// Native planner core of regent_fft_tpu_torch: the port's own copy of
// regent_fft_tpu/native/planner.cc, the same cost model and search, so
// planner="model" and Plan.cost() give the JAX package's answers.
//
// A re-design of FFTW's planner kernel (fftw-3.3.8 kernel/planner.c, a
// dynamic-programming search over solvers with memoization) for radix
// schedules of matmul stages:
//
//   * exact integer factorization,
//   * a DP over radix schedules minimizing a hardware cost model
//     (contraction flops + twiddle cost + stage overhead + traffic),
//   * smooth-size search for Bluestein padding.
//
// Exposed as a flat C ABI consumed from Python via ctypes
// (regent_fft_tpu_torch/native/planner.py), which builds this file with
// $CXX -O2 -shared -fPIC at first use into build/regent_fft_tpu_torch/.
//
// The cost parameters' defaults are the reference's (fitted to its
// schedule rankings); utils/calibrate.py replaces them with rates
// measured on the device.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Cost model: time units for one radix-r matmul stage applied to a
// length-n problem (per element-batch), on an MXU with EDGE-wide
// contraction.  A stage is a (B*n/r, r) x (r, r) complex matmul:
//   flops  = 8 * n * r   (4 real matmuls)
//   MXU efficiency ~ min(r, EDGE)/EDGE in the contraction dimension
//   twiddle multiply: 6 flops/elem on the VPU between stages
//   fixed per-stage overhead (pipeline drain, layout shuffle)
// ---------------------------------------------------------------------
// ---------------------------------------------------------------------
// Cost model, calibrated against measured per-schedule timings on v5e
// (the reference's schedule rankings).  Time unit: one useful
// f32 flop at the measured HIGHEST-precision einsum rate (mxu_rate
// scales it).  What the measurements showed:
//   * a radix-r stage costs its TRUE flops (8*n*r) — no MXU-efficiency
//     division: (64,64) beats (128,32) by the 128:160 flop ratio;
//   * every stage is one read+write of the split f32 planes (16 B/elem),
//     amplified by lane padding for small non-pow2 radices
//     ((128,5) ~25% slower than (80,8) at equal passes);
//   * >=3-stage schedules run the flattened pipeline, measured ~12x the
//     per-stage traffic of the in-place 2-stage executor (2.61 ms vs
//     0.19 ms at n=1024) — so the search is really: direct, else best
//     2-factor split, else cheapest flattened factorization.
// ---------------------------------------------------------------------
struct CostParams {
  double mxu_edge = 128.0;      // lane tile / systolic edge
  double mxu_rate = 1.0;        // relative useful-f32-flop rate
  double vpu_rate = 0.05;       // relative VPU flop rate (per MXU flop)
  double stage_overhead = 64.0; // per-stage fixed cost (per element: 0.25)
  // HBM traffic cost in MXU-flop time units per BYTE.  Calibrated as
  // mxu_flops_per_sec / hbm_bytes_per_sec; the default reproduces a
  // ~44 TFLOP/s : 440 GB/s chip (measured v5e ratios).
  double bw_unit = 100.0;
};

// Flattened (>=3 stage) pipeline's measured traffic multiplier.
constexpr double kFlatMult = 12.0;

// Lane-padding blowup of a radix-r stage's layout: the executor's
// Cooley-Tukey reshape puts the split sub-axis on a tiled dimension and
// non-pow2 extents pay relayout padding (pow2 extents collapse into
// neighboring dims for free).  Granularity 16, fitted to the measured
// schedule rankings: at n=640 (80,8) [blowup 1.0]
// beats (40,16) [48/40=1.2] by 4%, and at n=1000 (125,8) [128/125] beats
// (40,25) [1.2 + 32/25] by 6% — an 8-granularity term ranked both pairs
// backwards (the round-2 regression).
double pad_blowup(uint64_t r) {
  if ((r & (r - 1)) == 0) return 1.0;  // pow2: layout-free
  double pad16 = (double)((r + 15) / 16 * 16);
  return pad16 / (double)r;
}

// One radix-r contraction stage applied to the whole length-n problem:
// true flops + one padded read/write pass (per batch element).
double stage_cost(double n, uint64_t r, const CostParams& p) {
  double matmul = 8.0 * n * (double)r / p.mxu_rate;
  double traffic = 16.0 * n * pad_blowup(r) * p.bw_unit;
  return matmul + traffic + p.stage_overhead * n * 0.25;
}

// Inter-stage twiddle multiply: 6 VPU flops/element, in MXU-flop time
// units via the relative VPU rate.
double twiddle_cost(double n, const CostParams& p) {
  return 6.0 * n / (p.mxu_rate * p.vpu_rate);
}

std::vector<uint32_t> prime_factors(uint64_t n) {
  std::vector<uint32_t> out;
  for (uint64_t d = 2; d * d <= n; d += (d == 2 ? 1 : 2)) {
    while (n % d == 0) { out.push_back((uint32_t)d); n /= d; }
  }
  if (n > 1) out.push_back((uint32_t)n);
  return out;
}

// Divisors of n that are <= max_radix, descending.
std::vector<uint32_t> small_divisors(uint64_t n, uint32_t max_radix) {
  std::vector<uint32_t> divs;
  for (uint32_t d = 2; d <= max_radix && (uint64_t)d <= n; ++d)
    if (n % d == 0) divs.push_back(d);
  return divs;
}

// Greedy largest-first grouping of the prime factors (shared by the
// exported rftp_factorize and the flattened-schedule fallback).
bool greedy_factorize(uint64_t n, uint32_t max_radix,
                      std::vector<uint32_t>* out) {
  auto primes = prime_factors(n);
  for (auto p : primes)
    if (p > max_radix) return false;
  std::vector<uint32_t> sorted(primes.rbegin(), primes.rend());
  std::vector<uint32_t> factors;
  uint64_t cur = 1;
  for (uint32_t p : sorted) {
    if (cur * p <= max_radix) cur *= p;
    else { factors.push_back((uint32_t)cur); cur = p; }
  }
  factors.push_back((uint32_t)cur);
  std::sort(factors.rbegin(), factors.rend());
  *out = factors;
  return true;
}

// The schedule search mirrors the EXECUTOR's three code paths exactly
// (plan.axis_steps): a direct single contraction, the in-place 2-stage
// Cooley-Tukey, or the flattened multi-stage pipeline.  Returns the
// chosen factors and their modeled cost (per batch element of a length-n
// problem); empty vector when n is not smooth w.r.t. max_radix.
double plan_schedule(uint64_t n, uint32_t max_radix, const CostParams& p,
                     std::vector<uint32_t>* out) {
  out->clear();
  if (n == 1) { out->push_back(1); return 0.0; }
  double dn = (double)n;
  double best = -1.0;
  // direct: one contraction, one pass
  if (n <= max_radix) {
    best = 8.0 * dn * dn / p.mxu_rate + 16.0 * dn * pad_blowup(n) * p.bw_unit
           + p.stage_overhead * dn * 0.25;
    *out = {(uint32_t)n};
  }
  // best 2-factor split (both factors <= max_radix)
  for (uint32_t r : small_divisors(n, max_radix)) {
    uint64_t r2 = n / r;
    if (r2 > max_radix || r2 < 2 || (uint64_t)r > r2) continue;
    double c = stage_cost(dn, r, p) + stage_cost(dn, r2, p)
               + twiddle_cost(dn, p);
    if (best < 0 || c < best) {
      best = c;
      // larger factor first — matches factorize()/mixed2 conventions
      *out = {(uint32_t)r2, r};
    }
  }
  if (best >= 0) return best;
  // flattened multi-stage fallback (measured kFlatMult traffic penalty)
  std::vector<uint32_t> factors;
  if (!greedy_factorize(n, max_radix, &factors)) return -1.0;
  double c = 0.0;
  for (uint32_t r : factors) c += stage_cost(dn, r, p) + twiddle_cost(dn, p);
  c *= kFlatMult;
  *out = factors;
  return c;
}

struct Memo {
  // (n, max_radix) -> schedule; cleared when cost params change.
  std::map<std::pair<uint64_t, uint32_t>, std::vector<uint32_t>> best;
  std::mutex mu;
};

Memo g_memo;
CostParams g_params;

}  // namespace

extern "C" {

// Greedy largest-first factorization (parity with the Python fallback).
// Returns count, or 0 if n has a prime factor > max_radix.  out[cap].
int rftp_factorize(uint64_t n, uint32_t max_radix, uint32_t* out, int cap) {
  if (n == 0) return 0;
  if (n == 1) { if (cap > 0) out[0] = 1; return 1; }
  std::vector<uint32_t> factors;
  if (!greedy_factorize(n, max_radix, &factors)) return 0;
  int cnt = (int)factors.size();
  for (int i = 0; i < cnt && i < cap; ++i) out[i] = factors[i];
  return cnt;
}

// Cost-model schedule (executor-shaped search; see plan_schedule).
// Returns stage count, or 0 if n is not smooth w.r.t. max_radix.
int rftp_best_schedule(uint64_t n, uint32_t max_radix, uint32_t* out, int cap) {
  if (n == 0) return 0;
  const auto key = std::make_pair(n, max_radix);
  std::vector<uint32_t> sched;
  {
    std::lock_guard<std::mutex> g(g_memo.mu);
    auto it = g_memo.best.find(key);
    if (it != g_memo.best.end()) sched = it->second;
  }
  if (sched.empty()) {
    if (plan_schedule(n, max_radix, g_params, &sched) < 0.0) return 0;
    std::lock_guard<std::mutex> g(g_memo.mu);
    g_memo.best[key] = sched;
  }
  int cnt = (int)sched.size();
  for (int i = 0; i < cnt && i < cap; ++i) out[i] = sched[i];
  return cnt;
}

// Modeled cost of the best schedule (per batch element), for inspection
// and tests; -1 when n is not smooth.
double rftp_schedule_cost(uint64_t n, uint32_t max_radix) {
  std::vector<uint32_t> sched;
  return plan_schedule(n, max_radix, g_params, &sched);
}

// Smallest 5-smooth size >= n (Bluestein padding).
uint64_t rftp_next_fast_len(uint64_t n) {
  if (n <= 2) return n < 1 ? 1 : n;
  // next power of two is an upper bound
  uint64_t best = 1;
  while (best < n) best <<= 1;
  for (uint64_t p5 = 1; p5 < best; p5 *= 5) {
    for (uint64_t p35 = p5; p35 < best; p35 *= 3) {
      uint64_t q = (n + p35 - 1) / p35;
      uint64_t p2 = 1;
      while (p2 < q) p2 <<= 1;
      uint64_t cand = p35 * p2;
      if (cand >= n && cand < best) best = cand;
    }
  }
  return best;
}

// True algorithmic real-FLOP count of a schedule (api/flops.c analog).
double rftp_stage_flops(uint64_t n, const uint32_t* factors, int count) {
  double fl = 0;
  for (int i = 0; i < count; ++i) {
    fl += 8.0 * (double)n * (double)factors[i];
    if (i + 1 < count) fl += 6.0 * (double)n;
  }
  return fl;
}

// Tune the cost model (called by Python with per-chip measured numbers;
// bw_unit = useful-flops-per-second / HBM-bytes-per-second).
void rftp_set_cost_params(double mxu_edge, double mxu_rate, double vpu_rate,
                          double stage_overhead, double bw_unit) {
  std::lock_guard<std::mutex> g(g_memo.mu);
  g_params.mxu_edge = mxu_edge;
  g_params.mxu_rate = mxu_rate;
  g_params.vpu_rate = vpu_rate;
  g_params.stage_overhead = stage_overhead;
  g_params.bw_unit = bw_unit;
  g_memo.best.clear();
}

int rftp_version() { return 4; }

}  // extern "C"
