#!/usr/bin/env python3
"""Drive the PyTorch port (``regent_fft_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 off for every float32 product;
2. build: the CUDA kernels from ``regent_fft_tpu_torch/csrc`` with nvcc,
   one process per source, started together; the ptxas lines (the cluster
   kernel's four instances, fft_fused2's and the gap pass's in f32 and
   bf16, fft_fused2's register body (f32, bf16 and f32 reading
   interleaved complex64 at each of its two geometries), the matmul
   kernel, the 42 instances of fft_last's row kernel, the 58 of
   fft_cols's column kernel and its 10 f32 interleaved-output instances
   (each with its 10 f64 instances, whose
   registers are printed; the f32 and bf16 instances' registers must equal
   the parent build's, ``PARENT_REGISTERS``), the 10 each of the real pair
   kernels
   fft_last_r2c and ifft_last_c2r, on the same row body, the slab ring's
   48 axis-mode and 6 fuse_last instances, and the 21 of the four-step
   column kernel, on fft_cols' column body, must spill nothing), the
   count of tensor-core instructions (HMMA/HGMMA, from ``cuobjdump -sass``
   of the library) in fft_mm1's and fft_mm2's kernel, which must not be 0,
   fft_fused2's, fft_gap's and the fuse_last ring's cluster size and
   cudaOccupancyMaxActiveClusters at the main path's shapes (the ring's
   also its sub-slabs and TMA boxes), and the residency of fft_last's,
   fft_cols's and the axis ring's instances at every admitted length
   (cudaOccupancyMaxActiveBlocksPerMultiprocessor, rows or columns and
   threads a block, registers, shared bytes; the ring's depth, held
   against ring_geometry), f32 and bf16, of fft_last's and fft_cols's
   f64 instances at every power of two 2..1024, of the real pair kernels' (row
   pairs a block) and of every four-step column instance (fft_cols_tw and
   stage a's with the twiddle, stage b's);
3. kernels: every length the C2C kernel gates admit (ragged batches and
   column counts, both signs; fft_last at B = 1, 37 and one row past a
   whole block, also against fft_last_plain) against torch.fft in
   float64; fft_cols (f32 and bf16) and fft_axis0 at every length the
   mid-axis gate admits, V = 1, 37, one tile and one tile + 1, both
   signs, against torch.fft in float64 and their plain versions; and
   every
   length the real-kernel gate admits (2..1024; batches 37, 38 and a half
   and a whole pair past a block of pairs; narrow and Nyquist-packed
   layouts) against torch.fft.rfft / irfft * n in float64 and against
   their plain versions on the card; every four-step last-axis length
   (4096..2^21, batch 3, through ``backend="stockham"`` plans), the
   leading-axis four-step at
   every gated length (64..4096, axes 0 and 1) and the slab ring at all 24
   lengths of its instance table (ragged trailing extent) and all 93 pairs
   fused2_ring_supported admits, both signs, against torch.fft in float64
   and fft_axis_ring_plain; the four-step kernels against their plain
   versions on the card: fft_cols_tw at every n1 of the four-step last
   axis (the split's n2 and a ragged n2 below one tile, batch 3), the a0fs
   stages (f32 and bf16) at every (r1, r2) split of n = 64..4096 (pre 1,
   post 1024 and a ragged pre 2, post 37), both signs; fft_fused2 at all
   113 pairs ``fused2_supported`` admits, also against its plain version;
   the three
   C2C kernels on bf16 planes (complex32) at every length of the C2C sweep
   and every fused2 pair (odd batches, both signs), each against its plain
   version (within
   ``PLAIN_LIMIT``) and against torch.fft in float64 of the bf16-rounded
   input (within tolerance(n, "complex32")); the bf16 slab ring at the
   ring sweep's lengths and pairs (odd batches), the bf16 leading-axis
   four-step at n = 64..4096 on axes 0 and 1 (f32 planes out where
   r1 < 16; each stage also against its plain version), and the gap-fused
   pass at all 113 fused2 pairs (B = 2, Y = 3) in both types, the same
   way (the f32 pass also against its plain version);
   the matmul-form kernels at every length they take, both signs: fft_mm1
   at n = 1..128 (batch 37) against torch.fft in float64 on the host, and
   fft_mm2 at every n <= 16384 that two_stage_split admits (batch 3)
   against fft_mm2_plain on the card, every 16th of those lengths and the
   main path's also against torch.fft in float64 on the host;
   then each kernel at every shape the main path gives it (fft_last also
   at Bluestein's 16384 x 2048 inner planes; the f64 instances at every
   axis of 512^3, 256^3, 16 x 128^3, 64 x 1024 and 4096 x 1024, each also
   against torch.fft in complex128 within tolerance(n, "complex128"),
   bound 32 B an element), held against
   its plain PyTorch version on the card (rel_l2 <= tolerance(n), or
   ``PLAIN_LIMIT`` = 1e-3 for the bf16 kernels), the interleaved ends
   (fft_fused2's register body reading a complex64 tensor at 512^3, 256^3
   and a ragged last wave, fft_cols writing one at every power of two up
   to 1024 and the 512^3 and 256^3 axis-0 shapes, both signs) equal to
   the planar instances bit for bit, and timed
   (median of CUDA-event runs with the L2 flushed before each) beside its
   bound, its plain version and one torch.fft call over the same rows or
   axes where one computes the same function (a yardstick the port never
   calls; for the bf16 kernels the torch.complex32 call, cuFFT in fp16,
   where it runs, and the complex64 call beside it).  The four-step kernels
   (fft_cols_tw, a0fs_a, a0fs_b and the bf16 stages) have no such call;
   their entries (fft_last_four_step, fft_axis0_fourstep) are timed whole
   beside torch.fft.fft, the four-step last axis also by part (the two
   kernels and the sub-axis swap).  Every bound is the function's, not
   the algorithm's: its bytes over the memory rate or its 5 n log2 n flops
   a row over the FP32 rate, whichever is larger; fft_mm1 and fft_mm2 also
   report the flops of their dense products (8 n^2 a row; 8 n (n1 + n2) +
   6 n) as ``kernel_flops``, their time at the FP32 rate
   (``kernel_flops_ms``) and three times over at the TF32 tensor-core rate
   (``kernel_tc_ms``: the 3xTF32 split), and their plain versions run
   with TF32 asserted off;
4. main path, C2C: the complex64 plans a user makes -- 3-D 512^3, 1-D
   4096 x 1024 and 2-D 16 x 512^2 -- with the default device and backend.
   The kernel launch counts are zeroed just before the three plans run
   once and read just after: each kernel step must have launched its
   kernel exactly once, and the 512^3 and 16 x 512^2 inputs must have
   reached their first kernels as they are and the 512^3 output come from
   its last (``trace.COUNTS["interleaved_in"]`` 2, ``["interleaved_out"]``
   1), each output equal bit for bit to ``execute_split``'s on the same
   planes.  Results are held against torch.fft (and a small
   input against numpy in float64), the inverse plan must round-trip,
   then each plan's peak device memory is read and each plan is timed;
5. main path, real: the R2C and C2R plans of 4096 x 1024 (axis 1) and
   4 x 256^3 (axes 1-3), with the default device and backend.  Their step
   lines must be the expected ones; the counts are zeroed just before the
   four plans run once and must equal what their steps and real routes
   launch (fft_last_r2c 2, ifft_last_c2r 1, fft_cols 4, fft_last 1).
   Results are held against torch.fft.rfftn / irfftn within
   tolerance(logical_n), must come back through ``plan.inverse()``, and a
   small input is held against numpy in float64; then each plan is timed
   beside its bytes bound and the torch.fft call, and one more call of
   each is traced with torch.profiler for its device time by kernel;
6. main path, four-step and ring routes (``ROUTE_PLANS``): the 1-D
   64 x 2^20 C2C plan (default device and backend: the four-step last
   axis), 512^3 with ``axis0_impl="fourstep"``, ``"dma"`` and
   ``f2_impl="ring"``, and 4 x 256^3 (axes 1-3) with
   ``axis0_impl="fourstep"``.  Each plan is its own group: counts zeroed
   just before its one run and read just after must equal the listed
   launches exactly; then the checks, timings and profile of phase 4/5,
   and the 512^3 times by route side by side;
7. main path, data types (``DTYPE_PLANS``): complex32 C2C plans of 512^3
   (its input a SplitComplex of bf16 planes on the card; the default route,
   then ``axis0_impl="fourstep"``, ``"dma"`` and ``f2_impl="ring"``),
   4 x 256^3 (axes 1-3) with ``axis0_impl="fourstep"``, 4096 x 1024 and
   16 x 512^2, and complex128 C2C plans of 256^3 and 4096 x 1024, with the
   default device and backend.  One group per plan as in phase 6: the
   complex32 plans launch only the bf16 kernels, the complex128 plans only
   the f64 instances of fft_cols and fft_last.  Each is held against torch.fft in float64 (of the bf16-rounded
   input for complex32) within tolerance(logical_n, dtype) and must
   round-trip through ``plan.inverse()``; then its peak device memory
   is read, and it is timed beside its bytes bound, torch.fft on
   complex64 of the same data and torch.fft on the plan's own type where
   that runs (complex128; torch.complex32 for the complex32 plans), and
   traced; the complex32 512^3 times by route side by side, and the
   f2_impl="ring" plan's peak memory rise, which must not pass the grid
   plan's;
8. main path, the gap-fused route (``GAP_PLANS``): complex64 and complex32
   512^3 plans built with ``REGENT_FFT_GAP_FUSED=1`` set for this group
   only (the plan cache cleared before and after), checked, counted, timed
   and traced as in phase 7;
9. main path, ``backend="pallas"`` (``PALLAS_PLANS``): complex64 4096 x
   1024 and 4096 x 640 (fft_mm2 once each), 4 x 256^3 and 512^3 (fft_mm2
   on each of three axes) and 16 x 128^3 (fft_mm1 three times), one group
   each as in phase 7, each with the flops of its kernels' dense products;
10. main path, the precision tiers (``PRECISION_PLANS``): complex64 and
   complex32 512^3 with ``precision="high"`` (the steps and launches of
   "highest") and the columns of a 512 x 262144 array with
   ``precision="default"`` (the axis-0 step of a rank-2 complex64 array
   launches fft_axis0 at every tier and norm), one group each as in
   phase 7;
11. the general 1-D pipeline (Rader, Bluestein), the reference's
   interface and guru plans: every 16th of the 1820 C2C and 1917 real
   lengths in 1..4096 that no kernel, direct DFT or two-factor split takes
   (the port refused them before Rader and Bluestein; batch 3, C2C both
   signs), each step line held against ``schedule_description`` and each
   result against torch.fft in float64; then ``GENERAL_PLANS``, one group
   each as in phase 7 (Bluestein 1009 on two ``fft_last`` launches of
   m = 2048 a call, complex32 included; Rader 2053 and complex128 on
   contractions only), timed with their steps beside the bound and one
   torch.fft call, and traced; the ``generate_fft_interface`` plans of a
   512^3 C2C, a 256^3 R2C and a batched 4 x 256^3 C2C, each make_plan's
   cached plan, run and destroyed; a ``plan_many`` of interleaved fields
   and a transposing ``plan_guru`` layout on flat buffers, both 4096 x
   1024, against torch.fft;
12. the r2r kinds, CZT, FFTLog and NUFFT (``R2R_GROUPS``,
   ``SLICE_GROUPS``), one counted group each: f32 r2r on ``fft_last`` at
   its core length L (``dctn`` type 2 on 512^3, ``dstn`` type 1 on 511^3
   with L = 1024, DCT-IV on 4096 x 512, R2HC/HC2R/DHT on 4096 x 1024, an
   orthonormal ``idctn`` on 2048^2, a guru REDFT10 of interleaved fields),
   each plan's routes asserted; ``dctn`` of a float64 256^3 on the dense
   pipeline (no launch); ``zoom_fft`` of 4096 x 1000 and ``czt`` of
   16384 x 1009 (dense, L 5-smooth, no launch); ``fht``/``ifht`` of
   16384 x 1024 at bias 0 and -0.5 (``fft_last_r2c`` and the half-length
   C2R's ``fft_last``), on the JAX suite's sample family and on power-law
   spectra (``POWER_LAW_JAX_ERR``); NUFFT types 1 and 2 in 1-D (2^20 modes, 2^22
   points, grid 2^21 on the four-step), 2-D (1024^2 modes, 2^20 points,
   grid 2048^2) and 3-D (128^3 modes, 2^18 points, grid 256^3), and type 3
   in 1-D (2^20 points and frequencies, inner grid 2^21), eps 1e-6, each
   with its peak device memory.  Each result is held against a float64
   oracle (scipy/numpy on the host; the NUFFT against direct sums at 64
   sampled modes or points, in chunks on the card) within its bound
   (``tolerance(L)``, the complex128 tolerance, 1e-5 for CZT, 2e-5 for
   FFTLog, 2e-5/5e-5/1e-4 for the NUFFT by dimension), and timed beside
   its bytes bound and, where one PyTorch call computes a comparable
   transform, that call.  Phase 3b holds each kernel against its plain
   version, in both signs, on every planes' shape phase 12 feeds it (the
   511^3 DST-I's (511^2, 1024) planes among them); phase 12 records the
   shapes its launches get and fails on one that 3b did not hold;
13. the planner tiers (wisdom autoload off for the whole run): the
   ``planner="patient"`` race of the 512^3 plan in complex64 and
   complex32 (the schedules, the backends, the leading-axis x
   trailing-pair routes), ``planner="measure"`` on c64 4096 x 1024,
   64 x 2^20 and R2C 4 x 256^3 and ``planner="exhaustive"`` on complex32
   512^3 (its knob grid, none of which the card races), each candidate's
   median ms and the winner printed, every candidate that plans finite;
   each raced plan counted once beside its winner's routes planned
   directly (the same launches), held within tolerance(n, dtype) of the
   estimate plan and timed beside it; ``planner="model"`` against
   ``"estimate"`` on c64 16384 x 1000 (``backend="xla"``); ``calibrate()``
   at full size (its bandwidth at most 1.05 x the datasheet's);
   ``Plan.benchmark()`` of the 512^3 grid plan within 10 % of phase 4's
   steps ms; the wisdom exported and read back in a fresh process, whose
   patient plan reports "cached-wisdom" and the same step lines; and
   ``bench_cli --suite baseline --verify``.  Every time in this script
   comes from ``utils/timing.py`` (one warm-up, the median of 10
   CUDA-event runs, the L2 flushed before each);
14. the signal and spectral functions and the two adapters
   (``SIGNAL_SHAPES``, ``SIGNAL_GROUPS``), one counted group each at full
   width, the plan cache cleared before it: ``fftconvolve`` of a 32 x
   1000^2 image blur and ``correlate`` ("same", packed 1024^2 plans), a
   480^3 volume (packed 512^3) and a complex 256 x 16000 matched filter,
   ``oaconvolve`` of 64 x 480000 with a 257-tap FIR, ``stft``/``istft``,
   ``welch``/``csd``/``coherence``/``spectrogram`` on the same channels,
   ``hilbert`` (1024 x 16384 and 64 x 2^20), ``hilbert2`` 2048^2,
   ``resample`` (real and complex), ``periodogram``; ``torch_fft`` on CUDA
   tensors with every ``torch.fft`` function raising while the counted
   call runs; ``scipy.fft`` calls, numpy in and out, under the card's
   backend alone (``only=True``) with its ``RuntimeWarning`` an error.
   Each is held against scipy/numpy in float64 at the JAX suites' bounds
   (on 4 seeded rows where scipy on the batch is slow; the volume against
   direct sums at 64 points; the 3-D transforms against torch.fft in
   float64 on the card), timed beside its bound and a PyTorch yardstick
   (``torch.stft``/``torch.istft``, else the ``torch.fft`` chain, as
   labelled), traced (the port's kernels' share of the device time), the
   3-D and STFT groups with their peak memory; a group with no launch
   says its route is dense.  Phase 3b holds every (kernel, planes) shape
   phase 14 feeds (``check_held``);
15. the distributed plans (``parallel/``) in this process as a one-rank
   NCCL group (``init_distributed(device="cuda", init_method="file://...",
   world_size=1, rank=0)``; NCCL takes one rank a card, and the host has
   one card), ``DIST_GROUPS``, one counted group each at full width:
   c64 512^3 shards, slab, its inverse round trip, ``transposed_out``
   chained into ``transposed_in``, ``pipeline_chunks=4``, pencil 1 x 1
   and its ``transposed_out``, ``make_plan_distributed`` in estimate mode
   and with ``planner="measure"`` (the race printed, its ``"distrib"``
   wisdom exported and read back); complex32 slab 512^3 (every exchange
   buffer bf16), complex128 slab 256^3, ``howmany=2`` on 256^3; the
   rank-1 plan at n = 2^22 = 2048 x 2048, natural and scrambled; the
   transpose of an 8192^2 c64 matrix and ``make_plan_many_transpose`` of
   4096^2 x 2; the slab at 1024^3 once (the size a 4-card slab is planned
   at).  Each is held against torch.fft in float64 (the 1024^3 slab
   against the single-device plan, slab by slab) within
   tolerance(n, dtype), the transposes exactly; timed beside the
   single-device plan of the same spec; traced (the port's kernels, the
   NCCL kernel, and the rest: the pack/unpack copies around each
   exchange, pads and the scale) with its peak memory; one
   ``{"distributed": [...]}`` line.  Phase 3b holds every (kernel,
   planes) shape phase 15 feeds (the 1024^3 slab's through its plain
   versions on 16 slabs).  Multi-card NCCL is not run;
16. the real distributed plans (``parallel/`` part 2) in the same one-rank
   NCCL group, ``DIST_REAL_GROUPS``, one counted group each at full
   width: the packed slab R2C of 512^3 (and ``transposed_out``), its C2R
   on a random non-Hermitian spectrum, R2C ``transposed_out`` into C2R
   ``transposed_in``, pencil 1 x 1 R2C and its C2R back,
   ``make_plan_distributed(kind=R2C)`` in estimate mode and with
   ``planner="measure"`` (its "distrib" wisdom keyed "r2c"), the
   distributed r2r DCT-II of 512^3 (and ``transposed_out``; every
   exchange one real plane) and DCT-II into DCT-III, the unpacked R2C
   slab of 512 x 512 x 2048, the rank-1 R2C and C2R at n = 2^23 (m =
   2048 x 2048), and the packed R2C slab of 1024^3.  Each is held against
   a float64 torch.fft oracle on the card (rfftn, irfftn, rfft, a
   Makhoul DCT-II; the round trips against their input) within
   tolerance(n), timed beside the single-device plan, traced, with its
   peak memory; one ``{"distributed_real": [...]}`` line and the phase's
   time.  Phase 3b holds every (kernel, planes) shape phase 16 feeds;
17. the JAX plan's user switches (``plan.Switches``), each variable set
   for its group only, one counted group each: the complex32 512^3 and
   4096 x 1024 plans under every ``REGENT_FFT_MXU_IMPL`` (unset, direct,
   fourstep, fs4m, fstw: the same launches and the same output under each,
   within tolerance(n, "complex32") of torch.fft in float64), with
   fft_fused2_bf16, fft_cols_bf16 and fft_last_bf16 held at those planes
   against their plain runners on the body ``tile_impl`` names
   (``PLAIN_LIMIT``); the complex64 512^3 plan under
   ``REGENT_FFT_AXIS0_IMPL`` fourstep, dma, grid and ``REGENT_FFT_F2_IMPL``
   ring, off, grid (``ROUTE_SWITCHES``: step lines and launches, within
   tolerance(n) of torch.fft); the 1-D R2C of 4096 x 1024 under
   ``REGENT_FFT_R2C_1D=half`` (fft_last, not fft_last_r2c); the
   lane-padded r2c/c2r round trip at 4096 x 1024 and 16 x 512^2 (equal to
   the narrow one, zeros above n/2, the kernels held against their plain
   versions at those planes, padded and narrow timed); and a child process
   under ``REGENT_FFT_LOG=2`` that must print the make_plan and schedule
   lines; one ``{"switches": [...]}`` line and the phase's time;
18. complex128 on the f64 instances: ``torch_fft.fftn`` of a complex128
   256^3 tensor, ``scipy.fft.fftn`` of complex128 64 x 1024 through the
   card's backend and an R2C complex128 plan of 64 x 256^2, each counted
   (only f64 instances launch) and within tolerance(n, "complex128") of
   torch.fft in float64; NPB FT class C through the port
   (``examples/npb_ft.py --check``): its 20 checksums within 1e-12
   relative of the plain torch.fft iteration of ``fftbench/npb_ft.py``.

Prints how long each phase took, one ``{"plans": [...]}`` line,
one ``{"planners": [...]}`` line (phase 13),
one ``{"kernels": [...]}`` line (24 kernels; ``launches`` sums every
main-path run, ``launches_by_path`` splits them, and every kernel must
have launched), the nvidia-smi line, and last the device line.  Exits
non-zero, with no result, when no CUDA device is present.
"""
import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

# Datasheet peaks (dense, no sparsity): device-memory bytes/s, FP32
# (non-tensor-core) flop/s and TF32 tensor-core flop/s, matched on the
# nvidia-smi card name.
PEAKS = [("H100 PCIe", 2.0e12, 51.2e12, 378e12),
         ("H100 NVL", 3.9e12, 60.0e12, 417.5e12),
         ("H100", 3.35e12, 67.0e12, 495e12), ("H200", 4.8e12, 67.0e12, 495e12)]

PS = "regent_fft_tpu/ops/pallas_stockham.py"
PF = "regent_fft_tpu/ops/pallas_fft.py"
STOCKHAM_CU = "regent_fft_tpu_torch/csrc/stockham.cu"
COLS_CU = "regent_fft_tpu_torch/csrc/cols.cu"
MATMUL_CU = "regent_fft_tpu_torch/csrc/matmul.cu"
REAL_CU = "regent_fft_tpu_torch/csrc/real.cu"
FOURSTEP_CU = "regent_fft_tpu_torch/csrc/fourstep.cu"
RING_CU = "regent_fft_tpu_torch/csrc/ring.cu"
KERNELS = {   # name: (replaces, source)
    "fft_last": (f"{PS}:1267 (_runner_last)", STOCKHAM_CU),
    "fft_cols": (f"{PS}:787 (_runner_cols)", COLS_CU),
    "fft_fused2": (f"{PS}:875 (_runner_fused2)", STOCKHAM_CU),
    "fft_last_r2c": (f"{PS}:2395 (_runner_last_r2c)", REAL_CU),
    "ifft_last_c2r": (f"{PS}:2521 (_runner_last_c2r)", REAL_CU),
    "fft_cols_tw": (f"{PS}:1010 (_runner_cols_tw)", FOURSTEP_CU),
    "a0fs_a": (f"{PS}:1843 (_runner_a0fs, stage a)", FOURSTEP_CU),
    "a0fs_b": (f"{PS}:1843 (_runner_a0fs, stage b)", FOURSTEP_CU),
    "fft_axis_ring": (f"{PS}:1324 (_runner_axis0_dma)", RING_CU),
    "fft_axes2_ring": (f"{PS}:1324 (_runner_axis0_dma, fuse_last)", RING_CU),
    "fft_last_bf16": (f"{PS}:1267 (_runner_last, io=bf16: _direct_tile :614 "
                      f"n<=512, _mxu_tile_tw :566 n=1024/2048, "
                      f"_stockham_tile :709)", STOCKHAM_CU),
    "fft_cols_bf16": (f"{PS}:787 (_runner_cols, io=bf16: the same bodies)",
                      COLS_CU),
    "fft_fused2_bf16": (f"{PS}:875 (_runner_fused2, io=bf16: the same bodies "
                        f"on both axes)", STOCKHAM_CU),
    "fft_gap": (f"{PS}:1127 (_runner_fused2_gap)", STOCKHAM_CU),
    "fft_gap_bf16": (f"{PS}:1127 (_runner_fused2_gap, io=bf16: _stockham_tile "
                     f"on both axes)", STOCKHAM_CU),
    "a0fs_a_bf16": (f"{PS}:1843 (_runner_a0fs, stage a, io=bf16: 'hd' dots "
                    f"_dg0_3m :1800)", FOURSTEP_CU),
    "a0fs_b_bf16": (f"{PS}:1843 (_runner_a0fs, stage b, io=bf16: 'hd' dots "
                    f"_dg0_3m :1800)", FOURSTEP_CU),
    "fft_axis_ring_bf16": (f"{PS}:1324 (_runner_axis0_dma, io=bf16)", RING_CU),
    "fft_axes2_ring_bf16": (f"{PS}:1324 (_runner_axis0_dma, fuse_last, "
                            f"io=bf16)", RING_CU),
    "fft_axis0": (f"{PS}:739 (_runner_axis0)", COLS_CU),
    "fft_mm1": (f"{PF}:129 (_runner_1stage)", MATMUL_CU),
    "fft_mm2": (f"{PF}:157 (_runner_2stage)", MATMUL_CU),
    "fft_cols_f64": ("none (the JAX package runs a complex128 axis as a "
                     "dense contraction, regent_fft_tpu/plan.py:331)",
                     COLS_CU),
    "fft_last_f64": ("none (the JAX package runs a complex128 axis as a "
                     "dense contraction, regent_fft_tpu/plan.py:331)",
                     STOCKHAM_CU),
}
# The registers ptxas gave the f32 and bf16 instances of the row and column
# kernels (sm_90a) before their bodies took the arithmetic type as a
# template parameter: the f64 instances share those bodies, whose f32 and
# bf16 code must not move.
PARENT_REGISTERS = {
    "fft_last_kernel": {
        "f32 2": 16, "f32 4": 24, "f32 8": 32, "f32 16": 48, "f32 32": 72,
        "f32 64": 79, "f32 128": 79, "f32 256": 80, "f32 384": 116,
        "f32 512": 128, "f32 640": 128, "f32 768": 128, "f32 896": 128,
        "f32 1024": 127, "f32 1536": 128, "f32 2048": 126,
        "bf16 2": 15, "bf16 4": 20, "bf16 8": 27, "bf16 16": 47,
        "bf16 32": 64, "bf16 64": 71, "bf16 128": 80, "bf16 256": 79,
        "bf16 384": 116, "bf16 512": 127, "bf16 640": 128, "bf16 768": 128,
        "bf16 896": 128, "bf16 1024": 127, "bf16 1536": 128, "bf16 2048": 128,
    },
    "fft_cols_kernel": {
        "f32 2": 19, "f32 4": 26, "f32 8": 32, "f32 16": 48, "f32 24": 56,
        "f32 32": 72, "f32 40": 56, "f32 48": 95, "f32 56": 64, "f32 64": 94,
        "f32 96": 110, "f32 128": 80, "f32 160": 123, "f32 192": 119,
        "f32 224": 126, "f32 256": 96, "f32 384": 114, "f32 512": 128,
        "f32 640": 168, "f32 768": 168, "f32 896": 128, "f32 1024": 128,
        "f32 1536": 168, "f32 2048": 128,
        "bf16 2": 19, "bf16 4": 24, "bf16 8": 32, "bf16 16": 48,
        "bf16 24": 56, "bf16 32": 71, "bf16 40": 56, "bf16 48": 96,
        "bf16 56": 64, "bf16 64": 92, "bf16 96": 109, "bf16 128": 80,
        "bf16 160": 127, "bf16 192": 119, "bf16 224": 119, "bf16 256": 96,
        "bf16 384": 168, "bf16 512": 128, "bf16 640": 168, "bf16 768": 168,
        "bf16 896": 128, "bf16 1024": 128, "bf16 1536": 168, "bf16 2048": 128,
    },
}
# Kernel-vs-plain limit (rel_l2) of the bf16 kernels, set from what a
# correct kernel reads (H100 runs): the kernels and their plain versions
# both compute in f32 and round the output to bf16 once (the two-pass
# kernels keep the plane between their passes in f32, as the plain versions
# do), so the outputs differ only where the two f32 results straddle a bf16
# rounding boundary: within about 7e-5.  tolerance(n, "complex32") would
# sit 100-2000 times above it.  Every f32 kernel is held to tolerance(n).
PLAIN_LIMIT = {k: 1e-3 for k in (
    "fft_last_bf16", "fft_cols_bf16", "fft_axis_ring_bf16", "a0fs_a_bf16",
    "a0fs_b_bf16", "fft_fused2_bf16", "fft_axes2_ring_bf16", "fft_gap_bf16")}
MAIN_PLANS = [((512, 512, 512), (0, 1, 2)), ((4096, 1024), (1,)),
              ((16, 512, 512), (1, 2))]
C2C_LAUNCHES = {"fft_fused2": 2, "fft_cols": 1, "fft_last": 1}
REAL_PLANS = [((4096, 1024), (1,), "r2c"), ((4096, 1024), (1,), "c2r"),
              ((4, 256, 256, 256), (1, 2, 3), "r2c"),
              ((4, 256, 256, 256), (1, 2, 3), "c2r")]
REAL_STEPS = {   # describe() step lines of REAL_PLANS, in order
    0: ["(real axis 1: n=1024 shared-head row-pair kernel r2c)"],
    1: ["(real axis 1: n=1024 half-length conjugate-even kernel c2r)"],
    2: ["(real axis 3: n=256 shared-head row-pair kernel r2c "
        "[nyquist-packed mids])", "(axis 2: kernel-butterfly(n=256))",
        "(axis 1: kernel-butterfly(n=256))"],
    3: ["(axis 2: kernel-butterfly(n=256))",
        "(axis 1: kernel-butterfly(n=256))",
        "(real axis 3: n=256 fused kernel c2r [nyquist-packed mids])"],
}
REAL_LAUNCHES = {"fft_last": 1, "fft_cols": 4, "fft_fused2": 0,
                 "fft_last_r2c": 2, "ifft_last_c2r": 1}
CUBE = (512, 512, 512)
# The four-step and ring plans: (label, shape, axes, PlanSpec fields, step
# lines, the launches of one run; every other count must stay 0).
ROUTE_PLANS = [
    ("fourstep_last", (64, 1048576), (1,), {},
     ["(axis 1: kernel-fourstep-last(n=1048576))"],
     {"fft_cols_tw": 1, "fft_last": 1}),
    ("fourstep_ring", CUBE, (0, 1, 2), {"axis0_impl": "fourstep"},
     ["(axis 1: kernel-fused2(512, 512))",
      "(axis 0: kernel-fourstep-ring(n=512))"],
     {"fft_fused2": 1, "a0fs_a": 1, "a0fs_b": 1}),
    ("dma_ring", CUBE, (0, 1, 2), {"axis0_impl": "dma"},
     ["(axis 1: kernel-fused2(512, 512))", "(axis 0: kernel-dma-ring(n=512))"],
     {"fft_fused2": 1, "fft_axis_ring": 1}),
    ("fused2_ring", CUBE, (0, 1, 2), {"f2_impl": "ring"},
     ["(axis 1: kernel-fused2-ring(512, 512))",
      "(axis 0: kernel-butterfly(n=512))"],
     {"fft_axes2_ring": 1, "fft_cols": 1}),
    ("fourstep_ring_mid", (4, 256, 256, 256), (1, 2, 3),
     {"axis0_impl": "fourstep"},
     ["(axis 2: kernel-fused2(256, 256))",
      "(axis 1: kernel-fourstep-ring(n=256))"],
     {"fft_fused2": 1, "a0fs_a": 1, "a0fs_b": 1}),
]
# The complex32 and complex128 plans: (label, shape, axes, dtype, PlanSpec
# fields, step lines, the launches of one run; every other count must
# stay 0).
DTYPE_PLANS = [
    ("complex32_cube", CUBE, (0, 1, 2), "complex32", {},
     ["(axis 1: kernel-fused2(512, 512))", "(axis 0: kernel-butterfly(n=512))"],
     {"fft_fused2_bf16": 1, "fft_cols_bf16": 1}),
    ("complex32_fourstep_ring", CUBE, (0, 1, 2), "complex32",
     {"axis0_impl": "fourstep"},
     ["(axis 1: kernel-fused2(512, 512))",
      "(axis 0: kernel-fourstep-ring(n=512))"],
     {"fft_fused2_bf16": 1, "a0fs_a_bf16": 1, "a0fs_b_bf16": 1}),
    ("complex32_dma_ring", CUBE, (0, 1, 2), "complex32", {"axis0_impl": "dma"},
     ["(axis 1: kernel-fused2(512, 512))", "(axis 0: kernel-dma-ring(n=512))"],
     {"fft_fused2_bf16": 1, "fft_axis_ring_bf16": 1}),
    ("complex32_fused2_ring", CUBE, (0, 1, 2), "complex32", {"f2_impl": "ring"},
     ["(axis 1: kernel-fused2-ring(512, 512))",
      "(axis 0: kernel-butterfly(n=512))"],
     {"fft_axes2_ring_bf16": 1, "fft_cols_bf16": 1}),
    ("complex32_fourstep_ring_mid", (4, 256, 256, 256), (1, 2, 3), "complex32",
     {"axis0_impl": "fourstep"},
     ["(axis 2: kernel-fused2(256, 256))",
      "(axis 1: kernel-fourstep-ring(n=256))"],
     {"fft_fused2_bf16": 1, "a0fs_a_bf16": 1, "a0fs_b_bf16": 1}),
    ("complex32_1d", (4096, 1024), (1,), "complex32", {},
     ["(axis 1: kernel-butterfly(n=1024))"], {"fft_last_bf16": 1}),
    ("complex32_2d", (16, 512, 512), (1, 2), "complex32", {},
     ["(axis 1: kernel-fused2(512, 512))"], {"fft_fused2_bf16": 1}),
    ("complex128_cube", (256, 256, 256), (0, 1, 2), "complex128", {},
     ["(axis 2: kernel-butterfly(n=256))", "(axis 1: kernel-butterfly(n=256))",
      "(axis 0: kernel-butterfly(n=256))"],
     {"fft_last_f64": 1, "fft_cols_f64": 2}),
    ("complex128_1d", (4096, 1024), (1,), "complex128", {},
     ["(axis 1: kernel-butterfly(n=1024))"], {"fft_last_f64": 1}),
]
# The gap-fused plans, built under REGENT_FFT_GAP_FUSED=1 (same fields).
GAP_STEPS = ["(axis 0: kernel-gap-fused(512, 512))",
             "(axis 1: kernel-butterfly(n=512))"]
GAP_PLANS = [
    ("gap_complex64", CUBE, (0, 1, 2), "complex64", {}, GAP_STEPS,
     {"fft_gap": 1, "fft_cols": 1}),
    ("gap_complex32", CUBE, (0, 1, 2), "complex32", {}, GAP_STEPS,
     {"fft_gap_bf16": 1, "fft_cols_bf16": 1}),
]

# Phase 17: the JAX plan's user switches (plan.Switches), each set for its
# group only.  The complex32 plans under every REGENT_FFT_MXU_IMPL (None:
# unset) launch the same bf16 kernels, whose FFMA tile stands in for every
# body; the kernels are held against the plain runners on each body.
MXU_IMPLS = [None, "direct", "fourstep", "fs4m", "fstw"]
MXU_PLANS = [("cube", CUBE, (0, 1, 2),
              {"fft_fused2_bf16": 1, "fft_cols_bf16": 1}),
             ("rows", (4096, 1024), (1,), {"fft_last_bf16": 1})]
GRID_STEPS = ["(axis 1: kernel-fused2(512, 512))",
              "(axis 0: kernel-butterfly(n=512))"]
# (variable, value, the c64 512^3 plan's step lines, its launches); the JAX
# plan reads REGENT_FFT_F2_IMPL at the fused pair's dispatch only, so "off"
# keeps the pair fused on the grid pass
ROUTE_SWITCHES = [
    ("REGENT_FFT_AXIS0_IMPL", "fourstep",
     ["(axis 1: kernel-fused2(512, 512))",
      "(axis 0: kernel-fourstep-ring(n=512))"],
     {"fft_fused2": 1, "a0fs_a": 1, "a0fs_b": 1}),
    ("REGENT_FFT_AXIS0_IMPL", "dma",
     ["(axis 1: kernel-fused2(512, 512))", "(axis 0: kernel-dma-ring(n=512))"],
     {"fft_fused2": 1, "fft_axis_ring": 1}),
    ("REGENT_FFT_AXIS0_IMPL", "grid", GRID_STEPS,
     {"fft_fused2": 1, "fft_cols": 1}),
    ("REGENT_FFT_F2_IMPL", "ring",
     ["(axis 1: kernel-fused2-ring(512, 512))",
      "(axis 0: kernel-butterfly(n=512))"],
     {"fft_axes2_ring": 1, "fft_cols": 1}),
    ("REGENT_FFT_F2_IMPL", "off", GRID_STEPS, {"fft_fused2": 1, "fft_cols": 1}),
    ("REGENT_FFT_F2_IMPL", "grid", GRID_STEPS,
     {"fft_fused2": 1, "fft_cols": 1}),
]
PADDED_SHAPES = [(4096, 1024), (16, 512, 512)]


# Phase 11: full-width shapes of the general 1-D pipeline, one group each:
# (label, shape, axes, kind, dtype, launches of one call).  Bluestein's inner
# transforms of m = 2048 run fft_last (f32, also for complex32); Rader's
# convolution and complex128 run dense contractions only.
GENERAL_PLANS = [
    ("prime1009_batch512", (512, 1009), (1,), "c2c", "complex64",
     {"fft_last": 2}),
    ("bluestein1009", (16384, 1009), (1,), "c2c", "complex64",
     {"fft_last": 2}),
    ("rader2053", (16384, 2053), (1,), "c2c", "complex64", {}),
    ("r2c2018", (16384, 2018), (1,), "r2c", "complex64", {"fft_last": 2}),
    ("c2r2018", (16384, 2018), (1,), "c2r", "complex64", {"fft_last": 2}),
    ("general1009x1031", (1009, 1031), (0, 1), "c2c", "complex64",
     {"fft_last": 2}),
    ("bluestein1009_c32", (16384, 1009), (1,), "c2c", "complex32",
     {"fft_last": 2}),
    ("bluestein1009_c128", (4096, 1009), (1,), "c2c", "complex128", {}),
]

# Phase 12: the r2r kinds (f32 on fft_last where it takes the core length
# L, f64 on the dense pipeline), CZT (dense, L 5-smooth), FFTLog (fft_last_r2c
# and the half-length C2R on fft_last) and the NUFFT (the grid's C2C plan),
# one counted group each: (label, launches of one call).
R2R_GROUPS = [
    ("dctn2_512cubed", {"fft_last": 3}),         # L = 512 on each axis
    ("dstn1_511cubed", {"fft_last": 3}),         # L = 2 * (511 + 1) = 1024
    ("dct4_4096x512", {"fft_last": 1}),          # L = 2 * 512
    ("r2hc_4096x1024", {"fft_last": 1}),
    ("hc2r_4096x1024", {"fft_last": 1}),
    ("dht_4096x1024", {"fft_last": 1}),
    ("idctn2_ortho_2048sq", {"fft_last": 2}),    # DCT-III, L = 2048
    ("guru_redft10_interleaved", {"fft_last": 1}),
    ("dctn2_256cubed_f64", {}),                  # dense f64
]
SLICE_GROUPS = [
    ("zoom_fft_4096x1000", {}),                  # L = 2000, dense
    ("czt_16384x1009", {}),                      # L = 2025, dense
    ("fht_16384x1024_bias0", {"fft_last_r2c": 1, "fft_last": 1}),
    ("ifht_16384x1024_bias0", {"fft_last_r2c": 1, "fft_last": 1}),
    ("fht_16384x1024_bias-0.5", {"fft_last_r2c": 1, "fft_last": 1}),
    ("ifht_16384x1024_bias-0.5", {"fft_last_r2c": 1, "fft_last": 1}),
    ("fht_powerlaw_16384x1024_bias0", {"fft_last_r2c": 1, "fft_last": 1}),
    ("ifht_powerlaw_16384x1024_bias0", {"fft_last_r2c": 1, "fft_last": 1}),
    ("fht_powerlaw_16384x1024_bias-0.5", {"fft_last_r2c": 1, "fft_last": 1}),
    ("ifht_powerlaw_16384x1024_bias-0.5",
     {"fft_last_r2c": 1, "fft_last": 1}),
    ("nufft1d1_2^20", {"fft_cols_tw": 1, "fft_last": 1}),   # grid 2^21
    ("nufft1d2_2^20", {"fft_cols_tw": 1, "fft_last": 1}),
    ("nufft2d1_1024sq", {"fft_last": 1, "fft_axis0": 1}),    # grid 2048^2
    ("nufft2d2_1024sq", {"fft_last": 1, "fft_axis0": 1}),
    ("nufft3d1_128cubed", {"fft_fused2": 1, "fft_cols": 1}),  # grid 256^3
    ("nufft3d2_128cubed", {"fft_fused2": 1, "fft_cols": 1}),
    ("nufft1d3_2^20", {"fft_cols_tw": 1, "fft_last": 1}),   # inner 2^21
]

# FFTLog on power-law spectra, r^s / (1 + r^2)^1.5 on logspace(-4, 4, 1024)
# with a slope s in [1, 1.5) per row.  With a bias, the float32 FFTs'
# roundoff grows up to e^4.6 toward one end of the grid, and the biased
# ifht reads above 2e-5 against scipy's float64 in the JAX package too.  Each
# group is held to 2e-5, or to REFERENCE_MARGIN times the JAX package's own
# rel_l2 on the same rows where that is larger.  POWER_LAW_JAX_ERR holds the
# JAX package's readings on the CPU (float32 input, scipy float64 oracle);
# tests/test_torch_port_fftlog.py checks them against the package.
POWER_LAW_JAX_ERR = {("fht", 0.0): 3.13e-7, ("ifht", 0.0): 3.13e-7,
                     ("fht", -0.5): 6.17e-6, ("ifht", -0.5): 4.98e-5}
REFERENCE_MARGIN = 1.25


def power_law_spectra(rows=16384):
    """(dln, (rows, 1024) float32 numpy) power-law spectra from a seed."""
    import numpy as np
    r = np.logspace(-4, 4, 1024)
    slope = 1.0 + 0.5 * np.random.default_rng(16).random((rows, 1))
    return (float(np.log(r[1] / r[0])),
            (r ** slope / (1 + r ** 2) ** 1.5).astype(np.float32))


def _pipeline(axis, sched):
    return f"(axis {axis}: 1d-pipeline[{sched}])"


M256 = "mixed(256 = 128*2): radix-128 -> radix-2"
M512 = "mixed(512 = 128*4): radix-128 -> radix-4"
D128 = "direct-dft-128 (1 matmul)"
# The backend="pallas" plans (the JAX suite rows 1d_c2c_1024_batch4096,
# 1d_c2c_640_batch4096, 3d_c2c_256cubed_batch4; the north star; a batch of
# 128^3 grids), one group each, in the fields of DTYPE_PLANS.  The step
# lines are the JAX plan's (the dense schedule's name); the counts show the
# matmul kernels ran.
PALLAS_PLANS = [
    ("pallas_1d_1024", (4096, 1024), (1,), "complex64", {"backend": "pallas"},
     [_pipeline(1, "mixed(1024 = 128*8): radix-128 -> radix-8")],
     {"fft_mm2": 1}),
    ("pallas_1d_640", (4096, 640), (1,), "complex64", {"backend": "pallas"},
     [_pipeline(1, "mixed(640 = 80*8): radix-80 -> radix-8")], {"fft_mm2": 1}),
    ("pallas_256cubed_batch4", (4, 256, 256, 256), (1, 2, 3), "complex64",
     {"backend": "pallas"}, [_pipeline(a, M256) for a in (3, 2, 1)],
     {"fft_mm2": 3}),
    ("pallas_cube", CUBE, (0, 1, 2), "complex64", {"backend": "pallas"},
     [_pipeline(a, M512) for a in (2, 1, 0)], {"fft_mm2": 3}),
    ("pallas_128cubed_batch16", (16, 128, 128, 128), (1, 2, 3), "complex64",
     {"backend": "pallas"}, [_pipeline(a, D128) for a in (3, 2, 1)],
     {"fft_mm1": 3}),
]
# The precision tiers (the JAX suite row 3d_c2c_512cubed_precision_high):
# the steps and launches of "highest"; and the "default" tier on the
# columns of a 2-D array (a 512-point FFT over 262144 columns), whose
# axis-0 step takes the axis-0 pass by its shape, at any tier.
PRECISION_PLANS = [
    ("precision_high_cube", CUBE, (0, 1, 2), "complex64", {"precision": "high"},
     ["(axis 1: kernel-fused2(512, 512))", "(axis 0: kernel-butterfly(n=512))"],
     {"fft_fused2": 1, "fft_cols": 1}),
    ("precision_high_cube_c32", CUBE, (0, 1, 2), "complex32",
     {"precision": "high"},
     ["(axis 1: kernel-fused2(512, 512))", "(axis 0: kernel-butterfly(n=512))"],
     {"fft_fused2_bf16": 1, "fft_cols_bf16": 1}),
    ("columns_512x262144", (512, 262144), (0,), "complex64",
     {"precision": "default"}, ["(axis 0: kernel-butterfly(n=512))"],
     {"fft_axis0": 1}),
]


# Phase 14: signal.py, spectral.py, torch_fft.py and scipy_backend.py at
# full width.  Shapes (the workloads the JAX package's docstrings name:
# image blur, volume deconvolution, a matched filter, a long FIR, 64
# channels of 10 s at 48 kHz for the STFT and the Welch family), and one
# counted group per function: (label, launches of one call).  A group with
# no launch runs the dense pipeline (its length is no kernel length); its
# line says so.
SIGNAL_SHAPES = {
    "blur": ((32, 1000, 1000), (32, 25, 25)),     # axes (1, 2) -> 1024^2
    "volume": ((480, 480, 480), (33, 33, 33)),   # -> 512^3
    "matched": ((256, 16000), (256, 385)),       # c64, axis 1 -> 16384
    "long": (64, 480000), "fir": (64, 257),      # blocks (125, 64, 3840)
    "hilbert": (1024, 16384), "hilbert_long": (64, 1 << 20),
    "hilbert2": (2048, 2048), "resample": (4096, 2048),
    "periodogram": (4096, 1024), "rows": (4096, 1024),
    "volumes": (4, 256, 256, 256), "cube": (512, 512, 512),
    "dctn": (512, 512, 512), "fht": (16384, 1024)}
SIGNAL_ROWS = 4      # rows held against scipy where the batch is slow there
SIGNAL_GROUPS = [
    ("fftconvolve_blur", {"fft_last_r2c": 2, "fft_cols": 3,
                          "ifft_last_c2r": 1}),
    ("fftconvolve_volume", {"fft_last_r2c": 2, "fft_cols": 6,
                            "ifft_last_c2r": 1}),
    ("fftconvolve_complex", {}),                 # 16384 = 128 x 128: dense
    ("correlate_same", {"fft_last_r2c": 2, "fft_cols": 3,
                        "ifft_last_c2r": 1}),
    ("oaconvolve_fir", {"fft_last": 3}),         # half-length route, 2048
    ("hilbert", {}),                             # 16384: dense
    ("hilbert_long", {"fft_cols_tw": 2, "fft_last": 2}),
    ("hilbert2", {"fft_last": 2, "fft_axis0": 2}),
    ("resample_real", {"fft_last": 2}),
    ("resample_complex", {"fft_last": 1}),       # ifft 4096 = 64 x 64: dense
    ("stft", {"fft_last_r2c": 1}),
    ("istft", {"fft_last": 1}),
    ("welch", {"fft_last_r2c": 1}),
    ("csd", {"fft_last_r2c": 2}),
    ("coherence", {"fft_last_r2c": 4}),
    ("spectrogram", {"fft_last_r2c": 1}),
    ("periodogram", {"fft_last_r2c": 1}),
    ("torch_fft_fft_c64", {"fft_last": 1}),
    ("torch_fft_fft_bf16", {"fft_last": 1}),
    ("torch_fft_rfftn", {"fft_last_r2c": 1, "fft_cols": 2}),
    ("torch_fft_irfftn", {"fft_cols": 2, "ifft_last_c2r": 1}),
    ("torch_fft_fftn_cube", {"fft_fused2": 1, "fft_cols": 1}),
    ("scipy_fft_fft_c64", {"fft_last": 1}),
    ("scipy_fft_rfftn", {"fft_last_r2c": 1, "fft_cols": 2}),
    ("scipy_fft_dctn", {"fft_last": 3}),
    ("scipy_fft_fht", {"fft_last_r2c": 1, "fft_last": 1}),
    ("scipy_fft_fft_f64", {"fft_last_f64": 1}),  # complex128: f64 rows
]
# Phase 15: each distributed mode's counted run and the launches its local
# stages make at world size 1 (the slab: fft_fused2 on the local trailing
# pair, fft_cols on the former slab axis, once a chunk; the pencil:
# fft_last, then fft_cols twice; the rank-1 plan: fft_axis0 on the R
# columns, fft_last on the C rows; the complex128 slab: the f64 instances,
# fft_last_f64 and fft_cols_f64 on the local pair, fft_cols_f64 on the
# former slab axis; the transposes exchange only).  The
# measure race's group is set from its winner's chunk count.
DIST_GROUPS = [
    ("dist_shards_512cubed", {"fft_fused2": 1, "fft_cols": 1}),
    ("dist_slab_512cubed", {"fft_fused2": 1, "fft_cols": 1}),
    ("dist_slab_inverse_roundtrip", {"fft_fused2": 2, "fft_cols": 2}),
    ("dist_slab_transposed_pair", {"fft_fused2": 2, "fft_cols": 2}),
    ("dist_slab_chunks4", {"fft_fused2": 1, "fft_cols": 4}),
    ("dist_pencil_1x1", {"fft_last": 1, "fft_cols": 2}),
    ("dist_pencil_transposed_out", {"fft_last": 1, "fft_cols": 2}),
    ("dist_slab_howmany2_256cubed", {"fft_fused2": 1, "fft_cols": 1}),
    ("dist_slab_c32_512cubed", {"fft_fused2_bf16": 1, "fft_cols_bf16": 1}),
    ("dist_slab_c128_256cubed", {"fft_last_f64": 1, "fft_cols_f64": 2}),
    ("dist_slab1d_2p22", {"fft_axis0": 1, "fft_last": 1}),
    ("dist_slab1d_2p22_scrambled", {"fft_axis0": 1, "fft_last": 1}),
    ("dist_transpose_8192sq", {}),
    ("dist_many_transpose_4096sq_x2", {}),
    ("dist_auto_estimate_512cubed", {"fft_fused2": 1, "fft_cols": 1}),
    ("dist_slab_1024cubed", {"fft_last": 1, "fft_cols": 2}),
]
# Phase 16: the real distributed plans at world size 1.  The packed slab
# and pencil R2C: fft_last_r2c on the rows, fft_cols on the mid axis and on
# axis 0; C2R the same with ifft_last_c2r; the unpacked R2C at a last axis
# of 2048: fft_last (the half-length reduction at 1024), fft_cols twice;
# the rank-1 plans: fft_axis0 on the R columns, fft_last on the C rows;
# the r2r plan: fft_last at L = 512 on each axis.
DIST_REAL_GROUPS = [
    ("dist_slab_r2c_512cubed", {"fft_last_r2c": 1, "fft_cols": 2}),
    ("dist_slab_r2c_512cubed_transposed_out",
     {"fft_last_r2c": 1, "fft_cols": 2}),
    ("dist_slab_c2r_512cubed", {"ifft_last_c2r": 1, "fft_cols": 2}),
    ("dist_slab_r2c_c2r_transposed_pair",
     {"fft_last_r2c": 1, "ifft_last_c2r": 1, "fft_cols": 4}),
    ("dist_pencil_r2c_1x1", {"fft_last_r2c": 1, "fft_cols": 2}),
    ("dist_pencil_r2c_c2r_1x1",
     {"fft_last_r2c": 1, "ifft_last_c2r": 1, "fft_cols": 4}),
    ("dist_auto_r2c_estimate_512cubed", {"fft_last_r2c": 1, "fft_cols": 2}),
    ("dist_auto_r2c_measure_512cubed", {"fft_last_r2c": 1, "fft_cols": 2}),
    ("dist_r2r_dct2_512cubed", {"fft_last": 3}),
    ("dist_r2r_dct2_512cubed_transposed_out", {"fft_last": 3}),
    ("dist_r2r_dct2_dct3_roundtrip", {"fft_last": 6}),
    ("dist_slab_r2c_unpacked_512x512x2048", {"fft_last": 1, "fft_cols": 2}),
    ("dist_slab1d_r2c_2p23", {"fft_axis0": 1, "fft_last": 1}),
    ("dist_slab1d_c2r_2p23", {"fft_axis0": 1, "fft_last": 1}),
    ("dist_slab_r2c_1024cubed", {"fft_last_r2c": 1, "fft_cols": 2}),
]
# The port's own kernels in a profiler trace (the rest is torch glue).
PORT_KERNEL = re.compile(r"\b(i?fft_\w*kernel|real_kernel)\b")


def _ptxas(log: str):
    """One line per compiled kernel: its mangled name and what ptxas said
    of its registers, stack and spills."""
    props, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for", 1)[1].strip()
            props[fn] = []
        elif fn and ("spill" in ln or "registers" in ln):
            props[fn].append(ln.replace("ptxas info    :", "").strip())
    return [f"{fn}: {'; '.join(lines)}" for fn, lines in props.items()]


def ptxas_registers(lines, kname: str) -> dict:
    """Registers by "<type> <n>" of the f32 and bf16 instances of a kernel
    template (``fft_last_kernel``, ``fft_cols_kernel``) in ``_ptxas`` lines:
    the plane type after the template's name, n its first integer
    argument (fft_cols_kernel's ColsGeo<n, ...>)."""
    out = {}
    for ln in lines:
        name = ln.split(":")[0]
        tail = name.split(kname, 1)[1]
        if tail.startswith("If"):
            typ = "f32"
        elif "__nv_bfloat16" in tail[:24]:
            typ = "bf16"
        else:
            continue
        n = int(re.search(r"Li(\d+)E", tail).group(1))
        out[f"{typ} {n}"] = int(re.search(r"Used (\d+) registers",
                                          ln).group(1))
    return dict(sorted(out.items()))


def _tensor_ops(lib: str):
    """Tensor-core instructions (HMMA, HGMMA) per kernel in the SASS of
    the built library, from the CUDA toolkit's cuobjdump."""
    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        tool = "cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"\bH(G)?MMA\b|\bH(G)?MMA\.", ln):
            counts[fn] += 1
    return counts


def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    def phase(label):
        print(f"phase {label} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    import numpy as np

    # hermetic planning: no wisdom file of an earlier process (phase 13
    # writes its own and reads it back in a fresh process)
    os.environ["REGENT_FFT_NO_WISDOM"] = "1"
    import regent_fft_tpu_torch as rt
    from regent_fft_tpu_torch.ops import _build
    from regent_fft_tpu_torch.ops import fourstep as fs
    from regent_fft_tpu_torch.ops import pallas_fft as pf
    from regent_fft_tpu_torch.ops import stockham_kernels as sk
    from regent_fft_tpu_torch.plan import _half_shape
    from regent_fft_tpu_torch.utils import timing
    from regent_fft_tpu_torch.utils import trace
    from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

    def kernel_launches():
        """The launch counts of the port's kernels (cuBLAS's products,
        ``sk.LIBRARY_LAUNCHES``, left out)."""
        return {k: v for k, v in sk.LAUNCHES.items()
                if k not in sk.LIBRARY_LAUNCHES}

    # 1. environment
    smi = _smi()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    peak = next((p for p in PEAKS if p[0] in smi or p[0] in name), None)
    if peak is None:
        raise RuntimeError(f"no datasheet peaks for card {smi!r}")
    _, bw, fp32, tf32 = peak
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{_build.build_seconds} s) -> {_build.library_path().name}")
    for ln in _ptxas(_build.build_log):
        print("ptxas " + ln)
    # the cluster kernel: fft_fused2_kernel<T, false> is fft_fused2, <T,
    # true> the gap pass; no instance may spill
    for kname, tag in (("fft_fused2", "Lb0E"), ("fft_gap", "Lb1E")):
        lines = [ln for ln in _ptxas(_build.build_log)
                 if "fft_fused2_kernel" in ln and tag in ln.split(":")[0]]
        for ln in lines:
            print(f"ptxas {kname} (cluster kernel): " + ln)
        if len(lines) != 2 or not all(
                re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln)
                for ln in lines):
            raise AssertionError(f"{kname} ptxas: {lines}")
    # fft_fused2's register body: one instance per FUSED2_REGS geometry and
    # plane type, and an f32 one reading interleaved complex64 input (its
    # IL template argument true: Lb1E); none may spill
    regs_ptxas = [ln for ln in _ptxas(_build.build_log)
                  if "fft_fused2_regs_kernel" in ln.split(":")[0]]
    for ln in regs_ptxas:
        tag = ", interleaved in" if "Lb1E" in ln.split(":")[0] else ""
        print(f"ptxas fft_fused2 (register body{tag}): " + ln)
    if len(regs_ptxas) != 3 * len(sk.FUSED2_REGS) or sum(
            "Lb1E" in ln.split(":")[0] for ln in regs_ptxas) != len(
                sk.FUSED2_REGS) or not all(
            re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln)
            for ln in regs_ptxas):
        raise AssertionError(f"fft_fused2_regs_kernel ptxas: {regs_ptxas}")
    # the matmul kernels: products on tensor cores (3xTF32 mma.sync), no
    # spills; fft_mm_kernel<false> is fft_mm1, <true> fft_mm2
    mm_ptxas = [ln for ln in _ptxas(_build.build_log) if "fft_mm_kernel" in ln]
    if len(mm_ptxas) != 2 or not all(
            re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln)
            for ln in mm_ptxas):
        raise AssertionError(f"fft_mm ptxas: {mm_ptxas}")
    # the row kernel of fft_last: one instance per admitted length and
    # plane type, none may spill
    last_ptxas = [ln for ln in _ptxas(_build.build_log)
                  if "fft_last_kernel" in ln]
    n_last = sum(1 for n in range(2, sk.MAX_LAST_N + 1)
                 if sk.kernel_len_ok(n, True))
    f64_lengths = [n for n in range(2, sk.MAX_F64_N + 1) if sk.f64_len_ok(n)]
    if len(last_ptxas) != 2 * n_last + len(f64_lengths) or not all(
            re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln)
            for ln in last_ptxas):
        raise AssertionError(f"fft_last ptxas: {last_ptxas}")
    print(f"ptxas fft_last_kernel: {len(last_ptxas)} instances (f32, bf16 "
          f"and f64), 0 spill bytes in each")
    # the column kernel of fft_cols/fft_axis0: one instance per length the
    # mid-axis gate admits and plane type, and an f32 one per power of two
    # writing interleaved complex64 (its IO ColsIlIO); none may spill
    cols_all = [ln for ln in _ptxas(_build.build_log)
                if "fft_cols_kernel" in ln]
    cols_il = [ln for ln in cols_all if "ColsIlIO" in ln.split(":")[0]]
    cols_ptxas = [ln for ln in cols_all if ln not in cols_il]
    cols_lengths = [n for n in range(2, sk.MAX_STOCKHAM_N + 1)
                    if sk.kernel_len_ok(n, False)]
    il_lengths = [n for n in cols_lengths
                  if sk.cols_writes_complex(n, torch.float32)]
    if len(cols_ptxas) != 2 * len(cols_lengths) + len(f64_lengths) or len(
            cols_il) != len(il_lengths) or not all(
            re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln)
            for ln in cols_all):
        raise AssertionError(f"fft_cols ptxas: {cols_all}")
    print(f"ptxas fft_cols_kernel: {len(cols_ptxas)} instances (f32, bf16 "
          f"and f64) and {len(cols_il)} interleaved-out (f32), 0 spill bytes "
          f"in each")
    print("ptxas fft_cols_kernel interleaved out, registers by n: "
          + str(dict(sorted((int(re.search(r"Li(\d+)E", ln.split(
              "fft_cols_kernel", 1)[1]).group(1)), int(re.search(
                  r"Used (\d+) registers", ln).group(1))) for ln in cols_il))))
    # the f64 instances' registers and spills, and the f32 and bf16
    # instances' registers held to the parent's build (the f64 instances
    # share their templated bodies, which must compile to the same code)
    for kname, lines in (("fft_last_kernel", last_ptxas),
                         ("fft_cols_kernel", cols_ptxas)):
        for ln in lines:
            if f"{kname}Id" in ln.split(":")[0]:
                print(f"ptxas {kname} f64: {ln}")
        got = ptxas_registers(lines, kname)
        want = PARENT_REGISTERS[kname]
        print(f"ptxas {kname} f32/bf16 registers by (type, n), this build "
              f"against the parent build's: {got} / {want}")
        if got != want:
            raise AssertionError(f"{kname} f32/bf16 registers moved: {got} "
                                 f"against {want}")
    # the real pair kernels, on fft_last's row body: one instance per
    # length the real-kernel gate admits, none may spill
    real_lengths = [n for n in range(2, sk.MAX_REAL_N + 1)
                    if sk.r2c_last_supported(n)]
    for kname in ("fft_last_r2c_kernel", "ifft_last_c2r_kernel"):
        lines = [ln for ln in _ptxas(_build.build_log)
                 if kname in ln.split(":")[0]]
        if len(lines) != len(real_lengths) or not all(
                re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln)
                for ln in lines):
            raise AssertionError(f"{kname} ptxas: {lines}")
        print(f"ptxas {kname}: {len(lines)} instances, 0 spill bytes in "
              f"each")
    # the slab ring: the axis mode's instance per length of fft_cols' table
    # and plane type, the fuse_last mode's per sub-slab count (1, 2 or 4)
    # and plane type; none may spill
    for kname, count in (("fft_axis_ring_kernel", 2 * len(cols_lengths)),
                         ("fft_axes2_ring_kernel", 6)):
        lines = [ln for ln in _ptxas(_build.build_log)
                 if kname in ln.split(":")[0]]
        if len(lines) != count or not all(
                re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln)
                for ln in lines):
            raise AssertionError(f"{kname} ptxas: {lines}")
        print(f"ptxas {kname}: {len(lines)} instances, 0 spill bytes in "
              f"each")
    # the four-step column kernel: f32 with the twiddle at every power of
    # two 8..MAX_STOCKHAM_N (fft_cols_tw's n1, stage a's r1), and bf16 with
    # it and both types without it (stage b) at 8..64; none may spill
    fs_inst = [(n, dt, tw) for n in (1 << k for k in range(3, 12))
               for dt in (torch.float32, torch.bfloat16)
               for tw in (True, False)
               if n <= 64 or (dt == torch.float32 and tw)]
    fs_ptxas = [ln for ln in _ptxas(_build.build_log)
                if "fft_cols_fs_kernel" in ln.split(":")[0]]
    if len(fs_ptxas) != len(fs_inst) or not all(
            re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln)
            for ln in fs_ptxas):
        raise AssertionError(f"fft_cols_fs_kernel ptxas: {fs_ptxas}")
    print(f"ptxas fft_cols_fs_kernel: {len(fs_ptxas)} instances, 0 spill "
          f"bytes in each")
    tensor_ops = _tensor_ops(str(_build.library_path()))
    hmma = {}
    for kname, tag in (("fft_mm1", "fft_mm_kernelILb0E"),
                       ("fft_mm2", "fft_mm_kernelILb1E")):
        hmma[kname] = sum(c for f, c in tensor_ops.items() if tag in f)
    print(f"tensor-core instructions (HMMA/HGMMA) in the SASS: {hmma}; all "
          f"other kernels {sum(tensor_ops.values()) - sum(hmma.values())}")
    if min(hmma.values()) < 1:
        raise AssertionError(f"fft_mm kernels without tensor-core "
                             f"instructions: {hmma}")

    # the cluster size of fft_fused2 at the main path's shapes and how many
    # such clusters the card holds at once
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for p_, n1, n2 in ((512, 512, 512), (1024, 256, 256), (16, 512, 512),
                       (4, 256, 256)):
        c = sk.fused2_cluster(n1, n2, p_, sms)
        act = [sk.fused2_active_clusters(n1, n2, c, dt)
               for dt in (torch.float32, torch.bfloat16)]
        g = sk.fused2_regs_geometry(n1, n2, c)
        body = ("the register body, persistent" if g
                else "the stage walk, one plane a cluster")
        print(f"fft_fused2 {(p_, n1, n2)}: {body}: cluster {c} CTAs of "
              f"{g['threads'] if g else sk.FUSED2_THREADS} threads, "
              f"{sk.fused2_cta_smem(n1, n2, c)} B shared memory each; "
              f"cudaOccupancyMaxActiveClusters f32 {act[0]}, bf16 {act[1]} "
              f"({sms} SMs; the register body's grid covers "
              f"{act[0] * c} of them)")
        if min(act) < 1:
            raise AssertionError(f"fft_fused2 {(n1, n2)}: no cluster fits")
    # the same for the gap pass's strided instance: 512^3 and 4 x 256^3 as
    # (B, z, Y, x), b * y planes
    for b_, z_, y_, x_ in ((1, 512, 512, 512), (4, 256, 256, 256)):
        c = sk.fused2_cluster(z_, x_, b_ * y_, sms)
        act = [sk.fused2_active_clusters(z_, x_, c, dt, gap=True)
               for dt in (torch.float32, torch.bfloat16)]
        print(f"fft_gap {(b_, z_, y_, x_)}: cluster {c} CTAs of "
              f"{sk.FUSED2_THREADS} threads, "
              f"{sk.fused2_smem_bytes(z_, x_, c)} B shared memory each; "
              f"cudaOccupancyMaxActiveClusters f32 {act[0]}, bf16 {act[1]} "
              f"({sms} SMs)")
        if min(act) < 1:
            raise AssertionError(f"fft_gap {(z_, x_)}: no cluster fits")
    # the fuse_last ring: fft_fused2's cluster, its sub-slabs and TMA boxes,
    # and how many clusters the card holds at once (the persistent grid)
    for p_, n1, n2 in ((512, 512, 512), (1024, 256, 256)):
        for dt in (torch.float32, torch.bfloat16):
            g = sk.axes2_ring_geometry(n1, n2, p_, dt, sms)
            act = sk.axes2_ring_active_clusters(n1, n2, g["C"], dt)
            print(f"fft_axes2_ring {(p_, n1, n2)} {str(dt)[6:]}: cluster "
                  f"{g['C']} CTAs of {sk.FUSED2_THREADS} threads, "
                  f"{g['subslabs']} sub-slabs of {g['ws']} columns, TMA "
                  f"boxes ({g['ws']}, {g['box_rows']}), {g['tx_bytes']} B a "
                  f"sub-slab's mbarrier, {g['smem_bytes']} B dynamic shared "
                  f"memory; cudaOccupancyMaxActiveClusters {act}: "
                  f"{min(act, p_)} persistent clusters ({sms} SMs)")
            if act < 1:
                raise AssertionError(f"fft_axes2_ring {(n1, n2)}: no cluster "
                                     f"fits")
    # the axis ring at every length: ring depth K, tile width, blocks an SM,
    # registers, shared bytes; the C geometry must be the Python mirror's
    for n in cols_lengths:
        res = {dt: sk.axis_ring_residency(n, dt)
               for dt in (torch.float32, torch.bfloat16)}
        for dt, r in res.items():
            g = sk.ring_geometry(n, dt)
            if ((r["depth"], r["columns_per_block"], r["threads_per_block"],
                 r["smem_bytes"]) != (g["depth"], g["C"], g["threads"],
                                      g["smem_bytes"])
                    or r["blocks_per_sm"] < 1):
                raise AssertionError(f"fft_axis_ring n={n} {dt}: {r} vs {g}")
        print(f"fft_axis_ring residency n={n}: " + "; ".join(
            f"{str(dt)[6:]} K={r['depth']} slabs of {r['columns_per_block']} "
            f"columns ({r['threads_per_block']} threads), "
            f"{r['blocks_per_sm']} blocks/SM, {r['registers']} registers, "
            f"{r['smem_bytes']} B shared" for dt, r in res.items()))
    # where fft_last's instances sit: resident blocks an SM
    # (cudaOccupancyMaxActiveBlocksPerMultiprocessor), rows and threads a
    # block, registers a thread, shared bytes a block
    for n in range(2, sk.MAX_LAST_N + 1):
        if not sk.kernel_len_ok(n, True):
            continue
        res = {str(dt)[6:]: sk.last_residency(n, dt)
               for dt in (torch.float32, torch.bfloat16)}
        print(f"fft_last residency n={n} stages {sk.last_stages(n)}: "
              + "; ".join(f"{k} {r['blocks_per_sm']} blocks/SM x "
                          f"{r['rows_per_block']} rows ({r['threads_per_block']}"
                          f" threads), {r['registers']} registers, "
                          f"{r['smem_bytes']} B shared" for k, r in res.items()))
        if min(r["blocks_per_sm"] for r in res.values()) < 1:
            raise AssertionError(f"fft_last n={n}: no block fits an SM")
    # and fft_cols's: resident blocks an SM, columns and threads a block,
    # registers a thread, shared bytes a block, at every length
    for n in cols_lengths:
        res = {str(dt)[6:]: sk.cols_residency(n, dt)
               for dt in (torch.float32, torch.bfloat16)}
        print(f"fft_cols residency n={n} stages {sk.cols_stages(n)}: "
              + "; ".join(f"{k} {r['blocks_per_sm']} blocks/SM x "
                          f"{r['columns_per_block']} columns "
                          f"({r['threads_per_block']} threads), "
                          f"{r['registers']} registers, {r['smem_bytes']} B "
                          f"shared" for k, r in res.items()))
        if min(r["blocks_per_sm"] for r in res.values()) < 1:
            raise AssertionError(f"fft_cols n={n}: no block fits an SM")
    # and the f64 instances' of both, at every power of two they take
    for n in f64_lengths:
        rl, rc = (sk.last_residency(n, torch.float64),
                  sk.cols_residency(n, torch.float64))
        print(f"f64 residency n={n}: fft_last {rl['blocks_per_sm']} "
              f"blocks/SM x {rl['rows_per_block']} rows "
              f"({rl['threads_per_block']} threads), {rl['registers']} "
              f"registers, {rl['smem_bytes']} B shared; fft_cols "
              f"{rc['blocks_per_sm']} blocks/SM x {rc['columns_per_block']} "
              f"columns ({rc['threads_per_block']} threads), "
              f"{rc['registers']} registers, {rc['smem_bytes']} B shared")
        if min(rl["blocks_per_sm"], rc["blocks_per_sm"]) < 1:
            raise AssertionError(f"f64 n={n}: no block fits an SM")
    # and the four-step column kernel's: resident blocks an SM, columns and
    # threads a block, registers a thread, shared bytes a block
    for n in sorted({n for n, _, _ in fs_inst}):
        res = {f"{str(dt)[6:]} {'twiddle' if tw else 'stage b'}":
               sk.fourstep_residency(n, dt, tw)
               for m, dt, tw in fs_inst if m == n}
        print(f"fft_cols_fs residency n={n} stages {sk.cols_stages(n)}: "
              + "; ".join(f"{k} {r['blocks_per_sm']} blocks/SM x "
                          f"{r['columns_per_block']} columns "
                          f"({r['threads_per_block']} threads), "
                          f"{r['registers']} registers, {r['smem_bytes']} B "
                          f"shared" for k, r in res.items()))
        if min(r["blocks_per_sm"] for r in res.values()) < 1:
            raise AssertionError(f"fft_cols_fs n={n}: no block fits an SM")
    # and the real pair kernels': resident blocks an SM, row pairs and
    # threads a block, registers a thread, shared bytes a block
    for n in real_lengths:
        res = {k: sk.real_residency(n, k == "c2r") for k in ("r2c", "c2r")}
        print(f"real residency n={n} stages {sk.last_stages(n)}: "
              + "; ".join(f"{k} {r['blocks_per_sm']} blocks/SM x "
                          f"{r['pairs_per_block']} pairs "
                          f"({r['threads_per_block']} threads), "
                          f"{r['registers']} registers, {r['smem_bytes']} B "
                          f"shared" for k, r in res.items()))
        if min(r["blocks_per_sm"] for r in res.values()) < 1:
            raise AssertionError(f"real n={n}: no block fits an SM")
    phase("2 (build)")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape):
        return torch.randn(shape, device=dev, generator=gen)

    def planes(shape):
        return randn(shape), randn(shape)

    # the port's timer (utils/timing.py), the one Plan.benchmark, bench_cli
    # and the planner races use: the median ms of 10 runs after one
    # warm-up, each between CUDA events after an L2 flush
    timed = functools.partial(timing.time_ms, device=dev)

    src = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_ms = timed(lambda: dst.copy_(src))
    copy_bw = 2 * src.numel() * 4 / (copy_ms * 1e-3)
    print(f"copy_: 1 GiB read + 1 GiB written in {copy_ms:.4f} ms = "
          f"{copy_bw / 1e12:.3f} TB/s (datasheet {bw / 1e12} TB/s)")
    del src, dst

    def bound(nbytes, nflops):
        """Least ms for the work: bytes over the memory rate or flops over
        the FP32 rate, whichever is larger."""
        t_bytes, t_ops = nbytes / bw, nflops / fp32
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                          else "operations")

    def dev_rel(a, b):
        """rel_l2 on the card, in float64."""
        a, b = a.to(torch.complex128), b.to(torch.complex128)
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    def peak_bytes(fn):
        """Peak device memory of one call of fn, and its rise over what was
        allocated before it (max_memory_allocated after
        reset_peak_memory_stats)."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del out
        return peak, peak - before

    # 3a. every length the gates admit, ragged batches and column counts,
    # both signs, against torch.fft in float64
    plain_worst = {}   # kernel: worst rel_l2 against its plain version

    def check(kname, fn, shape, dims, sign, scale=0.5, plain=None):
        xr, xi = planes(shape)
        yr, yi = fn(xr, xi, sign, scale)
        x = torch.complex(xr.double(), xi.double())
        ref = (torch.fft.fftn(x, dim=dims) if sign < 0
               else torch.fft.ifftn(x, dim=dims, norm="forward")) * scale
        n = int(np.prod([shape[d] for d in dims]))
        err = rel_l2(torch.complex(yr, yi), ref)
        e_plain = 0.0
        if plain is not None:
            e_plain = dev_rel(torch.complex(yr, yi),
                              torch.complex(*plain(xr, xi, sign, scale)))
            plain_worst[kname] = max(plain_worst.get(kname, 0.0), e_plain)
        if not (err <= tolerance(n) and e_plain <= tolerance(n)):
            raise AssertionError(f"{kname}{shape} sign {sign}: rel_l2 {err}, "
                                 f"vs plain {e_plain} > {tolerance(n)}")
        return err

    lengths = [2 ** k for k in range(1, 12)] + [
        n for n in range(16, 2049, 8) if n & (n - 1) and n >= 128
        and sk.kernel_len_ok(n, False)]

    def last_batches(n):
        """fft_last's batches at length n: one row, 37, and one past a whole
        block (ragged, where a block holds more than one row)."""
        return sorted({1, 37, sk.last_geometry(n)[1] + 1})

    worst = 0.0
    for n in lengths:
        for sign in (-1, 1):
            if sk.kernel_len_ok(n, True):
                for b in last_batches(n):
                    worst = max(worst, check("fft_last", sk.fft_last, (b, n),
                                             (1,), sign,
                                             plain=sk.fft_last_plain))
            worst = max(worst, check("fft_cols", sk.fft_cols, (3, n, 45),
                                     (1,), sign))
    # the pairs of the gap and ring sweeps; fft_fused2 takes every pair
    # fused2_supported admits (n1 * n2 <= 262144 caps both axes), the ring
    # the 93 of them fused2_ring_supported admits (n2 <= 2048)
    f2_pairs = [(a, b) for a in range(16, 2049) if sk._fusable_len(a, False)
                for b in range(128, 16385, 128) if sk._fusable_len(b, True)
                and sk.fused2_supported(a, b)]
    ring_pairs = [ab for ab in f2_pairs if sk.fused2_ring_supported(*ab)]
    if len(f2_pairs) != 113 or len(ring_pairs) != 93:
        raise AssertionError(f"fused2 pairs: {len(f2_pairs)}, ring pairs: "
                             f"{len(ring_pairs)}")

    def vs_plain(kname, kern, plain, shape, n, sign):
        """rel_l2 of a kernel against its plain version on new planes."""
        xr, xi = planes(shape)
        e = dev_rel(torch.complex(*kern(xr, xi, sign, 0.5)),
                    torch.complex(*plain(xr, xi, sign, 0.5)))
        if not e <= tolerance(n):
            raise AssertionError(f"{kname}{shape} sign {sign}: rel_l2 vs "
                                 f"plain {e} > {tolerance(n)}")
        return e

    f2_plain = 0.0
    for n1, n2 in f2_pairs:
        for sign in (-1, 1):
            shape = (3, n1, n2)
            worst = max(worst, check("fft_fused2", sk.fft_fused2, shape,
                                     (1, 2), sign))
            f2_plain = max(f2_plain, vs_plain(
                "fft_fused2", sk.fft_fused2, sk.fft_fused2_plain, shape,
                n1 * n2, sign))
    print(f"sweep: {len(lengths)} lengths (last/cols), all {len(f2_pairs)} "
          f"fused2 pairs, both signs: worst rel_l2 vs torch.fft {worst:.3e}; "
          f"fft_fused2 vs fft_fused2_plain {f2_plain:.3e}; fft_last (B = 1, "
          f"37 and a ragged block) vs fft_last_plain "
          f"{plain_worst['fft_last']:.3e}")

    # the C2C kernels on bf16 planes: the same lengths and pairs, against
    # their plain versions (within PLAIN_LIMIT) and torch.fft in float64 of
    # the bf16-rounded input (within tolerance(n, "complex32"))
    def cplx(yr, yi):
        return torch.complex(yr.double(), yi.double())

    bf_worst = {}   # kernel: [worst vs float64, worst vs plain, cases]

    def note_bf16(key, e_ref, e_plain):
        w = bf_worst.setdefault(key, [0.0, 0.0, 0])
        w[:] = max(w[0], e_ref), max(w[1], e_plain), w[2] + 1

    def check_bf16(kname, shape, dims, sign, scale=0.5, kern=None,
                   plain=None):
        kern = kern or getattr(sk, kname)
        plain = plain or getattr(sk, kname + "_plain")
        xr, xi = (t.to(torch.bfloat16) for t in planes(shape))
        yr, yi = kern(xr, xi, sign, scale)
        if yr.dtype != torch.bfloat16 or yi.dtype != torch.bfloat16:
            raise AssertionError(f"{kname}_bf16{shape}: output {yr.dtype}")
        x = cplx(xr, xi)
        ref = (torch.fft.fftn(x, dim=dims) if sign < 0
               else torch.fft.ifftn(x, dim=dims, norm="forward")) * scale
        n = int(np.prod([shape[d] for d in dims]))
        y = cplx(yr, yi)
        e_ref = rel_l2(y, ref)
        e_plain = rel_l2(y, cplx(*plain(xr, xi, sign, scale)))
        tol, lim = tolerance(n, "complex32"), PLAIN_LIMIT[kname + "_bf16"]
        if not (e_ref <= tol and e_plain <= lim):
            raise AssertionError(f"{kname}_bf16{shape} sign {sign}: rel_l2 vs "
                                 f"torch.fft {e_ref} (limit {tol}), vs plain "
                                 f"{e_plain} (limit {lim})")
        note_bf16(kname + "_bf16", e_ref, e_plain)

    for kname, shape, dims in (
            [("fft_last", (b, n), (1,)) for n in lengths
             if sk.kernel_len_ok(n, True) for b in last_batches(n)]
            + [("fft_cols", (3, n, 45), (1,)) for n in lengths]
            + [("fft_fused2", (3, n1, n2), (1, 2)) for n1, n2 in f2_pairs]):
        for sign in (-1, 1):
            check_bf16(kname, shape, dims, sign)

    # fft_cols on f32 and bf16 planes and fft_axis0 at every length the
    # mid-axis gate admits: P = 3 planes of V = 1, 37, one tile and one tile
    # + 1 columns (fft_axis0: V = 1, 37 and one tile + 1), both signs,
    # against torch.fft in float64 (tolerance(n), tolerance(n, "complex32")
    # in bf16) and the plain versions (tolerance(n), PLAIN_LIMIT in bf16)
    cols_worst = {}
    for n in cols_lengths:
        tiles = {dt: sk.cols_residency(n, dt)["columns_per_block"]
                 for dt in (torch.float32, torch.bfloat16)}
        for sign in (-1, 1):
            for v in sorted({1, 37, tiles[torch.float32],
                             tiles[torch.float32] + 1}):
                e = check("fft_cols", sk.fft_cols, (3, n, v), (1,), sign,
                          plain=sk.fft_cols_plain)
                cols_worst["fft_cols"] = max(cols_worst.get("fft_cols", 0.0),
                                             e)
            for v in sorted({1, 37, tiles[torch.bfloat16],
                             tiles[torch.bfloat16] + 1}):
                check_bf16("fft_cols", (3, n, v), (1,), sign)
            for v in (1, 37, tiles[torch.float32] + 1):
                e = check("fft_axis0", sk.fft_axis0, (n, v), (0,), sign,
                          plain=sk.fft_axis0_plain)
                cols_worst["fft_axis0"] = max(
                    cols_worst.get("fft_axis0", 0.0), e)
    print(f"cols sweep: {len(cols_lengths)} lengths, V = 1, 37, a tile and a "
          f"tile + 1, P = 3, both signs: fft_cols vs torch.fft "
          f"{cols_worst['fft_cols']:.3e}, vs fft_cols_plain "
          f"{plain_worst['fft_cols']:.3e}; fft_axis0 vs torch.fft "
          f"{cols_worst['fft_axis0']:.3e}, vs fft_axis0_plain "
          f"{plain_worst['fft_axis0']:.3e}; fft_cols_bf16 vs float64 and vs "
          f"plain: {bf_worst['fft_cols_bf16'][:2]}")

    def packed_half(h, n):
        """(B, n/2+1) complex -> the packed (B, n/2) planes."""
        m = n // 2
        pr, pi = h.real[:, :m].contiguous(), h.imag[:, :m].clone()
        pi[:, 0] = h.real[:, m]
        return pr, pi.contiguous()

    def real_batches(n):
        """The real kernels' batches at length n: odd and even, and a half
        and a whole pair past a whole block of pairs."""
        rpb = sk.last_geometry(n)[1]
        return sorted({37, 38, 2 * rpb + 1, 2 * rpb + 2})

    worst = 0.0
    for n in real_lengths:
        m = n // 2
        for b in real_batches(n):
            x = randn((b, n))
            ref = torch.fft.rfft(x.double()) * 0.5
            h = torch.complex(randn((b, m + 1)), randn((b, m + 1)))
            hz = h.to(torch.complex128)          # numpy/irfft convention:
            hz.imag[:, 0] = 0.0                  # the endpoint bins' imaginary
            hz.imag[:, m] = 0.0                  # parts are ignored
            ref_c = torch.fft.irfft(hz, n=n) * n * 2.0
            for packed in (False, True):
                yr, yi = sk.fft_last_r2c(x, packed=packed, scale=0.5)
                want = ref
                if packed:
                    want = torch.complex(*packed_half(ref, n))
                err = rel_l2(torch.complex(yr, yi), want)
                e_r2c = dev_rel(torch.complex(yr, yi), torch.complex(
                    *sk.fft_last_r2c_plain(x, packed, 0.5)))
                hr, hi = (packed_half(h, n) if packed
                          else (h.real.contiguous(), h.imag.contiguous()))
                y = sk.ifft_last_c2r(hr, hi, n, packed=packed, scale=2.0)
                err_c = rel_l2(y, ref_c)
                e_c2r = dev_rel(y, sk.ifft_last_c2r_plain(hr, hi, n, packed,
                                                          2.0))
                for kname, e in (("fft_last_r2c", e_r2c),
                                 ("ifft_last_c2r", e_c2r)):
                    plain_worst[kname] = max(plain_worst.get(kname, 0.0), e)
                if not max(err, err_c, e_r2c, e_c2r) <= tolerance(n):
                    raise AssertionError(
                        f"real n={n} b={b} packed={packed}: r2c rel_l2 "
                        f"{err} (vs plain {e_r2c}), c2r {err_c} (vs plain "
                        f"{e_c2r}) > {tolerance(n)}")
                worst = max(worst, err, err_c)
    print(f"sweep: {len(real_lengths)} real lengths, batches 37, 38 and a "
          f"half and a whole pair past a block, narrow and packed: worst "
          f"rel_l2 vs torch.fft.rfft/irfft {worst:.3e}; vs the plain "
          f"versions fft_last_r2c {plain_worst['fft_last_r2c']:.3e}, "
          f"ifft_last_c2r {plain_worst['ifft_last_c2r']:.3e}")

    # every four-step last-axis length, through the plans a user makes
    fs_lengths = [1 << k for k in range(12, 22)]
    worst = 0.0
    for n in fs_lengths:
        g = torch.Generator(device=dev).manual_seed(n)
        x = torch.complex(torch.randn((3, n), device=dev, generator=g),
                          torch.randn((3, n), device=dev, generator=g))
        for direction in (rt.FORWARD, rt.BACKWARD):
            p = rt.make_plan((3, n), axes=(1,), backend="stockham",
                             direction=direction)
            if p.steps != [("stockham4", 1, n)]:
                raise AssertionError(f"(3, {n}) steps {p.steps}")
            xd = x.to(torch.complex128)
            ref = (torch.fft.fft(xd) if direction == rt.FORWARD
                   else torch.fft.ifft(xd))
            err = rel_l2(p(x), ref)
            if not err <= tolerance(n):
                raise AssertionError(f"four-step (3, {n}) {direction}: "
                                     f"rel_l2 {err} > {tolerance(n)}")
            worst = max(worst, err)
    print(f"sweep: {len(fs_lengths)} four-step lengths 4096..2^21, batch 3, "
          f"both signs: worst rel_l2 vs torch.fft {worst:.3e}")

    # the four-step kernels against their plain versions: fft_cols_tw at
    # every n1 of those lengths (the split's n2, and a ragged n2 below one
    # tile), the a0fs stages at every split of n = 64..4096 (pre 1 with
    # post 1024, and a ragged pre 2 with post 37; stage b on the plain stage
    # a's output), f32 and bf16, both signs
    a0_lengths = [1 << k for k in range(6, 13)]
    fs_cases = {}

    def fs_plain(kname, kern, plain, lim):
        e = dev_rel(cplx(*kern()), cplx(*plain()))
        w = fs_cases.setdefault(kname, [0.0, 0])
        w[:] = max(w[0], e), w[1] + 1
        if not e <= lim:
            raise AssertionError(f"{kname}: rel_l2 vs plain {e} > {lim}")

    for n in fs_lengths:
        n1, n2 = sk._four_step_split(n)
        cols = sk.fourstep_residency(n1)["columns_per_block"]
        for shape in ((3, n1, n2), (3, n1, cols // 2)):
            xr, xi = planes(shape)
            for sign in (-1, 1):
                fs_plain("fft_cols_tw",
                         lambda: fs.fft_cols_tw(xr, xi, sign),
                         lambda: fs.fft_cols_tw_plain(xr, xi, sign),
                         tolerance(n1 * shape[2]))
    for n in a0_lengths:
        for dt in (torch.float32, torch.bfloat16):
            sfx = sk.C2C_DTYPES[dt]
            lim = PLAIN_LIMIT["a0fs_a_bf16"] if sfx else tolerance(n)
            for pre, post in ((1, 1024), (2, 37)):
                xr, xi = (t.to(dt) for t in planes((pre, n, post)))
                for sign in (-1, 1):
                    mid = fs.a0fs_stage_plain("a", xr, xi, sign)
                    fs_plain("a0fs_a" + sfx,
                             lambda: fs.a0fs_stage("a", xr, xi, sign),
                             lambda: mid, lim)
                    fs_plain("a0fs_b" + sfx,
                             lambda: fs.a0fs_stage("b", *mid, sign, 0.5),
                             lambda: fs.a0fs_stage_plain("b", *mid, sign,
                                                         0.5), lim)
    print("sweep: the four-step kernels against their plain versions "
          "(fft_cols_tw every n1, the split's and a ragged n2; a0fs every "
          "split of 64..4096, post 1024 and a ragged 37; both signs): "
          + ", ".join(f"{k} {c} cases worst {w:.3e}"
                      for k, (w, c) in fs_cases.items()))

    # the leading-axis four-step at every gated length; the ring at every
    # length of its instance table (fft_cols': trailing extent ragged
    # against the tile) and all 93 ring pairs, both signs, against
    # torch.fft in float64 and the plain version
    def on_axis(fn, axis):
        return lambda xr, xi, s, sc: fn(xr, xi, axis, rt.Direction(s), sc)

    worst = 0.0
    for n in a0_lengths:
        for sign in (-1, 1):
            worst = max(worst, check("fft_axis0_fourstep",
                                     on_axis(fs.fft_axis0_fourstep, 0),
                                     (n, 8, 128), (0,), sign))
            worst = max(worst, check("fft_axis0_fourstep",
                                     on_axis(fs.fft_axis0_fourstep, 1),
                                     (2, n, 8, 128), (1,), sign))
    def ring_fn(fuse, plain=False):
        f = fs.fft_axis_ring_plain if plain else fs.fft_axis_ring
        return lambda xr, xi, s, sc: f(xr, xi, s, sc, fuse)

    ring_worst = 0.0
    for n in cols_lengths:
        for sign in (-1, 1):
            ring_worst = max(ring_worst, check(
                "fft_axis_ring", ring_fn(False), (3, n, 36), (1,), sign,
                plain=ring_fn(False, True)))
    for n1, n2 in ring_pairs:
        for sign in (-1, 1):
            ring_worst = max(ring_worst, check(
                "fft_axes2_ring", ring_fn(True), (3, n1, n2), (1, 2), sign,
                plain=ring_fn(True, True)))
    print(f"sweep: leading-axis four-step n = 64..4096 (axes 0 and 1), both "
          f"signs: worst rel_l2 {worst:.3e}; ring: {len(cols_lengths)} "
          f"lengths and all {len(ring_pairs)} fused pairs, both signs: worst vs "
          f"torch.fft {ring_worst:.3e}, vs fft_axis_ring_plain "
          f"{plain_worst['fft_axis_ring']:.3e} (axis), "
          f"{plain_worst['fft_axes2_ring']:.3e} (fuse_last)")

    # the bf16 ring at the same lengths (post % 8 == 0, ragged against the
    # tile width) and pairs, against its plain version and float64
    for fuse, shapes in ((False, [(3, n, 40) for n in cols_lengths]),
                         (True, [(3, n1, n2) for n1, n2 in ring_pairs])):
        rname = "fft_axes2_ring" if fuse else "fft_axis_ring"
        for shape in shapes:
            for sign in (-1, 1):
                check_bf16(rname, shape, (1, 2) if fuse else (1,), sign,
                           kern=ring_fn(fuse), plain=ring_fn(fuse, True))
    # the gap-fused pass on every fused2 pair, B = 2 and Y = 3, both types;
    # the f32 pass also against its plain version
    gap_worst = gap_plain = 0.0
    for n1, n2 in f2_pairs:
        if not sk.fused_gap_supported(n1, n2):
            raise AssertionError(f"gap pair {(n1, n2)} not supported")
        shape = (2, n1, 3, n2)
        for sign in (-1, 1):
            gap_worst = max(gap_worst, check("fft_gap", sk.fft_axes_gap,
                                             shape, (1, 3), sign))
            gap_plain = max(gap_plain, vs_plain(
                "fft_gap", sk.fft_axes_gap, sk.fft_axes_gap_plain, shape,
                n1 * n2, sign))
            check_bf16("fft_gap", shape, (1, 3), sign,
                       kern=sk.fft_axes_gap, plain=sk.fft_axes_gap_plain)
    print(f"sweep: fft_gap all {len(f2_pairs)} fused2 pairs (B = 2, Y = 3), "
          f"both signs: worst rel_l2 vs torch.fft {gap_worst:.3e}; "
          f"fft_gap vs fft_axes_gap_plain {gap_plain:.3e}")
    # the bf16 leading-axis four-step at every gated length: bf16 out from
    # r1 = 16 (n = 256), f32 planes out below, as in the JAX package; each
    # stage also against its plain version (stage b on the plain stage a)
    worst = worst_stage = 0.0
    for n in a0_lengths:
        r1 = sk._a0fs_split(n)[0]
        want = torch.bfloat16 if r1 >= 16 else torch.float32
        lim = PLAIN_LIMIT["a0fs_a_bf16"] if r1 >= 16 else tolerance(n)
        for shape, axis in (((n, 8, 128), 0), ((2, n, 8, 128), 1)):
            xr, xi = (t.to(torch.bfloat16) for t in planes(shape))
            xd = cplx(xr, xi)
            sr, si = (t.to(want).reshape(shape[0] if axis else 1, n, 1024)
                      for t in (xr, xi))
            for sign in (-1, 1):
                yr, yi = fs.fft_axis0_fourstep(xr, xi, axis,
                                               rt.Direction(sign), 0.5)
                if yr.dtype != want:
                    raise AssertionError(f"bf16 four-step {shape}: {yr.dtype}")
                ref = (torch.fft.fft(xd, dim=axis) if sign < 0 else
                       torch.fft.ifft(xd, dim=axis, norm="forward")) * 0.5
                err = rel_l2(cplx(yr, yi), ref)
                mid = fs.a0fs_stage_plain("a", sr, si, sign)
                e_a = rel_l2(cplx(*fs.a0fs_stage("a", sr, si, sign)),
                             cplx(*mid))
                e_b = rel_l2(cplx(*fs.a0fs_stage("b", *mid, sign, 0.5)),
                             cplx(*fs.a0fs_stage_plain("b", *mid, sign, 0.5)))
                if not (err <= tolerance(n, "complex32")
                        and max(e_a, e_b) <= lim):
                    raise AssertionError(
                        f"bf16 four-step {shape} sign {sign}: rel_l2 {err}; "
                        f"stages vs plain {e_a}, {e_b} (limit {lim})")
                worst = max(worst, err)
                worst_stage = max(worst_stage, e_a, e_b)
    print(f"sweep bf16: leading-axis four-step n = 64..4096 (axes 0 and 1), "
          f"both signs: worst rel_l2 vs torch.fft float64 {worst:.3e}, "
          f"stages vs plain {worst_stage:.3e}")
    for kname, (e_ref, e_plain, count) in bf_worst.items():
        print(f"sweep bf16: {kname} {count} cases (odd batches, both signs): "
              f"worst rel_l2 vs torch.fft float64 {e_ref:.3e}, vs plain "
              f"{e_plain:.3e} (limit {PLAIN_LIMIT[kname]})")

    # the matmul-form kernels at every length they take, both signs:
    # fft_mm1 at n = 1..128 (batch 37) against torch.fft in float64 on the
    # host; fft_mm2 at every n <= 16384 that two_stage_split admits (batch
    # 3) against fft_mm2_plain on the card, and every 16th of those lengths
    # and the main path's against torch.fft in float64 on the host (a cuFFT
    # plan for each of 4165 lengths, most with odd factors, would cost
    # minutes)
    def mm_errs(lengths, batch, kern, plain=None, ref_lengths=None):
        """Worst rel_l2 against float64 and against `plain`; raises with
        the lengths beyond tolerance(n)."""
        worst, worst_plain, bad = 0.0, 0.0, []
        for n in lengths:
            xr, xi = planes((batch, n))
            with_ref = ref_lengths is None or n in ref_lengths
            x = (torch.complex(xr.double(), xi.double()).cpu() if with_ref
                 else None)
            for sign in (-1, 1):
                y = torch.complex(*kern(n, xr, xi, sign))
                if plain is not None:
                    e = dev_rel(y, torch.complex(*plain(n, xr, xi, sign)))
                    worst_plain = max(worst_plain, e)
                    if not e <= tolerance(max(n, 2)):
                        bad.append((n, sign, "plain", e))
                if not with_ref:
                    continue
                ref = (torch.fft.fft(x) if sign < 0
                       else torch.fft.ifft(x, norm="forward"))
                y = y.cpu().to(torch.complex128)
                e = float(torch.linalg.vector_norm(y - ref)
                          / torch.linalg.vector_norm(ref))
                worst = max(worst, e)
                if not e <= tolerance(max(n, 2)):
                    bad.append((n, sign, "float64", e))
        if bad:
            raise AssertionError(f"matmul-form sweep: (n, sign, against, "
                                 f"rel_l2) {bad[:8]}")
        return worst, worst_plain

    w1, _ = mm_errs(range(1, 129), 37,
                    lambda n, xr, xi, s: pf.fft_mm1(xr, xi, n, s))
    mm2_lengths = [n for n in range(2, 16385) if pf.two_stage_split(n)]
    mm2_ref = set(mm2_lengths[::16]) | {256, 512, 640, 1024}
    w2, w2_plain = mm_errs(
        mm2_lengths, 3,
        lambda n, xr, xi, s: pf.fft_mm2(xr, xi, *pf.two_stage_split(n), s),
        lambda n, xr, xi, s: pf.fft_mm2_plain(xr, xi, *pf.two_stage_split(n),
                                              s), mm2_ref)
    print(f"sweep: fft_mm1 n = 1..128 (batch 37): worst rel_l2 vs torch.fft "
          f"float64 {w1:.3e}; fft_mm2 {len(mm2_lengths)} lengths "
          f"{mm2_lengths[0]}..{mm2_lengths[-1]} (batch 3): worst vs "
          f"fft_mm2_plain {w2_plain:.3e}, {len(mm2_ref)} of them vs "
          f"torch.fft float64 {w2:.3e}; both signs")
    phase("3a (sweeps)")

    # 3b. kernels at the main path's shapes against their plain versions
    def kernel_case(shape, n, pairs, kern, plain, lib, nbytes, nflops,
                    limit=None):
        """`pairs`: (kernel thunk, plain thunk) pairs, each returning one
        tensor, compared within `limit` (default tolerance(n)); `kern`,
        `plain`, `lib`: thunks timed."""
        limit = limit or tolerance(n)
        max_abs = max_rel = 0.0
        for k_fn, p_fn in pairs:
            k, p = k_fn(), p_fn()
            torch.cuda.synchronize()
            rel = dev_rel(k, p)
            if not rel <= limit:
                raise AssertionError(f"{shape}: kernel vs plain rel_l2 {rel} "
                                     f"> {limit}")
            max_rel = max(max_rel, rel)
            max_abs = max(max_abs, float(torch.max(torch.abs(k - p))))
            del k, p
        b_ms, b_by = bound(nbytes, nflops)
        return {"shape": list(shape), "n": n, "max_abs_err": max_abs,
                "max_rel_err": max_rel, "plain_limit": limit,
                "ms": timed(kern), "plain_ms": timed(plain), "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None if lib is None else timed(lib)}

    def entry_case(name, shape, kern, plain, lib, nbytes, nflops):
        """An entry that runs several kernels, timed as a whole."""
        b_ms, b_by = bound(nbytes, nflops)
        return {"name": name, "shape": list(shape), "ms": timed(kern),
                "plain_ms": timed(plain), "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timed(lib)}

    def c2c_case(kname, shape, dims, kern=None, plain=None):
        kern = kern or getattr(sk, kname)
        plain = plain or getattr(sk, kname + "_plain")
        n = int(np.prod([shape[d] for d in dims]))
        xr, xi = planes(shape)
        scale = 1.0 / math.sqrt(n)
        pairs = [(lambda s=s: torch.complex(*kern(xr, xi, s, scale)),
                  lambda s=s: torch.complex(*plain(xr, xi, s, scale)))
                 for s in (-1, 1)]
        xc = torch.complex(xr, xi)
        case = kernel_case(shape, n, pairs, lambda: kern(xr, xi, -1, 1.0),
                           lambda: plain(xr, xi, -1, 1.0),
                           lambda: torch.fft.fftn(xc, dim=dims),
                           16 * xr.numel(),
                           5 * xr.numel() * math.log2(n))
        del xr, xi, xc
        return case

    def dst1_case(n):
        """``fft_last`` on the (n^2, 2(n+1)) planes of an n^3 DST-I's axis,
        [0, x, 0, -rev(x)] and zeros, against ``fft_last_plain``."""
        x = randn((n * n, n))
        z = x.new_zeros((n * n, 1))
        vr = torch.cat([z, x, z, -x.flip(1)], 1)
        vi = torch.zeros_like(vr)
        del x, z
        L = vr.shape[1]
        vc = torch.complex(vr, vi)
        case = kernel_case(
            tuple(vr.shape), L,
            [(lambda: torch.complex(*sk.fft_last(vr, vi, -1)),
              lambda: torch.complex(*sk.fft_last_plain(vr, vi, -1)))],
            lambda: sk.fft_last(vr, vi, -1),
            lambda: sk.fft_last_plain(vr, vi, -1),
            lambda: torch.fft.fft(vc), 16 * vr.numel(),
            5 * vr.numel() * math.log2(L))
        del vr, vi, vc
        return case

    def r2c_case(shape, packed):
        b, n = shape
        x = randn(shape)
        scale = 1.0 / math.sqrt(n)
        w = n // 2 if packed else n // 2 + 1
        pairs = [(lambda: torch.complex(*sk.fft_last_r2c(x, packed, scale)),
                  lambda: torch.complex(*sk.fft_last_r2c_plain(x, packed,
                                                               scale)))]
        case = kernel_case(shape, n, pairs,
                           lambda: sk.fft_last_r2c(x, packed),
                           lambda: sk.fft_last_r2c_plain(x, packed),
                           lambda: torch.fft.rfft(x),
                           4 * b * n + 8 * b * w, 2.5 * b * n * math.log2(n))
        case["layout"] = "packed" if packed else "narrow"
        del x
        return case

    def c2r_case(shape, packed):
        b, n = shape
        m = n // 2
        h = torch.complex(randn((b, m + 1)), randn((b, m + 1)))
        hr, hi = (packed_half(h, n) if packed
                  else (h.real.contiguous(), h.imag.contiguous()))
        w = hr.shape[1]
        scale = 1.0 / math.sqrt(n)
        pairs = [(lambda: sk.ifft_last_c2r(hr, hi, n, packed, scale),
                  lambda: sk.ifft_last_c2r_plain(hr, hi, n, packed, scale))]
        case = kernel_case(shape, n, pairs,
                           lambda: sk.ifft_last_c2r(hr, hi, n, packed),
                           lambda: sk.ifft_last_c2r_plain(hr, hi, n, packed),
                           lambda: torch.fft.irfft(h, n=n),
                           8 * b * w + 4 * b * n, 2.5 * b * n * math.log2(n))
        case["layout"] = "packed" if packed else "narrow"
        case["planes"] = list(hr.shape)   # what the kernel is fed
        del h, hr, hi
        return case

    def cols_tw_case(b, n):
        """fft_cols_tw on the (b, n1, n2) view of a (b, n) last axis; its
        entry fft_last_four_step timed whole and by part."""
        n1, n2 = sk._four_step_split(n)
        shape = (b, n1, n2)
        xr, xi = planes(shape)
        pairs = [(lambda s=s: torch.complex(*fs.fft_cols_tw(xr, xi, s)),
                  lambda s=s: torch.complex(*fs.fft_cols_tw_plain(xr, xi, s)))
                 for s in (-1, 1)]
        case = kernel_case(shape, n, pairs, lambda: fs.fft_cols_tw(xr, xi, -1),
                           lambda: fs.fft_cols_tw_plain(xr, xi, -1), None,
                           16 * xr.numel(),
                           (5 * math.log2(n1) + 6) * xr.numel())
        fr, fi = xr.reshape(b, n), xi.reshape(b, n)
        xc = torch.complex(fr, fi)

        def swap(ar, ai):
            return (ar.reshape(b, n1, n2).transpose(1, 2).contiguous(),
                    ai.reshape(b, n1, n2).transpose(1, 2).contiguous())

        def plain_entry():
            ar, ai = fs.fft_cols_tw_plain(xr, xi, -1)
            return swap(*sk.fft_last_plain(ar.reshape(b * n1, n2),
                                           ai.reshape(b * n1, n2), -1))

        case["entry"] = entry_case(
            "fft_last_four_step", (b, n),
            lambda: fs.fft_last_four_step(fr, fi, rt.FORWARD), plain_entry,
            lambda: torch.fft.fft(xc, dim=1), 16 * fr.numel(),
            5 * fr.numel() * math.log2(n))
        ar, ai = (t.reshape(b * n1, n2) for t in fs.fft_cols_tw(xr, xi, -1))
        br, bi = sk.fft_last(ar, ai, -1)
        case["entry"]["parts_ms"] = {
            "fft_cols_tw": case["ms"],
            "fft_last": timed(lambda: sk.fft_last(ar, ai, -1)),
            "swap": timed(lambda: swap(br, bi))}
        del xr, xi, fr, fi, xc, ar, ai, br, bi
        return case

    a0fs_done = {}

    def a0fs_case(stage, shape, axis, bf16=False):
        """a0fs_a and a0fs_b (or their bf16 instances) on one input (stage
        b on stage a's plain output); their entry fft_axis0_fourstep timed
        whole."""
        key = (shape, axis, bf16)
        if key not in a0fs_done:
            n = shape[axis]
            pre = int(np.prod(shape[:axis]))
            post = int(np.prod(shape[axis + 1:]))
            r1, r2 = sk._a0fs_split(n)
            xr, xi = planes((pre, n, post))
            if bf16:
                xr, xi = xr.to(torch.bfloat16), xi.to(torch.bfloat16)
            eb = 8 if bf16 else 16
            scale = 1.0 / math.sqrt(n)
            mid = {s: fs.a0fs_stage_plain("a", xr, xi, s) for s in (-1, 1)}

            def c64(yr, yi):
                return torch.complex(yr.float(), yi.float())
            ca = kernel_case(
                shape, n,
                [(lambda s=s: c64(*fs.a0fs_stage("a", xr, xi, s)),
                  lambda s=s: c64(*mid[s])) for s in (-1, 1)],
                lambda: fs.a0fs_stage("a", xr, xi, -1),
                lambda: fs.a0fs_stage_plain("a", xr, xi, -1), None,
                eb * xr.numel(), (5 * math.log2(r1) + 6) * xr.numel(),
                PLAIN_LIMIT["a0fs_a_bf16"] if bf16 else None)
            cb = kernel_case(
                shape, n,
                [(lambda s=s: c64(*fs.a0fs_stage("b", *mid[s], s, scale)),
                  lambda s=s: c64(*fs.a0fs_stage_plain("b", *mid[s], s,
                                                       scale)))
                 for s in (-1, 1)],
                lambda: fs.a0fs_stage("b", *mid[-1], -1),
                lambda: fs.a0fs_stage_plain("b", *mid[-1], -1), None,
                eb * xr.numel(), 5 * math.log2(r2) * xr.numel(),
                PLAIN_LIMIT["a0fs_b_bf16"] if bf16 else None)
            del mid
            fr, fi = xr.reshape(shape), xi.reshape(shape)
            xc = torch.complex(fr.float(), fi.float())
            xh, _ = as_c32(fr, fi) if bf16 else (None, None)
            lib, _ = lib_c32(xh, (axis,)) if bf16 else (None, None)
            ca["entry"] = cb["entry"] = entry_case(
                "fft_axis0_fourstep", shape,
                lambda: fs.fft_axis0_fourstep(fr, fi, axis, rt.FORWARD),
                lambda: fs.a0fs_stage_plain(
                    "b", *fs.a0fs_stage_plain("a", xr, xi, -1), -1),
                lib or (lambda: torch.fft.fft(xc, dim=axis)), eb * xr.numel(),
                5 * xr.numel() * math.log2(n))
            ca["entry"]["library_call"] = cb["entry"]["library_call"] = (
                "torch.fft.fft complex32" if lib else "torch.fft.fft complex64")
            a0fs_done[key] = {"a": ca, "b": cb}
            del xr, xi, fr, fi, xc, xh, lib
        return a0fs_done[key].pop(stage)

    def ring_case(shape, fuse):
        """fft_axis_ring over (pre, n, post), or with `fuse` over both
        trailing axes of (pre, n1, n2)."""
        xr, xi = planes(shape)
        n = shape[1] * shape[2] if fuse else shape[1]
        scale = 1.0 / math.sqrt(n)
        pairs = [(lambda s=s: torch.complex(*fs.fft_axis_ring(xr, xi, s, scale,
                                                              fuse)),
                  lambda s=s: torch.complex(*fs.fft_axis_ring_plain(
                      xr, xi, s, scale, fuse))) for s in (-1, 1)]
        xc = torch.complex(xr, xi)
        case = kernel_case(
            shape, n, pairs, lambda: fs.fft_axis_ring(xr, xi, -1, 1.0, fuse),
            lambda: fs.fft_axis_ring_plain(xr, xi, -1, 1.0, fuse),
            (lambda: torch.fft.fft2(xc)) if fuse
            else (lambda: torch.fft.fft(xc, dim=1)),
            16 * xr.numel(), 5 * xr.numel() * math.log2(n))
        del xr, xi, xc
        return case

    def as_c32(xr, xi):
        """torch.complex32 (fp16 halves) of the planes, or None with the
        reason where PyTorch does not make one."""
        try:
            return torch.complex(xr.half(), xi.half()), None
        except Exception as e:   # noqa: BLE001 - the yardstick may not exist
            return None, repr(e)[:160]

    def lib_c32(xh, dims):
        """One torch.fft call on complex32 data, or None with the reason
        where cuFFT does not take it."""
        if xh is None:
            return None, "no torch.complex32 tensor"
        try:
            torch.fft.fftn(xh, dim=dims)
            torch.cuda.synchronize()
            return (lambda: torch.fft.fftn(xh, dim=dims)), None
        except Exception as e:   # noqa: BLE001
            return None, repr(e)[:160]

    def bf16_case(kname, shape, dims, kern=None, plain=None):
        """A kernel on bf16 planes against its plain version; both also
        against torch.fft in float64 of the bf16-rounded input."""
        kern = kern or getattr(sk, kname)
        plain = plain or getattr(sk, kname + "_plain")
        n = int(np.prod([shape[d] for d in dims]))
        xr, xi = (t.to(torch.bfloat16) for t in planes(shape))
        scale = 1.0 / math.sqrt(n)

        def c64(yr, yi):
            return torch.complex(yr.float(), yi.float())
        pairs = [(lambda s=s: c64(*kern(xr, xi, s, scale)),
                  lambda s=s: c64(*plain(xr, xi, s, scale))) for s in (-1, 1)]
        ref = torch.fft.fftn(cplx(xr, xi), dim=dims) * scale
        err = dev_rel(c64(*kern(xr, xi, -1, scale)), ref)
        perr = dev_rel(c64(*plain(xr, xi, -1, scale)), ref)
        del ref
        xc = torch.complex(xr.float(), xi.float())
        xh, why = as_c32(xr, xi)
        lib, why32 = lib_c32(xh, dims)
        case = kernel_case(shape, n, pairs, lambda: kern(xr, xi, -1, 1.0),
                           lambda: plain(xr, xi, -1, 1.0),
                           lib or (lambda: torch.fft.fftn(xc, dim=dims)),
                           8 * xr.numel(), 5 * xr.numel() * math.log2(n),
                           PLAIN_LIMIT[kname + "_bf16"])
        case["library_call"] = ("torch.fft.fftn complex32" if lib
                                else "torch.fft.fftn complex64")
        case["library_c32_ms"] = case["library_ms"] if lib else None
        case["library_c32_note"] = why or why32
        case["library_c64_ms"] = timed(lambda: torch.fft.fftn(xc, dim=dims))
        case["err_vs_f64"], case["plain_err_vs_f64"] = err, perr
        print(f"{kname}_bf16 {shape}: {case['ms']:.4f} ms (bound "
              f"{case['bound_ms']:.4f}, plain {case['plain_ms']:.4f}, "
              f"torch.fft complex32 {case['library_c32_ms']}, complex64 "
              f"{case['library_c64_ms']:.4f}); rel_l2 vs plain "
              f"{case['max_rel_err']:.3e}, vs float64 {err:.3e} (plain "
              f"{perr:.3e})")
        del xr, xi, xc, xh
        return case

    def mm_case(kname, shape):
        """fft_mm1 or fft_mm2 on (B, n) rows against its plain version;
        bound: the DFT's (its bytes, or its 5 n log2 n flops a row); the
        flops of the kernel's dense products (the TPU CostEstimate) as
        `kernel_flops`, their time at the FP32 rate and, three times over
        (the 3xTF32 split), at the TF32 tensor-core rate; library: one
        torch.fft.fft over the same rows."""
        b, n = shape
        xr, xi = planes(shape)
        if kname == "fft_mm1":
            kern = lambda s: pf.fft_mm1(xr, xi, n, s)
            plain_fn = lambda s: pf.fft_mm1_plain(xr, xi, n, s)
            kflops = 8 * n * n * b
        else:
            n1, n2 = pf.two_stage_split(n)
            kern = lambda s: pf.fft_mm2(xr, xi, n1, n2, s)
            plain_fn = lambda s: pf.fft_mm2_plain(xr, xi, n1, n2, s)
            kflops = (8 * n * (n1 + n2) + 6 * n) * b

        def plain(s):   # the reference runs its products in full f32
            if (torch.backends.cuda.matmul.allow_tf32
                    or torch.get_float32_matmul_precision() != "highest"):
                raise AssertionError("TF32 allowed while a plain version ran")
            return plain_fn(s)
        pairs = [(lambda s=s: torch.complex(*kern(s)),
                  lambda s=s: torch.complex(*plain(s))) for s in (-1, 1)]
        xc = torch.complex(xr, xi)
        case = kernel_case(shape, n, pairs, lambda: kern(-1),
                           lambda: plain(-1), lambda: torch.fft.fft(xc),
                           16 * xr.numel(), 5 * xr.numel() * math.log2(n))
        case["kernel_flops"] = kflops
        case["kernel_flops_ms"] = 1e3 * kflops / fp32
        case["kernel_tc_ms"] = 1e3 * 3 * kflops / tf32
        case["hmma"] = hmma[kname]
        geo = (pf.mm_geometry(1, n, b, sms) if kname == "fft_mm1"
               else pf.mm_geometry(n1, n2, b, sms))
        case["geometry"] = geo._asdict()
        print(f"{kname} {shape}: {case['ms']:.4f} ms, bound "
              f"{case['bound_ms']:.4f} ({case['bound_by']}), dense products "
              f"{kflops:.3e} flops: kernel_flops_ms "
              f"{case['kernel_flops_ms']:.4f} (FP32), kernel_tc_ms "
              f"{case['kernel_tc_ms']:.4f} (3xTF32); torch.fft "
              f"{case['library_ms']:.4f}, plain {case['plain_ms']:.4f}; "
              f"rel_l2 vs plain {case['max_rel_err']:.3e}; launch "
              f"{case['geometry']}", flush=True)
        del xr, xi, xc
        return case

    def axis0_case(shape):
        """fft_axis0 on (n, V) planes against its plain version."""
        n = shape[0]
        xr, xi = planes(shape)
        scale = 1.0 / math.sqrt(n)
        pairs = [(lambda s=s: torch.complex(*sk.fft_axis0(xr, xi, s, scale)),
                  lambda s=s: torch.complex(*sk.fft_axis0_plain(xr, xi, s,
                                                                scale)))
                 for s in (-1, 1)]
        xc = torch.complex(xr, xi)
        case = kernel_case(shape, n, pairs, lambda: sk.fft_axis0(xr, xi, -1),
                           lambda: sk.fft_axis0_plain(xr, xi, -1),
                           lambda: torch.fft.fft(xc, dim=0), 16 * xr.numel(),
                           5 * xr.numel() * math.log2(n))
        del xr, xi, xc
        return case

    def big_case(kname, shape, dims, axis):
        """c2c_case for planes too large to hold the plain version's whole
        output and a float64 comparison beside them (phase 15's 1024^3
        slab): the kernel on the whole planes, its plain version on 16
        slabs along `axis` (a batch axis: the transform is independent
        across it), rel_l2 summed in float64 over the slabs; plain_ms is
        one run of the plain version over all the slabs; library_ms one
        torch.fft call on the complex planes (16 GiB in and out)."""
        kern, plain = getattr(sk, kname), getattr(sk, kname + "_plain")
        n = int(np.prod([shape[d] for d in dims]))
        xr, xi = planes(shape)
        scale = 1.0 / math.sqrt(n)
        limit = tolerance(n)
        step = max(1, shape[axis] // 16)
        slabs = []
        for a in range(0, shape[axis], step):
            sl = [slice(None)] * len(shape)
            sl[axis] = slice(a, a + step)
            slabs.append(tuple(sl))

        def plain_all(s, sc):
            for sl in slabs:
                yield sl, plain(xr[sl].contiguous(), xi[sl].contiguous(), s,
                                sc)
        max_abs = max_rel = 0.0
        for s in (-1, 1):
            kr, ki = kern(xr, xi, s, scale)
            num = den = 0.0
            for sl, (pr, pi) in plain_all(s, scale):
                pr, pi = pr.double(), pi.double()
                dr, di = kr[sl].double() - pr, ki[sl].double() - pi
                d2 = dr * dr + di * di
                num += float(d2.sum())
                den += float((pr * pr + pi * pi).sum())
                max_abs = max(max_abs, float(d2.max().sqrt()))
                del pr, pi, dr, di, d2
            rel = math.sqrt(num / den)
            if not rel <= limit:
                raise AssertionError(f"{shape}: kernel vs plain rel_l2 {rel} "
                                     f"> {limit}")
            max_rel = max(max_rel, rel)
            del kr, ki
        b_ms, b_by = bound(16 * xr.numel(), 5 * xr.numel() * math.log2(n))
        case = {"shape": list(shape), "n": n, "max_abs_err": max_abs,
                "max_rel_err": max_rel, "plain_limit": limit,
                "ms": timed(lambda: kern(xr, xi, -1, 1.0)),
                "plain_ms": timing.time_ms(
                    lambda: [None for _ in plain_all(-1, 1.0)], 1, dev),
                "bound_ms": b_ms, "bound_by": b_by,
                "plain_in_slabs": len(slabs)}
        xc = torch.complex(xr, xi)
        del xr, xi
        case["library_ms"] = timed(lambda: torch.fft.fftn(xc, dim=dims))
        del xc
        return case

    def f64_case(kname, shape):
        """An f64 instance (``fft_cols_f64`` on (P, n, V) planes,
        ``fft_last_f64`` on (B, n)) against its plain version and one
        torch.fft call in complex128, each within tolerance(n,
        "complex128"); bound: 32 B a complex element (5 n log2 n flops a
        row over the FP32 rate, or the FP64 one, is far smaller);
        library: that torch.fft call."""
        base = kname[:-len("_f64")]
        kern, plain = getattr(sk, base), getattr(sk, base + "_plain")
        dim = 1 if base == "fft_cols" else -1
        n = shape[dim]
        xr, xi = (t.double() for t in planes(shape))
        limit = tolerance(n, "complex128")
        scale = 1.0 / math.sqrt(n)
        xc = torch.complex(xr, xi)
        ref = torch.fft.fft(xc, dim=dim) * scale
        err = dev_rel(torch.complex(*kern(xr, xi, -1, scale)), ref)
        del ref
        if not err <= limit:
            raise AssertionError(f"{kname} {shape}: rel_l2 vs torch.fft "
                                 f"complex128 {err} > {limit}")
        pairs = [(lambda s=s: torch.complex(*kern(xr, xi, s, scale)),
                  lambda s=s: torch.complex(*plain(xr, xi, s, scale)))
                 for s in (-1, 1)]
        case = kernel_case(shape, n, pairs, lambda: kern(xr, xi, -1, 1.0),
                           lambda: plain(xr, xi, -1, 1.0),
                           lambda: torch.fft.fft(xc, dim=dim),
                           32 * xr.numel(), 5 * xr.numel() * math.log2(n),
                           limit)
        case["err_vs_torch_fft_c128"] = err
        print(f"{kname} {shape}: {case['ms']:.4f} ms (bound "
              f"{case['bound_ms']:.4f}, plain {case['plain_ms']:.4f}, "
              f"torch.fft complex128 {case['library_ms']:.4f}); rel_l2 vs "
              f"plain {case['max_rel_err']:.3e}, vs torch.fft {err:.3e} "
              f"(tolerance {limit:.3e})", flush=True)
        del xr, xi, xc
        return case

    mid4 = (4, 256, 256, 256)
    gap = {"kern": sk.fft_axes_gap, "plain": sk.fft_axes_gap_plain}
    cases = {
        "fft_last": [lambda: c2c_case("fft_last", (4096, 1024), (1,)),
                     lambda: c2c_case("fft_last", (4096, 640), (1,)),
                     # stage 2 of the 64 x 2^20 four-step
                     lambda: c2c_case("fft_last", (32768, 2048), (1,)),
                     # the half-length C2R of 4096 x 1024
                     lambda: c2c_case("fft_last", (4096, 512), (1,)),
                     # Bluestein's inner transforms of 16384 x 1009 (m = 2048)
                     lambda: c2c_case("fft_last", (16384, 2048), (1,)),
                     # the 511^3 DST-I's planes: L = 1024, imag zero
                     lambda: dst1_case(511),
                     # phase 12: dctn 512^3's axes; idctn 2048^2 and the
                     # 2048^2 NUFFT grid's last axis; FFTLog's half-length
                     # C2R; stage 2 of the 2^21 NUFFT grid's four-step
                     lambda: c2c_case("fft_last", (262144, 512), (1,)),
                     lambda: c2c_case("fft_last", (2048, 2048), (1,)),
                     lambda: c2c_case("fft_last", (16384, 512), (1,)),
                     lambda: c2c_case("fft_last", (1024, 2048), (1,)),
                     # phase 14: oaconvolve's blocks (half-length route at
                     # 2048), istft's half-length C2R of 512, resample's
                     # complex rows
                     lambda: c2c_case("fft_last", (8000, 2048), (1,)),
                     lambda: c2c_case("fft_last", (240064, 256), (1,)),
                     lambda: c2c_case("fft_last", (4096, 2048), (1,)),
                     # phase 15: the last axis of the 1024^3 slab
                     lambda: big_case("fft_last", (1048576, 1024), (1,), 0),
                     # phase 16: the half-length R2C core of the unpacked
                     # 512 x 512 x 2048 slab
                     lambda: c2c_case("fft_last", (262144, 1024), (1,))],
        "fft_cols": [lambda: c2c_case("fft_cols", (1, 512, 262144), (1,)),
                     # the mid axis of the 512^3 gap-fused plan
                     lambda: c2c_case("fft_cols", CUBE, (1,)),
                     # axes 2 and 1 of the packed 4 x 256^3 real plans
                     lambda: c2c_case("fft_cols", (1024, 256, 128), (1,)),
                     lambda: c2c_case("fft_cols", (4, 256, 32768), (1,)),
                     # phase 12: the leading axis of the 256^3 NUFFT grid
                     lambda: c2c_case("fft_cols", (1, 256, 65536), (1,)),
                     # phase 14: the packed 32 x 1024^2 and 512^3
                     # convolutions' complex axes
                     lambda: c2c_case("fft_cols", (32, 1024, 512), (1,)),
                     lambda: c2c_case("fft_cols", (512, 512, 256), (1,)),
                     lambda: c2c_case("fft_cols", (1, 512, 131072), (1,)),
                     # phase 15: the slab's chunked axis 0 at 512^3 (4
                     # chunks), the howmany=2 256^3 slab's axis 0, and the
                     # 1024^3 slab's axes 1 and 0
                     lambda: c2c_case("fft_cols", (1, 512, 65536), (1,)),
                     lambda: c2c_case("fft_cols", (2, 256, 65536), (1,)),
                     lambda: big_case("fft_cols", (1024, 1024, 1024), (1,),
                                      0),
                     lambda: big_case("fft_cols", (1, 1024, 1048576), (1,),
                                      2),
                     # phase 16: the unpacked 512 x 512 x 2048 R2C slab's
                     # mid axis and axis 0 (1025 bins), the packed 1024^3
                     # R2C slab's (512 bins)
                     lambda: c2c_case("fft_cols", (512, 512, 1025), (1,)),
                     lambda: c2c_case("fft_cols", (1, 512, 524800), (1,)),
                     lambda: c2c_case("fft_cols", (1024, 1024, 512), (1,)),
                     lambda: c2c_case("fft_cols", (1, 1024, 524288), (1,))],
        "fft_fused2": [lambda: c2c_case("fft_fused2", (512, 512, 512),
                                        (1, 2)),
                       # the trailing pair of the 4 x 256^3 mid-axis plan
                       lambda: c2c_case("fft_fused2", (1024, 256, 256),
                                        (1, 2)),
                       lambda: c2c_case("fft_fused2", (16, 512, 512),
                                        (1, 2)),
                       # phase 12: the trailing pair of the 256^3 NUFFT grid
                       lambda: c2c_case("fft_fused2", (256, 256, 256),
                                        (1, 2)),
                       # phase 15: the howmany=2 256^3 slab's local pair
                       lambda: c2c_case("fft_fused2", (512, 256, 256),
                                        (1, 2))],
        "fft_last_r2c": [lambda: r2c_case((4096, 1024), False),
                         lambda: r2c_case((262144, 256), True),
                         # phase 12: FFTLog's rfft
                         lambda: r2c_case((16384, 1024), False),
                         # phase 14: the packed 32 x 1024^2 and 512^3
                         # convolutions; the STFT's, Welch's and the
                         # spectrogram's segments
                         lambda: r2c_case((32768, 1024), True),
                         lambda: r2c_case((262144, 512), True),
                         lambda: r2c_case((240064, 512), False),
                         lambda: r2c_case((59904, 1024), False),
                         lambda: r2c_case((34240, 1024), False),
                         # phase 16: the packed 1024^3 R2C slab's rows
                         lambda: r2c_case((1048576, 1024), True)],
        "ifft_last_c2r": [lambda: c2r_case((262144, 256), True),
                          # phase 14: the packed convolutions' C2R
                          lambda: c2r_case((32768, 1024), True),
                          lambda: c2r_case((262144, 512), True)],
        "fft_cols_tw": [lambda: cols_tw_case(64, 1 << 20),
                        # phase 12: the 2^21 NUFFT grid (one row)
                        lambda: cols_tw_case(1, 1 << 21)],
        "a0fs_a": [lambda: a0fs_case("a", CUBE, 0),
                   lambda: a0fs_case("a", mid4, 1)],
        "a0fs_b": [lambda: a0fs_case("b", CUBE, 0),
                   lambda: a0fs_case("b", mid4, 1)],
        "fft_axis_ring": [lambda: ring_case((1, 512, 262144), False)],
        "fft_axes2_ring": [lambda: ring_case(CUBE, True)],
        # bf16 planes: the complex32 plans' shapes, and 512 where the JAX
        # body is _direct_tile (1024: _mxu_tile_tw)
        "fft_last_bf16": [lambda: bf16_case("fft_last", (4096, 1024), (1,)),
                          lambda: bf16_case("fft_last", (8192, 512), (1,)),
                          # phase 13: the last axis of the complex32 512^3
                          # plans whose trailing pair is unfused
                          lambda: bf16_case("fft_last", (262144, 512),
                                            (1,))],
        "fft_cols_bf16": [lambda: bf16_case("fft_cols", (1, 512, 262144),
                                            (1,)),
                          lambda: bf16_case("fft_cols", CUBE, (1,))],
        "fft_fused2_bf16": [lambda: bf16_case("fft_fused2", CUBE, (1, 2)),
                            lambda: bf16_case("fft_fused2", (16, 512, 512),
                                              (1, 2)),
                            lambda: bf16_case("fft_fused2", (1024, 256, 256),
                                              (1, 2))],
        # the gap-fused pass: 512^3 (B = 1) and 4 x 256^3 as (B, z, Y, x)
        "fft_gap": [lambda: c2c_case("fft_gap", (1,) + CUBE, (1, 3), **gap),
                    lambda: c2c_case("fft_gap", mid4, (1, 3), **gap)],
        "fft_gap_bf16": [
            lambda: bf16_case("fft_gap", (1,) + CUBE, (1, 3), **gap),
            lambda: bf16_case("fft_gap", mid4, (1, 3), **gap)],
        "a0fs_a_bf16": [lambda: a0fs_case("a", CUBE, 0, True),
                        lambda: a0fs_case("a", mid4, 1, True)],
        "a0fs_b_bf16": [lambda: a0fs_case("b", CUBE, 0, True),
                        lambda: a0fs_case("b", mid4, 1, True)],
        "fft_axis_ring_bf16": [lambda: bf16_case(
            "fft_axis_ring", (1, 512, 262144), (1,), ring_fn(False),
            ring_fn(False, True))],
        "fft_axes2_ring_bf16": [lambda: bf16_case(
            "fft_axes2_ring", CUBE, (1, 2), ring_fn(True), ring_fn(True, True))],
        # the 512^3 leading axis, and the columns plan of PRECISION_PLANS
        "fft_axis0": [lambda: axis0_case((512, 262144)),
                      # phase 12: the leading axis of the 2048^2 NUFFT grid
                      lambda: axis0_case((2048, 2048))],
        # the rows every axis of the PALLAS_PLANS gives the kernels
        "fft_mm1": [lambda: mm_case("fft_mm1", (262144, 128))],
        "fft_mm2": [lambda: mm_case("fft_mm2", (4096, 1024)),
                    lambda: mm_case("fft_mm2", (4096, 640)),
                    lambda: mm_case("fft_mm2", (262144, 256)),
                    lambda: mm_case("fft_mm2", (262144, 512))],
        # the f64 instances on the planes each complex128 plan gives them:
        # 512^3 (NPB FT class C: axis 2; axis 1 and axis 0), 4096 x 1024
        # (phase 7, phase 14's scipy.fft row), 256^3 (phase 7, phase 15's
        # complex128 slab), 16 x 128^3 and 64 x 1024
        "fft_last_f64": [lambda: f64_case("fft_last_f64", (262144, 512)),
                         lambda: f64_case("fft_last_f64", (4096, 1024)),
                         lambda: f64_case("fft_last_f64", (65536, 256)),
                         lambda: f64_case("fft_last_f64", (262144, 128)),
                         lambda: f64_case("fft_last_f64", (64, 1024))],
        "fft_cols_f64": [lambda: f64_case("fft_cols_f64", CUBE),
                         lambda: f64_case("fft_cols_f64", (1, 512, 262144)),
                         lambda: f64_case("fft_cols_f64", (256, 256, 256)),
                         lambda: f64_case("fft_cols_f64", (1, 256, 65536)),
                         lambda: f64_case("fft_cols_f64", (2048, 128, 128)),
                         lambda: f64_case("fft_cols_f64", (16, 128, 16384)),
                         lambda: f64_case("fft_cols_f64", (1, 16, 2097152)),
                         lambda: f64_case("fft_cols_f64", (1, 64, 1024))],
    }
    rows = {}
    for kname, makers in cases.items():
        replaces, source = KERNELS[kname]
        done = []
        for make in makers:
            done.append(make())
            torch.cuda.empty_cache()
        first = done[0]
        rows[kname] = {"name": kname, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": 0,
                       "launches_by_path": {},
                       "max_abs_err": max(c["max_abs_err"] for c in done),
                       "max_rel_err": max(c["max_rel_err"] for c in done),
                       "ms": first["ms"], "time_ms": first["ms"],
                       "plain_ms": first["plain_ms"],
                       "bound_ms": first["bound_ms"],
                       "bound_by": first["bound_by"],
                       "library_ms": first["library_ms"], "cases": done}
        if "entry" in first:
            rows[kname]["entry"] = first["entry"]
        for key in ("library_call", "library_c32_ms", "library_c64_ms",
                    "err_vs_f64", "plain_err_vs_f64", "err_vs_torch_fft_c128",
                    "kernel_flops",
                    "kernel_flops_ms", "kernel_tc_ms", "hmma"):
            if key in first:
                rows[kname][key] = first[key]
        print(f"kernel {kname}: " + "; ".join(
            f"{tuple(c['shape'])} {c['ms']:.4f} ms (bound {c['bound_ms']:.4f}, "
            f"plain {c['plain_ms']:.4f}, library {c['library_ms']}), rel_l2 vs "
            f"plain {c['max_rel_err']:.3e}" for c in done), flush=True)
    # fft_fused2's register body (persistent clusters, a static round robin)
    # at plane counts that leave a ragged last wave: the fewest planes that
    # take its cluster size, the clusters the card holds at once (Q) +- 1
    # (2Q +- 1 where fewer planes take another cluster size) and 512, f32
    # and bf16, both signs, against the plain version (tolerance(n) in f32,
    # PLAIN_LIMIT in bf16); each call's planes counted in
    # trace.COUNTS["fused2_planes"]
    regs_worst = {}
    for (n1, n2, c_) in sorted(sk.FUSED2_REGS):
        least = next(p_ for p_ in range(1, 4096)
                     if sk.fused2_cluster(n1, n2, p_, sms) == c_)
        for dt in (torch.float32, torch.bfloat16):
            q_ = sk.fused2_active_clusters(n1, n2, c_, dt)
            counts = sorted({p_ for p_ in (least, q_ - 1, q_ + 1, 2 * q_ - 1,
                                           2 * q_ + 1, 512)
                             if p_ >= least})
            for p_ in counts:
                xr, xi = (t.to(dt) for t in planes((p_, n1, n2)))
                for sign in (-1, 1):
                    trace.reset_counts()
                    yr, yi = sk.fft_fused2(xr, xi, sign, 0.5)
                    if trace.COUNTS["fused2_planes"] != p_:
                        raise AssertionError(f"fused2_planes {trace.COUNTS}")
                    e = dev_rel(torch.complex(yr.float(), yi.float()),
                                torch.complex(*(t.float() for t in
                                                sk.fft_fused2_plain(
                                                    xr, xi, sign, 0.5))))
                    lim = (tolerance(n1 * n2) if dt == torch.float32
                           else PLAIN_LIMIT["fft_fused2_bf16"])
                    if not e <= lim:
                        raise AssertionError(
                            f"fft_fused2 register body {(p_, n1, n2)} "
                            f"{dt} sign {sign}: rel_l2 vs plain {e} > {lim}")
                    key = f"{n1}x{n2} {str(dt)[6:]}"
                    regs_worst[key] = max(regs_worst.get(key, 0.0), e)
                    del yr, yi
                del xr, xi
                torch.cuda.empty_cache()
            print(f"fft_fused2 register body {(n1, n2)} C {c_} "
                  f"{str(dt)[6:]}: {q_} clusters at once, planes {counts}, "
                  f"both signs: worst rel_l2 vs plain "
                  f"{regs_worst[f'{n1}x{n2} {str(dt)[6:]}']:.3e}")
    # the interleaved ends: fft_fused2's register body reading a complex64
    # tensor (fft_fused2_interleaved_in) at its two geometries, 512^3 and
    # 256^3 and a ragged last wave (2Q + 1 planes, which still take the
    # register body's cluster size), and fft_cols writing one
    # (fft_cols_interleaved_out) at every length it takes (3 x n x 37: a
    # ragged tile) and the main path's 512^3 and 256^3 axis-0 shapes; both
    # signs, each bit for bit against the planar instance it shares its
    # algorithm with and within tolerance(n) of the plain version
    il_worst = {}
    for (n1, n2, c_) in sorted(sk.FUSED2_REGS):
        q_ = sk.fused2_active_clusters(n1, n2, c_)
        for p_ in (n1, 2 * q_ + 1):
            if not sk.fused2_reads_complex((p_, n1, n2), torch.float32, sms):
                raise AssertionError(f"{(p_, n1, n2)}: not the register body")
            x = torch.complex(*planes((p_, n1, n2)))
            xr, xi = x.real.contiguous(), x.imag.contiguous()
            for sign in (-1, 1):
                trace.reset_counts()
                yr, yi = sk.fft_fused2(x, None, sign, 0.5)
                if trace.COUNTS["fused2_planes"] != p_:
                    raise AssertionError(f"fused2_planes {trace.COUNTS}")
                pr, pi = sk.fft_fused2(xr, xi, sign, 0.5)
                if not (torch.equal(yr, pr) and torch.equal(yi, pi)):
                    raise AssertionError(
                        f"fft_fused2 interleaved in {(p_, n1, n2)} sign "
                        f"{sign}: differs from the planar instance by "
                        f"{dev_rel(torch.complex(yr, yi), torch.complex(pr, pi))}")
                e = dev_rel(torch.complex(yr, yi), torch.complex(
                    *sk.fft_fused2_plain(xr, xi, sign, 0.5)))
                if not e <= tolerance(n1 * n2):
                    raise AssertionError(f"fft_fused2 interleaved in "
                                         f"{(p_, n1, n2)}: rel_l2 vs plain {e}")
                key = f"fft_fused2 in {n1}x{n2}"
                il_worst[key] = max(il_worst.get(key, 0.0), e)
                del yr, yi, pr, pi
            del x, xr, xi
            torch.cuda.empty_cache()
    il_shapes = [(3, n, 37) for n in range(2, sk.MAX_STOCKHAM_N + 1)
                 if sk.cols_writes_complex(n, torch.float32)]
    for shape in il_shapes + [(1, 512, 512 * 512), (1, 256, 256 * 256)]:
        xr, xi = planes(shape)
        for sign in (-1, 1):
            y, _ = sk.fft_cols(xr, xi, sign, 0.5, complex_out=True)
            pr, pi = sk.fft_cols(xr, xi, sign, 0.5)
            if not torch.equal(y, torch.complex(pr, pi)):
                raise AssertionError(
                    f"fft_cols interleaved out {shape} sign {sign}: differs "
                    f"from the planar instance by "
                    f"{dev_rel(y, torch.complex(pr, pi))}")
            e = dev_rel(y, torch.complex(*sk.fft_cols_plain(xr, xi, sign,
                                                            0.5)))
            if not e <= tolerance(shape[1]):
                raise AssertionError(f"fft_cols interleaved out {shape}: "
                                     f"rel_l2 vs plain {e}")
            key = f"fft_cols out n={shape[1]}"
            il_worst[key] = max(il_worst.get(key, 0.0), e)
            del y, pr, pi
        del xr, xi
    torch.cuda.empty_cache()
    print("interleaved ends, bit for bit with the planar instances, worst "
          "rel_l2 vs plain: " + "; ".join(f"{k} {v:.3e}"
                                          for k, v in il_worst.items()))
    trace.reset_counts()
    phase("3b (kernels at the main-path shapes)")

    def run_counted(label, plans, inputs, want):
        """Zero the counts, run each plan once, read the counts: they must
        equal `want` (every kernel it does not name 0)."""
        expected = {k: want.get(k, 0) for k in kernel_launches()}
        sk.reset_launches()
        outs = [p(x) for p, x in zip(plans, inputs)]
        torch.cuda.synchronize()
        launches = kernel_launches()
        print(f"main-path launches ({label}) {launches} expected {expected}")
        if launches != expected:
            raise AssertionError(f"{label} launch counts {launches} != "
                                 f"{expected}")
        return outs, launches

    # 4. the main path, C2C: three plans with default device and backend
    plans = [rt.make_plan(shape, axes=axes) for shape, axes in MAIN_PLANS]
    for p in plans:
        print(p.describe())
    steps3 = [ln.strip() for ln in plans[0].describe().splitlines()[1:-1]]
    if steps3 != ["(axis 1: kernel-fused2(512, 512))",
                  "(axis 0: kernel-butterfly(n=512))"]:
        raise AssertionError(f"512^3 plan steps: {steps3}")
    inputs = []
    for (shape, _), seed in zip(MAIN_PLANS, (1, 2, 3)):
        g = torch.Generator(device=dev).manual_seed(seed)
        inputs.append(torch.complex(torch.randn(shape, device=dev, generator=g),
                                    torch.randn(shape, device=dev, generator=g)))
    trace.reset_counts()
    outs, launches = run_counted("c2c", plans, inputs, C2C_LAUNCHES)
    # the complex64 inputs reach the kernels as they are where the plan's
    # first step reads them (512^3 and 16 x 512^2: fft_fused2's register
    # body) and its last step writes the output (512^3: fft_cols on axis 0)
    ends = [p.complex_ends for p in plans]
    print(f"interleaved ends {ends}, counts {trace.COUNTS}")
    if ends != [(True, True), (False, False), (True, False)] or (
            trace.COUNTS["interleaved_in"], trace.COUNTS["interleaved_out"]
    ) != (2, 1):
        raise AssertionError(f"interleaved ends {ends} {trace.COUNTS}")
    for kname, row in rows.items():
        row["launches_by_path"]["c2c"] = launches[kname]
        row["launches"] += launches[kname]

    plan_rows = []
    for p, x, y in zip(plans, inputs, outs):
        s = p.spec
        if y.dtype != torch.complex64 or tuple(y.shape) != s.shape:
            raise AssertionError(f"{s.shape}: output {y.dtype} {tuple(y.shape)}")
        if not bool(torch.isfinite(torch.view_as_real(y)).all()):
            raise AssertionError(f"{s.shape}: non-finite output")
        tol = tolerance(s.logical_n)
        err = dev_rel(y, torch.fft.fftn(x, dim=s.axes))
        back = dev_rel(p.inverse()(y), x)
        if not (err <= tol and back <= tol):
            raise AssertionError(f"{s.shape}: rel_l2 {err}, roundtrip {back}, "
                                 f"tolerance {tol}")
        xr, xi = x.real.contiguous(), x.imag.contiguous()
        # the same arithmetic as the split path's: equal bit for bit
        if not torch.equal(y, torch.complex(*p.execute_split(xr, xi))):
            raise AssertionError(f"{s.shape}: Plan.__call__ differs from "
                                 f"execute_split on the same planes")
        peak, rise = peak_bytes(lambda: p(x))
        print(f"peak memory c2c {s.shape}: {peak} B ({rise} B over the "
              f"{peak - rise} B resident before the call)")
        ms = timed(lambda: p(x))
        steps_ms = timed(lambda: p.execute_split(xr, xi))
        split_ms = timed(lambda: (x.real.contiguous(), x.imag.contiguous()))
        combine_ms = timed(lambda: torch.complex(xr, xi))
        lib_ms = timed(lambda: torch.fft.fftn(x, dim=s.axes))
        b_ms = 1e3 * p.bytes_ideal / bw
        plan_rows.append({
            "kind": "c2c", "shape": list(s.shape), "axes": list(s.axes),
            "steps": [ln.strip() for ln in p.describe().splitlines()[1:-1]],
            "rel_err_vs_torch_fft": err, "roundtrip_err": back,
            "tolerance": tol, "ms": ms, "steps_ms": steps_ms,
            "split_ms": split_ms, "combine_ms": combine_ms,
            "gflops": p.flops / (ms * 1e-3) / 1e9,
            "hbm_bound_ms": b_ms, "bound_fraction": b_ms / ms,
            "library_ms": lib_ms, "peak_bytes": peak, "peak_rise_bytes": rise})
        del xr, xi
    del inputs, outs

    # a small input against the float64 numpy DFT
    rng = np.random.default_rng(0)
    small = (rng.standard_normal((4, 128, 256))
             + 1j * rng.standard_normal((4, 128, 256))).astype(np.complex64)
    ys = rt.fftn(small)
    err_small = rel_l2(ys, np.fft.fftn(small.astype(np.complex128)))
    if ys.device.type != "cuda" or not err_small <= tolerance(small.size):
        raise AssertionError(f"small input: rel_l2 {err_small} on {ys.device}")
    print(f"small (4,128,256) vs numpy float64: rel_l2 {err_small}")

    phase("4 (C2C plans)")

    # 5. the main path, real: R2C and C2R plans, default device and backend
    kinds = {"r2c": (rt.Kind.R2C, rt.FORWARD), "c2r": (rt.Kind.C2R, rt.BACKWARD)}
    plans = [rt.make_plan(shape, axes=axes, kind=kinds[k][0],
                          direction=kinds[k][1])
             for shape, axes, k in REAL_PLANS]
    for i, p in enumerate(plans):
        print(p.describe())
        got = [ln.strip() for ln in p.describe().splitlines()[1:-1]]
        if got != REAL_STEPS[i]:
            raise AssertionError(f"{REAL_PLANS[i]} steps: {got}")
    inputs = []
    for (shape, axes, k), seed in zip(REAL_PLANS, (4, 5, 6, 7)):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(shape, device=dev, generator=g)
        # a C2R plan gets a Hermitian half spectrum: the rfftn of a real x
        inputs.append(x if k == "r2c" else torch.fft.rfftn(x, dim=axes))
    outs, launches = run_counted("real", plans, inputs, REAL_LAUNCHES)
    for kname, row in rows.items():
        row["launches_by_path"]["real"] = launches[kname]
        row["launches"] += launches[kname]

    for p, x, y in zip(plans, inputs, outs):
        s = p.spec
        r2c = s.kind == rt.Kind.R2C
        want_shape = _half_shape(s) if r2c else s.shape
        want_dtype = torch.complex64 if r2c else torch.float32
        if y.dtype != want_dtype or tuple(y.shape) != want_shape:
            raise AssertionError(f"{s.kind} {s.shape}: output {y.dtype} "
                                 f"{tuple(y.shape)}")
        yv = torch.view_as_real(y) if r2c else y
        if not bool(torch.isfinite(yv).all()):
            raise AssertionError(f"{s.kind} {s.shape}: non-finite output")
        tol = tolerance(s.logical_n)
        if r2c:
            ref = torch.fft.rfftn(x, dim=s.axes)
            lib = lambda: torch.fft.rfftn(x, dim=s.axes)
            steps = lambda: p.execute_real(x)
        else:
            ref = torch.fft.irfftn(x, s=[s.shape[a] for a in s.axes],
                                   dim=s.axes)
            lib = lambda: torch.fft.irfftn(x, s=[s.shape[a] for a in s.axes],
                                           dim=s.axes)
            hr, hi = x.real.contiguous(), x.imag.contiguous()
            steps = lambda: p.execute_split(hr, hi)
        err = dev_rel(y, ref)
        back = dev_rel(p.inverse()(y), x)
        del ref
        if not (err <= tol and back <= tol):
            raise AssertionError(f"{s.kind} {s.shape}: rel_l2 {err}, "
                                 f"roundtrip {back}, tolerance {tol}")
        ms = timed(lambda: p(x))
        steps_ms = timed(steps)
        lib_ms = timed(lib)
        b_ms = 1e3 * p.bytes_ideal / bw
        plan_rows.append({
            "kind": s.kind.value, "shape": list(s.shape),
            "axes": list(s.axes),
            "steps": [ln.strip() for ln in p.describe().splitlines()[1:-1]],
            "rel_err_vs_torch_fft": err, "roundtrip_err": back,
            "tolerance": tol, "ms": ms, "steps_ms": steps_ms,
            "gflops": p.flops / (ms * 1e-3) / 1e9,
            "hbm_bound_ms": b_ms, "bound_fraction": b_ms / ms,
            "library_ms": lib_ms})
        print(f"{s.kind.value} {s.shape}: {ms:.4f} ms (steps {steps_ms:.4f}, "
              f"bound {b_ms:.4f}, torch.fft {lib_ms:.4f}), rel_l2 {err:.3e}, "
              f"roundtrip {back:.3e}")
    # device time of one call of each real plan, by kernel
    for row, p, x in zip(plan_rows[len(MAIN_PLANS):], plans, inputs):
        by = timing.trace(lambda: p(x), dev)[1]
        row["device_ms_by_kernel"] = {k[:80]: ms for k, ms in by}
        print(f"profile {row['kind']} {tuple(row['shape'])}: device "
              f"{sum(ms for _, ms in by):.4f} ms in {len(by)} kernels: "
              + ", ".join(f"{k[:60]} {ms:.4f}" for k, ms in by[:8]))
    del inputs, outs

    # a small real input against the float64 numpy transforms
    small_r = rng.standard_normal((4, 128, 256)).astype(np.float32)
    ys = rt.rfftn(small_r)
    ref = np.fft.rfftn(small_r.astype(np.float64))
    err_r = rel_l2(ys, ref)
    zs = rt.irfftn(ref.astype(np.complex64), s=small_r.shape)
    err_c = rel_l2(zs, np.fft.irfftn(ref, s=small_r.shape, axes=(0, 1, 2)))
    if (ys.device.type != "cuda" or zs.device.type != "cuda"
            or not max(err_r, err_c) <= tolerance(small_r.size)):
        raise AssertionError(f"small real input: rfftn {err_r}, irfftn "
                             f"{err_c} on {ys.device}")
    print(f"small real (4,128,256) vs numpy float64: rfftn rel_l2 {err_r}, "
          f"irfftn {err_c}")

    phase("5 (real plans)")

    # 6. the four-step and ring routes, one group per plan: the counts are
    # zeroed just before the plan's one run and read just after
    route_ms = {}
    for label, shape, axes, fields, want_steps, want in ROUTE_PLANS:
        p = rt.make_plan(shape, axes=axes, **fields)
        print(p.describe())
        got = [ln.strip() for ln in p.describe().splitlines()[1:-1]]
        if got != want_steps:
            raise AssertionError(f"{label} steps: {got}")
        g = torch.Generator(device=dev).manual_seed(len(plan_rows))
        x = torch.complex(torch.randn(shape, device=dev, generator=g),
                          torch.randn(shape, device=dev, generator=g))
        (y,), launches = run_counted(label, [p], [x], want)
        for kname, row in rows.items():
            row["launches_by_path"][label] = launches[kname]
            row["launches"] += launches[kname]
        s = p.spec
        if y.dtype != torch.complex64 or tuple(y.shape) != s.shape:
            raise AssertionError(f"{label}: output {y.dtype} {tuple(y.shape)}")
        if not bool(torch.isfinite(torch.view_as_real(y)).all()):
            raise AssertionError(f"{label}: non-finite output")
        tol = tolerance(s.logical_n)
        err = dev_rel(y, torch.fft.fftn(x, dim=s.axes))
        back = dev_rel(p.inverse()(y), x)
        if not (err <= tol and back <= tol):
            raise AssertionError(f"{label}: rel_l2 {err}, roundtrip {back}, "
                                 f"tolerance {tol}")
        del y
        xr, xi = x.real.contiguous(), x.imag.contiguous()
        ms = timed(lambda: p(x))
        steps_ms = timed(lambda: p.execute_split(xr, xi))
        lib_ms = timed(lambda: torch.fft.fftn(x, dim=s.axes))
        b_ms = 1e3 * p.bytes_ideal / bw
        by = timing.trace(lambda: p(x), dev)[1]
        plan_rows.append({
            "kind": "c2c", "route": label, "shape": list(s.shape),
            "axes": list(s.axes), "steps": got,
            "rel_err_vs_torch_fft": err, "roundtrip_err": back,
            "tolerance": tol, "ms": ms, "steps_ms": steps_ms,
            "gflops": p.flops / (ms * 1e-3) / 1e9,
            "hbm_bound_ms": b_ms, "bound_fraction": b_ms / ms,
            "library_ms": lib_ms,
            "device_ms_by_kernel": {k[:80]: v for k, v in by}})
        route_ms[label] = ms
        print(f"{label} {s.shape}: {ms:.4f} ms (steps {steps_ms:.4f}, bound "
              f"{b_ms:.4f}, torch.fft {lib_ms:.4f}), rel_l2 {err:.3e}, "
              f"roundtrip {back:.3e}; device "
              f"{sum(v for _, v in by):.4f} ms: "
              + ", ".join(f"{k[:60]} {v:.4f}" for k, v in by[:6]))
        del x, xr, xi
        torch.cuda.empty_cache()
    cube = plan_rows[0]
    print(f"512^3 C2C by leading-axis / trailing-pair route (ms): grid "
          f"{cube['ms']:.4f}, fourstep {route_ms['fourstep_ring']:.4f}, dma "
          f"{route_ms['dma_ring']:.4f}, ring {route_ms['fused2_ring']:.4f}; "
          f"torch.fft.fftn {cube['library_ms']:.4f}")
    phase("6 (four-step and ring routes)")

    # 7. the data types: complex32, complex128 and, in phase 8, complex64
    # plans, one group each
    def dtype_plan(label, shape, axes, dtype, fields, want_steps, want):
        p = rt.make_plan(shape, axes=axes, dtype=dtype, **fields)
        print(p.describe())
        got = [ln.strip() for ln in p.describe().splitlines()[1:-1]]
        if got != want_steps:
            raise AssertionError(f"{label} steps: {got}")
        g = torch.Generator(device=dev).manual_seed(len(plan_rows))
        pd = {"complex32": torch.bfloat16, "complex64": torch.float32,
              "complex128": torch.float64}[dtype]
        xr = torch.randn(shape, device=dev, generator=g).to(pd)
        xi = torch.randn(shape, device=dev, generator=g).to(pd)
        x = (rt.SplitComplex(xr, xi) if dtype == "complex32"
             else torch.complex(xr, xi))
        (y,), launches = run_counted(label, [p], [x], want)
        for kname, row in rows.items():
            row["launches_by_path"][label] = launches[kname]
            row["launches"] += launches[kname]
        s = p.spec
        if dtype == "complex32":
            ok = (isinstance(y, rt.SplitComplex)
                  and y.re.dtype == y.im.dtype == torch.bfloat16)
            yc = cplx(y.re, y.im) if ok else None
        else:
            ok = y.dtype == {"complex64": torch.complex64,
                             "complex128": torch.complex128}[dtype]
            yc = y
        if not ok or tuple(yc.shape) != s.shape:
            raise AssertionError(f"{label}: output {type(y)} "
                                 f"{getattr(y, 'dtype', None)}")
        if not bool(torch.isfinite(torch.view_as_real(yc)).all()):
            raise AssertionError(f"{label}: non-finite output")
        tol = tolerance(s.logical_n, dtype)
        xd = cplx(xr, xi)
        err = dev_rel(yc, torch.fft.fftn(xd, dim=s.axes))
        back = p.inverse()(y)
        back = cplx(back.re, back.im) if dtype == "complex32" else back
        back = dev_rel(back, xd)
        del yc, y
        if not (err <= tol and back <= tol):
            raise AssertionError(f"{label}: rel_l2 {err}, roundtrip {back}, "
                                 f"tolerance {tol}")
        peak, rise = peak_bytes(lambda: p(x))
        print(f"peak memory {label} {s.shape} {dtype}: {peak} B ({rise} B "
              f"over the {peak - rise} B resident before the call)")
        ms = timed(lambda: p(x))
        steps_ms = timed(lambda: p.execute_split(xr, xi))
        xc = torch.complex(xr.float(), xi.float())
        lib64_ms = timed(lambda: torch.fft.fftn(xc, dim=s.axes))
        own_ms = own_note = None
        if dtype == "complex32":
            xh, why = as_c32(xr, xi)
            lib, why32 = lib_c32(xh, s.axes)
            own_ms = None if lib is None else timed(lib)
            own_note = why or why32
            del xh
        elif dtype == "complex128":
            own_ms = timed(lambda: torch.fft.fftn(xd, dim=s.axes))
        b_ms = 1e3 * p.bytes_ideal / bw
        by = timing.trace(lambda: p(x), dev)[1]
        plan_rows.append({
            "kind": "c2c", "dtype": dtype, "route": label,
            "shape": list(s.shape), "axes": list(s.axes), "steps": got,
            "rel_err_vs_torch_fft_f64": err, "roundtrip_err": back,
            "tolerance": tol, "ms": ms, "steps_ms": steps_ms,
            "gflops": p.flops / (ms * 1e-3) / 1e9,
            "bytes_ideal": p.bytes_ideal,
            "hbm_bound_ms": b_ms, "bound_fraction": b_ms / ms,
            "library_ms": own_ms if own_ms is not None else lib64_ms,
            "library_own_type_ms": own_ms, "library_own_type_note": own_note,
            "library_complex64_ms": lib64_ms, "peak_bytes": peak,
            "peak_rise_bytes": rise,
            "device_ms_by_kernel": {k[:80]: v for k, v in by}})
        print(f"{label} {s.shape} {dtype}: {ms:.4f} ms (steps {steps_ms:.4f}, "
              f"bound {b_ms:.4f}, torch.fft {dtype} {own_ms} "
              f"{own_note or ''}, complex64 {lib64_ms:.4f}), rel_l2 vs "
              f"torch.fft float64 {err:.3e} (tolerance {tol:.3e}), roundtrip "
              f"{back:.3e}; device {sum(v for _, v in by):.4f} ms: "
              + ", ".join(f"{k[:60]} {v:.4f}" for k, v in by[:6]), flush=True)
        del x, xr, xi, xc, xd
        torch.cuda.empty_cache()
        return ms

    c32_ms = {case[0]: dtype_plan(*case) for case in DTYPE_PLANS}
    # the fuse_last ring allocates nothing but the output: the complex32
    # 512^3 ring plan's peak rise is no more than the grid plan's
    rise = {r["route"]: r["peak_rise_bytes"] for r in plan_rows
            if r.get("route") in ("complex32_cube", "complex32_fused2_ring")}
    print(f"peak memory rise, complex32 512^3: f2_impl='ring' "
          f"{rise['complex32_fused2_ring']} B, grid {rise['complex32_cube']} B")
    if rise["complex32_fused2_ring"] > rise["complex32_cube"]:
        raise AssertionError(f"ring plan's peak rise over the grid's: {rise}")
    print(f"512^3 complex32 C2C by route (ms): grid "
          f"{c32_ms['complex32_cube']:.4f}, fourstep "
          f"{c32_ms['complex32_fourstep_ring']:.4f}, dma "
          f"{c32_ms['complex32_dma_ring']:.4f}, ring "
          f"{c32_ms['complex32_fused2_ring']:.4f}")
    phase("7 (data types)")

    # 8. the gap-fused route: the switch is read when a plan is built, so it
    # is set for this group only, with the plan cache cleared around it
    rt.clear_plan_cache()
    os.environ["REGENT_FFT_GAP_FUSED"] = "1"
    try:
        gap_ms = {case[0]: dtype_plan(*case) for case in GAP_PLANS}
    finally:
        del os.environ["REGENT_FFT_GAP_FUSED"]
        rt.clear_plan_cache()
    print(f"512^3 C2C gap-fused route (ms): complex64 "
          f"{gap_ms['gap_complex64']:.4f} (grid {plan_rows[0]['ms']:.4f}), "
          f"complex32 {gap_ms['gap_complex32']:.4f} (grid "
          f"{c32_ms['complex32_cube']:.4f})")
    phase("8 (gap-fused route)")

    # 9. the backend="pallas" plans, one group each; their bound is the
    # transform's, as for every plan (its bytes: 5 N log2 N flops over the
    # FP32 rate is smaller); beside it the flops of the matmul kernels'
    # dense products (the TPU CostEstimates: 8 n^2 a row for n <= 128,
    # 8 n (n1 + n2) + 6 n for a split n = n1 n2) and their time at the
    # FP32 rate
    for case in PALLAS_PLANS:
        dtype_plan(*case)
        row = plan_rows[-1]
        numel, flops, kflops = int(np.prod(case[1])), 0.0, 0
        for a in case[2]:
            n = case[1][a]
            sp = pf.two_stage_split(n)
            flops += 5 * numel * math.log2(n)
            kflops += numel // n * (8 * n * n if sp is None
                                    else 8 * n * sum(sp) + 6 * n)
        row["bound_ms"], row["bound_by"] = bound(row["bytes_ideal"], flops)
        row["kernel_flops"] = kflops
        row["kernel_flops_ms"] = 1e3 * kflops / fp32
        print(f"{case[0]}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}), dense-product flops {kflops:.3e} "
              f"({row['kernel_flops_ms']:.4f} ms at the FP32 rate), "
              f"torch.fft {row['library_complex64_ms']:.4f}", flush=True)
    phase("9 (backend=pallas plans)")

    # 10. the precision tiers, one group each
    prec_ms = {case[0]: dtype_plan(*case) for case in PRECISION_PLANS}
    print(f"512^3 precision='high' (ms): complex64 "
          f"{prec_ms['precision_high_cube']:.4f} (highest "
          f"{plan_rows[0]['ms']:.4f}), complex32 "
          f"{prec_ms['precision_high_cube_c32']:.4f} (default "
          f"{c32_ms['complex32_cube']:.4f})")
    phase("10 (precision tiers)")

    # 11. the general pipeline (Rader, Bluestein), FFTInterface and guru
    from regent_fft_tpu_torch.ops import factor
    from regent_fft_tpu_torch.ops.stockham import schedule_description

    def conv(n):
        return factor.plan_factors(n)[0] in ("rader", "bluestein")

    def inner_m(n):
        """Bluestein's m where its inner transforms run fft_last, else None."""
        kind, m = factor.plan_factors(n)
        return (m if kind == "bluestein" and 64 <= m <= sk.MAX_LAST_N
                and m & (m - 1) == 0 else None)
    # the lengths 1..4096 whose plans took no kernel, direct DFT or
    # two-factor split (C2C: above xla_direct_max; real: the core, n or n/2)
    c2c_new = [n for n in range(513, 4097) if conv(n)]
    real_new = [n for n in range(2, 4097) if conv(n if n % 2 else n // 2)]
    if (len(c2c_new), len(real_new)) != (1820, 1917):
        raise AssertionError(f"general lengths: {len(c2c_new)} C2C, "
                             f"{len(real_new)} real")
    sweep_worst, swept = 0.0, 0
    for kind, lengths in (("c2c", c2c_new[::16]), ("r2c", real_new[::16]),
                          ("c2r", real_new[::16])):
        for n in lengths:
            core = n if kind == "c2c" or n % 2 else n // 2
            for d in ((-1, 1) if kind == "c2c" else (-1 if kind == "r2c"
                                                     else 1,)):
                p = rt.make_plan((3, n), axes=(1,), kind=kind, direction=d)
                lines = [ln.strip() for ln in p.describe().splitlines()[1:-1]]
                if kind == "c2c":
                    want = [f"(axis 1: 1d-pipeline["
                            f"{schedule_description(n)}])"]
                    km = getattr(p.steps[0][2], "kernel_m", None)
                else:
                    want = [f"(real axis 1: n={n} conjugate-even einsum "
                            f"{kind})"]
                    km = p.real.fn.kernel_m
                if lines != want or km != inner_m(core):
                    raise AssertionError(f"{kind} {n}: steps {lines}, "
                                         f"kernel_m {km}")
                x = torch.complex(randn((3, n)), randn((3, n))).to(
                    torch.complex128)
                if kind == "c2c":
                    y = p(x.to(torch.complex64))
                    ref = (torch.fft.fft(x) if d < 0 else torch.fft.ifft(x))
                elif kind == "r2c":
                    y, ref = p(x.real.float()), torch.fft.rfft(x.real)
                else:
                    h = torch.fft.rfft(x.real)
                    y, ref = p(h.to(torch.complex64)), torch.fft.irfft(h, n)
                err = dev_rel(y, ref)
                if not err <= tolerance(n):
                    raise AssertionError(f"{kind} {n} sign {d}: rel_l2 {err}")
                sweep_worst, swept = max(sweep_worst, err), swept + 1
        rt.clear_plan_cache()
    print(f"general sweep: {swept} plans (every 16th of the {len(c2c_new)} "
          f"C2C and {len(real_new)} real lengths 1..4096 the port refused "
          f"before Rader and Bluestein; C2C both signs; batch 3), worst "
          f"rel_l2 vs torch.fft float64 {sweep_worst:.3e}", flush=True)

    for label, shape, axes, kind, dtype, want in GENERAL_PLANS:
        direction = 1 if kind == "c2r" else -1
        p = rt.make_plan(shape, axes=axes, kind=kind, direction=direction,
                         dtype=dtype)
        print(p.describe())
        got = [ln.strip() for ln in p.describe().splitlines()[1:-1]]
        if kind == "c2c":
            expect = [f"(axis {a}: 1d-pipeline["
                      f"{schedule_description(shape[a])}])"
                      for a in sorted(axes, reverse=True)]
        else:
            expect = [f"(real axis 1: n={shape[1]} conjugate-even einsum "
                      f"{kind})"]
        if got != expect:
            raise AssertionError(f"{label} steps: {got}")
        g = torch.Generator(device=dev).manual_seed(len(plan_rows))
        pd = {"complex32": torch.bfloat16, "complex64": torch.float32,
              "complex128": torch.float64}[dtype]
        if kind == "c2c":
            xr = torch.randn(shape, device=dev, generator=g).to(pd)
            xi = torch.randn(shape, device=dev, generator=g).to(pd)
            x = (rt.SplitComplex(xr, xi) if dtype == "complex32"
                 else torch.complex(xr, xi))
            xd = cplx(xr, xi)
            ref = torch.fft.fftn(xd, dim=axes)
            # cuFFT takes complex32 at powers of two only: the yardstick of
            # the complex32 plan is complex64
            lib_in = (torch.complex(xr.float(), xi.float())
                      if dtype == "complex32" else x)
            lib = lambda: torch.fft.fftn(lib_in, dim=axes)
            steps = lambda: p.execute_split(xr, xi)
        elif kind == "r2c":
            x = torch.randn(shape, device=dev, generator=g)
            ref = torch.fft.rfft(x.double())
            lib = lambda: torch.fft.rfft(x)
            steps = lambda: p.execute_real(x)
        else:
            x = torch.fft.rfft(torch.randn(shape, device=dev, generator=g))
            ref = torch.fft.irfft(x.to(torch.complex128), shape[1])
            hr, hi = x.real.contiguous(), x.imag.contiguous()
            lib = lambda: torch.fft.irfft(x, shape[1])
            steps = lambda: p.execute_split(hr, hi)
        (y,), launches = run_counted(label, [p], [x], want)
        for kname, row in rows.items():
            row["launches_by_path"][label] = launches[kname]
            row["launches"] += launches[kname]
        yc = cplx(y.re, y.im) if isinstance(y, rt.SplitComplex) else y
        if (tuple(yc.shape) != tuple(ref.shape)
                or not bool(torch.isfinite(torch.view_as_real(yc)
                                           if yc.is_complex() else yc).all())):
            raise AssertionError(f"{label}: output {tuple(yc.shape)}")
        tol = tolerance(p.spec.logical_n, dtype)
        err = dev_rel(yc, ref)
        del yc, y, ref
        if not err <= tol:
            raise AssertionError(f"{label}: rel_l2 {err} > {tol}")
        ms = timed(lambda: p(x))
        steps_ms = timed(steps)
        lib_ms = timed(lib)
        b_ms, b_by = bound(p.bytes_ideal, p.flops)
        by = timing.trace(lambda: p(x), dev)[1]
        plan_rows.append({
            "kind": kind, "dtype": dtype, "route": label,
            "shape": list(shape), "axes": list(axes), "steps": got,
            "rel_err_vs_torch_fft_f64": err, "tolerance": tol, "ms": ms,
            "steps_ms": steps_ms, "gflops": p.flops / (ms * 1e-3) / 1e9,
            "bytes_ideal": p.bytes_ideal, "bound_ms": b_ms,
            "bound_by": b_by, "bound_fraction": b_ms / ms,
            "library_ms": lib_ms,
            "library_call": ("torch.fft complex64" if dtype == "complex32"
                             else f"torch.fft {dtype}"),
            "launches": {k: v for k, v in launches.items() if v},
            "device_ms": sum(v for _, v in by),
            "device_ms_by_kernel": [[k[:120], v] for k, v in by]})
        print(f"{label} {shape} {kind} {dtype}: {ms:.4f} ms (steps "
              f"{steps_ms:.4f}, bound {b_ms:.4f} ({b_by}), torch.fft "
              f"{lib_ms:.4f}), rel_l2 vs torch.fft float64 {err:.3e} "
              f"(tolerance {tol:.3e}); device {sum(v for _, v in by):.4f} "
              f"ms: " + ", ".join(f"{k[:60]} {v:.4f}" for k, v in by[:8]),
              flush=True)
        del x
        torch.cuda.empty_cache()

    # the reference's interface: its plans are make_plan's cached plans
    # (norm "none"), run, compared and destroyed, one counted group each
    cube = (512, 512, 512)
    for label, dtype_in, shape, batch, want in (
            ("iface_c2c", torch.complex64, cube, False,
             {"fft_fused2": 1, "fft_cols": 1}),
            ("iface_r2c", torch.float32, (256, 256, 256), False,
             {"fft_last_r2c": 1, "fft_cols": 2}),
            ("iface_batch", torch.complex64, (256, 256, 256, 4), True,
             {"fft_cols": 3})):
        iface = rt.generate_fft_interface(3, dtype_in, torch.complex64)
        p = (iface.make_plan_batch(shape) if batch
             else iface.make_plan(shape))
        axes = (0, 1, 2)
        same = rt.make_plan(shape, axes=axes, kind=iface.kind, norm="none",
                            direction=-1)
        if p is not same:
            raise AssertionError(f"{label}: not make_plan's cached plan")
        g = torch.Generator(device=dev).manual_seed(len(plan_rows))
        x = torch.randn(shape, device=dev, generator=g)
        if iface.kind == rt.Kind.C2C:
            x = torch.complex(x, torch.randn(shape, device=dev, generator=g))
        (y,), launches = run_counted(
            label, [lambda v: iface.execute_plan_task(p, v)], [x], want)
        for kname, row in rows.items():
            row["launches_by_path"][label] = launches[kname]
            row["launches"] += launches[kname]
        ref = (torch.fft.fftn(x, dim=axes) if iface.kind == rt.Kind.C2C
               else torch.fft.rfftn(x, dim=axes))
        err = dev_rel(y, ref)
        del y, ref
        tol = tolerance(p.spec.logical_n)
        iface.destroy_plan_task(p)
        try:
            p(x)
            gone = False
        except RuntimeError:
            gone = p not in rt.cached_plans()
        if not (err <= tol and gone):
            raise AssertionError(f"{label}: rel_l2 {err}, destroyed {gone}")
        print(f"{label} {shape}: FFTInterface plan is make_plan's cached "
              f"plan; rel_l2 vs torch.fft {err:.3e}; destroyed", flush=True)
        del x
        torch.cuda.empty_cache()

    # guru: interleaved fields (plan_many, istride 2) and a transposing
    # layout, over flat buffers on the card
    gp = rt.plan_many((1024,), howmany=4096, istride=2, idist=2048)
    buf = torch.complex(randn(4096 * 2048), randn(4096 * 2048))
    tr = rt.plan_guru([(1024, 1, 4096)], [(4096, 1024, 1)])
    a = torch.complex(randn(4096 * 1024), randn(4096 * 1024))
    (y1, y2), launches = run_counted("guru", [gp, tr], [buf, a],
                                     {"fft_last": 2})
    for kname, row in rows.items():
        row["launches_by_path"]["guru"] = launches[kname]
        row["launches"] += launches[kname]
    e1 = dev_rel(y1, torch.fft.fft(buf.view(4096, 2048)[:, ::2]).reshape(-1))
    e2 = dev_rel(y2, torch.fft.fft(a.view(4096, 1024)).T.reshape(-1))
    if not max(e1, e2) <= tolerance(1024) or y1.device.type != "cuda":
        raise AssertionError(f"guru: rel_l2 {e1}, {e2}")
    guru_ms = [timed(lambda: gp(buf)), timed(lambda: tr(a))]
    print(f"guru: plan_many interleaved 4096 x 1024 rel_l2 {e1:.3e} "
          f"{guru_ms[0]:.4f} ms, transposing plan_guru 4096 x 1024 rel_l2 "
          f"{e2:.3e} {guru_ms[1]:.4f} ms", flush=True)
    del buf, a, y1, y2
    phase("11 (general pipeline, FFTInterface, guru)")

    # 12. r2r, CZT, FFTLog and NUFFT on the port's plans and kernels: each
    # group counted, held against a float64 oracle, timed beside its bytes
    # bound (input read once, output written once) and a yardstick call
    import scipy.fft as sfft
    import scipy.signal as ssig
    from regent_fft_tpu_torch.ops import fftlog as fl
    from regent_fft_tpu_torch.ops import nufft as nu
    R2R = rt.R2RKind
    workers = os.cpu_count() or 1
    groups = dict(R2R_GROUPS + SLICE_GROUPS)

    def host64(t):
        return t.detach().to(torch.float64 if not t.is_complex()
                             else torch.complex128).cpu().numpy()

    def on_dev(h):
        """A host oracle array on the card."""
        return torch.from_numpy(np.ascontiguousarray(h)).to(dev)

    on_cuda = sk._on_cuda
    fed = set()   # (kernel, planes' shape) of every launch in recording()

    def seen(name, *planes, **kw):
        fed.add((name + sk.C2C_DTYPES.get(planes[0].dtype, ""),
                 tuple(planes[0].shape)))
        return on_cuda(name, *planes, **kw)

    @contextlib.contextmanager
    def recording():
        """Record the (kernel, planes' shape) of every launch, the bf16
        instances under their own names, as LAUNCHES counts them."""
        sk._on_cuda = seen
        try:
            yield
        finally:
            sk._on_cuda = on_cuda

    def check_held(what):
        """Fail on a recorded (kernel, planes) that no phase-3b case held
        against its plain version; then forget the record."""
        held = {(k, tuple(c.get("planes", c["shape"])))
                for k, row in rows.items() for c in row["cases"]}
        if fed - held:
            raise AssertionError(f"{what} fed kernels planes no phase-3b "
                                 f"case holds against the plain version: "
                                 f"{fed - held}")
        print(f"{what} kernel planes, each held against its plain version "
              "in 3b: " + ", ".join(f"{k} {s}" for k, s in sorted(fed)))
        fed.clear()

    def counted(label, fn):
        with recording():
            (y,), launches = run_counted(label, [lambda _: fn()], [None],
                                         groups[label])
        for kname, row in rows.items():
            row["launches_by_path"][label] = launches[kname]
            row["launches"] += launches[kname]
        return y, launches

    def report(kind, label, shape, fn, err, tol, steps, nbytes, launches,
               lib=None, lib_call=None, mem=None, nflops=0,
               metric="rel_l2"):
        """Check err <= tol, time fn and its yardstick lib, trace fn once,
        add its plans row; the bound is bytes over the memory rate or
        nflops over the FP32 rate, whichever is larger."""
        if not err <= tol:
            raise AssertionError(f"{label}: {metric} {err} > {tol}")
        ms = timed(fn)
        b_ms, b_by = bound(nbytes, nflops)
        lib_ms = timed(lib) if lib is not None else None
        row = {"kind": kind, "route": label, "shape": list(shape),
               "steps": steps, "rel_err_vs_f64": err, "error_metric": metric,
               "tolerance": tol, "ms": ms, "bytes_ideal": nbytes,
               "flops": nflops, "bound_ms": b_ms, "bound_by": b_by,
               "bound_fraction": b_ms / ms,
               "library_ms": lib_ms, "library_call": lib_call,
               "launches": {k: v for k, v in launches.items() if v}}
        if mem is not None:
            row["peak_bytes"], row["peak_rise_bytes"] = mem
        by = timing.trace(fn, dev)[1]
        row["device_ms"] = sum(v for _, v in by)
        row["device_ms_by_kernel"] = [[k[:120], v] for k, v in by]
        plan_rows.append(row)
        print(f"{label} trace: device {row['device_ms']:.4f} ms: "
              + ", ".join(f"{k[:60]} {v:.4f}" for k, v in by[:6]))
        print(f"{label} {tuple(shape)}: {ms:.4f} ms (bound {b_ms:.4f} {b_by}"
              + (f", {lib_call} {lib_ms:.4f}" if lib is not None else "")
              + f"), {metric} vs float64 {err:.3e} (bound {tol:.1e}); launches "
              f"{row['launches']}"
              + ("" if mem is None else f"; peak memory {mem[0]} B ({mem[1]}"
                 f" B over the {mem[0] - mem[1]} B resident)")
              + "; steps " + " ".join(steps), flush=True)

    def r2r_steps(p):
        return [p.description] + [f"(axis {a}: {k} L={L} {r})"
                                  for a, k, L, r in p.routes]

    def r2hc_ref(h):
        f = np.fft.rfft(h)
        return np.concatenate([f.real, f.imag[:, 1:-1][:, ::-1]], 1)

    def hc2r_ref(h):
        n = h.shape[1]
        im = np.zeros((h.shape[0], n // 2 + 1))
        im[:, 1:n // 2] = h[:, n // 2 + 1:][:, ::-1]     # hc[n - k]
        return n * np.fft.irfft(h[:, :n // 2 + 1] + 1j * im, n)

    def dht_ref(h):
        f = np.fft.fft(h)
        return f.real - f.imag

    # r2r, f32: the kernel route on every transformed axis
    for label, shape, axes, kind, call, ref_fn, L in (
            ("dctn2_512cubed", (512, 512, 512), (0, 1, 2), R2R.REDFT10,
             lambda x: rt.dctn(x, type=2),
             lambda h: sfft.dctn(h, type=2, workers=workers), 512),
            ("dstn1_511cubed", (511, 511, 511), (0, 1, 2), R2R.RODFT00,
             lambda x: rt.dstn(x, type=1),
             lambda h: sfft.dstn(h, type=1, workers=workers), 1024),
            ("dct4_4096x512", (4096, 512), (1,), R2R.REDFT11,
             lambda x: rt.dct(x, type=4),
             lambda h: sfft.dct(h, type=4, workers=workers), 1024),
            ("r2hc_4096x1024", (4096, 1024), (1,), R2R.R2HC,
             lambda x: rt.r2r(x, R2R.R2HC), r2hc_ref, 1024),
            ("hc2r_4096x1024", (4096, 1024), (1,), R2R.HC2R,
             lambda x: rt.r2r(x, R2R.HC2R), hc2r_ref, 1024),
            ("dht_4096x1024", (4096, 1024), (1,), R2R.DHT,
             lambda x: rt.dht(x), dht_ref, 1024),
            ("idctn2_ortho_2048sq", (2048, 2048), (0, 1), R2R.REDFT01,
             lambda x: rt.idctn(x, type=2, norm="ortho"),
             lambda h: sfft.idctn(h, type=2, norm="ortho", workers=workers),
             2048)):
        x = randn(shape)
        p = rt.plan_r2r(shape, kind, axes=axes)
        if p.routes != tuple((a, kind.name, L, "kernel") for a in axes):
            raise AssertionError(f"{label}: routes {p.routes}")
        y, launches = counted(label, lambda: call(x))
        if y.dtype != torch.float32 or tuple(y.shape) != shape:
            raise AssertionError(f"{label}: output {y.dtype} {tuple(y.shape)}")
        err = dev_rel(y, on_dev(ref_fn(host64(x))))
        del y
        report("r2r", label, shape, lambda: call(x), err, tolerance(L),
               r2r_steps(p), 8 * x.numel(), launches,
               lambda: torch.fft.rfftn(x, dim=axes), "torch.fft.rfftn f32")
        del x
        torch.cuda.empty_cache()

    # guru r2r: REDFT10 of field 0 of two interleaved fields (is = 2)
    label = "guru_redft10_interleaved"
    gp = rt.plan_guru_r2r([(1024, 2, 1)], R2R.REDFT10, [(4096, 2048, 1024)])
    buf = randn(4096 * 2048)
    y, launches = counted(label, lambda: gp(buf))
    ref = sfft.dct(host64(buf).reshape(4096, 2048)[:, ::2], type=2, axis=1,
                   workers=workers).ravel()
    err = dev_rel(y, on_dev(ref))
    del y, ref
    field = buf.view(4096, 2048)[:, ::2]
    report("r2r", label, (4096, 1024), lambda: gp(buf), err, tolerance(1024),
           gp.describe().splitlines() + [
               f"(axis {a}: {k} L={L} {r})" for a, k, L, r in gp._plan.routes],
           8 * 4096 * 1024, launches, lambda: torch.fft.rfft(field),
           "torch.fft.rfft f32 (strided view)")
    del buf, field

    # r2r, f64: the dense pipeline, no kernel
    label = "dctn2_256cubed_f64"
    x = randn((256, 256, 256)).double()
    y, launches = counted(label, lambda: rt.dctn(x, type=2))
    if y.dtype != torch.float64:
        raise AssertionError(f"{label}: output {y.dtype}")
    err = dev_rel(y, on_dev(sfft.dctn(host64(x), type=2, workers=workers)))
    del y
    report("r2r", label, x.shape, lambda: rt.dctn(x, type=2), err,
           tolerance(256, "complex128"),
           [rt.plan_r2r(x.shape, R2R.REDFT10).description,
            "(f64: dense pipeline on every axis)"],
           16 * x.numel(), launches, lambda: torch.fft.rfftn(x),
           "torch.fft.rfftn f64")
    del x
    torch.cuda.empty_cache()

    # CZT: the dense pipeline at a 5-smooth L, no kernel; bound 1e-5
    x = torch.complex(randn((4096, 1000)), randn((4096, 1000)))
    zp = rt.ZoomFFT(1000, [0.1, 0.4], 1000)
    if zp._L != 2000:
        raise AssertionError(f"zoom L {zp._L}")
    label = "zoom_fft_4096x1000"
    y, launches = counted(label, lambda: rt.zoom_fft(x, [0.1, 0.4], 1000))
    ref = ssig.zoom_fft(host64(x), [0.1, 0.4], 1000, fs=2)
    err = dev_rel(y, on_dev(ref))
    del y, ref
    report("czt", label, x.shape, lambda: rt.zoom_fft(x, [0.1, 0.4], 1000),
           err, 1e-5, ["(zoom fft [0.1, 0.4] m=1000: dense L=2000)"],
           16 * x.numel(), launches)
    x = torch.complex(randn((16384, 1009)), randn((16384, 1009)))
    if rt.CZT(1009)._L != 2025:
        raise AssertionError("czt L")
    label = "czt_16384x1009"
    y, launches = counted(label, lambda: rt.czt(x))
    err = dev_rel(y, on_dev(ssig.czt(host64(x))))
    del y
    report("czt", label, x.shape, lambda: rt.czt(x), err, 1e-5,
           ["(czt m=1009 default w: dense L=2025)"], 16 * x.numel(), launches,
           lambda: torch.fft.fft(x), "torch.fft.fft c64")
    del x
    torch.cuda.empty_cache()

    # FFTLog: batched Hankel transforms of power spectra, mu = 0.5: the JAX
    # suite's sample r^1.5 exp(-(r/r0)^2/2) on its grid (tests/test_fftlog.py
    # _sample), a cutoff r0 per row; fht's rfft is fft_last_r2c, its irfft
    # the half-length C2R on fft_last
    r = np.logspace(-3, 3, 1024)
    dln = float(np.log(r[1] / r[0]))
    r0 = 10 ** (0.6 * torch.rand(16384, 1, device=dev, generator=gen) - 0.3)
    rd = torch.from_numpy(r).to(dev)
    a = (rd ** 1.5 * torch.exp(-(rd / r0.double()) ** 2 / 2)).float()
    real_steps = [ln.strip() for k, d in (("r2c", -1), ("c2r", 1))
                  for ln in rt.make_plan((16384, 1024), axes=(1,), kind=k,
                                         direction=d).describe().splitlines()
                  if "real axis" in ln]
    for bias in (0.0, -0.5):
        offset = rt.fhtoffset(dln, 0.5, bias=bias)
        for name, fn, ref_fn in (("fht", rt.fht, sfft.fht),
                                 ("ifht", rt.ifht, sfft.ifht)):
            label = f"{name}_16384x1024_bias{bias:g}"
            call = (lambda fn=fn: fn(a, dln, 0.5, offset=offset, bias=bias))
            y, launches = counted(label, call)
            err = dev_rel(y, on_dev(ref_fn(host64(a), dln, 0.5,
                                           offset=offset, bias=bias)))
            del y
            report("fftlog", label, a.shape, call, err, 2e-5, real_steps,
                   8 * a.numel(), launches)
    del a, rd, r0

    # FFTLog on power-law spectra (POWER_LAW_JAX_ERR): each held to 2e-5, or
    # to REFERENCE_MARGIN x the JAX package's rel_l2 on the same rows where
    # that is larger; beside it the same algorithm on torch.fft's f32 and
    # f64 transforms, on the same coefficients
    dln, host = power_law_spectra()
    a = on_dev(host)
    for bias in (0.0, -0.5):
        offset = rt.fhtoffset(dln, 0.5, bias=bias)
        for name, fn, ref_fn in (("fht", rt.fht, sfft.fht),
                                 ("ifht", rt.ifht, sfft.ifht)):
            label = f"{name}_powerlaw_16384x1024_bias{bias:g}"
            call = (lambda fn=fn: fn(a, dln, 0.5, offset=offset, bias=bias))
            y, launches = counted(label, call)
            ref = on_dev(ref_fn(host.astype(np.float64), dln, 0.5,
                                offset=offset, bias=bias))
            err = dev_rel(y, ref)
            cu, pre, post, _ = fl._tables(1024, dln, 0.5, offset, bias,
                                          name == "ifht", str(dev))
            lib = {}
            for dt, ct in ((torch.float32, torch.complex64),
                           (torch.float64, torch.complex128)):
                v = a.to(dt) * (1 if pre is None else pre.to(dt))
                v = torch.fft.irfft(torch.fft.rfft(v) * cu.to(ct),
                                    1024).flip(-1)
                lib[dt] = dev_rel(v * (1 if post is None else post.to(dt)),
                                  ref)
            del y, ref, v
            jax_err = POWER_LAW_JAX_ERR[(name, bias)]
            tol = max(2e-5, REFERENCE_MARGIN * jax_err)
            print(f"{label}: rel_l2 {err:.3e}; the JAX package's "
                  f"{jax_err:.3e} on these rows (bound {tol:.3e}); the same "
                  f"algorithm on torch.fft f32 {lib[torch.float32]:.3e}, "
                  f"f64 {lib[torch.float64]:.3e}")
            report("fftlog", label, a.shape, call, err, tol, real_steps,
                   8 * a.numel(), launches)
            plan_rows[-1].update(
                rel_err_jax=jax_err,
                rel_err_torch_fft_f32=lib[torch.float32],
                rel_err_torch_fft_f64=lib[torch.float64])
    del a, host

    # NUFFT, eps = 1e-6: each result held against a float64 direct sum at
    # 64 sampled modes or points, computed in chunks on the card; an
    # unbatched 1-D grid is planned as one row
    def direct(tgt, src, w, isign, chunk=1 << 19):
        """sum_j w_j exp(isign i tgt_k . src_j) in float64: tgt (T, d),
        src (S, d), w (S,) complex128."""
        acc = torch.zeros(tgt.shape[0], dtype=torch.complex128, device=dev)
        for i in range(0, src.shape[0], chunk):
            ph = tgt @ src[i:i + chunk].T
            acc += (torch.polar(torch.ones_like(ph), isign * ph)
                    * w[i:i + chunk]).sum(1)
        return acc

    def modes(ns):
        """All mode vectors (K, d) of a centred grid, float64, row-major."""
        ks = [torch.arange(-(n // 2), (n + 1) // 2, device=dev,
                           dtype=torch.float64) for n in ns]
        return torch.stack([g.reshape(-1) for g in
                            torch.meshgrid(*ks, indexing="ij")], 1)

    sample = torch.Generator(device="cpu").manual_seed(12)

    def pick(count):
        return torch.randperm(count, generator=sample)[:64].to(dev)

    def grid_steps(shape, ndim):
        p = nu.grid_plan(shape, ndim, True, dev)
        return p, [ln.strip() for ln in p.describe().splitlines()[1:-1]]

    def nufft_group(label, shape, call, got_at, tgt, src, w, tol, nbytes,
                    grid, ndim, kinds):
        gpn, steps = grid_steps(grid, ndim)
        if [k for k, _, _ in gpn.steps] != kinds:
            raise AssertionError(f"{label}: grid steps {steps}")
        y, launches = counted(label, call)
        if y.dtype != torch.complex64 or not bool(
                torch.isfinite(torch.view_as_real(y)).all()):
            raise AssertionError(f"{label}: output {y.dtype}")
        err = dev_rel(got_at(y), direct(tgt, src, w, 1))
        del y
        mem = peak_bytes(call)
        report("nufft", label, shape, call, err, tol,
               [f"(grid {grid})"] + steps, nbytes, launches, mem=mem)
        torch.cuda.empty_cache()

    def crandn(shape):
        return torch.complex(randn(shape), randn(shape))

    def upoints(m):
        return (2 * torch.rand(m, device=dev, generator=gen) - 1) * math.pi

    for d, ns, m, grid, kinds, tol in (
            (1, (1 << 20,), 1 << 22, (1, 1 << 21), ["stockham4"], 2e-5),
            (2, (1024, 1024), 1 << 20, (2048, 2048),
             ["stockham", "stockham"], 5e-5),
            (3, (128, 128, 128), 1 << 18, (256, 256, 256),
             ["stockham2", "stockham"], 1e-4)):
        pts = [upoints(m) for _ in range(d)]
        src = torch.stack(pts, 1).double()
        c = crandn(m)
        nmodes = int(np.prod(ns))
        kall = modes(ns)
        t1, t2 = {1: ("nufft1d1_2^20", "nufft1d2_2^20"),
                  2: ("nufft2d1_1024sq", "nufft2d2_1024sq"),
                  3: ("nufft3d1_128cubed", "nufft3d2_128cubed")}[d]
        entry1 = {1: rt.nufft1d1, 2: rt.nufft2d1, 3: rt.nufft3d1}[d]
        entry2 = {1: rt.nufft1d2, 2: rt.nufft2d2, 3: rt.nufft3d2}[d]
        idx = pick(nmodes)
        nufft_group(t1, ns, lambda: entry1(*pts, c, *ns),
                    lambda y: y.reshape(-1)[idx], kall[idx], src,
                    c.to(torch.complex128), tol,
                    4 * d * m + 8 * m + 8 * nmodes, grid, d, kinds)
        f = crandn(ns)
        jdx = pick(m)
        nufft_group(t2, ns, lambda: entry2(*pts, f), lambda y: y[jdx],
                    src[jdx], kall, f.reshape(-1).to(torch.complex128), tol,
                    4 * d * m + 8 * nmodes + 8 * m, grid, d, kinds)
        del pts, src, c, kall, f
        torch.cuda.empty_cache()

    # type 3, M = nk = 2^20: the sources in [-pi, pi], the frequencies sized
    # so the fine grid's half-size n3 is 2^19 and the inner type 2 runs on a
    # grid of 2^21 (the four-step last axis)
    m = 1 << 20
    x3 = upoints(m)
    smax = 130250 * math.pi / float(x3.abs().max())
    s3 = (2 * torch.rand(m, device=dev, generator=gen) - 1) * smax
    s3[0] = smax
    c3 = crandn(m)
    (_, n3, _), = nu.t3_params((x3,), (s3,))
    if n3 != 1 << 19:
        raise AssertionError(f"type 3 n3 {n3}")
    kdx = pick(m)
    nufft_group("nufft1d3_2^20", (m,), lambda: rt.nufft1d3(x3, c3, s3),
                lambda y: y[kdx], s3[kdx].double()[:, None],
                x3.double()[:, None], c3.to(torch.complex128), 2e-5,
                4 * m + 8 * m + 4 * m + 8 * m, (1, 4 * n3), 1, ["stockham4"])
    del x3, s3, c3
    torch.cuda.empty_cache()
    check_held("phase 12")
    phase("12 (r2r, CZT, FFTLog, NUFFT)")

    # 13. the planner tiers on the card: the patient, measure and
    # exhaustive races (each candidate's median ms and the winner), the
    # model planner beside "estimate", calibration, Plan.benchmark against
    # phase 4's steps ms, the wisdom read back in a fresh process, bench_cli
    import tempfile
    from dataclasses import replace

    from regent_fft_tpu_torch import bench_cli
    from regent_fft_tpu_torch import plan as planmod
    from regent_fft_tpu_torch.native import planner as native
    from regent_fft_tpu_torch.utils import measure
    t13 = time.perf_counter()
    rt.cleanup()
    torch.cuda.empty_cache()
    if not native.available():
        raise AssertionError("native planner did not build")
    print(f"native planner: {native.library_path().name} (version "
          f"{native.version()})")
    planner_rows = []
    cube = (512, 512, 512)

    def step_lines(p):
        return [ln.strip() for ln in p.describe().splitlines()[1:-1]]

    def refused(spec, key, cand):
        """Whether the race's candidate `cand` is refused at plan build."""
        if key == "backend":
            spec = replace(spec, backend=cand)
        else:
            a0, f2 = (kv.split("=")[1] for kv in cand.split())
            spec = replace(spec, planner="estimate", axis0_impl=a0,
                           f2_impl=f2)
        try:
            planmod._build_core(spec)
        except measure.REFUSED:
            return True
        return False

    def race_report(label, p):
        """Print each race of plan p, candidate by candidate, and its
        winner; a candidate that plans must time finite."""
        for key, m in p.measurements.items():
            races = m["timings"]
            if isinstance(races, dict) and key == "exhaustive":
                races = {f"exhaustive {k}": v for k, v in races.items()}
            elif isinstance(races, dict):
                races = {str(key): races}
            else:
                print(f"race {label} {key}: {races}, winner {m['winner']}")
                continue
            for sub, t in races.items():
                print(f"race {label} {sub} (ms): " + ", ".join(
                    f"{c} {1e3 * v:.4f}" for c, v in t.items())
                    + f"; winner {m['winner']}")
                for c, v in t.items():
                    if not math.isfinite(v) and not (
                            key in ("backend", "patient")
                            and refused(p.spec, key, c)):
                        raise AssertionError(f"{label} {sub}: {c} planned "
                                             f"but timed {v}")

    def as_c64(y):
        return (torch.complex(y.re.float(), y.im.float())
                if isinstance(y, rt.SplitComplex) else y)

    def tier_group(label, raced, est, x, tol):
        """Run the raced plan once, its winner's routes planned as an
        estimate plan (`twin`) once, each counted: both launch the same
        kernels; the output within `tol` of the estimate plan's; ms of
        both."""
        w = {}
        for key in ("patient", "exhaustive"):
            if key in raced.measurements:
                w = raced.measurements[key]["winner"]
        s = raced.spec
        twin = rt.make_plan(
            s.shape, axes=s.axes, kind=s.kind, direction=s.direction,
            dtype=s.dtype, backend=w.get("backend", raced.backend),
            axis0_impl=w.get("axis0_impl", "auto"),
            f2_impl=w.get("f2_impl", "auto"))
        if step_lines(twin) != step_lines(raced):
            raise AssertionError(f"{label}: {step_lines(raced)} vs the "
                                 f"winner's {step_lines(twin)}")
        with recording():
            sk.reset_launches()
            y = raced(x)
            torch.cuda.synchronize()
            got = kernel_launches()
            sk.reset_launches()
            twin(x)
            torch.cuda.synchronize()
            want = kernel_launches()
        ran = {k: v for k, v in got.items() if v}
        print(f"{label} launches {ran}; the winner's routes planned "
              f"directly: {({k: v for k, v in want.items() if v})}")
        if got != want or (raced.backend != "xla" and not ran):
            raise AssertionError(f"{label} launches {got} != {want}")
        for kname, row in rows.items():
            row["launches_by_path"][label] = got[kname]
            row["launches"] += got[kname]
        if not bool(torch.isfinite(torch.view_as_real(as_c64(y))).all()):
            raise AssertionError(f"{label}: non-finite output")
        err = dev_rel(as_c64(y), as_c64(est(x)))
        if not err <= tol:
            raise AssertionError(f"{label}: rel_l2 {err} to the estimate "
                                 f"plan, tolerance {tol}")
        ms, est_ms = timed(lambda: raced(x)), timed(lambda: est(x))
        print(f"{label}: steps {step_lines(raced)}; {ms:.4f} ms (estimate "
              f"plan {est_ms:.4f} ms, steps {step_lines(est)}); rel_l2 to "
              f"the estimate plan {err:.3e} (tolerance {tol:.3e})")
        planner_rows.append({
            "label": label, "shape": list(s.shape), "dtype": s.dtype,
            "planner": s.planner, "steps": step_lines(raced),
            "estimate_steps": step_lines(est), "ms": ms, "estimate_ms": est_ms,
            "rel_err_vs_estimate": err, "tolerance": tol, "launches": ran,
            "races": {str(k): m for k, m in raced.measurements.items()}})

    # Plan.benchmark on the c64 512^3 grid plan against phase 4's steps ms
    # (before any race: a measured backend would steer "auto" plans)
    grid = rt.make_plan(cube)
    if step_lines(grid) != plan_rows[0]["steps"]:
        raise AssertionError(f"512^3 steps {step_lines(grid)}")
    with tempfile.TemporaryDirectory() as tmp:
        bres = grid.benchmark(profile_dir=tmp)
        traced = sorted(os.listdir(tmp))
    ratio = 1e3 * bres["time_s"] / plan_rows[0]["steps_ms"]
    print(f"Plan.benchmark c64 512^3: {1e3 * bres['time_s']:.4f} ms "
          f"({bres['methodology']}, {bres['gflops_convention']:.1f} GFLOP/s, "
          f"roofline {bres['roofline_fraction']}, hardware "
          f"{bres['hardware']}); phase 4 steps ms "
          f"{plan_rows[0]['steps_ms']:.4f} (ratio {ratio:.4f}); trace "
          f"{bres['trace']['ms']:.4f} ms, files {traced}")
    if not 0.9 <= ratio <= 1.1:
        raise AssertionError(f"Plan.benchmark {bres} vs steps ms "
                             f"{plan_rows[0]['steps_ms']}")
    planner_rows.append({"label": "Plan.benchmark c64 512^3",
                         "time_s": bres["time_s"],
                         "steps_ms_phase4": plan_rows[0]["steps_ms"],
                         "ratio": ratio})


    g13 = torch.Generator(device=dev).manual_seed(13)

    def c_input(shape, dtype="complex64"):
        xr = torch.randn(shape, device=dev, generator=g13)
        xi = torch.randn(shape, device=dev, generator=g13)
        if dtype == "complex32":
            return rt.SplitComplex(xr.to(torch.bfloat16), xi.to(torch.bfloat16))
        return torch.complex(xr, xi)

    # each estimate plan is made before its race: "auto" plans made after
    # one take the measured backend
    patient, ests = {}, {}
    for dtype in ("complex64", "complex32"):
        est = ests[dtype] = rt.make_plan(cube, dtype=dtype)
        t0 = time.perf_counter()
        p = rt.make_plan(cube, dtype=dtype, planner="patient")
        print(f"patient {dtype} 512^3 planned in "
              f"{time.perf_counter() - t0:.2f} s")
        race_report(f"patient {dtype} 512^3", p)
        tier_group(f"patient {dtype} 512^3", p, est, c_input(cube, dtype),
                   tolerance(512 ** 3, dtype))
        patient[dtype] = p
    torch.cuda.empty_cache()

    for label, shape, axes, kind in (
            ("measure c64 4096x1024", (4096, 1024), (1,), "c2c"),
            ("measure c64 64x2^20", (64, 1 << 20), (1,), "c2c"),
            ("measure r2c 4x256^3", (4, 256, 256, 256), (1, 2, 3), "r2c")):
        k_, d_ = (rt.Kind.R2C, rt.FORWARD) if kind == "r2c" else (
            rt.Kind.C2C, rt.FORWARD)
        est = rt.make_plan(shape, axes=axes, kind=k_, direction=d_)
        t0 = time.perf_counter()
        p = rt.make_plan(shape, axes=axes, kind=k_, direction=d_,
                         planner="measure")
        print(f"{label} planned in {time.perf_counter() - t0:.2f} s")
        race_report(label, p)
        x = (torch.randn(shape, device=dev, generator=g13) if kind == "r2c"
             else c_input(shape))
        tier_group(label, p, est, x, tolerance(p.spec.logical_n))
        del x
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ex = rt.make_plan(cube, dtype="complex32", planner="exhaustive")
    print(f"exhaustive complex32 512^3 planned in "
          f"{time.perf_counter() - t0:.2f} s")
    race_report("exhaustive complex32 512^3", ex)
    ew = ex.measurements["exhaustive"]
    grid = measure.knob_combos(ex.spec, planmod._build_core(replace(
        ex.spec, planner="estimate", backend=ew["winner"]["backend"])).steps)
    print(f"exhaustive knobs: the JAX package's grid "
          f"{[measure.knob_name(c) for c in grid]}; raced on the card "
          f"{sorted(measure.RACED_KNOBS)} (none selects another kernel "
          f"instance or plain body here: utils/measure.py RACED_KNOBS); "
          f"winner knobs {ew['winner']['knobs']}, plan knobs {ex.knobs}")
    if ex.knobs or list(ew["timings"]["knobs"]) != ["defaults"]:
        raise AssertionError(f"exhaustive knobs {ew}")
    tier_group("exhaustive complex32 512^3", ex, ests["complex32"],
               c_input(cube, "complex32"), tolerance(512 ** 3, "complex32"))
    torch.cuda.empty_cache()

    # the model planner on a contraction-path shape
    shape = (16384, 1000)
    est = rt.make_plan(shape, axes=(1,), backend="xla")
    mod = rt.make_plan(shape, axes=(1,), backend="xla", planner="model")
    x = c_input(shape)
    ref = torch.fft.fft(x.to(torch.complex128), dim=1)
    errs = [dev_rel(q(x), ref) for q in (est, mod)]
    tms = [timed(lambda q=q: q(x)) for q in (est, mod)]
    print(f"model vs estimate c64 16384x1000 backend=xla: estimate "
          f"{step_lines(est)} {tms[0]:.4f} ms rel_l2 {errs[0]:.3e}, cost "
          f"{est.cost():.4e}; model {step_lines(mod)} {tms[1]:.4f} ms rel_l2 "
          f"{errs[1]:.3e}, cost {mod.cost():.4e}")
    if not max(errs) <= tolerance(1000):
        raise AssertionError(f"model/estimate rel_l2 {errs}")
    planner_rows.append({"label": "model vs estimate c64 16384x1000 xla",
                         "steps": step_lines(mod),
                         "estimate_steps": step_lines(est), "ms": tms[1],
                         "estimate_ms": tms[0], "rel_err_vs_torch_fft": errs,
                         "cost": mod.cost()})
    del x, ref

    # calibration at full size, against the datasheet
    t0 = time.perf_counter()
    cal = rt.calibrate()
    print(f"calibrate() in {time.perf_counter() - t0:.2f} s: {cal.to_dict()}; "
          f"mxu_tflops {cal.mxu_tflops:.3f} (f32 matmul, TF32 off; datasheet "
          f"FP32 {fp32 / 1e12}), vpu_gflops {cal.vpu_gflops:.1f}, hbm_gbps "
          f"{cal.hbm_gbps:.1f} (datasheet {bw / 1e9}), stage_overhead_s "
          f"{cal.stage_overhead_s:.3e}; cost parameters vpu_rate "
          f"{cal.vpu_rate:.4e}, bw_unit {cal.bw_unit:.3f}, stage_overhead "
          f"{cal.stage_overhead_units():.4e}")
    if not (cal.mxu_tflops > 0 and cal.vpu_gflops > 0
            and 0 < cal.hbm_gbps <= 1.05 * bw / 1e9
            and cal.stage_overhead_s >= 0):
        raise AssertionError(f"calibration {cal}")
    planner_rows.append({"label": "calibration", **cal.to_dict()})

    # the wisdom of this run in a fresh process: the patient plan there is
    # the cached winner's
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wisdom.json")
        rt.export_wisdom_to_filename(path)
        code = (
            "import json, sys, torch\n"
            "import regent_fft_tpu_torch as rt\n"
            "n = rt.import_wisdom_from_filename(sys.argv[1], build=False)\n"
            "p = rt.make_plan((512, 512, 512), planner='patient')\n"
            "g = torch.Generator(device='cuda').manual_seed(0)\n"
            "x = torch.randn((512, 512, 512), device='cuda', generator=g)\n"
            "y = p(torch.complex(x, x))\n"
            "print(json.dumps({'entries': n, 'timings': "
            "p.measurements['patient']['timings'], 'steps': [ln.strip() for "
            "ln in p.describe().splitlines()[1:-1]], 'finite': "
            "bool(torch.isfinite(torch.view_as_real(y)).all())}))\n")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", code, path],
                           cwd=os.path.dirname(os.path.abspath(__file__)),
                           capture_output=True, text=True, timeout=300)
    if r.returncode:
        raise AssertionError(f"wisdom subprocess: {r.stderr[-3000:]}")
    fresh = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"wisdom in a fresh process ({time.perf_counter() - t0:.2f} s): "
          f"{fresh}")
    if (fresh["timings"] != "cached-wisdom" or not fresh["finite"]
            or fresh["steps"] != step_lines(patient["complex64"])):
        raise AssertionError(f"fresh-process wisdom {fresh} vs "
                             f"{step_lines(patient['complex64'])}")

    check_held("phase 13")

    # bench_cli's baseline suite on the card
    rc = bench_cli.main(["--suite", "baseline", "--verify"])
    if rc:
        raise AssertionError(f"bench_cli --suite baseline exit {rc}")
    print(json.dumps({"planners": planner_rows}, default=str))
    print(f"phase 13 took {time.perf_counter() - t13:.1f} s")
    phase("13 (planner tiers)")

    # 14. signal.py, spectral.py, torch_fft.py and scipy_backend.py on the
    # card: one counted group per function at full width (SIGNAL_GROUPS),
    # each held against scipy/numpy in float64 at the JAX suites' bounds
    # (max|y - ref| / max|ref| for signal and spectral, rel_l2 for the
    # adapters) on SIGNAL_ROWS rows chosen by a numpy seed where scipy on
    # the whole batch is slow, the 3-D volume against direct sums at 64
    # sampled points, the 3-D transforms against torch.fft in float64 on
    # the card; timed beside its bound and a PyTorch yardstick, and traced
    import warnings

    import torch.nn.functional as F

    from regent_fft_tpu_torch import scipy_backend as sb
    from regent_fft_tpu_torch import torch_fft as tf
    t14 = time.perf_counter()
    rt.cleanup()          # phase 13's winners and schedules steer no plan here
    groups.update(SIGNAL_GROUPS)
    S = SIGNAL_SHAPES
    pick_rng = np.random.default_rng(14)
    c64 = torch.complex64

    def pick(n):
        """SIGNAL_ROWS row indices chosen by a numpy seed."""
        return sorted(pick_rng.choice(n, min(SIGNAL_ROWS, n),
                                      replace=False).tolist())

    def max_rel(got, ref):
        """max |got - ref| / max |ref| (the JAX suites' _check, _close)."""
        got, ref = np.asarray(got), np.asarray(ref)
        if got.shape != ref.shape:
            raise AssertionError(f"shape {got.shape} != {ref.shape}")
        return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))

    def rel(got, ref):
        """rel_l2 on the host (the JAX suites' _agree, _rel)."""
        got = np.asarray(got, np.complex128)
        ref = np.asarray(ref, np.complex128)
        return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))

    def rfl(n, rows):
        return 2.5 * rows * n * math.log2(n)

    def cfl(n, rows):
        return 5.0 * rows * n * math.log2(n)

    def no_torch_fft(fn):
        """fn with every torch.fft function raising while it runs."""
        def run():
            saved = {k: getattr(torch.fft, k) for k in tf.__all__
                     if hasattr(torch.fft, k)}

            def boom(*a, **k):
                raise AssertionError("a torch_fft call reached torch.fft")
            try:
                for k in saved:
                    setattr(torch.fft, k, boom)
                return fn()
            finally:
                for k, v in saved.items():
                    setattr(torch.fft, k, v)
        return run

    def via_backend(fn):
        """fn under the card's scipy.fft backend alone (only=True: a call
        it declined raises), its RuntimeWarning an error."""
        def run():
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                with sfft.set_backend(sb.RegentFFTBackend, only=True):
                    return fn()
        return run

    def group(kind, label, shape, call, check, tol, nbytes, nflops, lib,
              lib_call, mem=False, metric="max_rel", counted_call=None,
              steps=None):
        """One counted run (the plan cache cleared first, so the plans are
        this call's), check(y) -> error, then report; the device time
        split between the port's kernels and the torch glue."""
        rt.clear_plan_cache()
        y, launches = counted(label, counted_call or call)
        err = check(y)
        del y
        steps = (steps or []) + [
            f"{p.spec.kind.value} {list(p.spec.shape)} "
            + " ".join(ln.strip() for ln in p.describe().splitlines()[1:-1])
            for p in rt.cached_plans()]
        if not any(launches.values()):
            steps.append("(dense pipeline: no kernel launch)")
        m = peak_bytes(call) if mem else None
        report(kind, label, shape, call, err, tol, steps, nbytes, launches,
               lib, lib_call, m, nflops, metric)
        row = plan_rows[-1]
        row["port_kernels_ms"] = sum(v for k, v in row["device_ms_by_kernel"]
                                     if PORT_KERNEL.search(k))
        print(f"{label}: port kernels {row['port_kernels_ms']:.4f} of "
              f"{row['device_ms']:.4f} device ms, the rest torch glue")
        torch.cuda.empty_cache()
        return row

    # fftconvolve and correlate: the image blur, packed R2C/C2R at 1024^2
    (sa, sk_) = S["blur"]
    a, k = randn(sa), randn(sk_)
    ia = pick(sa[0])
    ha, hk = host64(a[ia]), host64(k[ia])
    s2 = tuple(rt.signal._conv_sizes(sa, sk_, (1, 2), "auto")[0][1:])
    st = [(sk_[i] - 1) // 2 for i in (1, 2)]

    def torch_same(x, w):
        y = torch.fft.irfftn(torch.fft.rfftn(x, s2, dim=(1, 2))
                             * torch.fft.rfftn(w, s2, dim=(1, 2)), s2,
                             dim=(1, 2))
        return y[:, st[0]:st[0] + sa[1], st[1]:st[1] + sa[2]]

    nb2 = 4 * (2 * a.numel() + k.numel())
    fl2 = 3 * sa[0] * 2.5 * s2[0] * s2[1] * math.log2(s2[0] * s2[1])
    group("signal", "fftconvolve_blur", sa,
          lambda: rt.fftconvolve(a, k, mode="same", axes=(1, 2)),
          lambda y: max_rel(host64(y[ia]), np.stack(
              [ssig.fftconvolve(ha[j], hk[j], mode="same")
               for j in range(len(ia))])),
          2e-4, nb2, fl2, lambda: torch_same(a, k),
          "torch.fft rfftn/irfftn chain")
    group("signal", "correlate_same", sa,
          lambda: rt.correlate(a, k, mode="same", axes=(1, 2)),
          lambda y: max_rel(host64(y[ia]), np.stack(
              [ssig.correlate(ha[j], hk[j], mode="same", method="fft")
               for j in range(len(ia))])),
          2e-4, nb2, fl2, lambda: torch_same(a, k.flip((1, 2))),
          "torch.fft rfftn/irfftn chain (flipped kernel)")
    del a, k

    # fftconvolve: the volume, packed R2C/C2R at 512^3, held against
    # direct sums at 64 sampled points of the "same" output on the card
    (sv, svk) = S["volume"]
    a, k = randn(sv), randn(svk)
    s3 = rt.signal._conv_sizes(sv, svk, (0, 1, 2), "auto")[0]
    pts = np.random.default_rng(15).integers(0, sv[0], size=(64, 3))
    half = [(m - 1) // 2 for m in svk]

    def direct(p):
        i = [int(p[d]) + half[d] for d in range(3)]
        lo = [max(i[d] - svk[d] + 1, 0) for d in range(3)]
        hi = [min(i[d], sv[d] - 1) + 1 for d in range(3)]
        aw = a[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].double()
        kw = k[i[0] - hi[0] + 1:i[0] - lo[0] + 1,
               i[1] - hi[1] + 1:i[1] - lo[1] + 1,
               i[2] - hi[2] + 1:i[2] - lo[2] + 1].double().flip((0, 1, 2))
        return float((aw * kw).sum())

    ref3 = np.array([direct(p) for p in pts])

    def torch_volume():
        y = torch.fft.irfftn(torch.fft.rfftn(a, s3) * torch.fft.rfftn(k, s3),
                             s3)
        return y[half[0]:half[0] + sv[0], half[1]:half[1] + sv[1],
                 half[2]:half[2] + sv[2]]

    group("signal", "fftconvolve_volume", sv,
          lambda: rt.fftconvolve(a, k, mode="same"),
          lambda y: max_rel(
              np.array([float(y[tuple(p)]) for p in pts]), ref3),
          2e-4, 4 * (2 * a.numel() + k.numel()),
          3 * 2.5 * np.prod(s3) * math.log2(np.prod(s3)), torch_volume,
          "torch.fft rfftn/irfftn chain", mem=True)
    del a, k

    # fftconvolve, complex: the matched filter (C2C at next_fast_len)
    (sm, smk) = S["matched"]
    a = torch.complex(randn(sm), randn(sm))
    k = torch.complex(randn(smk), randn(smk))
    ia = pick(sm[0])
    ha, hk = host64(a[ia]), host64(k[ia])
    nm = rt.next_fast_len(sm[1] + smk[1] - 1)
    group("signal", "fftconvolve_complex", sm,
          lambda: rt.fftconvolve(a, k, axes=(1,)),
          lambda y: max_rel(host64(y[ia]), np.stack(
              [ssig.fftconvolve(ha[j], hk[j]) for j in range(len(ia))])),
          2e-4, 8 * (2 * a.numel() + k.numel()), 3 * cfl(nm, sm[0]),
          lambda: torch.fft.ifft(torch.fft.fft(a, nm) * torch.fft.fft(k, nm)),
          "torch.fft fft/ifft chain")
    del a, k

    # oaconvolve: a long FIR, blocks of 4096 riding the batch axis
    (bl, nl), (_, kl) = S["long"], S["fir"]
    x, h = randn((bl, nl)), randn((bl, kl))
    il = pick(bl)
    hx, hh = host64(x[il]), host64(h[il])
    L = rt.signal._next_pow2(8 * kl) - (kl - 1)
    nbk = -(-nl // L)
    xb = F.pad(x, (0, nbk * L - nl)).reshape(bl, nbk, L)
    nfl = L + kl - 1
    group("signal", "oaconvolve_fir", (bl, nl),
          lambda: rt.oaconvolve(x, h, mode="same", axes=(1,)),
          lambda y: max_rel(host64(y[il]), np.stack(
              [ssig.oaconvolve(hx[j], hh[j], mode="same")
               for j in range(len(il))])),
          2e-4, 4 * (2 * x.numel() + h.numel()), 3 * rfl(nfl, bl * nbk),
          lambda: torch.fft.irfft(torch.fft.rfft(xb, nfl)
                                  * torch.fft.rfft(h, nfl)[:, None], nfl),
          f"torch.fft rfft/irfft of the same {tuple(xb.shape)} blocks "
          "(no overlap-add)")
    del xb

    # stft / istft on the same channels: nperseg 512, noverlap 384
    win = torch.hann_window(512, periodic=True, device=dev)
    group("signal", "stft", (bl, nl),
          lambda: rt.stft(x, nperseg=512, noverlap=384)[2],
          lambda y: max_rel(host64(y[il]), ssig.stft(
              hx, nperseg=512, noverlap=384, detrend=False)[2]),
          1e-4, 4 * x.numel() + 8 * bl * 257 * (nl // 128 + 1),
          rfl(512, bl * (nl // 128 + 1)),
          lambda: torch.stft(x, 512, 128, window=win, center=True,
                             pad_mode="constant", return_complex=True),
          "torch.stft", mem=True)
    z = rt.stft(x, nperseg=512, noverlap=384)[2]
    hz = host64(z[il])
    zt = torch.stft(x, 512, 128, window=win, center=True, pad_mode="constant",
                    return_complex=True)
    group("signal", "istft", tuple(z.shape),
          lambda: rt.istft(z, nperseg=512, noverlap=384)[1],
          lambda y: max_rel(host64(y[il]), ssig.istft(
              hz, nperseg=512, noverlap=384)[1][..., :y.shape[-1]]),
          1e-4, 8 * z.numel() + 4 * x.numel(), rfl(512, z.numel() // 257),
          lambda: torch.istft(zt, 512, 128, window=win, center=True),
          "torch.istft", mem=True)
    del z, zt

    # the Welch family on the same channels: nperseg 1024
    y2 = randn((bl, nl))
    hy = host64(y2[il])
    w1k = torch.hann_window(1024, periodic=True, device=dev)

    def torch_spec(u, step=512):
        seg = u.unfold(-1, 1024, step)
        return torch.fft.rfft((seg - seg.mean(-1, keepdim=True)) * w1k)

    nseg = (nl - 1024) // 512 + 1
    lbl = "torch.fft chain (unfold, detrend, window, rfft, products, mean)"
    spec_bytes = 4 * x.numel() + 4 * bl * 513
    group("spectral", "welch", (bl, nl),
          lambda: rt.welch(x, nperseg=1024)[1],
          lambda y: max_rel(host64(y[il]),
                            ssig.welch(hx, nperseg=1024)[1]),
          2e-4, spec_bytes, rfl(1024, bl * nseg),
          lambda: (torch_spec(x).abs() ** 2).mean(-2), lbl)
    group("spectral", "csd", (bl, nl),
          lambda: rt.csd(x, y2, nperseg=1024)[1],
          lambda y: max_rel(host64(y[il]),
                            ssig.csd(hx, hy, nperseg=1024)[1]),
          2e-4, spec_bytes + 4 * y2.numel() + 4 * bl * 513,
          2 * rfl(1024, bl * nseg),
          lambda: (torch_spec(x).conj() * torch_spec(y2)).mean(-2), lbl)

    def torch_coh():
        fx, fy = torch_spec(x), torch_spec(y2)
        pxy = (fx.conj() * fy).mean(-2)
        return pxy.abs() ** 2 / ((fx.abs() ** 2).mean(-2)
                                 * (fy.abs() ** 2).mean(-2))

    group("spectral", "coherence", (bl, nl),
          lambda: rt.coherence(x, y2, nperseg=1024)[1],
          lambda y: max_rel(host64(y[il]),
                            ssig.coherence(hx, hy, nperseg=1024)[1]),
          1e-3, spec_bytes + 4 * y2.numel(), 4 * rfl(1024, bl * nseg),
          torch_coh, lbl)
    nseg_s = (nl - 1024) // 896 + 1
    group("spectral", "spectrogram", (bl, nl),
          lambda: rt.spectrogram(x, nperseg=1024)[2],
          lambda y: max_rel(host64(y[il]),
                            ssig.spectrogram(hx, nperseg=1024)[2]),
          5e-4, 4 * x.numel() + 4 * bl * 513 * nseg_s,
          rfl(1024, bl * nseg_s),
          lambda: torch_spec(x, 896).abs() ** 2,
          "torch.fft chain (unfold, detrend, window, rfft, |X|^2)")
    del y2

    # hilbert on the same channels' length class, and on 1024 x 16384
    for label, shape in (("hilbert", S["hilbert"]),
                         ("hilbert_long", S["hilbert_long"])):
        xh = randn(shape)
        ih = pick(shape[0])
        hxh = host64(xh[ih])
        n = shape[1]
        hvec = torch.zeros(n, device=dev)
        hvec[0] = hvec[n // 2] = 1.0
        hvec[1:n // 2] = 2.0
        group("signal", label, shape, lambda: rt.hilbert(xh),
              lambda y: max_rel(host64(y[ih]), ssig.hilbert(hxh)),
              2e-4, 12 * xh.numel(), 2 * cfl(n, shape[0]),
              lambda: torch.fft.ifft(torch.fft.fft(xh) * hvec),
              "torch.fft fft/ifft chain")
        del xh
    del x, h

    # hilbert2: 2048^2 on the 2-D C2C route
    sh2 = S["hilbert2"]
    xh = randn(sh2)
    h1 = torch.zeros(sh2[0], device=dev)
    h1[0] = 1.0
    h1[1:(sh2[0] + 1) // 2] = 2.0
    group("signal", "hilbert2", sh2, lambda: rt.hilbert2(xh),
          lambda y: max_rel(host64(y), ssig.hilbert2(host64(xh))),
          2e-4, 12 * xh.numel(), 2 * cfl(xh.numel(), 1),
          lambda: torch.fft.ifft2(torch.fft.fft2(xh) * torch.outer(h1, h1)),
          "torch.fft fft2/ifft2 chain")
    del xh

    # resample: real 2048 -> 1024 and complex 2048 -> 4096 along the rows
    sr = S["resample"]
    xr = randn(sr)
    xc = torch.complex(randn(sr), randn(sr))
    ir = pick(sr[0])
    nr = sr[1]
    group("signal", "resample_real", sr,
          lambda: rt.resample(xr, nr // 2, axis=-1),
          lambda y: max_rel(host64(y[ir]),
                            ssig.resample(host64(xr[ir]), nr // 2, axis=-1)),
          5e-4, 4 * xr.numel() * 3 // 2, rfl(nr, sr[0]) + rfl(nr // 2, sr[0]),
          lambda: torch.fft.irfft(torch.fft.rfft(xr)[:, :nr // 4 + 1],
                                  nr // 2),
          "torch.fft rfft -> crop -> irfft chain")
    zpad = torch.zeros((sr[0], nr), dtype=c64, device=dev)

    def torch_upsample():
        f = torch.fft.fft(xc)
        return torch.fft.ifft(torch.cat([f[:, :nr // 2], zpad,
                                         f[:, nr // 2:]], 1))

    group("signal", "resample_complex", sr,
          lambda: rt.resample(xc, 2 * nr, axis=-1),
          lambda y: max_rel(host64(y[ir]),
                            ssig.resample(host64(xc[ir]), 2 * nr, axis=-1)),
          5e-4, 8 * xc.numel() * 3, cfl(nr, sr[0]) + cfl(2 * nr, sr[0]),
          torch_upsample, "torch.fft fft -> zero-pad -> ifft chain")
    del xr, xc, zpad

    # periodogram: 4096 rows of 1024, one segment each
    sp = S["periodogram"]
    xp = randn(sp)
    group("spectral", "periodogram", sp, lambda: rt.periodogram(xp)[1],
          lambda y: max_rel(host64(y), ssig.periodogram(host64(xp))[1]),
          2e-4, 4 * xp.numel() + 4 * sp[0] * (sp[1] // 2 + 1),
          rfl(sp[1], sp[0]),
          lambda: torch.fft.rfft(xp - xp.mean(-1, keepdim=True)).abs() ** 2,
          "torch.fft chain (detrend, rfft, |X|^2)")
    del xp

    # torch_fft on CUDA tensors; torch.fft raises while each counted call
    # runs, so none of them reaches it
    srow = S["rows"]
    xc = torch.complex(randn(srow), randn(srow))
    ir = pick(srow[0])
    hxc = host64(xc[ir])
    group("torch_fft", "torch_fft_fft_c64", srow, lambda: tf.fft(xc),
          lambda y: rel(host64(y[ir]), np.fft.fft(hxc)), 2e-5,
          16 * xc.numel(), cfl(srow[1], srow[0]), lambda: torch.fft.fft(xc),
          "torch.fft.fft", metric="rel_l2",
          counted_call=no_torch_fft(lambda: tf.fft(xc)))
    xb = randn(srow).to(torch.bfloat16)
    group("torch_fft", "torch_fft_fft_bf16", srow, lambda: tf.fft(xb),
          lambda y: rel(host64(y[ir]), np.fft.fft(host64(xb[ir]))), 2e-5,
          2 * xb.numel() + 8 * xb.numel(), cfl(srow[1], srow[0]),
          lambda: torch.fft.fft(xb.float()),
          "torch.fft.fft of the widened data", metric="rel_l2",
          counted_call=no_torch_fft(lambda: tf.fft(xb)))
    del xc, xb
    svol = S["volumes"]
    v = randn(svol)
    hv = v.cpu().numpy()
    ref_v = sfft.rfftn(hv.astype(np.float64), axes=(1, 2, 3), workers=workers)
    group("torch_fft", "torch_fft_rfftn", svol,
          lambda: tf.rfftn(v, dim=(1, 2, 3)),
          lambda y: rel(y.cpu().numpy(), ref_v), 2e-5,
          4 * v.numel() + 8 * v.numel() // svol[-1] * (svol[-1] // 2 + 1),
          rfl(v.numel() // svol[0], svol[0]),
          lambda: torch.fft.rfftn(v, dim=(1, 2, 3)), "torch.fft.rfftn",
          metric="rel_l2",
          counted_call=no_torch_fft(lambda: tf.rfftn(v, dim=(1, 2, 3))))
    zv = tf.rfftn(v, dim=(1, 2, 3))
    group("torch_fft", "torch_fft_irfftn", svol,
          lambda: tf.irfftn(zv, s=svol[1:], dim=(1, 2, 3)),
          lambda y: dev_rel(y, v), 2e-5, 8 * zv.numel() + 4 * v.numel(),
          rfl(v.numel() // svol[0], svol[0]),
          lambda: torch.fft.irfftn(zv, s=svol[1:], dim=(1, 2, 3)),
          "torch.fft.irfftn", metric="rel_l2 (round trip to the input)",
          counted_call=no_torch_fft(
              lambda: tf.irfftn(zv, s=svol[1:], dim=(1, 2, 3))))
    del zv
    scube = S["cube"]
    xq = torch.complex(randn(scube), randn(scube))
    group("torch_fft", "torch_fft_fftn_cube", scube, lambda: tf.fftn(xq),
          lambda y: dev_rel(y, torch.fft.fftn(xq.to(torch.complex128))),
          2e-5, 16 * xq.numel(), cfl(xq.numel(), 1),
          lambda: torch.fft.fftn(xq), "torch.fft.fftn", metric="rel_l2",
          counted_call=no_torch_fft(lambda: tf.fftn(xq)))
    del xq

    # scipy.fft through the card's backend: numpy in, numpy out
    hxc = torch.complex(randn(srow), randn(srow)).cpu().numpy()
    ir = pick(srow[0])

    def host_torch(fn, h):
        return lambda: fn(torch.from_numpy(h).to(dev)).cpu().numpy()

    for label, h, want_dtype in (
            ("scipy_fft_fft_c64", hxc, np.complex64),
            ("scipy_fft_fft_f64", hxc.astype(np.complex128), np.complex128)):
        call = via_backend(lambda h=h: sfft.fft(h))

        def check(y, h=h, want_dtype=want_dtype):
            if not isinstance(y, np.ndarray) or y.dtype != want_dtype:
                raise AssertionError(f"scipy backend output {type(y)} "
                                     f"{getattr(y, 'dtype', None)}")
            if want_dtype == np.complex128 and not any(
                    p.spec.dtype == "complex128" for p in rt.cached_plans()):
                raise AssertionError("the f64 call planned no complex128 "
                                     "plan: it did not run on the port")
            return rel(y[ir], np.fft.fft(h[ir].astype(np.complex128)))

        group("scipy_backend", label, srow, call, check, 1e-5,
              2 * h.nbytes, cfl(srow[1], srow[0]),
              host_torch(torch.fft.fft, h),
              "torch.fft.fft with the host copies", metric="rel_l2")
    group("scipy_backend", "scipy_fft_rfftn", svol,
          via_backend(lambda: sfft.rfftn(hv, axes=(1, 2, 3))),
          lambda y: rel(y, ref_v), 1e-5,
          hv.nbytes + 8 * hv.size // svol[-1] * (svol[-1] // 2 + 1),
          rfl(hv.size // svol[0], svol[0]),
          host_torch(lambda t: torch.fft.rfftn(t, dim=(1, 2, 3)), hv),
          "torch.fft.rfftn with the host copies", metric="rel_l2")
    del v, hv, ref_v
    hd = randn(S["dctn"]).cpu().numpy()
    ref_d = sfft.dctn(hd.astype(np.float64), type=2, workers=workers)
    group("scipy_backend", "scipy_fft_dctn", S["dctn"],
          via_backend(lambda: sfft.dctn(hd, type=2)),
          lambda y: rel(y, ref_d), 1e-4, 2 * hd.nbytes,
          rfl(hd.size, 1), host_torch(torch.fft.rfftn, hd),
          "torch.fft.rfftn with the host copies (not the same function)",
          metric="rel_l2", steps=r2r_steps(rt.plan_r2r(
              S["dctn"], R2R.REDFT10, axes=(0, 1, 2))))
    del hd, ref_d
    # fht: the JAX suite's sample r^1.5 exp(-(r/r0)^2/2), a cutoff per row,
    # float64 numpy (the port computes it in float32, as the JAX package)
    sfh = S["fht"]
    r = np.logspace(-3, 3, sfh[1])
    dln = float(np.log(r[1] / r[0]))
    r0 = 10 ** (0.6 * np.random.default_rng(16).random((sfh[0], 1)) - 0.3)
    hf = r ** 1.5 * np.exp(-(r / r0) ** 2 / 2)
    off = rt.fhtoffset(dln, 0.5)
    ifh = pick(sfh[0])
    group("scipy_backend", "scipy_fft_fht", sfh,
          via_backend(lambda: sfft.fht(hf, dln, 0.5, offset=off)),
          lambda y: rel(y[ifh], sfft.fht(hf[ifh], dln, 0.5, offset=off)),
          1e-4, 2 * hf.nbytes, 2 * rfl(sfh[1], sfh[0]),
          host_torch(lambda t: torch.fft.irfft(torch.fft.rfft(t)), hf),
          "torch.fft rfft/irfft chain with the host copies", metric="rel_l2")
    del hf
    torch.cuda.empty_cache()
    check_held("phase 14")
    print(f"phase 14 took {time.perf_counter() - t14:.1f} s")
    phase("14 (signal, spectral, torch_fft, scipy_backend)")

    # 15. the distributed plans (parallel/) in this process as a one-rank
    # NCCL group (the card is one H100; NCCL takes one rank a card): each
    # mode counted once at full width, held against torch.fft in float64
    # (the 1024^3 slab against the single-device plan), timed beside the
    # single-device plan of the same spec, traced (the port's kernels, the
    # NCCL kernel, and the rest: the pack/unpack copies around the
    # exchange, pads and the scale), with its peak memory.  Multi-card
    # NCCL (world size > 1) is not run here.
    import tempfile

    import torch.distributed as tdist

    from regent_fft_tpu_torch.parallel import distributed as pdist
    from regent_fft_tpu_torch.parallel import mesh as pmesh
    t15 = time.perf_counter()
    rt.cleanup()
    groups.update(DIST_GROUPS)
    ddev = "cuda"
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    pmesh.init_distributed(device=ddev, init_method="file://"
                           + os.path.join(store, "store"), world_size=1,
                           rank=0)
    print(f"phase 15: process group {tdist.get_backend()}, world size "
          f"{tdist.get_world_size()}; {pmesh.num_nodes()} node, "
          f"{pmesh.num_local_devices()} local devices")
    if tdist.get_backend() != "nccl" or tdist.get_world_size() != 1:
        raise AssertionError("phase 15 needs a one-rank NCCL group")
    dist_rows = []

    def split_trace(rows_):
        """A trace's device ms: the port's kernels, NCCL's, the rest."""
        k = sum(v for n, v in rows_ if PORT_KERNEL.search(n))
        c = sum(v for n, v in rows_ if "nccl" in n.lower())
        return k, c, sum(v for _, v in rows_) - k - c

    def dist_case(label, plan, fn, check, tol, single=None, reps=10,
                  nbytes=0):
        """One counted run of fn (the plan's execute_split), check(y) ->
        error <= tol, fn timed (median of reps) beside the single-device
        plan's call `single`, traced once, its peak memory read."""
        y, launches = counted(label, fn)
        err = check(y)
        del y
        if not err <= tol:
            raise AssertionError(f"{label}: rel_l2 {err} > {tol}")
        ms = timing.time_ms(fn, reps, dev)
        single_ms = (None if single is None
                     else timing.time_ms(single, reps, dev))
        total, by = timing.trace(fn, dev)
        k_ms, n_ms, c_ms = split_trace(by)
        mem = peak_bytes(fn)
        b_ms, b_by = bound(nbytes, 0)
        desc = plan.description if plan is not None else ""
        cores = [] if plan is None else [
            f"{list(c.spec.shape)} "
            + " ".join(ln.strip() for ln in c.describe().splitlines()[1:-1])
            for c in getattr(plan, "cores", [])]
        row = {"kind": "distributed", "route": label, "description": desc,
               "steps": cores, "rel_err_vs_f64": err, "tolerance": tol,
               "ms": ms, "single_device_ms": single_ms,
               "bytes_ideal": nbytes, "bound_ms": b_ms, "bound_by": b_by,
               "device_ms": total, "kernels_ms": k_ms, "nccl_ms": n_ms,
               "copies_ms": c_ms, "peak_bytes": mem[0],
               "peak_rise_bytes": mem[1],
               "launches": {k: v for k, v in launches.items() if v}}
        plan_rows.append(row)
        dist_rows.append(row)
        print(f"{label}: {ms:.4f} ms (single-device plan "
              + ("-" if single_ms is None else f"{single_ms:.4f}")
              + f" ms; bound {b_ms:.4f}); traced device {total:.4f} ms = "
              f"port kernels {k_ms:.4f} + NCCL kernels {n_ms:.4f} + copies "
              f"and glue {c_ms:.4f} (the profiler drops records); rel_l2 "
              f"{err:.3e} (bound {tol:.1e}); peak "
              f"{mem[0]} B ({mem[1]} B over the resident); launches "
              f"{row['launches']}; {desc}", flush=True)
        print(f"{label} trace: " + ", ".join(f"{n[:60]} {v:.4f}"
                                             for n, v in by[:8]))
        if cores:
            print(f"{label} local stages: " + "; ".join(cores))
        return row

    def cplanes(shape, dtype=torch.float32):
        xr, xi = planes(shape)
        return xr.to(dtype), xi.to(dtype)

    def ref_of(xr, xi, dims):
        return torch.fft.fftn(torch.complex(xr.double(), xi.double()),
                              dim=dims)

    def rel_to(ref):
        return lambda y: dev_rel(torch.complex(y[0].double(), y[1].double()),
                                 ref)

    tol64 = tolerance(CUBE[0] ** 3)
    xr, xi = cplanes(CUBE)
    ref = ref_of(xr, xi, (0, 1, 2))
    single = rt.make_plan(CUBE)
    one = lambda: single.execute_split(xr, xi)   # noqa: E731
    p = pdist.make_plan_shards(CUBE, norm=rt.Norm.NONE, device=ddev)
    dist_case("dist_shards_512cubed", p, lambda: p.execute_split(xr, xi),
              rel_to(ref), tol64, one, nbytes=16 * xr.numel())
    fwd = pdist.make_plan_slab(CUBE, norm=rt.Norm.NONE, device=ddev)
    dist_case("dist_slab_512cubed", fwd, lambda: fwd.execute_split(xr, xi),
              rel_to(ref), tol64, one, nbytes=16 * xr.numel())
    # one exchange of the slab's planes timed whole and its collective
    # alone (at P = 1 NCCL's all-to-all is a device-to-device copy, and
    # torch.profiler names it and the pack/unpack copies alike)
    ax0 = pdist._mesh_axis(fwd.mesh, fwd.mesh.mesh_dim_names[0])
    for dt, (er, ei) in ((torch.float32, (xr, xi)),
                         (torch.bfloat16, (xr.to(torch.bfloat16),
                                           xi.to(torch.bfloat16)))):
        ex_ms = timing.time_ms(lambda: pdist._a2a(er, ei, ax0, 2, 0), 10,
                               dev)
        sbuf = er.new_empty((1, 2) + CUBE)
        rbuf = torch.empty_like(sbuf)
        coll_ms = timing.time_ms(lambda: tdist.all_to_all_single(
            rbuf, sbuf, group=ax0.group), 10, dev)
        nb = 2 * sbuf.numel() * sbuf.element_size()
        print(f"exchange {str(dt)[6:]} 512^3 planes (P = 1): {ex_ms:.4f} ms ="
              f" all_to_all_single {coll_ms:.4f} + pack/unpack copies "
              f"{ex_ms - coll_ms:.4f}; bound of the three passes "
              f"{bound(3 * nb, 0)[0]:.4f} ms, of the collective "
              f"{bound(nb, 0)[0]:.4f}")
        dist_rows.append({"kind": "exchange", "dtype": str(dt)[6:],
                          "shape": list(CUBE), "ms": ex_ms,
                          "collective_ms": coll_ms,
                          "copies_ms": ex_ms - coll_ms,
                          "bound_ms": bound(3 * nb, 0)[0]})
        del sbuf, rbuf, er, ei
    inv = pdist.make_plan_slab(CUBE, direction=rt.Direction.BACKWARD,
                               device=ddev)
    dist_case("dist_slab_inverse_roundtrip", inv,
              lambda: inv.execute_split(*fwd.execute_split(xr, xi)),
              lambda y: dev_rel(torch.complex(*y), torch.complex(xr, xi)),
              tol64, nbytes=32 * xr.numel())
    t_out = pdist.make_plan_slab(CUBE, norm=rt.Norm.NONE,
                                 transposed_out=True, device=ddev)
    t_in = pdist.make_plan_slab(CUBE, direction=rt.Direction.BACKWARD,
                                transposed_in=True, device=ddev)
    yt = t_out.execute_split(xr, xi)
    err_t = rel_to(ref)(yt)
    del yt
    if not err_t <= tol64 or t_out.out_spec[-1] != "fft":
        raise AssertionError(f"transposed_out: {err_t} {t_out.out_spec}")
    dist_case("dist_slab_transposed_pair", t_in,
              lambda: t_in.execute_split(*t_out.execute_split(xr, xi)),
              lambda y: dev_rel(torch.complex(*y), torch.complex(xr, xi)),
              tol64, nbytes=32 * xr.numel())
    ch = pdist.make_plan_slab(CUBE, norm=rt.Norm.NONE, pipeline_chunks=4,
                              device=ddev)
    if "pipelined x4" not in ch.description:
        raise AssertionError(ch.description)
    dist_case("dist_slab_chunks4", ch, lambda: ch.execute_split(xr, xi),
              rel_to(ref), tol64, one, nbytes=16 * xr.numel())
    for label, kw in (("dist_pencil_1x1", {}),
                      ("dist_pencil_transposed_out",
                       dict(transposed_out=True))):
        pp = pdist.make_plan_pencil(CUBE, norm=rt.Norm.NONE, mesh_shape=(1, 1),
                                    device=ddev, **kw)
        dist_case(label, pp, lambda: pp.execute_split(xr, xi), rel_to(ref),
                  tol64, one, nbytes=16 * xr.numel())
    est = pdist.make_plan_distributed(CUBE, norm=rt.Norm.NONE, device=ddev)
    if est.strategy != {"mode": "slab", "pipeline_chunks": 1}:
        raise AssertionError(f"estimate strategy {est.strategy}")
    dist_case("dist_auto_estimate_512cubed", est,
              lambda: est.execute_split(xr, xi), rel_to(ref), tol64, one,
              nbytes=16 * xr.numel())
    # the strategy race: every candidate timed on every rank, the slowest
    # rank's time kept (here the one rank's)
    raced = pdist.make_plan_distributed(CUBE, norm=rt.Norm.NONE,
                                        planner="measure", device=ddev)
    key = pdist._distrib_key(CUBE, 1, rt.Direction.FORWARD, rt.Norm.NONE)
    winner = pdist._DISTRIB_WISDOM[key]
    race_t = raced.measurements["timings"]
    print("race distributed 512^3 c64 (P = 1): " + ", ".join(
        f"{k} {1e3 * v:.4f} ms" for k, v in race_t.items())
        + f"; winner {pdist.strategy_name(winner)}")
    if raced.strategy != winner or len(race_t) != 3 or not all(
            math.isfinite(v) for v in race_t.values()):
        raise AssertionError(f"raced plan {raced.strategy} != {winner}, "
                             f"{race_t}")
    groups["dist_auto_measure_512cubed"] = {
        "fft_fused2": 1, "fft_cols": winner.get("pipeline_chunks", 1)}
    dist_case("dist_auto_measure_512cubed", raced,
              lambda: raced.execute_split(xr, xi), rel_to(ref), tol64, one,
              nbytes=16 * xr.numel())
    wis = rt.export_wisdom_to_string()
    entries = json.loads(wis)["distrib"]
    rt.forget_wisdom()
    rt.import_wisdom_from_string(wis, build=False)
    again = pdist.make_plan_distributed(CUBE, norm=rt.Norm.NONE, device=ddev)
    print(f"distrib wisdom: {entries}; read back, the estimate plan takes "
          f"{pdist.strategy_name(again.strategy)}")
    if again.strategy != winner or len(entries) != 1:
        raise AssertionError(f"distrib wisdom {entries} -> {again.strategy}")
    del p, fwd, inv, t_out, t_in, ch, pp, est, raced, again, single, one
    # complex32: bf16 planes, and every exchange moves bf16
    br, bi = xr.to(torch.bfloat16), xi.to(torch.bfloat16)
    ref32 = ref_of(br, bi, (0, 1, 2))
    del ref, xr, xi
    c32 = pdist.make_plan_slab(CUBE, norm=rt.Norm.NONE, dtype="complex32",
                               device=ddev)
    a2a_dtypes = []
    a2a = tdist.all_to_all_single

    def spy(out, inp, *a, **k):
        a2a_dtypes.append(inp.dtype)
        return a2a(out, inp, *a, **k)
    tdist.all_to_all_single = spy
    try:
        y32 = c32.execute_split(br, bi)
    finally:
        tdist.all_to_all_single = a2a
    err32 = rel_to(ref32)(y32)
    print(f"complex32 slab exchanges: {[str(d) for d in a2a_dtypes]}; "
          f"output {y32[0].dtype}, rel_l2 {err32:.3e}")
    if (a2a_dtypes != [torch.bfloat16] * 2
            or y32[0].dtype != torch.bfloat16):
        raise AssertionError(f"complex32 exchange dtypes {a2a_dtypes}")
    del y32
    s32 = rt.make_plan(CUBE, dtype="complex32")
    dist_case("dist_slab_c32_512cubed", c32,
              lambda: c32.execute_split(br, bi), rel_to(ref32),
              tolerance(CUBE[0] ** 3, "complex32"),
              lambda: s32.execute_split(br, bi), nbytes=8 * br.numel())
    del c32, s32, br, bi, ref32
    torch.cuda.empty_cache()
    # howmany = 2 on 256^3, and complex128 256^3
    c256 = (256, 256, 256)
    hr, hi = cplanes((2,) + c256)
    href = ref_of(hr, hi, (1, 2, 3))
    hm = pdist.make_plan_slab(c256, norm=rt.Norm.NONE, howmany=2,
                              device=ddev)
    hs = rt.make_plan((2,) + c256, axes=(1, 2, 3))
    dist_case("dist_slab_howmany2_256cubed", hm,
              lambda: hm.execute_split(hr, hi), rel_to(href),
              tolerance(256 ** 3), lambda: hs.execute_split(hr, hi),
              nbytes=16 * hr.numel())
    del hm, hs, hr, hi, href
    dr_, di_ = cplanes(c256, torch.float64)
    dref = ref_of(dr_, di_, (0, 1, 2))
    d128 = pdist.make_plan_slab(c256, norm=rt.Norm.NONE, dtype="complex128",
                                device=ddev)
    ds = rt.make_plan(c256, dtype="complex128")
    dist_case("dist_slab_c128_256cubed", d128,
              lambda: d128.execute_split(dr_, di_), rel_to(dref),
              tolerance(256 ** 3, "complex128"),
              lambda: ds.execute_split(dr_, di_), nbytes=32 * dr_.numel())
    del d128, ds, dr_, di_, dref
    # the rank-1 plan: n = 2^22 = 2048 x 2048, natural and scrambled
    n1 = 1 << 22
    vr, vi = cplanes((n1,))
    vref = torch.fft.fft(torch.complex(vr.double(), vi.double()))
    vs = rt.make_plan((n1,))
    for label, kw, want in (
            ("dist_slab1d_2p22", {}, vref),
            ("dist_slab1d_2p22_scrambled", dict(scrambled_out=True),
             vref.reshape(2048, 2048).transpose(0, 1).reshape(-1))):
        p1 = pdist.make_plan_slab_1d(n1, norm=rt.Norm.NONE, device=ddev,
                                     **kw)
        if "2048x2048" not in p1.description:
            raise AssertionError(p1.description)
        dist_case(label, p1, lambda: p1.execute_split(vr, vi), rel_to(want),
                  tolerance(n1), lambda: vs.execute_split(vr, vi),
                  nbytes=16 * n1)
    del p1, vs, vr, vi, vref, want
    # the transposes: exact
    from regent_fft_tpu_torch.parallel import transpose as ptrans
    tx = torch.complex(*planes((8192, 8192)))
    tp = ptrans.make_plan_transpose(8192, 8192, device=ddev)
    dist_case("dist_transpose_8192sq", tp, lambda: (tp(tx),),
              lambda y: 0.0 if torch.equal(y[0], tx.transpose(0, 1)) else 1.0,
              0.0, lambda: tx.transpose(0, 1).contiguous(),
              nbytes=2 * 16 * tx.numel())
    del tx
    mx = randn((4096, 4096, 2))
    mp_ = ptrans.make_plan_many_transpose(4096, 4096, 2, device=ddev)
    dist_case("dist_many_transpose_4096sq_x2", mp_, lambda: (mp_(mx),),
              lambda y: 0.0 if torch.equal(y[0], mx.transpose(0, 1)) else 1.0,
              0.0, lambda: mx.transpose(0, 1).contiguous(),
              nbytes=2 * 4 * mx.numel())
    del mx, tp, mp_
    torch.cuda.empty_cache()
    # the slab at 1024^3, the size a 4-card slab is planned at: once,
    # held against the single-device plan slab by slab in float64
    big = (1024, 1024, 1024)
    gr, gi = cplanes(big)
    gp = pdist.make_plan_slab(big, norm=rt.Norm.NONE, device=ddev)
    gs = rt.make_plan(big)

    def against_single(y):
        sr, si = gs.execute_split(gr, gi)
        num = den = 0.0
        for a in range(0, big[0], 64):
            dr = y[0][a:a + 64].double() - sr[a:a + 64].double()
            di = y[1][a:a + 64].double() - si[a:a + 64].double()
            num += float((dr * dr + di * di).sum())
            den += float((sr[a:a + 64].double() ** 2
                          + si[a:a + 64].double() ** 2).sum())
        return math.sqrt(num / den)
    dist_case("dist_slab_1024cubed", gp, lambda: gp.execute_split(gr, gi),
              against_single, tolerance(1024 ** 3),
              lambda: gs.execute_split(gr, gi), reps=3,
              nbytes=16 * gr.numel())
    del gp, gs, gr, gi
    torch.cuda.empty_cache()
    check_held("phase 15")
    print(json.dumps({"distributed": dist_rows}))
    print(f"phase 15 took {time.perf_counter() - t15:.1f} s")
    phase("15 (distributed plans, one-rank NCCL group)")

    # 16. the real distributed plans (parallel/ part 2) in the same
    # one-rank NCCL group: the slab and pencil R2C/C2R plans (packed at
    # 512^3 and 1024^3, unpacked at a last axis of 2048), the rank-1 real
    # plans at n = 2^23, the distributed r2r plan and the real kinds of
    # the strategy layer, each counted once at full width, held against a
    # float64 torch.fft oracle on the card, timed beside the single-device
    # plan of the same spec, traced, with its peak memory.
    from regent_fft_tpu_torch.parallel import distributed_r2r as pr2r
    t16 = time.perf_counter()
    rt.cleanup()
    groups.update(DIST_REAL_GROUPS)
    n15 = len(dist_rows)
    half_cube = CUBE[:2] + (CUBE[2] // 2 + 1,)

    def rel_real(ref):
        return lambda y: dev_rel(y.double(), ref)

    def real_bytes(shape):
        """A real transform's ideal bytes: the real side read or written
        once (4 B an element), the half spectrum once (8 B a bin)."""
        h = shape[:-1] + (shape[-1] // 2 + 1,)
        return 4 * math.prod(shape) + 8 * math.prod(h)

    xr3 = randn(CUBE)
    rref = torch.fft.rfftn(xr3.double())
    s_r2c = rt.make_plan(CUBE, kind=rt.Kind.R2C)
    one_r2c = lambda: s_r2c.execute_real(xr3)    # noqa: E731
    for label, kw in (("dist_slab_r2c_512cubed", {}),
                      ("dist_slab_r2c_512cubed_transposed_out",
                       dict(transposed_out=True))):
        rp = pdist.make_plan_slab_r2c(CUBE, norm=rt.Norm.NONE, device=ddev,
                                      **kw)
        if rp.out_spec[1 if kw else 0] != "fft":
            raise AssertionError(f"{label}: out_spec {rp.out_spec}")
        dist_case(label, rp, lambda: rp.execute_real(xr3), rel_to(rref),
                  tol64, one_r2c, nbytes=real_bytes(CUBE))
    # C2R on a random non-Hermitian spectrum against irfftn in float64
    hr3, hi3 = randn(half_cube), randn(half_cube)
    cref = torch.fft.irfftn(torch.complex(hr3.double(), hi3.double()),
                            s=CUBE)
    cp = pdist.make_plan_slab_c2r(CUBE, device=ddev)
    if "nyquist-packed" not in cp.description:
        raise AssertionError(cp.description)
    s_c2r = rt.make_plan(CUBE, kind=rt.Kind.C2R,
                         direction=rt.Direction.BACKWARD)
    dist_case("dist_slab_c2r_512cubed", cp, lambda: cp.execute_split(hr3, hi3),
              rel_real(cref), tol64, lambda: s_c2r.execute_split(hr3, hi3),
              nbytes=real_bytes(CUBE))
    del hr3, hi3, cref
    t_o = pdist.make_plan_slab_r2c(CUBE, norm=rt.Norm.NONE,
                                   transposed_out=True, device=ddev)
    t_i = pdist.make_plan_slab_c2r(CUBE, transposed_in=True, device=ddev)
    dist_case("dist_slab_r2c_c2r_transposed_pair", t_i,
              lambda: t_i.execute_split(*t_o.execute_real(xr3)),
              rel_real(xr3.double()), tol64, nbytes=2 * real_bytes(CUBE))
    for label, ctor, fn_of, check in (
            ("dist_pencil_r2c_1x1", pdist.make_plan_pencil_r2c,
             lambda p: lambda: p.execute_real(xr3), rel_to(rref)),
            ("dist_pencil_r2c_c2r_1x1", pdist.make_plan_pencil_c2r,
             lambda p: lambda: p.execute_split(*pr_fwd.execute_real(xr3)),
             rel_real(xr3.double()))):
        pp = ctor(CUBE, norm=(rt.Norm.NONE if ctor is pdist.make_plan_pencil_r2c
                              else rt.Norm.BACKWARD),
                  mesh_shape=(1, 1), device=ddev)
        if ctor is pdist.make_plan_pencil_r2c:
            pr_fwd = pp
            if pp.out_spec[0] != ("fy", "fz"):
                raise AssertionError(f"{label}: out_spec {pp.out_spec}")
        dist_case(label, pp, fn_of(pp), check, tol64,
                  one_r2c if ctor is pdist.make_plan_pencil_r2c else None,
                  nbytes=real_bytes(CUBE) * (1 if ctor is
                                             pdist.make_plan_pencil_r2c
                                             else 2))
    est = pdist.make_plan_distributed(CUBE, norm=rt.Norm.NONE,
                                      kind=rt.Kind.R2C, device=ddev)
    if est.strategy != {"mode": "slab", "pipeline_chunks": 1}:
        raise AssertionError(f"R2C estimate strategy {est.strategy}")
    dist_case("dist_auto_r2c_estimate_512cubed", est,
              lambda: est.execute_real(xr3), rel_to(rref), tol64, one_r2c,
              nbytes=real_bytes(CUBE))
    raced = pdist.make_plan_distributed(CUBE, norm=rt.Norm.NONE,
                                        kind=rt.Kind.R2C, planner="measure",
                                        device=ddev)
    rkey = pdist._distrib_key(CUBE, 1, rt.Direction.FORWARD, rt.Norm.NONE,
                              rt.Kind.R2C)
    race_t = raced.measurements["timings"]
    print("race distributed R2C 512^3 (P = 1): " + ", ".join(
        f"{k} {1e3 * v:.4f} ms" for k, v in race_t.items())
        + f"; winner {pdist.strategy_name(pdist._DISTRIB_WISDOM[rkey])}")
    if (raced.strategy != pdist._DISTRIB_WISDOM[rkey]
            or list(race_t) != ["slab/c1"]
            or not all(math.isfinite(v) for v in race_t.values())):
        raise AssertionError(f"R2C race {raced.strategy} {race_t}")
    dist_case("dist_auto_r2c_measure_512cubed", raced,
              lambda: raced.execute_real(xr3), rel_to(rref), tol64, one_r2c,
              nbytes=real_bytes(CUBE))
    entries = [e for e in json.loads(rt.export_wisdom_to_string())["distrib"]
               if e["kind"] == "r2c"]
    if len(entries) != 1 or entries[0]["strategy"] != raced.strategy:
        raise AssertionError(f"R2C distrib wisdom {entries}")
    del rp, cp, s_c2r, t_o, t_i, pp, pr_fwd, est, raced, rref
    # the distributed r2r plan: DCT-II 512^3, each exchange one real plane
    r2r_k = rt.R2RKind.REDFT10

    def dct2_f64(x):
        """FFTW's REDFT10 of every axis in float64 on the card (Makhoul's
        reorder and one torch.fft.fft an axis)."""
        y = x.double()
        for d in range(y.ndim):
            v = y.movedim(d, -1)
            n = v.shape[-1]
            v = torch.cat([v[..., 0::2], v[..., 1::2].flip(-1)], -1)
            k = torch.arange(n, device=v.device, dtype=torch.float64)
            w = torch.polar(torch.ones_like(k), -math.pi * k / (2 * n))
            y = (2 * (torch.fft.fft(v) * w).real).movedim(-1, d)
        return y
    dref = dct2_f64(xr3)
    s_dct = rt.plan_r2r(CUBE, r2r_k)
    for label, kw in (("dist_r2r_dct2_512cubed", {}),
                      ("dist_r2r_dct2_512cubed_transposed_out",
                       dict(transposed_out=True))):
        dp = pr2r.make_plan_slab_r2r(CUBE, r2r_k, device=ddev, **kw)
        a2a_bufs = []
        spy_a2a = tdist.all_to_all_single

        def spy_r2r(out, inp, *a, **k):
            a2a_bufs.append(tuple(inp.shape))
            return spy_a2a(out, inp, *a, **k)
        tdist.all_to_all_single = spy_r2r
        try:
            dp.execute_real(xr3)
        finally:
            tdist.all_to_all_single = spy_a2a
        if any(b[1] != 1 for b in a2a_bufs) or len(a2a_bufs) != (
                1 if kw else 2):
            raise AssertionError(f"{label}: exchange buffers {a2a_bufs}")
        dist_case(label, dp, lambda: dp.execute_real(xr3), rel_real(dref),
                  tolerance(CUBE[0]), lambda: s_dct(xr3),
                  nbytes=8 * xr3.numel())
    inv_k = pr2r.make_plan_slab_r2r(CUBE, rt.R2RKind.REDFT01, device=ddev)
    fwd_k = pr2r.make_plan_slab_r2r(CUBE, r2r_k, device=ddev)
    scale_k = float(math.prod(2 * s for s in CUBE))
    dist_case("dist_r2r_dct2_dct3_roundtrip", inv_k,
              lambda: inv_k.execute_real(fwd_k.execute_real(xr3)),
              lambda y: dev_rel(y.double() / scale_k, xr3.double()),
              tolerance(CUBE[0]), nbytes=16 * xr3.numel())
    del dp, inv_k, fwd_k, s_dct, dref, s_r2c, one_r2c
    # the unpacked route: a last axis of 2048 (above MAX_REAL_N) takes the
    # local R2C core (the half-length reduction on fft_last at 1024)
    ushape = (512, 512, 2048)
    xu = randn(ushape)
    up = pdist.make_plan_slab_r2c(ushape, norm=rt.Norm.NONE, device=ddev)
    uref = torch.fft.rfftn(xu.double())
    su = rt.make_plan(ushape, kind=rt.Kind.R2C)
    dist_case("dist_slab_r2c_unpacked_512x512x2048", up,
              lambda: up.execute_real(xu), rel_to(uref),
              tolerance(math.prod(ushape)), lambda: su.execute_real(xu),
              nbytes=real_bytes(ushape))
    del up, uref, su, xu, xr3
    torch.cuda.empty_cache()
    # the rank-1 real plans at n = 2^23 (m = 2^22 = 2048 x 2048)
    n23 = 1 << 23
    x23 = randn((n23,))
    f23 = torch.fft.rfft(x23.double())

    def unpack_dev(y):
        """The packed (m,) halfcomplex planes -> numpy's (m+1,) bins."""
        yr, yi = y[0].double(), y[1].double()
        re = torch.cat([yr, yi[:1]])
        im = torch.cat([yi.new_zeros(1), yi[1:], yi.new_zeros(1)])
        return torch.complex(re, im)
    r1 = pdist.make_plan_slab_1d(n23, kind=rt.Kind.R2C, norm=rt.Norm.NONE,
                                 device=ddev)
    if "2048x2048" not in r1.description or not r1.packed_layout:
        raise AssertionError(r1.description)
    s23 = rt.make_plan((n23,), kind=rt.Kind.R2C)
    dist_case("dist_slab1d_r2c_2p23", r1, lambda: r1.execute_real(x23),
              lambda y: dev_rel(unpack_dev(y), f23), tolerance(n23),
              lambda: s23.execute_real(x23), nbytes=8 * n23)
    pr23 = f23[:-1].to(torch.complex64)
    hr23, hi23 = pr23.real.contiguous(), pr23.imag.clone()
    hi23[0] = f23[-1].real.float()
    c1 = pdist.make_plan_slab_1d(n23, kind=rt.Kind.C2R, device=ddev)
    dist_case("dist_slab1d_c2r_2p23", c1,
              lambda: c1.execute_split(hr23, hi23), rel_real(x23.double()),
              tolerance(n23), nbytes=8 * n23)
    del r1, c1, s23, x23, f23, pr23, hr23, hi23
    torch.cuda.empty_cache()
    # the R2C slab at 1024^3, what a four-card slab would plan: held
    # against rfftn in float64 slab by slab
    big_r = (1024, 1024, 1024)
    xg = randn(big_r)
    gp = pdist.make_plan_slab_r2c(big_r, norm=rt.Norm.NONE, device=ddev)
    gs = rt.make_plan(big_r, kind=rt.Kind.R2C)

    def against_rfftn(y):
        ref = torch.fft.rfftn(xg.double())
        num = den = 0.0
        for a in range(0, big_r[0], 64):
            dr = y[0][a:a + 64].double() - ref[a:a + 64].real
            di = y[1][a:a + 64].double() - ref[a:a + 64].imag
            num += float((dr * dr + di * di).sum())
            den += float((ref[a:a + 64].abs() ** 2).sum())
        del ref
        return math.sqrt(num / den)
    dist_case("dist_slab_r2c_1024cubed", gp, lambda: gp.execute_real(xg),
              against_rfftn, tolerance(math.prod(big_r)),
              lambda: gs.execute_real(xg), reps=3, nbytes=real_bytes(big_r))
    del gp, gs, xg
    torch.cuda.empty_cache()
    check_held("phase 16")
    tdist.destroy_process_group()
    print(json.dumps({"distributed_real": dist_rows[n15:]}))
    print(f"phase 16 took {time.perf_counter() - t16:.1f} s")
    phase("16 (real distributed plans, r2r, one-rank NCCL group)")

    # 17. the JAX plan's user switches (plan.Switches), read as a plan is
    # made: each variable set for its group only, the plan cache cleared
    # around it; every group counted
    t17 = time.perf_counter()
    switch_rows = []

    @contextlib.contextmanager
    def switched(var, value):
        old = os.environ.pop(var, None)
        if value is not None:
            os.environ[var] = value
        rt.clear_plan_cache()
        try:
            yield
        finally:
            os.environ.pop(var, None)
            if old is not None:
                os.environ[var] = old
            rt.clear_plan_cache()

    def switch_group(label, fn, want):
        (y,), launches = run_counted(label, [lambda _: fn()], [None], want)
        for kname, row in rows.items():
            row["launches_by_path"][label] = launches[kname]
            row["launches"] += launches[kname]
        return y

    def step_lines(p):
        return [ln.strip() for ln in p.describe().splitlines()[1:-1]]

    # the complex32 plans under each REGENT_FFT_MXU_IMPL: the same launches
    # and the same output under every value; each bf16 kernel held against
    # its plain runner on the body tile_impl names, at the plan's planes
    g = torch.Generator(device=dev).manual_seed(17)
    mxu_in = {label: tuple(torch.randn(shape, device=dev, generator=g)
                           .to(torch.bfloat16) for _ in range(2))
              for label, shape, _, _ in MXU_PLANS}
    first_out = {}
    for impl in MXU_IMPLS:
        with switched("REGENT_FFT_MXU_IMPL", impl):
            for label, shape, axes, want in MXU_PLANS:
                xr, xi = mxu_in[label]
                x = rt.SplitComplex(xr, xi)
                p = rt.make_plan(shape, axes=axes, dtype="complex32")
                if p.switches.mxu_impl != (impl or "direct"):
                    raise AssertionError(f"mxu {impl}: {p.switches}")
                tag = f"mxu_{impl or 'unset'}_{label}"
                y = switch_group(tag, lambda: p(x), want)
                n = p.spec.logical_n
                err = dev_rel(cplx(y.re, y.im),
                              torch.fft.fftn(cplx(xr, xi), dim=axes))
                same = first_out.setdefault(label, (y.re, y.im))
                if not (err <= tolerance(n, "complex32")
                        and torch.equal(y.re, same[0])
                        and torch.equal(y.im, same[1])):
                    raise AssertionError(f"{tag}: rel_l2 {err} (tolerance "
                                         f"{tolerance(n, 'complex32')}), "
                                         f"output differs from "
                                         f"{MXU_IMPLS[0]}'s")
                del y
                switch_rows.append({
                    "group": tag, "mxu_impl": impl, "shape": list(shape),
                    "steps": step_lines(p), "launches": want,
                    "rel_err_vs_torch_fft_f64": err,
                    "tolerance": tolerance(n, "complex32"),
                    "ms": timed(lambda: p(x))})
            held = []
            for kname, planes_, fn, plain in (
                    ("fft_fused2_bf16", mxu_in["cube"], sk.fft_fused2,
                     sk.fft_fused2_plain),
                    ("fft_cols_bf16", tuple(t.reshape(1, 512, 512 * 512)
                                            for t in mxu_in["cube"]),
                     sk.fft_cols, sk.fft_cols_plain),
                    ("fft_last_bf16", mxu_in["rows"], sk.fft_last,
                     sk.fft_last_plain)):
                xr, xi = planes_
                n = xr.shape[-2 if kname == "fft_cols_bf16" else -1]
                body = sk.tile_impl("bf16", n)
                worst = 0.0
                for sign in (-1, 1):
                    k = fn(xr, xi, sign, 1.0 / n)
                    q = plain(xr, xi, sign, 1.0 / n)
                    rel = dev_rel(cplx(*k), cplx(*q))
                    worst = max(worst, rel)
                    del k, q
                if not worst <= PLAIN_LIMIT[kname]:
                    raise AssertionError(f"{kname} under {impl}: rel_l2 vs "
                                         f"{body} plain {worst}")
                held.append({"kernel": kname, "planes": list(xr.shape),
                             "body": body, "rel_err_vs_plain": worst,
                             "ms": timed(lambda: fn(xr, xi, -1, 1.0)),
                             "plain_ms": timed(lambda: plain(xr, xi, -1,
                                                             1.0))})
                torch.cuda.empty_cache()
            switch_rows.append({"group": f"mxu_{impl or 'unset'}_held",
                                "mxu_impl": impl, "held": held})
            print(f"REGENT_FFT_MXU_IMPL={impl}: " + "; ".join(
                f"{h['kernel']} {tuple(h['planes'])} vs {h['body']} plain "
                f"{h['rel_err_vs_plain']:.3e} ({h['ms']:.4f} ms, plain "
                f"{h['plain_ms']:.4f})" for h in held) + "; plans " + ", ".join(
                f"{r['group']} {r['ms']:.4f} ms" for r in switch_rows[-3:-1]),
                flush=True)
    del mxu_in, first_out

    # the c64 512^3 plan under each route switch
    g = torch.Generator(device=dev).manual_seed(171)
    x = torch.complex(torch.randn(CUBE, device=dev, generator=g),
                      torch.randn(CUBE, device=dev, generator=g))
    ref = torch.fft.fftn(x)
    for var, value, want_steps, want in ROUTE_SWITCHES:
        with switched(var, value):
            p = rt.make_plan(CUBE, axes=(0, 1, 2))
            tag = f"{var[len('REGENT_FFT_'):].lower()}_{value}"
            if step_lines(p) != want_steps:
                raise AssertionError(f"{tag} steps: {step_lines(p)}")
            y = switch_group(tag, lambda: p(x), want)
            err = dev_rel(y, ref)
            del y
            if not err <= tolerance(math.prod(CUBE)):
                raise AssertionError(f"{tag}: rel_l2 {err}")
            switch_rows.append({
                "group": tag, "shape": list(CUBE), "steps": step_lines(p),
                "launches": want, "rel_err_vs_torch_fft": err,
                "tolerance": tolerance(math.prod(CUBE)),
                "ms": timed(lambda: p(x))})
            print(f"{var}={value}: {step_lines(p)} {want} rel_l2 {err:.3e}, "
                  f"{switch_rows[-1]['ms']:.4f} ms", flush=True)
    del x, ref
    torch.cuda.empty_cache()

    # a 1-D R2C under REGENT_FFT_R2C_1D=half: the half-length route on
    # fft_last, beside the default route's row-pair kernel
    g = torch.Generator(device=dev).manual_seed(172)
    xr_ = torch.randn((4096, 1024), device=dev, generator=g)
    ref = torch.fft.rfft(xr_)
    base = rt.make_plan((4096, 1024), axes=(1,), kind=rt.Kind.R2C,
                        direction=rt.FORWARD)
    with switched("REGENT_FFT_R2C_1D", "half"):
        p = rt.make_plan((4096, 1024), axes=(1,), kind=rt.Kind.R2C,
                         direction=rt.FORWARD)
        want_steps = ["(real axis 1: n=1024 half-length conjugate-even "
                      "kernel r2c)"]
        if step_lines(p) != want_steps:
            raise AssertionError(f"r2c half steps: {step_lines(p)}")
        y = switch_group("r2c_1d_half", lambda: p(xr_), {"fft_last": 1})
        err = dev_rel(y, ref)
        if not err <= tolerance(1024):
            raise AssertionError(f"r2c half: rel_l2 {err}")
        switch_rows.append({
            "group": "r2c_1d_half", "shape": [4096, 1024],
            "steps": step_lines(p), "launches": {"fft_last": 1},
            "rel_err_vs_torch_fft": err, "tolerance": tolerance(1024),
            "ms": timed(lambda: p(xr_)),
            "row_pair_route_ms": timed(lambda: base(xr_))})
    print(f"REGENT_FFT_R2C_1D=half: {switch_rows[-1]}", flush=True)
    del xr_, ref, y

    # the lane-padded real layout: the padded round trip equals the narrow
    # one, zeros above n/2; the kernels held against their plain versions
    # at these planes; the padding copy priced as padded minus narrow ms
    for shape in PADDED_SHAPES:
        n = shape[-1]
        h = n // 2 + 1
        xr_ = randn(shape)
        tag = "padded_" + "x".join(map(str, shape))
        yr, yi = switch_group(
            tag, lambda: sk.fft_last_r2c_stockham(xr_, padded=True),
            {"fft_last_r2c": 1})
        back = switch_group(
            tag + "_c2r",
            lambda: sk.ifft_last_c2r_stockham(yr, yi, n, scale=1.0 / n),
            {"ifft_last_c2r": 1})
        nr, ni = sk.fft_last_r2c_stockham(xr_)
        nback = sk.ifft_last_c2r_stockham(nr, ni, n, scale=1.0 / n)
        if (tuple(yr.shape) != shape or yr[..., h:].any() or yi[..., h:].any()
                or not torch.equal(yr[..., :h], nr)
                or not torch.equal(yi[..., :h], ni)
                or not torch.equal(back, nback)):
            raise AssertionError(f"{tag}: padded layout differs from narrow")
        rows2 = xr_.reshape(-1, n)
        e_r2c = dev_rel(torch.complex(nr, ni).reshape(-1, h), torch.complex(
            *sk.fft_last_r2c_plain(rows2)))
        e_c2r = dev_rel(nback.reshape(-1, n), sk.ifft_last_c2r_plain(
            nr.reshape(-1, h), ni.reshape(-1, h), n, False, 1.0 / n))
        e_ref = dev_rel(torch.complex(nr, ni), torch.fft.rfft(xr_))
        e_back = dev_rel(back, xr_)
        if not max(e_r2c, e_c2r, e_ref, e_back) <= tolerance(n):
            raise AssertionError(f"{tag}: vs plain {e_r2c} {e_c2r}, vs "
                                 f"rfft {e_ref}, round trip {e_back}")
        switch_rows.append({
            "group": tag, "shape": list(shape), "r2c_vs_plain": e_r2c,
            "c2r_vs_plain": e_c2r, "rel_err_vs_torch_fft": e_ref,
            "roundtrip_err": e_back, "tolerance": tolerance(n),
            "r2c_padded_ms": timed(
                lambda: sk.fft_last_r2c_stockham(xr_, padded=True)),
            "r2c_narrow_ms": timed(lambda: sk.fft_last_r2c_stockham(xr_)),
            "c2r_padded_ms": timed(
                lambda: sk.ifft_last_c2r_stockham(yr, yi, n)),
            "c2r_narrow_ms": timed(
                lambda: sk.ifft_last_c2r_stockham(nr, ni, n))})
        print(f"{tag}: {switch_rows[-1]}", flush=True)
        del xr_, yr, yi, back, nr, ni, nback, rows2
        torch.cuda.empty_cache()

    # the plan log in a child process under REGENT_FFT_LOG=2
    code = ("import regent_fft_tpu_torch as rt\n"
            "rt.make_plan((512, 512, 512))\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       env=dict(os.environ, REGENT_FFT_LOG="2"),
                       capture_output=True, text=True, timeout=300)
    want_log = ["[regent_fft_tpu_torch INFO] make_plan: Plan(c2c, "
                "shape=(512, 512, 512)", "[regent_fft_tpu_torch DEBUG] "
                "schedule:", "(axis 1: kernel-fused2(512, 512))"]
    if r.returncode or not all(w in r.stderr for w in want_log):
        raise AssertionError(f"REGENT_FFT_LOG=2 child: rc {r.returncode}, "
                             f"stderr {r.stderr[-3000:]}")
    print(f"REGENT_FFT_LOG=2 child ({time.perf_counter() - t0:.2f} s): "
          + " | ".join(ln for ln in r.stderr.splitlines()
                       if "regent_fft_tpu_torch" in ln))
    print(json.dumps({"switches": switch_rows}))
    print(f"phase 17 took {time.perf_counter() - t17:.1f} s")
    phase("17 (the JAX plan's user switches)")

    # 18. complex128 on the f64 instances: plans through the adapters and
    # one real plan, each counted and held within tolerance(n,
    # "complex128"); NPB FT class C through the port against the plain
    # torch.fft iteration of fftbench/npb_ft.py (20 checksums within 1e-12
    # relative).  The kernels themselves are held in phase 3b and the
    # complex128 slab in phase 15.
    t18 = time.perf_counter()
    rt.clear_plan_cache()

    def f64_group(label, call, ref, n_logical, want):
        before = kernel_launches()
        y = call()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in kernel_launches().items()
               if v != before[k]}
        tol = tolerance(n_logical, "complex128")
        err = dev_rel(torch.as_tensor(y, device=dev), ref)
        print(f"{label}: launches {got}, rel_l2 vs torch.fft float64 "
              f"{err:.3e} (tolerance {tol:.3e}); {timed(call):.4f} ms")
        if got != want or not err <= tol:
            raise AssertionError(f"{label}: launches {got} (want {want}), "
                                 f"rel_l2 {err}")
        for k, v in got.items():
            rows[k]["launches_by_path"][label] = v
            rows[k]["launches"] += v

    x3 = torch.complex(*(t.double() for t in planes((256, 256, 256))))
    f64_group("torch_fft_fftn_c128", lambda: tf.fftn(x3),
              torch.fft.fftn(x3), 256 ** 3,
              {"fft_last_f64": 1, "fft_cols_f64": 2})
    del x3
    h2 = torch.complex(*(t.double() for t in planes((64, 1024)))).cpu()
    f64_group("scipy_fft_fftn_f64",
              via_backend(lambda: sfft.fftn(h2.numpy())),
              torch.fft.fftn(h2.to(dev)), 64 * 1024,
              {"fft_last_f64": 1, "fft_cols_f64": 1})
    del h2
    xr3 = randn((64, 256, 256)).double()
    r128 = rt.make_plan((64, 256, 256), kind=rt.Kind.R2C, dtype="complex128")
    print(r128.describe())
    f64_group("r2c_c128_64x256x256", lambda: torch.complex(
                  *r128.execute_real(xr3)), torch.fft.rfftn(xr3),
              64 * 256 * 256, {"fft_cols_f64": 2})
    del xr3, r128
    torch.cuda.empty_cache()
    r = subprocess.run([sys.executable, "examples/npb_ft.py", "--class", "C",
                        "--check"], capture_output=True, text=True,
                       timeout=900)
    if r.returncode:
        raise AssertionError(f"examples/npb_ft.py: rc {r.returncode}, "
                             f"{r.stderr[-3000:]}")
    npb = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"NPB FT class C through the port: {npb['iters']} checksums, "
          f"largest relative difference from fftbench/npb_ft.py "
          f"{npb['checksum_rel_max']:.3e}, last field rel_l2 "
          f"{npb['rel_l2']:.3e}, max_gap {npb['max_gap']:.3e}; port "
          f"{npb['port_s']:.3f} s, torch.fft {npb['reference_s']:.3f} s")
    if not npb["checksum_rel_max"] <= 1e-12:
        raise AssertionError(f"NPB FT class C checksums: {npb}")
    print(f"phase 18 took {time.perf_counter() - t18:.1f} s")
    phase("18 (complex128 on the f64 instances)")
    idle = [k for k, row in rows.items() if row["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels no main-path run launched: {idle}")

    print(json.dumps({"plans": plan_rows}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
