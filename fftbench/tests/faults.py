"""Faults planted under the timed path, for the tests that show the
check fails: each patches the port in the process it runs in (a spawned
rank calls it by name before planning)."""
import torch


def skip_exchange():
    """The exchange between cards left out: every all-to-all keeps its
    own send buffer."""
    import torch.distributed as dist

    class _Done:
        def wait(self):
            return True

    def local(out, buf, *args, **kwargs):
        out.copy_(buf)
        return _Done()
    dist.all_to_all_single = local


def _wrap_steps(change):
    from regent_fft_tpu_torch import plan
    original = plan.run_steps

    def run_steps(steps, xr, xi, *args, **kwargs):
        yr, yi = original(steps, xr, xi, *args, **kwargs)
        return change(xr, xi, yr, yi)
    return run_steps


def unchanged(xr, xi, yr, yi):
    """A step that returns its state unchanged."""
    return xr, xi


def half_batch(xr, xi, yr, yi):
    """Half of axis 0 left as it came in."""
    h = xr.shape[0] // 2
    yr, yi = yr.clone(), yi.clone()
    yr[h:], yi[h:] = xr[h:], xi[h:]
    return yr, yi


def altered(xr, xi, yr, yi):
    """One answer altered where it is produced: an element negated."""
    yr = yr.clone()
    flat = yr.view(-1)
    k = int(torch.argmax(flat.abs()))
    flat[k] = -flat[k]
    return yr, yi


STEP_FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
               "altered": altered}
