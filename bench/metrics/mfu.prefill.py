"""model step: the model FLOPs of the real prompt tokens of the window's
prefill dispatches over the host wall of those dispatches and the card's
bf16 peak."""
from benchkit.readers import in_window, share_of_peak, step_flops


def read(run):
    ds = in_window(run, run.rec.dispatches)
    return share_of_peak(run, step_flops(run, ds, []),
                         sum(d.t1 - d.t0 for d in ds))
