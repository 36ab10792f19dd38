"""model step: the model FLOPs of the window's decode steps (one token a
live slot, attention over its live keys) over the host wall of those
steps and the card's bf16 peak."""
from benchkit.readers import in_window, share_of_peak, step_flops


def read(run):
    st = in_window(run, run.rec.steps)
    return share_of_peak(run, step_flops(run, [], st),
                         sum(s.t1 - s.t0 for s in st))
