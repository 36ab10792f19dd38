"""engine: the mean host wall of an admission that dispatched a prefill,
over the window (the call returns once the first tokens are read)."""
from benchkit.readers import in_window, wall_ms


def read(run):
    return wall_ms(in_window(run, run.rec.dispatches))
