"""admission: the share of the rows a prefill dispatch computes that are
real prompt tokens, over the window's dispatches: the engine's own count
of real rows (``stats["prefill_rows"]``) over the padded (B, S) of each
dispatch, which the benchmark records."""
from benchkit.readers import in_window


def read(run):
    rows = sum(d.B * d.S for d in in_window(run, run.rec.dispatches))
    real = run.stats1["prefill_rows"] - run.stats0["prefill_rows"]
    return 100.0 * real / rows if rows else None
