"""admission: the median wait, over every request due in the window, from
its due time to the start of the admission call that placed it in a slot
(a request still queued when the window closes counts its wait so far).
The benchmark's own stamps, on the host's clock."""
from benchkit.readers import percentile_ms
from benchkit.loops.open_loop import rejected


def read(run):
    we = run.window[1]
    waits = [((r.t_placed if r.t_placed is not None and r.t_placed <= we
               else we) - r.t_due) for r in run.due if not rejected(r)]
    return percentile_ms(waits, 50)
