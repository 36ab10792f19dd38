"""kernels: the SSD scan kernel's share of its roofline over the traced
prefill dispatches: the sum over its launches (one a layer a dispatch) of
the least time each needs over the real prompt rows (x, dt, B, C read
once; y and the final state written once), over the profiler's device time
of every ``ssd_scan_*`` kernel."""
from benchkit.profiling import roofline_share
from benchkit.readers import bound_s, traced


def read(run):
    if run.trace is None:
        return None
    c = run.counts
    bound = 0.0
    for d in traced(run.rec.dispatches):
        fb = c.ssd_launch(d.lengths)
        if fb is None:
            return None
        bound += c.layers() * bound_s(run, *fb)
    return roofline_share(bound, run.trace.kernel_s(r"ssd_scan_\w*kernel"))
