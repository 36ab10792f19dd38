"""kernels: the paged attention kernel's share of its roofline over the
traced iterations: the sum over its launches (one a layer a dispatch or
step) of the least time each needs (live [ckv | kr] rows read once, q, q2
and the output of real rows; FLOPs of real (query, key) pairs), over the
profiler's device time of every ``paged_*`` kernel."""
from benchkit.profiling import roofline_share
from benchkit.readers import bound_s, traced


def read(run):
    if run.trace is None:
        return None
    c = run.counts
    bound = 0.0
    for d in traced(run.rec.dispatches):
        fb = c.paged_attention_launch(sum(d.lengths), sum(d.lengths),
                                      sum(n * (n + 1) // 2
                                          for n in d.lengths))
        if fb is None:
            return None
        bound += c.layers() * bound_s(run, *fb)
    for s in traced(run.rec.steps):
        fb = c.paged_attention_launch(len(s.keys), sum(s.keys), sum(s.keys))
        if fb is None:
            return None
        bound += c.layers() * bound_s(run, *fb)
    return roofline_share(bound, run.trace.kernel_s(r"paged_\w*kernel"))
