"""admission: the share of the rows a prefill dispatch computes that are
real prompt tokens, over the window's dispatches: the ``rows`` of each
``serve.prefill`` span the program recorded over the window (a
``--trace 1`` run) over its padded ``B`` x ``S``. A span missing against
the engine's own count of the window's dispatches raises, so the reading
never rests on part of the window."""


def read(run):
    pre = run.spans.named("serve.prefill")
    n = run.stats1["prefill_dispatches"] - run.stats0["prefill_dispatches"]
    if len(pre) != n:
        raise RuntimeError(f"{len(pre)} serve.prefill spans for the "
                           f"window's {n} prefill dispatches")
    padded = sum(s.attrs["B"] * s.attrs["S"] for s in pre)
    return (100.0 * sum(s.attrs["rows"] for s in pre) / padded
            if padded else None)
