"""Where a served cell's time goes, by the program's own spans; never run by
the benchmark's own runs.

    python3 bench/trace_spans.py --workload <cell> --seeds 1,2 \\
        --seconds 51 --modes traced,off,on,on,off --out <file.jsonl>

Each (seed, mode) is one run of the cell in this process as ``bench/run.py``
runs it (weights drawn again, a new engine over the same compile cache,
the traffic's warm-up, then a window of ``--seconds``), without the check
of what was served. Modes: ``off``, the window as the benchmark's
``--trace 0`` runs it; ``on``, the same with the program's tracer
(``repro_torch.obs.trace.TRACER``) enabled over the window, so a pair of
``off`` and ``on`` gives the tracer's cost; ``traced``, the tracer enabled
and ``torch.profiler`` over the middle ``trace_span_s`` of the window, as
a ``--trace 1`` run places it; ``replay``, no traffic: the decode step's
executable alone, its host call and the card's time, without and with
the profiler (``replay_costs``). A run prints one JSON line, appended to
``--out``: the window's end-to-end numbers, its output tokens a second
whichever request they belong to (``tokens_per_s``) and
``decode_step_ms``, the span readers of ``benchkit.spans``, the host wall
of each span name, and, traced, the card's idle time by the innermost
span over it, the longest idle gaps by name, the mean decode cycle, and
how many replayed decode steps had every kernel of their graph inside
the ``serve.step`` that launched them.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from bisect import bisect_left, bisect_right
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run as R  # noqa: E402
from benchkit import spans as S  # noqa: E402

MODES = ("off", "on", "traced", "replay")
#: the tracer's ring while a window runs: room for every span of it
CAPACITY = 1 << 18


def measure(bench, cell: dict, seed: int, seconds: float, mode: str,
            device) -> dict:
    """One run of ``cell`` in ``mode``; returns its row."""
    import torch

    from benchkit import serve, specs, traffic, weights
    from benchkit.loops.open_loop import PEAK_BYTES, PEAK_FLOPS, due_in, e2e
    from benchkit.profiling import Trace
    from repro_torch.models.lm import lm_init
    from repro_torch.obs.trace import TRACER
    t_start = time.perf_counter()
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    fam = specs.family(cfg)
    model_cfg = fam.build(cfg)
    params = weights.draw(
        weights.as_dtype(lm_init(None, model_cfg, "meta"),
                         cfg.get("param_dtype")), seed, device)
    eng = serve.engine_for(model_cfg, params, mix, device,
                           os.path.join(bench.root, "build", "bench-graphs"))
    serve.warm(eng, traffic.possible_lengths(mix["prompt_len"]))
    if mode == "replay":
        return {"workload": cell["name"], "seed": seed, "mode": mode,
                **replay_costs(eng)}
    reqs = traffic.open_loop(mix, seed, seconds, cfg["vocab_size"])
    loop = serve.OpenLoop(eng, reqs)
    loop.start()
    loop.run_until(loop.rec.t_loop0 + mix["warmup_s"])

    prof = t_from = t_to = None
    if mode == "traced":
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
    ws = time.perf_counter()
    if prof is not None:
        span = min(mix.get("trace_span_s", 2.0), seconds)
        t_from = ws + (seconds - span) / 2
        t_to = t_from + span
    tok0, stats0 = loop.tokens(), dict(eng.stats)
    if mode != "off":
        TRACER.clear()
        TRACER.enable(CAPACITY)
    w0 = time.time_ns()
    we = loop.run_until(ws + seconds, prof, t_from, t_to)
    if loop._tracing:
        loop.stop_trace(prof)
    w1 = time.time_ns()
    TRACER.disable()
    tok1, stats1 = loop.tokens(), dict(eng.stats)
    tr = (Trace.from_profiler(prof, *loop.trace_ns)
          if prof is not None and loop.trace_ns is not None else None)

    t_loop0 = loop.rec.t_loop0
    run = SimpleNamespace(window=(ws, we), seconds=we - ws, rec=loop.rec,
                          due=due_in(reqs, t_loop0, ws, we),
                          offered=due_in(reqs, t_loop0, t_loop0, we),
                          counts=fam.Counts(cfg), trace=tr,
                          stats0=stats0, stats1=stats1,
                          tokens=tok1 - tok0, peak_flops=PEAK_FLOPS,
                          peak_bytes=PEAK_BYTES)
    row = {"workload": cell["name"], "seed": seed, "mode": mode,
           **e2e(run, ws - t_start),
           "tokens_per_s": run.tokens / run.seconds}
    for name in ("decode_step_ms", "prefill_dispatch_ms"):
        row[name] = bench.reader(name)(run)
    sp = S.window(w0, w1) if mode != "off" else None
    row["ring_full"] = mode != "off" and sp is None
    if sp is not None:
        row.update(S.readings(run, sp))
        row["spans"] = len(sp.items)
        row["span_ms"] = host_walls(sp)
    if tr is not None:
        segs = S.innermost(S.ranges(sp, tr), tr.t0, tr.t1)
        by_name = S.idle_by_name(tr, segs)
        row.update(
            window_s=tr.window_s, busy_s=tr.busy_s,
            decode_cycle_ms=S.decode_cycle_ms(run, sp),
            decode_cycles=(len(S.decode_cycles(sp, tr.t0, tr.t1))
                           if sp is not None else 0),
            idle_by_span_s=by_name,
            idle_under_program_pct=S.program_share(by_name),
            idle_gaps=S.named_gaps(tr, segs, 10),
            idle_gaps_bench=tr.idle_gaps(10),
            steps_inside=(steps_inside(prof, sp, tr)
                          if sp is not None else None))
    del eng, loop, params
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return row


def replay_costs(eng, n: int = 40) -> dict:
    """The decode step's executable called alone ``n`` times on inputs that
    change no state (``serve.warm``'s), without and with the profiler: the
    host wall of the call, and the card's time from the graph's first
    kernel to its last, read by CUDA events with the card held busy (a
    sleep kernel) until the call has returned, so no host time lies
    between them. Medians, ms."""
    import numpy as np
    import torch
    blank = eng._ints(np.full((eng.slots, eng.pool.pages_per_slot), -1))
    args = (eng.params, eng.kv, blank, eng.tokens, eng.pos,
            torch.zeros_like(eng._live))
    out = {}
    for prof in (False, True):
        host, dev = [], []
        p = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if prof else None
        if p is not None:
            p.start()
        for _ in range(n):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            torch.cuda._sleep(100_000_000)
            e0.record()
            t = time.perf_counter()
            eng._step(*args)
            host.append(1e3 * (time.perf_counter() - t))
            e1.record()
            torch.cuda.synchronize()
            dev.append(e0.elapsed_time(e1))
        if p is not None:
            p.stop()
        key = "profiled" if prof else "plain"
        out[f"step_call_ms.{key}"] = float(np.median(host))
        out[f"step_device_ms.{key}"] = float(np.median(dev))
    return out


def host_walls(sp) -> dict:
    """[count, mean ms, total s] of each span name in the window."""
    out = {}
    for s in sp.items:
        c = out.setdefault(s.name, [0, 0])
        c[0] += 1
        c[1] += s.t1 - s.t0
    return {k: [n, t / n / 1e6, t / 1e9] for k, (n, t) in out.items()}


def steps_inside(prof, sp, tr) -> list:
    """[steps whose graph's kernels all lie inside their ``serve.step``,
    replayed steps in the traced span]: a step's kernels are found by the
    correlation id of the graph launch its ``exe.replay`` made."""
    import torch
    launches, kernels = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.duration_ns() > 0:
                k = kernels.setdefault(e.correlation_id(), [None, None])
                s, t = e.start_ns(), e.start_ns() + e.duration_ns()
                k[0] = s if k[0] is None else min(k[0], s)
                k[1] = t if k[1] is None else max(k[1], t)
        elif e.name().startswith("cudaGraphLaunch"):
            launches.append((e.start_ns(), e.correlation_id()))
    launches.sort()
    starts = [s for s, _ in launches]
    calls = {s.sid: s for s in S.step_calls(sp)}
    inside = total = 0
    for r in sp.named("exe.replay"):
        call = calls.get(r.pid)
        if call is None or r.t0 < tr.t0 or r.t1 > tr.t1:
            continue
        step = sp.parent(call)
        total += 1
        mine = launches[bisect_left(starts, r.t0):bisect_right(starts, r.t1)]
        ks = [kernels.get(c) for _, c in mine]
        if len(mine) == 1 and ks[0] is not None and \
                step.t0 <= ks[0][0] and ks[0][1] <= step.t1:
            inside += 1
    return [inside, total]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--modes", default="traced")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    R.environment(R.ROOT)
    from benchkit.specs import Bench
    bench = Bench(R.ROOT)
    cell = bench.cell(args.workload)
    modes = args.modes.split(",")
    if not set(modes) <= set(MODES):
        print(f"modes are {', '.join(MODES)}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {R.card_line()}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in modes:
            t0 = time.perf_counter()
            row = measure(bench, cell, seed, args.seconds, mode, "cuda")
            row["wall_s"] = time.perf_counter() - t0
            print(json.dumps(row), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
