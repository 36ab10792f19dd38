"""One run of a served cell, offered its requests in an open loop: weights,
engine, warm-up, the loop and its window, the metrics, and the check of
what was served."""
from __future__ import annotations

import gc
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchkit import checks, serve, spans, specs, traffic, weights
from benchkit.profiling import Trace

PEAK_FLOPS = 989e12          # H100 SXM, dense bf16 (data sheet)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 (data sheet)
#: the program tracer's ring over a traced window: room for every span of
#: it (a 51-s window of ``mamba2-chat`` records ~4,200)
SPAN_CAPACITY = 1 << 16


def run(bench, cell: dict, seed: int, seconds: float, trace: bool,
        device, t_proc: float, control: bool = False,
        rate: float = None, check: bool = True) -> dict:
    """One run. For calibration only: ``control`` also reads the
    control's gaps on the same sample; ``rate`` offers the mix at another
    rate, and ``check=False`` skips the check (the knee's sweep)."""
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    if rate is not None:
        mix["rate_per_s"] = rate
    fam = specs.family(cfg)
    from repro_torch.models.lm import lm_init
    model_cfg = fam.build(cfg)
    phases = {"imports": time.perf_counter() - t_proc}
    t = time.perf_counter()
    params = weights.draw(
        weights.as_dtype(lm_init(None, model_cfg, "meta"),
                         cfg.get("param_dtype")), seed, device)
    _sync(device)
    phases["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    cache_dir = os.path.join(bench.root, "build", "bench-graphs")
    eng = serve.engine_for(model_cfg, params, mix, device, cache_dir)
    phases["engine"] = time.perf_counter() - t
    t = time.perf_counter()
    serve.warm(eng, traffic.possible_lengths(mix["prompt_len"]))
    phases["warm"] = time.perf_counter() - t
    reqs = traffic.open_loop(mix, seed, seconds, cfg["vocab_size"])
    loop = serve.OpenLoop(eng, reqs)
    loop.start()
    loop.run_until(loop.rec.t_loop0 + mix["warmup_s"])
    phases["traffic_warmup"] = time.perf_counter() - loop.rec.t_loop0
    sources = dict(eng.stats["compile_sources"])

    ws = time.perf_counter()
    tok0, stats0 = loop.tokens(), dict(eng.stats)
    queue0 = eng.scheduler.pending()
    prof = tr = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        span = min(mix.get("trace_span_s", 2.0), seconds)
        t_from = ws + (seconds - span) / 2
        # the program's own spans over the window: the (B, S) and real
        # rows of each prefill it dispatched
        from repro_torch.obs.trace import TRACER
        TRACER.clear()
        TRACER.enable(SPAN_CAPACITY)
        w0 = time.time_ns()
    we = loop.run_until(ws + seconds, prof,
                        t_from if trace else None,
                        t_from + span if trace else None)
    if loop._tracing:
        loop.stop_trace(prof)
    tok1, stats1 = loop.tokens(), dict(eng.stats)
    queue1 = eng.scheduler.pending()
    sp = None
    if trace:
        TRACER.disable()
        sp = spans.window(w0, time.time_ns())
        TRACER.clear()
        if sp is None:
            raise RuntimeError("the program's tracer filled its ring of "
                               f"{SPAN_CAPACITY} spans over the window")
        if loop.trace_ns is not None:
            tr = Trace.from_profiler(prof, *loop.trace_ns)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)

    t_loop0 = loop.rec.t_loop0
    offered = due_in(reqs, t_loop0, t_loop0, we)
    failed = [r for r in offered if rejected(r)]
    run = SimpleNamespace(window=(ws, we), seconds=we - ws, rec=loop.rec,
                          due=due_in(reqs, t_loop0, ws, we),
                          offered=offered, counts=fam.Counts(cfg),
                          trace=tr, spans=sp, stats0=stats0, stats1=stats1,
                          tokens=tok1 - tok0, peak_flops=PEAK_FLOPS,
                          peak_bytes=PEAK_BYTES)
    ttft = ttft_s(run)
    if trace:
        metrics = {m["name"]: (bench.reader(m["name"])(run), m["unit"])
                   for m in bench.metrics_of(cell, "per_layer")}
    else:
        metrics = e2e(run, ws - t_proc)
        metrics = {m["name"]: (metrics.get(m["name"]), m["unit"])
                   for m in bench.metrics_of(cell, "end_to_end")}
    done = [r for r in reqs if r.engine_req is not None
            and r.engine_req.done and r.engine_req.out]

    # the program's state goes before the reference runs
    del eng, loop
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    picked = checks.sample(done, mix["check"]["sample"] if check else 0,
                           seed)
    got = (checks.served_gap(params, cfg, fam, picked, device, control)
           if picked else checks.summary(np.zeros(0)))
    t_ref = time.perf_counter() - t_ref
    compared = {k: (got[k], v["limit"])
                for k, v in bench.limits(cell["name"]).items()}
    ok = bool(picked) and all(v <= lim for v, lim in compared.values())
    return {"correct": ok, "attempted": len(offered),
            "failed": len(failed),
            "metrics": metrics, "peak": peak, "trace": tr,
            "checks": compared,
            "notes": {"tokens_compared": got["tokens"],
                      "window_tokens_per_s": run.tokens / run.seconds,
                      "window_goodput_tokens_per_s":
                      goodput_tokens(run.due) / run.seconds,
                      "top1_share": got["top1_share"],
                      "logit_gap": got["logit_gap"],
                      "mean_logit_gap": got.get("mean_logit_gap"),
                      "p99_gap": got.get("p99_gap"),
                      "requests_compared": len(picked),
                      "control": got.get("control"),
                      "queue_at_start": queue0, "queue_at_end": queue1,
                      "setup_phases_s": phases, "sources": sources,
                      "reference_s": t_ref,
                      "rate_per_s": mix["rate_per_s"],
                      "ttft_ms_at": {q: 1e3 * float(np.percentile(ttft, q))
                                     for q in (50, 75, 80, 85, 90, 95)}
                      if ttft else None}}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def due_in(reqs, t_loop0: float, t0: float, t1: float) -> list:
    """Every request due in [t0, t1), stamped with its due time, enqueued
    or not (a loop that falls behind enqueues late, and the wait
    counts)."""
    due = [r for r in reqs if t0 <= t_loop0 + r.due < t1]
    for r in due:
        r.t_due = t_loop0 + r.due
    return due


def rejected(r) -> bool:
    """Refused or failed by the engine: done with no token."""
    q = r.engine_req
    return q is not None and q.done and not q.out


def ttft_s(run) -> list:
    """Due time to first token of every request due in the window; one
    still waiting when the window closes counts its wait so far."""
    we = run.window[1]
    out = []
    for r in run.due:
        if rejected(r):
            continue
        t = r.engine_req.t_first if r.engine_req is not None else None
        out.append((t if t is not None and t <= we else we) - r.t_due)
    return out


def goodput_tokens(reqs) -> int:
    """Output tokens (first tokens and decoded ones) that ``reqs`` had
    received when the window closed; read once the loop has stopped, so
    each request's output is as it was at the close. A request refused,
    or never placed, adds what it received (0)."""
    return sum(len(r.engine_req.out) for r in reqs
               if r.engine_req is not None)


def goodput_tokens_per_s(run) -> float:
    """The output tokens of every request due from the loop's start to the
    window's close, as received by the close, over that time. The loop
    starts empty, so no request is cut at the start, and one dropped,
    starved or cut short in the traffic warm-up reads as surely as one in
    the window; at the close a faster program has served more of the late
    arrivals."""
    return goodput_tokens(run.offered) / (run.window[1] - run.rec.t_loop0)


def e2e(run, setup_s: float) -> dict:
    """The end-to-end metrics of a window."""
    ws, we = run.window
    ttft = ttft_s(run)
    tpot = []
    for r in run.rec.requests:
        q = r.engine_req
        if (q is not None and q.done and q.t_done is not None
                and ws <= q.t_done <= we and len(q.out) > 1):
            tpot.append((q.t_done - q.t_first) / (len(q.out) - 1))
    out = {"setup_s": setup_s,
           "goodput_tokens_per_s": goodput_tokens_per_s(run)}
    if ttft:
        out["ttft_p90_ms"] = 1e3 * float(np.percentile(ttft, 90))
    if tpot:
        out["tpot_p90_ms"] = 1e3 * float(np.percentile(tpot, 90))
    return out
