"""The headline reproduction: interactively launch 16,384 application
instances — measured end to end via LLMapReduce waves through the
pipelined LaunchBackend (wave k+1 staged and enqueued while wave k runs),
with straggler telemetry, per-level launch-tree timings, plus the
paper-scale model comparison. Port of the reference's
``examples/massive_launch.py``.

    PYTHONPATH=src python -m repro_torch.examples.massive_launch
        [--n 16384] [--wave auto|<int>] [--backend pipelined|array|serial]
        [--nodes N] [--transport inproc|socket] [--compare] [--device cpu]

Everything runs on the card unless ``--device cpu`` is given; without a
card and without ``--device cpu`` it fails.

``--wave auto`` engages the measured-telemetry WaveController: wave sizes
(and node/core fan-out) are picked per wave from t_schedule /
t_first_result / drain, AIMD-style, instead of a static knob.

``--obs`` turns on fabric-wide observability for the launch: every wave
joins one span tree (``llmr.map_reduce`` -> dispatch -> shard ->
pump.send -> node stage/exec -> harvest) and the metric registry
(pump/registry/chunk-cache/node counters) is printed after the run.
``--trace-out PATH`` saves the trace as Chrome-trace JSON (Perfetto opens
it; ``python -m repro_torch.obs.report PATH`` renders it as text).

``--nodes N`` (N > 1) launches through the distributed fabric
(``repro_torch.dist``): one dispatch per wave fans out across N local node
agents — each with its own backend, compile cache and heartbeat lease,
all on the one device — and the per-node split, staging overlap and
measured re-weighting are printed after the launch: the paper's scheduler
-> node -> core tree with all three levels real. ``--transport socket``
swaps the fabric's wire from in-process queues to length-prefixed frames
over localhost TCP (one connection per node), so every shard payload
really serializes and travels. The reference's ``--cache-dir`` (its
compile cache's disk tier) has no counterpart: a CUDA graph cannot be
saved.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.backend import make_backend
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.launch_model import CURVES, copy_time
from repro_torch.core.llmr import LLMapReduce
from repro_torch.core.staging import stage_parallel_pull, synth_env, tree_bytes
from repro_torch.core.telemetry import nodes_rollup, stage_rollup, table
from repro_torch.obs import TRACER, enable_observability
from repro_torch.obs.trace import flame_summary


def app(x):
    """One launched instance: its item -> a scalar. Module-level, so
    process and remote nodes can unpickle it."""
    return (x * x).sum()


def reduce_sum(outs):
    """The reduce step: the sum over every instance's output."""
    return torch.stack(outs).sum() if isinstance(outs, list) else outs.sum()


def make_launch_backend(kind, cache, args):
    if args.nodes > 1:
        node_kind = "array" if kind == "serial" else kind
        return make_backend("dist", cache=cache, n_nodes=args.nodes,
                            node_backend=node_kind,
                            transport=args.transport,
                            stage_dedup=not args.no_stage_dedup,
                            device=args.device)
    if kind == "serial":
        return make_backend(kind, device=args.device)
    return make_backend(kind, cache=cache, device=args.device)


def run_launch(kind, cache, args, inputs):
    backend = make_launch_backend(kind, cache, args)
    llmr = LLMapReduce(wave_size=args.wave, backend=backend)
    t0 = time.perf_counter()
    outs, report = llmr.map_reduce(app, inputs, reduce_fn=reduce_sum)
    if backend.device.type == "cuda":
        torch.cuda.synchronize(backend.device)
    dt = time.perf_counter() - t0
    fabric = None
    if args.nodes > 1:
        # snapshot the registry's measured view before the agents stop
        fabric = backend.registry.rollup()
    if hasattr(backend, "close"):
        backend.close()
    return outs, report, dt, fabric


def parse_args(argv=None):
    def wave_arg(v):
        return v if v == "auto" else int(v)

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.massive_launch")
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--wave", type=wave_arg, default="auto",
                    help='wave size, or "auto" for the measured-telemetry '
                         "WaveController (default)")
    ap.add_argument("--backend", default="pipelined",
                    choices=("pipelined", "array", "serial"))
    ap.add_argument("--nodes", type=int, default=1,
                    help="launch through the distributed fabric with this "
                         "many local node agents (>1 engages "
                         "repro_torch.dist; each node runs its own "
                         "--backend)")
    ap.add_argument("--transport", default="inproc",
                    choices=("inproc", "socket"),
                    help="the fabric's wire (with --nodes > 1): in-process "
                         "queues, or length-prefixed frames over localhost "
                         "TCP — one connection per node")
    ap.add_argument("--no-stage-dedup", action="store_true",
                    help="disable content-addressed chunk staging in the "
                         "fabric (with --nodes > 1): every shard payload "
                         "travels whole, the A/B baseline for the "
                         "bytes-on-wire split printed after the launch")
    ap.add_argument("--obs", action="store_true",
                    help="enable fabric-wide tracing + metrics for the "
                         "launch; prints the span-tree flame summary and "
                         "key fabric counters afterwards")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="with --obs: also save the launch trace as "
                         "Chrome-trace JSON (open at ui.perfetto.dev)")
    ap.add_argument("--compare", action="store_true",
                    help="also time the array backend for contrast")
    ap.add_argument("--device", default=None,
                    help="where everything runs: the card unless 'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.obs:
        enable_observability()

    # Step 1: stage the 'application environment' (paper Fig 5)
    env = synth_env(mb=4.0)
    _, rec = stage_parallel_pull(env, [args.device])
    print(f"staged {tree_bytes(env) / 1e6:.1f} MB environment in "
          f"{rec.t_stage * 1e3:.1f} ms (parallel pull)")

    # Step 2: the array launch (paper Figs 6/7), pipelined by default:
    # wave k+1 is sliced/staged/enqueued while wave k executes
    cache = CompileCache()
    inputs = np.random.default_rng(0).standard_normal(
        (args.n, 32)).astype(np.float32)
    outs, report, dt, fabric = run_launch(args.backend, cache, args, inputs)
    r0 = report.records[0]
    print(f"launched {args.n:,} instances in {dt:.2f}s via {r0.strategy} "
          f"({args.n / dt:,.0f} inst/s, {report.waves} waves, "
          f"{report.speculative_redispatches} speculative re-dispatches, "
          f"first result after {r0.t_first_result * 1e3:.1f} ms, "
          f"compile={r0.extra.get('compile_source', 'n/a')})")
    print(f"reduce result {float(outs):.1f} in {report.t_reduce * 1e3:.1f} ms")
    if report.autoscale:
        picks = ", ".join(f"{d.wave}({d.reason.split(':')[0]})"
                          for d in report.autoscale)
        print(f"autoscaled waves: {picks}")
    if args.nodes > 1:
        print(f"per-node split across the fabric over {args.transport} "
              f"({report.node_failures} node failures):")
        for nid, agg in sorted(nodes_rollup(report.records).items()):
            cost = (fabric or {}).get(nid, {}).get("cost_per_instance")
            reweight = (f", measured cost {cost * 1e6:.0f} us/inst"
                        if cost else "")
            print(f"  {nid}: {agg['instances']:,} instances over "
                  f"{agg['waves']} wave shards, {agg['t_busy']:.2f}s busy, "
                  f"staged {agg['t_stage'] * 1e3:.1f} ms "
                  f"({agg['t_stage_hidden'] * 1e3:.1f} ms hidden)"
                  f"{reweight}")
        st = stage_rollup(report.records)
        print(f"staging overlap: {st['wall_s'] * 1e3:.1f} ms node-side "
              f"stage wall, {st['hidden_frac']:.0%} hidden under "
              f"execution (visible: "
              f"{(st['wall_s'] - st['hidden_s']) * 1e3:.1f} ms)")
        if st["bytes_delivered"]:
            dedup_note = (
                f", chunk-cache hit rate {st['cache_hit_rate']:.0%}"
                if "cache_hit_rate" in st else
                " (stage dedup off: every byte travels)")
            print(f"staging bytes: {st['bytes_on_wire'] / 1e6:.2f} MB on "
                  f"the wire for {st['bytes_delivered'] / 1e6:.2f} MB "
                  f"delivered "
                  f"({st['bytes_on_wire'] / st['bytes_delivered']:.2f}x)"
                  f"{dedup_note}")
    print("\nper-wave launch records (per-level: sched -> node -> core):")
    print(table(report.records[:4], title=f"first waves of {args.n}"))
    if args.obs:
        spans = TRACER.spans()
        print(f"\nlaunch span tree ({len(spans)} spans, scheduler -> "
              f"pump -> node -> harvest):")
        print(flame_summary(spans))
        shown = []
        for k, v in sorted(report.metrics.items()):
            if isinstance(v, dict):               # histogram: mean + count
                if v.get("count"):
                    shown.append(f"  {k}: mean {v['sum'] / v['count']:.4g}"
                                 f" over {v['count']} obs")
            elif v:
                shown.append(f"  {k}: {v:,.0f}")
        if shown:
            print("fabric metrics over the launch window:")
            print("\n".join(shown))
        if args.trace_out:
            TRACER.export_json(args.trace_out)
            print(f"trace written to {args.trace_out} "
                  f"(open at https://ui.perfetto.dev)")
    if args.compare:
        # warm BOTH first (untimed) so the timed contrast is pure launch
        # time: the pipelined backend's slots capture graphs of their own
        run_launch("pipelined", cache, args, inputs)
        run_launch("array", cache, args, inputs)
        _, _, dt_pipe, _ = run_launch("pipelined", cache, args, inputs)
        _, _, dt_array, _ = run_launch("array", cache, args, inputs)
        print(f"\nwarm backend contrast: pipelined {dt_pipe * 1e3:.1f} ms "
              f"vs array {dt_array * 1e3:.1f} ms "
              f"({dt_array / dt_pipe:.2f}x)")

    # Step 3: paper-scale context
    print("\npaper-scale (16,384 instances, 256 KNL nodes) launch model:")
    for name, fn in CURVES.items():
        t = fn(16384)
        mark = "  <- this paper" if name == "wine-llmr" else ""
        print(f"  {name:20s} {t / 60:10.1f} min  "
              f"({16384 / t:8.2f} inst/s){mark}")
    print(f"  copy time at n=16384: {copy_time(16384):.1f}s (Fig 5: small "
          f"vs launch)")


if __name__ == "__main__":
    main()
