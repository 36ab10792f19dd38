"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its traffic
mix and its metrics are found by name from BENCHMARK.json
(``benchkit.specs``). With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics and the
profiler's breakdown. The last line of standard output is the result, one
JSON object; the numbers the check compared, each beside its limit, are
the last lines of standard error. Without enough CUDA devices, or with JAX
or the JAX package loaded once the window has closed, it prints no result
and exits non-zero.
"""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first dot),
    compared whole, is JAX's, jaxlib's, flax's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def environment(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    no library loads JAX on its own."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(build, "inductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "extensions")
    os.environ["REPRO_COMPILE_CACHE_DIR"] = os.path.join(build, "graphs")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (BENCH_DIR, os.path.join(root, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(bench, cell: dict, seed: int, seconds: float, trace: bool,
             device, t_proc: float, **kw) -> dict:
    """One run of ``cell``, driven by the module its mix's ``loop`` names
    (``benchkit/loops/<loop>.py``)."""
    import importlib
    loop = bench.traffic(cell["traffic"])["loop"]
    kind = importlib.import_module(f"benchkit.loops.{loop}")
    return kind.run(bench, cell, seed, seconds, trace, device, t_proc, **kw)


def result_line(res: dict, device: dict, trace: bool) -> dict:
    """The result object of a run; the compared numbers come last."""
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"],
           "metrics": {k: {"value": v, "unit": u}
                       for k, (v, u) in res["metrics"].items()
                       if v is not None},
           "device": device}
    if trace and res.get("trace") is not None:
        t = res["trace"]
        out["breakdown"] = {"device_ops": t.top_ops(10),
                            "idle_gaps": t.idle_gaps(10)}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in res["checks"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment(ROOT)
    from benchkit.specs import Bench
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    res = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   "cuda", T_PROC)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(res["peak"])}
    if args.trace and res.get("trace") is not None:
        device["busy_s"] = res["trace"].busy_s
        device["window_s"] = res["trace"].window_s
    line = result_line(res, device, bool(args.trace))
    for k, v in res.get("notes", {}).items():
        print(f"note {k}: {v}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
