"""Serve qwen3-14b at full width from two or more source trees of this repo,
one after another on one card, and compare what a user sees.

Each tree (a checkout, or a ``git archive`` of another commit) is served in
a process of its own, in the order given, so that host noise falls on every
tree alike: for example ``--tree build/ab/parent --tree . --order
0,1,1,0``. A process builds that tree's paged-attention kernel, draws the
weights from seed 0, serves the waves of ``chip_smoke.py``'s ``[serve]``
phase (one request that registers a 64-token system prompt, then eight
requests: four behind that prompt, four of 128 fresh tokens; 16 new tokens
each) once to warm up and ``--reps`` times measured, and times the
paged-attention wrapper at the decode shape of that serve (B=4, H=40, K=8,
D=128, 16-row pages, 32 table entries, 9 live): the host time to enqueue a
call (200 calls back to back, then one sync; 400 kernels at most, within
the launch queue) and its call time with CUDA events around one call (the
wrapper's host work and the kernels, L2 flushed). It prints one JSON line
per process and, at the end, the medians per tree; ``--out`` also writes
them to a file. ``--eager`` serves with ``capture_step=False`` (every
executable of the engine run eagerly, no CUDA graph), the baseline the
graphs are measured against.

Run on the machine with the card: ``python3 tools/serve_ab.py --tree
build/ab/parent --tree . --order 0,1,1,0 --out
chiprun_out/serve_ab.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _requests(Request, vocab):
    import numpy as np
    rng = np.random.default_rng(0)
    system = rng.integers(1, vocab, 64)
    first = [Request(rid=0, prompt=system.copy(), max_new=16)]
    wave = ([Request(rid=1 + i, prompt=np.concatenate(
        [system, rng.integers(1, vocab, 64)]), max_new=16)
        for i in range(4)]
        + [Request(rid=5 + i, prompt=rng.integers(1, vocab, 128),
                   max_new=16) for i in range(4)])
    return [first, wave]


def _decode_problem(torch, seed=7):
    """Decode at the serve's shape: 4 slots, 9 live pages of 16 rows each
    in a permuted pool of 128, bf16."""
    import numpy as np
    B, H, K, D, P, ps, npps, live = 4, 40, 8, 128, 128, 16, 32, 9
    r = np.random.default_rng(seed)
    order = r.permutation(P)
    tables = np.full((B, npps), -1, np.int32)
    kpos = np.full((P, ps), -1, np.int32)
    for b in range(B):
        for j in range(live):
            pg = order[b * live + j]
            tables[b, j] = pg
            kpos[pg] = j * ps + np.arange(ps)
    q_pos = np.full((B, 1), live * ps - 1, np.int32)

    def f(shape):
        return torch.from_numpy(r.standard_normal(shape, np.float32)).to(
            "cuda", torch.bfloat16)
    return (f((B, 1, H, D)), f((P, ps, K, D)), f((P, ps, K, D)),
            *(torch.from_numpy(x).cuda() for x in (kpos, tables, q_pos)))


def worker(tree: Path, reps: int, eager: bool = False) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core.telemetry import class_summary
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch.serve import init_params, serve
    from repro_torch.serve.engine import Request
    assert Path(repro_torch.__file__).resolve().is_relative_to(
        tree.resolve()), repro_torch.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.build(["paged_attention"])

    args = _decode_problem(torch)
    call = lambda: paged_attention(*args)             # noqa: E731
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    host_us = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host_us.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    call_ms = []
    for _ in range(30):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        call_ms.append(start.elapsed_time(end))
    del args, flush

    cfg = get_config("qwen3-14b")
    params = init_params(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    runs = []
    for rep in range(reps + 1):
        waves = _requests(Request, cfg.vocab)
        with contextlib.redirect_stdout(io.StringIO()):
            eng = serve(cfg, params, waves, device="cuda", slots=4,
                        capacity=512, page_size=16, kernel="paged",
                        prefix_sharing=True, capture_step=not eager)
        torch.cuda.synchronize()
        if rep == 0:
            continue                                  # warm-up
        summ = class_summary(eng.records[-len(waves[1]):])["interactive"]
        n_tok = sum(len(r.out) for r in waves[1])
        runs.append(dict(ttft_p50_ms=summ["p50_ttft_s"] * 1e3,
                         tpot_p50_ms=summ["p50_tpot_s"] * 1e3,
                         tokens_per_s=n_tok / eng.stats["wall_s"]))
    return dict(tree=str(tree), eager=eager,
                wrapper_host_us=statistics.median(host_us),
                wrapper_host_us_all=host_us,
                decode_call_ms=statistics.median(call_ms),
                runs=runs, **{k: statistics.median(r[k] for r in runs)
                              for k in runs[0]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, type=Path)
    ap.add_argument("--order", default=None,
                    help="indices into --tree, e.g. 0,1,1,0")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--eager", action="store_true",
                    help="serve with capture_step=False")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.tree[0], a.reps, a.eager)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    order = ([int(i) for i in a.order.split(",")] if a.order
             else list(range(len(a.tree))))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"[serve_ab] {card}")
    # every tree's kernels built at once, before anything is timed
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; "
         "_build.build(['paged_attention'])", str(t / "src")])
        for t in a.tree]
    if any(p.wait() for p in builds):
        raise RuntimeError("a tree's paged_attention.cu did not build")
    results = []
    for i in order:
        res = subprocess.run([sys.executable, __file__, "--worker", "--tree",
                              str(a.tree[i]), "--reps", str(a.reps)]
                             + (["--eager"] if a.eager else []),
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            raise RuntimeError(f"the worker on {a.tree[i]} failed")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"[serve_ab] {json.dumps(r)}", flush=True)
        results.append(r)
    keys = ("wrapper_host_us", "decode_call_ms", "ttft_p50_ms",
            "tpot_p50_ms", "tokens_per_s")
    summary = {}
    for t in a.tree:
        mine = [r for r in results if r["tree"] == str(t)]
        runs = [x for r in mine for x in r["runs"]]
        summary[str(t)] = {
            "wrapper_host_us": statistics.median(r["wrapper_host_us"]
                                                 for r in mine),
            "decode_call_ms": statistics.median(r["decode_call_ms"]
                                                for r in mine),
            **{k: statistics.median(x[k] for x in runs) for k in keys[2:]},
            "processes": len(mine), "serves": len(runs)}
    line = json.dumps({"card": card, "order": order, "eager": a.eager,
                       "summary": summary})
    print(f"[serve_ab] summary {line}")
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps({"card": card, "order": order,
                                     "eager": a.eager, "summary": summary,
                                     "processes": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
