"""Readings that set a cell's limits and rate; never run by the benchmark's
own runs.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 12 [--control 3] [--rates 1,2,4] --out <file.jsonl>

Each seed is one whole run of the cell in this process (weights drawn
again, a new engine, the traffic's warm-up and a window of ``--seconds``).
``--control N`` also reads, on the first N seeds, the control's gap (the
reference through float8) on the same sample of served requests: the
upper reading of the cell's ``logit_gap``; the program's gaps over the
seeds are its lower reading. ``--rates`` sweeps the offered rate instead
(every rate on every seed) and records the queue at the window's start and
end: the knee is the highest rate whose queue does not grow on any seed.
``--fault chunk_carry`` runs every seed with the program's SSD scan broken
underneath (each chunk scanned from a zero state), to read what the check
makes of it. One JSON line a run is appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run as R  # noqa: E402


def drop_chunk_carry(ssd_chunked):
    """``ssd_chunked`` with the state carried from chunk to chunk dropped:
    each chunk scanned from a zero state, the last chunk's state
    returned."""
    import torch

    def faulty(xh, dt, A, Bm, Cm, chunk):
        ys, h = [], None
        for lo in range(0, xh.shape[1], chunk):
            cut = slice(lo, lo + chunk)
            y, h = ssd_chunked(xh[:, cut].contiguous(),
                               dt[:, cut].contiguous(), A,
                               Bm[:, cut].contiguous(),
                               Cm[:, cut].contiguous(), chunk)
            ys.append(y)
        return torch.cat(ys, 1), h
    return faulty


def plant(fault: str) -> None:
    if fault == "chunk_carry":
        from repro_torch.models import ssm
        ssm.ssd_chunked = drop_chunk_carry(ssm.ssd_chunked)
    elif fault:
        raise ValueError(f"no fault named {fault!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    R.environment(R.ROOT)
    plant(args.fault)
    from benchkit.specs import Bench
    bench = Bench(R.ROOT)
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {R.card_line()}", flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    rates = [float(r) for r in args.rates.split(",") if r] or [None]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for i, seed in enumerate(seeds):
        for rate in rates:
            t0 = time.perf_counter()
            res = R.run_cell(bench, cell, seed, args.seconds, False, "cuda",
                             t0, control=i < args.control, rate=rate,
                             check=rate is None)
            row = {"workload": cell["name"], "seed": seed,
                   "fault": args.fault or None,
                   "correct": res["correct"], "attempted": res["attempted"],
                   "failed": res["failed"],
                   "metrics": {k: v for k, (v, _) in res["metrics"].items()},
                   "checks": {k: v for k, (v, _) in res["checks"].items()},
                   **res["notes"], "peak": res["peak"],
                   "wall_s": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
