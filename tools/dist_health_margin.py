"""Measure how far the fabric's health scorer clears its outlier threshold
for a deliberately slow node, at one or more throttles.

Builds the thread-node fabric of ``chip_smoke.py``'s ``[dist]`` health gate
(4 nodes, equal shards, one shard in flight a node) again and again. Each
fabric takes one wave of 64 instances of the example's ``app`` (every node
captures its graph), then node1 is throttled and ten more waves run. The
tool prints node1's robust z-score (an outlier from 6), its verdict, and
the median shard wall of node1 and of the healthy nodes, as the driver
measures them, from dispatch to harvest. Then one summary line a
throttle.

Run on the machine with the card: ``python3 tools/dist_health_margin.py
--throttle 0.05,0.1 --reps 8``. ``--device cpu`` runs it here.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_fabric(cs, LLMapReduce, app, x, throttle):
    be = cs._thread_fabric(depth=1, reweight=False)
    walls = []
    observe = be.registry.observe_shard

    def record(node_id, n, wall_s):
        walls.append((node_id, wall_s))
        return observe(node_id, n, wall_s)

    be.registry.observe_shard = record
    try:
        llmr = LLMapReduce(wave_size=cs.DIST_HEALTH_WAVE, backend=be)
        llmr.map_reduce(app, x[:cs.DIST_HEALTH_WAVE])
        walls.clear()
        be.agents["node1"].throttle(throttle)
        llmr.map_reduce(app, x[:10 * cs.DIST_HEALTH_WAVE])
        node1 = be.registry.health.detail()["node1"]
    finally:
        be.close()
    return dict(
        z=node1["z"], verdict=node1["verdict"],
        node1_wall_ms=1e3 * statistics.median(
            w for nid, w in walls if nid == "node1"),
        healthy_wall_ms=1e3 * statistics.median(
            w for nid, w in walls if nid != "node1"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--throttle", default="0.05,0.1",
                    help="node1's seconds a shard, comma-separated")
    ap.add_argument("--reps", type=int, default=8,
                    help="fabrics a throttle")
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    os.environ["REPRO_COMPILE_CACHE_DIR"] = tempfile.mkdtemp(
        prefix="health-margin-")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import chip_smoke as cs
    from repro_torch.core.llmr import LLMapReduce
    from repro_torch.examples.massive_launch import app
    cs.DEV = args.device
    x = np.random.default_rng(0).standard_normal(
        (10 * cs.DIST_HEALTH_WAVE, 64)).astype(np.float32)
    for throttle in (float(t) for t in args.throttle.split(",")):
        runs = []
        for rep in range(args.reps):
            runs.append(one_fabric(cs, LLMapReduce, app, x, throttle))
            print(json.dumps(dict(throttle_s=throttle, rep=rep, **runs[-1])))
        zs = [r["z"] for r in runs]
        print(f"[health-margin] throttle {throttle} s a shard: node1 z min "
              f"{min(zs):.3f} median {statistics.median(zs):.3f} max "
              f"{max(zs):.3f}; outlier in "
              f"{sum(r['verdict'] == 'outlier' for r in runs)} of "
              f"{len(runs)}; healthy shard wall median "
              f"{statistics.median(r['healthy_wall_ms'] for r in runs):.2f}"
              f" ms, node1's "
              f"{statistics.median(r['node1_wall_ms'] for r in runs):.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
