"""Serving launcher: continuous-batching decode for any decoder-only
architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --smoke --requests 8 --gen-len 16 [--engine fixed] [--device cpu] \
        [--cache-dir D] [--no-cache-spill]

Port of ``repro.launch.serve`` (every architecture but whisper's
encoder-decoder). Default engine is the paged one (shared KV page pool,
batched multi-slot prefill, priority classes); ``--engine fixed`` runs the
statically partitioned baseline (``ServeEngine``: a private ring a slot,
one prefill a prompt). Runs on the card unless ``--device cpu`` is given,
and fails without one. Weights are random, drawn on the device from a
seeded ``torch.Generator``. ``--batch-frac`` marks a fraction of the trace
as batch-class filler so the priority split shows up in the per-class
TTFT/TPOT table. ``serve()`` is the entry point the CLI and
``chip_smoke.py`` share. The engine's decode step is compiled through one
``ArrayBackend`` (on the card: a captured CUDA graph, replayed every step).
The last line names the compile cache's sources and counters.
``--cache-dir`` is the compile cache's record directory (default
``$REPRO_COMPILE_CACHE_DIR/repro_torch`` or ``~/.cache/repro-torch-graphs``)
and ``--no-cache-spill`` keeps the cache in memory only, as the
reference's flags. Run twice over one directory, the second process
reads ``step=disk``: its engine captures the step and the prefill shapes
the first met at construction, before its first request.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.backend import ArrayBackend
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.telemetry import (class_summary, serve_table,
                                        slo_attainment)
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.lm import lm_init
from repro_torch.models.spec import ModelConfig
from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.serve.scheduler import AdmissionScheduler


def init_params(cfg: ModelConfig, device, seed: int = 0) -> dict:
    """Random weights drawn on ``device`` from a seeded generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return lm_init(gen, cfg, dev)


def serve(cfg: ModelConfig, params: dict, waves: Sequence[List[Request]], *,
          device=None, slots: int = 4, capacity: int = 128,
          page_size: int = 16, pool_pages: Optional[int] = None,
          batched_prefill: bool = True, kernel: str = "auto",
          prefix_sharing: bool = False,
          target_first_result_s: Optional[float] = None,
          backend: Optional[ArrayBackend] = None,
          capture_step: bool = True, engine: str = "paged"):
    """Serve each wave of requests to completion, in order, on ONE engine
    (a later wave finds the prefixes an earlier one registered), print the
    last wave's report and the compile cache's line, and return the
    engine. ``engine`` is ``"paged"`` (``PagedServeEngine``) or ``"fixed"``
    (``ServeEngine`` with ``slots`` rings of ``capacity`` rows; the paged
    engine's options do not apply to it). ``backend`` (default: a new
    ``ArrayBackend`` on ``device`` over the process-wide cache) compiles
    every executable of the engine (the decode step and each prefill
    shape); ``capture_step=False`` runs them all eagerly."""
    if engine not in ("paged", "fixed"):
        raise ValueError(f"engine must be paged|fixed: {engine!r}")
    if backend is None:
        # the SLO knob is set ONCE, on the shared backend: the admission
        # scheduler preempts against it, and any LLMapReduce built over
        # this backend hands it to its WaveController
        backend = ArrayBackend(device=device,
                               target_first_result_s=target_first_result_s)
    sched = AdmissionScheduler(
        target_first_result_s=backend.target_first_result_s)
    if engine == "fixed":
        eng = ServeEngine(cfg, params, slots=slots, capacity=capacity,
                          backend=backend, scheduler=sched, device=device,
                          capture_step=capture_step)
    else:
        pages_per_slot = max(1, -(-capacity // page_size))
        eng = PagedServeEngine(cfg, params, slots=slots, page_size=page_size,
                               pages_per_slot=pages_per_slot,
                               pool_pages=pool_pages, scheduler=sched,
                               batched_prefill=batched_prefill,
                               kernel=kernel, prefix_sharing=prefix_sharing,
                               device=device, backend=backend,
                               capture_step=capture_step)
    for wave in waves:
        before, n_rec = dict(eng.stats), len(eng.records)
        stats = eng.run(wave)
    recs = eng.records[n_rec:]
    wall = max(stats["wall_s"], 1e-9)        # instant runs: no ZeroDivision
    decoded = stats["decoded"] - before["decoded"]
    print(f"served {len(recs)} requests, {decoded} tokens in "
          f"{stats['steps'] - before['steps']} batched steps / "
          f"{stats['prefill_dispatches'] - before['prefill_dispatches']} "
          f"prefill dispatches ({stats['wall_s']:.1f}s, "
          f"{decoded / wall:.0f} tok/s) on {eng.device}"
          + (f" kernel={eng.kernel}" if engine == "paged" else ""))
    for cls, agg in class_summary(recs).items():
        print(f"  {cls}: n={agg['n']} p50_ttft={agg['p50_ttft_s']:.3f}s "
              f"p50_tpot={agg['p50_tpot_s'] * 1e3:.1f}ms "
              f"preemptions={agg['preemptions']}")
    if target_first_result_s is not None:
        print(f"  slo_attainment="
              f"{slo_attainment(recs, target_first_result_s):.2f} "
              f"(target_first_result_s={target_first_result_s})")
    if engine == "paged":
        ps = eng.pool_stats()
        print(f"  pool: {eng.pool.n_pages} pages x {eng.pool.page_size} "
              f"rows, watermark={ps['watermark']} "
              f"alloc_failures={ps['alloc_failures']} "
              f"prefix_hits={stats['prefix_hits']}")
    print(serve_table(recs, title=f"{cfg.name} {engine}"))
    src = stats["compile_sources"]
    print(f"compile cache: step={src.get('step')} "
          f"prefills={sorted(v for k, v in src.items() if k != 'step')} "
          f"captured_ahead={stats['captured_ahead']} "
          f"built_in={stats['t_build_s']:.2f}s stats={backend.cache.stats}")
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    # both engines serve decoder-only models (no encoder output)
    ap.add_argument("--arch", required=True, choices=[
        a for a in ARCHS if get_config(a).encoder is None])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=("paged", "fixed"), default="paged")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=128,
                    help="per-request KV rows (fixed: per-slot ring; paged: "
                         "pages_per_slot * page_size virtual capacity)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="shared pool size in pages (default: "
                         "slots * capacity / page_size, i.e. no "
                         "oversubscription; smaller pools admit more "
                         "requests than they can hold and preempt "
                         "batch-class work under pressure)")
    ap.add_argument("--batch-frac", type=float, default=0.0,
                    help="fraction of requests enqueued as batch-class")
    ap.add_argument("--one-slot-prefill", action="store_true",
                    help="paged engine: disable batched multi-slot prefill")
    ap.add_argument("--target-first-result-s", type=float, default=None,
                    help="interactive first-result SLO: gates admission "
                         "preemption of batch-class work")
    ap.add_argument("--cache-dir", default=None,
                    help="compile cache record directory (default: "
                         "$REPRO_COMPILE_CACHE_DIR/repro_torch or "
                         "~/.cache/repro-torch-graphs); a warm directory "
                         "captures the recorded shapes at construction")
    ap.add_argument("--no-cache-spill", action="store_true",
                    help="keep the compile cache in memory only")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    t0 = time.perf_counter()
    params = init_params(cfg, args.device)
    print(f"initialized {cfg.name} in {time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, size=args.prompt_len),
                    max_new=args.gen_len,
                    priority=("batch" if rng.random() < args.batch_frac
                              else "interactive"))
            for i in range(args.requests)]
    backend = ArrayBackend(
        cache=CompileCache(cache_dir=args.cache_dir,
                           persistent=not args.no_cache_spill),
        device=args.device, target_first_result_s=args.target_first_result_s)
    serve(cfg, params, [reqs], device=args.device, slots=args.slots,
          capacity=args.capacity, page_size=args.page_size,
          pool_pages=args.pool_pages,
          batched_prefill=not args.one_slot_prefill,
          target_first_result_s=args.target_first_result_s,
          backend=backend, engine=args.engine)


if __name__ == "__main__":
    main()
