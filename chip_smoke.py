#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs a CUDA card, ``nvcc`` and this repository; without them it exits
non-zero and prints no result. It imports only ``repro_torch``, torch and
numpy. Phases, each printing its own lines; any failure raises and exits
non-zero:

1. card     name and power limit; TF32 off for float32 products.
2. build    every CUDA kernel of the port, compiled from the sources here.
3. kernels  each kernel against its plain PyTorch version on the card: the
            reference test grid (page sizes 2/4/8/16, MHA/GQA/MQA, window +
            softcap, the MLA q2/k2 form, ragged padded prefill, fragmented
            tables with dead pages, a full pool) in f32 (atol 2e-5) and
            bf16 (atol 2e-2, rtol 1e-2), then the serving path's own bf16
            shapes, timed with CUDA events (median of 30 launches, L2
            flushed between launches) beside the plain version and, as a
            yardstick, scaled_dot_product_attention on the already-gathered
            dense view (no single PyTorch call computes the paged function,
            so ``library_ms`` is null).
4. serve    ``repro_torch.launch.serve.serve`` with qwen3-14b at its full
            published width (40 layers, d_model 5120, 40/8 heads, head_dim
            128, d_ff 17408, vocab 151936), random bf16 weights drawn on the
            card from a seeded generator: 4 slots, 16-row pages, capacity
            512, kernel "paged", prefix sharing. A first wave serves a
            64-token system prompt (registering it); the second wave is 8
            requests of 128 prompt tokens and 16 generated tokens, half of
            them extending the system prompt. Every paged-attention launch
            of both waves is counted: 40 per prefill dispatch and per
            decode step.
5. lockstep from one set of params, paged_prefill + 4 paged_decode_step
            with kernel "paged" and with kernel "gather" on two copies of a
            fresh pool: greedy tokens agree up to the first near-tie.
6. profile  torch.profiler over full-width decode steps: host wall time,
            device busy share, the kernels that take the time.

The last three lines: the card's name and power limit (nvidia-smi), the
kernels' JSON record, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
ULP_TIE = 0.05                     # tests/test_paged_attention.py:_ULP_TIE


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps=30, warmup=3):
    """Median device time of ``fn`` over ``reps`` launches (CUDA events),
    with the 50 MB L2 flushed before each, as a caller would find it."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def problem(seed, dtype, B=2, S=1, H=4, K=2, Dk=16, Dv=16, P=12, ps=4,
            npps=4, filled=None, q2dim=None, q_from_zero=False):
    """A paged-attention problem over a fragmented, permuted pool, as the
    reference tests build it (tests/test_paged_attention.py:_mk). Queries
    sit at the last positions past each slot's history, or with
    ``q_from_zero`` at the history's own last S positions (a prefill)."""
    r = np.random.default_rng(seed)
    k = r.standard_normal((P, ps, K, Dk), np.float32)
    v = r.standard_normal((P, ps, K, Dv), np.float32)
    order = r.permutation(P)
    tables = np.full((B, npps), -1, np.int32)
    kpos = np.full((P, ps), -1, np.int32)
    filled = [npps] * B if filled is None else filled
    n = 0
    for b in range(B):
        for j in range(filled[b]):
            tables[b, j] = order[n]
            kpos[order[n]] = j * ps + np.arange(ps)
            n += 1
    hist = np.asarray([f * ps for f in filled])
    first = hist - S if q_from_zero else hist - 1
    q_pos = (first[:, None] + np.arange(S)[None]).astype(np.int32)
    q = r.standard_normal((B, S, H, Dk), np.float32)
    a = dict(q=q, k=k, v=v, kpos=kpos, tables=tables, q_pos=q_pos,
             q2=None, k2=None)
    if q2dim:
        a["q2"] = r.standard_normal((B, S, H, q2dim), np.float32)
        a["k2"] = r.standard_normal((P, ps, K, q2dim), np.float32)
    return {n: (None if x is None else
                torch.from_numpy(x).to(DEV) if x.dtype == np.int32 else
                torch.from_numpy(x).to(DEV, dtype)) for n, x in a.items()}


def call(fn, a, **kw):
    return fn(a["q"], a["k"], a["v"], a["kpos"], a["tables"], a["q_pos"],
              q2=a["q2"], k2=a["k2"], **kw)


def small_cases():
    def ragged(dtype):
        a = problem(4, dtype, B=3, S=8, filled=[4, 2, 3])
        a["q_pos"][1, 5:] = -1
        return a
    cases = [(f"ps{ps}", lambda d, ps=ps, n=n: problem(0, d, P=16, ps=ps,
                                                       npps=n), {})
             for ps, n in [(2, 6), (4, 4), (8, 2), (16, 2)]]
    cases += [(f"H{H}K{K}", lambda d, H=H, K=K: problem(1, d, H=H, K=K), {})
              for H, K in [(4, 4), (10, 2), (4, 1)]]
    cases += [("window_softcap", lambda d: problem(2, d),
               dict(window=6, softcap=30.0)),
              ("mla_q2k2", lambda d: problem(3, d, K=1, q2dim=8),
               dict(scale=1.0 / math.sqrt(16 + 8))),
              ("dk_ne_dv", lambda d: problem(6, d, Dk=32, Dv=16), {}),
              ("prefill_ragged_padded", ragged, {}),
              ("dead_slot_full_pool",
               lambda d: problem(5, d, B=4, P=12, filled=[4, 0, 3, 4]), {})]
    return cases


def phase_kernels(paged_attention, paged_attention_ref):
    print("[kernels] paged_attention against paged_attention_ref on the card")
    for dtype, atol, rtol in ((torch.float32, 2e-5, 2e-5),
                              (torch.bfloat16, 2e-2, 1e-2)):
        for name, make, kw in small_cases():
            a = make(dtype)
            out = call(paged_attention, a, **kw)
            torch.cuda.synchronize()
            ref = call(paged_attention_ref, a, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                       rtol=rtol, msg=lambda m: f"{name}: {m}")
            if name == "prefill_ragged_padded":
                check(bool((out[1, 5:] == 0).all()), "pad rows not zero")
            if name == "dead_slot_full_pool":
                check(bool((out[1] == 0).all()), "dead slot not zero")
            print(f"[kernels]   {str(dtype)[6:]:8s} {name:22s} "
                  f"max_abs_err={err:.3e} ok")

    rec = {}
    for shape, kw in (("decode", dict(S=1, filled=[9] * 4)),
                      ("prefill", dict(S=128, filled=[8] * 4,
                                       q_from_zero=True))):
        a = problem(7, torch.bfloat16, B=4, H=40, K=8, Dk=128, Dv=128,
                    P=128, ps=16, npps=32, **kw)
        out = call(paged_attention, a)
        torch.cuda.synchronize()
        ref = call(paged_attention_ref, a)
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=1e-2)
        rec[shape] = dict(max_abs_err=err, **measure(paged_attention,
                                                     paged_attention_ref, a))
        r = rec[shape]
        print(f"[kernels] {shape}: B=4 S={a['q'].shape[1]} H=40 K=8 D=128 "
              f"ps=16 npps=32 live pages/slot={kw['filled'][0]} bf16 "
              f"max_abs_err={err:.3e} kernel={r['ms']:.4f}ms "
              f"plain={r['plain_ms']:.4f}ms bound={r['bound_ms']:.4f}ms "
              f"({r['bound_by']}) sdpa_on_gathered_view={r['sdpa_ms']:.4f}ms "
              "(yardstick only: no single PyTorch call computes the paged "
              "function)")
    return rec


def measure(paged_attention, paged_attention_ref, a):
    q, k, v, kpos, tables, q_pos = (a[n] for n in ("q", "k", "v", "kpos",
                                                   "tables", "q_pos"))
    B, S, H, D = q.shape
    P, ps, K, Dv = v.shape
    item = q.element_size()
    # the dense view and mask, gathered once, outside every timed region
    cl = tables.clamp(min=0).long()
    kp = torch.where((tables >= 0).repeat_interleave(ps, 1),
                     kpos[cl].reshape(B, -1), -1)
    vis = (kp[:, None, :] >= 0) & (kp[:, None, :] <= q_pos[:, :, None])
    live_rows = int((tables >= 0).sum()) * ps
    pairs = int(vis.sum())                       # (query, key) pairs needed
    n_bytes = (live_rows * K * (D + Dv) * item + live_rows * 4
               + tables.numel() * 4 + q.numel() * item + q_pos.numel() * 4
               + B * S * H * Dv * item)
    flops = 2 * pairs * H * (D + Dv)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    G = H // K
    kd = k[cl].reshape(B, -1, K, D).transpose(1, 2).repeat_interleave(G, 1)
    vd = v[cl].reshape(B, -1, K, Dv).transpose(1, 2).repeat_interleave(G, 1)
    qh = q.transpose(1, 2)
    mask = vis[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return dict(
        ms=time_ms(lambda: call(paged_attention, a)),
        plain_ms=time_ms(lambda: call(paged_attention_ref, a)),
        sdpa_ms=time_ms(lambda: sdpa(qh, kd, vd, attn_mask=mask)),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phases 4 and 5: serve at full width, then the lockstep check
# ---------------------------------------------------------------------------

def phase_serve(cfg, params, paged_attention, card):
    from repro_torch.core.telemetry import class_summary
    from repro_torch.launch.serve import serve
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.engine import Request

    finite = []

    def watched(fn):                   # record that every logit is finite
        def wrapper(*args, **kw):
            logits, pool = fn(*args, **kw)
            finite.append(bool(torch.isfinite(logits).all()))
            return logits, pool
        return wrapper

    engine_mod.paged_prefill = watched(engine_mod.paged_prefill)
    engine_mod.paged_decode_step = watched(engine_mod.paged_decode_step)

    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab, 64)
    first = [Request(rid=0, prompt=system.copy(), max_new=16)]
    wave = ([Request(rid=1 + i, prompt=np.concatenate(
        [system, rng.integers(1, cfg.vocab, 64)]), max_new=16)
        for i in range(4)]
        + [Request(rid=5 + i, prompt=rng.integers(1, cfg.vocab, 128),
                   max_new=16) for i in range(4)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0                 # count the main path only
    eng = serve(cfg, params, [first, wave], device=DEV, slots=4,
                capacity=512, page_size=16, kernel="paged",
                prefix_sharing=True)
    torch.cuda.synchronize()
    launches = paged_attention.launches
    st = eng.stats
    dispatches = st["prefill_dispatches"] + st["steps"]
    layers = cfg.n_layers
    print(f"[serve] paged_attention launches={launches} = {layers} layers x "
          f"({st['prefill_dispatches']} prefill dispatches "
          f"[{st['prefix_hits']} warm] + {st['steps']} decode steps)")
    check(all(r.done and len(r.out) == 16 for r in first + wave),
          "a request did not finish")
    check(launches == layers * dispatches,
          f"launches {launches} != {layers} x {dispatches}")
    check(st["prefix_hits"] > 0, "no prefix hit")
    eng.pool.check()
    check(finite and all(finite), "non-finite logits")
    recs = eng.records[-len(wave):]
    summ = class_summary(recs)["interactive"]
    n_tok = sum(len(r.out) for r in wave)
    out = dict(launches=launches, ttft_p50_s=summ["p50_ttft_s"],
               tpot_p50_s=summ["p50_tpot_s"], wall_s=st["wall_s"],
               tokens=n_tok, tokens_per_s=n_tok / st["wall_s"],
               peak_bytes=torch.cuda.max_memory_allocated(),
               prefix_hits=st["prefix_hits"], steps=st["steps"],
               prefill_dispatches=st["prefill_dispatches"])
    print(f"[serve] second wave: {len(wave)} requests, {n_tok} tokens in "
          f"{st['wall_s']:.3f}s: TTFT p50 {summ['p50_ttft_s'] * 1e3:.1f} ms, "
          f"TPOT p50 {summ['p50_tpot_s'] * 1e3:.2f} ms, "
          f"{out['tokens_per_s']:.1f} tokens/s; peak memory "
          f"{out['peak_bytes'] / 2**30:.2f} GiB; pool check clean; "
          f"all logits finite; on {card}")
    return out


def phase_lockstep(cfg, params):
    from repro_torch.models.lm import (paged_cache_init, paged_decode_step,
                                       paged_prefill)
    B, ps, npps, P, S, steps = 4, 16, 32, 128, 128, 4
    r = np.random.default_rng(1)
    perm = r.permutation(P)
    tables = np.full((B, npps), -1, np.int32)
    for b in range(B):
        tables[b, :9] = perm[9 * b:9 * (b + 1)]
    tables = torch.from_numpy(tables).to(DEV)
    toks = torch.from_numpy(r.integers(1, cfg.vocab, (B, S)).astype(
        np.int32)).to(DEV)
    lens = torch.full((B,), S, dtype=torch.int32, device=DEV)
    runs = {}
    for kernel in ("gather", "paged"):
        pool = paged_cache_init(cfg, B, P, ps, DEV)
        lg, pool = paged_prefill(params, pool, tables, toks, lens, cfg,
                                 kernel=kernel)
        logits = [lg[:, 0].float()]
        pos = lens[:, None].clone()
        for _ in range(steps):
            t = torch.argmax(logits[-1], -1)[:, None].to(torch.int32)
            lg, pool = paged_decode_step(params, pool, tables, t, pos, cfg,
                                         kernel=kernel)
            logits.append(lg[:, 0].float())
            pos = pos + 1
        lg = torch.stack(logits)                            # (steps+1, B, V)
        check(bool(torch.isfinite(lg).all()), f"{kernel}: non-finite logits")
        top2 = torch.topk(lg, 2, dim=-1)[0]
        runs[kernel] = (lg.argmax(-1).cpu().numpy(),
                        (top2[..., 0] - top2[..., 1]).cpu().numpy())
        del pool
    (a, gaps), (b, _) = runs["gather"], runs["paged"]
    for s in range(B):
        diff = np.nonzero(a[:, s] != b[:, s])[0]
        if diff.size:
            check(gaps[diff[0], s] < ULP_TIE,
                  f"slot {s}: tokens diverge at step {diff[0]} with top-2 "
                  f"gap {gaps[diff[0], s]:.4f} >= {ULP_TIE}")
    print(f"[lockstep] paged vs gather, prefill + {steps} decode steps over "
          f"{B} slots: tokens equal at {int((a == b).sum())}/{a.size} "
          "positions (first divergence only at a near-tie); ok")


def phase_profile(cfg, params, steps=3):
    """Where a full-width decode step's time goes: ``torch.profiler`` over
    ``steps`` steps of 4 slots at 144 rows of context, after a warm-up
    step; device busy share = summed kernel time / host wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.lm import (paged_cache_init, paged_decode_step,
                                       paged_prefill)
    B, ps, npps, P, S = 4, 16, 32, 128, 128
    tables = torch.arange(B * npps, dtype=torch.int32,
                          device=DEV).reshape(B, npps)
    tables[:, 9:] = -1
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (B, S)).astype(np.int32)).to(DEV)
    lens = torch.full((B,), S, dtype=torch.int32, device=DEV)
    pool = paged_cache_init(cfg, B, P, ps, DEV)
    lg, pool = paged_prefill(params, pool, tables, toks, lens, cfg,
                             kernel="paged")
    t = torch.argmax(lg[:, 0], -1)[:, None].to(torch.int32)
    pos = lens[:, None].clone()

    def step():
        nonlocal t, pos, pool
        lg, pool = paged_decode_step(params, pool, tables, t, pos, cfg,
                                     kernel="paged")
        t = torch.argmax(lg[:, 0], -1)[:, None].to(torch.int32)
        pos = pos + 1
        t.cpu()                              # the engine reads every token

    step()                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    kern = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type.name == "CUDA":
            kern[e.key] = (dev_us / steps / 1e3, e.count / steps)
    busy = sum(ms for ms, _ in kern.values())
    n_kernels = sum(n for _, n in kern.values())
    print(f"[profile] decode step at full width (4 slots, 144-row context, "
          f"kernel paged): host wall {wall * 1e3:.2f} ms, device busy "
          f"{busy:.2f} ms ({busy / (wall * 1e3):.1%}), "
          f"{n_kernels:.0f} kernels a step")
    for name, (ms, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[profile]   {ms:8.3f} ms {n:6.0f}x  {name[:90]}")
    check(busy > 0, "the profiler saw no device time")
    return dict(wall_ms=wall * 1e3, busy_ms=busy, kernels=n_kernels)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    from repro_torch.launch.serve import init_params

    name = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | tf32 off")

    t0 = time.perf_counter()
    logs = _build.build(["paged_attention"], verbose=True)
    for line in "".join(logs.values()).splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
    _build.load("paged_attention")
    print(f"[build] paged_attention.cu built and loaded in "
          f"{time.perf_counter() - t0:.1f}s (set-up)")

    rec = phase_kernels(paged_attention, paged_attention_ref)

    cfg = get_config("qwen3-14b")
    g = cfg.groups[0].pattern[0]
    t0 = time.perf_counter()
    params = init_params(cfg, DEV, seed=0)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {g.attn.n_heads}/{g.attn.n_kv_heads} heads, "
          f"head_dim {g.attn.head_dim}, d_ff {g.mlp.d_ff}, vocab {cfg.vocab}"
          f"; {n_params / 1e9:.2f} B params drawn on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    srv = phase_serve(cfg, params, paged_attention, card)
    phase_lockstep(cfg, params)
    srv["profile"] = phase_profile(cfg, params)

    dec, pre = rec["decode"], rec["prefill"]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:107",
        "launches": srv["launches"],
        "max_abs_err": max(dec["max_abs_err"], pre["max_abs_err"]),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None,
        "shape": "decode B=4 S=1 H=40 K=8 D=128 ps=16 npps=32, 9 live "
                 "pages/slot, bf16",
        "sdpa_dense_view_ms": dec["sdpa_ms"],
        "prefill": {k: pre[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "sdpa_ms",
                                        "max_abs_err")},
    }]
    print(f"[serve] summary {json.dumps(srv)}")
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
