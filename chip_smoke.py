#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs a CUDA card, ``nvcc`` and this repository; without them it exits
non-zero and prints no result. It imports only ``repro_torch``, torch and
numpy. Phases, each printing its own lines; any failure raises and exits
non-zero:

1. card     name and power limit; TF32 off for float32 products, f32
            reductions for bf16 products.
2. build    every CUDA kernel of the port (paged_attention.cu, ssd_scan.cu,
            flash_attention.cu; all three include hopper.cuh), compiled
            from the sources here, one nvcc each, all at once; registers,
            shared memory and spills of each kernel function (fails if a
            bf16 flash kernel, a split, combine or tile paged kernel or a tc
            SSD kernel spills), and, where cuobjdump is on the machine, the
            HGMMA (wgmma) instructions of the bf16 flash, the tile paged and
            the tc SSD kernels (fails on an instantiation without).
3. kernels  each kernel against its plain PyTorch version on the card.
            paged_attention: the reference test grid (page sizes 2/4/8/16,
            MHA/GQA/MQA, window + softcap, the MLA q2/k2 form, ragged padded
            prefill, fragmented tables with dead pages, a full pool, and two
            prefills with S*G >= 64) in f32 (atol 2e-5) and bf16 (atol
            2e-2, rtol 1e-2), each case's route printed (split, tile and
            general each run); then qwen3-14b's decode (split) and prefill
            (tile) shapes and a long-context decode (4 x 4,096 rows, 67 MB
            of K/V), each bf16 output held within one bf16 rounding of the
            f32 answer, with a control that must fail that limit (slot 0's
            last live page dropped); then the full-width decode and prefill
            shapes of the families served below (gemma2-27b past its 4,096
            window with softcap 50, gemma3-12b's D = 256 and 1,024 window,
            stablelm-12b's D = 160, olmoe-1b-7b's G = 1) in f32 and bf16,
            each route printed, each bf16 output held within one bf16
            rounding of the f32 answer against controls that must fail that
            limit (a dropped page; the window removed on the windowed
            shapes), and the bf16 call timed; then deepseek-v2's absorbed
            MLA shapes (H 128 over one latent head, Dk 512 + Dk2 64, Dv
            512; decode over 9 pages, a 128-row prefill over 8, a decode
            over 256), every call on the general route, f32 within 2e-5,
            bf16 within one bf16 rounding of the f32 answer against two
            controls that must fail it (the q2.k2 term dropped; the
            kernel's default scale 1/sqrt(576) for MLA's 1/sqrt(192)),
            timed beside SDPA on the gathered view with the backend that
            took it. ssd_scan: the
            reference sweep (tests/test_kernels.py, and a ragged tc shape)
            in f32 on its
            planned route (relative error 3e-4) and in bf16 on every route
            that takes the shape (6e-2), y and the final state, each case's
            route printed (tc and simt must both run); a strong decay (dt x
            10) on tc, finite and within 3e-4; then the model path's call
            (bf16 x/B/C, f32 dt, y f32 with the state; within 3e-4) at
            mamba2-1.3b's 4 x 512 and 4 x 192 (H=64, P=64, N=128, chunk
            256), batch 1 at 512 and 4,096 tokens, and zamba2-7b's width
            (4 x 512, H=112, N=64), on the planned tc route and on simt
            forced through the wrapper, both timed. Two times a kernel:
            "call" ms, the median of
            30 calls between CUDA events (L2 flushed before each), which
            holds the Python wrapper's host work too, and "device" ms, the
            profiler's self device time of the kernel's own functions per
            call over the same loop; beside them the plain version and the
            bound. paged_attention gets scaled_dot_product_attention on the
            already-gathered dense view as a yardstick; no single PyTorch
            call computes either function, so ``library_ms`` is null.
4. flash    flash_attention against attention_ref on the card, before any
            weights are loaded: the reference test grid (tests/test_kernels.py
            sweep, window/softcap/non-causal variants, Dv = 32) and the edges
            (Sq > Sk with a window: rows that see no key are exact zeros;
            Sq < Sk; B > 1; MQA; every supported head dim) in f32 (atol =
            rtol = 2e-5) and bf16 (2e-2). Then the main path: ``ops.attention``
            once at each full-width prefill shape of the supported configs
            (qwen3-14b, the local layers of gemma2-27b and gemma3-12b,
            stablelm-12b, zamba2-7b's shared block, deepseek-v2's MLA prefill,
            whisper-base's encoder; bf16), every count set to 0 before and
            read after: one launch each. Each output is held on every head
            against attention_ref's f32 answer for the same bf16 inputs
            within one bf16 rounding (rtol 2^-8, atol 1e-5), and a control
            (the window edge one 64-key tile off) must fail that limit. Each
            is timed beside its bound, the plain version and one library
            call: ``scaled_dot_product_attention``, or where it cannot apply
            a softcap, ``flex_attention`` compiled; printed with its device
            and call times, its TFLOP/s on the function's flops (device
            time) and its call time's ratios to the library's and (in the
            printed line only) to the CUDA-core design's
            (``FLASH_EARLIER_MS``).
4a. launch the paper's headline: 16,384 instances of app(x) = (x*x).sum()
            over (16,384, 64) f32 through ``LLMapReduce`` on the array
            backend (two waves of 8,192: one captured CUDA graph of the
            vmapped app, replayed per wave), the pipelined backend (depth
            2: each wave on its own stream with its own graph) and
            autoscaled waves, each cold (a fresh compile cache) and warm
            (the same cache: every wave "memory"), and the serial VM
            baseline (a new executable and capture per instance) on 256:
            every output within 1e-5 (relative) of numpy's and on the
            card; instances/s, t_schedule and ``LaunchRecord.levels()``
            printed. The app launches none of the port's kernels.
4b. dist    the distributed fabric (``repro_torch.dist``): the same 16,384
            instances through ``LLMapReduce(backend=make_backend("dist",
            ...))`` in waves of 8,192 over (a) 4 thread nodes on
            ``inproc``, (b) 4 thread nodes on ``socket``, (c) 2 process
            nodes on ``socket`` (spawned; each its own CUDA context) and
            (d) one remote node, ``python -m repro_torch.dist.node
            --connect``, joining a socket fabric armed with a secret; each
            cold (every node captures its graph) and warm. Gates: outputs
            within 1e-5 (relative) of numpy's and on the card, every
            shard's record naming the card, every process node and the
            remote node taking shards, a repeat launch over ``socket``
            under 10% of the first one's staged bytes on the wire; then on
            thread nodes: one killed mid-wave (the wave completes, correct,
            ``failover`` recorded), one throttled to 0.05 s a shard getting
            a smaller shard within 3 waves, and ``health_verdicts()``
            naming it ``outlier`` and the others ``healthy``. Printed:
            instances/s, t_schedule, bytes on the wire, captures and graph
            pool bytes per node, spawn to alive, beside ``[launch]``'s
            array numbers. The app launches none of the port's kernels.
4c. wine    all ten architectures at smoke width, prefill, decode and
            train (the default app: ``train_4k``, forward + backward +
            AdamW), through one ``WineAdapter``: each app's first step is
            the warm-up of its capture, its second a replay, held against
            the eager translation on the same inputs (within 3e-2, the
            port's bf16 limit; decode: against two eager ``decode_step``
            calls; train: the replayed loss within 1e-3 relative of an
            eager instance's from the same seed, on the same batches); the
            SSD-scan launches over the mamba2 / zamba2 prefill and train
            replays must be > 0; a second adapter on the same cache reads
            "memory" for all thirty.
4d. train-fault  ``resilient_train`` at smoke width (mamba2-1.3b-smoke, 4
            x 512, the SSD kernel in every layer), the step captured,
            checkpoints every 2 steps written asynchronously, a
            ``WorkerFailure`` injected entering step 5: one restart from
            step 4, the checkpoint restored INTO the bound tensors (no
            address moves), one graph that keeps replaying, every loss and
            the final params within 1e-5 of an uninterrupted run.
5. serve    ``repro_torch.launch.serve.serve`` with qwen3-14b at its full
            published width (40 layers, d_model 5120, 40/8 heads, head_dim
            128, d_ff 17408, vocab 151936), random bf16 weights drawn on the
            card from a seeded generator: 4 slots, 16-row pages, capacity
            512, kernel "paged", prefix sharing. A first wave serves a
            64-token system prompt (registering it); the second wave is 8
            requests of 128 prompt tokens and 16 generated tokens, half of
            them extending the system prompt. Every paged-attention launch
            of both waves is counted: 40 per prefill dispatch and per
            decode step, every decode step on the split route and every
            prefill dispatch on the tile route; the other kernels' counts
            stay 0. This phase runs the decode step eagerly (the baseline);
            every other serve phase replays it from a captured CUDA graph.
5a. serve-graph  as 5 with the decode step captured once and replayed
            (every replay counted on split); TTFT, TPOT, tokens/s and peak
            memory beside 5's, capture time, served tokens beside 5's; the
            gate: 8 greedy steps of the captured step against eager
            ``paged_decode_step`` calls from one prefill, tokens equal up
            to the first near-tie (logits' largest difference printed).
6. lockstep from one set of params, paged_prefill + 4 paged_decode_step
            with kernel "paged" and with kernel "gather" on two copies of a
            fresh pool (4 prompts of 128 tokens; 32-entry tables, as
            ``serve``'s at capacity 512, with 9 live pages and a dead tail,
            in a 128-page pool): greedy tokens agree up to the first
            near-tie.
7. profile  torch.profiler over full-width decode steps: host wall time,
            device busy share, the kernels that take the time, the paged
            kernels' share; then the same step captured and replayed: host
            wall, device busy, kernels on the card and launch calls from
            the host, beside the eager step's (every profile-* phase).
8. blocked  the model's blocked attention path at qwen3-14b's width: (a)
            ``attn_core`` at one layer's shape (Q = S = 8,448: past the
            8,192 threshold, the last 1,024-block padded) against the flat
            path on 2 kv heads (bf16 2e-2); (b) one 8,448-token prompt
            prefilled cold through ``paged_prefill(kernel="gather")`` (the
            blocked path in all 40 layers) against 8,192 gathered tokens
            (flat) plus a 256-token suffix through the paged kernel, then 4
            greedy decode steps each: tokens equal up to the first near-tie;
            wall time and peak memory printed.
9. serve-ssm  ``serve`` with mamba2-1.3b at its published width (48 layers,
            d_model 2048, d_inner 4096, 64 heads of 64, d_state 128, vocab
            50280, tied embeddings; 1.34 B parameters, 2.7 GB of bf16): 4
            slots, capacity 1024, 8 requests of 16 generated tokens, four
            with 512-token prompts (two chunks: the state carries) and four
            with 192-token prompts (Q = S). Prefill groups have one exact
            length; every SSD-scan launch is counted: 48 per prefill
            dispatch (decode runs the recurrence, not the scan), every one
            on the tc route.
9a. dist-serve  9's wave again with ``PagedServeEngine(backend=<a 2-node
            DistributedBackend>)``: the decode step compiled through the
            fabric's driver-side cache and replayed there. Gates: the
            tokens equal 9's, as many SSD launches, every one on tc.
10. lockstep-ssm  4 prompts of 512 tokens prefilled through the SSD kernel
            and decoded 4 steps, against the same prompts fed one token at
            a time through paged_decode_step (the decode recurrence, an
            independent path) and the same 4 tokens. In float32 (weights,
            activations, SSM caches) the paths compute one function: logits
            within 1e-3 of their scale and greedy tokens equal up to the
            first near-tie. In bf16, the served model, the paths round at
            different points (as the reference's do): the state's and the
            logits' relative errors and the token agreement are printed.
11. profile-ssm  as 7, for a mamba2-1.3b decode step; then one 4 x 512
            prefill dispatch under the profiler: host wall, device busy,
            kernel count, the SSD kernels' device time and share.
12. serve-window  ``serve`` with gemma2-27b at its published width (46
            layers, d_model 4608, 32/16 heads of 128, d_ff 36864, vocab
            256000; 27.2 B parameters): 2 slots of 4,608 rows, kernel
            "paged"; prompts of 4,200 and 4,150 tokens in one ragged
            prefill dispatch, decode past the 4,096 window, then prompts of
            1,000 and 700; 16 generated each. 46 paged launches a prefill
            dispatch (tile) and a decode step (split). profile-window: as 7.
13. lockstep-window  as 6 with gemma3-12b at its published width (48
            layers, 16/8 heads of 256, 1,024 window) and ragged prompts of
            1,300, 900 and 300 tokens in one batch padded past the window
            (tables of the live pages alone): the shape of the
            gather-prefill fault the port repaired.
14. serve-int8  ``serve`` with zamba2-7b at its published width (81 Mamba2
            layers + 27 applications of one shared attention block, int8
            KV): prompts of 512, 512, 256 and 192 tokens; every SSD launch
            on tc, no paged launch (quantized leaves take the gather
            route), int8 pool leaves. profile-int8: as 7.
15. serve-moe  as 5 with olmoe-1b-7b at its published width (16 layers,
            16 heads of 128, 64 experts top-8), capacity 1,024: 16 paged
            launches a dispatch, a prefix hit. profile-moe: as 7.
16. serve-mla  as 5 with deepseek-v2-236b at its published width (d_model
            5120, MLA with 128 heads, q_lora 1536, kv_lora 512, rope 64; 160
            experts of 1,536 top-6 and 2 shared; vocab 102,400), depth cut
            to the dense first layer and 4 of the 59 MoE layers (34.5 GB):
            5 paged launches a prefill dispatch and a decode step, all on
            the general route (the absorbed form, q2/k2).
17. lockstep-mla  as 6 with that model.
18. profile-mla  as 7, with the MoE layers' device time a step beside the
            least time that reading every expert's weights takes.
19. encdec  whisper-base at full width and depth (6 + 6 layers): 4 x 1,500
            seeded stub frames through encoder_apply, prefill of a 64-token
            prompt, 16 decode steps, held against the full forward (rel <
            0.05); no kernel of the port runs there, as in the reference.
20. vlm     internvl2-76b at full width, depth cut to 16 of 80 layers: 2 x
            (256 seeded patch embeddings + 128 tokens) through prefill into
            int8 KV rings, 8 decode steps at positions offset by the
            embeddings, held against the full forward (rel < 0.05).

21. train-ssm  training at full width and depth: mamba2-1.3b (48 layers,
            1.34 B params), 2 x 4,096 tokens of ``synth_batch`` data
            (``reduced``: batch 256 -> 2), AdamW (lr 1e-3, 2 warmup steps),
            remat on: 4 eager steps, then 4 steps from the same seeded
            state through ``compile_step`` (a warm-up and capture, then
            replays). Gates: every loss finite, the last below the first,
            each replayed loss within 1e-3 relative of the eager one.
            Printed: step ms, tokens/s, peak memory, SSD launches a step
            (48 forward + 48 in remat's recompute) and the model-FLOP share
            of the bf16 peak (6 x params x tokens). ssd-grad: layer 0 on
            its real activations (the trained params): the scan columns'
            gradients (w_x, w_B, w_C, w_dt, A_log) through the kernel's
            autograd wrapper within 6e-2 of the plain version's, the scan
            inputs' gradients within the SSD bounds (3e-4 f32, 6e-2 bf16);
            control: the raw launch (no grad_fn) leaves w_B, w_C, w_dt and
            A_log without a gradient.
22. train   qwen3-14b at full width with its depth cut to 4 of 40 layers
            (2.88 B params), 1 x 4,096: the gates and prints of 21, then one
            eager step with microbatches=2 on 2 x 4,096 whose loss is held
            within 1e-4 of the single-shot loss of the same rows.

Every model's weights are freed before the next one is drawn; the script's
total time is printed. The last three lines: the card's name and power
limit (nvidia-smi), the kernels' JSON record, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # float32 outside the tensor cores
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
    """Call time of ``fn``: the median over ``reps`` calls of CUDA events
    recorded around it, with the 50 MB L2 flushed before each, as a caller
    would find it. The start event is recorded before the Python wrapper
    runs, so this is the wrapper's host work and the kernel's device time
    together (``device_ms`` has the kernel alone)."""
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


def device_ms(fn, names, reps=30, warmup=3):
    """The kernels' own device time per call of ``fn``: torch.profiler's
    self device time of every kernel whose name holds one of ``names``,
    summed over ``reps`` calls with the L2 flushed before each (the loop of
    ``time_ms``), divided by ``reps``. Returns the total and the time per
    name. The profiler's device trace now and then comes back without a
    kernel's records although the kernel ran; such a loop is profiled again,
    up to three times in all, and printed."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        per = dict.fromkeys(names, 0.0)
        for e in prof.key_averages():
            if e.device_type.name != "CUDA":
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            for n in names:
                if n in e.key:
                    per[n] += us / reps / 1e3
        if all(v > 0 for v in per.values()):
            break
        print(f"[profile] attempt {attempt} of 3: the profiler saw no device "
              f"time for {per}")
    check(all(v > 0 for v in per.values()),
          f"the profiler saw no device time for {per}")
    return sum(per.values()), per


# kernel function names of each paged-attention route, as the profiler shows
PAGED_KERNELS = {"split": ("paged_split_kernel", "paged_combine_kernel"),
                 "tile": ("paged_tile_kernel",),
                 "general": ("paged_attention_kernel",)}


def _cuda_tool(name):
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    return path if os.path.exists(path) else None


def ptxas_report(kname, log):
    """Print, one line per kernel function, ptxas's registers, static shared
    memory and spills (``-Xptxas -v``), then its numbered notes (such as
    wgmma serialization) with their count; return {function: spill bytes}."""
    fn, used, smem, spills, notes = None, {}, {}, {}, {}
    for line in log.splitlines():
        note = re.search(r"\((C\d+)\) (.*?) (?:in|of) (?:the )?function "
                         r"'([\w$]+)'", line)
        if note:
            key = (note.group(3), note.group(1),
                   re.sub(r" (?:in )?around line \d+", "", note.group(2)))
            notes[key] = notes.get(key, 0) + 1
            continue
        m = re.search(r"(?:entry function|Function properties for) '?"
                      r"([\w$]+)", line)
        if m:
            fn = m.group(1)
        if "spill" in line:
            spills[fn] = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                                        line))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            used[fn] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            smem[fn] = int(m.group(1)) if m else 0
    for f in used:
        print(f"[build]   {kname}: {f}: {used[f]} registers, {smem[f]} bytes "
              f"smem, {spills.get(f, 0)} bytes spilled")
    for (f, code, text), n in notes.items():
        print(f"[build]   {kname}: {f}: ptxas ({code}) x{n}: {text[:160]}")
    return spills


def sass_count(lib, op, name_part):
    """Per kernel function whose name holds ``name_part``: how many SASS
    instructions of the built library are ``op`` (cuobjdump), or None where
    the tool is missing."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if name_part in m.group(1) else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(rf"\b{op}\b", line):
            counts[fn] += 1
    return counts


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
               lambda d: problem(5, d, B=4, P=12, filled=[4, 0, 3, 4]), {}),
              # S*G >= 64: tile route in bf16, general in f32
              ("prefill_tiles",
               lambda d: problem(8, d, S=32, H=8, K=2, P=40, ps=4, npps=24,
                                 filled=[20, 18], q_from_zero=True), {}),
              ("prefill_tiles_window_softcap",
               lambda d: problem(9, d, S=32, H=8, K=2, P=40, ps=4, npps=24,
                                 filled=[20, 18], q_from_zero=True),
               dict(window=20, softcap=30.0)),
              # S*G >= 64 with q2/k2 (MLA's prefill): general in both types
              ("mla_prefill",
               lambda d: problem(10, d, S=32, H=4, K=1, P=40, ps=4, npps=24,
                                 filled=[20, 18], q2dim=8, q_from_zero=True),
               dict(scale=1.0 / math.sqrt(16 + 8)))]
    return cases


def route_of(paged_attention, fn):
    """Run ``fn`` and return the one route its paged_attention call took."""
    before = dict(paged_attention.routes)
    out = fn()
    taken = [r for r in before if paged_attention.routes[r] != before[r]]
    check(len(taken) == 1, f"routes taken: {taken}")
    return out, taken[0]


# the serving path's shapes (qwen3-14b's attention: B=4, H=40, K=8, D=128,
# 16-row pages) and a long-context decode: 4 x 4,096 rows, 67 MB of K/V
PAGED_SHAPES = [
    ("decode", dict(S=1, filled=[9] * 4), "split"),
    ("prefill", dict(S=128, filled=[8] * 4, q_from_zero=True), "tile"),
    ("long_decode", dict(S=1, filled=[256] * 4, P=1024, npps=256), "split"),
]


def phase_kernels(paged_attention, paged_attention_ref, card):
    print("[kernels] paged_attention against paged_attention_ref on the card")
    seen = {torch.float32: set(), torch.bfloat16: set()}
    for dtype, atol, rtol in ((torch.float32, 2e-5, 2e-5),
                              (torch.bfloat16, 2e-2, 1e-2)):
        for name, make, kw in small_cases():
            a = make(dtype)
            out, route = route_of(paged_attention,
                                  lambda: call(paged_attention, a, **kw))
            seen[dtype].add(route)
            torch.cuda.synchronize()
            ref = call(paged_attention_ref, a, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                       rtol=rtol, msg=lambda m: f"{name}: {m}")
            if name == "prefill_ragged_padded":
                check(bool((out[1, 5:] == 0).all()), "pad rows not zero")
            if name == "dead_slot_full_pool":
                check(bool((out[1] == 0).all()), "dead slot not zero")
            print(f"[kernels]   {str(dtype)[6:]:8s} {name:28s} "
                  f"route={route:7s} max_abs_err={err:.3e} ok")
    # every route in bf16, the serving type; f32 has no tile route
    check(seen[torch.bfloat16] == set(PAGED_KERNELS)
          and seen[torch.float32] == {"split", "general"},
          f"the grid ran routes {seen}")

    rec = {}
    for shape, kw, want in PAGED_SHAPES:
        kw = {**dict(B=4, H=40, K=8, Dk=128, Dv=128, P=128, ps=16, npps=32),
              **kw}
        a = problem(7, torch.bfloat16, **kw)
        out, route = route_of(paged_attention,
                              lambda: call(paged_attention, a))
        check(route == want, f"{shape}: route {route}, not {want}")
        torch.cuda.synchronize()
        ref = call(paged_attention_ref, a)
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=1e-2)
        err_exact, offs = one_rounding_gate(paged_attention_ref, a, out, shape)
        n_off = offs["page dropped"]
        r = rec[shape] = dict(route=route, max_abs_err=err,
                              max_abs_err_f32=err_exact, control_off=n_off,
                              **measure(paged_attention, paged_attention_ref,
                                        a, PAGED_KERNELS[route]))
        dev = " + ".join(f"{n} {ms:.4f}"
                         for n, ms in r["device_parts"].items())
        print(f"[kernels] {shape}: B=4 S={a['q'].shape[1]} H=40 K=8 D=128 "
              f"ps=16 npps={kw['npps']} live pages/slot={kw['filled'][0]} "
              f"bf16 route={route}: max_abs_err={err:.3e} against the plain "
              f"version, {err_exact:.3e} against its f32 answer (limit "
              f"{FLASH_ATOL:g} + {FLASH_RTOL:g}|ref|: one bf16 rounding); "
              f"control (slot 0's last live page dropped): {n_off} elements "
              f"over the limit, fails as it must; device="
              f"{r['device_ms']:.4f}ms ({dev}) call={r['ms']:.4f}ms "
              f"(wrapper + kernel) plain={r['plain_ms']:.4f}ms "
              f"bound={r['bound_ms']:.4f}ms ({r['bound_by']}: "
              f"{r['mbytes']:.1f} MB) sdpa_on_gathered_view="
              f"{r['sdpa_ms']:.4f}ms (yardstick only: no single PyTorch call "
              "computes the paged function)")
        del a, out, ref
        torch.cuda.empty_cache()
    print(f"[kernels] paged_attention times on {card}")
    return rec


def one_rounding_gate(paged_attention_ref, a, out, name, **kw):
    """Hold a bf16 paged output within one bf16 rounding of the plain
    version run in f32 on the same inputs, and show that this limit fails
    each control: slot 0's last live page dropped and, on a windowed
    problem, the window removed. Returns the error against the f32 answer
    and each control's count of elements over the limit."""
    f32 = {n: (x.float() if x is not None and x.is_floating_point() else x)
           for n, x in a.items()}
    exact = call(paged_attention_ref, f32, **kw)
    err = (out.float() - exact).abs().max().item()
    torch.testing.assert_close(out.float(), exact, atol=FLASH_ATOL,
                               rtol=FLASH_RTOL, msg=lambda m: f"{name}: {m}")
    dropped = dict(f32, tables=f32["tables"].clone())
    dropped["tables"][0, int((f32["tables"][0] >= 0).sum()) - 1] = -1
    controls = {"page dropped": (dropped, kw)}
    if kw.get("window") is not None:
        controls["window removed"] = (f32, {**kw, "window": None})
    offs = {}
    for what, (inp, ckw) in controls.items():
        ctl = call(paged_attention_ref, inp, **ckw)
        offs[what] = int((~torch.isclose(out.float(), ctl, atol=FLASH_ATOL,
                                         rtol=FLASH_RTOL)).sum())
        check(offs[what] > 0, f"{name}: the one-rounding limit passes a "
                              f"control ({what})")
        del ctl
    return err, offs


def measure(paged_attention, paged_attention_ref, a, names, **kw):
    """Times of one paged call (device, call), its plain version and SDPA
    on the gathered view, and the bound from the (query, key) pairs the
    mask keeps (``window`` included; ``kw`` are the call's mask keywords)."""
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
    if kw.get("window") is not None:
        vis &= (q_pos[:, :, None] - kp[:, None, :]) < kw["window"]
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
    dev, parts = device_ms(lambda: call(paged_attention, a, **kw), names)
    return dict(
        ms=time_ms(lambda: call(paged_attention, a, **kw)),
        device_ms=dev, device_parts=parts,
        plain_ms=time_ms(lambda: call(paged_attention_ref, a, **kw)),
        sdpa_ms=time_ms(lambda: sdpa(qh, kd, vd, attn_mask=mask)),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        mbytes=n_bytes / 1e6)


# the paged shapes of the families served since (16-row pages, the batch of
# each one's phase below): (name, problem keywords, mask keywords, the bf16
# route). gemma2-27b: a decode at 4,223 / 4,207 past its 4,096 window and a
# 256-row prefill at 3,968-4,223, softcap 50; gemma3-12b: D = 256, window
# 1,024; stablelm-12b: D = 160, 2.5 boxes of 64 columns; olmoe-1b-7b: G = 1
FAMILY_SHAPES = [
    ("gemma2-27b decode", dict(B=2, S=1, H=32, K=16, Dk=128, Dv=128, P=528,
                               npps=264, filled=[264, 263]),
     dict(window=4096, softcap=50.0), "split"),
    ("gemma2-27b prefill", dict(B=2, S=256, H=32, K=16, Dk=128, Dv=128,
                                P=528, npps=264, filled=[264, 264],
                                q_from_zero=True),
     dict(window=4096, softcap=50.0), "tile"),
    ("gemma3-12b decode", dict(B=3, S=1, H=16, K=8, Dk=256, Dv=256, P=282,
                               npps=94, filled=[94, 90, 60]),
     dict(window=1024), "split"),
    ("gemma3-12b prefill", dict(B=3, S=128, H=16, K=8, Dk=256, Dv=256, P=282,
                                npps=94, filled=[94, 94, 94],
                                q_from_zero=True), dict(window=1024), "tile"),
    ("stablelm-12b decode", dict(B=4, S=1, H=32, K=8, Dk=160, Dv=160, P=128,
                                 npps=32, filled=[9] * 4), {}, "split"),
    ("stablelm-12b prefill", dict(B=4, S=128, H=32, K=8, Dk=160, Dv=160,
                                  P=128, npps=32, filled=[8] * 4,
                                  q_from_zero=True), {}, "tile"),
    ("olmoe-1b-7b decode", dict(B=4, S=1, H=16, K=16, Dk=128, Dv=128, P=128,
                                npps=32, filled=[9] * 4), {}, "split"),
    ("olmoe-1b-7b prefill", dict(B=4, S=128, H=16, K=16, Dk=128, Dv=128,
                                 P=128, npps=32, filled=[8] * 4,
                                 q_from_zero=True), {}, "tile"),
]


def phase_family_kernels(paged_attention, paged_attention_ref, card):
    """The new families' full-width paged shapes against the plain version:
    f32 (atol = rtol = 2e-5; decode on split, prefill on general) and bf16
    (atol 2e-2, rtol 1e-2; on the route the serving phases take), each
    route printed. The bf16 output is also held within one bf16 rounding
    of the plain version's f32 answer, against controls that must fail
    that limit (a dropped page; the window removed where there is one),
    and timed beside its bound, the plain version and SDPA on the
    gathered view."""
    print("[kernels] paged_attention at the windowed, D = 160 and G = 1 "
          "families' full-width shapes")
    rec = {}
    for name, shape, kw, want in FAMILY_SHAPES:
        for dtype, atol, rtol in ((torch.float32, 2e-5, 2e-5),
                                  (torch.bfloat16, 2e-2, 1e-2)):
            a = problem(17, dtype, ps=16, **shape)
            out, route = route_of(paged_attention,
                                  lambda: call(paged_attention, a, **kw))
            if dtype == torch.bfloat16:
                check(route == want, f"{name}: route {route}, not {want}")
            torch.cuda.synchronize()
            ref = call(paged_attention_ref, a, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                       rtol=rtol,
                                       msg=lambda m: f"{name} {dtype}: {m}")
            print(f"[kernels]   {str(dtype)[6:]:8s} {name:22s} "
                  f"route={route:7s} max_abs_err={err:.3e} ok")
            if dtype == torch.float32:
                del a, out, ref
                continue
            err_exact, offs = one_rounding_gate(paged_attention_ref, a, out,
                                                name, **kw)
            r = rec[name] = dict(route=route, max_abs_err=err,
                                 max_abs_err_f32=err_exact, control_off=offs,
                                 **measure(paged_attention,
                                           paged_attention_ref, a,
                                           PAGED_KERNELS[route], **kw))
            del a, out, ref
            torch.cuda.empty_cache()
            ctl = ", ".join(f"{n}: {c}" for n, c in offs.items())
            print(f"[kernels] {name}: B={shape['B']} S={shape['S']} "
                  f"H={shape['H']} K={shape['K']} D={shape['Dk']} ps=16 "
                  f"npps={shape['npps']} live pages/slot={shape['filled']} "
                  f"{kw or 'causal'} bf16 route={route}: {err_exact:.3e} "
                  f"against its f32 answer (limit {FLASH_ATOL:g} + "
                  f"{FLASH_RTOL:g}|ref|: one bf16 rounding); controls over "
                  f"the limit ({ctl}), fail as they must; device="
                  f"{r['device_ms']:.4f}ms call={r['ms']:.4f}ms (wrapper + "
                  f"kernel) plain={r['plain_ms']:.4f}ms bound="
                  f"{r['bound_ms']:.4f}ms ({r['bound_by']}: "
                  f"{r['mbytes']:.1f} MB) "
                  f"x{r['device_ms'] / r['bound_ms']:.1f} sdpa_on_gathered_view={r['sdpa_ms']:.4f}ms (yardstick; "
                  "no softcap there)")
    print(f"[kernels] paged_attention family times on {card}")
    return rec


# deepseek-v2's absorbed MLA at full head counts: 4 slots, 128 query heads
# over one latent head, q.ckv (Dk 512) + q_rope.kr (Dk2 64), values the
# same ckv pool (Dv 512), 16-row pages; R = S * 128 >= 64 rows and q2/k2
# leave split and tile out, so every shape takes the general route
MLA_SCALE = 1.0 / math.sqrt(128 + 64)           # 1/sqrt(dn + dr)
MLA_SHAPES = [
    ("decode", dict(S=1, filled=[9] * 4, P=128, npps=32)),
    ("prefill", dict(S=128, filled=[8] * 4, P=128, npps=32,
                     q_from_zero=True)),
    ("long_decode", dict(S=1, filled=[256] * 4, P=1024, npps=256)),
]


def mla_problem(dtype, **kw):
    """A paged MLA problem: k = v = one ckv pool tensor, k2 the rope keys."""
    a = problem(23, dtype, B=4, H=128, K=1, Dk=512, Dv=512, ps=16,
                q2dim=64, **kw)
    a["v"] = a["k"]
    return a


def sdpa_backend_ms(q, k, v, mask):
    """SDPA on a gathered view: the first backend of flash, efficient,
    cuDNN and math that takes the inputs, and its call time."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            # a refusing backend warns why before it raises
            with warnings.catch_warnings(), sdpa_kernel([be]):
                warnings.simplefilter("ignore", UserWarning)
                sdpa(q, k, v, attn_mask=mask, scale=MLA_SCALE)
                torch.cuda.synchronize()
                return be.name.lower(), time_ms(
                    lambda: sdpa(q, k, v, attn_mask=mask, scale=MLA_SCALE))
        except RuntimeError:
            continue
    return None, None


def mla_measure(paged_attention, paged_attention_ref, a):
    """Times of one MLA paged call (device, call), its plain version and
    SDPA on the gathered view (q and k as [q_abs | q_rope] and [ckv | kr],
    576 columns, v the 512 ckv columns), and the bound: the live ckv and kr
    rows read once (k = v is one tensor), kpos, tables, q, q2, q_pos and
    the output, against 2 * pairs * H * (Dk + Dk2 + Dv) flops."""
    q, q2, k, k2, kpos, tables, q_pos = (a[n] for n in (
        "q", "q2", "k", "k2", "kpos", "tables", "q_pos"))
    B, S, H, Dk = q.shape
    Dk2, ps, item = q2.shape[-1], k.shape[1], q.element_size()
    cl = tables.clamp(min=0).long()
    kp = torch.where((tables >= 0).repeat_interleave(ps, 1),
                     kpos[cl].reshape(B, -1), -1)
    vis = (kp[:, None, :] >= 0) & (kp[:, None, :] <= q_pos[:, :, None])
    live_rows = int((tables >= 0).sum()) * ps
    pairs = int(vis.sum())
    n_bytes = (live_rows * ((Dk + Dk2) * item + 4) + tables.numel() * 4
               + (q.numel() + q2.numel()) * item + q_pos.numel() * 4
               + B * S * H * Dk * item)
    flops = 2 * pairs * H * (Dk + Dk2 + Dk)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    kd = torch.cat([k[cl], k2[cl]], dim=-1).reshape(B, -1, Dk + Dk2)
    qh = torch.cat([q, q2], dim=-1).transpose(1, 2)         # (B, H, S, 576)
    kh = kd[:, None].expand(B, H, *kd.shape[1:])
    vh = kd[:, None, :, :Dk].expand(B, H, kd.shape[1], Dk)
    backend, sdpa_ms = sdpa_backend_ms(qh, kh, vh, vis[:, None])
    dev, parts = device_ms(lambda: call(paged_attention, a, scale=MLA_SCALE),
                           PAGED_KERNELS["general"])
    return dict(
        ms=time_ms(lambda: call(paged_attention, a, scale=MLA_SCALE)),
        device_ms=dev, device_parts=parts,
        plain_ms=time_ms(lambda: call(paged_attention_ref, a,
                                      scale=MLA_SCALE), reps=10),
        sdpa_ms=sdpa_ms, sdpa_backend=backend,
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        mbytes=n_bytes / 1e6)


def phase_mla_kernels(paged_attention, paged_attention_ref, card):
    """deepseek-v2's paged shapes (``MLA_SHAPES``) against the plain
    version: f32 within 2e-5; bf16 within one bf16 rounding of the f32
    answer, where two controls must fail that limit: the q2.k2 term dropped
    and the kernel's default scale 1/sqrt(Dk + Dk2) = 1/sqrt(576). Every
    call on the general route; the bf16 call timed."""
    print("[kernels] paged_attention at deepseek-v2's absorbed MLA shapes "
          "(H 128, K 1, Dk 512 + Dk2 64, Dv 512, 16-row pages)")
    rec = {}
    for name, kw in MLA_SHAPES:
        a = mla_problem(torch.float32, **kw)
        out, route = route_of(paged_attention, lambda: call(
            paged_attention, a, scale=MLA_SCALE))
        check(route == "general", f"mla {name} f32: route {route}")
        torch.cuda.synchronize()
        ref = call(paged_attention_ref, a, scale=MLA_SCALE)
        err32 = (out - ref).abs().max().item()
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5,
                                   msg=lambda m: f"mla {name} f32: {m}")
        del a, out, ref
        b = mla_problem(torch.bfloat16, **kw)
        out, route = route_of(paged_attention, lambda: call(
            paged_attention, b, scale=MLA_SCALE))
        check(route == "general", f"mla {name} bf16: route {route}")
        torch.cuda.synchronize()
        # the exact answer for the bf16 inputs: the plain version in f32
        f32 = {n: (x.float() if x is not None and x.is_floating_point()
                   else x) for n, x in b.items()}
        exact = call(paged_attention_ref, f32, scale=MLA_SCALE)
        err = (out.float() - exact).abs().max().item()
        torch.testing.assert_close(out.float(), exact, atol=FLASH_ATOL,
                                   rtol=FLASH_RTOL,
                                   msg=lambda m: f"mla {name} bf16: {m}")
        controls = {
            "q2.k2 dropped": call(paged_attention_ref,
                                  dict(f32, q2=None, k2=None),
                                  scale=MLA_SCALE),
            "scale 1/sqrt(576)": call(paged_attention_ref, f32)}
        offs = {}
        for what, ctl in controls.items():
            offs[what] = int((~torch.isclose(out.float(), ctl,
                                             atol=FLASH_ATOL,
                                             rtol=FLASH_RTOL)).sum())
            check(offs[what] > 0, f"mla {name}: the one-rounding limit "
                                  f"passes a control ({what})")
        del controls, f32, exact, out
        torch.cuda.empty_cache()
        r = rec[name] = dict(route=route, max_abs_err=err32,
                             max_abs_err_f32=err, control_off=offs,
                             **mla_measure(paged_attention,
                                           paged_attention_ref, b))
        del b
        torch.cuda.empty_cache()
        ctl = ", ".join(f"{n}: {c}" for n, c in offs.items())
        sdpa = (f"{r['sdpa_ms']:.4f}ms ({r['sdpa_backend']})"
                if r["sdpa_ms"] is not None else "null (refused)")
        print(f"[kernels] mla {name}: B=4 S={kw['S']} H=128 K=1 Dk=512+64 "
              f"Dv=512 ps=16 npps={kw['npps']} live pages/slot="
              f"{kw['filled'][0]} route={route}: f32 max_abs_err="
              f"{err32:.3e} against the plain version; bf16 {err:.3e} "
              f"against its f32 answer (limit {FLASH_ATOL:g} + "
              f"{FLASH_RTOL:g}|ref|: one bf16 rounding); controls over the "
              f"limit ({ctl}), fail as they must; device="
              f"{r['device_ms']:.4f}ms call={r['ms']:.4f}ms (wrapper + "
              f"kernel) plain={r['plain_ms']:.4f}ms bound="
              f"{r['bound_ms']:.4f}ms ({r['bound_by']}: {r['mbytes']:.1f} "
              f"MB) x{r['device_ms'] / r['bound_ms']:.1f} "
              f"sdpa_on_gathered_view={sdpa} (yardstick only)")
    print(f"[kernels] paged_attention MLA times on {card}")
    return rec


SSD_SWEEP = [(1, 128, 2, 64, 32, 64),       # tests/test_kernels.py:60-64
             (2, 256, 4, 64, 64, 128),
             (1, 192, 2, 32, 16, 64),
             (1, 200, 3, 64, 128, 100)]     # tc: a ragged last tile, H odd
# bf16 x/B/C, f32 dt, y f32 with the final state: the model path's call
SSD_MODEL = [("S512", (4, 512, 64, 64, 128, 256)),     # mamba2-1.3b: 2 chunks
             ("S192", (4, 192, 64, 64, 128, 256)),     # Q = S = 192
             ("batch1", (1, 512, 64, 64, 128, 256)),   # two blocks a head
             ("long4096", (1, 4096, 64, 64, 128, 256)),  # 16 chunks carried
             ("zamba2", (4, 512, 112, 64, 64, 256))]   # zamba2-7b's width
# kernel function names of each SSD route, as the profiler shows them
SSD_KERNELS = {"tc": ("ssd_scan_tc_kernel",), "simt": ("ssd_scan_simt_kernel",)}


def ssd_problem(seed, Bz, S, H, P, N, dtype, dt_dtype):
    """The reference sweep's inputs (tests/test_kernels.py), from numpy."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((Bz, S, H, P), np.float32)
    dt = np.logaddexp(r.standard_normal((Bz, S, H), np.float32), 0)
    A = -np.exp(0.3 * r.standard_normal((H,), np.float32))
    B = r.standard_normal((Bz, S, N), np.float32)
    C = r.standard_normal((Bz, S, N), np.float32)
    return (torch.from_numpy(x).to(DEV, dtype),
            torch.from_numpy(dt).to(DEV, dt_dtype),
            torch.from_numpy(A).to(DEV),
            torch.from_numpy(B).to(DEV, dtype),
            torch.from_numpy(C).to(DEV, dtype))


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()


def ssd_bound(args, y, h, chunk):
    """Least time for the scan: each input read once and y and the final
    state written once over the memory rate, against the reference's four
    products per (b, h, chunk) — C.B^T, scores @ x, the state read and the
    state update — over the peak rate of the inputs' type."""
    x, B = args[0], args[3]
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    n_bytes = sum(t.numel() * t.element_size() for t in (*args, y, h))
    flops = Bz * H * (S // Q) * (2 * Q * Q * N + 2 * Q * Q * P
                                 + 4 * Q * N * P)
    peak = BF16_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                mbytes=n_bytes / 1e6, gflop=flops / 1e9)


def ssd_run(ssd_scan, args, chunk, out_dtype=None, route=None):
    """One wrapper call; returns y, h and the route that launched."""
    before = dict(ssd_scan.routes)
    y, h = ssd_scan(*args, chunk=chunk, out_dtype=out_dtype,
                    return_state=True, route=route)
    torch.cuda.synchronize()
    ran = [r for r, n in ssd_scan.routes.items() if n != before[r]]
    check(len(ran) == 1, f"ssd_scan: one call moved the route counts {ran}")
    return y, h, ran[0]


def phase_ssd(ssd_scan, ssd_chunked_ref, card):
    """The sweep in f32 on its planned route and in bf16 on every route that
    takes the shape; a strong decay; then the model path's shapes on the
    planned route (tc) beside the simt route forced through the wrapper,
    each within 3e-4 and timed."""
    from repro_torch.kernels.ssd_scan import ROUTES, _plan
    print("[kernels] ssd_scan against ssd_chunked_ref on the card")
    ran = dict.fromkeys(ROUTES, 0)
    for dtype, tol in ((torch.float32, 3e-4), (torch.bfloat16, 6e-2)):
        for shape in SSD_SWEEP:
            Bz, S, H, P, N, chunk = shape
            args = ssd_problem(S, Bz, S, H, P, N, dtype, dtype)
            plan = _plan((Bz, S, H, P, N, min(chunk, S), dtype), 132)
            forced = [None] if dtype == torch.float32 else (
                ["tc", "simt"] if plan.route == "tc" else ["simt"])
            ry, rh = ssd_chunked_ref(*args, chunk)
            for route in forced:
                y, h, got = ssd_run(ssd_scan, args, chunk, route=route)
                ran[got] += 1
                ey, eh = rel_err(y, ry.to(y.dtype)), rel_err(h, rh)
                check(ey < tol and eh < tol,
                      f"ssd_scan {shape} {dtype} ({got}): rel err y "
                      f"{ey:.3e} h {eh:.3e}")
                print(f"[kernels]   {str(dtype)[6:]:8s} Bz={Bz} S={S} H={H} "
                      f"P={P} N={N} chunk={chunk} route={got}: rel_err y "
                      f"{ey:.3e} h {eh:.3e} (tol {tol:g}) ok")
    # strong decay: dt x 10, exp(cum) underflows along the chunk
    args = list(ssd_problem(11, 4, 512, 64, 64, 128, torch.bfloat16,
                            torch.float32))
    args[1] = args[1] * 10
    y, h, got = ssd_run(ssd_scan, args, 256, out_dtype=torch.float32)
    ry, rh = ssd_chunked_ref(*args, 256)
    ey, eh = rel_err(y, ry), rel_err(h, rh)
    check(got == "tc" and bool(torch.isfinite(y).all())
          and bool(torch.isfinite(h).all()) and ey < 3e-4 and eh < 3e-4,
          f"ssd_scan strong decay ({got}): rel err y {ey:.3e} h {eh:.3e}")
    print(f"[kernels]   strong decay (dt x 10) Bz=4 S=512 H=64: route={got} "
          f"rel_err y {ey:.3e} h {eh:.3e} (tol 3e-4), all finite: ok")

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rec = {}
    for name, shape in SSD_MODEL:
        Bz, S, H, P, N, chunk = shape
        args = ssd_problem(S, Bz, S, H, P, N, torch.bfloat16, torch.float32)
        plan = _plan((Bz, S, H, P, N, min(chunk, S), torch.bfloat16), n_sm)
        ry, rh = ssd_chunked_ref(*args, chunk)
        b = ssd_bound(args, ry, rh, chunk)
        plain_ms = time_ms(lambda: ssd_chunked_ref(*args, chunk))
        out = dict(plain_ms=plain_ms, bound_ms=b["bound_ms"],
                   bound_by=b["bound_by"], plan=dict(plan._asdict()))
        for route in ("tc", "simt"):
            y, h, got = ssd_run(ssd_scan, args, chunk, torch.float32,
                                None if route == "tc" else route)
            ran[got] += 1
            check(got == route, f"ssd_scan {name}: planned {got}, not tc")
            ey, eh = rel_err(y, ry), rel_err(h, rh)
            check(ey < 3e-4 and eh < 3e-4,
                  f"ssd_scan {name} ({route}): rel err y {ey:.3e} h "
                  f"{eh:.3e}")

            def run(route=route):
                return ssd_scan(*args, chunk=chunk, out_dtype=torch.float32,
                                return_state=True,
                                route=None if route == "tc" else route)
            ms = time_ms(run)
            dev = device_ms(run, SSD_KERNELS[route])[0]
            key = "" if route == "tc" else "simt_"
            out.update({f"{key}ms": ms, f"{key}device_ms": dev,
                        f"{key}rel_err_y": ey, f"{key}rel_err_h": eh,
                        f"{key}max_abs_err": (y - ry).abs().max().item()})
            print(f"[kernels]   model {name} Bz={Bz} S={S} H={H} P={P} N={N} "
                  f"chunk={chunk} route={route}"
                  + (f" (G={plan.G} R={plan.R}: {plan.blocks} blocks on "
                     f"{n_sm} SMs)" if route == "tc" else "")
                  + f": rel_err y {ey:.3e} h {eh:.3e} (tol 3e-4) "
                  f"device={dev:.4f}ms call={ms:.4f}ms (wrapper + kernel) "
                  f"plain={plain_ms:.4f}ms bound={b['bound_ms']:.4f}ms "
                  f"({b['bound_by']}: {b['mbytes']:.1f} MB, {b['gflop']:.2f} "
                  f"GFLOP; x{dev / b['bound_ms']:.1f}) ok")
        rec[name] = out
    print(f"[kernels] ssd_scan routes run: {json.dumps(ran)}")
    check(all(ran.values()), f"an ssd_scan route never ran: {ran}")
    print(f"[kernels] ssd_scan times on {card}")
    return rec


# ---------------------------------------------------------------------------
# Phase 4: flash attention against its plain version, through ops.attention
# ---------------------------------------------------------------------------

# (name, (B, H, K, Sq, Sk, D, Dv), keyword arguments): the reference test
# grid of tests/test_kernels.py (sweep, variants, Dv = 32), then the edges
# the kernel masks itself and every head dim of the supported configs
FLASH_GRID = (
    [(f"sweep{i}", shape, {}) for i, shape in enumerate([
        (1, 4, 4, 128, 128, 64, 64), (2, 8, 2, 256, 256, 64, 64),
        (1, 4, 1, 128, 384, 128, 128), (1, 2, 2, 96, 160, 64, 64)])]
    + [(f"variant{i}", (1, 4, 2, 128, 128, 64, 64), kw) for i, kw in
       enumerate([dict(window=32), dict(softcap=25.0),
                  dict(window=64, softcap=50.0), dict(causal=False)])]
    + [("dv32", (1, 4, 4, 128, 128, 64, 32), {}),
       ("sq_gt_sk_window", (1, 2, 1, 96, 40, 64, 64), dict(window=8)),
       ("sq_lt_sk_causal", (1, 2, 2, 40, 96, 64, 64), {}),
       ("batch3", (3, 4, 2, 64, 80, 32, 32), {}),
       ("mqa", (2, 6, 1, 72, 72, 64, 64), {})]
    + [(f"D{D}", (1, 2, 1, 72, 72, D, 128 if D == 192 else D),
        dict(scale=1.0 / math.sqrt(D)) if D == 192 else {})
       for D in (64, 112, 128, 160, 192, 256)])
# full-width prefill shapes of the supported configs, bf16
FLASH_MODEL = [
    ("qwen3-14b", (1, 40, 8, 4096, 4096, 128, 128), {}),
    ("gemma2-27b-local", (1, 32, 16, 8192, 8192, 128, 128),
     dict(window=4096, softcap=50.0)),
    ("gemma3-12b-local", (1, 16, 8, 4096, 4096, 256, 256), dict(window=1024)),
    ("stablelm-12b", (1, 32, 8, 4096, 4096, 160, 160), {}),
    ("zamba2-7b-shared", (1, 32, 32, 4096, 4096, 112, 112), {}),
    ("deepseek-v2-mla-prefill", (1, 128, 128, 4096, 4096, 192, 128),
     dict(scale=1.0 / math.sqrt(192))),
    ("whisper-base-encoder", (1, 8, 8, 1500, 1500, 64, 64),
     dict(causal=False)),
]
# the CUDA-core design's bf16 kernel times at these shapes, before the
# products moved to the tensor cores (PERF.md §6; H100 80GB HBM3, 700 W):
# a yardstick for the printed line only, never part of the kernels record
FLASH_EARLIER_MS = {
    "qwen3-14b": 7.0892, "gemma2-27b-local": 17.0524,
    "gemma3-12b-local": 2.8347, "stablelm-12b": 7.0689,
    "zamba2-7b-shared": 5.5720, "deepseek-v2-mla-prefill": 26.4188,
    "whisper-base-encoder": 0.3485}
# full width, bf16 out against the f32 answer: one round-to-nearest bf16
# rounding (half an ulp, 2^-9 relative) with 2x room, and f32 summation noise
FLASH_RTOL, FLASH_ATOL = 2.0 ** -8, 1e-5


def visible(Sq, Sk, causal=True, window=None, **_):
    """Per query row, the keys it sees: (Sq, Sk) bool on the card."""
    qp = torch.arange(Sq, device=DEV)[:, None]
    kp = torch.arange(Sk, device=DEV)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=DEV)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    return mask


def flash_inputs(shape, dtype, seed):
    """q, k, v drawn on the card from a seeded generator."""
    B, H, K, Sq, Sk, D, Dv = shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    return [torch.randn(s, generator=g, device=DEV).to(dtype)
            for s in ((B, H, Sq, D), (B, K, Sk, D), (B, K, Sk, Dv))]


def flash_bound(shape, kw, item):
    """Least time: q, k, v and out once over the memory rate, against
    2 * H * (D + Dv) flops per visible (query, key) pair over 989 TFLOP/s
    (bf16; 67 for f32)."""
    B, H, K, Sq, Sk, D, Dv = shape
    pairs = int(visible(Sq, Sk, **kw).sum())
    n_bytes = B * (H * Sq * (D + Dv) + K * Sk * (D + Dv)) * item
    flops = 2 * B * H * (D + Dv) * pairs
    peak = BF16_FLOPS if item == 2 else F32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                gflop=flops / 1e9, mbytes=n_bytes / 1e6)


def flex_ms(q, k, v, out, kw):
    """The library yardstick where SDPA cannot apply the function (the
    softcap): ``flex_attention``, compiled, with cap * tanh(s / cap) as its
    score_mod and the causal mask and window as its block mask. Returns its
    time, its max |diff| to the kernel's ``out`` and its name."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    Sq, Sk = q.shape[2], k.shape[2]
    cap, window = kw["softcap"], kw["window"]      # the one such shape: causal

    def score_mod(s, b, h, qi, ki):
        return cap * torch.tanh(s / cap)

    def mask_mod(b, h, qi, ki):
        return (ki <= qi) & (qi - ki < window)

    mask = create_block_mask(mask_mod, None, None, Sq, Sk, device=DEV)
    fn = torch.compile(flex_attention)

    def run():
        return fn(q, k, v, score_mod=score_mod, block_mask=mask,
                  scale=kw.get("scale"), enable_gqa=True)

    diff = (run().float() - out.float()).abs().max().item()
    return time_ms(run), diff, "flex_attention (compiled)"


def phase_flash(flash_attention, attention_ref, attention, counters, card):
    print("[flash] flash_attention against attention_ref on the card")
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for name, shape, kw in FLASH_GRID:
            q, k, v = flash_inputs(shape, dtype, 0)
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                       rtol=tol, msg=lambda m: f"{name}: {m}")
            dead = ~visible(shape[3], shape[4], **kw).any(-1)
            check(bool((out[:, :, dead] == 0).all()),
                  f"{name}: rows that see no key are not zero")
            print(f"[flash]   {str(dtype)[6:]:8s} {name:16s} "
                  f"max_abs_err={err:.3e}" + (f" ({int(dead.sum())} rows "
                                              "see no key: exact zeros)"
                                              if dead.any() else "") + " ok")

    # the main path: ops.attention at every full-width shape, counts from 0
    inputs = [flash_inputs(shape, torch.bfloat16, i)
              for i, (_, shape, _) in enumerate(FLASH_MODEL)]
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    outs = [attention(*x, **kw) for x, (_, _, kw) in zip(inputs, FLASH_MODEL)]
    torch.cuda.synchronize()
    launches = flash_attention.launches
    check(launches == len(FLASH_MODEL) and all(
        fn.launches == 0 for fn in counters if fn is not flash_attention),
        f"ops.attention launched flash_attention {launches} times for "
        f"{len(FLASH_MODEL)} calls")
    print(f"[flash] ops.attention (impl auto) at {len(FLASH_MODEL)} "
          f"full-width shapes: flash_attention launches={launches}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = {}
    for (name, shape, kw), (q, k, v), out in zip(FLASH_MODEL, inputs, outs):
        B, H, K, Sq, Sk, D, Dv = shape
        # the exact answer for these bf16 inputs: attention_ref in f32
        # (attention_ref on the bf16 tensors is this, rounded to bf16)
        f32 = [t.float() for t in (q, k, v)]
        exact = attention_ref(*f32, **kw)
        err = (out.float() - exact.to(out.dtype).float()).abs().max().item()
        err_exact = (out.float() - exact).abs().max().item()
        torch.testing.assert_close(out.float(), exact, atol=FLASH_ATOL,
                                   rtol=FLASH_RTOL,
                                   msg=lambda m: f"{name}: {m}")
        # control: the same limit must fail against the window edge moved
        # one 64-key tile nearer (the last rows lose up to 64 keys)
        ctl = attention_ref(*f32, **{**kw, "window": (kw.get("window")
                                                      or Sk) - 64})
        off = ~torch.isclose(out.float(), ctl, atol=FLASH_ATOL,
                             rtol=FLASH_RTOL)
        n_off, ctl_err = int(off.sum()), (out.float() - ctl).abs().max().item()
        check(n_off > 0, f"{name}: the tight limit passes a window edge one "
                         "tile off")
        del exact, ctl, off, f32
        ms = time_ms(lambda: flash_attention(q, k, v, **kw))
        dev = device_ms(lambda: flash_attention(q, k, v, **kw),
                        ("flash_attention_bf16_kernel",))[0]
        plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), reps=10)
        torch.cuda.empty_cache()
        if kw.get("softcap") is not None:
            lib_ms, lib_diff, lib_name = flex_ms(q, k, v, out, kw)
        else:
            if kw.get("window") is not None:
                lib = dict(attn_mask=visible(Sq, Sk, **kw))
            elif kw.get("causal", True):
                lib = dict(is_causal=True)        # Sq == Sk: top-left aligned
            else:
                lib = {}
            lib.update(scale=kw.get("scale"), enable_gqa=True)
            lib_diff = (sdpa(q, k, v, **lib).float()
                        - out.float()).abs().max().item()
            lib_ms = time_ms(lambda: sdpa(q, k, v, **lib))
            lib_name = "scaled_dot_product_attention"
        b = flash_bound(shape, kw, q.element_size())
        rec[name] = dict(shape=f"B={B} H={H} K={K} Sq={Sq} Sk={Sk} D={D} "
                               f"Dv={Dv} {kw or 'causal'} bf16",
                         max_abs_err=err, max_abs_err_f32=err_exact, ms=ms,
                         device_ms=dev, plain_ms=plain_ms,
                         bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                         library_ms=lib_ms,
                         library=lib_name, gflop=b["gflop"],
                         tflops=b["gflop"] / dev,
                         x_library=ms / lib_ms)
        print(f"[flash] {name}: {rec[name]['shape']}: max_abs_err="
              f"{err:.3e} against attention_ref, {err_exact:.3e} against its "
              f"f32 answer (limit {FLASH_ATOL:g} + {FLASH_RTOL:g}|ref|: "
              f"one bf16 rounding); control (window edge one tile off) "
              f"max_abs_err={ctl_err:.3e}, {n_off} elements over the limit: "
              f"fails as it must; device={dev:.4f}ms call={ms:.4f}ms "
              f"(wrapper + kernel) "
              f"bound={b['bound_ms']:.4f}ms ({b['bound_by']}: "
              f"{b['gflop']:.1f} GFLOP, {b['mbytes']:.1f} MB) "
              f"plain={plain_ms:.4f}ms library={lib_ms:.4f}ms ({lib_name}; "
              f"max |diff| to the kernel {lib_diff:.3e}); "
              f"{rec[name]['tflops']:.1f} TFLOP/s of the function's flops "
              f"(device time), call {rec[name]['x_library']:.2f}x the "
              f"library's call time and {FLASH_EARLIER_MS[name] / ms:.2f}x "
              f"faster than the CUDA-core design's {FLASH_EARLIER_MS[name]}ms")
        del q, k, v, out
        torch.cuda.empty_cache()
    del inputs, outs
    torch.cuda.empty_cache()
    print(f"[flash] flash_attention times on {card}")
    return launches, rec


# ---------------------------------------------------------------------------
# Phases 5, 6, 9 and 10: serve at full width, then the lockstep checks
# ---------------------------------------------------------------------------

def run_serve(cfg, params, waves, kernel_fn, tag="serve", capture_step=True,
              backend=None, **kw):
    """The main path: ``serve`` over ``waves`` with every kernel's launch
    count set to 0 just before and read just after (``kernel_fn``'s is
    returned; the others must stay 0); every prefill dispatch and decode
    step of the engine is watched for non-finite logits (a decode step's
    after its replay, outside the graph). The decode step is captured
    (``capture_step``, the engine's default) or run eagerly, on a compile
    cache of its own (freed with the engine) — ``backend``'s, where one is
    given; ``eng.capture`` notes the step's source and the cache's capture
    and replay counts."""
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.serve import serve
    from repro_torch.serve import engine as engine_mod
    counters = (paged_attention, ssd_scan, flash_attention)
    finite = []
    saved = engine_mod.paged_prefill, engine_mod.PagedServeEngine._decode

    def prefill(*args, **kw):
        logits, pool = saved[0](*args, **kw)
        finite.append(bool(torch.isfinite(logits).all()))
        return logits, pool

    def decode(self, *args, **kw):
        logits = saved[1](self, *args, **kw)
        finite.append(bool(torch.isfinite(logits).all()))
        return logits

    engine_mod.paged_prefill, engine_mod.PagedServeEngine._decode = (
        prefill, decode)
    if backend is None:
        backend = ArrayBackend(cache=CompileCache(), device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for fn in counters:
            fn.launches = 0
        paged_attention.routes = dict.fromkeys(paged_attention.routes, 0)
        ssd_scan.routes = dict.fromkeys(ssd_scan.routes, 0)
        eng = serve(cfg, params, waves, device=DEV, backend=backend,
                    capture_step=capture_step, **kw)
        torch.cuda.synchronize()
        launches = kernel_fn.launches
        others = {fn.__name__: fn.launches for fn in counters
                  if fn is not kernel_fn}
    finally:
        engine_mod.paged_prefill, engine_mod.PagedServeEngine._decode = saved
    st = backend.cache.stats
    eng.capture = dict(source=eng.stats["compile_sources"]["step"],
                       captures=st["captures"], replays=st["replays"],
                       t_capture_s=st["t_capture_s"])
    print(f"[{tag}] {cfg.name}: decode step {eng.capture['source']}"
          + (f", {st['captures']} capture ({st['t_capture_s']:.2f}s with "
             f"its warm-up step), {st['replays']} replays of "
             f"{eng.stats['steps']} steps" if capture_step else "")
          + f"; launches of the other kernels {json.dumps(others)}")
    if capture_step:
        check(eng.capture["source"] == "compiled" and st["captures"] == 1
              and st["replays"] == eng.stats["steps"] - 1,
              f"decode step not replayed from one graph: {eng.capture}")
    check(not any(others.values()), f"other kernels launched: {others}")
    check(all(r.done and len(r.out) == r.max_new for w in waves for r in w),
          "a request did not finish")
    eng.pool.check()
    check(finite and all(finite), "non-finite logits")
    return eng, launches


def serve_numbers(eng, wave, launches):
    from repro_torch.core.telemetry import class_summary
    st = eng.stats
    summ = class_summary(eng.records[-len(wave):])["interactive"]
    n_tok = sum(len(r.out) for r in wave)
    return dict(launches=launches, ttft_p50_s=summ["p50_ttft_s"],
                tpot_p50_s=summ["p50_tpot_s"], wall_s=st["wall_s"],
                tokens=n_tok, tokens_per_s=n_tok / st["wall_s"],
                peak_bytes=torch.cuda.max_memory_allocated(),
                prefix_hits=st["prefix_hits"], steps=st["steps"],
                prefill_dispatches=st["prefill_dispatches"],
                step=getattr(eng, "capture", None))


def print_serve(tag, wave, out, card):
    print(f"[{tag}] {len(wave)} requests, {out['tokens']} tokens in "
          f"{out['wall_s']:.3f}s: TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms, "
          f"TPOT p50 {out['tpot_p50_s'] * 1e3:.2f} ms, "
          f"{out['tokens_per_s']:.1f} tokens/s; peak memory "
          f"{out['peak_bytes'] / 2**30:.2f} GiB; pool check clean; "
          f"all logits finite; on {card}")


def greedy(logits):
    """(steps, B, V) logits -> greedy tokens and top-2 gaps, on the host."""
    top2 = torch.topk(logits, 2, dim=-1)[0]
    return (logits.argmax(-1).cpu().numpy(),
            (top2[..., 0] - top2[..., 1]).cpu().numpy())

def phase_serve(cfg, params, paged_attention, card, capacity=512,
                tag="serve", routes=("split", "tile"), capture_step=True):
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab, 64)
    first = [Request(rid=0, prompt=system.copy(), max_new=16)]
    wave = ([Request(rid=1 + i, prompt=np.concatenate(
        [system, rng.integers(1, cfg.vocab, 64)]), max_new=16)
        for i in range(4)]
        + [Request(rid=5 + i, prompt=rng.integers(1, cfg.vocab, 128),
                   max_new=16) for i in range(4)])
    eng, launches = run_serve(cfg, params, [first, wave], paged_attention,
                              tag=tag, slots=4, capacity=capacity,
                              page_size=16, kernel="paged",
                              prefix_sharing=True, capture_step=capture_step)
    routes = check_paged_routes(eng, launches, paged_attention, cfg, tag,
                                *routes)
    check(eng.stats["prefix_hits"] > 0, "no prefix hit")
    out = serve_numbers(eng, wave, launches)
    out.update(routes=routes, outs=[list(r.out) for r in first + wave])
    print_serve(tag, wave, out, card)
    return out


def check_paged_routes(eng, launches, paged_attention, cfg, tag,
                       decode="split", prefill="tile"):
    """Every attention layer launched the paged kernel once a prefill
    dispatch and once a decode step: every decode step on the ``decode``
    route, every prefill dispatch on ``prefill``. Returns the routes."""
    st = eng.stats
    dispatches = st["prefill_dispatches"] + st["steps"]
    layers = cfg.n_layers
    print(f"[{tag}] paged_attention launches={launches} = {layers} layers x "
          f"({st['prefill_dispatches']} prefill dispatches "
          f"[{st['prefix_hits']} warm] + {st['steps']} decode steps)")
    check(launches == layers * dispatches,
          f"launches {launches} != {layers} x {dispatches}")
    routes = dict(paged_attention.routes)
    want = dict.fromkeys(routes, 0)
    want[decode] += layers * st["steps"]
    want[prefill] += layers * st["prefill_dispatches"]
    print(f"[{tag}] paged_attention routes {json.dumps(routes)}: every "
          f"decode step on {decode}, every prefill dispatch on {prefill}")
    check(routes == want, f"routes {routes}, expected {want}")
    return routes


def phase_lockstep(cfg, params, lens=(128,) * 4, npps=32, P=128,
                   tag="lockstep", graph=False):
    """From one set of params, ``paged_prefill`` of one batch of prompts
    (``lens``, right-padded to a whole page) + 4 greedy decode steps with
    kernel "paged" and with kernel "gather", each into a fresh pool over
    permuted page tables: greedy tokens agree up to the first near-tie.
    With ``graph``: 8 steps, both on kernel "paged", the engine's decode
    step run eagerly and captured (one graph, replayed), the logits'
    largest difference printed.
    Each slot holds its prompt's pages and one for the decode rows at the
    head of an ``npps``-entry table (a dead tail of -1 entries past them,
    as ``[serve]``'s 32-entry tables at capacity 512) in a pool of ``P``
    pages; ``npps`` / ``P`` None size both to the live pages alone."""
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.models.lm import (paged_cache_init, paged_decode_step,
                                       paged_prefill)
    ps, steps = 16, (8 if graph else 4)
    B, S = len(lens), -(-max(lens) // ps) * ps
    live = S // ps + 1                    # one page for the decode rows
    npps, P = npps or live, P or B * live
    r = np.random.default_rng(1)
    perm = r.permutation(P)
    tables = np.full((B, npps), -1, np.int32)
    for b in range(B):
        tables[b, :live] = perm[live * b:live * (b + 1)]
    tables = torch.from_numpy(tables).to(DEV)
    toks = torch.from_numpy(r.integers(1, cfg.vocab, (B, S)).astype(
        np.int32)).to(DEV)
    lens = torch.tensor(lens, dtype=torch.int32, device=DEV)
    runs, stacks = {}, {}
    live = torch.ones((B,), dtype=torch.bool, device=DEV)
    modes = ("eager", "graph") if graph else ("gather", "paged")
    for mode in modes:
        kernel = "paged" if graph else mode

        def step_fn(p, kv, tb, t, po, lv):
            return paged_decode_step(p, kv, tb, t, po, cfg, live=lv,
                                     kernel=kernel)[0]

        pool = paged_cache_init(cfg, B, P, ps, DEV)
        lg, pool = paged_prefill(params, pool, tables, toks, lens, cfg,
                                 kernel=kernel)
        logits = [lg[:, 0].float()]
        pos = lens[:, None].clone()
        step = step_fn
        if mode == "graph":
            step, _ = ArrayBackend(cache=CompileCache()).compile(
                step_fn, (params, pool, tables, pos, pos, live),
                bind_argnums=(0, 1))
        for _ in range(steps):
            t = torch.argmax(logits[-1], -1)[:, None].to(torch.int32)
            lg = step(params, pool, tables, t, pos, live)
            logits.append(lg[:, 0].float())
            pos = pos + 1
        lg = torch.stack(logits)                            # (steps+1, B, V)
        check(bool(torch.isfinite(lg).all()), f"{mode}: non-finite logits")
        runs[mode] = greedy(lg)
        stacks[mode] = lg
        if mode == "graph":
            check(step.replays == steps - 1,
                  f"{tag}: {step.replays} replays of {steps} steps")
        del pool
    (a, gaps), (b, _) = runs[modes[0]], runs[modes[1]]
    d = float((stacks[modes[0]] - stacks[modes[1]]).abs().max())
    for s in range(B):
        diff = np.nonzero(a[:, s] != b[:, s])[0]
        if diff.size:
            check(gaps[diff[0], s] < ULP_TIE,
                  f"slot {s}: tokens diverge at step {diff[0]} with top-2 "
                  f"gap {gaps[diff[0], s]:.4f} >= {ULP_TIE}")
    print(f"[{tag}] {cfg.name}: {modes[1]} vs {modes[0]}, prefill of "
          f"prompts {lens.tolist()} (padded to {S}) + {steps} decode steps: "
          f"tokens equal at {int((a == b).sum())}/{a.size} positions (first "
          f"divergence only at a near-tie); logits max |diff| {d:.3e}; ok")
    return dict(tokens_equal=int((a == b).sum()), tokens=int(a.size),
                logits_max_abs_diff=d)


# ---------------------------------------------------------------------------
# The launch path: LLMapReduce, its backends, the Wine ABI
# ---------------------------------------------------------------------------

LAUNCH_N, LAUNCH_WAVE, LAUNCH_SERIAL = 16384, 8192, 256


def launch_app(x):
    """The launched application: one instance's (64,) item -> a scalar."""
    return (x * x).sum()


def phase_launch(card, counters):
    """The paper's headline on the card: 16,384 instances of ``launch_app``
    over (16,384, 64) f32 through ``LLMapReduce`` — the array backend (two
    waves of 8,192), the pipelined backend (depth 2) and autoscaled waves,
    each cold (a fresh compile cache: capture) and then warm (the same
    cache: replays, every wave ``memory``); the serial VM baseline (a new
    executable, warm-up and capture per instance) on 256. Every output is
    held against numpy's float64 answer (relative 1e-5) and must come back
    from the card."""
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.llmr import LLMapReduce
    x = np.random.default_rng(0).standard_normal((LAUNCH_N, 64)).astype(
        np.float32)
    want = (x.astype(np.float64) ** 2).sum(-1)
    runs = (("array", dict(scheduler="array", wave_size=LAUNCH_WAVE),
             LAUNCH_N),
            ("pipelined", dict(scheduler="pipelined", wave_size=LAUNCH_WAVE),
             LAUNCH_N),
            ("auto", dict(scheduler="array", wave_size="auto"), LAUNCH_N),
            ("serial", dict(scheduler="serial"), LAUNCH_SERIAL))
    for fn in counters:
        fn.launches = 0
    out = {}
    for name, kw, n in runs:
        cache = CompileCache()
        reads = []
        for when in ("cold", "warm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, report = LLMapReduce(cache=cache, **kw).map_reduce(
                launch_app, x[:n])
            got = torch.stack(res) if isinstance(res, list) else res
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(got.device.type == "cuda" and got.shape == (n,),
                  f"[launch] {name}: outputs {tuple(got.shape)} on "
                  f"{got.device}")
            err = float(np.max(np.abs(got.cpu().double().numpy() - want[:n])
                               / np.abs(want[:n])))
            check(err <= 1e-5, f"[launch] {name}: relative error {err:.2e}")
            levels = {k: sum(r.levels()[k] for r in report.records)
                      for k in ("sched", "node", "core")}
            reads.append(dict(
                wall_s=wall, instances_per_s=n / wall, waves=report.waves,
                t_schedule_s=sum(r.t_schedule for r in report.records),
                sources=[r.extra.get("compile_source")
                         for r in report.records],
                levels=levels, max_rel_err=err))
            r = reads[-1]
            print(f"[launch] {name} {when}: {n} instances in {wall:.4f}s "
                  f"({r['instances_per_s']:.0f} instances/s), {r['waves']} "
                  f"waves, t_schedule {r['t_schedule_s']:.4f}s, sources "
                  f"{sorted(set(map(str, r['sources'])))}, levels "
                  f"{json.dumps({k: round(v, 6) for k, v in levels.items()})}"
                  f", max rel err {err:.2e}")
        if name != "serial":
            check(all(s == "memory" for s in reads[1]["sources"]),
                  f"[launch] {name}: the warm launch compiled again: "
                  f"{reads[1]['sources']}")
        out[name] = dict(n=n, cold=reads[0], warm=reads[1],
                         captures=cache.stats["captures"])
    others = {fn.__name__: fn.launches for fn in counters}
    check(not any(others.values()), f"[launch] kernels launched: {others}")
    print(f"[launch] warm array launch: {out['array']['warm']['wall_s']:.4f}s"
          f" for {LAUNCH_N} instances (cold {out['array']['cold']['wall_s']:.4f}"
          f"s, t_schedule {out['array']['cold']['t_schedule_s']:.4f}s cold -> "
          f"{out['array']['warm']['t_schedule_s']:.4f}s warm); serial "
          f"{out['serial']['warm']['instances_per_s']:.0f} instances/s; the "
          f"app launches none of the port's kernels; on {card}")
    return out


# ---------------------------------------------------------------------------
# The distributed fabric: scheduler -> node -> core on one card
# ---------------------------------------------------------------------------

DIST_NODES, DIST_THROTTLE_S, DIST_GATE_WAVE = 4, 0.05, 2048
# the health scorer floors its scale at 1e-4 s an instance, and flags an
# outlier 6 scales above the fleet's median: 16-instance shards put a
# 0.05 s throttle at ~3 ms an instance
DIST_HEALTH_WAVE = 64


def _dist_reads(report, wall, n):
    """One launch's numbers."""
    from repro_torch.core.telemetry import nodes_rollup, stage_rollup
    return dict(wall_s=wall, instances_per_s=n / wall, waves=report.waves,
                t_schedule_s=sum(r.t_schedule for r in report.records),
                bytes_on_wire=stage_rollup(report.records)["bytes_on_wire"],
                node_failures=report.node_failures,
                nodes={nid: agg["instances"] for nid, agg in
                       nodes_rollup(report.records).items()})


def _dist_run(name, be, x, want, name_card):
    """``LLMapReduce`` over the fabric ``be``: 16,384 instances cold (each
    node captures its graphs) and warm (replays); every output within 1e-5
    of numpy's and on the card, every shard's record naming the card."""
    from repro_torch.core.llmr import LLMapReduce
    from repro_torch.examples.massive_launch import app
    n = x.shape[0]
    reads = {}
    for when in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, report = LLMapReduce(wave_size=LAUNCH_WAVE,
                                  backend=be).map_reduce(app, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(got.device.type == "cuda" and got.shape == (n,),
              f"[dist] {name}: outputs {tuple(got.shape)} on {got.device}")
        err = float(np.max(np.abs(got.cpu().double().numpy() - want)
                           / np.abs(want)))
        check(err <= 1e-5, f"[dist] {name}: relative error {err:.2e}")
        nrs = [nr for r in report.records if not r.superseded
               for nr in r.extra.get("node_records", ())]
        devices = {nr["device"] for nr in nrs}
        check(nrs and all(d and d.startswith("cuda") and name_card in d
                          for d in devices),
              f"[dist] {name}: shards ran on {devices}")
        r = reads[when] = _dist_reads(report, wall, n)
        r["max_rel_err"] = err
        r["captures_by_node"] = {}
        for nr in nrs:
            if nr["compile_source"] == "compiled":
                c = r["captures_by_node"]
                c[nr["node"]] = c.get(nr["node"], 0) + 1
        print(f"[dist] {name} {when}: {n} instances in {wall:.4f}s "
              f"({r['instances_per_s']:.0f} instances/s), {r['waves']} "
              f"waves over nodes {json.dumps(r['nodes'])}, t_schedule "
              f"{r['t_schedule_s']:.4f}s, {r['bytes_on_wire']:,} staged "
              f"bytes on the wire, captures {json.dumps(r['captures_by_node'])}"
              f", max rel err {err:.2e}, on {sorted(devices)}")
    return reads


def _graph_pool_bytes(cache) -> int:
    """Bytes the card holds reserved for the graphs of ``cache``: the
    segments of their private memory pools."""
    pools = {g.graph.pool() for exe in cache._mem.values()
             for g in getattr(exe, "graphs", {}).values()}
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) in pools)


def _thread_fabric(transport="inproc", **kw):
    from repro_torch.dist import DistributedBackend
    kw.setdefault("heartbeat_s", 0.02)
    kw.setdefault("heartbeat_timeout_s", 5.0)
    return DistributedBackend(n_nodes=DIST_NODES, device=DEV,
                              transport=transport, **kw)


def phase_dist_gates(x, want, name_card):
    """The fabric's failure and measurement gates on thread nodes: a node
    killed mid-wave (the wave completes, correct, with ``failover``
    recorded), a node throttled to 0.05 s a shard getting a smaller shard
    within 3 waves, and ``health_verdicts()`` naming it ``outlier`` and the
    others ``healthy``."""
    import threading
    from repro_torch.core.llmr import LLMapReduce
    from repro_torch.examples.massive_launch import app
    out = {}
    n = 4 * DIST_GATE_WAVE
    xs, ws = x[:n], want[:n]
    # a node killed mid-wave: paused (alive, taking no work) so its shard
    # is in flight when it dies; the handle fails it over on lease expiry
    be = _thread_fabric(heartbeat_timeout_s=0.5)
    try:
        be.launch(app, xs, n)                       # capture on each node
        victim = be.agents["node1"]
        victim.pause()
        time.sleep(0.1)               # its worker sees the pause first
        handle = be.dispatch(app, xs, n)
        killer = threading.Timer(0.05, victim.kill)
        killer.start()
        got, rec = handle.result()
        killer.join()
        err = float(np.max(np.abs(got.cpu().double().numpy() - ws)
                           / np.abs(ws)))
        moved = rec.extra.get("failover", [])
        check(err <= 1e-5, f"[dist] kill: relative error {err:.2e}")
        check(moved and all(m["from"] == "node1" for m in moved),
              f"[dist] kill: no failover recorded: {rec.extra.keys()}")
        out["kill"] = dict(failover=moved, max_rel_err=err,
                           t_wave_s=rec.t_spawn + rec.t_stage)
        print(f"[dist] kill: node1 killed mid-wave; the wave of {n} "
              f"completed in {out['kill']['t_wave_s']:.3f}s with failover "
              f"{json.dumps(moved)}, max rel err {err:.2e}")
    finally:
        be.close()
    # measured re-weighting: node1 slowed to 0.05 s a shard, one wave at
    # a time so each split sees the last wave's measurement
    be = _thread_fabric(depth=1)
    try:
        be.agents["node1"].throttle(DIST_THROTTLE_S)
        _, rep = LLMapReduce(wave_size=DIST_GATE_WAVE,
                             backend=be).map_reduce(app, x[:2 * n])
        shares = [(r.nodes().get("node1", {}).get("n", 0),
                   min(v["n"] for k, v in r.nodes().items()
                       if k != "node1")) for r in rep.records]
        print(f"[dist] throttle: node1 at {DIST_THROTTLE_S} s a shard; "
              f"(node1, smallest other) shard sizes by wave {shares}")
        check(any(slow < fast for slow, fast in shares[1:4]),
              f"[dist] throttle: node1's shard did not shrink within 3 "
              f"waves: {shares}")
        out["reweight"] = dict(shares=shares,
                               weights=rep.records[-1].extra.get(
                                   "shard_weights"))
    finally:
        be.close()
    # health: equal shards (no re-weighting) so node1's walls stand out;
    # a first wave captures every node's graph before the evidence counts
    be = _thread_fabric(depth=1, reweight=False)
    try:
        llmr = LLMapReduce(wave_size=DIST_HEALTH_WAVE, backend=be)
        llmr.map_reduce(app, x[:DIST_HEALTH_WAVE])
        be.agents["node1"].throttle(DIST_THROTTLE_S)
        _, rep = llmr.map_reduce(app, x[:10 * DIST_HEALTH_WAVE])
        verdicts = be.health_verdicts()
        print(f"[dist] health: verdicts {json.dumps(verdicts)}; report "
              f"{json.dumps(rep.health)}")
        check(verdicts.get("node1") == "outlier"
              and all(verdicts.get(f"node{i}") == "healthy"
                      for i in (0, 2, 3)),
              f"[dist] health: {verdicts}")
        out["health"] = verdicts
    finally:
        be.close()
    return out


def phase_dist(card, counters, launch):
    """The paper's launch tree with all three levels real, on one card:
    16,384 instances of ``launch_app``'s function (the example's ``app``:
    module-level, so process and remote nodes can unpickle it) over
    (16,384, 64) f32 through ``LLMapReduce(backend=make_backend("dist",
    ...))`` in waves of 8,192: (a) 4 thread nodes over ``inproc``, (b) 4
    thread nodes over ``socket``, (c) 2 process nodes over ``socket``, (d)
    one remote node (``python -m repro_torch.dist.node --connect``)
    joining a socket fabric armed with a secret — each cold and warm,
    every output within 1e-5 relative of numpy's, every shard's record
    naming the card. A repeat launch over ``socket`` puts under 10% of the
    first one's staged bytes on the wire; each process node and the remote
    node complete shards; then ``phase_dist_gates``. No kernel of the port
    runs."""
    import threading
    from repro_torch.core.backend import make_backend
    from repro_torch.dist import DistributedBackend
    name_card = torch.cuda.get_device_name(0)
    root = Path(__file__).resolve().parent
    x = np.random.default_rng(0).standard_normal((LAUNCH_N, 64)).astype(
        np.float32)
    want = (x.astype(np.float64) ** 2).sum(-1)
    for fn in counters:
        fn.launches = 0
    out = {}
    # the remote node's fabric listens first; the node and the process
    # fabric boot while the thread fabrics run
    secret_dir = root / "build" / "dist"
    secret_dir.mkdir(parents=True, exist_ok=True)
    secret_file = secret_dir / "secret"
    secret_file.write_bytes(os.urandom(16).hex().encode() + b"\n")
    remote_be = DistributedBackend(
        nodes=[], device=DEV, transport="socket",
        transport_options={"secret": secret_file.read_bytes().strip()},
        heartbeat_timeout_s=5.0)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    t_remote = time.perf_counter()
    remote = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.dist.node", "--connect",
         f"127.0.0.1:{remote_be.transport.address[1]}", "--node-id",
         "remote0", "--secret-file", str(secret_file), "--heartbeat-s",
         "0.05", "--device", DEV, "--peer-bind-host", "127.0.0.1",
         "--peer-advertise-host", "127.0.0.1"], env=env, cwd=str(root))
    proc_box = {}

    def boot_processes():
        try:
            t0 = time.perf_counter()
            proc_box["be"] = make_backend(
                "dist", device=DEV, n_nodes=2, node_mode="process",
                transport="socket", heartbeat_timeout_s=5.0)
            proc_box["t"] = time.perf_counter() - t0
        except BaseException as err:      # noqa: BLE001 — raised below
            proc_box["err"] = err

    booter = threading.Thread(target=boot_processes)
    booter.start()
    be = None
    try:
        for name, tr in (("thread-inproc", "inproc"),
                         ("thread-socket", "socket")):
            be = make_backend("dist", device=DEV, n_nodes=DIST_NODES,
                              transport=tr, heartbeat_timeout_s=5.0)
            reads = _dist_run(name, be, x, want, name_card)
            reads["reserved_bytes_by_node"] = {
                nid: _graph_pool_bytes(a.backend.cache)
                for nid, a in be.agents.items()}
            reads["captures_by_node_cache"] = {
                nid: a.backend.cache.stats["captures"]
                for nid, a in be.agents.items()}
            print(f"[dist] {name}: graph pools reserved by node (bytes) "
                  f"{json.dumps(reads['reserved_bytes_by_node'])}; captures "
                  f"{json.dumps(reads['captures_by_node_cache'])}")
            out[name] = reads
            be.close()
            be = None
        cold = out["thread-socket"]["cold"]["bytes_on_wire"]
        warm = out["thread-socket"]["warm"]["bytes_on_wire"]
        print(f"[dist] thread-socket: repeat launch {warm:,} staged bytes "
              f"on the wire against {cold:,} for the first "
              f"({warm / max(cold, 1):.4f}x)")
        check(cold > 0 and warm < 0.1 * cold,
              f"[dist] repeat wave bytes {warm} vs first {cold}")
        booter.join()
        if "err" in proc_box:
            raise proc_box["err"]
        be = proc_box.pop("be")
        reads = _dist_run("process-socket", be, x, want, name_card)
        boot = {nid: a.alive_s for nid, a in be.agents.items()}
        reads["alive_s"] = boot
        reads["construct_s"] = proc_box["t"]
        print(f"[dist] process-socket: spawn to alive (first heartbeat) by "
              f"node {json.dumps(boot)} s (the fabric built in "
              f"{proc_box['t']:.2f}s, under the thread runs)")
        for nid in be.agents:
            check(reads["cold"]["nodes"].get(nid, 0) > 0
                  and reads["warm"]["nodes"].get(nid, 0) > 0,
                  f"[dist] process node {nid} completed no shard: "
                  f"{reads['cold']['nodes']}")
        out["process-socket"] = reads
        be.close()
        be = None
        deadline = time.perf_counter() + 120.0
        while "remote0" not in remote_be.agents:
            check(remote.poll() is None, "[dist] the remote node died")
            check(time.perf_counter() < deadline,
                  "[dist] the remote node never joined")
            time.sleep(0.05)
        t_join = time.perf_counter() - t_remote
        reads = _dist_run("remote-socket", remote_be, x, want, name_card)
        reads["alive_s"] = t_join
        check(reads["cold"]["nodes"].get("remote0", 0) == LAUNCH_N,
              f"[dist] the remote node's shards: {reads['cold']['nodes']}")
        print(f"[dist] remote-socket: start to alive (joined through the "
              f"HMAC handshake) {t_join:.2f}s, under the runs before it")
        out["remote-socket"] = reads
    finally:
        booter.join()
        for fabric in (be, proc_box.get("be"), remote_be):
            if fabric is not None:
                fabric.close()
        remote.terminate()
        try:
            remote.wait(timeout=30)
        except subprocess.TimeoutExpired:
            remote.kill()
            remote.wait(timeout=30)
    out["gates"] = phase_dist_gates(x, want, name_card)
    others = {fn.__name__: fn.launches for fn in counters}
    check(not any(others.values()), f"[dist] kernels launched: {others}")
    arr = launch["array"]
    print(f"[dist] warm instances/s: "
          + ", ".join(f"{k} {v['warm']['instances_per_s']:.0f}"
                      for k, v in out.items() if k != "gates")
          + f"; [launch] array backend alone: warm "
          f"{arr['warm']['instances_per_s']:.0f} instances/s, t_schedule "
          f"{arr['warm']['t_schedule_s']:.4f}s (cold "
          f"{arr['cold']['instances_per_s']:.0f}); the app launches none of "
          f"the port's kernels; on {card}")
    return out


def phase_dist_serve(cfg, params, ssd_scan, card, ssm):
    """``[serve-ssm]``'s wave again with ``PagedServeEngine(backend=<a
    2-node DistributedBackend>)``: the engine compiles its decode step
    through the fabric's driver-side cache and replays it there, so the
    SSD kernel stays on the path. Gates: the tokens equal
    ``[serve-ssm]``'s, as many SSD launches, every one on ``tc``."""
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.dist import DistributedBackend
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(3)
    wave = [Request(rid=i, prompt=rng.integers(1, cfg.vocab,
                                               512 if i % 2 == 0 else 192),
                    max_new=16) for i in range(8)]
    fabric = DistributedBackend(n_nodes=2, device=DEV, cache=CompileCache(),
                                heartbeat_timeout_s=5.0)
    try:
        eng, launches = run_serve(cfg, params, [wave], ssd_scan,
                                  tag="dist-serve", slots=4, capacity=1024,
                                  page_size=16, kernel="auto",
                                  backend=fabric)
        routes = dict(ssd_scan.routes)
        nodes = fabric.n_nodes
    finally:
        fabric.close()
    toks = [list(map(int, r.out)) for r in wave]
    same = sum(a == b for a, b in zip(toks, ssm["outs"]))
    print(f"[dist-serve] {cfg.name} over a {nodes}-node fabric: ssd_scan "
          f"launches={launches} (serve-ssm {ssm['launches']}), by route "
          f"{json.dumps(routes)}; {same}/{len(wave)} requests' tokens equal "
          f"serve-ssm's")
    check(launches == ssm["launches"] and routes["tc"] == launches,
          f"[dist-serve] ssd_scan launches {launches} ({routes}) against "
          f"serve-ssm's {ssm['launches']}")
    check(same == len(wave), "[dist-serve] tokens differ from serve-ssm's")
    out = serve_numbers(eng, wave, launches)
    out["routes"] = routes
    print_serve("dist-serve", wave, out, card)
    return out


def _wine_batch(specs, vocab, r, position):
    """One seeded step of inputs for ``specs`` on the card."""
    batch = {}
    for k, v in specs.items():
        if k == "positions":
            batch[k] = torch.full(v.shape, position, dtype=v.dtype)
        elif v.dtype == torch.int32:
            batch[k] = torch.from_numpy(r.integers(1, vocab, v.shape).astype(
                np.int32))
        else:
            batch[k] = torch.from_numpy(r.standard_normal(v.shape).astype(
                np.float32)).to(v.dtype)
    return {k: t.to(DEV) for k, t in batch.items()}


WINE_LOGIT_ATOL = 3e-2          # tests/test_torch_lm.py: LOGIT_ATOL


def phase_wine(card, counters):
    """Every architecture (smoke width) loaded in the prefill, decode and
    train modes through one ``WineAdapter`` and run two steps: the first
    is the warm-up of the capture, the second a replay of the graph. Each
    replay's logits are finite and held against the eager translation on
    the same inputs (decode: two eager ``decode_step`` calls on a copy of
    the instance's rings) within the port's bf16 limit; each train
    replay's loss against an eager instance's from the same seed on the
    same batches (TRAIN_LOSS_RTOL); the SSD-scan kernel's launches over the
    mamba2 / zamba2 prefill and train replays must be > 0. A second
    adapter on the same cache reads ``memory`` for all thirty apps."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.wine import WineAdapter, WineApp
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import lm
    from repro_torch.models.blocks import tree_map
    cache = CompileCache()
    adapter = WineAdapter(backend=ArrayBackend(cache=cache))
    r = np.random.default_rng(4)
    apps = [WineApp(arch=a, mode=m, shape=f"{m}_32k", smoke=True)
            for a in ARCHS for m in ("prefill", "decode")]
    apps += [WineApp(arch=a, smoke=True) for a in ARCHS]   # train, train_4k
    for fn in counters:
        fn.launches = 0
    rows, ssd_replay, ssd_train = {}, {}, {}
    for app in apps:
        t0 = time.perf_counter()
        inst = adapter.load(app)
        specs = adapter.input_specs(app)
        b = [_wine_batch(specs, inst.cfg.vocab, r, i) for i in range(2)]
        if app.mode == "decode":
            params, rings = inst.state
            rings = tree_map(lambda t: t.clone(), rings)
        inst.run(b[0])
        n0 = ssd_scan.launches
        got = inst.run(b[1])
        torch.cuda.synchronize()
        n_ssd = ssd_scan.launches - n0
        if app.mode == "train":
            # an eager instance from the same seed, on the same batches
            eager = adapter._init_state(app, inst.cfg, 0)
            for step in b:
                _, want = inst.raw_fn(eager, step)
            got_l, want_l = float(got["loss"]), float(want["loss"])
            rel = abs(got_l - want_l) / abs(want_l)
            check(math.isfinite(got_l) and rel <= TRAIN_LOSS_RTOL,
                  f"[wine] {app.arch} train: replayed loss {got_l} vs eager "
                  f"{want_l}")
            check(inst.step_fn.replays == 1 and int(
                inst.state["opt"]["step"]) == 2,
                f"[wine] {app.arch} train: {inst.step_fn.replays} replays, "
                f"step {int(inst.state['opt']['step'])}")
            if app.arch in ("mamba2-1.3b", "zamba2-7b"):
                ssd_train[app.arch] = n_ssd
            rows[f"{app.arch}/train"] = dict(
                source=inst.load_report["compile_source"], loss=got_l,
                eager_loss=want_l, rel=rel, ssd_launches_in_replay=n_ssd,
                wall_s=time.perf_counter() - t0)
            print(f"[wine] {app.arch:17s} train   loss {got_l:.6f}: "
                  f"{inst.load_report['compile_source']}, replay vs eager "
                  f"rel {rel:.2e}, SSD launches in the replay {n_ssd}, "
                  f"{time.perf_counter() - t0:.2f}s")
            continue
        if app.mode == "prefill":
            got = got[0]
            want = inst.raw_fn(inst.state, b[1])[0]
        else:
            for step in b:
                want, rings = lm.decode_step(params, rings, step["tokens"],
                                             step["positions"], inst.cfg,
                                             enc_out=step.get("enc_out"))
        diff = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got.float()).all()),
              f"[wine] {app.arch} {app.mode}: non-finite logits")
        check(diff <= WINE_LOGIT_ATOL, f"[wine] {app.arch} {app.mode}: "
              f"replay vs eager max |diff| {diff:.3e}")
        check(inst.step_fn.replays == 1, f"[wine] {app.arch} {app.mode}: "
              f"{inst.step_fn.replays} replays")
        if app.mode == "prefill" and app.arch in ("mamba2-1.3b",
                                                  "zamba2-7b"):
            ssd_replay[app.arch] = n_ssd
        rows[f"{app.arch}/{app.mode}"] = dict(
            source=inst.load_report["compile_source"], max_abs_diff=diff,
            ssd_launches_in_replay=n_ssd,
            wall_s=time.perf_counter() - t0)
        print(f"[wine] {app.arch:17s} {app.mode:7s} {tuple(got.shape)}: "
              f"{inst.load_report['compile_source']}, replay vs eager max "
              f"|diff| {diff:.3e}, SSD launches in the replay {n_ssd}, "
              f"{time.perf_counter() - t0:.2f}s")
    check(all(v > 0 for v in ssd_replay.values()) and len(ssd_replay) == 2,
          f"[wine] SSD launches over the SSM prefill replays {ssd_replay}")
    check(all(v > 0 for v in ssd_train.values()) and len(ssd_train) == 2,
          f"[wine] SSD launches over the SSM train replays {ssd_train}")
    second = WineAdapter(backend=ArrayBackend(cache=cache))
    sources = [second.load(app).load_report["compile_source"] for app in apps]
    check(sources == ["memory"] * len(apps),
          f"[wine] second adapter: {sources}")
    counts = {fn.__name__: fn.launches for fn in counters}
    print(f"[wine] {len(apps)} apps: every replay finite and within "
          f"{WINE_LOGIT_ATOL} of the eager step; SSD launches over the "
          f"mamba2 / zamba2 prefill replays {json.dumps(ssd_replay)} and "
          f"train replays {json.dumps(ssd_train)} (forward + remat "
          f"recompute); train losses replayed within {TRAIN_LOSS_RTOL} of "
          f"eager; a "
          f"second adapter on the cache read memory for all {len(apps)}; "
          f"launches {json.dumps(counts)}; {cache.stats['captures']} "
          f"captures in {cache.stats['t_capture_s']:.2f}s; on {card}")
    return dict(apps=rows, ssd_launches_in_prefill_replays=ssd_replay,
                ssd_launches_in_train_replays=ssd_train,
                launches=counts,
                second_adapter_sources=sorted(set(sources)),
                captures=cache.stats["captures"],
                t_capture_s=cache.stats["t_capture_s"])


def phase_serve_graph(cfg, params, paged_attention, card, eager):
    """``[serve]``'s traffic again with the decode step captured (one graph
    for the run, replayed every step): every replayed step counted on the
    split route, its numbers beside the eager ``[serve]`` reading of the
    same run, its tokens beside ``[serve]``'s, and the gate: a lockstep of
    the captured step against eager ``paged_decode_step`` calls."""
    out = phase_serve(cfg, params, paged_attention, card, tag="serve-graph")
    same = sum(a == b for x, y in zip(out["outs"], eager["outs"])
               for a, b in zip(x, y))
    total = sum(len(x) for x in out["outs"])
    print(f"[serve-graph] {cfg.name}: graph vs eager step (one run): TTFT "
          f"p50 {out['ttft_p50_s'] * 1e3:.1f} vs "
          f"{eager['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
          f"{out['tpot_p50_s'] * 1e3:.2f} vs {eager['tpot_p50_s'] * 1e3:.2f} "
          f"ms, {out['tokens_per_s']:.1f} vs {eager['tokens_per_s']:.1f} "
          f"tokens/s; capture {out['step']['t_capture_s']:.2f}s (with its "
          f"warm-up step); peak memory {out['peak_bytes'] / 2**30:.2f} vs "
          f"{eager['peak_bytes'] / 2**30:.2f} GiB; served tokens equal to "
          f"[serve]'s at {same}/{total}")
    out["tokens_equal_to_eager_serve"] = [same, total]
    out["lockstep"] = phase_lockstep(cfg, params, tag="lockstep-graph",
                                     graph=True)
    return out


def count_calls(module, name, calls):
    """Wrap ``module.name`` to append to ``calls``; returns the original."""
    fn = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    setattr(module, name, wrapper)
    return fn


def phase_blocked(cfg, params, card, S=8448, steps=4):
    """The model's blocked attention path at qwen3-14b's full width.

    (a) ``attn_core`` at one layer's shape (B=1, Q=S=8,448 > 8,192 and not a
    multiple of 1,024, so the last block is padded), held against the flat
    path on the kv heads whose logits fit. (b) One 8,448-token prompt
    prefilled cold through ``paged_prefill(kernel="gather")`` — the blocked
    path in every layer — against the same prompt prefilled as 8,192
    gathered tokens (the flat path) plus a 256-token suffix through the
    paged kernel; then ``steps`` greedy decode steps each (kernel "paged").
    Greedy tokens agree up to the first near-tie; the last-position
    logits' difference is printed."""
    from repro_torch.models import attention as att
    from repro_torch.models.lm import (paged_cache_init, paged_decode_step,
                                       paged_prefill)
    a = cfg.groups[0].pattern[0].attn
    H, K, D = a.n_heads, a.n_kv_heads, a.head_dim
    G = H // K
    calls = []
    saved = count_calls(att, "_attn_blocked", calls)
    try:
        g = torch.Generator(device=DEV).manual_seed(5)
        q, k, v = (torch.randn(shape, generator=g, device=DEV).to(
            torch.bfloat16) for shape in ((1, S, H, D), (1, S, K, D),
                                          (1, S, K, D)))
        pos = torch.arange(S, dtype=torch.int32, device=DEV)[None]
        kw = dict(scale=1.0 / math.sqrt(D), causal=True, window=None,
                  cap=None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = att.attn_core(q, k, v, pos, pos, n_kv=K, **kw)
        torch.cuda.synchronize()
        t_blocked = time.perf_counter() - t0
        check(len(calls) == 1, "attn_core did not take the blocked path")
        kh = 2                                  # 2 x 5 heads: 2.9 GB logits
        t0 = time.perf_counter()
        flat = att._attn_flat(q.reshape(1, S, K, G, D)[:, :, :kh],
                              k[:, :, :kh], v[:, :, :kh], pos, pos, **kw)
        torch.cuda.synchronize()
        t_flat = time.perf_counter() - t0
        got = out.reshape(1, S, K, G, D)[:, :, :kh].float()
        err = (got - flat.float()).abs().max().item()
        torch.testing.assert_close(got, flat.float(), atol=2e-2, rtol=2e-2)
        print(f"[blocked] (a) attn_core B=1 Q=S={S} {H}/{K} heads D={D} bf16: "
              f"blocked path ({-(-S // att.KV_BLOCK)} blocks of "
              f"{att.KV_BLOCK}, the last padded) {t_blocked * 1e3:.1f} ms for "
              f"{H} heads; against the flat path on {kh * G} heads "
              f"({t_flat * 1e3:.1f} ms): max_abs_err={err:.3e} (atol/rtol "
              "2e-2) ok")
        del q, k, v, out, flat, got
        torch.cuda.empty_cache()

        # (b) the 8,448-token prompt both ways
        ps, split = 16, att.BLOCKED_THRESHOLD     # the flat path's most
        npps = -(-(S + steps) // ps)
        r = np.random.default_rng(6)
        tables = torch.from_numpy(r.permutation(npps)[None].astype(
            np.int32)).to(DEV)
        toks = torch.from_numpy(r.integers(1, cfg.vocab, (1, S)).astype(
            np.int32)).to(DEV)

        def lens(n):
            return torch.full((1,), n, dtype=torch.int32, device=DEV)

        def decode(pool, lg):
            logits = [lg[:, 0].float()]
            for i in range(steps):
                t = torch.argmax(logits[-1], -1)[:, None].to(torch.int32)
                p = torch.full((1, 1), S + i, dtype=torch.int32, device=DEV)
                lg, pool = paged_decode_step(params, pool, tables, t, p, cfg,
                                             kernel="paged")
                logits.append(lg[:, 0].float())
            return torch.stack(logits)                    # (steps + 1, 1, V)

        calls.clear()
        pool = paged_cache_init(cfg, 1, npps, ps, DEV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lg, pool = paged_prefill(params, pool, tables, toks, lens(S), cfg,
                                 kernel="gather")
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n_blocked = len(calls)
        check(n_blocked == cfg.n_layers,
              f"blocked path taken in {n_blocked} of {cfg.n_layers} layers")
        one = decode(pool, lg)
        del pool, lg
        torch.cuda.empty_cache()

        pool = paged_cache_init(cfg, 1, npps, ps, DEV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, pool = paged_prefill(params, pool, tables[:, :split // ps],
                                toks[:, :split], lens(split), cfg,
                                kernel="gather")
        lg, pool = paged_prefill(params, pool, tables, toks[:, split:],
                                 lens(S - split), cfg, starts=lens(split),
                                 kernel="paged")
        torch.cuda.synchronize()
        t_split = time.perf_counter() - t0
        peak_split = torch.cuda.max_memory_allocated()
        check(len(calls) == n_blocked, "the split prefill took the blocked "
              "path")
        two = decode(pool, lg)
        del pool, lg
        torch.cuda.empty_cache()
    finally:
        att._attn_blocked = saved
    for name, lgs in (("blocked", one), ("split", two)):
        check(bool(torch.isfinite(lgs).all()), f"{name}: non-finite logits")
    (ta, gaps), (tb, _) = greedy(one), greedy(two)
    diff = np.nonzero(ta[:, 0] != tb[:, 0])[0]
    if diff.size:
        check(gaps[diff[0], 0] < ULP_TIE,
              f"tokens diverge at step {diff[0]} with top-2 gap "
              f"{gaps[diff[0], 0]:.4f} >= {ULP_TIE}")
    d0 = (one[0] - two[0]).abs().max().item()
    print(f"[blocked] (b) {cfg.name}, one {S}-token prompt: cold "
          f"paged_prefill(kernel=gather) through the blocked path in "
          f"{n_blocked}/{cfg.n_layers} layers: {t_cold:.2f}s, peak memory "
          f"{peak / 2**30:.2f} GiB; against {split} gathered tokens (flat "
          f"path) + a {S - split}-token suffix through the paged kernel: "
          f"{t_split:.2f}s, peak {peak_split / 2**30:.2f} GiB. Last-position "
          f"logits max |diff| {d0:.3e} on a scale of "
          f"{one[0].abs().max().item():.3f}; greedy tokens equal at "
          f"{int((ta == tb).sum())}/{ta.size} (first divergence only at a "
          f"near-tie); ok, on {card}")
    return dict(attn_core_ms=t_blocked * 1e3, attn_core_max_abs_err=err,
                prefill_blocked_s=t_cold, prefill_blocked_peak_bytes=peak,
                prefill_split_s=t_split, prefill_split_peak_bytes=peak_split,
                last_logits_max_abs_diff=d0,
                tokens_equal=int((ta == tb).sum()), tokens=int(ta.size))


def phase_serve_ssm(cfg, params, ssd_scan, card):
    """mamba2 at full width: 4 prompts of 512 and 4 of 192 tokens,
    interleaved in the queue; exact-length groups put each length in one
    prefill dispatch of 4 slots."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(3)
    wave = [Request(rid=i, prompt=rng.integers(1, cfg.vocab,
                                               512 if i % 2 == 0 else 192),
                    max_new=16) for i in range(8)]
    eng, launches = run_serve(cfg, params, [wave], ssd_scan, tag="serve-ssm",
                              slots=4,
                              capacity=1024, page_size=16, kernel="auto")
    st = eng.stats
    layers = cfg.n_layers
    print(f"[serve-ssm] ssd_scan launches={launches} = {layers} layers x "
          f"{st['prefill_dispatches']} prefill dispatches ({st['steps']} "
          f"decode steps run the recurrence); kernel={eng.kernel}")
    check(launches > 0 and launches == layers * st["prefill_dispatches"],
          f"ssd_scan launches {launches} != {layers} x "
          f"{st['prefill_dispatches']}")
    routes = dict(ssd_scan.routes)
    print(f"[serve-ssm] ssd_scan launches by route {json.dumps(routes)}")
    check(routes["tc"] == launches,
          f"ssd_scan: {launches} launches, {routes['tc']} on the tc route")
    check(st["prefix_hits"] == 0, "an SSM config shared a prefix")
    out = serve_numbers(eng, wave, launches)
    out["routes"] = routes
    out["outs"] = [list(map(int, r.out)) for r in wave]
    print_serve("serve-ssm", wave, out, card)
    return out


def phase_serve_window(cfg, params, paged_attention, card):
    """gemma2-27b at full width: 2 slots of 4,608 rows. A first wave of two
    prompts of 4,200 and 4,150 tokens (one ragged prefill dispatch padded
    to 4,608) whose decode runs past the 4,096 window, then a wave of 1,000
    and 700; 16 generated each. The local layers' window and every layer's
    softcap run inside the paged kernel."""
    from repro_torch.core.telemetry import class_summary
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(7)
    waves = [[Request(rid=rid, prompt=rng.integers(1, cfg.vocab, n),
                      max_new=16) for rid, n in ids]
             for ids in (((0, 4200), (1, 4150)), ((2, 1000), (3, 700)))]
    eng, launches = run_serve(cfg, params, waves, paged_attention,
                              tag="serve-window", slots=2, capacity=4608,
                              page_size=16, kernel="paged")
    routes = check_paged_routes(eng, launches, paged_attention, cfg,
                                "serve-window")
    window = max(b.attn.window or 0 for g in cfg.groups for b in g.pattern)
    last = max(len(r.prompt) + len(r.out) - 2 for r in waves[0])
    check(last >= window, f"decode stopped at {last}, inside the window")
    out = serve_numbers(eng, waves[1], launches)
    out.update(routes=routes, last_decode_position=last,
               first_wave_ttft_p50_s=class_summary(
                   eng.records[:2])["interactive"]["p50_ttft_s"])
    print(f"[serve-window] first wave: TTFT p50 "
          f"{out['first_wave_ttft_p50_s'] * 1e3:.1f} ms (one ragged prefill "
          f"dispatch of 2 x 4,608 tokens); decode ran to position {last}, "
          f"past the {window}-row window")
    print_serve("serve-window", waves[1], out, card)
    return out


def phase_serve_int8(cfg, params, ssd_scan, card):
    """zamba2-7b at full width with its int8 KV cache: 4 slots of 1,024
    rows, prompts of 512, 512, 256 and 192 tokens, 16 generated each (an
    SSM prompt past one 256-token chunk must fill whole chunks: the SSD
    scan asserts it in both packages). Exact-length prefill groups; every
    SSD-scan launch on tc; quantized
    pool leaves take the gather route (the paged kernel does not
    dequantize, as in the reference), so no paged launch."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(8)
    wave = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, n), max_new=16)
            for i, n in enumerate((512, 512, 256, 192))]
    eng, launches = run_serve(cfg, params, [wave], ssd_scan, tag="serve-int8",
                              slots=4, capacity=1024, page_size=16,
                              kernel="auto")
    st = eng.stats
    layers = sum(1 for g in cfg.groups for b in g.pattern
                 if b.ssm is not None for _ in range(g.repeats))
    print(f"[serve-int8] ssd_scan launches={launches} = {layers} Mamba2 "
          f"layers x {st['prefill_dispatches']} prefill dispatches; "
          f"kernel={eng.kernel}; paged_attention launches 0: the int8 pool "
          "leaves take the gather route")
    check(launches == layers * st["prefill_dispatches"],
          f"ssd_scan launches {launches} != {layers} x "
          f"{st['prefill_dispatches']}")
    routes = dict(ssd_scan.routes)
    check(routes["tc"] == launches, f"ssd_scan routes {routes}")
    leaves = [btree["attn"] for gtree in eng.kv for btree in gtree.values()
              if "attn" in btree]
    check(leaves and all(l["k"].dtype == l["v"].dtype == torch.int8
                         and l["k_scale"].dtype == torch.bfloat16
                         for l in leaves), "the pool's k/v are not int8")
    print(f"[serve-int8] pool leaves: k/v {leaves[0]['k'].dtype} "
          f"{tuple(leaves[0]['k'].shape)}, scales {leaves[0]['k_scale'].dtype}"
          f"; ssd_scan routes {json.dumps(routes)}")
    out = serve_numbers(eng, wave, launches)
    out["routes"] = routes
    print_serve("serve-int8", wave, out, card)
    return out


def _ssm_state(pool):
    """Every SSM layer's state, (slots, H, P, N) each, copied."""
    return [st.clone() for gtree in pool for btree in gtree.values()
            if "ssm" in btree for st in btree["ssm"]["state"]]


def _lockstep_ssm_run(cfg, params, toks, steps, dtype):
    """Scan path (prefill through the SSD kernel, then ``steps`` greedy
    decode steps) and recurrence path (the prompt fed one token at a time,
    then the scan path's tokens), with weights and SSM caches in
    ``dtype``. Returns both paths' logits and states, and the recurrence
    wall time."""
    from repro_torch.models.blocks import tree_map
    from repro_torch.models.lm import (paged_cache_init, paged_decode_step,
                                       paged_prefill)
    B, S = toks.shape
    tables = torch.full((B, 1), -1, dtype=torch.int32, device=DEV)
    params = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                      params) if dtype != torch.bfloat16 else params

    def fresh_pool():
        pool = paged_cache_init(cfg, B, 1, 16, DEV)
        return tree_map(lambda a: a.to(torch.promote_types(a.dtype, dtype))
                        if a.is_floating_point() else a, pool)

    def decode(pool, lg, feed):
        logits = [lg[:, 0].float()]
        for k in range(steps):
            t = (torch.argmax(logits[-1], -1) if feed is None
                 else feed[k])[:, None].to(torch.int32)
            pos = torch.full((B, 1), S + k, dtype=torch.int32, device=DEV)
            lg, pool = paged_decode_step(params, pool, tables, t, pos, cfg,
                                         kernel="paged")
            logits.append(lg[:, 0].float())
        return torch.stack(logits)                       # (steps + 1, B, V)

    pool = fresh_pool()
    lg, pool = paged_prefill(params, pool, tables, toks,
                             torch.full((B,), S, dtype=torch.int32,
                                        device=DEV), cfg,
                             slot_ids=list(range(B)), kernel="paged")
    scan_state = _ssm_state(pool)
    scan = decode(pool, lg, None)
    del pool
    t0 = time.perf_counter()
    pool = fresh_pool()
    for i in range(S):
        lg, pool = paged_decode_step(
            params, pool, tables, toks[:, i:i + 1],
            torch.full((B, 1), i, dtype=torch.int32, device=DEV), cfg,
            kernel="paged")
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t0
    rec_state = _ssm_state(pool)
    rec = decode(pool, lg, scan.argmax(-1)[:steps])
    for name, lgs in (("scan", scan), ("recurrence", rec)):
        check(bool(torch.isfinite(lgs).all()), f"{name}: non-finite logits")
    return scan, rec, scan_state, rec_state, t_rec


def phase_lockstep_ssm(cfg, params, B=4, S=512, steps=4):
    """The chunked scan (prefill, through the kernel) against the decode
    recurrence fed the same prompt one token at a time: an independent path
    to the same state and the same logits; after the prompt both paths are
    fed the scan path's greedy tokens for ``steps`` decode steps.

    In float32 (weights, activations and SSM caches) the two paths compute
    one function, so they are held tight: logits within 1e-3 of their
    scale, and greedy tokens equal up to the first near-tie (``ULP_TIE``).
    In bf16, the served model, they round at different points — the
    prefill's causal conv adds its taps in bf16, the decode conv sums its
    window in f32, the products run at other shapes — as the reference's
    two paths do, and 48 layers amplify that: the bf16 gap is printed."""
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab, (B, S)).astype(np.int32)).to(DEV)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        scan, rec, s_state, r_state, t_rec = _lockstep_ssm_run(
            cfg, params, toks, steps, dtype)
        errs = [rel_err(a, b) for a, b in zip(s_state, r_state)]
        step_err = [rel_err(r, c) for r, c in zip(rec, scan)]
        logit_err = rel_err(rec, scan)
        (a, gaps), (b, _) = greedy(scan), greedy(rec)
        first = [(s, k) for s in range(B)
                 for k in np.nonzero(a[:, s] != b[:, s])[0][:1]]
        tag = str(dtype)[6:]
        print(f"[lockstep-ssm] {tag}: {B} prompts of {S} tokens, chunked "
              f"scan (SSD kernel) vs {S} recurrent decode steps "
              f"({t_rec:.1f}s). SSM state after the prompt: rel err layer 0 "
              f"{errs[0]:.3e}, last layer {errs[-1]:.3e}, max "
              f"{max(errs):.3e} over {len(errs)} layers. Logits, last prompt "
              f"token + {steps} steps fed the same tokens: rel err "
              f"{' '.join(f'{e:.2e}' for e in step_err)}, max |diff| "
              f"{(rec - scan).abs().max().item():.3e} on a scale of "
              f"{scan.abs().max().item():.3f}. Greedy picks equal at "
              f"{int((a == b).sum())}/{a.size}; first split: "
              + (", ".join(f"slot {s} step {k} (top-2 gap {gaps[k, s]:.4f})"
                           for s, k in first) or "none"))
        out[tag] = dict(state_rel_err=max(errs), state_rel_err_layer0=errs[0],
                        logit_rel_err=logit_err, step_rel_err=step_err,
                        tokens_equal=int((a == b).sum()), tokens=int(a.size),
                        splits=[[int(s), int(k), float(gaps[k, s])]
                                for s, k in first])
        if dtype == torch.float32:
            check(logit_err < 1e-3,
                  f"lockstep-ssm f32: logits rel err {logit_err:.3e} >= 1e-3")
            for s, k in first:
                check(gaps[k, s] < ULP_TIE,
                      f"lockstep-ssm f32: slot {s} splits at step {k} with "
                      f"top-2 gap {gaps[k, s]:.4f} >= {ULP_TIE}")
            print(f"[lockstep-ssm] float32: logits within 1e-3 (rel err "
                  f"{logit_err:.3e}), tokens equal up to the first near-tie: "
                  "ok")
    return out


def moe_weight_bytes(params) -> int:
    """Bytes of every MoE layer's weights (router, experts, shared)."""
    total = 0

    def walk(tree, inside):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, inside or k == "moe")
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v, inside)
        elif inside:
            total += tree.numel() * tree.element_size()

    walk(params, False)
    return total


def phase_profile(cfg, params, steps=3, S=128, tag="profile", moe=False):
    """Where a full-width decode step's time goes: ``torch.profiler`` over
    ``steps`` steps of 4 slots after an S-token prefill and a warm-up step
    (attention: 9 live pages a slot); device busy share = summed kernel
    time / host wall time. With ``moe``, every ``moe_apply`` call runs in a
    ``record_function`` range, and the kernels launched inside it are
    summed: the MoE layers' device time a step, beside the least time that
    reading every expert's weights takes (the dense dispatch does)."""
    from torch.profiler import record_function
    from repro_torch.models import blocks
    saved = blocks.moe_apply

    def annotated(*args, **kw):
        with record_function("moe_apply"):
            return saved(*args, **kw)

    if moe:
        blocks.moe_apply = annotated
    try:
        return _profile_steps(cfg, params, steps, S, tag, moe)
    finally:
        blocks.moe_apply = saved


HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                     "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
                     "cuLaunchKernelEx", "cudaLaunchKernelExC")


def _profile(step, steps, range_name="moe_apply"):
    """``torch.profiler`` over ``steps`` calls of ``step``: (host wall a
    step in s, {kernel: (device ms a step, launches a step)}, the CPU-side
    runtime calls that put work on the card a step (kernel and graph
    launches, async copies and sets), the ``range_name`` range's device
    ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    kern, host, moe_ms = {}, 0.0, 0.0
    for e in prof.key_averages():
        if e.key == range_name:              # the range, not a kernel
            if e.device_type.name == "CPU":
                moe_ms = getattr(e, "device_time_total", getattr(
                    e, "cuda_time_total", 0)) / steps / 1e3
            continue
        if e.device_type.name == "CPU" and e.key in HOST_LAUNCH_CALLS:
            host += e.count / steps
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type.name == "CUDA":
            kern[e.key] = (dev_us / steps / 1e3, e.count / steps)
    return wall, kern, host, moe_ms


def _profile_steps(cfg, params, steps, S, tag, moe):
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.models.lm import (paged_cache_init, paged_decode_step,
                                       paged_prefill)
    B, ps, npps, P = 4, 16, 32, 128
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
    live = torch.ones((B,), dtype=torch.bool, device=DEV)

    def step_fn(p, kv, tb, tt, po, lv):
        return paged_decode_step(p, kv, tb, tt, po, cfg, live=lv,
                                 kernel="paged")[0]

    # the engine's step: eager, then captured once and replayed
    graph, _ = ArrayBackend(cache=CompileCache()).compile(
        step_fn, (params, pool, tables, t, pos, live), bind_argnums=(0, 1))

    def stepper(fn):
        def step():
            nonlocal t, pos
            lg = fn(params, pool, tables, t, pos, live)
            t = torch.argmax(lg[:, 0], -1)[:, None].to(torch.int32)
            pos = pos + 1
            t.cpu()                          # the engine reads every token
        return step

    out = {}
    for mode, fn in (("eager", step_fn), ("graph", graph)):
        step = stepper(fn)
        step()                               # warm-up (graph: the capture)
        step()
        wall, kern, host, moe_ms = _profile(step, steps)
        busy = sum(ms for ms, _ in kern.values())
        n_kernels = sum(n for _, n in kern.values())
        print(f"[{tag}] {cfg.name} decode step at full width ({B} slots "
              f"after a {S}-token prefill, kernel paged), {mode}: host wall "
              f"{wall * 1e3:.2f} ms, device busy {busy:.2f} ms "
              f"({busy / (wall * 1e3):.1%}), {n_kernels:.0f} kernels a step "
              f"on the card, {host:.0f} launch calls a step from the host")
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])
        for name, (ms, n) in top[:8 if mode == "eager" else 3]:
            print(f"[{tag}]   {ms:8.3f} ms {n:6.0f}x  {name[:90]}")
        paged = {n: v for n, v in kern.items() if "paged_" in n}
        paged_ms = sum(ms for ms, _ in paged.values())
        print(f"[{tag}] paged-attention kernels ({mode}): {paged_ms:.3f} ms "
              f"of device time a step in "
              f"{sum(n for _, n in paged.values()):.0f} launches")
        r = dict(wall_ms=wall * 1e3, busy_ms=busy, kernels=n_kernels,
                 host_launch_calls=host, paged_ms=paged_ms)
        if mode == "eager":
            check(busy > 0, "the profiler saw no device time")
            out.update(r)
            if moe:
                floor = moe_weight_bytes(params) / HBM_BYTES_PER_S * 1e3
                print(f"[{tag}] MoE layers (router, dense one-hot dispatch, "
                      f"every expert's products): {moe_ms:.3f} ms of device "
                      f"time a step ({moe_ms / busy:.1%} of busy"
                      + ("; not measured: the profiler attributed no kernel "
                         "to the range" if moe_ms == 0 else "")
                      + f"); reading every expert's weights once "
                      f"({moe_weight_bytes(params) / 1e9:.2f} GB) takes at "
                      f"least {floor:.3f} ms at 3.35 TB/s")
                out.update(moe_ms=moe_ms, moe_weight_floor_ms=floor)
        else:
            check(graph.replays >= steps + 1,
                  f"[{tag}] the graph replayed {graph.replays} times")
            out["graph"] = r
    g = out["graph"]
    print(f"[{tag}] replayed vs eager step: host wall {g['wall_ms']:.2f} vs "
          f"{out['wall_ms']:.2f} ms, device busy {g['busy_ms']:.2f} vs "
          f"{out['busy_ms']:.2f} ms"
          + (" (the profiler saw no kernel inside the replays: busy not "
             "measured)" if g["busy_ms"] == 0 else "")
          + f", host launch calls {g['host_launch_calls']:.0f} vs "
          f"{out['host_launch_calls']:.0f} a step")
    return out


def phase_profile_prefill(cfg, params, B=4, S=512, tag="profile-ssm"):
    """Where one full-width prefill dispatch's time goes (B prompts of S
    tokens, the engine's SSM prefill: every layer's scan through the SSD
    kernel): ``torch.profiler`` over one dispatch after a warm-up one, each
    into a fresh pool; host wall, device busy, kernel count, and the SSD
    kernels' device time and share of the busy time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.lm import paged_cache_init, paged_prefill
    tables = torch.full((B, 1), -1, dtype=torch.int32, device=DEV)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, (B, S)).astype(np.int32)).to(DEV)
    lens = torch.full((B,), S, dtype=torch.int32, device=DEV)

    def dispatch(pool):
        lg, _ = paged_prefill(params, pool, tables, toks, lens, cfg,
                              slot_ids=list(range(B)), kernel="paged")
        return torch.argmax(lg[:, 0], -1).cpu()  # the engine reads a token

    dispatch(paged_cache_init(cfg, B, 1, 16, DEV))      # warm-up
    pool = paged_cache_init(cfg, B, 1, 16, DEV)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch(pool)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type.name == "CUDA":
            kern[e.key] = (dev_us / 1e3, e.count)
    busy = sum(ms for ms, _ in kern.values())
    n_kernels = sum(n for _, n in kern.values())
    ssd = {n: v for n, v in kern.items() if "ssd_scan" in n}
    ssd_ms = sum(ms for ms, _ in ssd.values())
    ssd_n = sum(n for _, n in ssd.values())
    print(f"[{tag}] {cfg.name} prefill dispatch at full width ({B} prompts "
          f"of {S} tokens, kernel paged): host wall {wall * 1e3:.2f} ms, "
          f"device busy {busy:.2f} ms ({busy / (wall * 1e3):.1%}), "
          f"{n_kernels} kernels")
    for name, (ms, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[{tag}]   {ms:8.3f} ms {n:6d}x  {name[:90]}")
    check(busy > 0 and ssd_n == cfg.n_layers,
          f"prefill profile: busy {busy} ms, {ssd_n} SSD launches")
    print(f"[{tag}] SSD-scan kernels: {ssd_ms:.3f} ms of device time in "
          f"{ssd_n} launches, {ssd_ms / busy:.1%} of the dispatch's busy "
          f"time")
    return dict(wall_ms=wall * 1e3, busy_ms=busy, kernels=n_kernels,
                ssd_ms=ssd_ms, ssd_launches=ssd_n, ssd_share=ssd_ms / busy)


def draw(cfg, init_params, tag, note=""):
    """Random bf16 weights of ``cfg`` drawn on the card from seed 0, with a
    line naming the model's width (and ``note``: a cut in depth)."""
    t0 = time.perf_counter()
    params = init_params(cfg, DEV, seed=0)
    torch.cuda.synchronize()
    b = next(b for g in cfg.groups for b in g.pattern if b.attn is not None)
    a = b.attn
    moe = next((b.moe for g in cfg.groups for b in g.pattern
                if b.moe is not None), None)
    ffn = (f"{moe.n_experts} experts top-{moe.top_k} of d_ff {moe.d_ff}"
           + (f", {moe.n_shared} shared" if moe.n_shared else "")
           if moe is not None else f"d_ff {b.mlp.d_ff}")
    heads = (f"MLA {a.n_heads} heads, q_lora {a.q_lora_rank}, kv_lora "
             f"{a.kv_lora_rank}, rope {a.qk_rope_head_dim}"
             if a.kind == "mla" else
             f"{a.n_heads}/{a.n_kv_heads} heads of {a.head_dim}")
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers{note}, d_model "
          f"{cfg.d_model}, {heads}, {ffn}, vocab {cfg.vocab}"
          + (", int8 KV" if a.kv_quant else "")
          + f"; {cfg.param_count() / 1e9:.2f} B params drawn on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    return params


def cut_depth(cfg, repeats):
    """``cfg`` with its last scan group cut to ``repeats`` repeats (the
    widths and every other group as published)."""
    *head, last = cfg.groups
    return cfg.replace(groups=(*head, dataclasses.replace(
        last, repeats=repeats)))


def decode_vs_full(params, cfg, inputs, prompt, steps, enc_out=None,
                   off=0):
    """``prefill`` of the first ``prompt`` tokens (after ``off`` patch
    embeddings), then the next ``steps`` tokens through ``decode_step``
    one at a time, against the full forward over all of them
    (tests/test_consistency.py): (relative error, times in s of the
    prefill and of all decode steps, the decode logits, the caches)."""
    from repro_torch.models.lm import (decode_step, lm_hidden, lm_logits,
                                       prefill)
    toks = inputs["tokens"]
    B = toks.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = prefill(params, dict(inputs, tokens=toks[:, :prompt]), cfg,
                         enc_out=enc_out, capacity=off + prompt + steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = [lg]
    for i in range(prompt, prompt + steps):
        lg, caches = decode_step(params, caches, toks[:, i:i + 1],
                                 torch.full((B, 1), off + i,
                                            dtype=torch.int32, device=DEV),
                                 cfg, enc_out=enc_out)
        outs.append(lg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    h, _ = lm_hidden(params, inputs, cfg, enc_out=enc_out)
    full = lm_logits(params, h[:, off + prompt - 1:off + prompt + steps - 1],
                     cfg).float()
    dec = torch.cat(outs[:-1], dim=1).float()
    check(bool(torch.isfinite(dec).all()), "non-finite decode logits")
    err = float((dec - full).abs().max() / (full.abs().max() + 1e-9))
    return err, t1 - t0, t2 - t1, caches


def phase_encdec(cfg, params, card, counters, B=4, prompt=64, steps=16):
    """whisper-base at full width and depth: 4 x 1,500 seeded stub frames
    through ``encoder_apply``, ``prefill`` of a 64-token prompt over its
    output, 16 ``decode_step``s, each step's logits against the full
    forward's (relative error < 0.05, tests/test_consistency.py:80). The
    path runs no kernel of the port (``attn_core``, as the reference);
    every count is set to 0 before and must stay 0. A first pass warms
    cuBLAS; the second is timed."""
    from repro_torch.models.lm import encoder_apply
    gen = torch.Generator(device=DEV).manual_seed(4)
    frames = (0.02 * torch.randn((B, cfg.encoder.seq_len, cfg.d_model),
                                 generator=gen, device=DEV)).to(
        torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (B, prompt + steps), generator=gen,
                         device=DEV, dtype=torch.int32)
    for fn in counters:
        fn.launches = 0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encoder_apply(params, frames, cfg)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        err, t_pre, t_dec, _ = decode_vs_full(params, cfg, {"tokens": toks},
                                              prompt, steps, enc_out=enc)
    launches = {fn.__name__: fn.launches for fn in counters}
    check(not any(launches.values()), f"kernels launched: {launches}")
    check(err < 0.05, f"whisper decode/full mismatch rel={err:.3e}")
    print(f"[encdec] {cfg.name}: encoder over {B} x {cfg.encoder.seq_len} "
          f"frames {t_enc * 1e3:.2f} ms, prefill of {B} x {prompt} tokens "
          f"{t_pre * 1e3:.2f} ms, {steps} decode steps "
          f"{t_dec / steps * 1e3:.2f} ms a step; decode logits against the "
          f"full forward rel={err:.3e} (< 0.05); kernel launches "
          f"{json.dumps(launches)}: no kernel of the port runs on this path "
          f"(attention by attn_core, as in the reference); on {card}")
    return dict(encoder_ms=t_enc * 1e3, prefill_ms=t_pre * 1e3,
                decode_ms_per_step=t_dec / steps * 1e3, rel_err=err,
                launches=launches)


def phase_vlm(cfg, params, card, counters, B=2, text=128, steps=8):
    """internvl2-76b at full width, depth cut: 2 x (256 seeded patch
    embeddings + 128 tokens) through ``prefill`` into int8 KV rings, then 8
    ``decode_step``s at positions offset by the 256 embeddings, each
    step's logits against the full forward's (relative error < 0.05). No
    kernel of the port runs (ring caches; the paged engine is not on this
    path). A first pass warms cuBLAS; the second is timed."""
    n_img = cfg.frontend_len
    gen = torch.Generator(device=DEV).manual_seed(6)
    embeds = (0.02 * torch.randn((B, n_img, cfg.d_model), generator=gen,
                                 device=DEV)).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (B, text + steps), generator=gen,
                         device=DEV, dtype=torch.int32)
    for fn in counters:
        fn.launches = 0
    for _ in range(2):
        err, t_pre, t_dec, caches = decode_vs_full(
            params, cfg, {"tokens": toks, "embeds": embeds}, text, steps,
            off=n_img)
    ring = caches[0]["0"]["attn"]
    check(ring["k"].dtype == torch.int8 and
          int(ring["pos"].max()) == n_img + text + steps - 1,
          f"rings: {ring['k'].dtype}, last position {int(ring['pos'].max())}")
    launches = {fn.__name__: fn.launches for fn in counters}
    check(not any(launches.values()), f"kernels launched: {launches}")
    check(err < 0.05, f"internvl2 decode/full mismatch rel={err:.3e}")
    print(f"[vlm] {cfg.name}: prefill of {B} x ({n_img} patch embeddings + "
          f"{text} tokens) {t_pre * 1e3:.2f} ms, {steps} decode steps at "
          f"positions {n_img + text}-{n_img + text + steps - 1} "
          f"{t_dec / steps * 1e3:.2f} ms a step, int8 KV rings; decode "
          f"logits against the full forward rel={err:.3e} (< 0.05); kernel "
          f"launches {json.dumps(launches)}; on {card}")
    return dict(prefill_ms=t_pre * 1e3, decode_ms_per_step=t_dec / steps
                * 1e3, rel_err=err, launches=launches)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

TRAIN_LOSS_RTOL = 1e-3          # a replayed step's loss against the eager one
TRAIN_MB_RTOL = 1e-4            # microbatches=2 against the single-shot loss
TRAIN_FAULT_RTOL = 1e-5         # a resumed run against the uninterrupted one
SSD_GRAD_TOL = {torch.float32: 3e-4, torch.bfloat16: 6e-2}   # the SSD bounds
SCAN_COLUMNS = ("w_x", "w_B", "w_C", "w_dt", "A_log")


def train_state(cfg, seed=0):
    """``init_state`` (bf16 params, f32 moments, int32 step) drawn on the
    card from ``seed``."""
    from repro_torch.train.step import init_state
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    state = init_state(gen, cfg, DEV)
    torch.cuda.synchronize()
    return state


def run_train_steps(step, state, batches, counters):
    """Each batch through ``step``: its loss, gradient norm, host wall to
    a synchronize (ms) and the launches of each counted kernel."""
    rows = []
    for b in batches:
        before = [fn.launches for fn in counters]
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append(dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]), ms=ms,
                         launches={fn.__name__: fn.launches - n for fn, n in
                                   zip(counters, before)}))
    return rows


def phase_train(cfg, tag, B, S, counters, card, note="", microbatch=False):
    """The train step at full width: ``steps`` eager steps, then the same
    steps from the same seeded state through ``compile_step`` (the first
    call is the warm-up and capture, the rest replay the CUDA graph). Gates:
    every loss finite, each replayed loss within TRAIN_LOSS_RTOL of the
    eager one, the last loss below the first. With ``microbatch``, one
    eager step with microbatches=2 on a 2-row batch, its loss held to the
    single-shot loss of those rows (the mean of the two rows' losses)."""
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import batch_fn, compile_step
    from repro_torch.models.lm import lm_loss
    from repro_torch.train.optimizer import AdamWConfig
    n_params = cfg.param_count()
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    get = batch_fn(cfg, DataConfig(seq_len=S, global_batch=B,
                                   vocab=cfg.vocab), DEV)
    batches = [get(s) for s in range(4)]
    tokens = B * S
    out = dict(arch=cfg.name, layers=cfg.n_layers, params=n_params,
               batch=B, seq=S, tokens_a_step=tokens, lr=opt.lr,
               warmup_steps=opt.warmup_steps)
    for capture in (False, True):
        mode = "replayed" if capture else "eager"
        state = train_state(cfg)
        state_gb = torch.cuda.memory_allocated() / 1e9
        cache = CompileCache()
        step, source = compile_step(
            cfg, opt, state, batches[0], capture_step=capture,
            backend=ArrayBackend(cache=cache, device=DEV))
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
            if hasattr(fn, "routes"):
                fn.routes = dict.fromkeys(fn.routes, 0)
        rows = run_train_steps(step, state, batches, counters)
        counts = {fn.__name__: fn.launches for fn in counters}
        routes = {fn.__name__: dict(fn.routes) for fn in counters
                  if fn.launches and hasattr(fn, "routes")}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [r["loss"] for r in rows]
        check(all(math.isfinite(v) for v in losses),
              f"[{tag}] {mode}: a loss is not finite: {losses}")
        check(losses[-1] < losses[0],
              f"[{tag}] {mode}: the last loss {losses[-1]} is not below the "
              f"first {losses[0]}")
        ms = statistics.median(r["ms"] for r in rows[1:])
        out[mode] = dict(source=source, losses=losses,
                         grad_norms=[r["grad_norm"] for r in rows],
                         step_ms=[r["ms"] for r in rows], median_ms=ms,
                         tokens_per_s=tokens / ms * 1e3, peak_gib=peak,
                         state_gb=state_gb, launches=counts,
                         launches_a_step=[r["launches"] for r in rows],
                         routes=routes,
                         captures=cache.stats["captures"],
                         t_capture_s=cache.stats["t_capture_s"])
        if capture:
            check(source == "compiled" and cache.stats["captures"] == 1
                  and step.replays == len(batches) - 1,
                  f"[{tag}] source {source}, {cache.stats['captures']} "
                  f"captures, {step.replays} replays")
            ssm = any(b.ssm is not None for g in cfg.groups
                      for b in g.pattern)
            out["profile"] = profile_train_step(step, state, batches[0],
                                                tag, card, eager=ssm)
            params = state["params"]          # for the layer gate
        print(f"[{tag}] {mode}: losses {[round(v, 4) for v in losses]}, "
              f"step ms {[round(r['ms'], 1) for r in rows]} (median of "
              f"steps 2-4 {ms:.1f}), {tokens / ms * 1e3:,.0f} tokens/s, "
              f"peak {peak:.2f} GiB (state {state_gb:.2f} GB), launches "
              f"{json.dumps(counts)}, by route {json.dumps(routes)}; on "
              f"{card}")
        del step, cache, state
        torch.cuda.empty_cache()
    eager, graph = out["eager"]["losses"], out["replayed"]["losses"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(graph, eager))
    out["replay_vs_eager_rel"] = worst
    check(worst <= TRAIN_LOSS_RTOL, f"[{tag}] replayed losses {graph} vs "
          f"eager {eager}: {worst:.2e} > {TRAIN_LOSS_RTOL}")
    flops = 6 * n_params * tokens
    ms = out["replayed"]["median_ms"]
    per_step = {m: sorted({r["ssd_scan"] for r in out[m]["launches_a_step"]})
                for m in ("eager", "replayed")}
    out["model_flops_a_step"] = flops
    out["mfu_bf16"] = flops / (ms / 1e3) / BF16_FLOPS
    print(f"[{tag}] {cfg.name}{note}: {n_params / 1e9:.2f} B params, batch "
          f"{B} x seq {S}; replayed losses within {worst:.2e} of eager "
          f"(limit {TRAIN_LOSS_RTOL}); step {out['eager']['median_ms']:.1f} "
          f"ms eager, {ms:.1f} ms replayed; model FLOPs a step 6 x params x "
          f"tokens = {flops / 1e12:.1f} TFLOP (no recompute, no attention or "
          f"scan FLOPs): {100 * out['mfu_bf16']:.1f}% of the 989 TFLOP/s "
          f"bf16 peak; SSD launches a step {json.dumps(per_step)} (forward "
          f"+ remat recompute); on {card}")
    if microbatch:
        state = train_state(cfg)
        two = batch_fn(cfg, DataConfig(seq_len=S, global_batch=2,
                                       vocab=cfg.vocab), DEV)(7)
        with torch.no_grad():
            single = sum(float(lm_loss(state["params"], {
                k: v[i:i + 1] for k, v in two.items()}, cfg)[0])
                for i in range(2)) / 2
        step, _ = compile_step(cfg, opt, state, two, microbatches=2,
                               capture_step=False)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, m = step(state, two)
        mb = float(m["loss"])
        torch.cuda.synchronize()
        mb_ms = (time.perf_counter() - t0) * 1e3
        rel = abs(mb - single) / abs(single)
        out["microbatches2"] = dict(loss=mb, single_shot_loss=single,
                                    rel=rel, ms=mb_ms,
                                    peak_gib=torch.cuda.max_memory_allocated()
                                    / 2 ** 30)
        print(f"[{tag}] microbatches=2 on 2 x {S}: loss {mb:.6f} against the "
              f"single-shot {single:.6f} (rel {rel:.2e}, limit "
              f"{TRAIN_MB_RTOL}), {mb_ms:.1f} ms, peak "
              f"{out['microbatches2']['peak_gib']:.2f} GiB")
        check(math.isfinite(mb) and rel <= TRAIN_MB_RTOL,
              f"[{tag}] microbatches=2 loss {mb} vs single-shot {single}")
        del state, step
        torch.cuda.empty_cache()
        return out, None
    return out, params


GEMM_NAMES = re.compile(r"gemm|xmma|nvjet|cutlass", re.I)


def profile_train_step(step, state, batch, tag, card, eager=False):
    """One more replayed step under ``torch.profiler``: host wall, device
    busy, the GEMMs' (cuBLAS) and the SSD kernel's device time, and the
    kernels that take the most; with ``eager`` (SSM models) one eager step
    too, for the device time of the SSD backward (the plain version
    recomputed, inside the ``ssd_scan_backward`` range, which a graph's
    replay does not record; the graph's pool is held meanwhile, which
    qwen3's eager step would not fit beside). The state advances by each
    step."""
    wall, kern, host, _ = _profile(lambda: step(state, batch), 1)
    busy = sum(ms for ms, _ in kern.values())
    check(busy > 0, f"[{tag}] the profiler saw no device time in the step")
    gemm = sum(ms for k, (ms, _) in kern.items() if GEMM_NAMES.search(k))
    ssd = sum(ms for k, (ms, _) in kern.items() if "ssd_scan" in k)
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]
    out = dict(wall_ms=wall * 1e3, busy_ms=busy,
               kernels=sum(n for _, n in kern.values()), gemm_ms=gemm,
               ssd_kernel_ms=ssd, host_launch_calls=host,
               top=[(k[:80], ms, n) for k, (ms, n) in top])
    print(f"[{tag}] profile of a replayed step: host wall {wall * 1e3:.1f} "
          f"ms, device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%),"
          f" {out['kernels']:.0f} kernels, {host:.0f} host launch calls; "
          f"GEMMs {gemm:.1f} ms ({100 * gemm / busy:.1f}% of busy), the SSD "
          f"kernel {ssd:.2f} ms; on {card}")
    for k, ms, n in out["top"]:
        print(f"[{tag}]   {ms:9.2f} ms  x{n:5.0f}  {k}")
    if not eager:
        return out
    e_wall, e_kern, _, bwd = _profile(lambda: step.fn(state, batch), 1,
                                      range_name="ssd_scan_backward")
    e_busy = sum(ms for ms, _ in e_kern.values())
    out.update(eager_wall_ms=e_wall * 1e3, eager_busy_ms=e_busy,
               ssd_backward_ms=bwd)
    print(f"[{tag}] profile of an eager step: host wall {e_wall * 1e3:.1f} "
          f"ms, device busy {e_busy:.1f} ms; the SSD backward (the plain "
          f"version recomputed) {bwd:.1f} ms ({100 * bwd / e_busy:.1f}% of "
          f"busy); on {card}")
    return out


def phase_ssd_grads(cfg, params, B, S, ssd_scan, card):
    """One SSM layer (the first) at full width on its real input
    activations (the trained params, ``batch``'s tokens): the gradients of
    its scan columns (w_x, w_B, w_C, w_dt and A_log) through the kernel's
    autograd wrapper against those through the plain version (the layer is
    bf16: 6e-2), and the scan's own input gradients (x, dt, A, B, C at the
    activations recorded in the layer) against the plain version's at the
    SSD bounds (3e-4 f32, 6e-2 bf16). Control: the raw launch (no
    autograd wrapper) leaves the scan columns w_B, w_C, w_dt and A_log
    without a gradient."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.kernels.ssd_scan import ssd_chunked_ref
    from repro_torch.launch.train import batch_fn
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.blocks import _repeat
    from repro_torch.models.layers import embed_lookup, norm_apply
    spec = cfg.groups[0].pattern[0].ssm
    lp = _repeat(params["groups"][0]["stacked"]["0"], 0)
    batch = batch_fn(cfg, DataConfig(seq_len=S, global_batch=B,
                                     vocab=cfg.vocab), DEV)(0)
    with torch.no_grad():
        h = norm_apply(lp["norm_ssm"], embed_lookup(params["embed"],
                                                    batch["tokens"]),
                       cfg.norm, cfg.norm_eps)
    B, S, _ = h.shape
    pos = torch.arange(S, dtype=torch.int32, device=DEV)[None].expand(B, S)
    g = torch.Generator(device=DEV)
    g.manual_seed(11)
    G = torch.randn(h.shape, device=DEV, generator=g)
    recorded = []

    def kernel(x, dt, A, Bm, Cm, **kw):
        recorded.append((x, dt, A, Bm, Cm, kw["chunk"]))
        return ssd_scan(x, dt, A, Bm, Cm, **kw)

    def plain(x, dt, A, Bm, Cm, *, chunk, out_dtype, return_state):
        y, st = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
        return y.to(out_dtype), st

    def raw(x, dt, A, Bm, Cm, *, chunk, out_dtype, return_state):
        return ssd_mod._launch(x.detach(), dt.detach(), A.detach(),
                               Bm.detach(), Cm.detach(), chunk, out_dtype,
                               True, None)

    def layer_grads(scan):
        saved = ssm_mod.ssd_scan
        ssm_mod.ssd_scan = scan
        try:
            live = {k: v.detach().requires_grad_()
                    for k, v in lp["ssm"].items()}
            y = ssm_mod.ssm_apply(live, h, spec, cfg, pos)
            got = torch.autograd.grad((y.float() * G).sum(),
                                      [live[n] for n in SCAN_COLUMNS],
                                      allow_unused=True)
        finally:
            ssm_mod.ssd_scan = saved
        return dict(zip(SCAN_COLUMNS, got))

    t0 = time.perf_counter()
    via_kernel, via_plain = layer_grads(kernel), layer_grads(plain)
    layer_rel = {n: rel_err(via_kernel[n], via_plain[n])
                 for n in SCAN_COLUMNS}
    check(all(v <= SSD_GRAD_TOL[torch.bfloat16] for v in layer_rel.values()),
          f"[ssd-grad] layer gradients through the kernel vs plain "
          f"{layer_rel}")
    control = layer_grads(raw)
    missing = {n: control[n] is None or not bool(control[n].any())
               for n in SCAN_COLUMNS[1:]}
    check(all(missing.values()),
          f"[ssd-grad] control: the raw launch still gives the scan "
          f"columns a gradient: {missing}")
    check(all(bool(via_kernel[n].any()) for n in SCAN_COLUMNS),
          "[ssd-grad] a scan column's gradient through the wrapper is zero")
    x, dt, A, Bm, Cm, chunk = recorded[0]
    gy = torch.randn(x.shape, device=DEV, generator=g)
    ins_rel = {}
    for fn, key in ((kernel, "kernel"), (plain, "plain")):
        ins = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        y, _ = fn(*ins, chunk=chunk, out_dtype=torch.float32,
                  return_state=True)
        ins_rel[key] = torch.autograd.grad(y, ins, gy)
    ins_rel = {n: (rel_err(a, b), str(a.dtype).replace("torch.", ""))
               for n, a, b in zip("x dt A B C".split(), ins_rel["kernel"],
                                  ins_rel["plain"])}
    check(all(r <= SSD_GRAD_TOL[getattr(torch, d)]
              for r, d in ins_rel.values()),
          f"[ssd-grad] scan input gradients vs plain {ins_rel}")
    out = dict(layer_rel=layer_rel, inputs_rel=ins_rel,
               control_missing=missing, shape=[B, S, *x.shape[2:],
                                               Bm.shape[-1]],
               wall_s=time.perf_counter() - t0)
    print(f"[ssd-grad] {cfg.name} layer 0 at B={B} S={S}: scan columns "
          f"through the wrapper vs plain rel {json.dumps(layer_rel)} (limit "
          f"6e-2, bf16 layer); scan input gradients rel "
          f"{json.dumps(ins_rel)} (3e-4 f32, 6e-2 bf16); control (raw "
          f"launch, no grad_fn): w_B, w_C, w_dt, A_log without gradient "
          f"{json.dumps(missing)}; {out['wall_s']:.1f}s; on {card}")
    return out


def phase_train_fault(counters, card, n=8, fail_at=5):
    """``resilient_train`` on the card at smoke width (mamba2-1.3b-smoke,
    the SSD kernel in every layer) with the step captured, checkpoints
    every 2 steps written asynchronously, and a ``WorkerFailure`` injected
    entering step ``fail_at``: the run restores the last committed
    checkpoint INTO the state's tensors and the same graph keeps replaying.
    Gates: one restart from step 4; the state's addresses unchanged; one
    graph; every loss of the interrupted run (the replayed steps too) and
    the final parameters within TRAIN_FAULT_RTOL of an uninterrupted run
    from the same seed."""
    import shutil as _shutil
    from repro_torch.configs import get_config
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import batch_fn, compile_step
    from repro_torch.runtime.fault import (FaultConfig, WorkerFailure,
                                           resilient_train)
    from repro_torch.train.optimizer import AdamWConfig, leaves_with_path
    cfg = get_config("mamba2-1.3b", smoke=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=n)
    get = batch_fn(cfg, DataConfig(seq_len=512, global_batch=4,
                                   vocab=cfg.vocab), DEV)
    ckdir = Path(__file__).resolve().parent / "build" / "train_fault_ckpt"
    _shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    runs = {}
    for fn in counters:
        fn.launches = 0
    for name in ("uninterrupted", "interrupted"):
        state = train_state(cfg)
        ptrs = [x.data_ptr() for _, x in leaves_with_path(state)]
        step, _ = compile_step(cfg, opt, state, get(0), backend=ArrayBackend(
            cache=CompileCache(), device=DEV))
        if name == "uninterrupted":
            losses = []
            for s in range(n):
                state, m = step(state, get(s))
                losses.append(float(m["loss"]))
            report = None
        else:
            fired = []

            def hook(s):
                if s == fail_at and not fired:
                    fired.append(s)
                    raise WorkerFailure("injected node loss")

            state, report = resilient_train(
                step, state, get, n, FaultConfig(
                    ckpt_dir=str(ckdir), ckpt_every=2, async_save=True),
                failure_hook=hook)
            losses = report.losses
        torch.cuda.synchronize()
        runs[name] = dict(losses=losses, report=report, step=step,
                          moved=[x.data_ptr() for _, x in
                                 leaves_with_path(state)] != ptrs,
                          params=[x.float() for _, x in
                                  leaves_with_path(state["params"])])
    counts = {fn.__name__: fn.launches for fn in counters}
    u, f = runs["uninterrupted"], runs["interrupted"]
    rep = f["report"]
    check(rep.restarts == 1 and rep.restore_steps == [4],
          f"[train-fault] restarts {rep.restarts}, from {rep.restore_steps}")
    check(not f["moved"] and not u["moved"],
          "[train-fault] the state's tensors moved")
    check(len(f["step"].graphs) == 1 and f["step"].replays == len(
        f["losses"]) - 1, f"[train-fault] {len(f['step'].graphs)} graphs, "
          f"{f['step'].replays} replays over {len(f['losses'])} steps")
    want = u["losses"][:fail_at] + u["losses"][4:]
    worst = max(abs(a - b) / abs(b) for a, b in zip(f["losses"], want))
    pworst = max(rel_err(a, b) for a, b in zip(f["params"], u["params"]))
    check(len(f["losses"]) == len(want) and worst <= TRAIN_FAULT_RTOL
          and pworst <= TRAIN_FAULT_RTOL,
          f"[train-fault] resumed losses {f['losses']} vs {want}: {worst:.2e}"
          f", params {pworst:.2e}")
    check(all(math.isfinite(v) for v in f["losses"]),
          "[train-fault] a loss is not finite")
    _shutil.rmtree(ckdir, ignore_errors=True)
    out = dict(steps=n, fail_at=fail_at, restore_steps=rep.restore_steps,
               losses=f["losses"], uninterrupted=u["losses"],
               loss_rel=worst, params_rel=pworst,
               replays=f["step"].replays, launches=counts,
               wall_s=time.perf_counter() - t0)
    print(f"[train-fault] {cfg.name}, 4 x 512, {n} steps, checkpoints every "
          f"2 written async, a WorkerFailure entering step {fail_at}: "
          f"restored step {rep.restore_steps} into the bound tensors, one "
          f"graph, {f['step'].replays} replays; the {len(want)} losses "
          f"within {worst:.1e} of the uninterrupted run, params within "
          f"{pworst:.1e} (limit {TRAIN_FAULT_RTOL}); launches "
          f"{json.dumps(counts)}; {out['wall_s']:.1f}s; on {card}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    # flex_attention's compiled kernels (the softcap yardstick) stay in build/
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(root / "build" /
                                                         "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    from repro_torch.kernels.ssd_scan import ssd_chunked_ref, ssd_scan
    from repro_torch.launch.serve import init_params

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products reduce in f32, as the reference's do (no bf16 split-K)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"[card] {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | tf32 off | bf16 reductions in f32")

    t0 = time.perf_counter()
    names = ["paged_attention", "ssd_scan", "flash_attention"]
    logs = _build.build(names, verbose=True)
    spills = {kname: ptxas_report(kname, log) for kname, log in logs.items()}
    libs = {kname: _build.load(kname) for kname in names}
    print(f"[build] {', '.join(n + '.cu' for n in names)} built and loaded "
          f"in {time.perf_counter() - t0:.1f}s (set-up)")
    new_spills = {f: n for kname, parts in (
        ("flash_attention", ("flash_attention_bf16",)),
        ("paged_attention", ("paged_split", "paged_combine", "paged_tile")),
        ("ssd_scan", ("ssd_scan_tc",)))
        for f, n in spills.get(kname, {}).items()
        if any(part in f for part in parts)}
    check(all(n == 0 for n in new_spills.values()),
          f"a tensor-core or split kernel spills: {new_spills}")
    for kname, part in (("flash_attention", "flash_attention_bf16"),
                        ("paged_attention", "paged_tile_kernel"),
                        ("ssd_scan", "ssd_scan_tc_kernel")):
        hgmma = sass_count(_build.library_path(kname), "HGMMA", part)
        if hgmma is None:
            print(f"[build]   {kname}: no cuobjdump on this machine: HGMMA "
                  "not counted")
            continue
        check(hgmma and all(hgmma.values()),
              f"{kname}: a {part} instantiation has no HGMMA: {hgmma}")
        print(f"[build]   {kname}: HGMMA (wgmma) instructions in each "
              f"{part} instantiation: {sorted(hgmma.values())}")
    smem = libs["ssd_scan"].ssd_scan_simt_smem_bytes
    tc_smem = libs["ssd_scan"].ssd_scan_tc_smem_bytes
    smem.restype = tc_smem.restype = ctypes.c_longlong
    print(f"[build]   ssd_scan: dynamic shared memory a block (of 232,448): "
          f"tc {tc_smem(2, 128, 256):,} bytes at G=2, N=128, chunk 256 "
          f"({tc_smem(1, 128, 256):,} at G=1; {tc_smem(2, 64, 256):,} at "
          f"N=64; {tc_smem(2, 128, 1024):,} at chunk 1,024); simt "
          f"{smem(128, 256):,} bytes at N=128, chunk 256")
    split = libs["paged_attention"].paged_attention_split_smem_bytes
    tile = libs["paged_attention"].paged_attention_tile_smem_bytes
    split.restype = tile.restype = ctypes.c_longlong
    print(f"[build]   paged_attention: dynamic shared memory a block at "
          f"qwen3-14b's shapes (G=5, D=128, 16-row pages): split "
          f"{split(5, 16, 128, 128, 2, 2):,} bytes (decode, 2 entries a "
          f"split), tile {tile(128, 128, 32, 16):,} bytes (32 table "
          f"entries); the general kernel sizes its own per launch")
    limit = libs["paged_attention"].paged_attention_max_smem_bytes
    limit.restype = ctypes.c_longlong
    print(f"[build]   paged_attention: tile blocks of the new families: "
          f"{tile(128, 128, 288, 16):,} bytes at gemma2-27b's D=128 and 288 "
          f"table entries, {tile(256, 256, 94, 16):,} at gemma3-12b's D=256 "
          f"(94 entries), {tile(160, 160, 32, 16):,} at stablelm-12b's "
          f"D=160; the limit {limit():,}")
    smem = libs["flash_attention"].flash_attention_smem_bytes
    smem.restype = ctypes.c_longlong
    print(f"[build]   flash_attention: dynamic shared memory "
          f"{smem(128, 128, 1):,} / {smem(256, 256, 1):,} bytes a block at "
          f"D=Dv=128 / 256 bf16, {smem(256, 256, 0):,} at D=Dv=256 f32 (of "
          f"232,448)")

    rec = phase_kernels(paged_attention, paged_attention_ref, card)
    rec_family = phase_family_kernels(paged_attention, paged_attention_ref,
                                      card)
    t0 = time.perf_counter()
    rec_mla = phase_mla_kernels(paged_attention, paged_attention_ref, card)
    print(f"[kernels] mla shapes: {time.perf_counter() - t0:.1f}s")
    rec_ssd = phase_ssd(ssd_scan, ssd_chunked_ref, card)
    # before any weights are on the card: the plain version's score tensors
    # take up to ~26 GB at the largest shapes
    counters = (paged_attention, ssd_scan, flash_attention)
    flash_launches, rec_flash = phase_flash(
        flash_attention, attention_ref, ops.attention, counters, card)
    t0 = time.perf_counter()
    launch = phase_launch(card, counters)
    print(f"[launch] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dist = phase_dist(card, counters, launch)
    t_dist = time.perf_counter() - t0
    print(f"[dist] phase wall {t_dist:.1f}s")
    t0 = time.perf_counter()
    wine = phase_wine(card, counters)
    print(f"[wine] phase wall {time.perf_counter() - t0:.1f}s")
    fault = phase_train_fault(counters, card)

    cfg = get_config("qwen3-14b")
    params = draw(cfg, init_params, "serve")
    srv = phase_serve(cfg, params, paged_attention, card, capture_step=False)
    t0 = time.perf_counter()
    graph = phase_serve_graph(cfg, params, paged_attention, card, srv)
    print(f"[serve-graph] phase wall {time.perf_counter() - t0:.1f}s")
    srv["lockstep"] = phase_lockstep(cfg, params)
    srv["profile"] = phase_profile(cfg, params)
    blocked = phase_blocked(cfg, params, card)
    del params
    torch.cuda.empty_cache()

    cfg = get_config("mamba2-1.3b")
    s = cfg.groups[0].pattern[0].ssm
    t0 = time.perf_counter()
    params = init_params(cfg, DEV, seed=0)
    torch.cuda.synchronize()
    print(f"[serve-ssm] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_inner {s.expand * cfg.d_model}, "
          f"{s.expand * cfg.d_model // s.head_dim} heads of {s.head_dim}, "
          f"d_state {s.d_state}, chunk {s.chunk}, vocab {cfg.vocab}, tied "
          f"embeddings; {cfg.param_count() / 1e9:.2f} B params drawn on the "
          f"card in {time.perf_counter() - t0:.1f}s")
    ssm = phase_serve_ssm(cfg, params, ssd_scan, card)
    t0 = time.perf_counter()
    dist_serve = phase_dist_serve(cfg, params, ssd_scan, card, ssm)
    t_dist_serve = time.perf_counter() - t0
    print(f"[dist-serve] phase wall {t_dist_serve:.1f}s; [dist] + "
          f"[dist-serve] add {t_dist + t_dist_serve:.1f}s to this script")
    ssm.pop("outs")
    ssm["lockstep"] = phase_lockstep_ssm(cfg, params)
    ssm["profile"] = phase_profile(cfg, params, S=512, tag="profile-ssm")
    ssm["prefill_profile"] = phase_profile_prefill(cfg, params)
    del params
    torch.cuda.empty_cache()

    cfg = get_config("gemma2-27b")
    params = draw(cfg, init_params, "serve-window")
    win = phase_serve_window(cfg, params, paged_attention, card)
    win["profile"] = phase_profile(cfg, params, tag="profile-window")
    del params
    torch.cuda.empty_cache()

    cfg = get_config("gemma3-12b")
    params = draw(cfg, init_params, "lockstep-window")
    lock_win = phase_lockstep(cfg, params, lens=(1300, 900, 300),
                              npps=None, P=None, tag="lockstep-window")
    del params
    torch.cuda.empty_cache()

    cfg = get_config("zamba2-7b")
    params = draw(cfg, init_params, "serve-int8")
    int8 = phase_serve_int8(cfg, params, ssd_scan, card)
    int8["profile"] = phase_profile(cfg, params, tag="profile-int8")
    del params
    torch.cuda.empty_cache()

    cfg = get_config("olmoe-1b-7b")
    params = draw(cfg, init_params, "serve-moe")
    moe = phase_serve(cfg, params, paged_attention, card, capacity=1024,
                      tag="serve-moe")
    moe["profile"] = phase_profile(cfg, params, tag="profile-moe")
    del params
    torch.cuda.empty_cache()

    # deepseek-v2-236b is 439 GiB: its first (dense) layer and 4 of its 59
    # MoE layers, every width as published
    cfg = cut_depth(get_config("deepseek-v2-236b"), 4)
    t0 = time.perf_counter()
    params = draw(cfg, init_params, "serve-mla", note=" (depth cut from "
                  "60: the dense layer + 4 of 59 MoE layers)")
    mla = phase_serve(cfg, params, paged_attention, card, tag="serve-mla",
                      routes=("general", "general"))
    print(f"[serve-mla] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mla["lockstep"] = phase_lockstep(cfg, params, tag="lockstep-mla")
    print(f"[lockstep-mla] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mla["profile"] = phase_profile(cfg, params, tag="profile-mla", moe=True)
    print(f"[profile-mla] phase wall {time.perf_counter() - t0:.1f}s")
    del params
    torch.cuda.empty_cache()

    cfg = get_config("whisper-base")
    t0 = time.perf_counter()
    params = draw(cfg, init_params, "encdec", note=" (+ 6 encoder layers)")
    encdec = phase_encdec(cfg, params, card, counters)
    print(f"[encdec] phase wall {time.perf_counter() - t0:.1f}s")
    del params
    torch.cuda.empty_cache()

    # internvl2-76b is 131 GiB: 16 of its 80 layers
    cfg = cut_depth(get_config("internvl2-76b"), 16)
    t0 = time.perf_counter()
    params = draw(cfg, init_params, "vlm", note=" (depth cut from 80)")
    vlm = phase_vlm(cfg, params, card, counters)
    print(f"[vlm] phase wall {time.perf_counter() - t0:.1f}s")
    del params
    torch.cuda.empty_cache()

    # training at full width: mamba2-1.3b at full depth, then qwen3-14b
    # with its depth cut to 4 of 40 layers
    cfg = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    train_ssm, tparams = phase_train(cfg, "train-ssm", 2, 4096, counters,
                                     card)
    ssd_grad = phase_ssd_grads(cfg, tparams, 2, 4096, ssd_scan, card)
    del tparams
    torch.cuda.empty_cache()
    print(f"[train-ssm] phase wall {time.perf_counter() - t0:.1f}s")
    cfg = cut_depth(get_config("qwen3-14b"), 4)
    t0 = time.perf_counter()
    train_dense, _ = phase_train(cfg, "train", 1, 4096, counters, card,
                                 note=" (depth cut from 40 to 4)",
                                 microbatch=True)
    print(f"[train] phase wall {time.perf_counter() - t0:.1f}s")

    paged_phases = {"serve": srv, "serve-graph": graph,
                    "serve-window": win, "serve-moe": moe, "serve-mla": mla}
    for r in (srv, graph, moe, mla):
        r.pop("outs", None)
    dec = rec["decode"]
    keep = ("route", "ms", "device_ms", "device_parts", "plain_ms",
            "bound_ms", "bound_by", "sdpa_ms", "max_abs_err",
            "max_abs_err_f32")
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:107",
        "launches": sum(r["launches"] for r in paged_phases.values()),
        "launches_by_phase": {n: r["launches"]
                              for n, r in paged_phases.items()},
        "routes_by_phase": {n: r["routes"] for n, r in paged_phases.items()},
        "max_abs_err": max(r["max_abs_err"] for r in (
            *rec.values(), *rec_family.values(), *rec_mla.values())),
        "ms": dec["ms"], "device_ms": dec["device_ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None,
        "shape": "decode B=4 S=1 H=40 K=8 D=128 ps=16 npps=32, 9 live "
                 "pages/slot, bf16; ms is the call (wrapper + kernel), "
                 "device_ms the kernels alone",
        "sdpa_dense_view_ms": dec["sdpa_ms"],
        **{shape: {k: rec[shape][k] for k in keep}
           for shape in ("prefill", "long_decode")},
        "families": {n: {k: r[k] for k in keep if k in r}
                     for n, r in rec_family.items()},
        "mla": {n: {k: r[k] for k in (*keep, "sdpa_backend") if k in r}
                for n, r in rec_mla.items()},
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:63",
        "launches": ssm["launches"] + dist_serve["launches"]
        + int8["launches"] + sum(
            train_ssm[m]["launches"]["ssd_scan"]
            for m in ("eager", "replayed"))
        + fault["launches"]["ssd_scan"] + wine["launches"]["ssd_scan"],
        "launches_by_phase": {
            "serve-ssm": ssm["launches"],
            "dist-serve": dist_serve["launches"],
            "serve-int8": int8["launches"],
            "train-ssm eager": train_ssm["eager"]["launches"]["ssd_scan"],
            "train-ssm replayed":
                train_ssm["replayed"]["launches"]["ssd_scan"],
            "train-fault": fault["launches"]["ssd_scan"],
            "wine (prefill and train replays)":
                wine["launches"]["ssd_scan"]},
        "train_launches_a_step": {
            m: [r["ssd_scan"] for r in train_ssm[m]["launches_a_step"]]
            for m in ("eager", "replayed")},
        "train_launches_note": "a train step of mamba2-1.3b launches the "
                               "kernel once a layer forward and once again "
                               "in remat's recompute (48 + 48); the backward "
                               "recomputes the plain version",
        "ssd_grad_rel": ssd_grad["inputs_rel"],
        "routes_by_phase": {"serve-ssm": ssm["routes"],
                            "dist-serve": dist_serve["routes"],
                            "serve-int8": int8["routes"],
                            **{f"train-ssm {m}":
                               train_ssm[m]["routes"]["ssd_scan"]
                               for m in ("eager", "replayed")}},
        **{k: rec_ssd["S512"][k] for k in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "simt_ms", "simt_device_ms", "plan")},
        "library_ms": None,
        "shape": "Bz=4 S=512 H=64 P=64 N=128 chunk 256, bf16 x/B/C, f32 "
                 "dt, y f32 + final state; ms / device_ms on the tc route, "
                 "simt_* the simt route forced through the wrapper",
        "shapes": {n: r for n, r in rec_ssd.items() if n != "S512"},
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "launches": flash_launches,
        **{k: rec_flash["qwen3-14b"][k] for k in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shape")},
        "shapes": {n: r for n, r in rec_flash.items() if n != "qwen3-14b"},
    }]
    print(f"[launch] summary {json.dumps(launch)}")
    print(f"[dist] summary {json.dumps(dist)}")
    print(f"[wine] summary {json.dumps(wine)}")
    print(f"[serve] summary {json.dumps(srv)}")
    print(f"[serve-graph] summary {json.dumps(graph)}")
    print(f"[serve-ssm] summary {json.dumps(ssm)}")
    print(f"[dist-serve] summary {json.dumps(dist_serve)}")
    print(f"[blocked] summary {json.dumps(blocked)}")
    print(f"[serve-window] summary {json.dumps(win)}")
    print(f"[lockstep-window] summary {json.dumps(lock_win)}")
    print(f"[serve-int8] summary {json.dumps(int8)}")
    print(f"[serve-moe] summary {json.dumps(moe)}")
    print(f"[serve-mla] summary {json.dumps(mla)}")
    print(f"[encdec] summary {json.dumps(encdec)}")
    print(f"[vlm] summary {json.dumps(vlm)}")
    print(f"[train-fault] summary {json.dumps(fault)}")
    print(f"[train-ssm] summary {json.dumps(train_ssm)}")
    print(f"[ssd-grad] summary {json.dumps(ssd_grad)}")
    print(f"[train] summary {json.dumps(train_dense)}")
    print(f"[total] chip_smoke.py took {time.perf_counter() - t_start:.1f}s "
          "(build included)")
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
