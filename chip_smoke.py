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
            bf16 flash kernel, a split, combine, tile or mla paged kernel or
            a tc SSD kernel spills), and, where cuobjdump is on the machine,
            the HGMMA (wgmma) instructions of the bf16 flash, the tile and
            mla paged and the tc SSD kernels (fails on an instantiation
            without).
3. kernels  each kernel against its plain PyTorch version on the card.
            paged_attention: the reference test grid (page sizes 2/4/8/16,
            MHA/GQA/MQA, window + softcap, the MLA q2/k2 form, ragged padded
            prefill, fragmented tables with dead pages, a full pool, and two
            prefills with S*G >= 64, and an MLA prefill with v the tensor
            k) in f32 (atol 2e-5) and bf16 (atol 2e-2, rtol 1e-2), each
            case's route printed (split, tile, mla and general each run in
            bf16); then qwen3-14b's decode (split) and prefill
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
            over 256), f32 on the general route within 2e-5, bf16 on the
            mla route within one bf16 rounding of the f32 answer against
            two controls that must fail it (the q2.k2 term dropped; the
            kernel's default scale 1/sqrt(576) for MLA's 1/sqrt(192)),
            timed beside the general kernel on the same bf16 inputs and
            SDPA on the gathered view with the backend that took it.
            ssd_scan: the
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
4a'. mesh   the same 16,384 instances through ``make_backend("array",
            mesh=...)``: on ``make_host_mesh()`` (the card once: each wave
            whole) and on a mesh listing the card twice on ``data`` (each
            wave split in two, each piece its own captured graph, joined in
            order), cold and warm. Gates: outputs bit-equal to the
            mesh-less run's; the split records name the card twice; warm
            waves replay. Captures and walls printed.
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
            a smaller shard within 3 waves, and one throttled to 0.1 s a
            shard that ``health_verdicts()`` names ``outlier`` and the
            others ``healthy`` (each node's z printed). Printed:
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
4d'. elastic  that run's checkpoint of step 6 restored through
            ``restore(..., sharding=state_sharding(state,
            make_host_mesh()))`` into the interrupted run's bound state
            (no address moves), then steps 6 and 7 replayed: their losses
            bit-equal to the uninterrupted run's.
4e. examples  the port's three examples as ``python -m
            repro_torch.examples.<name>`` subprocesses on the card, at
            once: ``quickstart --n 1024 --serial-n 8``, ``serve_batch`` and
            ``train_lm --steps 12 --inject-failure`` (checkpoints in a
            temporary directory). Gates: each exits 0; train_lm restarts
            once and its loss falls; serve_batch's decode step compiled.
            Their own lines are printed.
4f. pipeline  ``runtime.pipeline.pipeline_apply`` (the GPipe schedule, M +
            S - 1 ticks, hand-offs by ``.to()``) over a mesh listing the
            card 4 times on ``pod``: 4 stages of 2 blocks at full width, 4
            microbatches of 1 x 128 tokens; qwen3-14b's blocks, then
            mamba2-1.3b's (the SSD kernel in the stages). Gates: in f32
            within 1e-4 of ``reference_apply`` (relative to the output's
            scale); every SSD launch of the bf16 runs on tc. Printed: the
            bf16 gap, the bubble fraction 3/7, pipeline against sequential
            wall.
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
5b. serve-obs  as 5a with ``obs.metrics.REGISTRY`` enabled, then disabled:
            the ``serve.ttft_s`` / ``serve.tpot_s`` histograms and series
            each count the records with tokens; ``serve.preemptions``,
            ``serve.prefix.hits`` / ``misses`` and
            ``serve.kernel.bytes_avoided`` equal the engine's stats (bytes
            avoided > 0 on kernel "paged"); the occupancy gauge in [0, 1];
            the step one graph, replayed every step after its capture; TPOT
            beside 5a's (the registry off).
5c. serve-fixed  5's second wave on the fixed-ring ``ServeEngine`` (4
            slots, capacity 512, no prefix sharing, the decode step
            replayed): one prefill dispatch a request, no kernel of the port
            launched, tokens equal 5a's paged engine's up to the first
            near-tie (the gap read along the fixed path: prefill, then
            decode steps); TTFT, TPOT, tokens/s and peak memory beside 5a's.
            lockstep-fixed: 4 x 128 prompts prefilled into rings of 512,
            8 greedy steps of the captured step against eager
            ``decode_step`` calls: tokens equal up to the first near-tie.
            serve-fixed-twin: the same wave on the paged engine with kernel
            "gather" and one-slot prefill (the reference's bitwise twin of
            the fixed engine): every token equal.
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
8a. engine-churn  five qwen3-14b ``PagedServeEngine``s built over 5's
            weights and one compile cache, each serving 5's second wave and
            then dropped: after each drop ``memory_reserved()``, the pool
            count and the pools' MiB. Gates: the pool count back to its
            value before the first engine, ``memory_reserved()`` within 64
            MiB of its value after the first drop, every engine's tokens
            equal (a dropped engine's graphs go with it: none replays).
            Then one engine is dropped in another thread while a second
            serves: the drop's seconds, and the live engine's TPOT p50 and
            longest decode step beside a wave with no drop (gates: its
            tokens equal, the dropped engine's pool gone).
8b. restart  (after the qwen3-14b weights are freed here) two processes
            (``chip_smoke.py --restart-child A|B DIR``, an internal mode),
            one after the other, over one compile-cache directory: A draws
            qwen3-14b and serves 5's traffic cold; B does the same over the
            records A left and captures the step and each prefill shape at
            construction. Printed for each: construction seconds, sources,
            captures ahead and on the request path, each wave's TTFT p50,
            TPOT p50, graph pools and MiB. Gates: B's sources "disk" for
            every key A captured, no capture on B's request path, every
            paged launch there inside a replay, B's tokens equal A's (144
            of 144). restart-ssm (after 9, in this process): the same for
            mamba2-1.3b on 9's wave, B a fresh cache over A's directory
            (A's engine dropped first); every SSD launch of B's request
            path inside a replay, all on tc. Every run of this script
            starts cold: ``REPRO_COMPILE_CACHE_DIR`` points at a fresh
            directory, removed at exit, and every other phase's compile
            cache keeps the memory tier alone.
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
9b. serve-fixed-ssm  9's wave on the fixed-ring ``ServeEngine`` (4 slots,
            capacity 1024): every prompt prefilled alone, 48 SSD launches a
            prefill dispatch and one dispatch a request, all on tc; tokens
            equal 9's up to the first near-tie.
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
            the mla route (the absorbed form, q2/k2, v the ckv pool).
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
23. roofline  the H100 roofline bound (``launch.roofline``: 989 TFLOP/s
            bf16, 3.35 TB/s) of two measured steps, counted on meta at
            their exact shapes by ``launch.op_analysis`` (the kernels'
            plain versions): 7's replayed qwen3-14b decode step (4 slots,
            the engine's 128-page pool) and 21's replayed mamba2-1.3b train
            step (2 x 4,096). The bound is max(counted flops / peak, the
            step's state / HBM rate); the share is bound / measured device
            busy. Gate: 0 < share <= 1.05 for both.
24. dryrun  ``launch.dryrun.run_cell`` on the abstract 16 x 16 production
            mesh (meta tensors, no card; the step under the SPMD runtime on
            a fake process group): qwen3-14b decode_32k and mamba2-1.3b
            train_4k; each row's status "ok", with a collectives table and
            collective bytes a chip above 0; rows and bounds printed.
25. spmd    the SPMD runtime (``sharding.spmd``) across every card of the
            machine, one rank a card (NCCL; one rank on a one-card
            machine), on a mesh of n ranks along ``model``: qwen3-14b
            ``decode_step`` on rings
            (4 slots of 512 rows) and a mamba2-1.3b 4 x 512 ``prefill``
            at full width, seeded bf16 weights drawn on the card. Gates on
            every rank: the live collectives (``CollectiveCounter``) equal
            those of the same steps counted on meta under ``counting``; the
            sharded prefill launches the SSD kernel on the tc route (> 0);
            logits bit-equal to the same step with no mesh on one rank; on
            more, the qwen3 decode's within 3e-2 of the logit scale (greedy
            tokens equal unless at a near tie) and the mamba2 prefill's in
            f32 within 1e-4 (its bf16 gap printed). Prints each rank's collectives, the host
            wall beside the unsharded step's, and with two ranks or more
            the profiler's NCCL time beside the counted t_collective.
            Each rank also runs both steps through the compile cache, one
            CUDA graph a rank a step with its NCCL collectives inside
            (captured, then replayed), and a mamba2-1.3b train_4k Wine app
            (``reduced``: 8 of 48 layers, 2 rows of 256) through
            ``WineAdapter(mesh=...)``: the replays' collectives equal the
            counted ones, their SSD launches all tc, their logits meet the
            eager sharded step's gates (bit-equal on one rank), NCCL
            kernels show in a profiled replay (2+ ranks), the Wine app is
            compiled and its losses within 2e-5 of its eager sharded
            ones.
            ``python3 chip_smoke.py --spmd`` runs this phase alone.

Every model's weights are freed before the next one is drawn; the script's
total time is printed. The last three lines: the card's name and power
limit (nvidia-smi), the kernels' JSON record, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import ctypes
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import unittest.mock
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


def card_settings() -> None:
    """TF32 off for float32 products; bf16 products reduce in f32, as the
    reference's do (no bf16 split-K)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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
                 "mla": ("paged_mla_kernel", "paged_combine_kernel"),
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
               dict(scale=1.0 / math.sqrt(16 + 8))),
              # ... with v the tensor k and Dk 64 + Dk2 16, 8-row pages: the
              # mla route in bf16 (two row tiles, five key tiles, a
              # part-filled table), general in f32
              ("mla_shared_kv", shared_kv, dict(scale=0.125))]
    return cases


def shared_kv(dtype):
    """An MLA prefill whose values are its keys (one ckv pool, as the model
    passes it): G = 64 heads over one latent head."""
    a = problem(12, dtype, S=2, H=64, K=1, Dk=64, Dv=64, P=40, ps=8,
                npps=20, filled=[20, 13], q2dim=16, q_from_zero=True)
    a["v"] = a["k"]
    return a


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
# leave split and tile out: bf16 takes the mla route, f32 the general one
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


def mla_measure(paged_attention, paged_attention_ref, a, route):
    """Times of one MLA paged call (device, call) on ``route``, the general
    kernel's device time on the same inputs (the route forced for that
    loop alone), its plain version and SDPA on the gathered view (q and k
    as [q_abs | q_rope] and [ckv | kr], 576 columns, v the 512 ckv
    columns), and the bound: the live ckv and kr rows read once (k = v is
    one tensor), kpos, tables, q, q2, q_pos and the output, against 2 *
    pairs * H * (Dk + Dk2 + Dv) flops."""
    from repro_torch.kernels import paged_attention as pa
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
    names = PAGED_KERNELS[route]
    if route == "mla" and pa._plan(
            pa._shape(q, k, a["v"], q2, tables),
            pa._n_sm(q.device.index or 0), pa._library_smem())[1] == 1:
        names = names[:1]                 # unsplit: no combine kernel
    dev, parts = device_ms(lambda: call(paged_attention, a, scale=MLA_SCALE),
                           names)
    plan = pa._plan
    pa._plan = lambda *args: ("general", 0, 0, 0)
    try:
        general, _ = device_ms(
            lambda: call(paged_attention, a, scale=MLA_SCALE),
            PAGED_KERNELS["general"], reps=5 if a["q"].shape[1] > 1 else 30)
    finally:
        pa._plan = plan
    return dict(
        ms=time_ms(lambda: call(paged_attention, a, scale=MLA_SCALE)),
        device_ms=dev, device_parts=parts, general_device_ms=general,
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
    and the kernel's default scale 1/sqrt(Dk + Dk2) = 1/sqrt(576). f32 on
    the general route, bf16 on the mla route; the bf16 call timed, beside
    the general kernel on the same inputs."""
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
        check(route == "mla", f"mla {name} bf16: route {route}")
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
                                           paged_attention_ref, b, route))
        del b
        torch.cuda.empty_cache()
        ctl = ", ".join(f"{n}: {c}" for n, c in offs.items())
        sdpa = (f"{r['sdpa_ms']:.4f}ms ({r['sdpa_backend']})"
                if r["sdpa_ms"] is not None else "null (refused)")
        dev = " + ".join(f"{n} {ms:.4f}"
                         for n, ms in r["device_parts"].items())
        print(f"[kernels] mla {name}: B=4 S={kw['S']} H=128 K=1 Dk=512+64 "
              f"Dv=512 ps=16 npps={kw['npps']} live pages/slot="
              f"{kw['filled'][0]} route={route}: f32 max_abs_err="
              f"{err32:.3e} against the plain version; bf16 {err:.3e} "
              f"against its f32 answer (limit {FLASH_ATOL:g} + "
              f"{FLASH_RTOL:g}|ref|: one bf16 rounding); controls over the "
              f"limit ({ctl}), fail as they must; device="
              f"{r['device_ms']:.4f}ms ({dev}) call={r['ms']:.4f}ms (wrapper"
              f" + kernel) general_device={r['general_device_ms']:.4f}ms "
              f"plain={r['plain_ms']:.4f}ms bound="
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
             ("pipe128", (1, 128, 64, 64, 128, 256)),  # [pipeline]'s stages
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
              backend=None, first_pool=False, warm=False, **kw):
    """The main path: ``serve`` over ``waves`` with every kernel's launch
    count set to 0 just before and read just after (``kernel_fn``'s is
    returned; the others must stay 0; with ``kernel_fn`` None all must); every
    prefill dispatch and decode step of the engine (``kw["engine"]``: the
    paged one by default, or the fixed one) is watched for non-finite logits
    after its executable returns, outside any graph. Every executable of
    the engine — the decode step and each prefill key (``prefill_b{B}_s{S}``,
    ``warm_s{S}``, ``prefill_s{S}``) — is captured once and replayed after
    (``capture_step``, the engine's default) or run eagerly, on a compile
    cache of its own (freed with the engine) — ``backend``'s, where one is
    given. ``eng.capture`` notes the sources, the cache's capture and
    replay counts, the graph pools and their bytes (with ``first_pool``,
    also as they stood after the first prefill dispatch), the launches
    made inside replays, each wave's TTFT p50, the engine's construction
    seconds and the captures made there (ahead) and on the request path.
    ``warm``: the backend's cache directory holds the records of an
    earlier engine of this configuration, so every executable reads
    "disk" and is captured at construction; the request path only
    replays."""
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import COUNTED, CompileCache
    from repro_torch.core.telemetry import class_summary
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.serve import serve
    from repro_torch.serve import engine as engine_mod
    counters = (paged_attention, ssd_scan, flash_attention)
    finite = []
    paged, fixed = engine_mod.PagedServeEngine, engine_mod.ServeEngine
    methods = ((paged, "_prefill_exec"), (paged, "_warm_exec"),
               (paged, "_decode"), (fixed, "_prefill"), (fixed, "_decode"))
    saved = [getattr(cls, name) for cls, name in methods]

    pool_after_first = []

    def seen(out, prefill=False):
        logits = out[0] if isinstance(out, tuple) else out
        finite.append(bool(torch.isfinite(logits).all()))
        if prefill and first_pool and capture_step and not pool_after_first:
            pool_after_first.append(_graph_pool_bytes(backend.cache))
        return out

    def watched_exec(get):
        def exec_of(self, *shape):
            exe = get(self, *shape)
            return lambda *args: seen(exe(*args), prefill=True)
        return exec_of

    def watched(fn):
        prefill = fn.__name__ == "_prefill"
        return lambda self, *args: seen(fn(self, *args), prefill)

    def restore():
        for (cls, name), fn in zip(methods, saved):
            setattr(cls, name, fn)

    for (cls, name), fn in zip(methods, saved):
        setattr(cls, name, (watched_exec if name.endswith("_exec")
                            else watched)(fn))
    if backend is None:
        backend = ArrayBackend(cache=CompileCache(persistent=False),
                               device=DEV)
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
        launches = kernel_fn.launches if kernel_fn is not None else 0
        others = {fn.__name__: fn.launches for fn in counters
                  if fn is not kernel_fn}
    finally:
        restore()
    cache = backend.cache
    st, src = cache.stats, dict(eng.stats["compile_sources"])
    graphs = [g for exe in cache._mem.values()
              for g in getattr(exe, "graphs", {}).values()]
    in_replays = {fn.__name__: sum(g.replays * g.counts[i][0]
                                   for g in graphs)
                  for i, fn in enumerate(COUNTED)}
    n_prefill = len(src) - 1
    ttft, done = [], 0
    for w in waves:
        ttft.append(class_summary(eng.records[done:done + len(w)])[
            "interactive"]["p50_ttft_s"])
        done += len(w)
    ahead = eng.stats["captured_ahead"]
    eng.capture = dict(
        source=src["step"], sources=src, captures=st["captures"],
        captured_ahead=ahead, request_captures=st["captures"] - ahead,
        t_build_s=eng.stats["t_build_s"],
        replays=st["replays"], t_capture_s=st["t_capture_s"],
        pools=len({g.graph.pool() for g in graphs}),
        pool_bytes=_graph_pool_bytes(cache) if graphs else 0,
        launches_in_replays=in_replays, wave_ttft_p50_s=ttft,
        first_pool_bytes=pool_after_first[0] if pool_after_first else None)
    print(f"[{tag}] {cfg.name}: compile sources {json.dumps(src)}"
          + (f"; engine built in {eng.stats['t_build_s']:.2f}s with {ahead} "
             f"captures ahead; {st['captures']} captures "
             f"({st['t_capture_s']:.2f}s with "
             f"their warm-up calls), {st['replays']} replays of "
             f"{eng.stats['steps']} steps + {eng.stats['prefill_dispatches']}"
             f" prefill dispatches; {eng.capture['pools']} graph pool(s) "
             f"holding {eng.capture['pool_bytes'] / 2**20:.1f} MiB; launches "
             f"inside replays {json.dumps(in_replays)}" if capture_step
             else "") + f"; launches of the other kernels "
          f"{json.dumps(others)}; TTFT p50 by wave "
          f"{[round(t * 1e3, 1) for t in ttft]} ms")
    if capture_step:
        # cold: each executable captured on its first call, replayed after;
        # warm: each captured ahead, at construction, every call a replay
        calls = eng.stats["steps"] + eng.stats["prefill_dispatches"]
        want = dict(source="disk" if warm else "compiled",
                    captures=1 + n_prefill,
                    ahead=1 + n_prefill if warm else 0,
                    replays=calls - (0 if warm else 1 + n_prefill))
        check(set(src.values()) == {want["source"]} and n_prefill > 0
              and st["captures"] == want["captures"]
              and ahead == want["ahead"]
              and st["replays"] == want["replays"],
              f"[{tag}] executables not each captured once and replayed "
              f"after: {eng.capture}, expected {want}")
        # the step and the prefills bind the same weights and caches
        check(eng.capture["pools"] == 1, f"[{tag}] {eng.capture['pools']} "
              "graph pools for one engine")
    else:
        check(set(src.values()) == {"eager"}, f"[{tag}] sources {src}")
    check(not any(others.values()), f"other kernels launched: {others}")
    check(all(r.done and len(r.out) == r.max_new for w in waves for r in w),
          "a request did not finish")
    if hasattr(eng, "pool"):
        eng.pool.check()
    check(finite and all(finite), "non-finite logits")
    return eng, launches


def serve_numbers(eng, wave, launches):
    """A wave's numbers, from its own requests: TTFT and TPOT p50, and its
    wall from the first enqueue to the last finish."""
    from repro_torch.core.telemetry import class_summary
    st = eng.stats
    summ = class_summary([r.record() for r in wave])["interactive"]
    n_tok = sum(len(r.out) for r in wave)
    wall = (max(r.t_done for r in wave)
            - min(r.t_enqueue for r in wave))
    return dict(launches=launches, ttft_p50_s=summ["p50_ttft_s"],
                tpot_p50_s=summ["p50_tpot_s"], wall_s=wall,
                tokens=n_tok, tokens_per_s=n_tok / wall,
                peak_bytes=torch.cuda.max_memory_allocated(),
                peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                prefix_hits=st.get("prefix_hits", 0), steps=st["steps"],
                prefill_dispatches=st["prefill_dispatches"],
                step=getattr(eng, "capture", None))


def print_serve(tag, wave, out, card):
    print(f"[{tag}] {len(wave)} requests, {out['tokens']} tokens in "
          f"{out['wall_s']:.3f}s: TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms, "
          f"TPOT p50 {out['tpot_p50_s'] * 1e3:.2f} ms, "
          f"{out['tokens_per_s']:.1f} tokens/s; peak memory "
          f"{out['peak_bytes'] / 2**30:.2f} GiB allocated, "
          f"{out['peak_reserved_bytes'] / 2**30:.2f} GiB reserved; "
          + ("" if "fixed" in tag else "pool check clean; ")
          + f"all logits finite; on {card}")


def greedy(logits):
    """(steps, B, V) logits -> greedy tokens and top-2 gaps, on the host."""
    top2 = torch.topk(logits, 2, dim=-1)[0]
    return (logits.argmax(-1).cpu().numpy(),
            (top2[..., 0] - top2[..., 1]).cpu().numpy())

def print_replayed_wave(tag, eng, first, again, launches):
    """The same wave served again on the same engine, where every prefill
    shape the first wave captured is replayed: its TTFT, TPOT and tokens
    a second beside the first wave's (the phase's numbers), and the gate
    that its tokens equal the first wave's."""
    a, b = (serve_numbers(eng, w, launches) for w in (first, again))
    same = ([list(map(int, r.out)) for r in first]
            == [list(map(int, r.out)) for r in again])
    print(f"[{tag}] the wave again, every prefill replayed: TTFT p50 "
          f"{b['ttft_p50_s'] * 1e3:.1f} ms (first wave, capturing: "
          f"{a['ttft_p50_s'] * 1e3:.1f}), TPOT p50 "
          f"{b['tpot_p50_s'] * 1e3:.2f} ms ({a['tpot_p50_s'] * 1e3:.2f}), "
          f"{b['tokens_per_s']:.1f} tokens/s ({a['tokens_per_s']:.1f}); "
          f"tokens equal to the first wave's: {same}")
    check(same, f"[{tag}] the replayed wave's tokens differ from the first "
          "wave's")
    return dict(ttft_p50_s=b["ttft_p50_s"], tpot_p50_s=b["tpot_p50_s"],
                tokens_per_s=b["tokens_per_s"], wall_s=b["wall_s"])


def phase_varied_lengths(cfg, params, kernel_fn, tag, lengths, engine,
                         card, capacity=1024, **kw):
    """One wave of prompts whose lengths are all distinct and new to the
    engine (``lengths``, 4 new tokens each), on a fresh engine whose
    executables are captured and on one run eagerly, one after the other:
    the traffic where an exact-length key (the fixed engine's
    ``prefill_s{S}``, an SSM config's exact-length groups) never replays,
    so every dispatch pays its warm-up and capture. Prints each engine's
    TTFT p50, the captures and the graph pool's bytes; gates the tokens
    equal, one key a length, one pool, and the pool's growth past the
    first length below one length's KV rings (a graph that kept its
    rings would add one set a length)."""
    from repro_torch.models.lm import cache_init
    from repro_torch.serve.engine import Request
    from torch.utils import _pytree as pytree
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, cfg.vocab, n) for n in lengths]
    res = {}
    for capture in (True, False):
        wave = [Request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(prompts)]
        eng, _ = run_serve(cfg, params, [wave], kernel_fn,
                           tag=f"{tag}-{'graph' if capture else 'eager'}",
                           capture_step=capture, engine=engine, slots=4,
                           capacity=capacity, first_pool=True, **kw)
        res[capture] = dict(serve_numbers(eng, wave, 0),
                            outs=[list(map(int, r.out)) for r in wave])
        res[capture]["capture"] = res[capture].pop("step")
    g, e = res[True], res[False]
    keys = {k for k in g["capture"]["sources"] if k != "step"}
    ring = (sum(x.numel() * x.element_size() for x in pytree.tree_leaves(
        cache_init(cfg, 1, capacity, "meta"))) if engine == "fixed" else None)
    print(f"[{tag}] {cfg.name}, {engine} engine, one wave of {len(lengths)} "
          f"prompt lengths never seen before {list(lengths)}: TTFT p50 "
          f"{g['ttft_p50_s'] * 1e3:.1f} ms captured on first use vs "
          f"{e['ttft_p50_s'] * 1e3:.1f} ms eager (one run), TPOT p50 "
          f"{g['tpot_p50_s'] * 1e3:.2f} vs {e['tpot_p50_s'] * 1e3:.2f} ms; "
          f"{len(keys)} prefill keys, {g['capture']['captures']} captures "
          f"({g['capture']['t_capture_s']:.2f}s with their warm-up calls); "
          f"{g['capture']['pools']} graph pool, "
          f"{g['capture']['pool_bytes'] / 2**20:.1f} MiB ("
          f"{g['capture']['first_pool_bytes'] / 2**20:.1f} after the first "
          f"length)"
          + (f" (one length's rings: {ring / 2**20:.1f} MiB)" if ring else "")
          + f"; tokens equal {g['outs'] == e['outs']}; on {card}")
    check(g["outs"] == e["outs"], f"[{tag}] captured tokens differ from "
          "eager's")
    check(len(keys) == g["capture"]["captures"] - 1
          and g["capture"]["pools"] == 1,
          f"[{tag}] keys {sorted(keys)}, {g['capture']}")
    if ring:
        check(g["capture"]["pool_bytes"] < g["capture"]["first_pool_bytes"]
              + ring, f"[{tag}] the pool grew past one length's rings: "
              f"{g['capture']}")
    return dict(graph={k: v for k, v in g.items() if k != "outs"},
                eager={k: v for k, v in e.items() if k != "outs"},
                lengths=list(lengths), ring_bytes=ring)


def serve_traffic(cfg):
    """``[serve]``'s two waves: a 64-token system prompt, then 8 requests
    of 128 prompt tokens and 16 generated, half extending the system
    prompt."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab, 64)
    first = [Request(rid=0, prompt=system.copy(), max_new=16)]
    wave = ([Request(rid=1 + i, prompt=np.concatenate(
        [system, rng.integers(1, cfg.vocab, 64)]), max_new=16)
        for i in range(4)]
        + [Request(rid=5 + i, prompt=rng.integers(1, cfg.vocab, 128),
                   max_new=16) for i in range(4)])
    return first, wave


def phase_serve(cfg, params, paged_attention, card, capacity=512,
                tag="serve", routes=("split", "tile"), capture_step=True):
    first, wave = serve_traffic(cfg)
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
    dispatch and once a decode step — and once a call captured ahead at
    construction (the step, each recorded prefill): every decode step on
    the ``decode`` route, every prefill dispatch on ``prefill``. Returns
    the routes."""
    st = eng.stats
    ahead = st["captured_ahead"]
    steps = st["steps"] + min(ahead, 1)
    prefills = st["prefill_dispatches"] + max(ahead - 1, 0)
    layers = cfg.n_layers
    print(f"[{tag}] paged_attention launches={launches} = {layers} layers x "
          f"({st['prefill_dispatches']} prefill dispatches "
          f"[{st['prefix_hits']} warm] + {st['steps']} decode steps"
          + (f" + {ahead} calls captured ahead" if ahead else "") + ")")
    check(launches == layers * (steps + prefills),
          f"launches {launches} != {layers} x {steps + prefills}")
    routes = dict(paged_attention.routes)
    want = dict.fromkeys(routes, 0)
    want[decode] += layers * steps
    want[prefill] += layers * prefills
    print(f"[{tag}] paged_attention routes {json.dumps(routes)}: every "
          f"decode step on {decode}, every prefill dispatch on {prefill}")
    check(routes == want, f"routes {routes}, expected {want}")
    return routes


def tie_gate(tag, a, b, gaps):
    """Gate: greedy tokens ``a`` and ``b`` (steps, B) agree in every slot
    up to the first near-tie (``gaps``: ``a``'s top-2 gaps)."""
    for s in range(a.shape[1]):
        diff = np.nonzero(a[:, s] != b[:, s])[0]
        if diff.size:
            check(gaps[diff[0], s] < ULP_TIE,
                  f"[{tag}] slot {s}: tokens diverge at step {diff[0]} with "
                  f"top-2 gap {gaps[diff[0], s]:.4f} >= {ULP_TIE}")


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
            step, _ = ArrayBackend(
                cache=CompileCache(persistent=False)).compile(
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
    tie_gate(tag, a, b, gaps)
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
        cache = CompileCache(persistent=False)
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
# the health scorer's scale is at least half the fleet's median wall an
# instance, and it flags an outlier 6 scales above that median: a node
# must run ~4x slower than its peers. A healthy thread node's shard of 16
# instances takes milliseconds on the card whatever its size (dispatch,
# event wait and harvest on a shared host), and more when the host is
# loaded, so a 0.05 s throttle can fall under 4x; 0.1 s doubles the margin
# (tools/dist_health_margin.py measures it)
DIST_HEALTH_WAVE, DIST_HEALTH_THROTTLE_S = 64, 0.1


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
            if nr["compile_source"] in ("compiled", "disk"):
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
    segments of their memory pools (one pool for every graph of a binding,
    ``CompileCache.pools``)."""
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
    within 3 waves, and one throttled to 0.1 s a shard that
    ``health_verdicts()`` names ``outlier`` and the others ``healthy``."""
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
        be.agents["node1"].throttle(DIST_HEALTH_THROTTLE_S)
        _, rep = llmr.map_reduce(app, x[:10 * DIST_HEALTH_WAVE])
        verdicts = be.health_verdicts()
        scores = {nid: (d["z"], d["wall_per_instance_s"])
                  for nid, d in sorted(be.registry.health.detail().items())}
        print(f"[dist] health: node1 at {DIST_HEALTH_THROTTLE_S} s a "
              f"shard; verdicts {json.dumps(verdicts)}; report "
              f"{json.dumps(rep.health)}; (z, recent wall an instance s) "
              f"by node {json.dumps(scores)}")
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
    """``[serve-ssm]``'s two waves again with ``PagedServeEngine(backend=<a
    2-node DistributedBackend>)``: the engine compiles its decode step and
    prefills through the fabric's driver-side cache and replays them
    there, so the SSD kernel stays on the path. Gates: the tokens equal
    ``[serve-ssm]``'s, as many SSD launches, every one on ``tc``. The
    first wave gives the phase's numbers, the replayed one a line of its
    own."""
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.dist import DistributedBackend
    waves = [ssm_wave(cfg), ssm_wave(cfg)]
    wave = waves[0]
    fabric = DistributedBackend(n_nodes=2, device=DEV,
                                cache=CompileCache(persistent=False),
                                heartbeat_timeout_s=5.0)
    try:
        eng, launches = run_serve(cfg, params, waves, ssd_scan,
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
    out["replayed_wave"] = print_replayed_wave("dist-serve", eng, *waves,
                                               launches)
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
    cache = CompileCache(persistent=False)
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
    """``[serve]``'s traffic again with every executable of the engine
    captured (the decode step and the three prefill keys: ``prefill_b4_s64``
    for the system prompt, ``warm_s64`` for the prefix hits,
    ``prefill_b4_s128`` for the fresh prompts; each captured on its first
    use, replayed after): every launch counted on the routes of the eager
    ``[serve]``, its numbers and each wave's TTFT beside ``[serve]``'s of the
    same run, its tokens equal to ``[serve]``'s up to the first near-tie,
    and the gates: lockstep of the captured step, and of the captured
    prefills (``[lockstep-prefill]``), against eager calls."""
    out = phase_serve(cfg, params, paged_attention, card, tag="serve-graph")
    first, wave = serve_traffic(cfg)
    reqs = first + wave
    same = sum(a == b for x, y in zip(out["outs"], eager["outs"])
               for a, b in zip(x, y))
    total = sum(len(x) for x in out["outs"])
    check(out["routes"] == eager["routes"],
          f"[serve-graph] routes {out['routes']} against [serve]'s "
          f"{eager['routes']}")
    keys = {k for k in out["step"]["sources"] if k != "step"}
    check(keys == {"prefill_b4_s64", "warm_s64", "prefill_b4_s128"},
          f"[serve-graph] prefill keys {sorted(keys)}")
    n_req, n_tok = equal_up_to_near_tie(cfg, params, reqs, out["outs"],
                                        eager["outs"], 512, "serve-graph",
                                        "serve")
    ttft = out["step"]["wave_ttft_p50_s"]
    ttft_eager = eager["step"]["wave_ttft_p50_s"]
    print(f"[serve-graph] {cfg.name}: graphs vs eager engine (one run): TTFT "
          f"p50 {out['ttft_p50_s'] * 1e3:.1f} vs "
          f"{eager['ttft_p50_s'] * 1e3:.1f} ms (first wave, the system "
          f"prompt: {ttft[0] * 1e3:.1f} vs {ttft_eager[0] * 1e3:.1f}; second "
          f"wave: {ttft[1] * 1e3:.1f} vs {ttft_eager[1] * 1e3:.1f}), TPOT p50 "
          f"{out['tpot_p50_s'] * 1e3:.2f} vs {eager['tpot_p50_s'] * 1e3:.2f} "
          f"ms, {out['tokens_per_s']:.1f} vs {eager['tokens_per_s']:.1f} "
          f"tokens/s; captures {out['step']['t_capture_s']:.2f}s (with their "
          f"warm-up calls); graph pools {out['step']['pools']}, "
          f"{out['step']['pool_bytes'] / 2**20:.1f} MiB; peak memory "
          f"{out['peak_bytes'] / 2**30:.2f} vs "
          f"{eager['peak_bytes'] / 2**30:.2f} GiB; served tokens equal to "
          f"[serve]'s at {same}/{total} ({n_req}/{len(reqs)} requests whole; "
          f"any difference only after a near-tie)")
    out["tokens_equal_to_eager_serve"] = [same, total]
    out["lockstep"] = phase_lockstep(cfg, params, tag="lockstep-graph",
                                     graph=True)
    return out


# ---------------------------------------------------------------------------
# The compile cache's lifetime: a later process, and engines dropped
# ---------------------------------------------------------------------------

def restart_child(role: str, cache_dir: str) -> int:
    """``[restart]``'s process A (``role`` "A", over an empty cache
    directory) or B ("B", over the directory A filled): qwen3-14b at full
    width, drawn from seed 0, on ``[serve-graph]``'s traffic through
    ``serve`` over a compile cache on ``cache_dir``, gated by
    ``run_serve`` — A cold; B warm, every executable captured ahead at
    construction and only replayed on the request path. The last line is
    one JSON object of its numbers and tokens."""
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    card_settings()
    from repro_torch.configs import get_config
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch.serve import init_params
    cfg = get_config("qwen3-14b")
    t0 = time.perf_counter()
    params = init_params(cfg, DEV, seed=0)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    first, wave = serve_traffic(cfg)
    tag = f"restart-{role}"
    eng, launches = run_serve(
        cfg, params, [first, wave], paged_attention, tag=tag, slots=4,
        capacity=512, page_size=16, kernel="paged", prefix_sharing=True,
        backend=ArrayBackend(cache=CompileCache(cache_dir=cache_dir),
                             device=DEV), warm=role == "B")
    routes = check_paged_routes(eng, launches, paged_attention, cfg, tag)
    out = serve_numbers(eng, wave, launches)
    one = serve_numbers(eng, first, launches)
    out.update(routes=routes, t_draw_s=t_draw,
               first_wave=dict(ttft_p50_s=one["ttft_p50_s"],
                               tpot_p50_s=one["tpot_p50_s"]),
               outs=[list(map(int, r.out)) for r in first + wave])
    print(json.dumps(out))
    return 0


def _restart_line(tag, role, r, card):
    c = r["step"]
    print(f"[{tag}] process {role}: engine built in {c['t_build_s']:.2f}s "
          f"({c['captured_ahead']} captures ahead), {c['request_captures']}"
          f" captures on the request path, {c['replays']} replays; sources "
          f"{json.dumps(c['sources'])}; TTFT p50 by wave "
          f"{[round(t * 1e3, 1) for t in c['wave_ttft_p50_s']]} ms, TPOT "
          f"p50 first wave {r['first_wave']['tpot_p50_s'] * 1e3:.2f} ms, "
          f"last {r['tpot_p50_s'] * 1e3:.2f} ms; {c['pools']} graph pool(s), "
          f"{c['pool_bytes'] / 2**20:.1f} MiB; launches "
          f"{r['launches']}, {json.dumps(c['launches_in_replays'])} inside "
          f"replays; on {card}")


def _restart_gates(tag, cfg, a, b, kernel):
    """B read "disk" for every key A captured, captured each ahead and
    nothing on the request path, where every launch of ``kernel`` ran
    inside a replay; B's tokens equal A's."""
    keys = set(a["step"]["sources"])
    check(b["step"]["sources"] == dict.fromkeys(keys, "disk"),
          f"[{tag}] B's sources {b['step']['sources']} against A's keys "
          f"{sorted(keys)}")
    check(b["step"]["request_captures"] == 0
          and b["step"]["captured_ahead"] == len(keys),
          f"[{tag}] B captured {b['step']['captured_ahead']} ahead and "
          f"{b['step']['request_captures']} on the request path")
    calls = b["steps"] + b["prefill_dispatches"] if kernel == \
        "paged_attention" else b["prefill_dispatches"]
    inside = b["step"]["launches_in_replays"][kernel]
    check(inside == cfg.n_layers * calls,
          f"[{tag}] {kernel}: {inside} launches inside B's replays, "
          f"expected {cfg.n_layers} x {calls}")
    same = sum(x == y for p, q in zip(a["outs"], b["outs"])
               for x, y in zip(p, q))
    total = sum(len(p) for p in a["outs"])
    check(same == total and total > 0,
          f"[{tag}] B's tokens equal A's at {same}/{total}")
    return [same, total]


def phase_restart(card, root):
    """Two processes over one compile-cache directory, one after the
    other (``restart_child``): A fills it, B captures every recorded
    shape at construction. Each draws its own 29.5 GB of weights; this
    process holds none then (run after the qwen3-14b phases freed theirs).
    Gates: ``_restart_gates`` (144 of 144 tokens)."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-14b")
    d = tempfile.mkdtemp(prefix="restart-",
                         dir=os.environ["REPRO_COMPILE_CACHE_DIR"])
    print(f"[restart] this process holds "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved while "
          "its two children run")
    runs = {}
    for role in "AB":
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, str(root / "chip_smoke.py"),
                            "--restart-child", role, d], cwd=root,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(f"[restart] {role} | {line}")
        check(p.returncode == 0 and lines,
              f"[restart] process {role} exited {p.returncode}: "
              f"{p.stderr[-4000:]}")
        runs[role] = r = json.loads(lines[-1])
        r["process_wall_s"] = wall
        _restart_line("restart", role, r, card)
    a, b = runs["A"], runs["B"]
    tokens = _restart_gates("restart", cfg, a, b, "paged_attention")
    print(f"[restart] qwen3-14b: B's engine built in "
          f"{b['step']['t_build_s']:.2f}s against A's "
          f"{a['step']['t_build_s']:.2f}s, first wave TTFT p50 "
          f"{b['first_wave']['ttft_p50_s'] * 1e3:.1f} against "
          f"{a['first_wave']['ttft_p50_s'] * 1e3:.1f} ms, second wave "
          f"{b['ttft_p50_s'] * 1e3:.1f} against {a['ttft_p50_s'] * 1e3:.1f}"
          f" ms; processes {a['process_wall_s']:.1f}s / "
          f"{b['process_wall_s']:.1f}s (weights drawn in "
          f"{a['t_draw_s']:.1f}s / {b['t_draw_s']:.1f}s); tokens equal at "
          f"{tokens[0]}/{tokens[1]}; on {card}")
    for r in runs.values():
        r.pop("outs")
    return dict(A=a, B=b, tokens_equal=tokens)


def phase_restart_ssm(cfg, params, ssd_scan, card):
    """``[restart]`` for mamba2-1.3b on ``[serve-ssm]``'s wave, in this
    process: A's engine over an empty directory, dropped; then B, a fresh
    compile cache over the same directory (the later process's part).
    Gates: ``_restart_gates`` — every ``ssd_scan`` launch of B's request
    path inside a replay of a graph captured ahead — and every launch on
    the tc route."""
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    d = tempfile.mkdtemp(prefix="restart-ssm-",
                         dir=os.environ["REPRO_COMPILE_CACHE_DIR"])
    runs = {}
    for role in "AB":
        wave = ssm_wave(cfg)
        tag = f"restart-ssm-{role}"
        eng, launches = run_serve(
            cfg, params, [wave], ssd_scan, tag=tag, slots=4, capacity=1024,
            page_size=16, kernel="auto",
            backend=ArrayBackend(cache=CompileCache(cache_dir=d), device=DEV),
            warm=role == "B")
        routes = dict(ssd_scan.routes)
        check(routes["tc"] == launches > 0,
              f"[{tag}] ssd_scan: {launches} launches, routes {routes}")
        r = runs[role] = serve_numbers(eng, wave, launches)
        r.update(routes=routes, first_wave=dict(
            ttft_p50_s=r["ttft_p50_s"], tpot_p50_s=r["tpot_p50_s"]),
            outs=[list(map(int, q.out)) for q in wave])
        del eng
        gc.collect()
        _restart_line("restart-ssm", role, r, card)
    a, b = runs["A"], runs["B"]
    tokens = _restart_gates("restart-ssm", cfg, a, b, "ssd_scan")
    print(f"[restart-ssm] mamba2-1.3b: B's engine built in "
          f"{b['step']['t_build_s']:.2f}s against A's "
          f"{a['step']['t_build_s']:.2f}s, TTFT p50 "
          f"{b['ttft_p50_s'] * 1e3:.1f} against {a['ttft_p50_s'] * 1e3:.1f}"
          f" ms; tokens equal at {tokens[0]}/{tokens[1]}; on {card}")
    for r in runs.values():
        r.pop("outs")
    return dict(A=a, B=b, tokens_equal=tokens)


def phase_engine_churn(cfg, params, card, n=5):
    """qwen3-14b ``PagedServeEngine``s over the same weights and one
    compile cache, each built, serving ``[serve]``'s second wave, and
    dropped, ``n`` times. After each drop: ``memory_reserved()``, the
    cache's pool count and its pools' MiB. Gates: after the last drop the
    pool count is back to its value before the first engine, and
    ``memory_reserved()`` is within 64 MiB of its value after the first
    drop; every engine's tokens equal the first's (no stale graph)."""
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.serve.engine import PagedServeEngine
    cache = CompileCache(persistent=False)
    backend = ArrayBackend(cache=cache, device=DEV)
    gc.collect()
    torch.cuda.synchronize()
    pools0 = len(cache.pools)
    reads, outs = [], []
    for i in range(n):
        _, wave = serve_traffic(cfg)
        eng = PagedServeEngine(cfg, params, slots=4, page_size=16,
                               pages_per_slot=32, kernel="paged",
                               prefix_sharing=True, device=DEV,
                               backend=backend)
        eng.run(wave)
        outs.append([list(map(int, r.out)) for r in wave])
        live = dict(pools=len(cache.pools),
                    pool_mib=_graph_pool_bytes(cache) / 2**20,
                    reserved=torch.cuda.memory_reserved())
        del eng
        gc.collect()
        torch.cuda.synchronize()
        reads.append(dict(engine=i + 1, live=live,
                          reserved=torch.cuda.memory_reserved(),
                          pools=len(cache.pools),
                          pool_mib=_graph_pool_bytes(cache) / 2**20,
                          captures=cache.stats["captures"]))
        r = reads[-1]
        print(f"[engine-churn] engine {i + 1}: while it served "
              f"{live['pools']} pool(s), {live['pool_mib']:.1f} MiB, "
              f"{live['reserved'] / 2**20:,.0f} MiB reserved; dropped: "
              f"{r['pools']} pool(s), {r['pool_mib']:.1f} MiB, "
              f"memory_reserved() {r['reserved'] / 2**20:,.0f} MiB; "
              f"{r['captures']} captures so far; on {card}")
    grew = reads[-1]["reserved"] - reads[0]["reserved"]
    check(reads[-1]["pools"] == pools0,
          f"[engine-churn] {reads[-1]['pools']} pools after the last drop, "
          f"{pools0} before the first engine")
    check(grew <= 64 * 2**20,
          f"[engine-churn] memory_reserved() grew {grew / 2**20:.1f} MiB "
          "from the first drop to the last")
    check(all(o == outs[0] for o in outs),
          "[engine-churn] an engine's tokens differ from the first's")
    print(f"[engine-churn] {n} engines built and dropped: pools "
          f"{pools0} -> {reads[-1]['pools']}, memory_reserved() after the "
          f"first drop {reads[0]['reserved'] / 2**20:,.0f} MiB, after the "
          f"last {reads[-1]['reserved'] / 2**20:,.0f} MiB ({grew / 2**20:+.1f}"
          f"); tokens of every engine equal; on {card}")
    drop = drop_while_serving(cfg, params, backend, card)
    gc.collect()            # the live engine's timed step made it a cycle
    torch.cuda.synchronize()
    check(len(cache.pools) == pools0,
          f"[engine-churn] {len(cache.pools)} pools after the live engine "
          f"went, {pools0} before the first engine")
    return dict(pools_before=pools0, reads=reads, reserved_growth=grew,
                drop_while_serving=drop)


def drop_while_serving(cfg, params, backend, card):
    """What dropping an engine costs one that is serving: engine L serves
    ``[serve]``'s second wave three times (once to capture its shapes, a
    baseline, and once while a thread drops engine D, built and served
    before, after L's third decode step: D's graphs are released in that
    thread — its card synchronised, the cached blocks handed back — while
    L decodes). Printed: each wave's TPOT p50, its median and longest
    decode step, and the drop's seconds. Gates: the drop wave's tokens
    equal the baseline's, and D's pool goes while L's stays."""
    import threading
    from repro_torch.serve.engine import PagedServeEngine

    def build():
        return PagedServeEngine(cfg, params, slots=4, page_size=16,
                                pages_per_slot=32, kernel="paged",
                                prefix_sharing=True, device=DEV,
                                backend=backend)

    held = [build()]
    held[0].run(serve_traffic(cfg)[1])
    live = build()
    steps, go, dropped = [], threading.Event(), {}
    serve_step = live.step

    def timed_step():
        t = time.perf_counter()
        serve_step()                   # ends on the host's read of tokens
        steps.append(time.perf_counter() - t)
        if len(steps) == 3:
            go.set()

    def drop():
        go.wait()
        t = time.perf_counter()
        held.pop()          # the last reference: the release runs here
        dropped["s"] = time.perf_counter() - t

    live.step = timed_step
    waves = {}
    for name in ("capture", "baseline", "drop"):
        steps.clear()
        go.clear()
        wave = serve_traffic(cfg)[1]
        t = threading.Thread(target=drop) if name == "drop" else None
        if t:
            pools = len(backend.cache.pools)        # L's and D's
            t.start()
        live.run(wave)
        if t:
            t.join()
        out = serve_numbers(live, wave, None)
        waves[name] = dict(tpot_p50_s=out["tpot_p50_s"],
                           step_p50_s=float(np.median(steps)),
                           step_max_s=max(steps),
                           outs=[list(map(int, r.out)) for r in wave])
    base, hit = waves["baseline"], waves["drop"]
    check(hit["outs"] == base["outs"],
          "[engine-churn] the live engine's tokens changed under the drop")
    check(len(backend.cache.pools) == pools - 1,
          f"[engine-churn] {len(backend.cache.pools)} pools after the drop "
          f"under load, {pools} before it")
    print(f"[engine-churn] an engine dropped in another thread while one "
          f"serves: the drop took {dropped['s'] * 1e3:.1f} ms; the live "
          f"engine's TPOT p50 {hit['tpot_p50_s'] * 1e3:.2f} ms (baseline "
          f"{base['tpot_p50_s'] * 1e3:.2f}), decode step p50 "
          f"{hit['step_p50_s'] * 1e3:.2f} ms ({base['step_p50_s'] * 1e3:.2f})"
          f", longest {hit['step_max_s'] * 1e3:.2f} ms "
          f"({base['step_max_s'] * 1e3:.2f}); tokens equal; on {card}")
    for w in waves.values():
        w.pop("outs")
    return dict(drop_s=dropped["s"], **waves)


# ---------------------------------------------------------------------------
# The fixed-ring engine, the engine's obs hooks, the examples
# ---------------------------------------------------------------------------

def fixed_path_gap(cfg, params, prompt, toks, i, capacity):
    """Top-2 gap of the logits that chose token ``i`` of a request, along
    the fixed engine's own path: ``prefill`` of the prompt into rings of
    ``capacity`` rows, then ``toks[:i]`` through the decode step, the last
    hidden state projected in f32 (at full width the logits' scale is ~6,
    where one bf16 ulp is 0.03125: a bf16 gap reads a near-tie only in
    those steps)."""
    from repro_torch.models.layers import softcap
    from repro_torch.models.lm import decode_step, lm_hidden, prefill
    n = len(prompt)

    def tok(x):
        return torch.tensor([[x]], dtype=torch.int32, device=DEV)

    t = torch.as_tensor(np.asarray(prompt), dtype=torch.int32).to(DEV)
    if i == 0:
        h = lm_hidden(params, {"tokens": t[None]}, cfg)[0][:, -1:]
    else:
        _, caches = prefill(params, {"tokens": t[None]}, cfg,
                            capacity=capacity)
        for j in range(i - 1):
            decode_step(params, caches, tok(toks[j]), tok(n + j), cfg)
        h, _ = lm_hidden(params, {"tokens": tok(toks[i - 1]),
                                  "positions": tok(n + i - 1)}, cfg,
                         caches=caches)
    w = (params["embed"]["embedding"].T if cfg.tie_embeddings
         else params["lm_head"]["lm_head"])
    logits = h[0, -1].float() @ w.float()
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    top2 = torch.topk(logits, 2)[0]
    return float(top2[0] - top2[1])


def equal_up_to_near_tie(cfg, params, wave, outs, ref_outs, capacity, tag,
                         ref):
    """Gate: each request's tokens ``outs`` equal ``ref_outs`` up to the
    first near-tie (where they first differ, the f32 top-2 gap along the
    fixed path is below ``ULP_TIE``). Returns (requests equal, tokens
    equal)."""
    same = tokens = 0
    for req, a, b in zip(wave, outs, ref_outs):
        check(len(a) == len(b), f"[{tag}] request {req.rid}: {len(a)} "
              f"tokens against {ref}'s {len(b)}")
        diff = [j for j, (x, y) in enumerate(zip(a, b)) if x != y]
        tokens += len(a) - len(diff)
        if not diff:
            same += 1
            continue
        gap = fixed_path_gap(cfg, params, req.prompt, a, diff[0], capacity)
        print(f"[{tag}] request {req.rid}: tokens differ from {ref}'s at "
              f"{diff[0]} (f32 top-2 gap there {gap:.4f})")
        check(gap < ULP_TIE, f"[{tag}] request {req.rid} diverges from "
              f"{ref}'s at token {diff[0]} with top-2 gap {gap:.4f} >= "
              f"{ULP_TIE}")
    return same, tokens


def phase_lockstep_fixed(cfg, params, B=4, S=128, capacity=512, steps=8,
                         tag="lockstep-fixed"):
    """``prefill`` of B prompts of S tokens into rings of ``capacity`` rows,
    copied twice, then ``steps`` greedy steps of the fixed engine's decode
    step: eagerly on one copy, captured once and replayed on the other.
    Gate: tokens equal up to the first near-tie."""
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.models.lm import decode_step, prefill
    from torch.utils import _pytree as pytree
    r = np.random.default_rng(1)
    toks = torch.from_numpy(r.integers(1, cfg.vocab, (B, S)).astype(
        np.int32)).to(DEV)
    lg0, caches = prefill(params, {"tokens": toks}, cfg, capacity=capacity)
    twin = pytree.tree_map(torch.clone, caches)

    def step_fn(p, c, t, po):
        return decode_step(p, c, t, po, cfg)[0]

    pos0 = torch.full((B, 1), S, dtype=torch.int32, device=DEV)
    t0 = torch.argmax(lg0[:, 0], -1)[:, None].to(torch.int32)
    exe, _ = ArrayBackend(cache=CompileCache(persistent=False),
                          device=DEV).compile(
        step_fn, (params, twin, t0, pos0), bind_argnums=(0, 1))
    runs, stacks = {}, {}
    for mode, c, step in (("eager", caches, step_fn), ("graph", twin, exe)):
        logits, pos = [lg0[:, 0].float()], pos0
        for _ in range(steps):
            t = torch.argmax(logits[-1], -1)[:, None].to(torch.int32)
            logits.append(step(params, c, t, pos)[:, 0].float())
            pos = pos + 1
        lg = torch.stack(logits)
        check(bool(torch.isfinite(lg).all()), f"[{tag}] {mode}: non-finite "
              "logits")
        runs[mode], stacks[mode] = greedy(lg), lg
    check(exe.replays == steps - 1,
          f"[{tag}] {exe.replays} replays of {steps} steps")
    (a, gaps), (b, _) = runs["eager"], runs["graph"]
    tie_gate(tag, a, b, gaps)
    d = float((stacks["eager"] - stacks["graph"]).abs().max())
    print(f"[{tag}] {cfg.name}: replayed vs eager fixed decode step, "
          f"prefill of {B} x {S} into rings of {capacity} + {steps} steps: "
          f"tokens equal at {int((a == b).sum())}/{a.size} positions; logits "
          f"max |diff| {d:.3e}; ok")
    return dict(tokens_equal=int((a == b).sum()), tokens=int(a.size),
                logits_max_abs_diff=d)


def phase_serve_fixed(cfg, params, card, paged):
    """``[serve]``'s second wave on the fixed-ring engine (4 slots,
    capacity 512, no prefix sharing; the decode step replayed): one
    prefill dispatch a request, no kernel of the port launched (the rings'
    attention is the model's own); tokens equal ``[serve-graph]``'s paged
    engine's on the same requests up to the first near-tie, and equal, all
    of them, to the paged engine's on kernel "gather" with one-slot prefill
    (the reference's ``test_paged_tokens_bit_identical_to_fixed``: that
    path decodes over the same dense view); then the replayed step against
    eager ``decode_step`` calls."""
    _, wave = serve_traffic(cfg)
    eng, _ = run_serve(cfg, params, [wave], None, tag="serve-fixed",
                       engine="fixed", slots=4, capacity=512)
    st = eng.stats
    check(st["prefill_dispatches"] == st["admitted"] == len(wave),
          f"[serve-fixed] {st['prefill_dispatches']} prefill dispatches for "
          f"{st['admitted']} admitted of {len(wave)}")
    outs = [list(map(int, r.out)) for r in wave]
    out = serve_numbers(eng, wave, 0)      # before the twin's run: its peak
    _, twin = serve_traffic(cfg)
    run_serve(cfg, params, [twin], None, tag="serve-fixed-twin", slots=4,
              capacity=512, page_size=16, kernel="gather",
              batched_prefill=False)
    twin_equal = sum(list(map(int, r.out)) == o for r, o in zip(twin, outs))
    print(f"[serve-fixed] {twin_equal}/{len(wave)} requests' tokens equal, "
          f"all of them, to the paged engine's on kernel gather with one-slot "
          f"prefill")
    check(twin_equal == len(wave), "[serve-fixed] tokens differ from the "
          "paged engine's on kernel gather with one-slot prefill")
    same, toks = equal_up_to_near_tie(cfg, params, wave, outs,
                                      paged["outs"][1:], 512, "serve-fixed",
                                      "serve-graph")
    out.update(requests_equal_to_paged=[same, len(wave)],
               tokens_equal_to_paged=[toks, out["tokens"]],
               requests_equal_to_gather_one_slot=[twin_equal, len(wave)])
    print_serve("serve-fixed", wave, out, card)
    print(f"[serve-fixed] {cfg.name}: fixed vs paged engine ([serve-graph], "
          f"one run; both replay their decode step): TTFT p50 "
          f"{out['ttft_p50_s'] * 1e3:.1f} vs {paged['ttft_p50_s'] * 1e3:.1f} "
          f"ms, TPOT p50 {out['tpot_p50_s'] * 1e3:.2f} vs "
          f"{paged['tpot_p50_s'] * 1e3:.2f} ms, {out['tokens_per_s']:.1f} vs "
          f"{paged['tokens_per_s']:.1f} tokens/s, peak memory "
          f"{out['peak_bytes'] / 2**30:.2f} vs "
          f"{paged['peak_bytes'] / 2**30:.2f} GiB; {st['prefill_dispatches']}"
          f" prefill dispatches (one a request) and {st['steps']} steps; "
          f"{same}/{len(wave)} requests and {toks}/{out['tokens']} tokens "
          f"equal to the paged engine's; on {card}")
    out["lockstep"] = phase_lockstep_fixed(cfg, params)
    return out


def phase_serve_fixed_ssm(cfg, params, ssd_scan, card, ssm):
    """``[serve-ssm]``'s wave on the fixed-ring engine (4 slots, capacity
    1024): each request prefilled alone, so 48 SSD launches a request, all
    on ``tc``; tokens equal ``[serve-ssm]``'s up to the first near-tie."""
    wave = ssm_wave(cfg)
    eng, launches = run_serve(cfg, params, [wave], ssd_scan,
                              tag="serve-fixed-ssm", engine="fixed", slots=4,
                              capacity=1024)
    st = eng.stats
    routes = dict(ssd_scan.routes)
    print(f"[serve-fixed-ssm] ssd_scan launches={launches} = "
          f"{cfg.n_layers} layers x {st['prefill_dispatches']} prefill "
          f"dispatches (one a request); by route {json.dumps(routes)}")
    check(st["prefill_dispatches"] == st["admitted"] == len(wave),
          f"[serve-fixed-ssm] {st['prefill_dispatches']} prefill dispatches "
          f"for {st['admitted']} admitted of {len(wave)}")
    check(launches == cfg.n_layers * len(wave) and routes["tc"] == launches,
          f"[serve-fixed-ssm] ssd_scan launches {launches} ({routes}) != "
          f"{cfg.n_layers} x {len(wave)}, all on tc")
    outs = [list(map(int, r.out)) for r in wave]
    same, toks = equal_up_to_near_tie(cfg, params, wave, outs, ssm["outs"],
                                      1024, "serve-fixed-ssm", "serve-ssm")
    out = serve_numbers(eng, wave, launches)
    out.update(routes=routes, requests_equal_to_paged=[same, len(wave)],
               tokens_equal_to_paged=[toks, out["tokens"]])
    print_serve("serve-fixed-ssm", wave, out, card)
    print(f"[serve-fixed-ssm] {cfg.name}: fixed vs paged engine "
          f"([serve-ssm], one run): TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} vs "
          f"{ssm['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
          f"{out['tpot_p50_s'] * 1e3:.2f} vs {ssm['tpot_p50_s'] * 1e3:.2f} "
          f"ms, {out['tokens_per_s']:.1f} vs {ssm['tokens_per_s']:.1f} "
          f"tokens/s, peak memory {out['peak_bytes'] / 2**30:.2f} vs "
          f"{ssm['peak_bytes'] / 2**30:.2f} GiB; {same}/{len(wave)} requests "
          f"and {toks}/{out['tokens']} tokens equal; on {card}")
    return out


SERVE_HISTS = ("serve.ttft_s", "serve.tpot_s")
SERVE_COUNTERS = {"serve.preemptions": "preemptions",
                  "serve.prefix.hits": "prefix_hits",
                  "serve.prefix.misses": "prefix_misses",
                  "serve.kernel.bytes_avoided": "kv_bytes_avoided"}


def phase_serve_obs(cfg, params, paged_attention, card, graph):
    """``[serve-graph]``'s traffic again with ``obs.metrics.REGISTRY``
    enabled, then disabled: the engine's instruments against its own
    stats, the captured step unchanged, TPOT beside ``[serve-graph]``'s
    (the registry off)."""
    from repro_torch.obs import metrics
    reg = metrics.REGISTRY
    check(not reg.enabled, "[serve-obs] the registry is already on")
    first, wave = serve_traffic(cfg)
    reg.clear()
    reg.enable()
    try:
        eng, launches = run_serve(cfg, params, [first, wave],
                                  paged_attention, tag="serve-obs", slots=4,
                                  capacity=512, page_size=16, kernel="paged",
                                  prefix_sharing=True)
        snap = reg.snapshot()
        series = {n: len(reg.series(n)) for n in SERVE_HISTS}
    finally:
        reg.disable()
        reg.clear()
    st = eng.stats
    routes = check_paged_routes(eng, launches, paged_attention, cfg,
                                "serve-obs")
    n_rec = sum(1 for r in eng.records if r.n_tokens > 0)
    hists = {n: snap[n]["count"] for n in SERVE_HISTS}
    check(hists == dict.fromkeys(SERVE_HISTS, n_rec) and series == hists,
          f"[serve-obs] histograms {hists}, series {series}: {n_rec} records "
          "with tokens")
    counters = {n: snap[n] for n in SERVE_COUNTERS}
    want = {n: st[k] for n, k in SERVE_COUNTERS.items()}
    check(counters == want, f"[serve-obs] counters {counters} != stats {want}")
    check(eng.kernel == "paged" and st["kv_bytes_avoided"] > 0,
          f"[serve-obs] no dense view avoided on kernel {eng.kernel}")
    occ = snap["serve.pool_occupancy"]
    check(0.0 <= occ <= 1.0, f"[serve-obs] occupancy {occ}")
    cap = eng.capture
    out = serve_numbers(eng, wave, launches)
    out.update(routes=routes, histogram_counts=hists, counters=counters,
               pool_occupancy_last=occ,
               kv_row_bytes=eng.kv_row_bytes())
    print(f"[serve-obs] {cfg.name}: registry on: serve.ttft_s / tpot_s "
          f"count {n_rec} each (= records with tokens), counters "
          f"{json.dumps(counters)} (= the engine's stats), pool occupancy "
          f"{occ:.3f} before the last step, {st['kv_bytes_avoided']:,} bytes "
          f"of dense views not built ({eng.kv_row_bytes():,} bytes a KV row)")
    print(f"[serve-obs] TPOT p50 {out['tpot_p50_s'] * 1e3:.2f} ms with the "
          f"registry on vs {graph['tpot_p50_s'] * 1e3:.2f} ms off "
          f"([serve-graph], same traffic, one run); TTFT p50 "
          f"{out['ttft_p50_s'] * 1e3:.1f} vs {graph['ttft_p50_s'] * 1e3:.1f} "
          f"ms; {cap['captures']} captures (step and prefills), "
          f"{cap['replays']} replays of {st['steps']} steps + "
          f"{st['prefill_dispatches']} prefill dispatches; on {card}")
    return out


EXAMPLES = (("quickstart", ["--n", "1024", "--serial-n", "8"]),
            ("serve_batch", []),
            ("train_lm", ["--steps", "12", "--inject-failure"]))


def phase_examples(card, root):
    """Each example of the port as ``python -m repro_torch.examples.<name>``
    on the card, the three at once. Gates: each exits 0; train_lm restarts
    once and its loss falls. Their own lines are printed."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    ckpt = tempfile.mkdtemp(prefix="repro_torch_train_ckpt_")
    t0 = time.perf_counter()
    procs = {}
    try:
        for name, argv in EXAMPLES:
            if name == "train_lm":
                argv = argv + ["--ckpt-dir", ckpt]
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"repro_torch.examples.{name}", *argv],
                cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        outs = {}
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=300)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    for name, text in outs.items():
        for line in text.strip().splitlines()[-14:]:
            print(f"[examples] {name} | {line}")
    rcs = {name: p.returncode for name, p in procs.items()}
    check(all(rc == 0 for rc in rcs.values()), f"[examples] exit codes {rcs}")
    m = re.search(r"done: (\d+) steps, (\d+) restarts, loss ([\d.]+) -> "
                  r"([\d.]+)", outs["train_lm"])
    check(m is not None, "[examples] train_lm printed no summary")
    restarts, first, last = int(m[2]), float(m[3]), float(m[4])
    check(restarts == 1 and last < first,
          f"[examples] train_lm: {restarts} restarts, loss {first} -> {last}")
    check("decode step: compiled" in outs["serve_batch"],
          "[examples] serve_batch's decode step was not compiled")
    print(f"[examples] quickstart, serve_batch and train_lm ran on the card "
          f"at once in {wall:.1f}s: exit codes {json.dumps(rcs)}; train_lm "
          f"restarted {restarts} time, loss {first} -> {last}; on {card}")
    return dict(exit_codes=rcs, wall_s=wall, train_restarts=restarts,
                train_loss=[first, last])


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


def ssm_wave(cfg):
    """``[serve-ssm]``'s wave: 4 prompts of 512 and 4 of 192 tokens,
    interleaved in the queue, 16 generated each."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab,
                                               512 if i % 2 == 0 else 192),
                    max_new=16) for i in range(8)]


def phase_serve_ssm(cfg, params, ssd_scan, card):
    """mamba2 at full width on ``ssm_wave`` served twice: exact-length
    groups put each length in one prefill dispatch of 4 slots; the first
    wave captures each length's prefill and gives the phase's numbers,
    the second replays it (its tokens equal the first's; its numbers on a
    line of their own)."""
    waves = [ssm_wave(cfg), ssm_wave(cfg)]
    eng, launches = run_serve(cfg, params, waves, ssd_scan, tag="serve-ssm",
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
    out = serve_numbers(eng, waves[0], launches)
    out["routes"] = routes
    out["outs"] = [list(map(int, r.out)) for r in waves[0]]
    print_serve("serve-ssm", waves[0], out, card)
    out["replayed_wave"] = print_replayed_wave("serve-ssm", eng, *waves,
                                               launches)
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
    scan asserts it in both packages), served twice: the first wave gives
    the phase's numbers, the second replays every prefill the first
    captured (a line of its own). Exact-length prefill groups; every
    SSD-scan launch on tc;
    quantized
    pool leaves take the gather route (the paged kernel does not
    dequantize, as in the reference), so no paged launch."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab, n) for n in (512, 512, 256, 192)]
    waves = [[Request(rid=i, prompt=p, max_new=16)
              for i, p in enumerate(prompts)] for _ in range(2)]
    wave = waves[0]
    eng, launches = run_serve(cfg, params, waves, ssd_scan, tag="serve-int8",
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
    out["replayed_wave"] = print_replayed_wave("serve-int8", eng, *waves,
                                               launches)
    return out


def _ssm_leaves(pool):
    """Every SSM leaf of a pool (conv and state, slot-dense)."""
    return [x for gtree in pool for btree in gtree.values() if "ssm" in btree
            for x in btree["ssm"].values()]


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
    graph, _ = ArrayBackend(cache=CompileCache(persistent=False)).compile(
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


def phase_profile_prefill(cfg, params, B=4, S=512, tag="profile-ssm",
                          kernel="ssd_scan", more_slots=None):
    """Where one full-width prefill dispatch's time goes (B prompts of S
    tokens through the engine's batched prefill, ``paged_prefill`` on kernel
    "paged"), run eagerly and replayed from its captured graph:
    ``torch.profiler`` over two dispatches after two warm-up ones (the
    graph's first is its capture), each dispatch ending where the engine
    reads its first tokens; host wall, device busy and its share, kernels
    and host launch calls a dispatch, and the device time and share of the
    kernels named ``kernel`` (the SSD scan for an SSM config, the paged
    attention kernels otherwise), which must launch once a layer. With
    ``more_slots``, the replayed dispatch again into a pool of that many
    slots (B rows still written): its host wall, busy time and graph pool
    bytes beside the B-slot pool's, since the SSM state it writes is
    slot-dense."""
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.models.lm import paged_cache_init, paged_prefill
    ps = 16
    npps = -(-S // ps)
    tables = torch.arange(B * npps, dtype=torch.int32,
                          device=DEV).reshape(B, npps)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, (B, S)).astype(np.int32)).to(DEV)
    lens = torch.full((B,), S, dtype=torch.int32, device=DEV)
    sids = torch.arange(B, dtype=torch.int32, device=DEV)
    pool = paged_cache_init(cfg, B, B * npps, ps, DEV)

    def prefill_fn(p, kv, tb, tt, ln, sd):
        return paged_prefill(p, kv, tb, tt, ln, cfg, slot_ids=sd,
                             kernel="paged")[0]

    caches = [CompileCache(persistent=False)]
    graph, _ = ArrayBackend(cache=caches[0]).compile(
        prefill_fn, (params, pool, tables, toks, lens, sids),
        bind_argnums=(0, 1))
    out, layers = {}, cfg.n_layers
    if kernel == "ssd_scan":
        layers = sum(1 for g in cfg.groups for b in g.pattern
                     if b.ssm is not None for _ in range(g.repeats))
    for mode, fn in (("eager", prefill_fn), ("graph", graph)):
        def dispatch():
            lg = fn(params, pool, tables, toks, lens, sids)
            torch.argmax(lg[:, 0], -1).cpu()   # the engine reads the tokens
        dispatch()
        dispatch()
        wall, kern, host, _ = _profile(dispatch, 2)
        busy = sum(ms for ms, _ in kern.values())
        n_kernels = sum(n for _, n in kern.values())
        named = {n: v for n, v in kern.items() if kernel in n
                 and "combine" not in n}
        k_ms = sum(ms for ms, _ in named.values())
        k_n = sum(n for _, n in named.values())
        print(f"[{tag}] {cfg.name} prefill dispatch at full width ({B} "
              f"prompts of {S} tokens, kernel paged), {mode}: host wall "
              f"{wall * 1e3:.2f} ms, device busy {busy:.2f} ms "
              f"({busy / (wall * 1e3):.1%}), {n_kernels:.0f} kernels and "
              f"{host:.0f} host launch calls a dispatch; {kernel} kernels "
              f"{k_ms:.3f} ms in {k_n:.0f} launches ({k_ms / busy:.1%} of "
              f"busy)" if busy else
              f"[{tag}] {cfg.name} prefill dispatch, {mode}: host wall "
              f"{wall * 1e3:.2f} ms; the profiler saw no kernel: busy not "
              f"measured")
        if mode == "eager":
            for name, (ms, n) in sorted(kern.items(),
                                        key=lambda kv: -kv[1][0])[:6]:
                print(f"[{tag}]   {ms:8.3f} ms {n:6.0f}x  {name[:90]}")
            check(busy > 0 and k_n == layers,
                  f"[{tag}] prefill profile: busy {busy} ms, {k_n} {kernel} "
                  f"launches for {layers} layers")
        out[mode] = dict(wall_ms=wall * 1e3, busy_ms=busy,
                         kernels=n_kernels, host_launch_calls=host,
                         kernel_ms=k_ms, kernel_launches=k_n,
                         kernel_share=k_ms / busy if busy else None)
    check(graph.replays == 3, f"[{tag}] the prefill graph replayed "
          f"{graph.replays} times")
    e, g = out["eager"], out["graph"]
    print(f"[{tag}] replayed vs eager prefill dispatch: host wall "
          f"{g['wall_ms']:.2f} vs {e['wall_ms']:.2f} ms, device busy "
          f"{g['busy_ms']:.2f} vs {e['busy_ms']:.2f} ms, host launch calls "
          f"{g['host_launch_calls']:.0f} vs {e['host_launch_calls']:.0f} a "
          f"dispatch")
    g["pool_bytes"] = _graph_pool_bytes(caches[0])
    if more_slots:
        del pool
        torch.cuda.empty_cache()
        big = paged_cache_init(cfg, more_slots, B * npps, ps, DEV)
        caches.append(CompileCache(persistent=False))
        exe, _ = ArrayBackend(cache=caches[1]).compile(
            prefill_fn, (params, big, tables, toks, lens, sids),
            bind_argnums=(0, 1))

        def dispatch():
            lg = exe(params, big, tables, toks, lens, sids)
            torch.argmax(lg[:, 0], -1).cpu()
        dispatch()
        dispatch()
        wall, kern, host, _ = _profile(dispatch, 2)
        busy = sum(ms for ms, _ in kern.values())
        state = sum(x.numel() * x.element_size() for x in _ssm_leaves(big))
        out[f"graph_{more_slots}_slots"] = m = dict(
            wall_ms=wall * 1e3, busy_ms=busy,
            pool_bytes=_graph_pool_bytes(caches[1]), state_bytes=state)
        print(f"[{tag}] the replayed dispatch into {more_slots} slots "
              f"(SSM state {state / 2**30:.2f} GiB) vs {B}: host wall "
              f"{m['wall_ms']:.2f} vs {g['wall_ms']:.2f} ms, device busy "
              f"{busy:.2f} vs {g['busy_ms']:.2f} ms, graph pool "
              f"{m['pool_bytes'] / 2**20:.1f} vs "
              f"{g['pool_bytes'] / 2**20:.1f} MiB")
        check(m["pool_bytes"] < g["pool_bytes"] + state / more_slots * B,
              f"[{tag}] the {more_slots}-slot dispatch's pool grew with "
              f"the slots: {m}")
        del big
        torch.cuda.empty_cache()
    return out


def phase_lockstep_prefill(cfg, params, shapes, npps=32, pool_pages=128,
                           tag="lockstep-prefill"):
    """The engine's own prefill executables (``PagedServeEngine.
    _prefill_exec`` / ``_warm_exec``, kernel "paged"), captured with one
    set of tables, slot ids, lengths (and ``starts``) and replayed with
    others, the two ``shapes`` alternating in the engine's one graph pool:
    every call's logits and every pool leaf (KV pages and positions, SSM
    state) bit-equal to the same function run eagerly on a twin pool, and
    the kernels' launches counted alike. The same kernels run on the same
    inputs, so any difference is a fault. A batched call's last row is a
    dummy (table -1, slot id out of range) on every other call."""
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.lm import paged_cache_init
    from repro_torch.serve.engine import PagedServeEngine
    from torch.utils import _pytree as pytree
    slots, ps = 4, 16
    cache = CompileCache(persistent=False)
    eng = PagedServeEngine(cfg, params, slots=slots, page_size=ps,
                           pages_per_slot=npps, pool_pages=pool_pages,
                           kernel="paged", device=DEV,
                           backend=ArrayBackend(cache=cache, device=DEV))
    twin = paged_cache_init(cfg, slots, pool_pages, ps, DEV)
    exact = not eng._pad_safe
    r = np.random.default_rng(4)

    def inputs(kind, B, S, call):
        real = B - (call // 2 % 2 if B > 1 else 0)
        starts = (r.integers(1, (npps * ps - S) // 2, B) if kind == "warm"
                  else np.zeros(B, np.int64))
        lens = (np.full(B, S) if exact or kind == "warm"
                else r.integers(S // 2 + 1, S + 1, B))
        tables = np.full((B, npps), -1, np.int32)
        pages = r.permutation(pool_pages)
        sids = np.full(B, slots, np.int32)
        sids[:real] = r.permutation(slots)[:real]
        used = 0
        for b in range(real):
            n = -(-(int(starts[b]) + S) // ps)
            tables[b, :n] = pages[used:used + n]
            used += n
        toks = r.integers(1, cfg.vocab, (B, S))
        args = [tables, toks, lens, sids] + ([starts] if kind == "warm"
                                            else [])
        return [torch.from_numpy(np.asarray(a, np.int32)).to(DEV)
                for a in args]

    def counts():
        return (paged_attention.launches, ssd_scan.launches)

    rows = []
    for call in range(6):
        kind, B, S = shapes[call % 2]
        exe = eng._warm_exec(S) if kind == "warm" else eng._prefill_exec(B, S)
        ints = inputs(kind, B, S, call)
        c0 = counts()
        eager = exe.fn(params, twin, *ints)
        c1 = counts()
        replays = cache.stats["replays"]
        graph = exe(params, eng.kv, *ints).clone()
        c2 = counts()
        same_logits = bool(torch.equal(eager, graph))
        diff = [i for i, (a, b) in enumerate(zip(pytree.tree_leaves(twin),
                                                 pytree.tree_leaves(eng.kv)))
                if not torch.equal(a, b)]
        how = "replay" if cache.stats["replays"] > replays else "capture"
        launches = tuple(b - a for a, b in zip(c1, c2))
        rows.append(dict(kind=kind, B=B, S=S, call=how,
                         real_rows=int((ints[3] < slots).sum()),
                         logits_equal=same_logits, pool_leaves_differ=diff,
                         launches=launches))
        print(f"[{tag}] {cfg.name} call {call} {kind} {B} x {S} ({how}, "
              f"{rows[-1]['real_rows']} real rows): logits bit-equal "
              f"{same_logits}, pool leaves differing {len(diff)}, launches "
              f"(paged, ssd) {launches} against eager "
              f"{tuple(b - a for a, b in zip(c0, c1))}")
        check(same_logits and not diff,
              f"[{tag}] call {call}: replayed prefill differs from eager "
              f"(logits equal {same_logits}, pool leaves {diff})")
        check(launches == tuple(b - a for a, b in zip(c0, c1)),
              f"[{tag}] call {call}: launches {launches} against eager's")
    graphs = [g for exe in cache._mem.values()
              for g in getattr(exe, "graphs", {}).values()]
    pools = {g.graph.pool() for g in graphs}
    check(cache.stats["captures"] == 2 and cache.stats["replays"] == 4
          and len(pools) == 1,
          f"[{tag}] {cache.stats['captures']} captures, "
          f"{cache.stats['replays']} replays, {len(pools)} pools")
    pool_bytes = _graph_pool_bytes(cache)
    inputs_named = "tables, slot ids, lengths" + (
        " and starts" if any(kind == "warm" for kind, _, _ in shapes) else "")
    print(f"[{tag}] {cfg.name}: 2 shapes captured into one graph pool "
          f"({pool_bytes / 2**20:.1f} MiB) and replayed 4 times with new "
          f"{inputs_named}: every call bit-equal to eager; ok")
    return dict(calls=rows, pool_bytes=pool_bytes)


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
        cache = CompileCache(persistent=False)
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
    from the same seed. The checkpoints stay for ``[elastic]``, which
    takes the interrupted run's state and step from ``out["handle"]``."""
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
            cache=CompileCache(persistent=False), device=DEV))
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
                          state=state,
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
    out = dict(steps=n, fail_at=fail_at, restore_steps=rep.restore_steps,
               losses=f["losses"], uninterrupted=u["losses"],
               loss_rel=worst, params_rel=pworst,
               replays=f["step"].replays, launches=counts,
               wall_s=time.perf_counter() - t0)
    del u["state"], u["step"]
    # [elastic] restores a checkpoint of this run into its bound state
    out["handle"] = dict(state=f["state"], step=f["step"], get=get,
                         ckdir=str(ckdir))
    print(f"[train-fault] {cfg.name}, 4 x 512, {n} steps, checkpoints every "
          f"2 written async, a WorkerFailure entering step {fail_at}: "
          f"restored step {rep.restore_steps} into the bound tensors, one "
          f"graph, {f['step'].replays} replays; the {len(want)} losses "
          f"within {worst:.1e} of the uninterrupted run, params within "
          f"{pworst:.1e} (limit {TRAIN_FAULT_RTOL}); launches "
          f"{json.dumps(counts)}; {out['wall_s']:.1f}s; on {card}")
    return out


# ---------------------------------------------------------------------------
# The multi-device and analysis layer: meshes, the GPipe schedule, elastic
# restore, the roofline of measured steps and the dry run
# ---------------------------------------------------------------------------

def card_device() -> torch.device:
    """The card, with its index (a mesh's position names one device)."""
    return torch.device("cuda", torch.cuda.current_device())


def phase_mesh(card, counters, launch):
    """``[launch]``'s 16,384 instances through ``make_backend("array",
    mesh=...)`` in waves of 8,192: on ``make_host_mesh()`` (the card once:
    the task axis has one position, so each wave runs whole) and on a mesh
    listing the card twice on ``data`` (each wave split in two, each piece
    captured as its own graph and joined in order); each cold (a fresh
    cache) and warm. Gates: both outputs bit-equal to the mesh-less array
    backend's, on the card; the split records name the card twice; the
    warm launches replay (every wave ``memory``); no counted kernel."""
    from repro_torch.core.backend import make_backend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.llmr import LLMapReduce
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    x = np.random.default_rng(0).standard_normal((LAUNCH_N, 64)).astype(
        np.float32)
    want, _ = LLMapReduce(scheduler="array", wave_size=LAUNCH_WAVE,
                          cache=CompileCache(persistent=False),
                          device=DEV).map_reduce(launch_app, x)
    card0 = card_device()
    meshes = (("host", make_host_mesh(None if DEV == "cuda" else DEV)),
              ("card-twice", Mesh([[card0], [card0]], ("data", "model"))))
    for fn in counters:
        fn.launches = 0
    out = {}
    for name, mesh in meshes:
        cache = CompileCache(persistent=False)
        be = make_backend("array", mesh=mesh, cache=cache)
        reads = []
        for when in ("cold", "warm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, rep = LLMapReduce(backend=be, wave_size=LAUNCH_WAVE
                                   ).map_reduce(launch_app, x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(got.device == want.device and torch.equal(got, want),
                  f"[mesh] {name} {when}: outputs differ from the mesh-less "
                  f"run (max {float((got - want).abs().max()):.3e})")
            split = [r.extra.get("mesh_devices") for r in rep.records]
            sources = [r.extra["compile_source"] for r in rep.records]
            reads.append(dict(wall_s=wall, instances_per_s=LAUNCH_N / wall,
                              waves=rep.waves, pieces=split,
                              sources=sources))
            print(f"[mesh] {name} ({mesh}) {when}: {LAUNCH_N} instances in "
                  f"{wall:.4f}s ({LAUNCH_N / wall:,.0f} instances/s), "
                  f"{rep.waves} waves, pieces {split[0]}, sources "
                  f"{sorted(set(sources))}; bit-equal to the mesh-less run")
        check(all(s == "memory" for s in reads[1]["sources"]),
              f"[mesh] {name}: the warm launch compiled again")
        want_pieces = [str(card0)] * 2 if name == "card-twice" else None
        check(all(p == want_pieces for r in reads for p in r["pieces"]),
              f"[mesh] {name}: pieces {reads[0]['pieces']}")
        out[name] = dict(cold=reads[0], warm=reads[1],
                         captures=cache.stats["captures"])
        print(f"[mesh] {name}: {cache.stats['captures']} captures "
              f"({'one graph a mesh position' if want_pieces else 'one graph'}"
              f"), {cache.stats['replays']} replays")
    others = {fn.__name__: fn.launches for fn in counters}
    check(not any(others.values()), f"[mesh] kernels launched: {others}")
    a = launch["array"]["warm"]["wall_s"]
    print(f"[mesh] warm: mesh-less array {a:.4f}s ([launch]), host mesh "
          f"{out['host']['warm']['wall_s']:.4f}s, the card twice "
          f"{out['card-twice']['warm']['wall_s']:.4f}s; on {card}")
    return out


PIPE_STAGES, PIPE_PER, PIPE_MB, PIPE_TOKENS = 4, 2, 4, 128
PIPE_RTOL = 1e-4                # f32: against the output's scale


def _pipe_stages(cfg, dtype):
    """PIPE_STAGES x PIPE_PER of ``cfg``'s first group's blocks drawn on the
    card from seed 0, restacked (stages, per, ...) — in float32, or as
    drawn (bf16, the SSM's f32 leaves kept) — and the stage function: its
    PIPE_PER blocks in order."""
    from repro_torch.models.blocks import block_apply, group_init, tree_map
    g = dataclasses.replace(cfg.groups[0], repeats=PIPE_STAGES * PIPE_PER)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    stacked = group_init(gen, cfg, g, DEV)["stacked"]
    params = tree_map(lambda a: (a.float() if dtype == torch.float32
                                 else a).reshape(
        (PIPE_STAGES, PIPE_PER) + tuple(a.shape[1:])), stacked)

    def stage(p, x):
        pos = torch.arange(x.shape[1], dtype=torch.int32,
                           device=x.device)[None].expand(x.shape[:2])
        for r in range(PIPE_PER):
            for i, b in enumerate(g.pattern):
                x, _ = block_apply(tree_map(lambda a: a[r], p[str(i)]), x,
                                   b, cfg, pos)
        return x
    return params, stage


PIPE_SSD_TOL = 3e-4            # each stage's SSD call against its plain version


def _ssd_held(scan, ssd_scan, ssd_chunked_ref, errs):
    """``scan`` (the models' SSD entry) with each call's y and final state
    held against ``ssd_chunked_ref`` on the same inputs: (the route
    ``ssd_scan.routes`` counted, rel err y, rel err h) appended to
    ``errs``."""
    def call(x, dt, A, B, C, *, chunk, out_dtype=None, return_state=False,
             route=None):
        before = dict(ssd_scan.routes)
        y, h = scan(x, dt, A, B, C, chunk=chunk, out_dtype=out_dtype,
                    return_state=True, route=route)
        ran = [r for r, n in ssd_scan.routes.items() if n != before[r]]
        ry, rh = ssd_chunked_ref(x, dt, A, B, C, chunk)
        errs.append((ran[0] if ran else "plain", rel_err(y, ry.to(y.dtype)),
                     rel_err(h, rh)))
        return (y, h) if return_state else y
    return call


def phase_pipeline(card, ssd_scan, ssd_chunked_ref):
    """``runtime.pipeline.pipeline_apply`` on the card: 4 stages (a mesh
    listing the card 4 times on ``pod``), each 2 blocks at full width, 4
    microbatches of 1 x 128 tokens; qwen3-14b's dense blocks, then
    mamba2-1.3b's, whose SSD scans run in the stages. Gates: in f32 the
    pipeline within PIPE_RTOL of ``reference_apply`` (relative to the
    output's scale); every SSD launch of a bf16 run on ``tc`` (the f32 runs
    take ``simt``, the route of f32 inputs); in the warm-up run of each,
    every stage's SSD call within PIPE_SSD_TOL of the plain version on the
    same inputs (y and final state, relative). Printed: the bf16
    pipeline's gap to the f32 answer, the bubble fraction (S-1)/(M+S-1),
    and the wall of the pipeline beside the sequential stages (bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.runtime.pipeline import pipeline_apply, reference_apply
    mesh = Mesh([card_device()] * PIPE_STAGES, ("pod",))
    bubble = (PIPE_STAGES - 1) / (PIPE_MB + PIPE_STAGES - 1)
    out = {}
    for arch in ("qwen3-14b", "mamba2-1.3b"):
        cfg = get_config(arch)
        r = np.random.default_rng(7)
        x32 = torch.from_numpy(r.standard_normal(
            (PIPE_MB, PIPE_TOKENS, cfg.d_model)).astype(np.float32)).to(DEV)
        res = {}
        for dtype in (torch.float32, torch.bfloat16):
            params, stage = _pipe_stages(cfg, dtype)
            x = x32.to(dtype)
            walls = {}
            with torch.no_grad():
                for name, run in (
                        ("pipeline", lambda: pipeline_apply(
                            stage, params, x, mesh, axis="pod",
                            microbatches=PIPE_MB)),
                        ("sequential", lambda: reference_apply(
                            stage, params, x))):
                    errs, scan = [], ssm_mod.ssd_scan
                    ssm_mod.ssd_scan = _ssd_held(scan, ssd_scan,
                                                 ssd_chunked_ref, errs)
                    try:
                        run()                # warm-up (kernel plans, cuBLAS)
                    finally:
                        ssm_mod.ssd_scan = scan
                    torch.cuda.synchronize()
                    res[(dtype, name, "held")] = errs
                    ssd_scan.launches = 0
                    ssd_scan.routes = dict.fromkeys(ssd_scan.routes, 0)
                    t0 = time.perf_counter()
                    y = run()
                    torch.cuda.synchronize()
                    walls[name] = (time.perf_counter() - t0) * 1e3
                    res[(dtype, name)] = y.float()
                    res[(dtype, name, "ssd")] = dict(ssd_scan.routes)
            res[dtype] = walls
            del params
            torch.cuda.empty_cache()
        f32, bf16 = torch.float32, torch.bfloat16
        ref = res[(f32, "sequential")]
        scale = float(ref.abs().max())
        err = float((res[(f32, "pipeline")] - ref).abs().max()) / scale
        gap = float((res[(bf16, "pipeline")] - ref).abs().max()) / scale
        check(math.isfinite(err) and err <= PIPE_RTOL,
              f"[pipeline] {arch}: f32 pipeline vs sequential {err:.2e} of "
              f"the scale {scale:.3g} > {PIPE_RTOL}")
        ssd = {f"{str(d).split('.')[-1]} {n}": res[(d, n, "ssd")]
               for d in (f32, bf16) for n in ("pipeline", "sequential")}
        held = {}
        if cfg.groups[0].pattern[0].ssm is not None:
            for d in (f32, bf16):
                want = "tc" if d == bf16 else "simt"
                for n in ("pipeline", "sequential"):
                    routes = res[(d, n, "ssd")]
                    check(sum(routes.values()) > 0
                          and routes[want] == sum(routes.values()),
                          f"[pipeline] {arch} {d} {n}: SSD routes {routes}")
                    errs = res[(d, n, "held")]
                    ey = max(e[1] for e in errs)
                    eh = max(e[2] for e in errs)
                    check(len(errs) == sum(routes.values())
                          and all(e[0] == want for e in errs)
                          and ey < PIPE_SSD_TOL and eh < PIPE_SSD_TOL,
                          f"[pipeline] {arch} {d} {n}: {len(errs)} SSD calls "
                          f"against the plain version: routes "
                          f"{sorted({e[0] for e in errs})}, rel err y {ey:.3e} "
                          f"h {eh:.3e} (tol {PIPE_SSD_TOL})")
                    held[f"{str(d).split('.')[-1]} {n}"] = dict(
                        calls=len(errs), route=want, rel_err_y=ey,
                        rel_err_h=eh)
                    print(f"[pipeline] {arch} {str(d).split('.')[-1]} {n}: "
                          f"{len(errs)} SSD calls ({want}) each held against "
                          f"the plain version on its inputs: rel err y <= "
                          f"{ey:.3e}, h <= {eh:.3e} (tol {PIPE_SSD_TOL}) ok")
        out[arch] = dict(stages=PIPE_STAGES, blocks_a_stage=PIPE_PER,
                         microbatches=PIPE_MB, tokens=PIPE_TOKENS,
                         f32_rel=err, bf16_gap=gap, scale=scale,
                         bubble=bubble, wall_ms={str(d).split(".")[-1]:
                                                 res[d] for d in (f32, bf16)},
                         ssd_routes=ssd, ssd_held=held)
        w = res[bf16]
        print(f"[pipeline] {arch}: {PIPE_STAGES} stages x {PIPE_PER} blocks "
              f"(d_model {cfg.d_model}), {PIPE_MB} microbatches of 1 x "
              f"{PIPE_TOKENS}: f32 pipeline within {err:.2e} of sequential "
              f"(limit {PIPE_RTOL}, scale {scale:.3g}); bf16 pipeline's gap "
              f"to the f32 answer {gap:.2e}; bubble {bubble:.3f}; bf16 wall "
              f"pipeline {w['pipeline']:.2f} ms vs sequential "
              f"{w['sequential']:.2f} ms; SSD launches {json.dumps(ssd)}; on "
              f"{card}")
    return out


def phase_elastic(card, fault):
    """``[train-fault]``'s checkpoint of step 6, restored through
    ``restore(..., sharding=state_sharding(state, make_host_mesh()))`` into
    the interrupted run's state (the tensors its captured step is bound
    to), then steps 6 and 7 replayed: their losses bit-equal to the
    uninterrupted run's; every leaf placed on the card, none moved."""
    import shutil as _shutil
    from repro_torch.ckpt.checkpoint import latest_steps, restore
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.elastic import state_sharding
    from repro_torch.train.optimizer import leaves_with_path
    h = fault.pop("handle")
    state, step, get, ckdir = h["state"], h["step"], h["get"], h["ckdir"]
    at = 6
    t0 = time.perf_counter()
    mesh = make_host_mesh(None if DEV == "cuda" else DEV)
    check(at in latest_steps(ckdir), f"[elastic] no checkpoint of step {at} "
          f"in {latest_steps(ckdir)}")
    ptrs = [x.data_ptr() for _, x in leaves_with_path(state)]
    state, got = restore(ckdir, state, step=at,
                         sharding=state_sharding(state, mesh))
    leaves = [x for _, x in leaves_with_path(state)]
    check(got == at and [x.data_ptr() for x in leaves] == ptrs
          and all(x.device.type == torch.device(DEV).type for x in leaves),
          "[elastic] the restored state moved or left the card")
    losses = []
    for s in range(at, fault["steps"]):
        state, m = step(state, get(s))
        losses.append(float(m["loss"]))
    want = fault["uninterrupted"][at:]
    check(losses == want, f"[elastic] losses after the restore {losses} vs "
          f"the uninterrupted run's {want}")
    _shutil.rmtree(ckdir, ignore_errors=True)
    out = dict(restored_step=at, losses=losses, mesh=str(mesh),
               wall_s=time.perf_counter() - t0)
    print(f"[elastic] step {at} restored through sharding= on {mesh} into "
          f"the bound state (no address moved), steps {at}-"
          f"{fault['steps'] - 1} replayed: losses {losses} bit-equal to the "
          f"uninterrupted run's; {out['wall_s']:.2f}s; on {card}")
    return out


def _count_serve_step():
    """``[profile]``'s replayed qwen3-14b decode step (the engine's: 4
    slots, a 128-page pool of 16 rows, 32-entry tables), counted on meta:
    (cost, bytes that must move, model flops). The bytes: the weights,
    less the input embedding's rows that no token gathers (all but 4), and
    of the pool the rows a step reads at the least, S + 1 a slot after the
    S-token prefill (the profiled steps attend 130-134 rows of 9 pages)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import embed_rows_not_read
    from repro_torch.launch.op_analysis import count
    from repro_torch.models import lm
    cfg = get_config("qwen3-14b")
    B, ps, npps, P, S = 4, 16, 32, 128, 128
    meta = dict(device="meta")
    params = lm.lm_init(None, cfg, "meta")
    pool = lm.paged_cache_init(cfg, B, P, ps, "meta")
    args = (torch.empty((B, npps), dtype=torch.int32, **meta),
            torch.empty((B, 1), dtype=torch.int32, **meta),
            torch.empty((B, 1), dtype=torch.int32, **meta))
    live = torch.empty((B,), dtype=torch.bool, **meta)
    _, cost = count(lm.paged_decode_step, params, pool, *args, cfg,
                    live=live, kernel="paged")
    must = (_tree_bytes(params) - embed_rows_not_read(cfg, params, B)
            + _tree_bytes(pool) * B * (S + 1) // (P * ps))
    return cost, must, 2.0 * lm.count_params(cfg, active_only=True) * B


def _count_train_step(B=2, S=4096):
    """``[train-ssm]``'s replayed mamba2-1.3b step (2 x 4,096, remat,
    AdamW), counted on meta: (cost, bytes that must move — the state,
    params and AdamW moments, each once — model flops). The counted flops
    include remat's recompute, which the step executes."""
    from repro_torch.configs import get_config
    from repro_torch.launch.op_analysis import count
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_state, make_train_step
    cfg = get_config("mamba2-1.3b")
    state = init_state(None, cfg, "meta")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=100))
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    _, cost = count(step, state, batch)
    return (cost, _tree_bytes(state),
            6.0 * lm.count_params(cfg, active_only=True) * B * S)


def _tree_bytes(tree) -> int:
    from torch.utils import _pytree as pytree
    return sum(x.numel() * x.element_size() for x in pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


ROOF_MAX_SHARE = 1.05


def phase_roofline(card, serve_profile, train_profile):
    """The roofline bound (``launch.roofline``, H100 data-sheet peaks) of
    two measured steps, counted on meta at their exact shapes
    (``launch.op_analysis``; the kernels' plain versions): the replayed
    qwen3-14b decode step of ``[profile]`` (``[serve-graph]``'s step) and
    the replayed mamba2-1.3b train step of ``[train-ssm]``. The bound is
    the larger of the counted flops over the bf16 peak and the bytes the
    step must move over HBM's rate (``_count_serve_step``,
    ``_count_train_step``), a lower bound of the step as it runs; the share
    is bound / measured device busy. Gate: 0 < share <= ROOF_MAX_SHARE for
    both (a larger share means the count is wrong)."""
    from repro_torch.launch.dryrun import roofline_row
    out = {}
    g = serve_profile["graph"]
    busy_serve = g["busy_ms"] or serve_profile["busy_ms"]
    for name, counted, busy, src in (
            ("serve-graph decode step", _count_serve_step, busy_serve,
             "[profile] replayed" if g["busy_ms"] else
             "[profile] eager (no kernel seen inside the replays)"),
            ("train-ssm step", _count_train_step, train_profile["busy_ms"],
             "[train-ssm] replayed")):
        t0 = time.perf_counter()
        cost, must, mflops = counted()
        row = roofline_row(cost, must, mflops, 1)
        bound_ms = row["t_step"] * 1e3
        share = bound_ms / busy if busy > 0 else float("inf")
        check(0 < share <= ROOF_MAX_SHARE,
              f"[roofline] {name}: bound {bound_ms:.3f} ms over measured busy "
              f"{busy:.3f} ms = {share:.3f}, outside (0, {ROOF_MAX_SHARE}]")
        out[name] = dict(row, bound_ms=bound_ms, busy_ms=busy, share=share,
                         busy_from=src, must_move_bytes=must,
                         model_flops=mflops,
                         count_s=time.perf_counter() - t0)
        print(f"[roofline] {name}: counted {cost.flops / 1e12:.3f} TFLOP "
              f"({cost.ops} ops; plain versions), must move "
              f"{must / 1e9:.3f} GB; bound {bound_ms:.3f} ms ({row['bound']}: compute "
              f"{row['t_compute'] * 1e3:.3f} ms, memory "
              f"{row['t_memory'] * 1e3:.3f} ms); measured device busy "
              f"{busy:.3f} ms ({src}): {100 * share:.1f}% of the roofline; "
              f"eager traffic counted {row['op_bytes_per_chip'] / 1e9:.1f} "
              f"GB; on {card}")
    return out


SPMD_RINGS = (4, 512, 128)     # qwen3-14b: slots, rows a slot, prompt
SPMD_SSM = (4, 512)            # mamba2-1.3b prefill: batch, tokens
SPMD_TOL = 3e-2                # n >= 2 ranks: of the logit scale (bf16)
SPMD_TOL_F32 = 1e-4            # n >= 2: the mamba2 prefill in f32 (below)
# n >= 2: the mamba2 prefill in bf16, of the logit scale: above the sound
# runs' readings (0.046-0.059 on 2 and 4 H100 80GB HBM3 cards at 700 W,
# torch 2.11) and below what logits of the wrong rows read (gated too)
SPMD_TOL_SSM = 0.1
# the Wine train app of [spmd]: mamba2-1.3b train_4k at full width, cut
# (``reduced``) to this many of its 48 layers and rows of its 256, so the
# phase fits its time; its replayed losses against its eager sharded
# losses, relative: tests/test_torch_spmd_cuda.py's TOL
SPMD_WINE_LAYERS = 8
SPMD_WINE_BATCH = 2
SPMD_WINE_STEPS = 3
SPMD_TOL_TRAIN = 2e-5


def _table_delta(after: dict, before: dict) -> dict:
    """A collectives table's change (``{kind: [count, bytes]}``)."""
    out = {}
    for k, (n, b) in after.items():
        n0, b0 = before.get(k, (0, 0))
        if n != n0:
            out[k] = [n - n0, b - b0]
    return out


def _nccl_ms(prof):
    """(NCCL kernels seen, their device ms) in a profile."""
    ev = [e for e in prof.key_averages() if "nccl" in e.key.lower()
          and e.self_device_time_total > 0]
    return (sum(e.count for e in ev),
            sum(e.self_device_time_total for e in ev) / 1e3)


def _spmd_graph(mesh, fn, state, inputs, profile=False, reps=3):
    """``fn(state, inputs)`` (a sharded step returning logits) through a
    fresh compile cache with ``state`` bound: the first call captures one
    CUDA graph on this rank (timed, its warm-up included), one replay is
    watched (its collectives from ``exe.collectives``, its SSD launches),
    its logits gathered whole, then ``reps`` replays are timed to a
    synchronize each (the median kept) and, with ``profile``, one more
    replay profiled (its NCCL kernels: issued by the graph, since a replay
    issues nothing from the host)."""
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.kernels.ssd_scan import ssd_scan
    cache = CompileCache(persistent=False)
    exe, source = cache.compile(fn, (state, inputs), bind_argnums=(0,),
                                device=mesh.local_device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exe(state, inputs)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    before = exe.collectives.table()
    n0, tc0 = ssd_scan.launches, ssd_scan.routes["tc"]
    out = exe(state, inputs)
    torch.cuda.synchronize()
    rec = {"source": source, "collectives": _table_delta(
        exe.collectives.table(), before),
        "ssd_launches": ssd_scan.launches - n0,
        "ssd_tc": ssd_scan.routes["tc"] - tc0,
        "logits": out.full_tensor().float()}
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe(state, inputs)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
            exe(state, inputs)
            torch.cuda.synchronize()
        rec["nccl_kernels"], rec["nccl_device_ms"] = _nccl_ms(prof)
    rec.update(captures=cache.stats["captures"], replays=exe.replays,
               t_capture_s=cache.stats["t_capture_s"],
               first_call_ms=first * 1e3,
               host_ms=statistics.median(ts) * 1e3 if ts else None,
               pool_mib=_graph_pool_bytes(cache) / 2**20)
    del exe, out
    cache._mem.clear()
    return rec


def _spmd_wine_train(mesh):
    """The mamba2-1.3b train_4k Wine app on ``mesh`` (full width; depth and
    batch cut, printed as ``reduced``): ``SPMD_WINE_STEPS`` eager steps of
    the app's own translation on its seed-0 state, then the app loaded
    through ``WineAdapter(mesh=mesh)`` from the same seed and run on the
    same whole batches (the first call captures, the rest replay).
    Returns its source, captures, replays, losses beside the eager ones,
    the SSD launches inside the replays and the host walls."""
    from repro_torch.configs import get_config, input_specs
    from repro_torch.core import wine as wine_mod
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.wine import WineAdapter, WineApp
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.spec import ShapeCell
    app = WineApp("mamba2-1.3b")                    # train, train_4k
    full = get_config(app.arch)
    cfg = cut_depth(full, SPMD_WINE_LAYERS)
    c = app.cell()
    cell = ShapeCell(c.name, seq_len=c.seq_len, global_batch=SPMD_WINE_BATCH,
                     mode=c.mode)
    gen = torch.Generator(device=mesh.local_device).manual_seed(7)
    batches = [{k: torch.randint(1, cfg.vocab, s.shape, generator=gen,
                                 device=mesh.local_device, dtype=s.dtype)
                for k, s in input_specs(cfg, cell).items()}
               for _ in range(SPMD_WINE_STEPS)]

    def whole(x):
        return float(x.full_tensor() if hasattr(x, "full_tensor") else x)

    with unittest.mock.patch.object(wine_mod, "get_config",
                                    lambda arch, smoke=False: cfg), \
            unittest.mock.patch.object(WineAdapter, "_cell",
                                       staticmethod(lambda app: cell)):
        adapter = WineAdapter(mesh=mesh, cache=CompileCache(
            persistent=False))
        step = adapter._build_train(app, cfg)
        state = adapter._init_state(app, cfg, 0)
        eager, eager_ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            eager.append(whole(m["loss"]))
            eager_ms.append((time.perf_counter() - t0) * 1e3)
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
        inst = adapter.load(app)
        got, ms, ssd, tc = [], [], 0, 0
        for i, b in enumerate(batches):
            n0, tc0 = ssd_scan.launches, ssd_scan.routes["tc"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got.append(whole(inst.run(b)["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            if i:                                   # a replay
                ssd += ssd_scan.launches - n0
                tc += ssd_scan.routes["tc"] - tc0
        exe = inst.step_fn
        rec = {"source": inst.load_report["compile_source"],
               "captures": adapter.cache.stats["captures"],
               "replays": exe.replays, "losses": got, "eager_losses": eager,
               "rel": max(abs(a - b) / abs(b) for a, b in zip(got, eager)),
               "ssd_launches_in_replays": ssd, "ssd_tc_in_replays": tc,
               "t_capture_s": adapter.cache.stats["t_capture_s"],
               "host_ms": ms, "eager_host_ms": eager_ms,
               "reduced": f"layers {full.n_layers} -> {cfg.n_layers}, batch "
                          f"{c.global_batch} -> {SPMD_WINE_BATCH} x "
                          f"{c.seq_len} tokens"}
        del inst, exe
        adapter.cache._mem.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _spmd_steps(mesh, qcfg, mcfg, qp, qc, qin, mp, min_, count=True):
    """[spmd]'s two sharded steps on ``mesh`` (a mesh of ranks, or the
    counting one on meta): qwen3-14b ``decode_step`` on rings and a
    mamba2-1.3b ``prefill``; the params, rings and inputs placed as the
    dry run places them. Returns [(logits, CollectiveStats or None where
    not ``count``, host s)]: the counter's dispatch hook is timed only
    where it counts."""
    from contextlib import nullcontext

    from torch.utils import _pytree as pytree

    from repro_torch.models import lm
    from repro_torch.sharding.partition import (batch_sharding,
                                                cache_sharding,
                                                param_sharding, place,
                                                sharding_ctx)
    from repro_torch.sharding.spmd import CollectiveCounter

    def put(tree, shardings, mode):
        return pytree.tree_map(place, tree, shardings(tree, mesh, mode))

    out = []
    qp, qc = put(qp, param_sharding, "serve"), put(qc, cache_sharding,
                                                   "serve")
    qin = put(qin, batch_sharding, "serve")
    sync = torch.cuda.synchronize if mesh.local_device.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with (CollectiveCounter() if count else nullcontext()) as cc, \
            sharding_ctx(mesh, "serve"):
        logits, _ = lm.decode_step(qp, qc, qin["tokens"], qin["positions"],
                                   qcfg)
    sync()
    out.append((logits, cc and cc.stats, time.perf_counter() - t0))
    mp, min_ = put(mp, param_sharding, "prefill"), put(min_, batch_sharding,
                                                       "prefill")
    sync()
    t0 = time.perf_counter()
    with (CollectiveCounter() if count else nullcontext()) as cc, \
            sharding_ctx(mesh, "prefill"):
        logits, _ = lm.prefill(mp, min_, mcfg)
    sync()
    out.append((logits, cc and cc.stats, time.perf_counter() - t0))
    return out


def spmd_rank(rank, n, store, device, out_dir):
    """``[spmd]``'s rank ``rank`` of ``n``, one a card, NCCL over a
    ``FileStore``: both steps first counted on ``meta`` under
    ``spmd.counting`` at the same mesh and shapes, then run live on the
    mesh of n ranks along ``model`` at full width (seeded bf16 weights
    drawn on the card) beside the same steps with no mesh, and each host
    wall timed on a second call with no counter (the sharded step's holds
    DTensor's dispatch; the first, counted call's is kept beside it). The
    unsharded bf16 prefill with the SSD scan forced onto the simt route,
    a control of how far two sound bf16 routes drift apart. With n >= 2
    the mamba2 prefill again in f32, and the profiler's NCCL device time
    of both sharded steps. Writes ``spmd-rank{r}.json``."""
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    card_settings()
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.roofline import LINK_BW
    from repro_torch.launch.serve import init_params
    from repro_torch.models import lm, ssm
    from repro_torch.sharding.spmd import counting, spmd_mesh
    # one axis: the (1, n) mesh without its axis of one position, which
    # the rules would leave whole anyway
    sizes, names = (n,), ("model",)
    qcfg, mcfg = get_config("qwen3-14b"), get_config("mamba2-1.3b")
    B, cap, prompt = SPMD_RINGS
    Bm, Sm = SPMD_SSM

    def inputs(dev, gen=None):
        def ints(shape, vocab):
            if dev == "meta":
                return torch.empty(shape, dtype=torch.int32, device=dev)
            return torch.randint(1, vocab, shape, generator=gen, device=dev,
                                 dtype=torch.int32)
        return ({"tokens": ints((B, 1), qcfg.vocab),
                 "positions": torch.full((B, 1), prompt, dtype=torch.int32,
                                         device=dev)},
                {"tokens": ints((Bm, Sm), mcfg.vocab)})

    t0 = time.perf_counter()
    with counting(Mesh.abstract(sizes, names), rank=rank) as cm:
        qin, min_ = inputs("meta")
        counted = [st.table() for _, st, _ in _spmd_steps(
            cm, qcfg, mcfg, lm.lm_init(None, qcfg, "meta"),
            lm.cache_init(qcfg, B, cap, "meta"), qin,
            lm.lm_init(None, mcfg, "meta"), min_)]
    t_count = time.perf_counter() - t0
    mesh = spmd_mesh(sizes, names, device=device, rank=rank,
                     store_path=store)
    dev = mesh.local_device
    gen = torch.Generator(device=dev).manual_seed(1)
    qp = init_params(qcfg, dev, seed=0)
    _, rings = lm.prefill(qp, {"tokens": torch.randint(
        1, qcfg.vocab, (B, prompt), generator=gen, device=dev,
        dtype=torch.int32)}, qcfg, capacity=cap)
    qin, min_ = inputs(dev, gen)
    mp = init_params(mcfg, dev, seed=0)

    def copy(tree):
        return pytree.tree_map(torch.clone, tree)

    for _ in range(2):                  # the second call is timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_q, _ = lm.decode_step(qp, copy(rings), qin["tokens"],
                                    qin["positions"], qcfg)
        torch.cuda.synchronize()
        t_plain_q = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain_m, _ = lm.prefill(mp, min_, mcfg)
        torch.cuda.synchronize()
        t_plain_m = time.perf_counter() - t0
    with unittest.mock.patch.object(ssm, "ssd_scan", functools.partial(
            ssd_scan, route="simt")):
        simt_m, _ = lm.prefill(mp, min_, mcfg)
    tc0 = ssd_scan.routes["tc"]
    n0 = ssd_scan.launches
    (q, q_st, t_q1), (m, m_st, t_m1) = _spmd_steps(
        mesh, qcfg, mcfg, qp, copy(rings), qin, mp, min_)
    tc, launches = ssd_scan.routes["tc"] - tc0, ssd_scan.launches - n0
    (_, _, t_q), (_, _, t_m) = _spmd_steps(
        mesh, qcfg, mcfg, qp, copy(rings), qin, mp, min_, count=False)
    rec = {"rank": rank, "ranks": n, "mesh": "x".join(map(str, sizes)),
           "t_count_s": t_count}
    fulls = {}
    for name, got, plain, st, cnt, t, t1, tp in (
            ("qwen3-14b decode_step", q, plain_q, q_st, counted[0], t_q,
             t_q1, t_plain_q),
            ("mamba2-1.3b prefill", m, plain_m, m_st, counted[1], t_m,
             t_m1, t_plain_m)):
        full = fulls[name] = got.full_tensor().float()
        plain = plain.float()
        top2 = plain.topk(2, dim=-1).values
        rec[name] = {
            "collectives": st.table(), "counted": cnt,
            "collective_bytes": st.total_bytes,
            "t_collective_ms": st.total_bytes / LINK_BW * 1e3,
            "bit_equal": bool(torch.equal(full, plain)),
            "max_abs_err": float((full - plain).abs().max()),
            "scale": float(plain.abs().max()),
            # a fault's reading: the logits of the wrong batch rows
            "wrong_rows_err": float((full - plain.roll(1, 0)).abs().max()),
            "tokens_equal": bool(torch.equal(full.argmax(-1),
                                             plain.argmax(-1))),
            "min_top2_gap": float((top2[..., 0] - top2[..., 1]).min()),
            "host_ms": t * 1e3, "counted_host_ms": t1 * 1e3,
            "plain_host_ms": tp * 1e3}
    rec["mamba2-1.3b prefill"].update(
        ssd_launches=launches, ssd_tc=tc,
        simt_err=float((simt_m.float() - plain_m.float()).abs().max()))

    # the same two steps through the compile cache: each rank captures one
    # CUDA graph a step (its NCCL collectives and SSD launches inside) on
    # the first call and replays it afterwards; the inputs are DTensors
    # (static buffers of each rank's shard)
    from repro_torch.sharding.partition import (batch_sharding,
                                                cache_sharding,
                                                param_sharding, place,
                                                sharding_ctx)

    def put(tree, shardings, mode):
        return pytree.tree_map(place, tree, shardings(tree, mesh, mode))

    def q_step(state, inp):
        params, caches = state
        with sharding_ctx(mesh, "serve"):
            return lm.decode_step(params, caches, inp["tokens"],
                                  inp["positions"], qcfg)[0]

    def m_step(params, inp):
        with sharding_ctx(mesh, "prefill"):
            return lm.prefill(params, inp, mcfg)[0]

    n0 = ssd_scan.launches
    graphs = {"qwen3-14b decode_step": _spmd_graph(
        mesh, q_step, (put(qp, param_sharding, "serve"),
                       put(copy(rings), cache_sharding, "serve")),
        put(qin, batch_sharding, "serve"), profile=n >= 2)}
    n1 = ssd_scan.launches
    graphs["mamba2-1.3b prefill"] = _spmd_graph(
        mesh, m_step, put(mp, param_sharding, "prefill"),
        put(min_, batch_sharding, "prefill"), profile=n >= 2)
    rec["graph_ssd_launches"] = ssd_scan.launches - n1
    check(n1 == n0, "[spmd] the captured qwen3 decode launched the SSD "
          "kernel")
    for name, plain in (("qwen3-14b decode_step", plain_q),
                        ("mamba2-1.3b prefill", plain_m)):
        g = graphs[name]
        full, plain = g.pop("logits"), plain.float()
        top2 = plain.topk(2, dim=-1).values
        rec[name]["graph"] = dict(
            g, bit_equal=bool(torch.equal(full, plain)),
            eager_bit_equal=bool(torch.equal(full, fulls[name])),
            eager_max_abs_err=float((full - fulls[name]).abs().max()),
            max_abs_err=float((full - plain).abs().max()),
            wrong_rows_err=float((full - plain.roll(1, 0)).abs().max()),
            tokens_equal=bool(torch.equal(full.argmax(-1),
                                          plain.argmax(-1))),
            min_top2_gap=float((top2[..., 0] - top2[..., 1]).min()))
    if n >= 2:
        # the bf16 prefill of 48 SSM layers carries another GEMM shape's
        # roundings a rank through the recurrence: the same prefill in f32
        # is gated beside it, tighter
        m32 = pytree.tree_map(lambda t: t.float(), mp)
        plain32, _ = lm.prefill(m32, min_, mcfg)
        got32 = _spmd_steps(mesh, qcfg, mcfg, qp, copy(rings), qin, m32,
                            min_, count=False)[1][0].full_tensor()
        rec["mamba2-1.3b prefill"].update(
            f32_max_abs_err=float((got32 - plain32).abs().max()),
            f32_scale=float(plain32.abs().max()))
        g32 = _spmd_graph(mesh, m_step, put(m32, param_sharding, "prefill"),
                          put(min_, batch_sharding, "prefill"), reps=0)
        rec["mamba2-1.3b prefill"]["graph"].update(
            f32_max_abs_err=float((g32["logits"] - plain32).abs().max()),
            f32_collectives=g32["collectives"])
        del m32, plain32, got32, g32
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _spmd_steps(mesh, qcfg, mcfg, qp, copy(rings), qin, mp, min_,
                        count=False)
        rec["nccl_device_ms_both_steps"] = _nccl_ms(prof)[1]
    # the Wine train app on the same mesh, the models above freed first
    del qp, mp, rings, plain_q, plain_m, simt_m, q, m, fulls, graphs
    gc.collect()
    torch.cuda.empty_cache()
    n0 = ssd_scan.launches
    rec["wine train"] = _spmd_wine_train(mesh)
    rec["wine_ssd_launches"] = ssd_scan.launches - n0
    with open(os.path.join(out_dir, f"spmd-rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def phase_spmd(card):
    """``[spmd]``: the SPMD runtime across every card of the machine, one
    rank a card (``spmd.spawn``; NCCL; one rank on a one-card machine).
    Gates, on every rank: the live collectives of each step equal those
    counted under ``counting`` (kind, count, bytes); the mamba2 prefill
    launches the SSD kernel on the tc route on each rank's heads (> 0);
    the logits against the unsharded step — bit-equal on one rank; on
    more, the qwen3 decode's within SPMD_TOL of the logit scale and the
    mamba2 prefill's within SPMD_TOL_SSM (a wrong-rows reading above it)
    and, in f32, within SPMD_TOL_F32; greedy tokens equal unless the
    top-2 gap is a near tie. Printed beside them: the unsharded bf16
    prefill's drift between the SSD routes tc and simt.

    Each rank also runs both steps through the compile cache (one CUDA
    graph a rank a step, captured on the first call, then replayed;
    ``_spmd_graph``) and a mamba2-1.3b train_4k Wine app loaded through
    ``WineAdapter(mesh=...)`` (``_spmd_wine_train``). Gates on every rank
    (``check_spmd_graphs``): one capture and the replays, whose
    collectives (``exe.collectives``) equal the counted ones; the
    prefill's replay launches as many SSD kernels as the eager sharded
    prefill, all tc; the replayed logits bit-equal to the unsharded step
    on one rank, and on more within the eager sharded step's gates (bf16,
    wrong rows, f32, greedy tokens) with NCCL kernels in a profiled
    replay; the Wine app's source not "eager", one capture, its replays'
    SSD launches all tc, its losses within SPMD_TOL_TRAIN of its eager
    sharded losses. Printed: whether a replay is bit-equal to the eager
    sharded step, the host walls, the capture's seconds, the graph pool,
    NCCL device time a replay beside the counted t_collective."""
    from repro_torch.sharding.spmd import spawn
    n = torch.cuda.device_count()
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-spmd-")
    t0 = time.perf_counter()
    spawn(spmd_rank, n, out_dir)
    wall = time.perf_counter() - t0
    recs = []
    for r in range(n):
        with open(os.path.join(out_dir, f"spmd-rank{r}.json")) as f:
            recs.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    for rec in recs:
        for name in ("qwen3-14b decode_step", "mamba2-1.3b prefill"):
            x = rec[name]
            tag = f"[spmd] rank {rec['rank']} of {n} ({rec['mesh']}) {name}"
            check(x["collectives"] == x["counted"],
                  f"{tag}: live collectives {x['collectives']} != counted "
                  f"{x['counted']}")
            if n == 1:
                check(x["bit_equal"], f"{tag}: not bit-equal to the "
                      f"unsharded step (max |d| {x['max_abs_err']})")
            else:
                tol = SPMD_TOL_SSM if name.startswith("mamba2") else SPMD_TOL
                check(x["max_abs_err"] <= tol * x["scale"],
                      f"{tag}: max |d| {x['max_abs_err']} > {tol} of "
                      f"{x['scale']}")
                check(x["wrong_rows_err"] > tol * x["scale"],
                      f"{tag}: the wrong rows' logits read "
                      f"{x['wrong_rows_err']}, within {tol} of "
                      f"{x['scale']}: the gate tells nothing")
                check(x["tokens_equal"] or x["min_top2_gap"]
                      < tol * x["scale"],
                      f"{tag}: greedy tokens differ past a near tie")
            if "f32_max_abs_err" in x:
                check(x["f32_max_abs_err"] <= SPMD_TOL_F32 * x["f32_scale"],
                      f"{tag}: f32 max |d| {x['f32_max_abs_err']} > "
                      f"{SPMD_TOL_F32} of {x['f32_scale']}")
                print(f"{tag}: bf16 max |d| {x['max_abs_err']:.4g} of "
                      f"{x['scale']:.4g} (gated at {SPMD_TOL_SSM}; the wrong "
                      f"rows read {x['wrong_rows_err']:.4g}); f32 max |d| "
                      f"{x['f32_max_abs_err']:.3g} of {x['f32_scale']:.3g} "
                      f"(gated at {SPMD_TOL_F32}); tokens equal "
                      f"{x['tokens_equal']}")
            if "simt_err" in x:
                print(f"{tag}: control, no mesh: the bf16 prefill with the "
                      f"SSD scan on simt against tc max |d| "
                      f"{x['simt_err']:.4g} of {x['scale']:.4g}")
            print(f"{tag}: {n} rank(s), collectives {x['collectives']} "
                  f"({x['collective_bytes']} B a rank; counted the same "
                  f"on meta), t_collective at 450 GB/s "
                  f"{x['t_collective_ms']:.4f} ms; host wall "
                  f"{x['host_ms']:.1f} ms sharded (the first call, counted: "
                  f"{x['counted_host_ms']:.1f}) vs {x['plain_host_ms']:.1f}"
                  f" ms unsharded; max |d| {x['max_abs_err']:.3g} of "
                  f"{x['scale']:.3g} (bit-equal {x['bit_equal']}); {card}")
        m = rec["mamba2-1.3b prefill"]
        check(m["ssd_tc"] > 0 and m["ssd_tc"] == m["ssd_launches"],
              f"[spmd] rank {rec['rank']}: the sharded mamba2 prefill "
              f"launched {m['ssd_launches']} SSD kernels, {m['ssd_tc']} tc")
        if "nccl_device_ms_both_steps" in rec:
            print(f"[spmd] rank {rec['rank']} of {n}: NCCL device time "
                  f"{rec['nccl_device_ms_both_steps']:.3f} ms over both "
                  f"steps beside the counted t_collective "
                  f"{sum(rec[k]['t_collective_ms'] for k in ('qwen3-14b decode_step', 'mamba2-1.3b prefill')):.4f} ms")
        check_spmd_graphs(rec, n, card)
    print(f"[spmd] {n} rank(s), one a card: SSD tc launches "
          f"{[r['mamba2-1.3b prefill']['ssd_tc'] for r in recs]} a rank; "
          f"counted on meta in {recs[0]['t_count_s']:.1f}s; phase wall "
          f"{wall:.1f}s; torch {torch.__version__}; {card}")
    return recs


def check_spmd_graphs(rec, n, card):
    """``[spmd]``'s gates on one rank's captured steps (``_spmd_graph``)
    and its Wine train app (``_spmd_wine_train``); see ``phase_spmd``."""
    for name in ("qwen3-14b decode_step", "mamba2-1.3b prefill"):
        x, g = rec[name], rec[name]["graph"]
        tag = (f"[spmd] rank {rec['rank']} of {n} ({rec['mesh']}) {name}, "
               f"replayed")
        check(g["source"] == "compiled" and g["captures"] == 1
              and g["replays"] >= 2, f"{tag}: source {g['source']}, "
              f"{g['captures']} captures, {g['replays']} replays")
        check(g["collectives"] == x["counted"],
              f"{tag}: the replay's collectives {g['collectives']} != "
              f"counted {x['counted']}")
        if name.startswith("mamba2"):
            check(g["ssd_tc"] == g["ssd_launches"] == x["ssd_launches"] > 0,
                  f"{tag}: {g['ssd_launches']} SSD launches in a replay "
                  f"({g['ssd_tc']} tc), {x['ssd_launches']} eager")
        if n == 1:
            check(g["bit_equal"], f"{tag}: not bit-equal to the unsharded "
                  f"step (max |d| {g['max_abs_err']})")
        else:
            tol = SPMD_TOL_SSM if name.startswith("mamba2") else SPMD_TOL
            check(g["max_abs_err"] <= tol * x["scale"],
                  f"{tag}: max |d| {g['max_abs_err']} > {tol} of "
                  f"{x['scale']}")
            check(g["wrong_rows_err"] > tol * x["scale"],
                  f"{tag}: the wrong rows read {g['wrong_rows_err']}")
            check(g["tokens_equal"] or g["min_top2_gap"] < tol * x["scale"],
                  f"{tag}: greedy tokens differ past a near tie")
            check(g.get("nccl_kernels", 0) > 0,
                  f"{tag}: no NCCL kernel in a profiled replay")
            if "f32_max_abs_err" in g:
                check(g["f32_max_abs_err"] <= SPMD_TOL_F32 * x["f32_scale"],
                      f"{tag}: f32 max |d| {g['f32_max_abs_err']} > "
                      f"{SPMD_TOL_F32} of {x['f32_scale']}")
        nccl = (f"; NCCL device time a replay {g['nccl_device_ms']:.3f} ms "
                f"({g['nccl_kernels']} kernels) beside the counted "
                f"t_collective {x['t_collective_ms']:.4f} ms"
                if "nccl_device_ms" in g else "")
        f32 = (f"; f32 max |d| {g['f32_max_abs_err']:.3g} (its replay's "
               f"collectives {g['f32_collectives']})"
               if "f32_max_abs_err" in g else "")
        print(f"{tag}: collectives {g['collectives']} (= counted); host "
              f"wall {g['host_ms']:.2f} ms replayed vs {x['host_ms']:.1f} "
              f"eager sharded vs {x['plain_host_ms']:.1f} unsharded; capture "
              f"{g['t_capture_s']:.2f} s (first call {g['first_call_ms']:.0f}"
              f" ms, its warm-up included); graph pool {g['pool_mib']:.1f} "
              f"MiB; max |d| {g['max_abs_err']:.3g} of {x['scale']:.3g} "
              f"(bit-equal to unsharded {g['bit_equal']}; to the eager "
              f"sharded step {g['eager_bit_equal']}, max |d| "
              f"{g['eager_max_abs_err']:.3g}); SSD launches in a replay "
              f"{g['ssd_launches']} ({g['ssd_tc']} tc){f32}{nccl}; {card}")
    w = rec["wine train"]
    tag = f"[spmd] rank {rec['rank']} of {n} wine mamba2-1.3b train_4k"
    check(w["source"] != "eager" and w["captures"] == 1
          and w["replays"] == SPMD_WINE_STEPS - 1,
          f"{tag}: source {w['source']}, {w['captures']} captures, "
          f"{w['replays']} replays")
    check(all(math.isfinite(v) for v in w["losses"]) and
          w["rel"] <= SPMD_TOL_TRAIN, f"{tag}: losses {w['losses']} vs "
          f"eager sharded {w['eager_losses']} (rel {w['rel']:.3g} > "
          f"{SPMD_TOL_TRAIN})")
    check(w["ssd_tc_in_replays"] == w["ssd_launches_in_replays"] > 0,
          f"{tag}: {w['ssd_launches_in_replays']} SSD launches in the "
          f"replays, {w['ssd_tc_in_replays']} tc")
    print(f"{tag} (reduced: {w['reduced']}): source {w['source']}, "
          f"{w['captures']} capture ({w['t_capture_s']:.2f} s), "
          f"{w['replays']} replays; losses {w['losses']} vs eager sharded "
          f"{w['eager_losses']} (rel {w['rel']:.3g}, gated at "
          f"{SPMD_TOL_TRAIN}); SSD launches in the replays "
          f"{w['ssd_launches_in_replays']} ({w['ssd_tc_in_replays']} tc); "
          f"host ms a step {[round(v, 1) for v in w['host_ms']]} vs eager "
          f"sharded {[round(v, 1) for v in w['eager_host_ms']]}; {card}")


def phase_dryrun(card):
    """``launch.dryrun.run_cell`` on the 16 x 16 production mesh (abstract,
    meta tensors, the host's CPU; the step under the SPMD runtime on a fake
    process group): qwen3-14b ``decode_32k`` and mamba2-1.3b ``train_4k``;
    each row's status must be ``ok``, with collectives counted (bytes a
    chip above 0 and a table by kind)."""
    from repro_torch.launch.dryrun import run_cell
    out = {}
    for arch, shape in (("qwen3-14b", "decode_32k"),
                        ("mamba2-1.3b", "train_4k")):
        rec = run_cell(arch, shape, multi_pod=False)
        check(rec["status"] == "ok",
              f"[dryrun] {arch} {shape}: {rec.get('error')}\n"
              f"{rec.get('trace', '')}")
        check(rec["collective_bytes_per_chip"] > 0 and rec["collectives"],
              f"[dryrun] {arch} {shape}: no collective counted")
        out[f"{arch} {shape}"] = rec
        print(f"[dryrun] {json.dumps(rec)}")
        print(f"[dryrun] {arch} {shape}: bound {rec['bound']} (compute "
              f"{rec['t_compute'] * 1e3:.3f} ms, memory "
              f"{rec['t_memory'] * 1e3:.3f} ms, collective "
              f"{rec['t_collective'] * 1e3:.3f} ms: "
              f"{rec['collective_bytes_per_chip']:.0f} B a chip, "
              f"{rec['collectives']})")
    print(f"[dryrun] {len(out)} rows on the abstract 16 x 16 mesh at the "
          f"H100 data-sheet constants, counted on this host's CPU (the card "
          f"the times elsewhere ran on: {card})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # every run starts cold: the compile cache's records go to a fresh
    # directory (a leftover one would turn "compiled" into "disk"), set
    # before the first import of repro_torch and removed at exit
    graphs = tempfile.mkdtemp(prefix="chip-smoke-graphs-")
    os.environ["REPRO_COMPILE_CACHE_DIR"] = graphs
    atexit.register(shutil.rmtree, graphs, ignore_errors=True)
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
    card_settings()
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
        ("paged_attention", ("paged_split", "paged_combine", "paged_tile",
                             "paged_mla")),
        ("ssd_scan", ("ssd_scan_tc",)))
        for f, n in spills.get(kname, {}).items()
        if any(part in f for part in parts)}
    check(all(n == 0 for n in new_spills.values()),
          f"a tensor-core or split kernel spills: {new_spills}")
    for kname, part in (("flash_attention", "flash_attention_bf16"),
                        ("paged_attention", "paged_tile_kernel"),
                        ("paged_attention", "paged_mla_kernel"),
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
    mla_smem = libs["paged_attention"].paged_attention_mla_smem_bytes
    limit.restype = mla_smem.restype = ctypes.c_longlong
    print(f"[build]   paged_attention: mla blocks at deepseek-v2's Dk 512 "
          f"(16-row pages): {mla_smem(512, 32, 16):,} bytes at 32 table "
          f"entries, {mla_smem(512, 256, 16):,} at 256")
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
    mesh = phase_mesh(card, counters, launch)
    print(f"[mesh] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dist = phase_dist(card, counters, launch)
    t_dist = time.perf_counter() - t0
    print(f"[dist] phase wall {t_dist:.1f}s")
    t0 = time.perf_counter()
    wine = phase_wine(card, counters)
    print(f"[wine] phase wall {time.perf_counter() - t0:.1f}s")
    fault = phase_train_fault(counters, card)
    elastic = phase_elastic(card, fault)
    examples = phase_examples(card, root)
    t0 = time.perf_counter()
    pipe = phase_pipeline(card, ssd_scan, ssd_chunked_ref)
    print(f"[pipeline] phase wall {time.perf_counter() - t0:.1f}s")

    cfg = get_config("qwen3-14b")
    params = draw(cfg, init_params, "serve")
    srv = phase_serve(cfg, params, paged_attention, card, capture_step=False)
    t0 = time.perf_counter()
    graph = phase_serve_graph(cfg, params, paged_attention, card, srv)
    print(f"[serve-graph] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    graph["lockstep_prefill"] = phase_lockstep_prefill(
        cfg, params, (("batched", 4, 128), ("warm", 1, 64)))
    print(f"[lockstep-prefill] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    obs = phase_serve_obs(cfg, params, paged_attention, card, graph)
    print(f"[serve-obs] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    fixed = phase_serve_fixed(cfg, params, card, graph)
    print(f"[serve-fixed] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    fixed["varied_lengths"] = phase_varied_lengths(
        cfg, params, None, "serve-fixed-varied",
        (211, 97, 150, 113, 178, 131, 196, 160), "fixed", card, capacity=512)
    print(f"[serve-fixed-varied] phase wall {time.perf_counter() - t0:.1f}s")
    srv["lockstep"] = phase_lockstep(cfg, params)
    srv["profile"] = phase_profile(cfg, params)
    srv["prefill_profile"] = phase_profile_prefill(
        cfg, params, S=128, tag="profile", kernel="paged")
    blocked = phase_blocked(cfg, params, card)
    t0 = time.perf_counter()
    churn = phase_engine_churn(cfg, params, card)
    print(f"[engine-churn] phase wall {time.perf_counter() - t0:.1f}s")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    restart = phase_restart(card, root)
    print(f"[restart] phase wall {time.perf_counter() - t0:.1f}s")

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
    restart["mamba2-1.3b"] = phase_restart_ssm(cfg, params, ssd_scan, card)
    print(f"[restart-ssm] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dist_serve = phase_dist_serve(cfg, params, ssd_scan, card, ssm)
    t_dist_serve = time.perf_counter() - t0
    print(f"[dist-serve] phase wall {t_dist_serve:.1f}s; [dist] + "
          f"[dist-serve] add {t_dist + t_dist_serve:.1f}s to this script")
    t0 = time.perf_counter()
    fixed_ssm = phase_serve_fixed_ssm(cfg, params, ssd_scan, card, ssm)
    print(f"[serve-fixed-ssm] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ssm["varied_lengths"] = phase_varied_lengths(
        cfg, params, ssd_scan, "serve-ssm-varied",
        (80, 112, 144, 176, 208, 240, 256, 768), "paged", card,
        capacity=1024, page_size=16, kernel="auto")
    print(f"[serve-ssm-varied] phase wall {time.perf_counter() - t0:.1f}s")
    ssm.pop("outs")
    ssm["lockstep"] = phase_lockstep_ssm(cfg, params)
    ssm["profile"] = phase_profile(cfg, params, S=512, tag="profile-ssm")
    ssm["prefill_profile"] = phase_profile_prefill(cfg, params,
                                                   more_slots=64)
    ssm["lockstep_prefill"] = phase_lockstep_prefill(
        cfg, params, (("batched", 4, 512), ("batched", 4, 192)))
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
                      routes=("mla", "mla"))
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
    t0 = time.perf_counter()
    roof = phase_roofline(card, srv["profile"], train_ssm["profile"])
    print(f"[roofline] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dry = phase_dryrun(card)
    print(f"[dryrun] phase wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    spmd = phase_spmd(card)
    print(f"[spmd] phase wall {time.perf_counter() - t0:.1f}s")

    paged_phases = {"serve": srv, "serve-graph": graph, "serve-obs": obs,
                    "restart A": restart["A"], "restart B": restart["B"],
                    "serve-window": win, "serve-moe": moe, "serve-mla": mla}
    ssm_restart = {f"restart-ssm {k}": restart["mamba2-1.3b"][k]
                   for k in "AB"}
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
        "launches_in_replays_by_phase": {
            n: r["step"]["launches_in_replays"]["paged_attention"]
            for n, r in paged_phases.items()},
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
        "name": "paged_attention (mla route)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:107",
        "launches": mla["routes"]["mla"],
        "launches_in_replays": mla["step"]["launches_in_replays"][
            "paged_attention"],
        "max_abs_err": max(r["max_abs_err_f32"] for r in rec_mla.values()),
        **{k: rec_mla["decode"][k] for k in (
            "ms", "device_ms", "general_device_ms", "plain_ms", "bound_ms",
            "bound_by")},
        "library_ms": None,
        "shape": "deepseek-v2 decode B=4 S=1 H=128 K=1 Dk=512 + Dk2=64, "
                 "Dv=512 (v is k) ps=16 npps=32, 9 live pages/slot, bf16; "
                 "max_abs_err against the f32 answer on the same bf16 "
                 "inputs (limit: one bf16 rounding)",
        "sdpa_dense_view_ms": rec_mla["decode"]["sdpa_ms"],
        **{shape: {k: rec_mla[shape][k] for k in (
            "ms", "device_ms", "general_device_ms", "plain_ms", "bound_ms",
            "bound_by", "sdpa_ms", "max_abs_err_f32")}
           for shape in ("prefill", "long_decode")},
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:63",
        "launches": ssm["launches"] + dist_serve["launches"]
        + fixed_ssm["launches"] + int8["launches"]
        + sum(r["launches"] for r in ssm_restart.values()) + sum(
            train_ssm[m]["launches"]["ssd_scan"]
            for m in ("eager", "replayed"))
        + fault["launches"]["ssd_scan"] + wine["launches"]["ssd_scan"]
        + pipe["mamba2-1.3b"]["ssd_routes"]["bfloat16 pipeline"]["tc"]
        + spmd[0]["mamba2-1.3b prefill"]["ssd_launches"]
        + spmd[0]["graph_ssd_launches"] + spmd[0]["wine_ssd_launches"],
        "launches_by_phase": {
            "serve-ssm": ssm["launches"],
            "dist-serve": dist_serve["launches"],
            "serve-fixed-ssm": fixed_ssm["launches"],
            "serve-int8": int8["launches"],
            **{n: r["launches"] for n, r in ssm_restart.items()},
            "train-ssm eager": train_ssm["eager"]["launches"]["ssd_scan"],
            "train-ssm replayed":
                train_ssm["replayed"]["launches"]["ssd_scan"],
            "train-fault": fault["launches"]["ssd_scan"],
            "wine (prefill and train replays)":
                wine["launches"]["ssd_scan"],
            "pipeline (bf16, 4 stages x 4 microbatches)":
                pipe["mamba2-1.3b"]["ssd_routes"]["bfloat16 pipeline"]["tc"],
            f"spmd (rank 0 of {len(spmd)}: the sharded prefill)":
                spmd[0]["mamba2-1.3b prefill"]["ssd_launches"],
            f"spmd (rank 0 of {len(spmd)}: the captured sharded prefill, "
            f"its warm-up and replays)": spmd[0]["graph_ssd_launches"],
            f"spmd (rank 0 of {len(spmd)}: the Wine train app, eager and "
            f"compiled)": spmd[0]["wine_ssd_launches"]},
        "launches_in_replays_by_phase": {
            **{n: r["step"]["launches_in_replays"]["ssd_scan"]
               for n, r in (("serve-ssm", ssm), ("dist-serve", dist_serve),
                            ("serve-fixed-ssm", fixed_ssm),
                            ("serve-int8", int8), *ssm_restart.items())},
            f"spmd (rank 0 of {len(spmd)})":
                spmd[0]["mamba2-1.3b prefill"]["graph"]["replays"]
                * spmd[0]["mamba2-1.3b prefill"]["graph"]["ssd_launches"]
                + spmd[0]["wine train"]["ssd_launches_in_replays"]},
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
                            "serve-fixed-ssm": fixed_ssm["routes"],
                            "serve-int8": int8["routes"],
                            **{n: r["routes"] for n, r in ssm_restart.items()},
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
    print(f"[mesh] summary {json.dumps(mesh)}")
    print(f"[pipeline] summary {json.dumps(pipe)}")
    print(f"[elastic] summary {json.dumps(elastic)}")
    print(f"[roofline] summary {json.dumps(roof)}")
    print(f"[dryrun] summary {json.dumps(dry)}")
    print(f"[dist] summary {json.dumps(dist)}")
    print(f"[wine] summary {json.dumps(wine)}")
    print(f"[serve] summary {json.dumps(srv)}")
    print(f"[serve-graph] summary {json.dumps(graph)}")
    print(f"[restart] summary {json.dumps(restart)}")
    print(f"[engine-churn] summary {json.dumps(churn)}")
    print(f"[serve-obs] summary {json.dumps(obs)}")
    print(f"[serve-fixed] summary {json.dumps(fixed)}")
    print(f"[serve-ssm] summary {json.dumps(ssm)}")
    print(f"[dist-serve] summary {json.dumps(dist_serve)}")
    print(f"[serve-fixed-ssm] summary {json.dumps(fixed_ssm)}")
    print(f"[blocked] summary {json.dumps(blocked)}")
    print(f"[serve-window] summary {json.dumps(win)}")
    print(f"[lockstep-window] summary {json.dumps(lock_win)}")
    print(f"[serve-int8] summary {json.dumps(int8)}")
    print(f"[serve-moe] summary {json.dumps(moe)}")
    print(f"[serve-mla] summary {json.dumps(mla)}")
    print(f"[encdec] summary {json.dumps(encdec)}")
    print(f"[vlm] summary {json.dumps(vlm)}")
    print(f"[train-fault] summary {json.dumps(fault)}")
    print(f"[examples] summary {json.dumps(examples)}")
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


def spmd_only() -> int:
    """``python3 chip_smoke.py --spmd``: the card line, the SSD kernel's
    build and ``[spmd]`` alone, across every card of the machine (for a
    machine of several cards, where the whole script is not needed)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    card = card_line()
    print(f"[card] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | nvidia-smi: {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build(["ssd_scan"])
    print(f"[build] ssd_scan.cu in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_spmd(card)
    print(f"[spmd] phase wall {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--restart-child"]:
        sys.exit(restart_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--spmd"]:
        sys.exit(spmd_only())
    sys.exit(main())
