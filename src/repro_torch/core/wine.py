"""WineAdapter: the compatibility layer. Port of ``repro.core.wine``.

Wine's job in the paper: present an unmodified Windows application with an
environment "virtually indistinguishable" from its native OS, translating its
ABI onto the host. Here the foreign "applications" are model families with
mutually alien semantics (dense vs MoE routing vs SSM recurrences vs enc-dec
cross-attention vs a patch frontend, prefill vs decode), and the host is the
card. ``WineAdapter`` translates every family onto ONE runtime ABI:

    load(app)             -> Instance   (build + stage + compile = env setup)
    Instance.run(inputs)  -> outputs    (one step)
    Instance.state        -> params, or (params, caches)

The launcher (core.llmr) only ever sees this ABI — which is precisely what
makes it workload-agnostic, the property the paper's whole pipeline rests on.
Like Wine, translation is NOT emulation: on the card a step is a captured
CUDA graph (``core.compile_cache``), replayed, with the port's kernels (the
SSD scan of an SSM prefill among them) inside it.

Modes: ``train`` (the default, as in the reference) runs ``make_train_step``
(forward, backward and AdamW) on the instance's ``{"params", "opt"}`` state
and advances it IN PLACE (on the card the whole step is one captured
graph, with the state bound at its addresses); ``prefill`` runs
``models.lm.prefill`` (whisper's ``encoder_apply`` first) and never
replaces the state; ``decode`` runs ``decode_step`` on the instance's KV
rings and advances them.

The compile cache's disk tier (``core.compile_cache``) records every app
``load`` compiles, so a later process — or another cache over the same
directory — loads it with ``load_report["compile_source"] == "disk"``.
Whether a mode then captures ahead, at load (``load_report
["capture_ahead"]``; ``["captured_ahead"]`` says whether it did, on the
card, for a "disk" app), depends on what its first call does:
``prefill`` does — it is a pure function of the bound weights, so ``load``
runs it once on zero inputs and the first ``run`` replays; ``train`` does
not — its first call is a real step and advances the state; ``decode``
does not — its first call writes the bound caches. Those two capture on
their first ``run``, as the launch backends' wave graphs capture on their
first dispatch (their source reads "disk", their cost is unchanged).

``WineAdapter(mesh=...)`` runs every app under ``sharding_ctx(mesh,
mode)`` (train, serve for decode, prefill) and places a train state on the
mesh (``runtime.elastic.reshard_state``): the state it draws, and a state
passed to ``load`` (a restored checkpoint). Its default backend is an
``ArrayBackend`` over the same mesh.

On a mesh of ranks (``sharding.spmd.spmd_mesh``: one process a card, every
rank running the same apps, loaded in the same order) each rank holds its
shard of the state — params and caches laid out as ``param_sharding`` /
``cache_sharding`` lay them out for the app's mode, a train state as
``reshard_state`` lays it out; a state passed to ``load`` is laid out the
same way — and ``load`` compiles every app through ``backend.compile``
with that state bound, as the reference compiles a sharded app: on the
card each rank captures the step as one CUDA graph (its NCCL collectives
and SSD launches inside) on its first call and replays it afterwards; on
the CPU the executable is the function itself. The executable takes the
batch WHOLE (host or device tensors, as on one device) and lays it out
inside the step (``batch_sharding``, then ``place``): a replay copies the
whole batch into the rank's static buffers on its card (the only bytes
that cross from the host: B x S int32 tokens), and the graph cuts this
rank's rows there (a view where the cut is the leading dim, a copy kernel
otherwise). Outputs are DTensors (``.full_tensor()`` gathers one).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config, input_specs
from repro_torch.core.compile_cache import LazyGraph
from repro_torch.models import lm as lm_mod
from repro_torch.models.spec import (SHAPES_BY_NAME, ModelConfig, ShapeCell,
                                     TensorSpec)
from repro_torch.runtime.elastic import reshard_state
from repro_torch.sharding.partition import (batch_sharding, cache_sharding,
                                            param_sharding, place,
                                            sharding_ctx)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import init_state, make_train_step


#: the modes whose first call changes no state, captured at load
CAPTURE_AHEAD_MODES = ("prefill",)


@dataclass(frozen=True)
class WineApp:
    """An 'application': (architecture, mode, shape) to be launched."""
    arch: str
    mode: str = "train"                    # train | prefill | decode
    shape: str = "train_4k"
    smoke: bool = False
    microbatches: int = 1

    def cell(self) -> ShapeCell:
        return SHAPES_BY_NAME[self.shape]


def _copy_out(tree: Any) -> Any:
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


@dataclass
class Instance:
    app: WineApp
    cfg: ModelConfig
    step_fn: Callable                      # the executable
    state: Any                   # {"params", "opt"}, params or (params, caches)
    load_report: dict = field(default_factory=dict)
    raw_fn: Optional[Callable] = None      # uncompiled translation layer
    device: Any = None

    def run(self, inputs: Any) -> Any:
        try:
            out = self.step_fn(self.state, inputs)
        except TypeError:
            if self.raw_fn is None:
                raise
            # the executable is exact-signature; an input shape the app's
            # declared specs did not foresee gets its own executable per
            # new shape (on the card: its own capture, still on the card),
            # keeping the ABI workload-agnostic instead of erroring
            self.step_fn = LazyGraph(self.raw_fn, self.device,
                                     bind_argnums=(0,))
            self.load_report["compile_source"] = "jit-fallback"
            out = self.step_fn(self.state, inputs)
        # Dispatch on the app's declared mode, NOT on the output's shape:
        # prefill also returns a len-2 tuple — (logits, caches) — but its
        # params are read-only. A graph's outputs alias its memory (the
        # next replay overwrites them), so what the step made is copied
        # out (train: the metrics); the state's own tensors are returned
        # as they are.
        if self.app.mode == "prefill":
            return _copy_out(out)
        new_state, result = out            # train/decode: state advances
        self.state = new_state
        return _copy_out(result)


class WineAdapter:
    """Uniform ABI over all registered model families.

    Compilation goes through the shared ``CompileCache`` (via a
    ``LaunchBackend``), keyed by CONTENT fingerprint — the same cache the
    launcher and the serve engine use, so a Wine app compiled anywhere in
    the process is warm here too. Runs on the card unless built with
    ``device="cpu"`` (or over a backend that runs on the CPU)."""

    def __init__(self, mesh=None, backend=None, cache=None, device=None):
        from repro_torch.core.backend import ArrayBackend
        self.mesh = mesh
        if backend is None:
            backend = ArrayBackend(mesh=mesh, cache=cache, device=device)
        self.backend = backend
        self.cache = backend.cache
        self.device = backend.device

    # -- translation layer ------------------------------------------------
    def _laid_out(self, inputs: Any, mode: str) -> Any:
        """A whole batch laid out on a mesh of ranks (each rank keeps its
        rows; nothing is sent); ``inputs`` itself elsewhere."""
        if not self._spmd:
            return inputs
        return pytree.tree_map(place, inputs,
                               batch_sharding(inputs, self.mesh, mode))

    def _build_train(self, app: WineApp, cfg: ModelConfig):
        step = make_train_step(cfg, AdamWConfig(),
                               microbatches=app.microbatches)

        def traced(state, batch):
            batch = self._laid_out(batch, "train")
            with sharding_ctx(self.mesh, "train"):
                return step(state, batch)
        return traced

    def _build_decode(self, app: WineApp, cfg: ModelConfig):
        def traced(state, inputs):
            params, caches = state
            inputs = self._laid_out(inputs, "serve")
            with sharding_ctx(self.mesh, "serve"):
                logits, caches = lm_mod.decode_step(
                    params, caches, inputs["tokens"], inputs["positions"],
                    cfg, enc_out=inputs.get("enc_out"))
            return (params, caches), logits
        return traced

    def _build_prefill(self, app: WineApp, cfg: ModelConfig):
        def traced(params, inputs):
            inputs = self._laid_out(inputs, "prefill")
            with sharding_ctx(self.mesh, "prefill"):
                enc = None
                if cfg.encoder is not None:
                    enc = lm_mod.encoder_apply(params, inputs["frames"], cfg)
                    inputs = {k: v for k, v in inputs.items()
                              if k != "frames"}
                return lm_mod.prefill(params, inputs, cfg, enc_out=enc)
        return traced

    # -- public ABI --------------------------------------------------------
    def load(self, app: WineApp, key: Optional[int] = None,
             state: Any = None) -> Instance:
        """Set up the 'Wine environment': build, stage, compile.

        Compiles through the shared ``CompileCache`` for the app's declared
        input signature (``input_specs``), so repeat loads — in this
        adapter, another adapter or the launcher — reuse the executable.
        ``key`` seeds the random weights (default 0)."""
        t0 = time.perf_counter()
        cfg = get_config(app.arch, smoke=app.smoke)
        builder = {"train": self._build_train, "decode": self._build_decode,
                   "prefill": self._build_prefill}[app.mode]
        fn = builder(app, cfg)

        if state is None:
            state = self._init_state(app, cfg, 0 if key is None else key)
        else:
            state = self._laid_out_state(app, state)
        t_stage = time.perf_counter() - t0

        specs = input_specs(cfg, self._cell(app))
        compiled, source = self.backend.compile(
            fn, (state, specs), bind_argnums=(0,),
            extras=("wine", app.arch, app.mode, app.shape, app.smoke,
                    app.microbatches))
        ahead = app.mode in CAPTURE_AHEAD_MODES
        captured = ahead and source == "disk" and self.device.type == "cuda"
        if captured:
            compiled(state, pytree.tree_map(
                lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                      device=self.device)
                if isinstance(s, TensorSpec) else s, specs))
        t_compile = time.perf_counter() - t0 - t_stage
        return Instance(app, cfg, compiled, state,
                        {"t_stage": t_stage, "t_compile": t_compile,
                         "compile_source": source,
                         "compile_cached": source in ("memory", "disk"),
                         "capture_ahead": ahead,
                         "captured_ahead": captured},
                        raw_fn=fn, device=self.device)

    @property
    def _spmd(self) -> bool:
        return self.mesh is not None and self.mesh.is_spmd

    def _laid_out_state(self, app: WineApp, state: Any) -> Any:
        """An app's state laid out on the adapter's mesh: a train state
        on any mesh (``reshard_state``); params and caches on a mesh of
        ranks (``param_sharding`` / ``cache_sharding`` for the app's
        mode); ``state`` itself elsewhere."""
        if app.mode == "train":
            return (reshard_state(state, self.mesh) if self.mesh is not None
                    else state)
        if not self._spmd:
            return state
        mode = "serve" if app.mode == "decode" else "prefill"

        def put(tree, shardings):
            return pytree.tree_map(place, tree,
                                   shardings(tree, self.mesh, mode))
        if app.mode == "decode":
            params, caches = state
            return (put(params, param_sharding), put(caches, cache_sharding))
        return put(state, param_sharding)

    def _init_state(self, app: WineApp, cfg: ModelConfig, seed: int):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if app.mode == "train":
            state = init_state(gen, cfg, self.device)
        else:
            state = lm_mod.lm_init(gen, cfg, self.device)
            if app.mode == "decode":
                cell = self._cell(app)
                state = (state, lm_mod.cache_init(
                    cfg, cell.global_batch, cell.seq_len, self.device))
        return self._laid_out_state(app, state)

    def input_specs(self, app: WineApp) -> dict:
        cfg = get_config(app.arch, smoke=app.smoke)
        return input_specs(cfg, self._cell(app))

    @staticmethod
    def _cell(app: WineApp) -> ShapeCell:
        cell = app.cell()
        if app.smoke:
            # a small stand-in of the same mode: tiny batch/seq
            cell = ShapeCell(cell.name, seq_len=min(cell.seq_len, 64),
                             global_batch=min(cell.global_batch, 4),
                             mode=cell.mode)
        return cell
