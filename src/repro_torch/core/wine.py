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

Modes: ``prefill`` runs ``models.lm.prefill`` (whisper's ``encoder_apply``
first) and never replaces the state; ``decode`` runs ``decode_step`` on the
instance's KV rings and advances them. ``train`` is not ported (the
reference builds it from ``train/step.py``).
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
from repro_torch.models.spec import SHAPES_BY_NAME, ModelConfig, ShapeCell


@dataclass(frozen=True)
class WineApp:
    """An 'application': (architecture, mode, shape) to be launched."""
    arch: str
    mode: str = "prefill"                  # prefill | decode (train: raises)
    shape: str = "prefill_32k"
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
    state: Any                             # params or (params, caches)
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
        # out; the state's own tensors are returned as they are.
        if self.app.mode == "prefill":
            return _copy_out(out)
        new_state, result = out            # decode: state advances
        self.state = new_state
        return _copy_out(result)


class WineAdapter:
    """Uniform ABI over all registered model families.

    Compilation goes through the shared ``CompileCache`` (via a
    ``LaunchBackend``), keyed by CONTENT fingerprint — the same cache the
    launcher and the serve engine use, so a Wine app compiled anywhere in
    the process is warm here too. Runs on the card unless built with
    ``device="cpu"`` (or over a backend that runs on the CPU)."""

    def __init__(self, backend=None, cache=None, device=None):
        from repro_torch.core.backend import ArrayBackend
        if backend is None:
            backend = ArrayBackend(cache=cache, device=device)
        self.backend = backend
        self.cache = backend.cache
        self.device = backend.device

    # -- translation layer ------------------------------------------------
    def _build_train(self, app: WineApp, cfg: ModelConfig):
        raise NotImplementedError(
            "Wine's train mode is not ported: the port has no training "
            "step yet (ROADMAP.md section 1, item 4)")

    def _build_decode(self, app: WineApp, cfg: ModelConfig):
        def traced(state, inputs):
            params, caches = state
            logits, caches = lm_mod.decode_step(
                params, caches, inputs["tokens"], inputs["positions"], cfg,
                enc_out=inputs.get("enc_out"))
            return (params, caches), logits
        return traced

    def _build_prefill(self, app: WineApp, cfg: ModelConfig):
        def traced(params, inputs):
            enc = None
            if cfg.encoder is not None:
                enc = lm_mod.encoder_apply(params, inputs["frames"], cfg)
                inputs = {k: v for k, v in inputs.items() if k != "frames"}
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
        t_stage = time.perf_counter() - t0

        specs = input_specs(cfg, self._cell(app))
        compiled, source = self.backend.compile(
            fn, (state, specs), bind_argnums=(0,),
            extras=("wine", app.arch, app.mode, app.shape, app.smoke,
                    app.microbatches))
        t_compile = time.perf_counter() - t0 - t_stage
        return Instance(app, cfg, compiled, state,
                        {"t_stage": t_stage, "t_compile": t_compile,
                         "compile_source": source,
                         "compile_cached": source == "memory"},
                        raw_fn=fn, device=self.device)

    def _init_state(self, app: WineApp, cfg: ModelConfig, seed: int):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = lm_mod.lm_init(gen, cfg, self.device)
        if app.mode == "decode":
            cell = self._cell(app)
            caches = lm_mod.cache_init(cfg, cell.global_batch, cell.seq_len,
                                       self.device)
            return (params, caches)
        return params

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
