"""Serving engines: continuous decode over a request pool. Port of
``repro.serve.engine``.

Two engines share one loop (``_EngineBase.run``: admit -> grow -> step):

``ServeEngine``      the fixed-partition baseline: every slot owns a
                     private ``capacity``-row KV ring and admission
                     prefills ONE unpadded prompt per dispatch, then copies
                     it into the slot's rows in place.
``PagedServeEngine`` one shared page pool (``serve.kv_pool``) behind every
                     slot through per-slot page tables; admission packs a
                     priority-ordered group of waiting prompts into ONE
                     length-bucketed prefill; pages are allocated a page at
                     a time as requests decode and batch-class requests are
                     preempted (pages freed, request requeued) when
                     interactive work needs the pool or the slots.

The paged engine also owns two optimizations this module only orchestrates:

* ``kernel=`` selects the attention data path. ``"gather"`` materializes
  each slot's dense KV view per step (the dense baseline); ``"paged"``
  walks the page table inside the CUDA kernel of ``kernels.paged_attention``
  so the dense view is never built (``stats["kv_bytes_avoided"]`` counts
  the bytes of the views it did not build); ``"auto"`` picks paged on CUDA,
  gather on the CPU (where the "paged" path runs the kernel's plain
  version).
* prefix sharing (copy-on-write). After a prompt prefills, its pages are
  REGISTERED under a digest of the prompt tokens, which pins them in the
  pool past the request's lifetime. A later prompt that starts with a
  registered prefix is admitted WARM: it maps the pinned pages into its own
  table (refcount++, zero KV written) and prefills only its suffix. Shared
  pages are immutable: any write landing in one first breaks the page out
  via ``PagePool.cow_page`` + ``models.lm.paged_copy``.
* SSM configs (mamba2, zamba2) keep their recurrent state slot-dense in the
  pool. Right-padded batched prefill would feed pad tokens into the
  recurrence, so their prefill groups have one exact length; a prefix's
  state at the divergence point is not in the pool, so prefix sharing is
  off for them; a stalled slot's state does not advance (``live``).

Every executable of an engine goes through ``backend.compile`` (a
``LaunchBackend``, default an ``ArrayBackend`` on the engine's device and
the process-wide compile cache), as the reference's do: the decode step
(``"step"``), the paged engine's batched prefill, one a (B, S) bucket
(``prefill_b{B}_s{S}``), its warm-suffix prefill, one a padded suffix
length (``warm_s{S}``), and the fixed engine's prefill, one a prompt
length (``prefill_s{S}``). On the card each is a CUDA graph captured on
its first call — that call's warm-up is its real execution, so the pool
advances once — and replayed after; ``stats["compile_sources"]`` reads
``"compiled"`` for each, or ``"memory"`` for a second engine on the same
cache. The weights and the caches (the fixed engine's rings, the paged
engine's pool) are bound: read and written in place at their own
addresses, which is why admission, preemption and copy-on-write change
them in place and never rebind them; tokens, positions, tables, lengths,
slot ids, ``starts`` and the step's static ``live`` mask are copied into
the graph's inputs (the fixed prefill's destination slot too: it writes
the prompt's rings into the slot itself). Graphs that bind the same
tensors share one memory pool (``core.compile_cache``), so each engine's
step and prefills, whatever the number of shapes, share one pool, and
a prefill's graph keeps only its logits. An executable's outputs are
valid until the next replay of any graph in its pool: the engine reads
the logits with ``argmax`` at once.
``capture_step=False`` runs every executable of the engine eagerly
(source ``"eager"``), the baseline the graphs are measured against. On
the CPU an executable is the function itself. Entry points run on the
card unless the caller passes ``device="cpu"``; without a card they raise.

Capture ahead, where the reference compiles. The compile cache's disk
tier records every executable an engine makes (``core.compile_cache``).
An engine built over a cache whose directory holds records of its own
configuration — an earlier process's, or another cache's over the same
directory — makes those executables at construction (source ``"disk"``:
its decode step, and every prefill shape an earlier engine met) and, on
the card, calls each once with inputs that change no state, so its
warm-up and capture happen there and the request path only replays
(``stats["captured_ahead"]``). The paged engine's step runs with ``live``
all False over blank tables and its prefills with lengths 0, blank tables
and every slot id out of range: every KV row goes to the pool's sink
page and the SSM store rewrites slot 0 with its own state. The fixed
engine's rings have no sink: after capturing ahead it refills each leaf
in place with the one value ``cache_init`` gave it. A record's prefill
shape is read from its input signature (``record_args``); the slot count
is part of a configuration's prefix. A cold engine (no record) captures each executable on
its first call, as the reference's engine compiles its prefill shapes.

Admission rejects, each with a finish reason of its own, a prompt over
the engine's capacity (``rejected_over_capacity``) and, on a config with
SSM blocks, a prompt the chunked scan cannot take: one longer than the
SSD chunk and not a multiple of it, or one shorter than ``d_conv - 1``,
which cannot fill the conv state (``rejected_ssm_length``).

While ``obs.metrics.REGISTRY`` is enabled both engines record, as the
reference's do: ``serve.ttft_s`` / ``serve.tpot_s`` (histograms and
series, a finished request with tokens each), ``serve.preemptions``,
``serve.pool_occupancy`` (paged, before each step), ``serve.prefix.hits`` /
``misses`` and ``serve.kernel.bytes_avoided`` (paged), and after ``run``
under an SLO the ``serve.slo_attainment`` series; attainment below
``obs.flight.RECORDER.slo_min`` triggers the flight recorder's
``slo_breach`` bundle. The hooks are host code around the step, never
inside a captured graph.

While ``obs.trace.TRACER`` is enabled the engine records spans on the
profiler's clock (``core.spans``): each step is a ``serve.step`` (``live``:
the slots that advanced); the paged engine's admission a ``serve.admit``
(``placed``), each of its prefill dispatches, from its host arrays to its
first tokens read back, a ``serve.prefill`` (``B``, ``S``, ``rows``: real
prompt rows, ``requests``, ``warm``), and its page growth a
``serve.pre_step`` (``stalled``). The executables' ``exe.*`` spans nest
inside them.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import spans
from repro_torch.core.backend import ArrayBackend
from repro_torch.core.compile_cache import record_args
from repro_torch.core.telemetry import (RequestRecord, class_summary,
                                        slo_attainment)
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.lm import (cache_init, decode_step, paged_cache_init,
                                   paged_clear, paged_copy, paged_decode_step,
                                   paged_prefill, prefill)
from repro_torch.models.spec import ModelConfig, TensorSpec
from repro_torch.obs import flight as _flight
from repro_torch.obs import metrics as _obs
from repro_torch.obs.trace import TRACER
from repro_torch.serve.kv_pool import PagePool
from repro_torch.serve.scheduler import AdmissionScheduler, bucket_len


@dataclass(eq=False)                      # identity semantics: a request is
class Request:                            # a ticket, not a value
    rid: int
    prompt: np.ndarray                    # (S,)
    max_new: int
    priority: str = "interactive"         # "interactive" | "batch"
    out: List[int] = field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None
    # telemetry stamps (perf_counter seconds); budget = max_new after the
    # capacity clamp. Reset by preemption: a preempted request restarts.
    t_enqueue: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    preemptions: int = 0
    budget: Optional[int] = None

    def record(self) -> RequestRecord:
        n = len(self.out)
        ttft = (self.t_first - self.t_enqueue) if self.t_first else 0.0
        tpot = ((self.t_done - self.t_first) / (n - 1)
                if n > 1 and self.t_done and self.t_first else 0.0)
        return RequestRecord(rid=self.rid, priority=self.priority,
                             ttft_s=ttft, tpot_s=tpot, n_tokens=n,
                             preemptions=self.preemptions,
                             finish=self.finish_reason or "length")


class _EngineBase:
    """Shared driver: scheduler-ordered admission, batched decode,
    capacity guards, per-request/per-class telemetry."""

    def __init__(self, cfg: ModelConfig, params, slots: int,
                 backend: Optional[ArrayBackend],
                 scheduler: Optional[AdmissionScheduler], device,
                 capture_step: bool = True):
        if cfg.encoder is not None:
            raise ValueError(f"{cfg.name}: {type(self).__name__} serves "
                             "decoder-only models (it takes no encoder "
                             "output)")
        self._t_init = time.perf_counter()
        self.device = resolve_device(device)
        emb = params["embed"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, the engine runs "
                             f"on {self.device}")
        self.cfg, self.params = cfg, params
        self.slots = slots
        self.backend = (backend if backend is not None
                        else ArrayBackend(device=self.device))
        self.capture_step = capture_step
        self.scheduler = scheduler if scheduler is not None \
            else AdmissionScheduler()
        self.tokens = torch.zeros((slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.pos = torch.zeros((slots, 1), dtype=torch.int32,
                               device=self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self._stalled: set = set()        # slots waiting on a page
        self.records: List[RequestRecord] = []
        self.stats = {"decoded": 0, "admitted": 0, "steps": 0,
                      "rejected_over_capacity": 0, "capacity_clamped": 0,
                      "preemptions": 0, "pool_exhausted": 0,
                      "stall_steps": 0, "prefill_dispatches": 0,
                      "rejected_ssm_length": 0, "captured_ahead": 0,
                      "t_build_s": 0.0, "compile_sources": {}}
        ssm = [b.ssm for g in cfg.groups for b in g.pattern
               if b.ssm is not None]
        # (chunk, d_conv) of each SSM block: the prompt lengths a chunked
        # scan can prefill
        self._ssm_shapes = sorted({(m.chunk, m.d_conv) for m in ssm})
        # registry instruments (created once; observed only while enabled)
        self._m_ttft = _obs.histogram("serve.ttft_s")
        self._m_tpot = _obs.histogram("serve.tpot_s")
        self._m_preempt = _obs.counter("serve.preemptions")
        self._m_occupancy = _obs.gauge("serve.pool_occupancy")

    # -- executables -------------------------------------------------------
    def _executable(self, name: str, fn, example: tuple, extras: tuple,
                    bind_argnums: Tuple[int, ...] = (0, 1)):
        """``fn`` through ``backend.compile`` for ``example``'s signature,
        the weights (and the caches) bound, or ``fn`` itself, run eagerly,
        when the engine was built with ``capture_step=False``; its source
        is noted under ``name`` in ``stats["compile_sources"]``."""
        if self.capture_step:
            exe, src = self.backend.compile(fn, example, extras=extras,
                                            bind_argnums=bind_argnums)
        else:
            exe, src = fn, "eager"
        self.stats["compile_sources"][name] = src
        return exe

    def _recorded(self, prefix: tuple, tokens_at: int) -> List[tuple]:
        """The tokens' shape (argument ``tokens_at``) of each executable the
        compile cache's disk tier records under ``prefix`` on this engine's
        device and does not hold in memory: the prefill shapes an earlier
        engine of this configuration met."""
        cache = getattr(self.backend, "cache", None)
        if not self.capture_step or not hasattr(cache, "records"):
            return []
        shapes = []
        for r in cache.records(prefix, device=self.device):
            try:
                shapes.append(tuple(record_args(r)[tokens_at].shape))
            except Exception:       # a record that cannot be read: a miss
                continue
        return shapes

    def _make_recorded(self) -> None:
        """Make the prefill executables of every shape the disk tier
        records for this configuration (``_recorded``)."""
        raise NotImplementedError

    def _ahead_calls(self) -> list:
        """(executable, harmless arguments) for each executable whose
        source is ``"disk"`` (see the module docstring)."""
        raise NotImplementedError

    def _run_ahead(self, calls: list) -> None:
        for exe, args in calls:
            exe(*args)

    def _capture_ahead(self) -> None:
        """Capture ahead, where the reference compiles: on the card, each
        recorded executable is called once with inputs that change no
        state, so its warm-up and capture are paid at construction. The
        last step of construction: ``stats["t_build_s"]`` is the engine's
        construction seconds, this included."""
        self._make_recorded()
        calls = self._ahead_calls()
        if calls and self.device.type == "cuda":
            self._run_ahead(calls)
            torch.cuda.synchronize(self.device)
            self.stats["captured_ahead"] = len(calls)
        self.stats["t_build_s"] = time.perf_counter() - self._t_init

    def _ints(self, x) -> torch.Tensor:
        """A host index array (tokens, tables, lengths, slot ids) as an
        int32 tensor on the engine's device."""
        return torch.as_tensor(np.asarray(x, np.int32)).to(self.device)

    # -- capacity guard ----------------------------------------------------
    def _request_capacity(self) -> int:
        raise NotImplementedError

    def _screen(self, req: Request) -> bool:
        """Admission guard: reject a prompt that cannot fit, or that an SSM
        block's chunked scan cannot prefill; clamp the generation budget so
        decode never wraps the ring past live history. Prompt rows occupy
        [0, S); generated token t is written at S + t - 1 when fed back,
        and the last token is never fed, so S + budget - 1 <= capacity."""
        cap = self._request_capacity()
        S = len(req.prompt)
        allowed = cap - S + 1
        if S > cap or allowed <= 0:
            return self._reject(req, "rejected_over_capacity")
        if any((S > chunk and S % chunk) or S < d_conv - 1
               for chunk, d_conv in self._ssm_shapes):
            return self._reject(req, "rejected_ssm_length")
        if req.max_new > allowed:
            if req.budget is None:           # count once per request
                self.stats["capacity_clamped"] += 1
            req.budget = allowed
        else:
            req.budget = req.max_new
        req.done = False
        req.finish_reason = None
        return True

    def _reject(self, req: Request, reason: str) -> bool:
        req.done = True
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        self.stats[reason] += 1
        self.records.append(req.record())
        return False

    # -- per-engine hooks --------------------------------------------------
    def _admit(self) -> int:
        """Admit from the scheduler into free slots; returns #admitted."""
        raise NotImplementedError

    def _pre_step(self) -> None:
        """Hook before a decode step (page growth for the paged engine)."""

    def _step_executable(self) -> np.ndarray:
        raise NotImplementedError

    def _release_slot(self, i: int) -> None:
        self.active[i] = None

    # -- shared decode bookkeeping ----------------------------------------
    def _finish(self, i: int, reason: Optional[str] = None) -> None:
        req = self.active[i]
        req.done = True
        req.finish_reason = reason or req.finish_reason or (
            "length" if req.budget == req.max_new else "capacity")
        req.t_done = time.perf_counter()
        rec = req.record()
        self.records.append(rec)
        if _obs.REGISTRY.enabled and rec.n_tokens > 0:
            self._m_ttft.observe(rec.ttft_s)
            self._m_tpot.observe(rec.tpot_s)
            now = time.time()
            _obs.REGISTRY.series_append("serve.ttft_s", now, rec.ttft_s)
            _obs.REGISTRY.series_append("serve.tpot_s", now, rec.tpot_s)
        self._release_slot(i)

    @spans.traced("serve.step", lambda self, n: {"live": n})
    def step(self) -> int:
        """One batched decode step across all slots -> the number of slots
        that advanced."""
        nxt = self._step_executable()
        now = time.perf_counter()
        self.stats["steps"] += 1
        n = 0
        for i, req in enumerate(self.active):
            if req is None or i in self._stalled:
                continue
            req.out.append(int(nxt[i]))
            n += 1
            if req.t_first is None:
                req.t_first = now
            if len(req.out) >= req.budget:
                self._finish(i)
        self.stats["decoded"] += n
        return n

    def run(self, requests: List[Request], max_steps: int = 10_000) -> dict:
        t0 = time.perf_counter()
        for r in requests:
            self.scheduler.enqueue(r)
        while ((self.scheduler.has_pending()
                or any(a is not None for a in self.active))
               and self.stats["steps"] < max_steps):
            admitted = self._admit()
            if any(a is not None for a in self.active):
                self._pre_step()
                self.step()
            elif not admitted and self.scheduler.has_pending():
                # idle engine that cannot place the head request: fail it
                # loudly instead of spinning (pool smaller than one prompt)
                req = self.scheduler.pop_next()
                req.done, req.finish_reason = True, "pool_exhausted"
                req.t_done = time.perf_counter()
                self.stats["pool_exhausted"] += 1
                self.records.append(req.record())
        self.stats["wall_s"] = time.perf_counter() - t0
        self.stats["classes"] = class_summary(self.records)
        slo = self.scheduler.target_first_result_s
        if slo is not None:
            att = slo_attainment(self.records, slo)
            self.stats["slo_attainment"] = att
            if _obs.REGISTRY.enabled:
                _obs.REGISTRY.series_append("serve.slo_attainment",
                                            time.time(), att)
            if att < _flight.RECORDER.slo_min:
                _flight.RECORDER.trigger("slo_breach", attainment=att,
                                         target_first_result_s=slo)
        return self.stats


# ----------------------------------------------------------------------
# Fixed-partition baseline
# ----------------------------------------------------------------------

class ServeEngine(_EngineBase):
    """Fixed-slot batched decoder: every slot owns a private KV ring of
    ``capacity`` rows (static partition; a windowed layer's ring holds
    min(capacity, window) rows), admission prefills one unpadded prompt per
    dispatch (the paper's serial-launch analogue at the serving layer).

    The rings are the step's bound argument: on the card the captured graph
    reads and writes them at their own addresses, so admission copies a
    prefilled prompt into slot ``i`` of every cache leaf in place (KV,
    positions, int8 scales, MLA ``ckv`` / ``kr``, SSM conv and state) and
    never rebinds ``self.caches``. Prefill is one executable a prompt
    length (``prefill_s{S}``), bound like the step to the weights and the
    rings: it writes the prompt's rings into its slot (a device int input)
    in place and returns the logits only, so a length's graph keeps no
    rings of its own."""

    def __init__(self, cfg: ModelConfig, params, slots: int = 8,
                 capacity: int = 256,
                 backend: Optional[ArrayBackend] = None,
                 scheduler: Optional[AdmissionScheduler] = None,
                 device=None, capture_step: bool = True):
        super().__init__(cfg, params, slots, backend, scheduler, device,
                         capture_step)
        self.capacity = capacity
        self.caches = cache_init(cfg, slots, capacity, self.device)

        def step_fn(p, c, t, po):
            logits, _ = decode_step(p, c, t, po, cfg)
            return logits

        self._step = self._executable(
            "step", step_fn, (params, self.caches, self.tokens, self.pos),
            ("serve-step", cfg.name, slots, capacity))
        self._prefill_by_len: dict = {}     # prompt length -> executable
        self._prefill_extras = ("serve-prefill", cfg.name, slots, capacity)
        self._capture_ahead()

    def _request_capacity(self) -> int:
        return self.capacity

    def _make_recorded(self) -> None:
        for _, S in self._recorded(self._prefill_extras, 2):
            self._prefill_exec(S)

    def _ahead_calls(self) -> list:
        """The step over the engine's own tokens and positions, and each
        prompt length into slot 0: both write the rings, which
        ``_run_ahead`` puts back as construction made them."""
        src = self.stats["compile_sources"]
        calls = []
        if src.get("step") == "disk":
            calls.append((self._step, (self.params, self.caches,
                                       self.tokens, self.pos)))
        for S, exe in sorted(self._prefill_by_len.items()):
            if src[f"prefill_s{S}"] == "disk":
                calls.append((exe, (self.params, self.caches,
                                    self._ints(np.zeros((1, S))),
                                    self._ints([0]))))
        return calls

    def _run_ahead(self, calls: list) -> None:
        """The rings have no sink page. They are run ahead over just after
        ``cache_init`` made them, when each leaf holds one value (0, or -1
        for positions): every leaf is refilled with it in place, so the
        engine starts bit-equal to a cold one and never holds a second
        ring set."""
        super()._run_ahead(calls)
        fresh = pytree.tree_leaves(cache_init(self.cfg, 1, 1, "cpu"))
        for x, f in zip(pytree.tree_leaves(self.caches), fresh):
            x.fill_(f.reshape(-1)[0].item())

    def _prefill_exec(self, S: int):
        """The prefill of one unpadded prompt of length ``S``: writes its
        rings into a slot in place and returns its logits."""
        exe = self._prefill_by_len.get(S)
        if exe is None:
            cfg, capacity = self.cfg, self.capacity

            def prefill_fn(p, c, t, slot):
                logits, new = prefill(p, {"tokens": t}, cfg,
                                      capacity=capacity)
                idx = slot.long()
                # leaves are (repeats, slots, ...): slot ``slot`` takes the
                # prompt's row 0
                for d, s in zip(pytree.tree_leaves(c),
                                pytree.tree_leaves(new)):
                    d.index_copy_(1, idx, s.to(d.dtype))
                return logits

            exe = self._prefill_by_len[S] = self._executable(
                f"prefill_s{S}", prefill_fn,
                (self.params, self.caches, TensorSpec((1, S), torch.int32),
                 TensorSpec((1,), torch.int32)), self._prefill_extras)
        return exe

    def _prefill(self, tokens: torch.Tensor, slot: torch.Tensor):
        """One unpadded prompt (1, S) prefilled into slot ``slot`` ((1,)
        int32 on the device) of every ring, in place, through the prompt
        length's executable -> its logits (1, 1, V) (on the card they live
        in the graph's memory until the next replay of its pool)."""
        return self._prefill_exec(tokens.shape[1])(
            self.params, self.caches, tokens, slot)

    def admit(self, req: Request) -> bool:
        """Prefill a request into a free slot (one-slot batch prefill)."""
        if req.budget is None and not self._screen(req):
            return False                      # rejected: over capacity
        for i, a in enumerate(self.active):
            if a is None:
                logits = self._prefill(self._ints(req.prompt)[None],
                                       self._ints([i]))
                self.stats["prefill_dispatches"] += 1
                tok = int(torch.argmax(logits[0, -1]))
                req.out.append(tok)
                req.t_first = time.perf_counter()
                self.tokens[i, 0] = tok
                self.pos[i, 0] = len(req.prompt)
                self.active[i] = req
                self.stats["admitted"] += 1
                if len(req.out) >= req.budget:
                    self._finish(i)
                return True
        return False

    def _admit(self) -> int:
        n = 0
        while self.scheduler.has_pending():
            head = self.scheduler.peek_next()
            if not self._screen(head):
                self.scheduler.pop_next()
                continue
            if not self.admit(head):
                break
            self.scheduler.pop_next()
            n += 1
        return n

    def _decode(self) -> torch.Tensor:
        """One decode step's logits (B, 1, V); the rings advance in place.
        On the card the logits live in the graph's memory until the next
        replay."""
        return self._step(self.params, self.caches, self.tokens, self.pos)

    def _step_executable(self) -> np.ndarray:
        logits = self._decode()
        nxt = torch.argmax(logits[:, 0], -1).to(torch.int32)
        self.tokens = nxt[:, None].contiguous()
        self.pos = self.pos + 1
        return nxt.cpu().numpy()


# ----------------------------------------------------------------------
# Paged engine: shared pool, batched prefill, priority preemption
# ----------------------------------------------------------------------

class PagedServeEngine(_EngineBase):
    """Continuous-batching decoder over one shared KV page pool.

    * capacity is POOLED: ``pool_pages`` pages back all ``slots`` slots;
      a slot holds at most ``pages_per_slot`` pages (its virtual capacity
      ``vcap = pages_per_slot * page_size`` rows), allocated one page at a
      time as its request decodes, so ``pool_pages`` can be far below
      ``slots * pages_per_slot`` (oversubscription);
    * admission pops a priority-ordered GROUP of same-bucket prompts and
      prefills them in ONE padded call (``batched_prefill=False`` reverts
      to the exact-shape one-slot loop);
    * when the pool or the slots are exhausted, batch-class requests are
      preempted for interactive ones (youngest victim first; pages freed,
      victim requeued at the front of its class and restarted on
      re-admission), with admission-time preemption gated by the
      scheduler's ``target_first_result_s`` SLO; a request that can't
      grow and has no victim STALLS until peers free pages, a full-pool
      deadlock preempts one victim to unblock the rest, and only a lone
      request larger than the entire pool is finished early
      (``finish_reason="pool_exhausted"``).

    ``kernel="paged"`` keeps the math of ``kernel="gather"`` (online
    softmax over the same masked rows) without ever materializing the dense
    view; the two reduce in different orders, so logits agree to about one
    bf16 ulp and greedy tokens match up to the first near-tie.
    """

    def __init__(self, cfg: ModelConfig, params, slots: int = 8,
                 page_size: int = 16, pages_per_slot: int = 8,
                 pool_pages: Optional[int] = None,
                 scheduler: Optional[AdmissionScheduler] = None,
                 batched_prefill: bool = True,
                 kernel: str = "auto",
                 prefix_sharing: bool = False,
                 prefix_min_tokens: Optional[int] = None,
                 device=None,
                 backend: Optional[ArrayBackend] = None,
                 capture_step: bool = True):
        super().__init__(cfg, params, slots, backend, scheduler, device,
                         capture_step)
        if pool_pages is None:
            pool_pages = slots * pages_per_slot
        self.pool = PagePool(pool_pages, page_size, slots, pages_per_slot)
        self.kv = paged_cache_init(cfg, slots, pool_pages, page_size,
                                   self.device)
        self.tables = self._ints(self.pool.table_array())
        self._tables_dirty = False
        self.batched_prefill = batched_prefill
        if kernel == "auto":
            kernel = "paged" if self.device.type == "cuda" else "gather"
        if kernel not in ("gather", "paged"):
            raise ValueError(f"kernel must be gather|paged|auto: {kernel!r}")
        self.kernel = kernel
        # right-padded batched prefill is unsound for SSM state (the
        # recurrence would absorb pad tokens): group by exact length then
        self._pad_safe = not any(b.ssm is not None
                                 for g in cfg.groups for b in g.pattern)
        # prefix sharing caches attention pages only; an SSM config's
        # recurrent state at the divergence point is NOT in the pool, so a
        # warm continuation would decode from a wrong (zero) state
        self._prefix_ok = prefix_sharing and self._pad_safe
        self.prefix_min_tokens = (page_size if prefix_min_tokens is None
                                  else prefix_min_tokens)
        self._admit_order = 0                  # preemption recency clock
        self._admit_seq: List[int] = [0] * slots
        self._dense_view_bytes, self._kv_row_bytes = self._kv_geometry()

        def step_fn(p, kv, tables, t, po, live):
            logits, _ = paged_decode_step(p, kv, tables, t, po, cfg,
                                          live=live, kernel=kernel)
            return logits

        self._live = torch.ones((slots,), dtype=torch.bool,
                                device=self.device)
        self._step = self._executable(
            "step", step_fn, (params, self.kv, self.tables, self.tokens,
                              self.pos, self._live),
            ("serve-paged-step", cfg.name, slots, pool_pages, page_size,
             pages_per_slot, kernel))
        self._prefill_by_shape: dict = {}      # (B, S) -> executable
        self._warm_by_len: dict = {}           # S_pad  -> executable
        # the slots too: a prefill's batch never exceeds them, and another
        # slot count's records are not this configuration's shapes
        geometry = (cfg.name, slots, pool_pages, page_size, pages_per_slot,
                    kernel)
        self._prefill_extras = ("serve-paged-prefill",) + geometry
        self._warm_extras = ("serve-paged-warm",) + geometry
        self.stats.update({"prefix_hits": 0, "prefix_misses": 0,
                           "prefix_registered": 0, "cow_pages": 0,
                           "prefill_rows": 0, "kv_bytes_avoided": 0})
        self._m_phit = _obs.counter("serve.prefix.hits")
        self._m_pmiss = _obs.counter("serve.prefix.misses")
        self._m_bytes = _obs.counter("serve.kernel.bytes_avoided")
        self._capture_ahead()

    def _kv_geometry(self) -> Tuple[int, int]:
        """(bytes of dense per-slot views the gather path materializes per
        decode step, bytes one KV cache row costs across all layers)."""
        dense = row = 0
        vcap = self.pool.vcap
        for gtree in self.kv:
            for btree in gtree.values():
                sub = btree.get("attn")
                if not sub:
                    continue
                for name, leaf in sub.items():
                    R = leaf.shape[0]
                    tail = int(np.prod(leaf.shape[3:])) if leaf.ndim > 3 else 1
                    item = leaf.element_size()
                    dense += R * self.slots * vcap * tail * item
                    if name != "pos":
                        row += R * tail * item
        return dense, row

    def _request_capacity(self) -> int:
        return self.pool.vcap

    # -- prefill executables ----------------------------------------------
    def _prefill_example(self, B: int, S: int, warm: bool) -> tuple:
        """The signature of a prefill call: the weights and the pool, then
        tables, tokens, lengths, slot ids (and ``starts``) as int32."""
        spec = (TensorSpec((B, self.pool.pages_per_slot), torch.int32),
                TensorSpec((B, S), torch.int32),
                *[TensorSpec((B,), torch.int32)] * (3 if warm else 2))
        return (self.params, self.kv) + spec

    def _prefill_exec(self, B: int, S: int):
        """The batched prefill of a (B, S) bucket: writes the pool in place
        and returns the last-real-token logits (B, 1, V)."""
        exe = self._prefill_by_shape.get((B, S))
        if exe is None:
            cfg, kern = self.cfg, self.kernel

            def prefill_fn(p, kv, trows, toks, lens, sids):
                return paged_prefill(p, kv, trows, toks, lens, cfg,
                                     slot_ids=sids, kernel=kern)[0]

            exe = self._prefill_by_shape[(B, S)] = self._executable(
                f"prefill_b{B}_s{S}", prefill_fn,
                self._prefill_example(B, S, warm=False), self._prefill_extras)
        return exe

    def _warm_exec(self, S: int):
        """Suffix-continuation prefill (B=1): rows start at ``starts`` and
        attend the slot's already-resident prefix pages through the
        table."""
        exe = self._warm_by_len.get(S)
        if exe is None:
            cfg, kern = self.cfg, self.kernel

            def warm_fn(p, kv, trows, toks, lens, sids, starts):
                return paged_prefill(p, kv, trows, toks, lens, cfg,
                                     slot_ids=sids, starts=starts,
                                     kernel=kern)[0]

            exe = self._warm_by_len[S] = self._executable(
                f"warm_s{S}", warm_fn, self._prefill_example(1, S, warm=True),
                self._warm_extras)
        return exe

    def _make_recorded(self) -> None:
        for B, S in self._recorded(self._prefill_extras, 3):
            self._prefill_exec(B, S)
        for _, S in self._recorded(self._warm_extras, 3):
            self._warm_exec(S)

    def _ahead_calls(self) -> list:
        """The step with ``live`` all False over blank tables, and each
        prefill shape with lengths 0, blank tables and every slot id out of
        range (``starts`` 0 for a warm suffix): every KV row they write
        lands in the pool's sink page, and the SSM store rewrites slot 0
        with its own state."""
        src = self.stats["compile_sources"]
        blank = np.full((self.slots, self.pool.pages_per_slot), -1)
        calls = []
        if src.get("step") == "disk":
            calls.append((self._step, (
                self.params, self.kv, self._ints(blank), self.tokens,
                self.pos, torch.zeros_like(self._live))))
        shapes = [(f"prefill_b{B}_s{S}", exe, B, S, False)
                  for (B, S), exe in sorted(self._prefill_by_shape.items())]
        shapes += [(f"warm_s{S}", exe, 1, S, True)
                   for S, exe in sorted(self._warm_by_len.items())]
        for name, exe, B, S, warm in shapes:
            if src[name] != "disk":
                continue
            zeros = self._ints(np.zeros((B,)))
            calls.append((exe, (
                self.params, self.kv, self._ints(blank[:B]),
                self._ints(np.zeros((B, S))), zeros,
                self._ints(np.full((B,), self.slots)))
                + ((zeros,) if warm else ())))
        return calls

    # -- prefix sharing ----------------------------------------------------
    @staticmethod
    def _digest(tokens) -> bytes:
        return hashlib.sha1(
            np.ascontiguousarray(tokens, np.int32).tobytes()).digest()

    def _match_prefix(self, req: Request):
        """Longest registered, token-verified prefix strictly shorter than
        or equal to the prompt: returns (L, entry) or None. L == len(prompt)
        still re-prefills the last token (logits need a forward pass)."""
        if not self._prefix_ok:
            return None
        S = len(req.prompt)
        for L in self.pool.prefix_lengths():
            if L > S or L < self.prefix_min_tokens:
                continue
            e = self.pool.lookup_prefix(self._digest(req.prompt[:L]),
                                        req.prompt)
            if e is not None:
                return L, e
        return None

    def _cow(self, slot: int, pg_idx: int, priority: str) -> bool:
        """Break the shared page at ``slot``'s table index ``pg_idx`` out
        into a private copy (pool bookkeeping + device-side page copy)."""
        res = self.pool.cow_page(slot, pg_idx)
        if res is None and self._ensure_pages(1, priority, exclude=slot):
            res = self.pool.cow_page(slot, pg_idx)
        if res is None:
            return False
        src, dst = res
        self.kv = paged_copy(self.kv, src, dst)
        self.stats["cow_pages"] += 1
        self._tables_dirty = True
        return True

    def _register(self, slot: int, req: Request) -> None:
        """Pin the pages holding ``req``'s full prompt under its digest.
        The boundary page may later take the owner's decode writes — the
        owner COWs it first (``_pre_step``), leaving the pinned snapshot
        frozen."""
        if not self._prefix_ok:
            return
        S = len(req.prompt)
        if S < self.prefix_min_tokens:
            return
        pages = self.pool.pages_of(slot)[: self.pool.pages_for_tokens(S)]
        if self.pool.register_prefix(self._digest(req.prompt),
                                     req.prompt, pages):
            self.stats["prefix_registered"] += 1

    # -- preemption --------------------------------------------------------
    def _preempt(self, i: int) -> None:
        """Evict slot ``i``'s (batch-class) request: free + clear its
        pages, requeue it at the front of its class, restart-on-readmit."""
        req = self.active[i]
        req.out.clear()
        req.t_first = None
        req.preemptions += 1
        self.stats["preemptions"] += 1
        if _obs.REGISTRY.enabled:
            self._m_preempt.inc()
        self.scheduler.requeue_front(req)
        self._release_slot(i)

    def _pick_victim(self, exclude: Optional[int] = None) -> Optional[int]:
        """Youngest-admitted preemptible (batch-class) active slot: the
        least sunk work is thrown away, and FIFO order within the batch
        class is preserved on requeue."""
        best = None
        for i, req in enumerate(self.active):
            if req is None or i == exclude:
                continue
            if req.priority not in self.scheduler.preemptible:
                continue
            if best is None or self._admit_seq[i] > self._admit_seq[best]:
                best = i
        return best

    def _ensure_pages(self, need: int, priority: str,
                      exclude: Optional[int] = None,
                      admission: bool = False) -> bool:
        """Make ``need`` pages available, preempting batch-class work when
        the requester is interactive. Admission-time preemption is gated
        by the scheduler's TTFT SLO; an already-RUNNING interactive request
        growing a page always may preempt. Before touching live work, cold
        pinned prefixes are evicted LRU — cache, not computation, so ANY
        priority may reclaim them."""
        if self.pool.free_pages < need:
            freed = self.pool.evict_prefixes(need)
            if freed:
                self.kv = paged_clear(self.kv, freed)
        while self.pool.free_pages < need:
            if priority != "interactive":
                return False
            if (admission
                    and self.scheduler.target_first_result_s is not None
                    and not self.scheduler.should_preempt()):
                return False
            victim = self._pick_victim(exclude=exclude)
            if victim is None:
                return False
            self._preempt(victim)
        return True

    def _release_slot(self, i: int) -> None:
        freed = self.pool.free_slot(i)
        if freed:
            self.kv = paged_clear(self.kv, freed)
            self._tables_dirty = True
        self.active[i] = None

    # -- admission ---------------------------------------------------------
    def _bucket(self, n: int) -> int:
        if not self._pad_safe:
            return n                          # exact-length groups (SSM)
        return min(bucket_len(n), self.pool.vcap)

    @spans.traced("serve.admit", lambda self, n: {"placed": n})
    def _admit(self) -> int:
        if self._stalled:
            # page-starved: admitting more work would steal the pages the
            # stalled slots are waiting for
            return 0
        # slot pressure: an overdue interactive head may evict a batch slot
        if (all(a is not None for a in self.active)
                and self.scheduler.pending("interactive")
                and self.scheduler.should_preempt()):
            victim = self._pick_victim()
            if victim is not None:
                self._preempt(victim)
        free = [i for i, a in enumerate(self.active) if a is None]
        if not free:
            return 0
        # screen the head until it is admittable (pop rejects outright)
        while self.scheduler.has_pending():
            head = self.scheduler.peek_next()
            if self._screen(head):
                break
            self.scheduler.pop_next()
        if not self.scheduler.has_pending():
            return 0
        head = self.scheduler.peek_next()
        m = self._match_prefix(head)
        if m is not None:
            L, entry = m
            if self._admit_warm(head, L, entry):
                self.scheduler.pop_next()
                return 1
            # warm admission couldn't get pages/slot: fall through cold
        if not self._ensure_pages(
                self.pool.pages_for_tokens(len(head.prompt)), head.priority,
                admission=True):
            return 0
        free = [i for i, a in enumerate(self.active) if a is None]
        if self.batched_prefill:
            b = self._bucket(len(head.prompt))
            group = self.scheduler.pop_group(
                len(free), match=lambda r: self._bucket(len(r.prompt)) == b)
        else:
            group = [self.scheduler.pop_next()]
        placed: List[Tuple[int, Request]] = []
        leftover: List[Request] = []
        for req in group:
            if not self._screen(req):
                continue                     # rejected + recorded in _screen
            need = self.pool.pages_for_tokens(len(req.prompt))
            free = [i for i, a in enumerate(self.active) if a is None
                    and all(i != s for s, _ in placed)]
            if not free or not self._ensure_pages(need, req.priority,
                                                  admission=True):
                leftover.append(req)
                continue
            slot = free.pop(0)
            self.pool.alloc(slot, need)
            placed.append((slot, req))
        for req in reversed(leftover):       # restore original queue order
            self.scheduler.requeue_front(req)
        if placed:
            self._prefill_commit(placed)
        return len(placed)

    def _admit_warm(self, req: Request, L: int, entry: dict) -> bool:
        """Admit ``req`` onto a registered prefix: map the pinned pages
        into a free slot (refcount++, zero KV written), claim private
        pages for the suffix, COW the boundary page when the divergence
        point is inside a shared page, then prefill ONLY the suffix
        (continuing from absolute position ``suffix_start``). A fully-
        cached prompt re-runs just its last token to produce logits."""
        free = [i for i, a in enumerate(self.active) if a is None]
        if not free:
            return False
        slot = free[0]
        S = len(req.prompt)
        shared = entry["pages"]
        n_priv = self.pool.pages_for_tokens(S) - len(shared)
        if not self.pool.share(slot, shared):
            return False
        ok = n_priv <= 0 or (
            self._ensure_pages(n_priv, req.priority, admission=True)
            and self.pool.alloc(slot, n_priv) is not None)
        suffix_start = min(L, S - 1)
        pg_w = suffix_start // self.pool.page_size
        if ok and pg_w < len(shared):
            ok = self._cow(slot, pg_w, req.priority)
        if not ok:
            freed = self.pool.free_slot(slot)   # undo the share
            if freed:
                self.kv = paged_clear(self.kv, freed)
            return False
        S_suf = S - suffix_start
        S_pad = min(bucket_len(S_suf), self.pool.vcap)
        sp = spans.begin("serve.prefill") if TRACER.enabled else None
        toks = np.zeros((1, S_pad), np.int32)
        toks[0, :S_suf] = req.prompt[suffix_start:]
        logits = self._warm_exec(S_pad)(
            self.params, self.kv,
            self._ints(self.pool.table_array()[slot][None]),
            self._ints(toks), self._ints([S_suf]), self._ints([slot]),
            self._ints([suffix_start]))
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_rows"] += S_suf
        self.stats["prefix_hits"] += 1
        if _obs.REGISTRY.enabled:
            self._m_phit.inc()
        tok = int(torch.argmax(logits[0, -1]))
        if sp is not None:
            spans.end(sp, B=1, S=S_pad, rows=S_suf, requests=1, warm=True)
        req.out.append(tok)
        req.t_first = time.perf_counter()
        self.tokens[slot, 0] = tok
        self.pos[slot, 0] = S
        self.active[slot] = req
        self._admit_order += 1
        self._admit_seq[slot] = self._admit_order
        self.stats["admitted"] += 1
        self._tables_dirty = True
        self._register(slot, req)  # a warm prompt seeds longer prefixes too
        if len(req.out) >= req.budget:
            self._finish(slot)
        return True

    def _prefill_commit(self, placed: List[Tuple[int, Request]]) -> None:
        """One prefill call for the whole group. In batched mode the batch
        has a fixed ``slots`` rows — absent slots ride as dummy rows whose
        table is -1 and slot id out of range, so every one of their writes
        (KV rows and SSM state) is dropped."""
        if self.batched_prefill:
            S = max(self._bucket(len(r.prompt)) for _, r in placed)
            B = self.slots
        else:
            S = len(placed[0][1].prompt)     # exact shape, no padding
            B = 1
        sp = spans.begin("serve.prefill") if TRACER.enabled else None
        toks = np.zeros((B, S), np.int32)
        lens = np.zeros((B,), np.int32)
        trows = np.full((B, self.pool.pages_per_slot), -1, np.int32)
        sids = np.full((B,), self.slots, np.int32)      # OOB = dummy row
        table = self.pool.table_array()
        for r, (slot, req) in enumerate(placed):
            n = len(req.prompt)
            toks[r, :n] = req.prompt
            lens[r] = n
            trows[r] = table[slot]
            sids[r] = slot
        logits = self._prefill_exec(B, S)(
            self.params, self.kv, self._ints(trows),
            self._ints(toks), self._ints(lens), self._ints(sids))
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_rows"] += int(lens.sum())
        first = torch.argmax(logits[:, -1], -1).cpu().numpy()
        if sp is not None:
            spans.end(sp, B=B, S=S, rows=int(lens.sum()),
                      requests=len(placed), warm=False)
        now = time.perf_counter()
        for r, (slot, req) in enumerate(placed):
            tok = int(first[r])
            req.out.append(tok)
            req.t_first = now
            self.tokens[slot, 0] = tok
            self.pos[slot, 0] = len(req.prompt)
            self.active[slot] = req
            self._admit_order += 1
            self._admit_seq[slot] = self._admit_order
            self.stats["admitted"] += 1
            if self._prefix_ok and len(req.prompt) >= self.prefix_min_tokens:
                self.stats["prefix_misses"] += 1   # served cold
                if _obs.REGISTRY.enabled:
                    self._m_pmiss.inc()
            self._register(slot, req)
            if len(req.out) >= req.budget:
                self._finish(slot)
        self._tables_dirty = True

    # -- decode-time page growth ------------------------------------------
    @spans.traced("serve.pre_step",
                  lambda self, _: {"stalled": len(self._stalled)})
    def _pre_step(self) -> None:
        """Before each step, make sure every active slot owns the page its
        next KV write lands in. A slot that can't get one (no free page,
        no preemptible victim) STALLS: its in-step KV write is dropped, its
        output token is discarded, and its tokens/pos don't advance — the
        identical step is retried once another request frees pages. When
        EVERY active slot is stalled one victim is preempted to unblock the
        rest; a lone request larger than the entire pool is finished early
        with ``finish_reason="pool_exhausted"``."""
        self._stalled.clear()
        if _obs.REGISTRY.enabled:
            self._m_occupancy.set(self.pool.occupancy)
        ps = self.pool.page_size
        for i, req in enumerate(self.active):
            if req is None:
                continue
            nxt_pos = len(req.prompt) + len(req.out) - 1   # row written now
            v = nxt_pos % self.pool.vcap
            pg_idx = v // ps
            if pg_idx < self.pool.n_allocated(i):
                page = int(self.pool.table[i, pg_idx])
                # page in hand — but a shared page (pinned prefix, or the
                # ring wrapping back onto one) is immutable: copy-on-write
                # before this step's KV row lands in it
                if (self.pool.writable(i, page)
                        or self._cow(i, pg_idx, req.priority)):
                    continue
            elif self.pool.alloc(i, 1) is not None:
                self._tables_dirty = True
                continue
            elif self._ensure_pages(1, req.priority, exclude=i):
                self.pool.alloc(i, 1)
                self._tables_dirty = True
                continue
            self._stalled.add(i)
            self.stats["stall_steps"] += 1
        act = [i for i, r in enumerate(self.active) if r is not None]
        if act and all(i in self._stalled for i in act):
            # full-pool deadlock: nobody can free pages for anybody.
            # Preempt one victim (batch-class first, youngest-admitted
            # first) so the survivors decode on. Only a request ALONE on
            # the pool is finished early.
            victim = max(act, key=lambda i: (
                self.active[i].priority in self.scheduler.preemptible,
                self._admit_seq[i]))
            self._stalled.discard(victim)
            if len(act) == 1:
                self.stats["pool_exhausted"] += 1
                self._finish(victim, reason="pool_exhausted")
            else:
                self._preempt(victim)

    def _decode(self, tables: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
        """One decode step's logits (B, 1, V); the pool advances in place.
        On the card the logits live in the graph's memory until the next
        replay."""
        return self._step(self.params, self.kv, tables, self.tokens,
                          self.pos, live)

    def _step_executable(self) -> np.ndarray:
        if self._tables_dirty:
            self.tables = self._ints(self.pool.table_array())
            self._tables_dirty = False
        tbl, live = self.tables, self._live
        if self._stalled:
            keep = np.ones((self.slots,), bool)
            keep[list(self._stalled)] = False
            # a stalled slot must not write: a page-less stall drops its
            # KV write anyway, but a COW-stall's write would land in a
            # SHARED page — blank the whole row (its output is discarded
            # and the identical step is retried with the real table) —
            # and its SSM state must not absorb the retried token (live)
            masked = self.pool.table_array()
            masked[list(self._stalled)] = -1
            tbl = self._ints(masked)
            live = torch.as_tensor(keep).to(self.device)
        logits = self._decode(tbl, live)
        if self.kernel == "paged":
            self.stats["kv_bytes_avoided"] += self._dense_view_bytes
            if _obs.REGISTRY.enabled:
                self._m_bytes.inc(self._dense_view_bytes)
        nxt = torch.argmax(logits[:, 0], -1).to(torch.int32)
        if self._stalled:
            # stalled slots hold position: same token, same pos, identical
            # retry next step (their page-less KV write was dropped and
            # `live` kept their SSM state)
            k = live[:, None]
            self.tokens = torch.where(k, nxt[:, None], self.tokens)
            self.pos = self.pos + k.to(torch.int32)
        else:
            self.tokens = nxt[:, None].contiguous()
            self.pos = self.pos + 1
        return nxt.cpu().numpy()

    def pool_stats(self) -> Dict[str, float]:
        s = dict(self.pool.stats)
        s["occupancy"] = self.pool.occupancy
        s["free_pages"] = self.pool.free_pages
        s["pinned_prefixes"] = len(self.pool.prefix_keys())
        return s

    def kv_row_bytes(self) -> int:
        """Bytes one KV cache row costs across all attention layers (for
        bytes-on-wire style accounting of ``stats['prefill_rows']``)."""
        return self._kv_row_bytes
