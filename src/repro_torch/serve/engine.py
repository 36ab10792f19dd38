"""Paged serving engine: continuous decode over one shared KV page pool.
Port of ``repro.serve.engine`` (the paged engine; the fixed-ring
``ServeEngine`` waits).

``_EngineBase.run`` drives admit -> grow -> step. ``PagedServeEngine`` keeps
one shared page pool (``serve.kv_pool``) behind every slot through per-slot
page tables; admission packs a priority-ordered group of waiting prompts
into ONE length-bucketed prefill; pages are allocated a page at a time as
requests decode and batch-class requests are preempted (pages freed,
request requeued) when interactive work needs the pool or the slots.

* ``kernel=`` selects the attention data path. ``"gather"`` materializes
  each slot's dense KV view per step (the dense baseline); ``"paged"``
  walks the page table inside the CUDA kernel of ``kernels.paged_attention``
  so the dense view is never built; ``"auto"`` picks paged on CUDA, gather
  on the CPU (where the "paged" path runs the kernel's plain version).
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

The decode step goes through ``backend.compile`` (a ``LaunchBackend``,
default an ``ArrayBackend`` on the engine's device and the process-wide
compile cache): on the card it is a CUDA graph captured on the first step
and replayed after — one graph per (slots, pool shape, kernel) — and
``stats["compile_sources"]["step"]`` reads ``"compiled"``, or ``"memory"``
for a second engine on the same cache. The step always takes a static
``live`` mask (all true when nothing is stalled) and the page tables,
tokens and positions are copied into the graph's inputs; the weights and
the pool are read and written in place at their own addresses.
``capture_step=False`` runs the step eagerly (source ``"eager"``), the
baseline the graph is measured against. Prefill and warm admission stay
eager (``"eager"`` sources). Entry points run on the card unless the caller
passes ``device="cpu"``; without a card they raise.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backend import ArrayBackend
from repro_torch.core.telemetry import (RequestRecord, class_summary,
                                        slo_attainment)
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.lm import (paged_cache_init, paged_clear, paged_copy,
                                   paged_decode_step, paged_prefill)
from repro_torch.models.spec import ModelConfig
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
                 scheduler: Optional[AdmissionScheduler], device):
        self.device = resolve_device(device)
        emb = params["embed"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, the engine runs "
                             f"on {self.device}")
        self.cfg, self.params = cfg, params
        self.slots = slots
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
                      "compile_sources": {}}

    # -- capacity guard ----------------------------------------------------
    def _request_capacity(self) -> int:
        raise NotImplementedError

    def _screen(self, req: Request) -> bool:
        """Admission guard: reject a prompt that cannot fit; clamp the
        generation budget so decode never wraps the ring past live
        history. Prompt rows occupy [0, S); generated token t is written
        at S + t - 1 when fed back, and the last token is never fed, so
        S + budget - 1 <= capacity."""
        cap = self._request_capacity()
        S = len(req.prompt)
        allowed = cap - S + 1
        if S > cap or allowed <= 0:
            req.done = True
            req.finish_reason = "rejected_over_capacity"
            req.t_done = time.perf_counter()
            self.stats["rejected_over_capacity"] += 1
            self.records.append(req.record())
            return False
        if req.max_new > allowed:
            if req.budget is None:           # count once per request
                self.stats["capacity_clamped"] += 1
            req.budget = allowed
        else:
            req.budget = req.max_new
        req.done = False
        req.finish_reason = None
        return True

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
        self.records.append(req.record())
        self._release_slot(i)

    def step(self) -> None:
        """One batched decode step across all slots."""
        nxt = self._step_executable()
        now = time.perf_counter()
        self.stats["steps"] += 1
        for i, req in enumerate(self.active):
            if req is None or i in self._stalled:
                continue
            req.out.append(int(nxt[i]))
            self.stats["decoded"] += 1
            if req.t_first is None:
                req.t_first = now
            if len(req.out) >= req.budget:
                self._finish(i)

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
            self.stats["slo_attainment"] = slo_attainment(self.records, slo)
        return self.stats


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
        if cfg.encoder is not None:
            raise ValueError(f"{cfg.name}: the paged engine serves "
                             "decoder-only models (it takes no encoder "
                             "output)")
        super().__init__(cfg, params, slots, scheduler, device)
        if pool_pages is None:
            pool_pages = slots * pages_per_slot
        self.pool = PagePool(pool_pages, page_size, slots, pages_per_slot)
        self.kv = paged_cache_init(cfg, slots, pool_pages, page_size,
                                   self.device)
        self.tables = self._table_tensor(self.pool.table_array())
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
        self.backend = (backend if backend is not None
                        else ArrayBackend(device=self.device))

        def step_fn(p, kv, tables, t, po, live):
            logits, _ = paged_decode_step(p, kv, tables, t, po, cfg,
                                          live=live, kernel=kernel)
            return logits

        self._live = torch.ones((slots,), dtype=torch.bool,
                                device=self.device)
        if capture_step:
            self._step, src = self.backend.compile(
                step_fn, (params, self.kv, self.tables, self.tokens,
                          self.pos, self._live), bind_argnums=(0, 1),
                extras=("serve-paged-step", cfg.name, slots, pool_pages,
                        page_size, pages_per_slot, kernel))
        else:
            self._step, src = step_fn, "eager"
        self.stats["compile_sources"]["step"] = src
        self.stats.update({"prefix_hits": 0, "prefix_misses": 0,
                           "prefix_registered": 0, "cow_pages": 0,
                           "prefill_rows": 0})

    def _table_tensor(self, table: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(table, dtype=torch.int32).to(self.device)

    def _request_capacity(self) -> int:
        return self.pool.vcap

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
        toks = np.zeros((1, S_pad), np.int64)
        toks[0, :S_suf] = req.prompt[suffix_start:]
        dev = self.device
        logits, self.kv = paged_prefill(
            self.params, self.kv,
            self._table_tensor(self.pool.table_array()[slot][None]),
            torch.as_tensor(toks, dtype=torch.int32).to(dev),
            torch.tensor([S_suf], dtype=torch.int32, device=dev), self.cfg,
            slot_ids=[slot],
            starts=torch.tensor([suffix_start], dtype=torch.int32,
                                device=dev),
            kernel=self.kernel)
        self.stats["compile_sources"].setdefault(f"warm_s{S_pad}", "eager")
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_rows"] += S_suf
        self.stats["prefix_hits"] += 1
        tok = int(torch.argmax(logits[0, -1]))
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
        toks = np.zeros((B, S), np.int64)
        lens = np.zeros((B,), np.int64)
        trows = np.full((B, self.pool.pages_per_slot), -1, np.int32)
        sids = np.full((B,), self.slots, np.int64)      # OOB = dummy row
        table = self.pool.table_array()
        for r, (slot, req) in enumerate(placed):
            n = len(req.prompt)
            toks[r, :n] = req.prompt
            lens[r] = n
            trows[r] = table[slot]
            sids[r] = slot
        dev = self.device
        logits, self.kv = paged_prefill(
            self.params, self.kv, self._table_tensor(trows),
            torch.as_tensor(toks, dtype=torch.int32).to(dev),
            torch.as_tensor(lens, dtype=torch.int32).to(dev), self.cfg,
            slot_ids=sids, kernel=self.kernel)
        self.stats["compile_sources"].setdefault(f"prefill_b{B}_s{S}",
                                                 "eager")
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_rows"] += int(lens.sum())
        first = torch.argmax(logits[:, -1], -1).cpu().numpy()
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
            self._register(slot, req)
            if len(req.out) >= req.budget:
                self._finish(slot)
        self._tables_dirty = True

    # -- decode-time page growth ------------------------------------------
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
            self.tables = self._table_tensor(self.pool.table_array())
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
            tbl = self._table_tensor(masked)
            live = torch.as_tensor(keep).to(self.device)
        logits = self._decode(tbl, live)
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
