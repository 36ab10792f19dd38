"""Compile cache: the port's compile-once is a captured CUDA graph. Port of
``repro.core.compile_cache``.

The reference pays trace + lower + compile once and dispatches ONE program
per call. PyTorch runs eagerly, so the host issues every kernel of a step
itself (thousands at full width); the counterpart of a compiled executable
is a CUDA graph, captured once and replayed: one host call launches the
whole recorded kernel sequence.

  * executables are keyed by a CONTENT fingerprint, as the reference's: a
    hash of the function's source (plus bounded closure / default / global
    context, with sampled VALUES of captured tensors and arrays), the
    abstract input tree (structure, shapes, dtypes), ``extras``, a salt over
    ``repro_torch``'s own sources, and — in place of ``jax.__version__`` and
    the backend — torch's version, its CUDA version and the device's type,
    name and index (two cards of one model get keys of their own: a graph
    holds one card's addresses). Never ``id(fn)``, which CPython reuses
    after garbage collection;
  * two tiers, memory and disk. A CUDA graph holds raw device addresses, so
    the graph itself cannot go to disk. What does is the RECORD of what was
    captured: the key, the executable's name and ``extras``, the input
    signature (the tree's shapes and dtypes as ``TensorSpec``s) and
    ``bind_argnums``, one JSON file a key (``RECORD_SUFFIX``). ``compile``
    returns source ``"disk"`` for a key this cache has no executable for
    but the directory has a record of, and records every new key. A later
    process lists the records of a configuration (``records``) and
    captures those shapes AHEAD of its first request, where the reference
    compiles (``serve.engine``): the record is the pre-staged environment,
    the capture ahead is its set-up. A disk hit by itself saves no work in
    ``compile``: an executable that nobody captures ahead still captures on
    its first call (the launch backends' wave graphs do; their source reads
    ``"disk"`` and their cost does not change). The tier follows the
    reference's policy: records stamped with another version (torch, CUDA,
    the card's name, the port's source salt: ``_version_tag``) are deleted
    on sight, ``max_bytes`` (default ``REPRO_COMPILE_CACHE_MAX_BYTES``)
    bounds the directory least-recently-used first by bytes (a disk hit
    refreshes a record's mtime), a record is published atomically (a
    temporary file, then ``os.replace``), and a failure to spill counts in
    ``stats["spill_errors"]`` and never raises; an unreadable record is a
    miss and is recorded again. The directory is the port's own
    (``default_cache_dir``) and its prunes touch only its own suffix, so
    the reference's ``.aotx`` spills and the port's records never delete
    each other. The nvcc-built kernel library persists on its own
    (``kernels._build``).

On CUDA ``compile`` returns a ``GraphExecutable``. Its graph is captured on
the FIRST call of a binding (see below): that call runs the function
eagerly on a side stream — the warm-up, which also is the call's real
execution, so a step that advances state advances it once — and then
captures it (capture records, it runs nothing). Every later call copies its
inputs into the graph's static input buffers, replays, and returns the
graph's outputs. Those outputs ALIAS the graph's memory: the next replay
overwrites them, so a caller that keeps them across calls copies them out.
A capture that fails raises; nothing falls back to eager execution. A
function that runs autograd (the train step: forward, backward and AdamW,
``train.step``) is captured the same way: its backward runs on the capture
stream, and its warm-up is the step's real execution, so the state
advances exactly once on the first call.

``bind_argnums`` names arguments the graph reads and writes AT THEIR OWN
ADDRESSES (weights, a KV pool): never copied. A graph is specific to the
addresses it was captured with, so an executable keeps one graph per
binding (the bound tensors' addresses): a second engine on the same cache
gets the cached executable (source ``"memory"``) and captures its own
graph on its first step. Other tensor arguments get static buffers owned
by the graph.

Graphs of one cache that bind the same tensors (an engine's decode step
and its prefill executables, one a shape, all over the same weights and
pool) capture into ONE shared memory pool, so the number of shapes does
not multiply the card's graph memory. Such graphs write the same tensors,
so they replay one at a time on one stream, and the contract is: **an
executable's outputs are valid until the next replay of any graph in its
pool** (a later capture may place its outputs where an earlier graph keeps
its temporaries). Callers consume or copy them at once.

How long a graph lives:

  * a graph that BINDS tensors (an engine's step and prefills, a Wine
    instance's step) lives as long as every tensor it binds. Each bound
    storage is watched (``weakref.finalize``, ``_Binding``); when one is
    freed — the engine is dropped, its pool goes — every graph of that
    binding is unlinked from its executable at once and its pool entry
    leaves ``CompileCache.pools``, so no call can replay it again: a new
    engine whose tensors land at the same addresses captures its own.
    The unlinked graphs, their static buffers and outputs are destroyed as
    soon as no capture is running (a finalizer may fire inside one), in
    the thread that dropped the last reference, after their own card is
    synchronised (no replay of them in flight; no other card waits), and
    the cached blocks are then returned (``empty_cache``), so
    ``memory_reserved()`` falls back;
  * a graph that binds NOTHING (the launch backends' wave graphs, the
    fabric's thread nodes: one a shard shape) keeps a pool of its own,
    owned by its executable (several may replay on several streams at
    once), and goes when the executable goes: with its cache.

The kernels' launch counters (``paged_attention.launches`` / ``.routes``,
``ssd_scan``'s, ``flash_attention.launches``) count in Python, so a replay
would add nothing: the executable takes each counter's change during the
capture back out (the capture launched nothing) and adds it on every
replay.

A sharded step (a DTensor among its arguments: a rank of a mesh of ranks,
``sharding.spmd``) is captured the same way, ONE graph a rank, with that
rank's NCCL collectives and kernel launches inside. Its key and signature
hold each DTensor's layout (the mesh's sizes and axis names, placements,
local shape beside the global one: ``spmd.ShardedSpec``), so the same
global shape laid out otherwise is another executable. It binds, buffers
and copies through local tensors: a bound DTensor's shard is read at its
own address, a static buffer holds a shard (the replay copies the
argument's ``to_local()`` in, and runs no DTensor op), and the outputs are
the capture's DTensors over the graph's memory, returned on every replay.
The warm-up (whose collectives set up the rank's NCCL communicators) and
the capture settle their outputs (``spmd.settle``), so every collective is
waited inside the capture and every NCCL stream joins it. The ranks of a
mesh run one program, so they capture and replay the same executables in
the same order: a rank that replays while another captures would wait on
it forever. A replay dispatches nothing, so the capture's collectives are
recorded (a ``CollectiveCounter`` held over it) and added on every replay
to ``exe.collectives`` and to every counter open in the thread, as the
launch counts below are; the warm-up's are counted as they run. On the CPU
(gloo) a sharded executable counts each call's.

Captures are serialized process-wide (``_CAPTURE_LOCK``): a warm-up and
its capture run on the device's one shared capture stream, and the
counter change a capture takes back out is read from process-global
counters. Thread nodes of the distributed fabric (``repro_torch.dist``),
each with a cache of its own, so capture one at a time while the others
replay; a replay that adds its counts during another thread's capture
is folded into that capture's change (the launch path's applications
launch none of the counted kernels).

On the CPU the executable is the function itself behind the same
signature check and bookkeeping, so the cache's tests (the disk tier's
among them) run without a card.

While ``obs.trace.TRACER`` is enabled every call of an executable is an
``exe.call`` span (``core.spans``; ``source``: ``"replay"``, ``"capture"``,
or ``"eager"`` on the CPU), the ``graph.replay()`` inside it an
``exe.replay`` span and a warm-up with its capture an ``exe.capture`` span.
"""
from __future__ import annotations

import gc
import hashlib
import inspect
import json
import os
import re
import tempfile
import threading
import time
import weakref
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import spans
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import resolve_device
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch.roofline import CollectiveStats
from repro_torch.models.spec import TensorSpec
from repro_torch.obs.trace import TRACER
from repro_torch.sharding.spmd import (CollectiveCounter, ShardedSpec,
                                       count_replayed, local_tensor, rewrap,
                                       settle, spec_of)

# the wrappers whose launch counters a replay must keep true
COUNTED = (paged_attention, ssd_scan, flash_attention)

_DEFAULT_DIR_ENV = "REPRO_COMPILE_CACHE_DIR"
_MAX_BYTES_ENV = "REPRO_COMPILE_CACHE_MAX_BYTES"
#: the records' suffix: the port's own (the reference spills ``.aotx``)
RECORD_SUFFIX = ".graph.json"


def default_cache_dir() -> str:
    """The port's record directory: ``$REPRO_COMPILE_CACHE_DIR/repro_torch``
    where that variable is set (a folder of its own inside the reference's
    directory), else ``~/.cache/repro-torch-graphs``."""
    base = os.environ.get(_DEFAULT_DIR_ENV)
    if base:
        return os.path.join(base, "repro_torch")
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro-torch-graphs")


_VERSION_TAG: Optional[str] = None


def _version_tag() -> str:
    """Short digest of what a record's keys depend on beyond the program:
    torch's version, its CUDA version, the card's name and the port's
    source salt. A record stamped with another tag can never hit (the
    fingerprint folds the same in), so pruning deletes it on sight."""
    global _VERSION_TAG
    if _VERSION_TAG is None:
        card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "cpu")
        _VERSION_TAG = hashlib.sha256(
            f"torch:{torch.__version__} cuda:{torch.version.cuda} "
            f"card:{card} src:{_source_tree_salt()}".encode()).hexdigest()[:8]
    return _VERSION_TAG


# ----------------------------------------------------------------------
# Content fingerprinting
# ----------------------------------------------------------------------

def _is_array(v: Any) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray, np.generic))


def _obj_sig(v: Any, depth: int = 2) -> str:
    """A stable signature for a closure cell / referenced global.

    Bounded: tensors and arrays collapse to shape/dtype + a sampled value
    digest, callables to a code hash plus (``depth`` levels of) their own
    closure and default signatures — enough to distinguish ``f`` calling
    ``g1`` from ``f`` calling ``g2`` even when g1/g2 come from one factory
    over different data. Memory addresses are stripped before hashing, so
    signatures are stable across processes.
    """
    if isinstance(v, (int, float, bool, str, bytes, type(None))):
        return repr(v)
    if inspect.ismodule(v):
        return f"mod:{v.__name__}"
    if _is_array(v):
        lay = spec_of(v)
        return (f"arr{tuple(v.shape)}:{v.dtype}:{_array_digest(v)}"
                + (f":{lay.layout!r}" if lay is not None else ""))
    if isinstance(v, (TensorSpec, ShardedSpec)):
        return f"spec{tuple(v.shape)}:{v.dtype}"
    # containers: recurse over EVERY element so interior tensors get VALUE
    # digests (repr of a dict of weights truncates and would alias
    # different values); the signature string is hashed if it grows long,
    # so the key stays bounded while the content walk is complete
    if isinstance(v, (list, tuple)):
        sig = ";".join(_obj_sig(x, depth) for x in v)
        return f"{type(v).__name__}[{len(v)}]:({_squash(sig)})"
    if isinstance(v, dict):
        try:
            keys = sorted(v, key=repr)
        except TypeError:
            keys = list(v)
        sig = ";".join(f"{k!r}={_obj_sig(v[k], depth)}" for k in keys)
        return f"dict[{len(v)}]:({_squash(sig)})"
    if callable(v):
        code = getattr(v, "__code__", None)
        if code is not None and depth > 0:
            consts = tuple(c for c in code.co_consts
                           if isinstance(c, (int, float, bool, str, bytes,
                                             type(None))))
            ctx = []
            for cell in getattr(v, "__closure__", None) or ():
                try:
                    ctx.append(_obj_sig(cell.cell_contents, depth - 1))
                except ValueError:
                    ctx.append("<empty>")
            for d in getattr(v, "__defaults__", None) or ():
                ctx.append(_obj_sig(d, depth - 1))
            return ("fn:" + hashlib.sha256(code.co_code).hexdigest()[:16]
                    + f":{consts!r}:{';'.join(ctx)}")
        return "call:" + getattr(v, "__qualname__", type(v).__name__)
    r = re.sub(r" at 0x[0-9a-fA-F]+", "", repr(v))
    if len(r) > 256:
        return "obj:" + hashlib.sha256(r.encode()).hexdigest()[:16]
    return r


def _squash(sig: str, limit: int = 512) -> str:
    return (sig if len(sig) <= limit
            else hashlib.sha256(sig.encode()).hexdigest()[:16])


def _array_digest(v: Any) -> str:
    """Digest of a tensor's or array's VALUES, not just shape/dtype: a
    captured graph reads closed-over tensors as they are, and two closures
    over same-shaped but different-valued tensors compute different
    functions. Large ones are sampled (head + stride + tail) to bound the
    cost; a tensor on the card is sampled there and only the sample copied
    back (outside any capture: fingerprints are taken in ``compile``). A
    DTensor's digest is its shard's: no collective runs for a key."""
    try:
        if isinstance(v, torch.Tensor):
            flat = local_tensor(v).detach().reshape(-1)
            if flat.numel() > 65536:
                step = max(1, flat.numel() // 16384)
                flat = torch.cat([flat[:16384], flat[::step][:16384],
                                  flat[-16384:]])
            data = flat.contiguous().view(torch.uint8).cpu().numpy()
        else:
            flat = np.asarray(v).reshape(-1)
            if flat.size > 65536:
                step = max(1, flat.size // 16384)
                flat = np.concatenate([flat[:16384], flat[::step][:16384],
                                       flat[-16384:]])
            data = np.ascontiguousarray(flat)
        return hashlib.sha256(data.tobytes()).hexdigest()[:16]
    except Exception:
        return "opaque"


_SOURCES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _source_text(fn: Callable) -> str:
    """``fn``'s source text (or bytecode), read once per code object: the
    text of a code object never changes, and reading it (a tokenize of
    the file) was most of a warm dispatch's host work (0.31 → 0.12 ms a
    CPU dispatch of a 4-instance wave), which every node of the
    distributed fabric pays per shard."""
    code = getattr(fn, "__code__", None)
    src = _SOURCES.get(code) if code is not None else None
    if src is None:
        try:
            src = inspect.getsource(fn)
        except (OSError, TypeError):
            src = code.co_code.hex() if code is not None else repr(
                getattr(fn, "__qualname__", type(fn).__name__))
        if code is not None:
            _SOURCES[code] = src
    return src


def _source_hash(fn: Callable) -> str:
    """Hash of what the function *is*: source text (or bytecode), closure
    cells, defaults, and one level of referenced globals.

    Deliberately NOT memoized on the function object: closure cells and
    module globals are rebindable and closed-over tensors are mutable in
    place, so a frozen digest could serve a stale executable — the exact
    failure class the content fingerprint exists to eliminate. Only the
    source text is kept, per code object (``_source_text``)."""
    src = _source_text(fn)
    parts = [getattr(fn, "__module__", ""), getattr(fn, "__qualname__", ""),
             src]
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            parts.append(_obj_sig(cell.cell_contents))
        except ValueError:          # empty cell
            parts.append("<empty>")
    for d in getattr(fn, "__defaults__", None) or ():
        parts.append("default:" + _obj_sig(d))
    for k, d in (getattr(fn, "__kwdefaults__", None) or {}).items():
        parts.append(f"kwdefault:{k}=" + _obj_sig(d))
    code = getattr(fn, "__code__", None)
    if code is not None:
        g = getattr(fn, "__globals__", {})
        for name in sorted(code.co_names):
            if name in g:
                parts.append(f"{name}={_obj_sig(g[name])}")
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()


_TREE_SALT: Optional[str] = None


def _source_tree_salt() -> str:
    """Digest of the ``repro_torch`` package's source files (path, mtime,
    size), computed once per process and folded into every fingerprint:
    the static context walk cannot see an edit deeper in the call graph
    (fn -> g -> h), so any change to the package's sources makes a new key
    (a conservative miss, never a wrong hit). Callees outside the package
    remain the caller's responsibility (pass a version via ``extras``)."""
    global _TREE_SALT
    if _TREE_SALT is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha256()
        for dirpath, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                if f.endswith(".py"):
                    p = os.path.join(dirpath, f)
                    try:
                        st = os.stat(p)
                    except OSError:
                        continue
                    h.update(f"{os.path.relpath(p, root)}:"
                             f"{st.st_mtime_ns}:{st.st_size}".encode())
        _TREE_SALT = h.hexdigest()[:16]
    return _TREE_SALT


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def abstractify(tree: Any) -> Any:
    """Concrete tree -> TensorSpec tree (identity on specs; numpy arrays
    take torch's dtype; a DTensor becomes its ``ShardedSpec``, which keeps
    its layout; other leaves stay as they are)."""
    def leaf(x):
        lay = spec_of(x)
        if lay is not None:
            return lay
        if isinstance(x, TensorSpec):
            return TensorSpec(tuple(x.shape), _torch_dtype(x.dtype))
        if _is_array(x):
            return TensorSpec(tuple(x.shape), _torch_dtype(x.dtype))
        return x
    return pytree.tree_map(leaf, tree)


def _device_sig(device: torch.device) -> str:
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        name = f"{torch.cuda.get_device_name(index)} #{index}"
    else:
        name = device.type
    return f"torch {torch.__version__} cuda {torch.version.cuda} {name}"


def _infer_device(tree: Any) -> torch.device:
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def fingerprint(fn: Callable, abstract_args: tuple, extras: tuple = (),
                device=None) -> str:
    """Content key for one (program, input signature, device) triple."""
    leaves, spec = pytree.tree_flatten(abstractify(tuple(abstract_args)))
    avals = "|".join(
        f"{tuple(l.shape)}:{l.dtype}:{l.layout!r}" if isinstance(
            l, ShardedSpec) else f"{tuple(l.shape)}:{l.dtype}" if isinstance(
            l, TensorSpec) else f"const:{l!r}" for l in leaves)
    dev = (torch.device(device) if device is not None
           else _infer_device(abstract_args))
    blob = "\n".join([
        _source_hash(fn), str(spec), avals, str(tuple(extras)),
        _device_sig(dev), _source_tree_salt(),
    ])
    return hashlib.sha256(blob.encode()).hexdigest()


def _jsonable(x: Any) -> Any:
    """``x`` as JSON reads it back (tuples become lists; what JSON cannot
    hold becomes its ``repr``)."""
    return json.loads(json.dumps(x, default=repr))


def _leaf_record(x) -> Any:
    if isinstance(x, ShardedSpec):
        return [list(x.shape), str(x.dtype).replace("torch.", ""),
                x.record()]
    if isinstance(x, TensorSpec):
        return [list(x.shape), str(x.dtype).replace("torch.", "")]
    return {"const": _jsonable(x)}


def _leaf_from_record(x) -> Any:
    if not isinstance(x, list):
        return x["const"]
    if len(x) == 3:
        return ShardedSpec.from_record(x[0], getattr(torch, x[1]), x[2])
    return TensorSpec(tuple(x[0]), getattr(torch, x[1]))


def signature_record(args: tuple) -> list:
    """The input signature of ``args`` for a record: per argument, its tree
    (``treespec_dumps``) and its leaves, ``[shape, dtype]`` for a tensor,
    an array or a ``TensorSpec``, ``[shape, dtype, layout]`` for a DTensor
    or a ``ShardedSpec`` (the layout: the mesh's sizes and axis names, the
    placements, the local shape), ``{"const": value}`` otherwise."""
    out = []
    for a in args:
        leaves, spec = pytree.tree_flatten(abstractify(a))
        out.append({"tree": pytree.treespec_dumps(spec),
                    "leaves": [_leaf_record(x) for x in leaves]})
    return out


def record_args(record: dict) -> tuple:
    """The abstract arguments (``TensorSpec`` and ``ShardedSpec`` trees) a
    record was made for: what ``compile`` takes as ``example_args`` to
    rebuild its executable."""
    args = []
    for a in record["signature"]:
        leaves = [_leaf_from_record(x) for x in a["leaves"]]
        args.append(pytree.tree_unflatten(leaves,
                                          pytree.treespec_loads(a["tree"])))
    return tuple(args)


# ----------------------------------------------------------------------
# Executables
# ----------------------------------------------------------------------

def _aval(x) -> tuple:
    """One leaf of a signature: (shape, dtype) of a tensor, an array or a
    ``TensorSpec``; (shape, dtype, layout) of a DTensor or a
    ``ShardedSpec``; ("const", value) otherwise."""
    if not (_is_array(x) or isinstance(x, (TensorSpec, ShardedSpec))):
        return ("const", x)
    lay = spec_of(x)
    if lay is not None:
        return (tuple(x.shape), _torch_dtype(x.dtype), lay.layout)
    return (tuple(x.shape), _torch_dtype(x.dtype))


def _signature(args: tuple, flat: Optional[list] = None) -> tuple:
    """(per-argument tree specs, abstract leaves) of a call's arguments
    (``flat``: their ``tree_flatten``s, when the caller has them). A
    DTensor's leaf carries its layout: the same global shape laid out
    otherwise is another signature."""
    if flat is None:
        flat = [pytree.tree_flatten(a) for a in args]
    specs = tuple(s for _, s in flat)
    avals = tuple(_aval(x) for leaves, _ in flat for x in leaves)
    return specs, avals


def _counts() -> List[tuple]:
    return [(fn.launches, dict(getattr(fn, "routes", {}))) for fn in COUNTED]


def _count_delta(before: List[tuple], after: List[tuple]) -> List[tuple]:
    return [(a[0] - b[0], {k: a[1].get(k, 0) - b[1].get(k, 0)
                           for k in a[1]})
            for b, a in zip(before, after)]


def _apply_counts(delta: List[tuple], sign: int = 1) -> None:
    for fn, (n, routes) in zip(COUNTED, delta):
        fn.launches += sign * n
        rt = getattr(fn, "routes", None)
        if rt is not None:
            for k, m in routes.items():
                rt[k] = rt.get(k, 0) + sign * m


class Executable:
    """The CPU executable: the function itself behind the compiled
    signature. A call whose inputs do not match it raises ``TypeError``,
    as the reference's exact-signature AOT executable does.

    ``sharded``: the signature holds a DTensor (a step of a mesh of ranks).
    ``collectives`` counts what the calls of a sharded executable issued,
    by kind (count and operand bytes a rank)."""

    def __init__(self, fn: Callable, signature: tuple):
        self.fn = fn
        self.signature = signature
        self.calls = 0
        self.sharded = any(len(a) == 3 for a in signature[1])
        self.collectives = CollectiveStats()

    def _check(self, args: tuple, flat: Optional[list] = None) -> None:
        if _signature(args, flat) != self.signature:
            raise TypeError(f"{getattr(self.fn, '__qualname__', self.fn)}: "
                            "inputs do not match the compiled signature")

    def _counter(self):
        return CollectiveCounter() if self.sharded else nullcontext()

    #: how the latest call ran: ``"eager"`` here; a graph executable's
    #: ``"capture"`` or ``"replay"`` (``exe.call``'s attribute)
    source = "eager"

    @spans.traced("exe.call", lambda self, _: {"source": self.source})
    def __call__(self, *args):
        self._check(args)
        self.calls += 1
        with self._counter() as cc:
            out = self.fn(*args)
        if cc is not None:
            self.collectives.merge(cc.stats)
        return out


def _view_key(x: torch.Tensor) -> tuple:
    """Where a tensor's elements lie (a DTensor's: its shard's, and its
    layout)."""
    lt = local_tensor(x)
    return (lt.data_ptr(), tuple(lt.shape), lt.stride(), lt.dtype,
            spec_of(x))


class _Graph:
    """One captured graph: its static input buffers (None where a leaf is
    bound or not a tensor; a DTensor's: its shard), its outputs, the
    counter changes a replay adds (the kernels' launches; a sharded
    graph's collectives, ``collectives``), and the ``_Binding`` it
    captured over (None: it binds nothing).

    An output that IS one of the bound tensors (a train step returns its
    state) is not kept: holding it would keep the binding alive as long
    as the graph, and the graph as long as its executable. A replay
    returns the call's own bound tensor in its place (``outputs``)."""

    def __init__(self, graph, static_leaves, out, counts, bound=None,
                 bound_leaves=(), collectives=None):
        self.graph = graph
        self.static_leaves = static_leaves
        self.counts = counts
        self.collectives = collectives
        self.bound = bound
        self.replays = 0
        where = {_view_key(x): k for k, x in enumerate(bound_leaves)
                 if isinstance(x, torch.Tensor)}
        leaves, self.out_spec = pytree.tree_flatten(out)
        self.alias = [where.get(_view_key(x))
                      if isinstance(x, torch.Tensor) else None
                      for x in leaves]
        self.aliased = any(a is not None for a in self.alias)
        self.out = None if self.aliased else out
        self.out_leaves = [None if a is not None else x
                           for x, a in zip(leaves, self.alias)]

    def outputs(self, bound_leaves: list):
        """The outputs of a replay whose bound tensors are
        ``bound_leaves``."""
        if not self.aliased:
            return self.out
        return pytree.tree_unflatten(
            [bound_leaves[a] if a is not None else x
             for x, a in zip(self.out_leaves, self.alias)], self.out_spec)


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
_CAPTURE_LOCK = threading.RLock()
_capturing = 0                  # captures running (under _CAPTURE_LOCK)
_GRAVE: List[_Graph] = []       # graphs released, not yet destroyed
_GRAVE_LOCK = threading.Lock()


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream warm-ups and captures run on (one per device, so
    the library workspaces a stream needs are set up once)."""
    s = _CAPTURE_STREAMS.get(device)
    if s is None:
        s = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return s


class _Binding:
    """The tensors a set of graphs read and write at their own addresses
    (an engine's weights and caches), keyed ``(device, data pointers)`` in
    a cache's ``pools``, and the memory pool those graphs share. Each bound
    storage is watched: when any is freed, ``_release`` unlinks every
    graph captured over the binding."""

    def __init__(self, key: tuple, storages, pools: dict):
        self.key = key
        self.pools = pools
        self.pool = None                    # a graph pool, on first capture
        self.holders = weakref.WeakSet()    # executables with a graph here
        self._watch = [weakref.finalize(s, _release, self) for s in storages]
        for f in self._watch:
            f.atexit = False                # nothing to free at exit

    def unlink(self) -> List[_Graph]:
        """Take the binding out of its cache and its graphs out of their
        executables (idempotent) -> the graphs taken."""
        for f in self._watch:
            f.detach()
        if self.pools.get(self.key) is self:
            del self.pools[self.key]
        ptrs, graphs = self.key[1], []
        for exe in list(self.holders):
            g = exe.graphs.get(ptrs)
            if g is not None and g.bound is self:
                graphs.append(exe.graphs.pop(ptrs))
        self.holders.clear()
        return graphs


def _release(bound: _Binding) -> None:
    """A bound storage was freed: no call may find the binding's graphs
    again (unlinked now, in whatever thread freed it); they are destroyed
    once no capture is running."""
    graphs = bound.unlink()
    with _GRAVE_LOCK:
        _GRAVE.extend(graphs)
    _bury()


def _bury() -> None:
    """Destroy the released graphs and hand the card's cached blocks back,
    unless a capture is running (another thread's, or this thread's: a
    finalizer can fire inside one); the capture's end buries them."""
    if not _GRAVE or not _CAPTURE_LOCK.acquire(blocking=False):
        return
    try:
        if _capturing:
            return
        with _GRAVE_LOCK:
            dead = list(_GRAVE)
            _GRAVE.clear()
        if dead and torch.cuda.is_initialized():
            # no replay of them in flight: their own cards alone, so no
            # other card's work stalls for a drop
            for dev in {g.bound.key[0] for g in dead}:
                torch.cuda.synchronize(dev)
        dead.clear()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
    finally:
        _CAPTURE_LOCK.release()


class GraphExecutable(Executable):
    """A function captured as CUDA graphs, one per binding (see the module
    docstring). ``stream`` is the side stream its warm-ups and captures
    run on (default: the device's shared capture stream); ``pools`` maps a
    (device, binding) to its ``_Binding`` (the cache's, shared by every
    executable of the cache; default a map of its own)."""

    def __init__(self, fn: Callable, signature: tuple,
                 bind_argnums: Sequence[int] = (), device=None,
                 stream: Optional["torch.cuda.Stream"] = None,
                 stats: Optional[dict] = None,
                 pools: Optional[dict] = None):
        super().__init__(fn, signature)
        self.bind_argnums = tuple(bind_argnums)
        self.device = torch.device(device)
        self.stream = stream
        self.stats = stats if stats is not None else {}
        self.pools = pools if pools is not None else {}
        self.graphs: Dict[tuple, _Graph] = {}

    def _bound(self, binding: tuple, per_arg: list) -> Optional[_Binding]:
        """The ``_Binding`` a graph of ``binding`` captures over: the one
        its bound tensors' other graphs share (made, and its storages
        watched, on the first), or None when nothing is bound (a pool of
        its own)."""
        if not binding:
            return None
        key = (self.device, binding)
        b = self.pools.get(key)
        if b is None:
            storages = {}
            for i in self.bind_argnums:
                for x in per_arg[i][0]:
                    if isinstance(x, torch.Tensor):
                        s = local_tensor(x).untyped_storage()
                        storages[id(s)] = s
            b = self.pools[key] = _Binding(key, storages.values(),
                                           self.pools)
        b.holders.add(self)
        return b

    @spans.traced("exe.call", lambda self, _: {"source": self.source})
    def __call__(self, *args):
        per_arg = [pytree.tree_flatten(a) for a in args]
        self._check(args, per_arg)
        self.calls += 1
        binding = tuple(local_tensor(x).data_ptr() for i in self.bind_argnums
                        for x in per_arg[i][0] if isinstance(x, torch.Tensor))
        g = self.graphs.get(binding)
        if g is None:
            self.source = "capture"
            return self._capture(args, per_arg, binding)
        self.source = "replay"
        leaves = (x for xs, _ in per_arg for x in xs)
        for x, s in zip(leaves, g.static_leaves):
            if s is not None:
                x = (local_tensor(x) if isinstance(x, torch.Tensor)
                     else torch.as_tensor(x))
                if x is not s:
                    s.copy_(x, non_blocking=True)
        if TRACER.enabled:
            rp = spans.begin("exe.replay")
            g.graph.replay()
            spans.end(rp)
        else:
            g.graph.replay()
        g.replays += 1
        self.stats["replays"] = self.stats.get("replays", 0) + 1
        _apply_counts(g.counts)
        if g.collectives is not None:
            self.collectives.merge(g.collectives)
            count_replayed(g.collectives)
        if not g.aliased:
            return g.out
        return g.outputs([x for i in self.bind_argnums
                          for x in per_arg[i][0]])

    def _buffer(self, x):
        """A static input buffer on the card holding ``x`` (a DTensor's
        shard; None for a leaf that is not a tensor or an array)."""
        if isinstance(x, torch.Tensor):
            x = local_tensor(x)
            return torch.empty_like(x, device=self.device).copy_(x)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(self.device)
        return None

    @spans.traced("exe.capture")
    def _capture(self, args, per_arg, binding):
        global _capturing
        with _CAPTURE_LOCK:
            _bury()                 # released graphs' memory, before ours
            _capturing += 1
            try:
                out = self._capture_locked(args, per_arg, binding)
            finally:
                _capturing -= 1
        _bury()
        return out

    def _capture_locked(self, args, per_arg, binding):
        t0 = time.perf_counter()
        static_leaves, static_args = [], []
        for i, (a, (leaves, spec)) in enumerate(zip(args, per_arg)):
            if i in self.bind_argnums:          # read at its own addresses
                static_leaves += [None] * len(leaves)
                static_args.append(a)
                continue
            own = [self._buffer(x) for x in leaves]
            static_leaves += own
            static_args.append(pytree.tree_unflatten(
                [x if o is None else rewrap(x, o) if spec_of(x) else o
                 for o, x in zip(own, leaves)], spec))
        cur = torch.cuda.current_stream(self.device)
        side = self.stream or capture_stream(self.device)
        side.wait_stream(cur)
        # the warm-up: the call's real execution, outside the capture, so
        # every lazy set-up (kernel libraries, route plans, shared-memory
        # opt-ins, library workspaces, a mesh's NCCL communicators) is
        # done before capture begins
        with torch.cuda.stream(side), self._counter() as cc:
            out = settle(self.fn(*static_args))
        if cc is not None:
            self.collectives.merge(cc.stats)
        cur.wait_stream(side)
        for x in pytree.tree_leaves(out):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                local_tensor(x).record_stream(cur)
        # the graph allocates from a graph pool, which cannot reuse the
        # blocks the warm-up left cached: release them first (a train
        # step's activations would otherwise be held twice)
        torch.cuda.empty_cache()
        bound = self._bound(binding, per_arg)
        if bound is not None and bound.pool is None:
            bound.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        # no graph may be destroyed in the capturing thread (a destroy there
        # invalidates the capture): the cyclic collector, which frees a
        # dropped fabric's or engine's graphs in whatever thread it runs,
        # waits until the capture ends
        collect = gc.isenabled()
        gc.disable()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=bound.pool if bound else None,
                                capture_error_mode="thread_local")
            try:
                # a sharded step's collectives are recorded as they are
                # captured, and each is waited inside the capture
                with self._counter() as cc:
                    g_out = settle(self.fn(*static_args))
                graph.capture_end()
            except BaseException as err:
                try:
                    graph.capture_end()
                except Exception:
                    pass
                raise RuntimeError(
                    f"CUDA graph capture of "
                    f"{getattr(self.fn, '__qualname__', self.fn)} failed "
                    f"(no eager fallback): {err}") from err
            finally:
                if collect:
                    gc.enable()
        delta = _count_delta(before, _counts())
        _apply_counts(delta, sign=-1)       # the capture launched nothing
        if cc is not None:
            count_replayed(cc.stats, sign=-1)   # nor moved a byte
        cur.wait_stream(side)
        self.graphs[binding] = _Graph(
            graph, static_leaves, g_out, delta, bound,
            [x for i in self.bind_argnums for x in per_arg[i][0]],
            cc.stats if cc is not None else None)
        self.stats["captures"] = self.stats.get("captures", 0) + 1
        self.stats["t_capture_s"] = (self.stats.get("t_capture_s", 0.0)
                                     + time.perf_counter() - t0)
        return out

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.graphs.values())


def make_executable(fn: Callable, example_args: tuple, *, device=None,
                    bind_argnums: Sequence[int] = (),
                    stream: Optional["torch.cuda.Stream"] = None,
                    stats: Optional[dict] = None,
                    pools: Optional[dict] = None) -> Executable:
    """A fresh executable of ``fn`` for the signature of ``example_args``:
    a graph executable on the card (the default), the function itself on
    the CPU. ``pools`` is the cache's map of bindings and their shared
    graph pools (None: outside any cache, a map of the executable's own)."""
    dev = resolve_device(device)
    sig = _signature(tuple(example_args))
    if dev.type == "cuda":
        return GraphExecutable(fn, sig, bind_argnums, dev, stream=stream,
                               stats=stats, pools=pools)
    return Executable(fn, sig)


class LazyGraph:
    """A function with one executable per input signature, made on first
    use (the port's lazy ``jax.jit``): an input the compiled specs did not
    foresee gets its own capture, still on the card."""

    def __init__(self, fn: Callable, device, bind_argnums=(),
                 stats: Optional[dict] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.bind_argnums = tuple(bind_argnums)
        self.stats = stats
        self._by_sig: Dict[tuple, Executable] = {}

    def __call__(self, *args):
        sig = _signature(args)
        exe = self._by_sig.get(sig)
        if exe is None:
            exe = self._by_sig[sig] = make_executable(
                self.fn, args, device=self.device,
                bind_argnums=self.bind_argnums, stats=self.stats)
        return exe(*args)


# ----------------------------------------------------------------------
# The cache
# ----------------------------------------------------------------------

class CompileCache:
    """Two tiers (memory, disk) of executables keyed by content
    fingerprint (see the module docstring). ``cache_dir`` holds the disk
    tier's records (default ``default_cache_dir()``); ``persistent=False``
    keeps the memory tier alone; ``max_bytes`` (default
    ``REPRO_COMPILE_CACHE_MAX_BYTES``; None = unbounded) caps the records'
    bytes, least recently used first. ``stats`` counts hits, misses and the
    disk tier's work, and, for the graphs of its executables, captures and
    replays; ``pools`` holds the ``_Binding`` each set of bound tensors'
    graphs share (its memory pool), while those tensors live."""

    def __init__(self, cache_dir: Optional[str] = None,
                 persistent: bool = True,
                 max_bytes: Optional[int] = None):
        self.cache_dir = (cache_dir if cache_dir is not None
                          else default_cache_dir())
        self.persistent = persistent
        if max_bytes is None:
            env = os.environ.get(_MAX_BYTES_ENV)
            max_bytes = int(env) if env else None
        self.max_bytes = max_bytes
        self._mem: dict = {}
        self._lock = threading.Lock()
        self._version_pruned = False
        self.pools: dict = {}
        self.stats = {"mem_hits": 0, "disk_hits": 0, "misses": 0,
                      "spills": 0, "spill_errors": 0, "evictions": 0,
                      "version_drops": 0, "captures": 0, "replays": 0,
                      "t_capture_s": 0.0}

    # -- the disk tier ------------------------------------------------------
    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir,
                            f"{key}.{_version_tag()}{RECORD_SUFFIX}")

    def _prune_stale_versions(self) -> None:
        """Drop records stamped with another version (once a cache): they
        can never hit. Only the port's suffix is listed."""
        if self._version_pruned:
            return
        self._version_pruned = True
        mine = f".{_version_tag()}{RECORD_SUFFIX}"
        try:
            for name in os.listdir(self.cache_dir):
                if name.endswith(RECORD_SUFFIX) and not name.endswith(mine):
                    os.remove(os.path.join(self.cache_dir, name))
                    self.stats["version_drops"] += 1
        except OSError:
            pass

    def _prune_lru(self) -> None:
        """LRU by bytes: evict the least recently USED records (a disk hit
        refreshes a record's mtime) until the directory fits
        ``max_bytes``."""
        if self.max_bytes is None:
            return
        try:
            entries = []
            for name in os.listdir(self.cache_dir):
                if not name.endswith(RECORD_SUFFIX):
                    continue
                p = os.path.join(self.cache_dir, name)
                st = os.stat(p)
                entries.append((st.st_mtime_ns, st.st_size, p))
            total = sum(sz for _, sz, _ in entries)
            for _, sz, p in sorted(entries):
                if total <= self.max_bytes:
                    break
                os.remove(p)
                total -= sz
                self.stats["evictions"] += 1
        except OSError:
            pass

    def _disk_get(self, key: str) -> Optional[dict]:
        """The record of ``key``, its recency refreshed, or None (none, or
        one that cannot be read: a miss)."""
        if not self.persistent:
            return None
        try:
            self._prune_stale_versions()
            path = self._path(key)
            with open(path) as f:
                record = json.load(f)
            if record.get("key") != key:
                return None
            try:
                os.utime(path)               # refresh LRU recency
            except OSError:
                pass                         # read-only dir: still a hit
            return record
        except Exception:
            return None

    def _disk_put(self, key: str, name: str, example_args: tuple,
                  extras: tuple, bind_argnums: tuple,
                  device: torch.device) -> None:
        if not self.persistent:
            return
        try:
            record = {
                "version": _version_tag(), "key": key, "name": name,
                "extras": _jsonable(list(extras)),
                "bind_argnums": list(bind_argnums),
                "device": _device_sig(device),
                "signature": signature_record(tuple(example_args))}
            os.makedirs(self.cache_dir, exist_ok=True)
            self._prune_stale_versions()
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(record, f)
            os.replace(tmp, self._path(key))     # atomic publish
            self.stats["spills"] += 1
            self._prune_lru()
        except Exception:
            self.stats["spill_errors"] += 1

    def records(self, prefix: tuple = (), device=None) -> List[dict]:
        """The readable records of this version whose ``extras`` start with
        ``prefix`` (and, with ``device``, made for that device) and whose
        key this cache's memory tier does not hold — what ``compile``
        would serve from disk — in the order of their files: the shapes
        earlier processes of one configuration met (``record_args`` reads
        a record's shapes back)."""
        if not self.persistent:
            return []
        want = _jsonable(list(prefix))
        dev = _device_sig(resolve_device(device)) if device else None
        mine = f".{_version_tag()}{RECORD_SUFFIX}"
        out = []
        try:
            names = sorted(os.listdir(self.cache_dir))
        except OSError:
            return []
        for fname in names:
            if not fname.endswith(mine):
                continue
            try:
                with open(os.path.join(self.cache_dir, fname)) as f:
                    rec = json.load(f)
            except Exception:
                continue
            if (rec.get("extras", [])[:len(want)] == want
                    and (dev is None or rec.get("device") == dev)
                    and rec.get("key") not in self._mem):
                out.append(rec)
        return out

    # -- public API ---------------------------------------------------------
    def get(self, key: str):
        """-> (executable, "memory") from the memory tier, or (None, None)
        (``compile`` consults the disk tier)."""
        with self._lock:
            if key in self._mem:
                self.stats["mem_hits"] += 1
                return self._mem[key], "memory"
        return None, None

    def put(self, key: str, executable) -> None:
        with self._lock:
            self._mem[key] = executable

    def compile(self, fn: Callable, example_args: tuple, *,
                key_fn: Optional[Callable] = None, device=None,
                bind_argnums: Sequence[int] = (),
                stream: Optional["torch.cuda.Stream"] = None,
                extras: tuple = ()):
        """The executable of ``fn`` for the signature of ``example_args``
        (tensors, arrays or ``TensorSpec`` stand-ins) on ``device``: the
        card unless ``"cpu"`` is passed; without a card it raises.

        ``key_fn`` fingerprints the entry when ``fn`` is a transform wrapper
        (e.g. a vmap of the user function) whose own source is not
        distinguishing; its qualified name names the record. ->
        (executable, source), source in
        {"memory", "disk", "compiled"}: "disk" when this cache had no
        executable for the key but the directory had its record (an
        earlier process, or cache, made it)."""
        dev = resolve_device(device)
        extras = tuple(extras) + (tuple(bind_argnums),)
        keyed = key_fn if key_fn is not None else fn
        key = fingerprint(keyed, tuple(example_args), device=dev,
                          extras=extras)
        exe, source = self.get(key)
        if exe is not None:
            return exe, source
        exe = make_executable(fn, tuple(example_args), device=dev,
                              bind_argnums=bind_argnums, stream=stream,
                              stats=self.stats, pools=self.pools)
        if self._disk_get(key) is not None:
            source = "disk"
            self.stats["disk_hits"] += 1
        else:
            source = "compiled"
            self.stats["misses"] += 1
            self._disk_put(key, getattr(keyed, "__qualname__", repr(keyed)),
                           example_args, extras, bind_argnums, dev)
        self.put(key, exe)
        return exe, source


_default_cache: Optional[CompileCache] = None
_default_lock = threading.Lock()


def default_cache() -> CompileCache:
    """Process-wide shared cache (launcher + serve use the same one)."""
    global _default_cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = CompileCache()
        return _default_cache
