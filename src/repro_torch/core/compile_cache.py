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
    the backend — torch's version, its CUDA version and the device's type
    and name. Never ``id(fn)``, which CPython reuses after garbage
    collection;
  * one memory tier. There is no disk tier: a CUDA graph holds raw device
    addresses and cannot be serialized. What the port does keep across
    processes is the nvcc-built kernel library (``kernels._build``).

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

The kernels' launch counters (``paged_attention.launches`` / ``.routes``,
``ssd_scan``'s, ``flash_attention.launches``) count in Python, so a replay
would add nothing: the executable takes each counter's change during the
capture back out (the capture launched nothing) and adds it on every
replay.

Captures are serialized process-wide (``_CAPTURE_LOCK``): a warm-up and
its capture run on the device's one shared capture stream, and the
counter change a capture takes back out is read from process-global
counters. Thread nodes of the distributed fabric (``repro_torch.dist``),
each with a cache of its own, so capture one at a time while the others
replay; a replay that adds its counts during another thread's capture
is folded into that capture's change (the launch path's applications
launch none of the counted kernels).

On the CPU the executable is the function itself behind the same
signature check and bookkeeping, so the cache's tests run without a card.
"""
from __future__ import annotations

import hashlib
import inspect
import os
import re
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import resolve_device
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.spec import TensorSpec

# the wrappers whose launch counters a replay must keep true
COUNTED = (paged_attention, ssd_scan, flash_attention)


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
        return f"arr{tuple(v.shape)}:{v.dtype}:{_array_digest(v)}"
    if isinstance(v, TensorSpec):
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
    back (outside any capture: fingerprints are taken in ``compile``)."""
    try:
        if isinstance(v, torch.Tensor):
            flat = v.detach().reshape(-1)
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
    take torch's dtype; other leaves stay as they are)."""
    def leaf(x):
        if isinstance(x, TensorSpec):
            return TensorSpec(tuple(x.shape), _torch_dtype(x.dtype))
        if _is_array(x):
            return TensorSpec(tuple(x.shape), _torch_dtype(x.dtype))
        return x
    return pytree.tree_map(leaf, tree)


def _device_sig(device: torch.device) -> str:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
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
    avals = "|".join(f"{tuple(l.shape)}:{l.dtype}" if isinstance(
        l, TensorSpec) else f"const:{l!r}" for l in leaves)
    dev = (torch.device(device) if device is not None
           else _infer_device(abstract_args))
    blob = "\n".join([
        _source_hash(fn), str(spec), avals, str(tuple(extras)),
        _device_sig(dev), _source_tree_salt(),
    ])
    return hashlib.sha256(blob.encode()).hexdigest()


# ----------------------------------------------------------------------
# Executables
# ----------------------------------------------------------------------

def _signature(args: tuple, flat: Optional[list] = None) -> tuple:
    """(per-argument tree specs, abstract leaves) of a call's arguments
    (``flat``: their ``tree_flatten``s, when the caller has them)."""
    if flat is None:
        flat = [pytree.tree_flatten(a) for a in args]
    specs = tuple(s for _, s in flat)
    avals = tuple(
        (tuple(x.shape), _torch_dtype(x.dtype)) if (
            _is_array(x) or isinstance(x, TensorSpec)) else ("const", x)
        for leaves, _ in flat for x in leaves)
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
    as the reference's exact-signature AOT executable does."""

    def __init__(self, fn: Callable, signature: tuple):
        self.fn = fn
        self.signature = signature
        self.calls = 0

    def _check(self, args: tuple, flat: Optional[list] = None) -> None:
        if _signature(args, flat) != self.signature:
            raise TypeError(f"{getattr(self.fn, '__qualname__', self.fn)}: "
                            "inputs do not match the compiled signature")

    def __call__(self, *args):
        self._check(args)
        self.calls += 1
        return self.fn(*args)


class _Graph:
    """One captured graph: its static input buffers (None where a leaf is
    bound or not a tensor), its outputs, and the counter changes a replay
    adds."""

    def __init__(self, graph, static_leaves, out, counts):
        self.graph = graph
        self.static_leaves = static_leaves
        self.out = out
        self.counts = counts
        self.replays = 0


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
_CAPTURE_LOCK = threading.RLock()


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream warm-ups and captures run on (one per device, so
    the library workspaces a stream needs are set up once)."""
    s = _CAPTURE_STREAMS.get(device)
    if s is None:
        s = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return s


class GraphExecutable(Executable):
    """A function captured as CUDA graphs, one per binding (see the module
    docstring). ``stream`` is the side stream its warm-ups and captures
    run on (default: the device's shared capture stream)."""

    def __init__(self, fn: Callable, signature: tuple,
                 bind_argnums: Sequence[int] = (), device=None,
                 stream: Optional["torch.cuda.Stream"] = None,
                 stats: Optional[dict] = None):
        super().__init__(fn, signature)
        self.bind_argnums = tuple(bind_argnums)
        self.device = torch.device(device)
        self.stream = stream
        self.stats = stats if stats is not None else {}
        self.graphs: Dict[tuple, _Graph] = {}

    def __call__(self, *args):
        per_arg = [pytree.tree_flatten(a) for a in args]
        self._check(args, per_arg)
        self.calls += 1
        binding = tuple(x.data_ptr() for i in self.bind_argnums
                        for x in per_arg[i][0] if isinstance(x, torch.Tensor))
        g = self.graphs.get(binding)
        if g is None:
            return self._capture(args, per_arg, binding)
        leaves = (x for xs, _ in per_arg for x in xs)
        for x, s in zip(leaves, g.static_leaves):
            if s is not None and x is not s:
                s.copy_(torch.as_tensor(x), non_blocking=True)
        g.graph.replay()
        g.replays += 1
        self.stats["replays"] = self.stats.get("replays", 0) + 1
        _apply_counts(g.counts)
        return g.out

    def _buffer(self, x):
        """A static input buffer on the card holding ``x`` (None for a
        leaf that is not a tensor or an array)."""
        if isinstance(x, torch.Tensor):
            return torch.empty_like(x, device=self.device).copy_(x)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(self.device)
        return None

    def _capture(self, args, per_arg, binding):
        with _CAPTURE_LOCK:
            return self._capture_locked(args, per_arg, binding)

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
                [o if o is not None else x for o, x in zip(own, leaves)],
                spec))
        cur = torch.cuda.current_stream(self.device)
        side = self.stream or capture_stream(self.device)
        side.wait_stream(cur)
        # the warm-up: the call's real execution, outside the capture, so
        # every lazy set-up (kernel libraries, route plans, shared-memory
        # opt-ins, library workspaces) is done before capture begins
        with torch.cuda.stream(side):
            out = self.fn(*static_args)
        cur.wait_stream(side)
        for x in pytree.tree_leaves(out):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                x.record_stream(cur)
        # the graph allocates from a pool of its own, which cannot reuse the
        # blocks the warm-up left cached: release them first (a train
        # step's activations would otherwise be held twice)
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                g_out = self.fn(*static_args)
            except BaseException as err:
                try:
                    graph.capture_end()
                except Exception:
                    pass
                raise RuntimeError(
                    f"CUDA graph capture of "
                    f"{getattr(self.fn, '__qualname__', self.fn)} failed "
                    f"(no eager fallback): {err}") from err
            graph.capture_end()
        delta = _count_delta(before, _counts())
        _apply_counts(delta, sign=-1)       # the capture launched nothing
        cur.wait_stream(side)
        self.graphs[binding] = _Graph(graph, static_leaves, g_out, delta)
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
                    stats: Optional[dict] = None) -> Executable:
    """A fresh executable of ``fn`` for the signature of ``example_args``,
    outside any cache: a graph executable on the card (the default), the
    function itself on the CPU."""
    dev = resolve_device(device)
    sig = _signature(tuple(example_args))
    if dev.type == "cuda":
        return GraphExecutable(fn, sig, bind_argnums, dev, stream=stream,
                               stats=stats)
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
    """A memory tier of executables keyed by content fingerprint (no disk
    tier: see the module docstring). ``stats`` counts hits and misses and,
    for the graphs of its executables, captures and replays."""

    def __init__(self):
        self._mem: dict = {}
        self._lock = threading.Lock()
        self.stats = {"mem_hits": 0, "misses": 0, "captures": 0,
                      "replays": 0, "t_capture_s": 0.0}

    def get(self, key: str):
        """-> (executable, source) where source in {"memory", None}."""
        with self._lock:
            if key in self._mem:
                self.stats["mem_hits"] += 1
                return self._mem[key], "memory"
            self.stats["misses"] += 1
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
        distinguishing. -> (executable, source), source in {"memory",
        "compiled"}."""
        dev = resolve_device(device)
        key = fingerprint(key_fn if key_fn is not None else fn,
                          tuple(example_args), device=dev,
                          extras=tuple(extras) + (tuple(bind_argnums),))
        exe, source = self.get(key)
        if exe is not None:
            return exe, source
        exe = make_executable(fn, tuple(example_args), device=dev,
                              bind_argnums=bind_argnums, stream=stream,
                              stats=self.stats)
        self.put(key, exe)
        return exe, "compiled"


_default_cache: Optional[CompileCache] = None
_default_lock = threading.Lock()


def default_cache() -> CompileCache:
    """Process-wide shared cache (launcher + serve use the same one)."""
    global _default_cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = CompileCache()
        return _default_cache
