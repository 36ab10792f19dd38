"""The SPMD runtime: one program on every rank, each rank holding its shard.

PyTorch's own form of the reference's ``jit`` over a mesh: one process per
card (a rank) runs the port's model code unchanged, and the sharded tensors
are ``torch.distributed.tensor.DTensor`` on a ``DeviceMesh`` whose axis
names are the port's mesh axes (``pod``, ``data``, ``model``).
``sharding.partition`` does the rest: under ``sharding_ctx`` on a mesh from
here, ``constrain`` redistributes to the resolved spec and ``place`` is
``distribute_tensor``.

  spmd_mesh(sizes, names)   the process group (NCCL on the cards, gloo when
                            the caller asks for the CPU) and a ``Mesh`` whose
                            positions are its ranks;
  placements(spec, mesh)    a ``PartitionSpec`` as DTensor placements;
  counting(mesh)            an abstract mesh brought up on a fake process
                            group: every position is a rank of this one
                            process, tensors live on ``meta`` and no
                            collective moves a byte (the dry run);
  CollectiveCounter         the collectives a rank issues, by kind, counted
                            as the reference's ``parse_collectives`` counts
                            them: the operand bytes a rank;
  spawn(fn, n)              n ranks, a process each;
  local_tensor, rewrap, settle, spec_of / ShardedSpec, count_replayed
                            what ``core.compile_cache`` needs to capture a
                            sharded step: a DTensor's shard, its layout as
                            a signature entry, its pending collectives
                            waited, and a replay's collectives counted;
  einsum, matmul, embedding, gather, softmax, reshape, write_rows, like
                            the ops whose DTensor rules the model cannot
                            use, each the plain op on plain tensors (so a
                            step with no mesh is unchanged; a mesh of one
                            rank is bit-equal to it).

``counting`` is the only place in the port that imports
``torch.testing._internal.distributed.fake_pg``: the module is internal to
torch (it registers the ``fake`` backend), so its use is kept here.
"""
from __future__ import annotations

import os
import sys
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import Mesh

# DTensor's collectives, by the reference's HLO names
_KINDS = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_c10d_functional", "broadcast"): "collective-broadcast",
    # a shard moved from one dim to another over a mesh dim (NCCL); on a
    # "cpu" mesh DTensor issues an all-gather of the same operand instead
    # (gloo has no all-to-all), which the counter counts as this one
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
}


def _in_alltoall() -> bool:
    """Whether the collective being dispatched is DTensor's all-to-all made
    of an all-gather (a "cpu" mesh)."""
    f = sys._getframe(2)
    for _ in range(40):
        if f is None:
            return False
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def _device_mesh(device_type: str, sizes: Sequence[int],
                 axis_names: Sequence[str]):
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(int(np.prod(sizes, dtype=np.int64))).reshape(
        tuple(sizes))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def _spmd(sizes, axis_names, devices, device_mesh, device) -> Mesh:
    mesh = Mesh(np.asarray(devices, dtype=object).reshape(tuple(sizes)),
                axis_names)
    mesh.device_mesh = device_mesh
    mesh.local_device = device
    return mesh


def spmd_mesh(sizes: Sequence[int], axis_names: Sequence[str], *,
              device=None, rank: Optional[int] = None,
              store_path: Optional[str] = None) -> Mesh:
    """This rank's view of a mesh of ranks, one rank a position.

    The process group is the one already set up, or one set up here: from
    ``rank`` / ``store_path`` (a ``FileStore``; no network) where they are
    given, the world the mesh's size, else from the usual environment
    variables (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` /
    ``MASTER_PORT``; ``LOCAL_RANK`` picks the card), else as the one rank of
    a ``FileStore`` in a temporary directory. ``device=None`` is the card
    (NCCL; rank r on ``cuda:{local rank}``); ``device="cpu"`` is gloo on
    the CPU. The world size must be the mesh's size. Tear the group down
    with ``shutdown()``."""
    dev = resolve_device(device)
    n = int(np.prod(sizes, dtype=np.int64))
    if not dist.is_initialized():
        if rank is None and "RANK" in os.environ:
            rank, world_size = (int(os.environ["RANK"]),
                                int(os.environ["WORLD_SIZE"]))
            init = dict(init_method="env://")
        else:
            rank, world_size = 0 if rank is None else rank, n
            if store_path is None:
                if world_size != 1:
                    raise ValueError("spmd_mesh: ranks of more than one "
                                     "process need a shared store_path or "
                                     "the RANK / WORLD_SIZE environment")
                store_path = os.path.join(tempfile.mkdtemp(), "store")
            init = dict(store=dist.FileStore(store_path, world_size))
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=rank, world_size=world_size, **init)
    if dist.get_world_size() != n:
        raise ValueError(f"spmd_mesh: a mesh of {n} positions on a process "
                         f"group of {dist.get_world_size()} ranks")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        local = torch.device("cuda", torch.cuda.current_device())
        devices = [torch.device("cuda", r % count) for r in range(n)]
    else:
        local = dev
        devices = [dev] * n
    return _spmd(sizes, axis_names, devices,
                 _device_mesh(dev.type, sizes, axis_names), local)


def shutdown() -> None:
    """Tear down the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextmanager
def counting(mesh: Mesh, rank: int = 0) -> Iterator[Mesh]:
    """``mesh`` (abstract) brought up on a fake process group whose world
    is the mesh's size, as rank ``rank`` of it; yields the SPMD mesh, its
    tensors on ``meta``. Nothing moves: a collective's result is the fake
    group's. The ``DeviceMesh``'s type is "cuda" where the process sees a
    card (the ranks there are NCCL ones, and DTensor's rules follow the
    mesh's type) and "cpu" where it does not (a "cuda" mesh there makes
    DTensor's shape propagation run some decompositions for CUDA, which a
    CPU build refuses; the counter counts a "cpu" mesh's all-to-alls as
    NCCL ranks issue them). The group is torn down on exit. Raises where a
    process group is already set up (count before ``spmd_mesh``, or in
    another process)."""
    # internal to torch: importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("counting: a process group is already set up in "
                           "this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=mesh.size)
    try:
        meta = torch.device("meta")
        yield _spmd(mesh.sizes, mesh.axis_names, [meta] * mesh.size,
                    _device_mesh("cuda" if torch.cuda.is_available()
                                 else "cpu", mesh.sizes, mesh.axis_names),
                    meta)
    finally:
        dist.destroy_process_group()


def placements(spec, mesh: Mesh) -> tuple:
    """DTensor placements (one a mesh dim) of a ``PartitionSpec``: a dim
    sharded over several mesh axes, as ``("pod", "data")``, is cut over
    them major to minor, as JAX cuts it, which DTensor does for axes named
    in mesh order (the rule tables name them so). An axis of size 1 is
    left whole."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        idx = [mesh.axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: axes {axes} of dim {dim} are not "
                             f"in the mesh's order {mesh.axis_names}")
        for i in idx:
            # an axis of one position cuts nothing: whole, so that a mesh
            # of one rank runs every op as the unsharded step does
            if mesh.sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives issued under it (``_c10d_functional``'s and
    DTensor's all-to-all): by kind (the reference's HLO names), with the
    operand bytes a rank (``roofline.CollectiveStats``). ``wait_tensor``
    and ``_wrap_tensor_autograd`` are bookkeeping, not collectives."""

    def __init__(self):
        super().__init__()
        from repro_torch.launch.roofline import CollectiveStats
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = _KINDS.get((func.namespace, func._opname))
            if kind == "all-gather" and _in_alltoall():
                kind = "all-to-all"
            if kind is not None:
                x = args[0]
                xs = x if isinstance(x, (list, tuple)) else [x]
                self.stats.add(kind, sum(t.numel() * t.element_size()
                                         for t in xs))
        return func(*args, **kwargs)


def count_replayed(stats, sign: int = 1) -> None:
    """Add ``stats`` (the collectives a captured call recorded) to every
    ``CollectiveCounter`` open in this thread. A CUDA graph's replay
    dispatches nothing, so ``core.compile_cache`` adds its capture's record
    on every replay, and takes it back out after the capture (``sign=-1``:
    a capture moves nothing)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, CollectiveCounter):
            mode.stats.merge(stats, sign)


# ---------------------------------------------------------------------------
# DTensors as the compile cache sees them
# ---------------------------------------------------------------------------
#
# A captured graph reads and writes raw addresses, so ``core.compile_cache``
# binds, buffers and copies a DTensor through its local tensor (its shard on
# this rank), and keys it by its layout: the mesh's sizes and axis names,
# the placements, and the local shape beside the global one.

_DTENSOR = None


def _dtensor_type():
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return _DTENSOR


def local_tensor(x):
    """``x``'s local tensor where ``x`` is a DTensor (its shard on this rank;
    a collective still pending on it waited), else ``x`` itself."""
    if not isinstance(x, _dtensor_type()):
        return x
    lt = x._local_tensor
    if hasattr(lt, "trigger_wait"):             # an AsyncCollectiveTensor
        lt = lt.wait()
    return lt


def rewrap(x, local):
    """A DTensor laid out as the DTensor ``x`` (mesh, placements, global
    shape and stride) over ``local``, this rank's shard."""
    return _dtensor_type().from_local(local, x.device_mesh, x.placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())


def settle(tree):
    """``tree`` with every collective its leaves wait on done: a DTensor
    over a pending collective's result rewrapped over the waited tensor, a
    pending result waited. A captured graph's outputs are settled inside
    the capture, so every NCCL stream joins the capture's stream before it
    ends."""
    from torch.utils import _pytree as pytree

    def one(x):
        if isinstance(x, _dtensor_type()):
            lt = local_tensor(x)
            return x if lt is x._local_tensor else rewrap(x, lt)
        return x.wait() if hasattr(x, "trigger_wait") else x
    return pytree.tree_map(one, tree)


def _placement_record(p) -> list:
    from torch.distributed.tensor import Partial, Replicate, Shard
    if type(p) is Shard:
        return ["S", p.dim]
    if type(p) is Replicate:
        return ["R"]
    if type(p) is Partial:
        return ["P", p.reduce_op]
    raise ValueError(f"no record form for the placement {p!r}")


def _placement(rec: list):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return {"S": lambda: Shard(rec[1]), "R": Replicate,
            "P": lambda: Partial(rec[1])}[rec[0]]()


@dataclass(frozen=True)
class ShardedSpec:
    """A stand-in for a DTensor that is not allocated: its global shape and
    dtype (as ``TensorSpec``'s), the mesh's sizes and axis names, its
    placements and this rank's local shape. ``core.compile_cache`` keys a
    DTensor argument on these, and a disk record keeps them
    (``record`` / ``from_record``)."""
    shape: Tuple[int, ...]
    dtype: object
    mesh_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    placements: tuple
    local_shape: Tuple[int, ...]

    @property
    def layout(self) -> tuple:
        """What a signature holds beyond the shape and dtype."""
        return (self.mesh_sizes, self.axis_names, self.placements,
                self.local_shape)

    def record(self) -> dict:
        return {"mesh": list(self.mesh_sizes), "axes": list(self.axis_names),
                "placements": [_placement_record(p)
                               for p in self.placements],
                "local": list(self.local_shape)}

    @classmethod
    def from_record(cls, shape, dtype, rec: dict) -> "ShardedSpec":
        return cls(tuple(shape), dtype, tuple(rec["mesh"]),
                   tuple(rec["axes"]),
                   tuple(_placement(p) for p in rec["placements"]),
                   tuple(rec["local"]))


def spec_of(x) -> Optional[ShardedSpec]:
    """``x``'s ``ShardedSpec`` where ``x`` is a DTensor (or is one already),
    else None."""
    if isinstance(x, ShardedSpec):
        return x
    if not isinstance(x, _dtensor_type()):
        return None
    mesh = x.device_mesh
    return ShardedSpec(tuple(x.shape), x.dtype, tuple(mesh.shape),
                       tuple(mesh.mesh_dim_names or ()),
                       tuple(x.placements), tuple(x._local_tensor.shape))


# ---------------------------------------------------------------------------
# Ops whose DTensor rules the model cannot use
# ---------------------------------------------------------------------------
#
# DTensor's own einsum decomposes into views and a bmm, and its bmm may
# shard a flattened output dim that the view back cannot cut (qwen3's 40
# heads on a 16-wide axis); its masked-partial gather of a vocab-sharded
# table fails inside DTensor. These ops lay their operands out explicitly,
# run the plain op on each rank's shards and say what the result is. Each
# is the plain op where no operand is a DTensor.

def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor of the SPMD runtime)."""
    return isinstance(x, _dtensor_type())


def as_sharded(x, like):
    """``x`` as a DTensor on ``like``'s mesh: a plain tensor, whole on
    every rank, is replicated (nothing is sent)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _from_local(local, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def einsum(eq: str, *ops: torch.Tensor, local_op=None) -> torch.Tensor:
    """``torch.einsum`` on each rank's shards where an operand is a
    DTensor. For each mesh dim, one letter is chosen to be cut there (the
    one the largest operand is cut on): an operand cut on another letter
    is gathered, one holding the letter whole is sliced (nothing sent),
    and a partial sum is reduced unless every other operand is whole there.
    The result is cut on that letter, or a partial sum where the letter is
    contracted, in the operands' dtype. ``local_op`` computes the same product
    on the local tensors where ``torch.einsum`` should not (``matmul``'s
    ``@``)."""
    if not any(is_sharded(o) for o in ops):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import Partial, Replicate, Shard
    like = next(o for o in ops if is_sharded(o))
    mesh = like.device_mesh
    ops = [as_sharded(o, like) for o in ops]
    lhs, out = eq.replace(" ", "").split("->")
    subs = lhs.split(",")
    sizes = {c: n for s, o in zip(subs, ops) for c, n in zip(s, o.shape)}
    pls = [list(o.placements) for o in ops]
    # each operand's gradient: cut as the operand where it is cut; a partial
    # sum where it is whole beside a cut or a kept partial sum (its rank
    # sees only that share); whole where it is itself the partial sum
    grads = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl = []
    for m in range(mesh.ndim):
        # the letter cut on mesh dim m: the largest operand's
        cut = [(o.numel(), s[p[m].dim]) for s, o, p in zip(subs, ops, pls)
               if isinstance(p[m], Shard)]
        letter = max(cut)[1] if cut else None
        if letter is not None and sizes[letter] % mesh.size(m):
            letter = None
        partial = [i for i, p in enumerate(pls) if isinstance(p[m], Partial)]
        keep_partial = (len(partial) == 1 and letter is None and all(
            isinstance(p[m], Replicate) for i, p in enumerate(pls)
            if i != partial[0]))
        for i, s in enumerate(subs):
            p = pls[i][m]
            if isinstance(p, Partial) and keep_partial:
                continue
            want = (Shard(s.index(letter)) if letter is not None
                    and letter in s else Replicate())
            pls[i][m] = want
        for i, p in enumerate(pls):
            if isinstance(p[m], Shard):
                grads[i][m] = p[m]
            elif keep_partial and i != partial[0] or (
                    letter is not None and not keep_partial):
                grads[i][m] = Partial()
        if keep_partial:
            out_pl.append(pls[partial[0]][m])
        elif letter is None:
            out_pl.append(Replicate())
        elif letter in out:
            out_pl.append(Shard(out.index(letter)))
        else:
            out_pl.append(Partial())
    ops = [o if list(o.placements) == p else o.redistribute(mesh, p)
           for o, p in zip(ops, pls)]
    locals_ = [o.to_local(grad_placements=g) for o, g in zip(ops, grads)]
    local = (local_op(*locals_) if local_op is not None
             else torch.einsum(eq, *locals_)).contiguous()
    return _from_local(local, mesh, out_pl, [sizes[c] for c in out])


def _offset(x, dim: int) -> int:
    """The global index of this rank's first element of ``x`` along
    ``dim``: each mesh dim that cuts ``dim`` cuts, in mesh order, what the
    ones before it left into chunks of ceil(n / k), as ``torch.chunk``
    (worked out from the sizes alone: torch's own helper builds an index
    of the whole shard). An empty shard's is the dim's size, as torch's."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    n, off = x.shape[dim], 0
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-n // mesh.size(m))
            first = min(coord[m] * chunk, n)
            off, n = off + first, min(chunk, n - first)
    return off if n else x.shape[dim]     # an empty shard: torch's end


def _take(x, dim: int, index, gather: bool):
    """``x`` indexed along a DTensor's ``dim`` by ``index``: each rank
    takes the rows its shard of ``dim`` holds, zero elsewhere, and the
    result is a partial sum over the mesh dims that cut ``dim``.
    ``gather``: ``torch.gather`` (``index`` has ``x``'s rank and is laid
    out as ``x`` but whole along ``dim``); else row lookup
    (``F.embedding`` of a (V, ...) table: ``index`` replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    dim = dim % x.ndim
    index = as_sharded(index, x)
    x_pl, x_grad, idx_pl, out_pl = [], [], [], []
    for p, q in zip(x.placements, index.placements):
        cuts = isinstance(p, Shard) and p.dim == dim
        x_grad.append(p)
        if gather:
            x_pl.append(p)
            idx_pl.append(Replicate() if cuts else p)
            out_pl.append(Partial() if cuts else p)
        elif cuts:
            x_pl.append(p)
            idx_pl.append(Replicate())
            out_pl.append(Partial())
        elif isinstance(q, Shard):
            # the index keeps its cut; the table is gathered on this dim
            # (its gradient: a partial sum of this rank's rows)
            x_pl.append(Replicate())
            x_grad[-1] = Partial()
            idx_pl.append(q)
            out_pl.append(q)
        else:
            x_pl.append(p)
            idx_pl.append(Replicate())
            out_pl.append(Shard(index.ndim + p.dim - 1)
                          if isinstance(p, Shard) else p)
    if list(x.placements) != x_pl:
        x = x.redistribute(mesh, x_pl)
    if list(index.placements) != idx_pl:
        index = index.redistribute(mesh, idx_pl)
    lx = x.to_local(grad_placements=x_grad)
    li = index.to_local().long() - _offset(x, dim)
    held = (li >= 0) & (li < lx.shape[dim])
    li = li.clamp(0, lx.shape[dim] - 1)
    if gather:
        got = torch.gather(lx, dim, li)
        got = torch.where(held, got, torch.zeros_like(got))
        shape = index.shape
    else:
        got = torch.nn.functional.embedding(li, lx)
        got = torch.where(held[..., None], got, torch.zeros_like(got))
        shape = tuple(index.shape) + tuple(x.shape[1:])
    return _from_local(got, mesh, out_pl, shape)


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``; on a DTensor table cut along its
    rows, each rank looks up the rows it holds (see ``_take``)."""
    if not is_sharded(table):
        return torch.nn.functional.embedding(tokens, table)
    return _take(table, 0, tokens, gather=False)


def gather(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, dim, index)``; on a DTensor, each rank gathers
    from its shard of ``dim`` (see ``_take``)."""
    if not is_sharded(x):
        return torch.gather(x, dim, index)
    return _take(x, dim, index, gather=True)


def write_rows(leaf, rows: torch.Tensor, start=None) -> None:
    """The ring write of ``models.attention`` on a DTensor ``leaf`` (B,
    cap, ...), in place: ``rows`` (B, S, ...) go to columns ``start[b] +
    j`` (``start`` (B,) ints, None for 0) where S < cap; where S >= cap the
    last cap rows go to columns ``(start[b] + i) % cap``, a roll. Each rank
    writes into its own shard of ``leaf`` the rows that land there, from
    the rows of its batch (gathered where ``rows`` is cut along the
    sequence): B x S rows a rank, as the plain path's ``index_put``, with
    no host sync."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = leaf.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in leaf.placements]
    bat = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in leaf.placements]

    def local(x, pl):
        x = as_sharded(x, leaf)
        return (x if list(x.placements) == pl
                else x.redistribute(mesh, pl)).to_local()

    lo, lr = leaf.to_local(), local(rows, want)
    cap, C = leaf.shape[1], lo.shape[1]
    lr = lr[:, max(lr.shape[1] - cap, 0):]
    j = torch.arange(lr.shape[1], device=lo.device)[None]        # (1, S)
    st = 0 if start is None else local(start, bat)[:, None].long()
    col = ((st + j) % cap - _offset(leaf, 1)).expand(lo.shape[0], -1)
    held = (col >= 0) & (col < C)
    # a row that lands elsewhere repeats its batch row's first held write
    # (same column, same value), or, where none lands here, rewrites column
    # 0 with what it holds: duplicate indices of index_put_ carry one value
    first = held.int().argmax(1, keepdim=True)
    some = held.any(1, keepdim=True)
    jj = torch.where(held, j, first)
    b = torch.arange(lo.shape[0], device=lo.device)[:, None].expand_as(jj)
    tail = (1,) * (lo.ndim - 2)
    vals = torch.where(some.reshape(some.shape + tail),
                       lr[b, jj].to(lo.dtype), lo[:, :1])
    lo.index_put_((b, torch.where(some, col.gather(1, jj), 0)), vals)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.softmax(x, dim)``; on a DTensor cut along ``dim``, each
    rank exponentiates its shard against the all-reduced maximum and
    divides by the all-reduced sum (two small all-reduces, where DTensor's
    own softmax gathers the whole of ``x``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dim = dim % x.ndim

    def cut(p):
        return isinstance(p, Shard) and p.dim == dim

    if not (is_sharded(x) and any(cut(p) for p in x.placements)):
        return torch.softmax(x, dim)
    mesh, pl = x.device_mesh, list(x.placements)
    red = tuple(x.shape[:dim]) + (1,) + tuple(x.shape[dim + 1:])
    rep = [Replicate() if cut(p) else p for p in pl]

    def total(local, op):
        part = [Partial(op) if cut(p) else p for p in pl]
        return _from_local(local, mesh, part, red).redistribute(
            mesh, rep).to_local(grad_placements=[
                Partial() if cut(p) else p for p in pl])

    lx = x.to_local()
    e = torch.exp(lx - total(lx.detach().amax(dim, keepdim=True), "max"))
    return _from_local(e / total(e.sum(dim, keepdim=True), "sum"), mesh, pl,
                       tuple(x.shape))


def like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` (a gradient) laid out as ``p`` (its parameter): a partial sum
    reduced, a cut moved. ``g`` itself where ``p`` is not a DTensor."""
    if not (is_sharded(g) and is_sharded(p)) or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _reshape_dt(x, new: tuple):
    """A DTensor ``x`` reshaped to ``new``, the cuts no layout holds
    gathered first (see ``reshape``)."""
    from torch.distributed.tensor import Replicate, Shard
    old = tuple(x.shape)
    a = 0
    while a < min(len(old), len(new)) and old[a] == new[a]:
        a += 1
    t = 0
    while (t < min(len(old), len(new)) - a
           and old[len(old) - 1 - t] == new[len(new) - 1 - t]):
        t += 1
    mesh = x.device_mesh
    per: dict = {}
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and a <= p.dim < len(old) - t:
            per[p.dim] = per.get(p.dim, 1) * mesh.size(m)
    bad = {d for d, n in per.items() if d != a or new[a] % n}
    if bad:
        x = x.redistribute(mesh, [
            Replicate() if isinstance(p, Shard) and p.dim in bad else p
            for p in x.placements])
    return x.reshape(new)


class _Reshape(torch.autograd.Function):
    """``_reshape_dt`` both ways: the gradient is reshaped back by the same
    rule (a view's own backward would split a cut dim unchecked)."""

    @staticmethod
    def forward(ctx, x, new):
        ctx.old = tuple(x.shape)
        return _reshape_dt(x, new)

    @staticmethod
    def backward(ctx, g):
        return _reshape_dt(g, ctx.old), None


def reshape(x: torch.Tensor, shape) -> torch.Tensor:
    """``x.reshape(shape)``; on a DTensor whose cut dims the reshape would
    split or merge in a way no DTensor layout holds (a cut dim split into
    a first part the cut does not divide, or a cut dim merged into an
    outer one), those cuts are first gathered, in the backward pass too."""
    if not is_sharded(x):
        return x.reshape(shape)
    return _Reshape.apply(x, tuple(shape))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a (..., K) and a (K, N) ``b``; where either is a
    DTensor, through ``einsum``'s layout rule (DTensor's own strategy
    search for a product whose flattened rows are cut over several mesh
    dims takes tens of seconds a call on a 512-position mesh), a partial
    sum reduced at once."""
    if not (is_sharded(a) or is_sharded(b)):
        return a @ b
    from torch.distributed.tensor import Partial, Replicate
    lead = "abcdefgh"[:a.ndim - 1]
    y = einsum(f"{lead}k,kn->{lead}n", a, b, local_op=torch.matmul)
    # a partial sum is reduced at the product, in the operands' dtype (a
    # later linear op would otherwise carry it to a larger tensor first)
    whole = [Replicate() if isinstance(p, Partial) else p
             for p in y.placements]
    return y if whole == list(y.placements) else y.redistribute(
        y.device_mesh, whole)


def shard_of(x: torch.Tensor, device_mesh, pl, device) -> torch.Tensor:
    """This rank's shard of ``x`` (whole on every rank), on ``device``, as a
    DTensor laid out as ``pl``: the slice is cut where ``x`` lies and only
    it is copied (``distribute_tensor`` with no source rank; nothing is
    sent between ranks). A leaf held whole that is already there is kept
    as it is, as ``Tensor.to`` keeps it."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, off = compute_local_shape_and_global_offset(
        x.shape, device_mesh, pl)
    local = x
    for d, (n, o) in enumerate(zip(shape, off)):
        if n != x.shape[d]:
            local = local.narrow(d, o, n)
    return _from_local(local.to(device).contiguous(), device_mesh, list(pl),
                       tuple(x.shape))


def _rank_main(rank: int, fn, n: int, store_path: str, device, args):
    torch.set_num_threads(1)
    try:
        fn(rank, n, store_path, device, *args)
    finally:
        shutdown()


def spawn(fn, n: int, *args, device=None) -> None:
    """Run ``fn(rank, n, store_path, device, *args)`` in ``n`` spawned
    processes, one a rank, and wait for all of them. ``store_path`` is a
    ``FileStore`` file in a fresh temporary directory: ``fn`` passes it
    (with ``rank`` and ``n``) to ``spmd_mesh``. Each rank runs one torch
    thread and tears its process group down on exit. ``fn`` must be
    importable (module level); a rank that raises makes this raise."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, n, os.path.join(tmp, "store"), device,
                                 args),
                           nprocs=n, join=True, start_method="spawn")


def pad(x: torch.Tensor, widths, value: float = 0.0) -> torch.Tensor:
    """``F.pad(x, widths, value=value)`` (constant); on a DTensor each rank
    pads its shard, a cut along a padded dim first gathered (torch 2.11's
    rule for the op indexes past the mesh's dims on a cut tensor)."""
    if not is_sharded(x):
        return torch.nn.functional.pad(x, widths, value=value)
    from torch.distributed.tensor import Replicate, Shard
    padded = {x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    whole = [Replicate() if isinstance(p, Shard) and p.dim in padded else p
             for p in x.placements]
    if whole != list(x.placements):
        x = x.redistribute(x.device_mesh, whole)
    shape = list(x.shape)
    for i, w in enumerate(widths):
        shape[x.ndim - 1 - i // 2] += w
    return _from_local(torch.nn.functional.pad(x.to_local(), widths,
                                               value=value),
                       x.device_mesh, whole, shape)
