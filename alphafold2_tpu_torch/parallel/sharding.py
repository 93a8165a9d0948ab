"""Device meshes, the pair grid's layout and the port's collectives.

Port of ``alphafold2_tpu/parallel/sharding.py`` on ``torch.distributed``.
JAX runs one program over all devices and lets GSPMD insert the
collectives its sharding constraints imply; the port runs SPMD ranks, one
process a device, each holding its own block of every sharded array, and
every cross-rank step is one of the explicit collectives below.

- A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with JAX's
  axis names: ``(dp, sp)`` from :func:`make_mesh`, ``(dp, spr, spc)`` from
  ``grid_parallel.make_grid_mesh``. Building one needs an initialised
  process group (``parallel.distributed.initialize``); without one it
  raises, and no rank ever falls back to the meshless path.
- The pair grid (B, N, N, D) is held as ``(B/dp, N/spr, N/spc, D)``
  blocks: rank ``(d, r, c)`` holds batch slice ``d``, rows block ``r`` and
  columns block ``c`` (:func:`pair_layout`). A 1D ``(dp, sp)`` mesh is the
  same layout with ``sp`` as the row axis and one column shard, which is
  the layout JAX's ``P(dp, sp)`` constraint gives the pair grid there.
- The MSA grid (B, M, Nm, D) is replicated over the sequence axes and
  sharded over ``dp`` only, as in JAX; under ``model.msa_row_shard`` its
  rows are sharded too (JAX's ``msa_spec(rows=True)``): over ``sp`` on a
  1D mesh, over ``spr`` on a grid mesh (replicated over ``spc``), each
  rank holding ``ceil(M / n)`` rows of its dp slice, the last ranks' tails
  padded with rows that abstain (:func:`msa_row_block`).
- :func:`shard_pair`, :func:`shard_msa` and :func:`shard_batch` stand
  where JAX's sharding constraints stand, at layer boundaries; each checks
  the local block's shape against the layout (identity without an active
  mesh). JAX's ``replicated`` has no counterpart: parameters and the MSA
  are whole on every rank by construction, and nothing is gathered to
  make them so.
- Every collective of the port goes through :func:`all_to_all`,
  :func:`all_to_all_uneven`, :func:`all_gather`, :func:`reduce_scatter`,
  :func:`all_reduce`, :func:`ring_shift` and :func:`broadcast_object`, each
  of which records ``(op, mesh axis, bytes)`` into a process-wide census
  (:func:`census`), the way ``ops/cuda/build.py``'s ``count`` records
  kernel launches; the collective audit (``analysis/hlo_audit.py``) reads
  it. Over an axis of one rank a wrapper records what it would send and
  returns its input (or a view of it) without calling the backend: the
  census stays whole, and the one card's world-1 mesh copies nothing.

The sharded backward follows the rule GSPMD gives JAX implicitly:

- Each collective's backward is its SPMD transpose, run where autograd
  reaches it (an ``autograd.Function`` a wrapper, entered only where grad
  is enabled and an input requires it): ``all_to_all`` the inverse
  all_to_all, ``all_to_all_uneven`` the same with the split sizes swapped,
  ``all_gather`` a reduce-scatter (sum) of which each rank keeps its
  block, ``reduce_scatter`` an all_gather, an ``all_reduce`` sum an
  all_reduce sum of the cotangents, ``transpose_pair`` itself,
  ``ring_shift`` the shift the other way; an ``all_reduce`` max carries no
  gradient. :func:`gather_pair` is an all_gather and views. The backward
  records its collectives in the census too, so a step's census holds the
  forward, remat's recompute and the backward.
- A replicated tensor's cotangent is held as partials, one a rank, that
  sum to the whole; a rank's block holds the whole cotangent of its block.
  Each rank's loss is its own share of the global loss (its valid pairs'
  sum over the valid count summed over the world, that count reduced with
  no gradient), so every parameter gradient after ``backward`` is a
  partial, summed once over the whole world (``train/loop.py``
  ``reduce_gradients``: one flat buffer in parameter order, one all_reduce
  a micro-step). Replicated parameters and optimizer state then stay
  bit-identical on every rank, and so do ``grads_ok`` and the skip.

``AF2TPU_AUDIT_DROP_SHARD_PAIR`` is the audit's negative control: with it
set, :func:`shard_pair` replicates the pair state onto every rank by an
all_gather over the sequence axes (and keeps its own block of the result),
the defect the collective audit must catch. Never set in production.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import threading
from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "dp"
SEQ_AXIS = "sp"
ROW_AXIS = "spr"  # pair-grid rows on a grid mesh
COL_AXIS = "spc"  # pair-grid columns on a grid mesh

_active = threading.local()
_census: dict = {}
_census_lock = threading.Lock()
_seq_groups: dict = {}


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def require_process_group() -> None:
    """Raise unless a process group is initialised, as every mesh needs."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs an initialised process group: call "
            "alphafold2_tpu_torch.parallel.distributed.initialize() (torchrun's env) "
            "or torch.distributed.init_process_group first")


def build_mesh(shape: tuple, names: tuple):
    """A DeviceMesh of ``shape`` over every rank of the initialised process
    group, row-major, with axis ``names``. Raises without a process group
    or when the shape does not cover the world."""
    from torch.distributed.device_mesh import init_device_mesh

    require_process_group()
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} != {world} ranks")
    mesh = init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(names))
    axis_group(mesh, "seq")  # made now, on every rank in one order, not mid-forward
    return mesh


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1):
    """A ``(dp, sp)`` mesh over the world; ``n_data`` defaults to every rank
    the ``sp`` axis leaves."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_seq
    return build_mesh((n_data, n_seq), (DATA_AXIS, SEQ_AXIS))


@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active one on this thread: the model code run
    inside takes its sharded route."""
    prev = getattr(_active, "mesh", None)
    _active.mesh = mesh
    try:
        yield mesh
    finally:
        _active.mesh = prev


def active_mesh():
    return getattr(_active, "mesh", None)


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name``; 1 where the mesh has no such axis."""
    names = axis_names(mesh)
    return int(mesh.shape[names.index(name)]) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on mesh axis ``name``; 0 where it has none."""
    return int(mesh.get_local_rank(name)) if name in axis_names(mesh) else 0


def is_grid(mesh) -> bool:
    return mesh is not None and ROW_AXIS in axis_names(mesh)


@dataclasses.dataclass(frozen=True)
class PairLayout:
    """Where this rank's block of the pair grid lies: batch slice
    ``data_index`` of ``n_data``, rows block ``row_index`` of ``n_row``
    (mesh axis ``row_axis``), columns block ``col_index`` of ``n_col``
    (``col_axis``, None on a 1D mesh)."""

    n_data: int
    data_index: int
    n_row: int
    row_index: int
    n_col: int
    col_index: int
    row_axis: str
    col_axis: Optional[str]

    def rows(self, n: int) -> slice:
        step = n // self.n_row
        return slice(self.row_index * step, (self.row_index + 1) * step)

    def cols(self, n: int) -> slice:
        step = n // self.n_col
        return slice(self.col_index * step, (self.col_index + 1) * step)

    def batch(self, b: int) -> slice:
        step = b // self.n_data
        return slice(self.data_index * step, (self.data_index + 1) * step)


def pair_layout(mesh) -> PairLayout:
    """The pair grid's layout on ``mesh``: rows over ``spr`` and columns
    over ``spc`` on a grid mesh, rows over ``sp`` on a 1D mesh."""
    if is_grid(mesh):
        row, col = ROW_AXIS, COL_AXIS
    else:
        row, col = SEQ_AXIS, None
    return PairLayout(
        n_data=axis_size(mesh, DATA_AXIS), data_index=axis_index(mesh, DATA_AXIS),
        n_row=axis_size(mesh, row), row_index=axis_index(mesh, row),
        n_col=axis_size(mesh, col) if col else 1,
        col_index=axis_index(mesh, col) if col else 0, row_axis=row, col_axis=col)


def check_divisible(n: int, mesh, what: str = "pair length") -> None:
    """The all_to_all transposes trade a factor of ``n / spr`` or ``n / spc``
    for the other axis: ``n`` must divide by ``spr * spc`` (``sp`` on a 1D
    mesh)."""
    lay = pair_layout(mesh)
    tile = lay.n_row * lay.n_col
    if n % tile:
        raise ValueError(f"{what} {n} does not divide by the mesh's sequence tile "
                         f"{tile} ({describe_mesh(mesh)})")


def seq_axes(mesh) -> tuple:
    """The mesh axes the pair grid is sharded over: ``(sp,)`` or ``(spr, spc)``."""
    lay = pair_layout(mesh)
    return (lay.row_axis,) if lay.col_axis is None else (lay.row_axis, lay.col_axis)


def axis_group(mesh, axis):
    """The process group of one mesh axis, or of the sequence axes together
    (``axis="seq"``: every rank holding a block of the same batch slice)."""
    if axis == "seq":
        axes = seq_axes(mesh)
        if len(axes) == 1:
            return mesh.get_group(axes[0])
        key = id(mesh)
        hit = _seq_groups.get(key)
        if hit is None or hit[0] is not mesh:
            hit = (mesh, mesh[axes]._flatten().get_group())
            _seq_groups[key] = hit
        return hit[1]
    if axis == "world":
        return dist.group.WORLD
    return mesh.get_group(axis)


# ------------------------------------------------------------ the census


def _record(op: str, axis: str, nbytes: int) -> None:
    with _census_lock:
        entry = _census.setdefault(f"{op}@{axis}", {"count": 0, "bytes": 0, "max_bytes": 0})
        entry["count"] += 1
        entry["bytes"] += int(nbytes)
        entry["max_bytes"] = max(entry["max_bytes"], int(nbytes))


def census() -> dict:
    """The collectives recorded since the last :func:`reset_census`:
    ``{"op@axis": {"count", "bytes", "max_bytes"}}`` (bytes a rank sends,
    or an all_gather's gathered result, as JAX counts result shapes), keys
    sorted, and ``"pair_state": {"held_bytes", "whole_bytes"}``: the
    largest pair block a rank held at a layer boundary and the whole grid
    it belongs to."""
    with _census_lock:
        return {k: dict(_census[k]) for k in sorted(_census)}


def census_delta(before: dict, after: dict) -> dict:
    """The collectives ``after`` (a :func:`census`) holds beyond ``before``:
    ``{"op@axis": {"count", "bytes"}}``, without the pair-state record."""
    out = {}
    for key, v in after.items():
        if key == "pair_state":
            continue
        b = before.get(key, {"count": 0, "bytes": 0})
        if v["count"] != b["count"]:
            out[key] = {"count": v["count"] - b["count"], "bytes": v["bytes"] - b["bytes"]}
    return out


def reset_census() -> None:
    with _census_lock:
        _census.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ----------------------------------------------------------- collectives


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _all_to_all(t, mesh, axis, split_dim, concat_dim):
    group = axis_group(mesh, axis)
    size = dist.get_world_size(group)
    if t.shape[split_dim] % size:
        raise ValueError(f"axis {split_dim} of {tuple(t.shape)} does not divide by mesh "
                         f"axis {axis}={size} for the all-to-all")
    if size == 1:
        _record("all_to_all", axis, _nbytes(t))
        return t
    send = t.unflatten(split_dim, (size, -1)).movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    _record("all_to_all", axis, _nbytes(send))
    dist.all_to_all_single(recv, send, group=group)
    return recv.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)
        return _all_to_all(t, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def all_to_all(t: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int):
    """JAX's tiled ``lax.all_to_all`` over one mesh axis: ``t``'s
    ``split_dim`` cut into one chunk a rank of the axis, chunk ``i`` sent
    to rank ``i``, the chunks received concatenated along ``concat_dim``
    in rank order. One ``all_to_all_single``; its backward is the inverse
    all_to_all (``concat_dim`` split, ``split_dim`` concatenated)."""
    if _needs_grad(t):
        return _AllToAll.apply(t, mesh, axis, split_dim, concat_dim)
    return _all_to_all(t, mesh, axis, split_dim, concat_dim)


def _all_to_all_uneven(send, send_splits, recv_splits, mesh, axis):
    group = axis_group(mesh, axis)
    _record("all_to_all", axis, _nbytes(send))
    if dist.get_world_size(group) == 1:
        return send
    recv = send.new_empty((sum(recv_splits), *send.shape[1:]))
    dist.all_to_all_single(recv, send.contiguous(), output_split_sizes=list(recv_splits),
                           input_split_sizes=list(send_splits), group=group)
    return recv


class _AllToAllUneven(torch.autograd.Function):
    @staticmethod
    def forward(ctx, send, send_splits, recv_splits, mesh, axis):
        ctx.args = (recv_splits, send_splits, mesh, axis)
        return _all_to_all_uneven(send, send_splits, recv_splits, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_uneven(g.contiguous(), *ctx.args), None, None, None, None


def all_to_all_uneven(send: torch.Tensor, send_splits: list, recv_splits: list, mesh,
                      axis: str):
    """``all_to_all_single`` with per-rank split sizes along dim 0 of a
    contiguous ``send``: ``send_splits[i]`` rows go to rank ``i``,
    ``recv_splits[i]`` rows come from it. Its backward sends the
    cotangent's rows back with the split sizes swapped."""
    if _needs_grad(send):
        return _AllToAllUneven.apply(send, send_splits, recv_splits, mesh, axis)
    return _all_to_all_uneven(send, send_splits, recv_splits, mesh, axis)


def _all_gather(t, mesh, axis, dim):
    group = axis_group(mesh, axis)
    size = dist.get_world_size(group)
    if size == 1:
        _record("all_gather", axis, _nbytes(t))
        return t
    t = t.contiguous()
    out = t.new_empty((size * t.shape[0], *t.shape[1:]))
    _record("all_gather", axis, _nbytes(out))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=group)
    return out.view(size, *t.shape).movedim(0, dim).flatten(dim, dim + 1)


def _reduce_scatter(t, mesh, axis, dim):
    group = axis_group(mesh, axis)
    size = dist.get_world_size(group)
    if t.shape[dim] % size:
        raise ValueError(f"axis {dim} of {tuple(t.shape)} does not divide by mesh axis "
                         f"{axis}={size} for the reduce-scatter")
    if size == 1:
        _record("reduce_scatter", axis, _nbytes(t))
        return t
    send = t.unflatten(dim, (size, -1)).movedim(dim, 0).contiguous()
    out = send.new_empty(send[0].numel())
    _record("reduce_scatter", axis, _nbytes(send))
    dist.reduce_scatter_tensor(out, send.view(-1), op=dist.ReduceOp.SUM, group=group)
    return out.view(send.shape[1:])


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _all_gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _reduce_scatter(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return _all_gather(g, mesh, axis, dim), None, None, None


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0):
    """Every rank's ``t`` of mesh axis ``axis`` concatenated along ``dim``
    in rank order (JAX's tiled ``all_gather``). Its backward is a
    reduce-scatter: the cotangents summed over the axis, each rank keeping
    its own block."""
    if _needs_grad(t):
        return _AllGather.apply(t, mesh, axis, dim)
    return _all_gather(t, mesh, axis, dim)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int = 0):
    """The sum of ``t`` over mesh axis ``axis``, of which each rank keeps
    block ``i`` (its index on the axis) along ``dim``: one
    ``reduce_scatter_tensor`` (NCCL, and gloo on the CPU and on CUDA
    tensors, ``chip_smoke.py`` ``probe_gloo_cuda``). Its backward is an
    all_gather."""
    if _needs_grad(t):
        return _ReduceScatter.apply(t, mesh, axis, dim)
    return _reduce_scatter(t, mesh, axis, dim)


def _all_reduce(t, mesh, axis, op):
    group = axis_group(mesh, axis)
    _record("all_reduce", axis, _nbytes(t))
    if dist.get_world_size(group) == 1:
        return t
    out = t.contiguous().clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(out, op=red, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.args = (mesh, axis)
        return _all_reduce(t, mesh, axis, "sum")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, *ctx.args, "sum"), None, None


def all_reduce(t: torch.Tensor, mesh, axis: str, op: str = "sum"):
    """The elementwise ``op`` ("sum" or "max") of ``t`` over mesh axis
    ``axis``, in a new tensor (``t`` itself over one rank). A sum's
    backward is the sum of the cotangents over the axis; a max carries no
    gradient (its one use, the merges' stabiliser, cancels out of their
    result)."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce op must be 'sum' or 'max', not {op!r}")
    if _needs_grad(t):
        if op == "max":
            return _all_reduce(t.detach(), mesh, axis, op)
        return _AllReduceSum.apply(t, mesh, axis)
    return _all_reduce(t, mesh, axis, op)


def _ring_shift(tensors, mesh, axis, step=1):
    group = axis_group(mesh, axis)
    size = dist.get_world_size(group)
    if size == 1:
        for t in tensors:
            _record("send_recv", axis, _nbytes(t))
        return list(tensors)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + step) % size)
    prv = dist.get_global_rank(group, (me - step) % size)
    ops, out = [], []
    for t in tensors:
        t = t.contiguous()
        r = torch.empty_like(t)
        _record("send_recv", axis, _nbytes(t))
        ops += [dist.P2POp(dist.isend, t, nxt, group=group),
                dist.P2POp(dist.irecv, r, prv, group=group)]
        out.append(r)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *tensors):
        ctx.args = (mesh, axis)
        ctx.floating = [t.is_floating_point() for t in tensors]
        out = _ring_shift(tensors, mesh, axis)
        for t, f in zip(out, ctx.floating):
            if not f:
                ctx.mark_non_differentiable(t)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        moved = iter(_ring_shift([g for g, f in zip(grads, ctx.floating) if f], *ctx.args,
                                 step=-1))
        return (None, None, *(next(moved) if f else None for f in ctx.floating))


def ring_shift(tensors, mesh, axis: str):
    """Each tensor of ``tensors`` sent one hop along the ring of mesh axis
    ``axis`` (rank ``i`` to ``i + 1``) and the previous rank's received in
    its place, by ``batch_isend_irecv``; returns the received tensors. The
    backward sends each floating tensor's cotangent one hop the other way."""
    tensors = list(tensors)
    if _needs_grad(*tensors):
        return list(_RingShift.apply(mesh, axis, *tensors))
    return _ring_shift(tensors, mesh, axis)


def broadcast_object(obj, src: int = 0, device: Optional[torch.device] = None):
    """``obj`` from global rank ``src`` to every rank of the world (pickled;
    on the card the bytes travel in a device tensor, as NCCL needs)."""
    buf = [obj]
    if dist.get_rank() == src:
        _record("broadcast", "world", len(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)))
    if dist.get_world_size() == 1:
        return obj
    dist.broadcast_object_list(buf, src=src, device=device)
    return buf[0]


# -------------------------------------------------- the layout boundaries


def shard_pair(x: torch.Tensor, n: Optional[int] = None, mesh=None) -> torch.Tensor:
    """The pair grid's layer boundary: under an active mesh ``x`` must be
    this rank's ``(b, n/rows, n/cols, ...)`` block of a global length
    ``n`` (by default the rows the block implies); returns ``x``. With
    ``AF2TPU_AUDIT_DROP_SHARD_PAIR`` set, the audit's seeded defect (module
    docstring)."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return x
    lay = pair_layout(mesh)
    n = x.shape[1] * lay.n_row if n is None else n
    want = (n // lay.n_row, n // lay.n_col)
    if tuple(x.shape[1:3]) != want:
        raise ValueError(f"pair block {tuple(x.shape)} is not this rank's "
                         f"{want} block of {n} x {n} on {describe_mesh(mesh)}")
    if os.environ.get("AF2TPU_AUDIT_DROP_SHARD_PAIR"):
        return _audit_replicate_pair(x, n, mesh)
    _observe_pair(x, lay)
    return x


def _audit_replicate_pair(x, n, mesh):  # af2: gated-defect[AF2TPU_AUDIT_DROP_SHARD_PAIR]
    """The collective audit's seeded defect: every rank gathers the whole
    pair grid of its batch slice (the replicated state a dropped JAX
    constraint leaves) and keeps its own block of it."""
    lay = pair_layout(mesh)
    full = gather_pair(x, mesh, axis="seq")
    _observe_pair(full, None)
    return full[:, lay.rows(n), lay.cols(n)]


def _observe_pair(held: torch.Tensor, lay: Optional[PairLayout]) -> None:
    """Record the largest pair state a rank has held and the whole grid it
    is a block of (``lay`` None: ``held`` is the whole grid), for the
    collective audit's AF2A108."""
    whole = _nbytes(held) * (lay.n_row * lay.n_col if lay is not None else 1)
    with _census_lock:
        seen = _census.setdefault("pair_state", {"held_bytes": 0, "whole_bytes": 0})
        seen["held_bytes"] = max(seen["held_bytes"], _nbytes(held))
        seen["whole_bytes"] = max(seen["whole_bytes"], whole)


@dataclasses.dataclass(frozen=True)
class RowBlock:
    """Where this rank's block of an MSA grid's rows lies under
    ``msa_row_shard``: mesh axis ``axis`` (``sp`` on a 1D mesh, ``spr`` on
    a grid mesh) of ``n`` ranks, this rank's index ``index`` on it, ``total``
    rows in all and ``per`` = ceil(total / n) a rank. Rank ``i`` holds
    global rows ``[i * per, (i + 1) * per)``; those past ``total`` are
    padding that abstains (masked, zeroed where they would vote)."""

    axis: str
    n: int
    index: int
    total: int
    per: int

    @property
    def offset(self) -> int:
        """This rank's first global row."""
        return self.index * self.per

    @property
    def pad(self) -> int:
        """Padding rows over the whole axis (all at the global tail)."""
        return self.n * self.per - self.total

    @property
    def valid(self) -> int:
        """This rank's real rows (its first ``valid`` rows)."""
        return max(0, min(self.per, self.total - self.offset))

    def take(self, t: torch.Tensor, dim: int = 1, fill=0) -> torch.Tensor:
        """This rank's ``per`` rows of ``t`` along ``dim``, a global array of
        ``total`` rows, padded with ``fill`` past them."""
        lo = min(self.offset, self.total)
        block = t.narrow(dim, lo, self.valid)
        if self.valid == self.per:
            return block
        shape = list(t.shape)
        shape[dim] = self.per - self.valid
        return torch.cat([block, t.new_full(shape, fill)], dim=dim)


def msa_row_block(total: int, mesh) -> RowBlock:
    """The row block of an MSA grid of ``total`` rows on ``mesh`` under
    ``msa_row_shard`` (JAX's ``msa_spec(rows=True)``: ``sp`` on a 1D mesh,
    ``spr`` on a grid mesh)."""
    axis = ROW_AXIS if is_grid(mesh) else SEQ_AXIS
    n = axis_size(mesh, axis)
    return RowBlock(axis=axis, n=n, index=axis_index(mesh, axis), total=int(total),
                    per=-(-int(total) // n))


def shard_msa(m: torch.Tensor, b: int, mesh=None, rows: Optional[RowBlock] = None) -> torch.Tensor:
    """The MSA grid's layer boundary: under an active mesh ``m`` is a
    ``(b, M, Nm, D)`` MSA grid of the same ``b`` batch rows, this rank's dp
    slice, as the pair block it runs beside: whole (replicated over the
    sequence axes) or, with ``rows`` (``msa_row_shard``), this rank's
    ``rows.per`` rows of it; returns ``m``."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return m
    if m.dim() != 4 or m.shape[0] != b:
        raise ValueError(f"MSA block {tuple(m.shape)} is not a (b, M, Nm, D) grid of the "
                         f"pair block's {b} batch rows on {describe_mesh(mesh)}")
    if rows is not None and m.shape[1] != rows.per:
        raise ValueError(f"MSA block {tuple(m.shape)} does not hold this rank's {rows.per} "
                         f"of {rows.total} rows over {rows.axis}={rows.n} on "
                         f"{describe_mesh(mesh)}")
    return m


def shard_batch(t: torch.Tensor, b: int, mesh=None) -> torch.Tensor:
    """A batch-leading array's boundary: under an active mesh ``t`` holds
    this rank's ``b / dp`` rows of a global batch ``b``; returns ``t``."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is not None and t.shape[0] != b // axis_size(mesh, DATA_AXIS):
        raise ValueError(f"batch block {t.shape[0]} is not 1/{axis_size(mesh, DATA_AXIS)} "
                         f"of {b}")
    return t


def gather_pair(block: torch.Tensor, mesh, axis: str = "world") -> torch.Tensor:
    """The whole pair grid from every rank's block: ``axis="seq"`` gathers
    this rank's batch slice over the sequence axes, ``"world"`` the whole
    batch over every rank. ``block`` is ``(b, n/rows, n/cols, ...)``."""
    lay = pair_layout(mesh)
    parts = all_gather(block[None], mesh, axis, dim=0)
    n_data = lay.n_data if axis == "world" else 1
    tail = tuple(block.shape[3:])
    b, hr, wc = block.shape[:3]
    g = parts.view(n_data, lay.n_row, lay.n_col, b, hr, wc, *tail)
    g = g.permute(0, 3, 1, 4, 2, 5, *range(6, 6 + len(tail)))
    return g.reshape(n_data * b, lay.n_row * hr, lay.n_col * wc, *tail)


class _TransposePair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, mesh):
        ctx.args = (n, mesh)
        return _transpose_pair(x, n, mesh)

    @staticmethod
    def backward(ctx, g):
        return _transpose_pair(g, *ctx.args), None, None


def transpose_pair(x: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """This rank's block of ``x``'s transpose over the two pair axes: rows
    ``I`` and columns ``J`` of ``x^T`` are ``x[J, I]``, which other ranks
    hold. Each rank sends every rank of its sequence group the part of its
    block the other's transposed block needs, in one uneven
    ``all_to_all_single``; nothing larger than the local block moves. The
    transpose is its own inverse and its own adjoint: its backward is
    itself on the cotangent."""
    if _needs_grad(x):
        return _TransposePair.apply(x, n, mesh)
    return _transpose_pair(x, n, mesh)


def _transpose_pair(x, n, mesh):
    lay = pair_layout(mesh)
    axis = "seq"
    hr, wc = n // lay.n_row, n // lay.n_col
    me_r, me_c = lay.row_index, lay.col_index
    peers = [(r, c) for r in range(lay.n_row) for c in range(lay.n_col)]

    def overlap(a0, a1, b0, b1):
        return max(a0, b0), min(a1, b1)

    send, send_splits, recv_spec = [], [], []
    tail = x.shape[3:]
    for pr, pc in peers:
        # the peer's transposed block needs x[rows J_pc, cols I_pr]; we hold
        # rows I_me, cols J_me of x
        r0, r1 = overlap(me_r * hr, (me_r + 1) * hr, pc * wc, (pc + 1) * wc)
        c0, c1 = overlap(me_c * wc, (me_c + 1) * wc, pr * hr, (pr + 1) * hr)
        if r1 > r0 and c1 > c0:
            piece = x[:, r0 - me_r * hr:r1 - me_r * hr, c0 - me_c * wc:c1 - me_c * wc]
            send.append(piece.transpose(1, 2).reshape(-1, *tail))
            send_splits.append(send[-1].shape[0])
        else:
            send_splits.append(0)
        # what the peer sends us: x[rows I_pr ∩ J_me, cols J_pc ∩ I_me]
        r0, r1 = overlap(pr * hr, (pr + 1) * hr, me_c * wc, (me_c + 1) * wc)
        c0, c1 = overlap(pc * wc, (pc + 1) * wc, me_r * hr, (me_r + 1) * hr)
        recv_spec.append((r0, r1, c0, c1) if r1 > r0 and c1 > c0 else None)
    b = x.shape[0]
    recv_splits = [0 if s is None else b * (s[1] - s[0]) * (s[3] - s[2]) for s in recv_spec]
    flat = torch.cat(send) if send else x.new_empty((0, *tail))
    recv = _all_to_all_uneven(flat, send_splits, recv_splits, mesh, axis)
    out = x.new_empty(x.shape)
    at = 0
    for spec, rows in zip(recv_spec, recv_splits):
        if spec is None:
            continue
        r0, r1, c0, c1 = spec
        # x[r0:r1, c0:c1] transposed lands at x^T rows c0:c1, cols r0:r1
        piece = recv[at:at + rows].view(b, c1 - c0, r1 - r0, *tail)
        out[:, c0 - me_r * hr:c1 - me_r * hr, r0 - me_c * wc:r1 - me_c * wc] = piece
        at += rows
    return out


def describe_mesh(mesh) -> Optional[str]:
    """Stable mesh identity, e.g. ``"dp1.spr2.spc2"`` (JAX's strings): the
    key the serving executables, result cache and compile records share.
    None for no mesh."""
    if mesh is None:
        return None
    return ".".join(f"{name}{int(size)}" for name, size in zip(axis_names(mesh), mesh.shape))


def parse_mesh_spec(spec: Optional[str]):
    """A mesh from a compact spec: ``"DPxSPRxSPC"`` (a grid mesh) or
    ``"DPxSP"`` (a 1D mesh); empty or None gives no mesh."""
    if not spec:
        return None
    parts = [int(p) for p in spec.lower().replace("x", " ").split()]
    if len(parts) == 3:
        from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh

        return make_grid_mesh(*parts)
    if len(parts) == 2:
        return make_mesh(parts[0], parts[1])
    raise ValueError(f"mesh spec {spec!r} must be 'dpxsprxspc' (grid) or 'dpxsp' (1D)")
