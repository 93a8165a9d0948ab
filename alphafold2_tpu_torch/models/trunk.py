"""The trunk and its engines: layers of axial self-attention and pair<->MSA
cross-attention over the pair and MSA streams.

Port of ``alphafold2_tpu/models/trunk.py``: ``TrunkLayer`` (:42-168),
``resolve_remat_policy`` (:171-193), ``_ScanBody`` (:196-219) and ``Trunk``
with its three engines (:222-412). Streams stay grids: pair (B, N, N, D),
MSA (B, M, Nm, D).

- The default engine is a python loop of TrunkLayers named ``layer_{i}``.
- ``remat=True`` runs each layer under ``torch.utils.checkpoint``
  (non-reentrant), so the backward recomputes its activations. The
  parameters stay ``layer_{i}``, the default engine's. ``remat_policy``
  "dots" keeps the outputs of every matmul (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``), "dots_no_batch" those of the matmuls without batch dims
  (``mm``, ``addmm``: the Dense projections), as JAX's ``checkpoint_dots``
  and ``checkpoint_dots_with_no_batch_dims`` do. The attention kernels are
  no matmuls to either policy: their outputs are recomputed, as JAX
  recomputes its ``pallas_call``s. Under no gradient remat changes nothing.
- ``scan_layers=True`` keeps one TrunkLayer whose parameters carry a leading
  depth axis (``scan.layer.<...>``, flax's ``trunk/scan/layer``) and applies
  depth slice ``i`` with ``torch.func.functional_call``. PyTorch runs
  eagerly, so unlike ``lax.scan`` this saves no compile time: the engine
  exists so that a JAX scanned checkpoint, and the same network, run in the
  port. With ``remat`` each step is checkpointed.
- ``reversible=True`` is ``models/reversible.py``'s inversion-based engine,
  a different network with its own stacked parameters. It takes precedence
  over ``remat`` and ``scan_layers``.

Dropout (``attn_dropout``, ``ff_dropout``) is active where the forward is
given a ``DropoutKey`` (``ops/attention.py``): the loop's layers draw under
``trunk/layer_{i}/<module>``, the scanned layer under ``trunk/scan/layer``
at index ``i``, so remat's recompute replays each mask from its key, not
from the RNG state ``torch.utils.checkpoint`` saves (that covers only the
global generators). The numerics tags sit where JAX's do: each loop
layer's streams as ``trunk.layer_{i}.pair``/``.msa``, outside the
checkpointed call (JAX :408-413); the scanned and reversible engines tag
only ``trunk.out.pair``/``.msa`` (:362-366, :392-394).

``sparse_self_attn`` (a bool, or one per layer) makes a layer's pair axial
passes block-sparse (K4/K5), as in JAX only the pair stream; the scanned and
reversible engines need one value for every layer.

Under an active device mesh (``parallel/sharding.py use_mesh``) the loop
and scanned engines run on this rank's blocks, with JAX's layer-boundary
placements (``alphafold2_tpu/models/trunk.py:91-166``) as
``parallel/sharding.py``'s ``shard_pair``/``shard_msa`` checks: the pair
grid is ``(b, N/spr, N/spc, D)`` (rows over ``sp`` on a 1D mesh), the MSA
grid replicated, or with ``msa_row_shard`` this rank's ``msa_rows.per``
rows of it (``msa_rows``, a ``sharding.RowBlock``: over ``sp`` on a 1D
mesh, ``spr`` on a grid mesh; the model passes it). The pair axial passes
run sharded (``grid_parallel`` required on a grid mesh, as JAX's engine
requires it).

- A replicated MSA: the MSA stream, its tied rows (K2) and the
  feedforwards run locally; the pair<-MSA pass is local (its keys, the
  MSA, are replicated); the MSA<-pair pass runs K1 with lse over the local
  pair keys and merges across the ranks
  (``Attention.forward_sharded_context``).
- Row-sharded MSA (``msa_rows``): the MSA's column pass trades its row
  block for a column block by an all_to_all over the row axis; its tied
  row pass runs K2's split route with the logits all-reduced over the row
  axis (``Attention`` ``rows=``), its untied one and the feedforward run
  locally; pair<-MSA attends the MSA gathered over the row axis, padding
  dropped, so the compressed pass's key groups are JAX's; MSA<-pair
  gathers this rank's queries over the row axis, takes K1's lse partials
  over the local pair keys and merges them so each rank keeps its rows
  (:meth:`TrunkLayer._cross_row_sharded`).

With ``context_parallel`` ("ring" or "ulysses") on a 1D mesh both cross
passes take JAX's context-parallel route instead
(``Attention.forward_context_parallel``; not the compressed pair<-MSA
pass, as in JAX), on the whole MSA (a row-sharded one gathered first). The
loop and scanned engines train on a rank's blocks, with and without ``remat``:
every sharded route is differentiable (``parallel/sharding.py``'s rule for
the sharded backward), and remat's recompute replays a layer's forward
collectives in the same order on every rank, since every rank runs the
same graph, under the mesh and kernel policy of the forward
(``remat_call``). The reversible engine refuses the three flags, as JAX's
does, and runs on a ``(dp, sp)`` mesh with the same routes
(``models/reversible.py``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from alphafold2_tpu_torch.observe.numerics import tag
from alphafold2_tpu_torch.ops.attention import (
    Attention, AxialAttention, DropoutKey, FeedForward, child_key,
)
from alphafold2_tpu_torch.ops.layers import LayerNorm
from alphafold2_tpu_torch.ops import kernels as kernel_policy
from alphafold2_tpu_torch.parallel.sharding import (
    SEQ_AXIS, RowBlock, active_mesh, all_gather, axis_names, shard_msa, shard_pair, use_mesh,
)


class TrunkLayer(nn.Module):
    """One depth step: axial self-attention on both streams, pair<->MSA
    cross-attention, then GEGLU feedforwards. All residual, all pre-LN.
    ``cross_attn_compress_ratio`` above 1 compresses the MSA keys and
    values of the pair<-MSA pass (``ops/attention.py``)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 gelu_exact: bool = False, msa_tie_row_attn: bool = False,
                 sparse_attn: bool = False, seq_len: Optional[int] = None,
                 sparse_config=None, attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 cross_attn_compress_ratio: int = 1, grid_parallel: bool = False,
                 context_parallel: Optional[str] = None):
        super().__init__()
        for name in ("pair_axial_norm", "msa_axial_norm", "pair_cross_norm",
                     "pair_cross_ctx_norm", "msa_cross_norm",
                     "msa_cross_ctx_norm", "pair_ff_norm", "msa_ff_norm"):
            self.add_module(name, LayerNorm(dim))
        self.pair_axial = AxialAttention(dim, heads, dim_head, sparse_attn=sparse_attn,
                                         seq_len=seq_len, sparse_config=sparse_config,
                                         dropout=attn_dropout, pair_grid=True,
                                         grid_parallel=grid_parallel)
        self.msa_axial = AxialAttention(dim, heads, dim_head, tie_row_attn=msa_tie_row_attn,
                                        dropout=attn_dropout)
        # KV compression in the pair<-MSA pass only, as JAX builds it (:124)
        self.pair_from_msa = Attention(dim, heads, dim_head, dropout=attn_dropout,
                                       compress_ratio=cross_attn_compress_ratio,
                                       context_parallel=context_parallel)
        self.msa_from_pair = Attention(dim, heads, dim_head, dropout=attn_dropout,
                                       context_parallel=context_parallel)
        self.pair_ff = FeedForward(dim, gelu_exact=gelu_exact, dropout=ff_dropout)
        self.msa_ff = FeedForward(dim, gelu_exact=gelu_exact, dropout=ff_dropout)

    def forward(
        self,
        x: torch.Tensor,  # (B, N, N, D) pair grid
        m: Optional[torch.Tensor],  # (B, M, Nm, D) MSA grid or None
        pair_mask: Optional[torch.Tensor] = None,  # (B, N, N)
        msa_mask: Optional[torch.Tensor] = None,  # (B, M, Nm)
        key: Optional[DropoutKey] = None,
        msa_rows: Optional[RowBlock] = None,  # msa_row_shard: m is this rank's rows
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        mesh = active_mesh()
        rows = msa_rows if mesh is not None else None
        x = x + self.pair_axial(self.pair_axial_norm(x), mask=pair_mask,
                                key=child_key(key, "pair_axial"))
        x = shard_pair(x)
        if m is not None:
            m = m + self.msa_axial(self.msa_axial_norm(m), mask=msa_mask,
                                   key=child_key(key, "msa_axial"), rows=rows)
            m = shard_msa(m, x.shape[0], rows=rows)
            b, n, n2, d = x.shape
            bm, mm, nm, _ = m.shape
            x_flat = x.reshape(b, n * n2, d)
            m_flat = m.reshape(bm, mm * nm, d)
            x_mask = pair_mask.reshape(b, n * n2) if pair_mask is not None else None
            m_mask = msa_mask.reshape(bm, mm * nm) if msa_mask is not None else None
            # JAX's context-parallel route: a 1D mesh's sp axis, uncompressed keys
            cp = (mesh is not None and SEQ_AXIS in axis_names(mesh)
                  and self.pair_from_msa.context_parallel is not None)
            if rows is not None and cp:
                x_flat, m_flat = self._cross_context_parallel_rows(
                    x_flat, m_flat, x_mask, m_mask, mesh, rows, nm, key)
            elif rows is not None:
                x_flat, m_flat = self._cross_row_sharded(x_flat, m_flat, x_mask, m_mask, mesh,
                                                         rows, nm, key)
            else:
                x_flat, m_flat = self._cross(x_flat, m_flat, x_mask, m_mask, mesh, cp, key)
            x = shard_pair(x_flat.reshape(b, n, n2, d))
            m = shard_msa(m_flat.reshape(bm, mm, nm, d), b, rows=rows)
        x = x + self.pair_ff(self.pair_ff_norm(x), key=child_key(key, "pair_ff"))
        x = shard_pair(x)
        if m is not None:
            m = m + self.msa_ff(self.msa_ff_norm(m), key=child_key(key, "msa_ff"))
            m = shard_msa(m, x.shape[0], rows=rows)
        return x, m

    def _cross(self, x_flat, m_flat, x_mask, m_mask, mesh, cp, key):
        """The two cross passes on a whole (replicated) MSA."""
        if cp and self.pair_from_msa.compress_ratio == 1:
            x_flat = x_flat + self.pair_from_msa.forward_context_parallel(
                self.pair_cross_norm(x_flat), self.pair_cross_ctx_norm(m_flat), mesh,
                context_mask=m_mask, queries_sharded=True)
        else:  # the MSA keys are replicated: local under a mesh too
            x_flat = x_flat + self.pair_from_msa(
                self.pair_cross_norm(x_flat),
                context=self.pair_cross_ctx_norm(m_flat),
                mask=x_mask, context_mask=m_mask, key=child_key(key, "pair_from_msa"),
            )
        if mesh is None:
            m_flat = m_flat + self.msa_from_pair(
                self.msa_cross_norm(m_flat),
                context=self.msa_cross_ctx_norm(x_flat),
                mask=m_mask, context_mask=x_mask, key=child_key(key, "msa_from_pair"),
            )
        elif cp:
            m_flat = m_flat + self.msa_from_pair.forward_context_parallel(
                self.msa_cross_norm(m_flat), self.msa_cross_ctx_norm(x_flat), mesh,
                context_mask=x_mask, queries_sharded=False)
        else:  # the pair keys are this rank's block: K1 with lse, merged
            m_flat = m_flat + self.msa_from_pair.forward_sharded_context(
                self.msa_cross_norm(m_flat), self.msa_cross_ctx_norm(x_flat), mesh,
                mask=m_mask, context_mask=x_mask)
        return x_flat, m_flat

    def _cross_context_parallel_rows(self, x_flat, m_flat, x_mask, m_mask, mesh, rows, nm, key):
        """JAX's context-parallel cross passes, which take the whole MSA,
        with its rows sharded: the rows gathered over the row axis (padding
        dropped), the replicated passes (:meth:`_cross`), then this rank's
        rows of the result (its padded rows zero: they abstain)."""
        b, d = m_flat.shape[0], m_flat.shape[-1]

        def gather(t):
            return all_gather(t, mesh, rows.axis, dim=1)[:, :rows.total * nm]

        whole = gather(m_flat)
        whole_mask = gather(m_mask.to(torch.uint8)).bool() if m_mask is not None else None
        x_flat, whole = self._cross(x_flat, whole, x_mask, whole_mask, mesh, True, key)
        mine = rows.take(whole.view(b, rows.total, nm, d))
        return x_flat, mine.reshape(b, rows.per * nm, d)

    def _cross_row_sharded(self, x_flat, m_flat, x_mask, m_mask, mesh, rows, nm, key):
        """The two cross passes with the MSA's rows sharded (``rows``):
        pair<-MSA gathers the normed MSA over the row axis and drops the
        padded rows, so its keys, and the compressed pass's key groups, are
        JAX's; MSA<-pair gathers this rank's MSA queries over the row axis,
        takes K1's lse partials over the local pair keys and merges them so
        that each rank keeps its rows (``Attention.forward_sharded_context``)."""
        whole = rows.total * nm

        def gather(t):
            return all_gather(t, mesh, rows.axis, dim=1)[:, :whole]

        ctx = gather(self.pair_cross_ctx_norm(m_flat))
        ctx_mask = gather(m_mask.to(torch.uint8)).bool() if m_mask is not None else None
        x_flat = x_flat + self.pair_from_msa(
            self.pair_cross_norm(x_flat), context=ctx, mask=x_mask, context_mask=ctx_mask,
            key=child_key(key, "pair_from_msa"))
        del ctx
        m_flat = m_flat + self.msa_from_pair.forward_sharded_context(
            self.msa_cross_norm(m_flat), self.msa_cross_ctx_norm(x_flat), mesh, mask=m_mask,
            context_mask=x_mask, rows=rows)
        return x_flat, m_flat


# the matmuls whose outputs each remat policy keeps
_SAVED_DOTS = {"dots": ("mm", "addmm", "bmm", "baddbmm"), "dots_no_batch": ("mm", "addmm")}


def resolve_remat_policy(name: Optional[str]):
    """A config-level policy name -> the ``context_fn`` that
    ``torch.utils.checkpoint`` takes, or None for None/"nothing" (save
    nothing: the whole layer is recomputed). Unknown names raise."""
    if name is None or name == "nothing":
        return None
    if name not in _SAVED_DOTS:
        raise ValueError(
            f"unknown remat_policy {name!r}; have {[None, 'nothing', *_SAVED_DOTS]}")
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    ops = [getattr(torch.ops.aten, op).default for op in _SAVED_DOTS[name]]
    return functools.partial(create_selective_checkpoint_contexts, ops)


def remat_call(fn, context_fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward (under
    ``context_fn``'s policy when one is given); plain under no gradient.
    The recompute runs under the device mesh and the kernel policy active
    now: it runs where autograd runs the backward, which may be another
    thread (the card's) and outside the step's ``use_mesh``, and must
    replay the forward's route and collectives exactly."""
    if not torch.is_grad_enabled():
        return fn(*args)
    mesh, policy = active_mesh(), kernel_policy.current_policy()

    def replayed(*a):
        with use_mesh(mesh), kernel_policy.use_kernel_policy(policy):
            return fn(*a)

    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(replayed, *args, use_reentrant=False, **kw)


def stack_parameters(module: nn.Module, depth: int) -> nn.Module:
    """Give every parameter of ``module`` a leading depth axis in place (each
    slice a copy of its value), as flax's scanned and vmapped inits stack
    them; returns ``module``, whose ``forward`` then runs on one depth
    slice through :func:`depth_slice`."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        stacked = p.detach()[None].repeat(depth, *([1] * p.dim()))
        setattr(module.get_submodule(owner), leaf, nn.Parameter(stacked))
    return module


def depth_slice(names: Sequence[str], stacked: Sequence[torch.Tensor], i: int) -> dict:
    """Depth slice ``i`` of stacked parameters, by name, for
    ``torch.func.functional_call``."""
    return {n: p[i] for n, p in zip(names, stacked)}


class ScanBody(nn.Module):
    """The scanned engine (JAX's ``_ScanBody`` under ``nn.scan``): ``layer``
    is one TrunkLayer with depth-stacked parameters; the masks are the same
    at every step."""

    def __init__(self, depth: int, remat: bool, context_fn, **layer_kwargs):
        super().__init__()
        self.depth, self.remat, self.context_fn = depth, remat, context_fn
        self.layer = stack_parameters(TrunkLayer(**layer_kwargs), depth)

    def forward(self, x, m, pair_mask=None, msa_mask=None,
                key: Optional[DropoutKey] = None, msa_rows: Optional[RowBlock] = None):
        names, stacked = zip(*self.layer.named_parameters())
        key = child_key(key, "layer")

        def step(i, x, m):
            return torch.func.functional_call(
                self.layer, depth_slice(names, stacked, i),
                (x, m, pair_mask, msa_mask, None if key is None else key.at(i), msa_rows))

        for i in range(self.depth):
            if self.remat:
                x, m = remat_call(functools.partial(step, i), self.context_fn, x, m)
            else:
                x, m = step(i, x, m)
        return x, m


class Trunk(nn.Module):
    """``depth`` layers under one of the three engines (module docstring).
    ``sparse_self_attn`` is one bool for every layer or a tuple of one per
    layer; ``seq_len`` and ``sparse_config`` go to the sparse layers;
    ``cross_attn_compress_ratio`` to every engine's pair<-MSA pass;
    ``dtype`` is the compute dtype, which only the reversible engine needs
    (its carry is float32)."""

    def __init__(self, dim: int, depth: int = 6, heads: int = 8,
                 dim_head: int = 64, gelu_exact: bool = False,
                 msa_tie_row_attn: bool = False, remat: bool = False,
                 remat_policy: Optional[str] = None,
                 reversible: bool = False, scan_layers: bool = False,
                 sparse_self_attn: Union[bool, Sequence[bool]] = False,
                 seq_len: Optional[int] = None, sparse_config=None,
                 msa_row_shard: bool = False, grid_parallel: bool = False,
                 context_parallel: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 cross_attn_compress_ratio: int = 1):
        super().__init__()
        sparse = sparse_self_attn
        if not isinstance(sparse, (tuple, list)):
            sparse = (sparse,) * depth
        if len(sparse) != depth:
            raise ValueError(f"sparse_self_attn tuple has {len(sparse)} entries "
                             f"for depth {depth}")
        # validate eagerly, as JAX does: a policy with remat off, or with the
        # reversible engine (which never applies one), would be a silent
        # no-op. "nothing" spells the default and is always allowed
        context_fn = resolve_remat_policy(remat_policy)
        if context_fn is not None and (not remat or reversible):
            raise ValueError(
                f"remat_policy={remat_policy!r} has no effect "
                + ("with the reversible engine (it has its own O(1)-memory "
                   "schedule and never applies checkpoint policies)"
                   if reversible else "without remat=True"))
        layer_kwargs = dict(dim=dim, heads=heads, dim_head=dim_head, gelu_exact=gelu_exact,
                            msa_tie_row_attn=msa_tie_row_attn, seq_len=seq_len,
                            sparse_config=sparse_config, attn_dropout=attn_dropout,
                            ff_dropout=ff_dropout,
                            cross_attn_compress_ratio=cross_attn_compress_ratio)
        self.depth = depth
        if reversible:
            from alphafold2_tpu_torch.models.reversible import ReversibleTrunk

            if len(set(sparse)) > 1:
                raise ValueError(
                    "the reversible engine scans one stacked layer; per-layer "
                    f"sparse_self_attn={tuple(sparse)} needs the python loop")
            for flag, name, why in (
                    (context_parallel is not None, "context_parallel",
                     "its cross-attention runs dense per device"),
                    (msa_row_shard, "msa_row_shard", "its MSA streams are replicated"),
                    (grid_parallel, "grid_parallel",
                     "its axial passes run dense, so the memory benefit would be lost")):
                if flag:
                    raise ValueError(f"{name} is not supported by the reversible engine "
                                     f"({why}); use remat=True with it")
            self.engine = "reversible"
            self.reversible = ReversibleTrunk(depth=depth, sparse_attn=bool(sparse[0]),
                                              dtype=dtype, **layer_kwargs)
            return
        self.remat, self.context_fn = remat, context_fn
        layer_kwargs.update(grid_parallel=grid_parallel, context_parallel=context_parallel)
        if scan_layers:
            if len(set(sparse)) > 1:
                raise ValueError(
                    "scan_layers needs homogeneous layers; per-layer "
                    f"sparse_self_attn={tuple(sparse)} requires the python loop")
            self.engine = "scan"
            self.scan = ScanBody(depth, remat, context_fn, sparse_attn=bool(sparse[0]),
                                 **layer_kwargs)
            return
        self.engine = "loop"
        for i in range(depth):
            self.add_module(f"layer_{i}", TrunkLayer(sparse_attn=bool(sparse[i]),
                                                     **layer_kwargs))

    def forward(self, x, m, pair_mask=None, msa_mask=None,
                key: Optional[DropoutKey] = None, msa_rows: Optional[RowBlock] = None):
        """The trunk over the streams; ``key`` (the trunk's own,
        ``trunk``) makes dropout active; ``msa_rows`` (``msa_row_shard``
        under a mesh) says which rows of the MSA grid ``m`` holds."""
        if self.engine != "loop":  # the module is named after its engine
            rows = {"msa_rows": msa_rows} if self.engine == "scan" else {}
            x, m = getattr(self, self.engine)(x, m, pair_mask, msa_mask,
                                              key=child_key(key, self.engine), **rows)
            x = tag("trunk.out.pair", x)
            if m is not None:
                m = tag("trunk.out.msa", m)
            return x, m
        for i in range(self.depth):
            layer = getattr(self, f"layer_{i}")
            args = (x, m, pair_mask, msa_mask, child_key(key, f"layer_{i}"), msa_rows)
            if self.remat:
                x, m = remat_call(layer, self.context_fn, *args)
            else:
                x, m = layer(*args)
            x = tag(f"trunk.layer_{i}.pair", x)
            if m is not None:
                m = tag(f"trunk.layer_{i}.msa", m)
        return x, m
