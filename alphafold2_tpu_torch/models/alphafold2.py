"""The Alphafold2 distogram model: embeddings, MSA or PLM stream, templates,
trunk, head.

Port of ``alphafold2_tpu/models/alphafold2.py``: the outer-sum pair grid
with axial positional embeddings and an AND-combined pair mask (:187-201),
the MSA stream with per-position and per-row embeddings (:203-215) or, in
its place, the ``embedds`` (PLM) grid: ``embedd_project`` of the residue
embeddings outer-summed into an (N, N) grid masked by the pair mask
(:216-223; an ``msa`` wins), the template stream (:228-285) with its
:class:`TemplateBlock`\\ s (:44-99) and, for templates with sidechains,
the ``SE3TemplateEmbedder`` (``models/se3.py``), the trunk under any of its
engines (``remat`` with ``remat_policy``, ``reversible``, ``scan_layers``;
block-sparse pair attention with ``sparse_self_attn``, ``sparse_config``
and ``seq_len=max_seq_len``, as :288-312 passes them; ``msa_row_shard``,
``grid_parallel`` and ``context_parallel`` go to the trunk, which applies
them under an active mesh; ``cross_attn_compress_ratio`` compresses the
pair<-MSA pass's keys and values, :129 and :300), and the symmetrized
distogram head (:314-318), whose LayerNorm output is cast to the compute
dtype (the reversible engine returns float32 streams).

Under an active device mesh (``parallel/sharding.py use_mesh``) the
forward takes this rank's ``dp`` slice of the batch and returns this rank's
``(b, N/spr, N/spc, K)`` block of the logits (rows over ``sp`` on a 1D
mesh; ``sharding.gather_pair`` assembles them): the outer-sum embedding,
the axial positional embeddings and the pair mask are built on the local
block from the token embeddings, which every rank computes whole; the MSA
stream (or the ``embedds`` grid) is replicated or, with ``msa_row_shard``,
this rank's block of its rows (``sharding.msa_row_block``: ``sp`` on a 1D
mesh, ``spr`` on a grid mesh): the forward takes the whole MSA, as it
takes the whole sequence, and embeds its own ``ceil(M / n)`` rows with
their global row indices (``msa_num_pos_emb``), the last ranks' tails
padded with rows the mask marks absent (a mask is made where none is
given); the PLM grid's block is its rows ``pe[rows] + pe`` of the pair
rows' split; the symmetrisation ``x + x^T`` takes the transposed
block from the ranks that hold it (``sharding.transpose_pair``: nothing
larger than the local block moves; under autograd its backward is the same
transpose of the cotangent), then the head's LayerNorm and
projection run locally. With templates on a mesh the embeddings and the
template blocks run on this rank's ``dp`` slice of the whole pair grid,
replicated over the sequence axes (the meshless template stream's memory
on every rank), and the rank's block of the result (and of the pair mask)
goes to the trunk; the template parameters' gradients are then partials,
as any replicated tensor's, that ``train/loop.py reduce_gradients`` sums
(JAX's template stream runs under its mesh, ``shard_pair`` after it,
:278-285). The numerics tag ``embed.pair`` there holds the whole grid of
the slice. ``dtype`` is the
compute dtype; parameters stay float32. ``attn_dropout`` and
``ff_dropout`` are active when the forward is given a ``dropout_key``
(``ops/attention.py``), as a training step gives one; the trunk draws
under ``trunk/...``, template block ``i`` under ``template_block_{i}/...``
(at ``attn_dropout``, its feedforward too, as in JAX). The numerics tags
``embed.pair``, ``embed.msa`` and ``distogram.logits`` sit where JAX's do
(:197, :225, :318).

The parameter set: flax creates ``embedd_project``, the template modules
and ``template_sidechain_emb`` only when ``init`` sees those inputs; here
the constructor builds them, and the same set JAX's init builds for the
same inputs: ``num_embedds`` (the embedds width) builds ``embedd_project``
in place of the MSA's ``msa_pos_emb`` and ``msa_num_pos_emb`` (None: the
MSA tables, no ``embedd_project``); ``max_num_templates`` above 0 builds the template modules
(0: none); with templates, ``use_se3_template_embedder`` builds
``template_sidechain_emb`` (JAX builds it when sidechains are given and the
flag is on, so a tree from an init without sidechains wants it False). An
input whose modules were not built raises ``ValueError``; sidechains with
the flag off are ignored, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.models.trunk import Trunk
from alphafold2_tpu_torch.observe.numerics import tag
from alphafold2_tpu_torch.ops.attention import (
    Attention, AxialAttention, DropoutKey, FeedForward, child_key,
)
from alphafold2_tpu_torch.ops.layers import Dense, LayerNorm
from alphafold2_tpu_torch.parallel.sharding import (
    active_mesh, check_divisible, msa_row_block, pair_layout, shard_msa, shard_pair,
    transpose_pair,
)
from alphafold2_tpu_torch.utils.structure import get_bucketed_distance_matrix


class TemplateBlock(nn.Module):
    """One template-attention layer: pair axial self-attention with no
    residual (as the reference's :568), template axial self-attention on
    (B*T, N, N, D), attention along the template axis (each pair position
    attends over its 1+T tokens [x_ij, t^1_ij .. t^T_ij] on (B*N*N, 1+T, D),
    masked by the concatenated pair and template masks where both are
    given), then the template feedforward; all pre-LN, the last three
    residual. Every attention runs K1 (K3a/K3b under gradient)."""

    def __init__(self, dim: int, heads: int, dim_head: int, dropout: float = 0.0,
                 gelu_exact: bool = False):
        super().__init__()
        for name in ("pair_norm", "template_norm", "template_axis_norm", "template_ff_norm"):
            self.add_module(name, LayerNorm(dim))
        self.pair_axial = AxialAttention(dim, heads, dim_head, dropout=dropout)
        self.template_axial = AxialAttention(dim, heads, dim_head, dropout=dropout)
        self.template_axis_attn = Attention(dim, heads, dim_head, dropout=dropout)
        self.template_ff = FeedForward(dim, gelu_exact=gelu_exact, dropout=dropout)

    def forward(self, x, t, pair_mask=None, t_mask=None, key: Optional[DropoutKey] = None):
        # x: (B, N, N, D); t: (B, T, N, N, D); t_mask: (B, T, N, N)
        b, n, _, d = x.shape
        nt = t.shape[1]
        x = self.pair_axial(self.pair_norm(x), mask=pair_mask,
                            key=child_key(key, "pair_axial"))
        t_flat = t.reshape(b * nt, n, n, d)
        tm_flat = t_mask.reshape(b * nt, n, n) if t_mask is not None else None
        t_flat = t_flat + self.template_axial(self.template_norm(t_flat), mask=tm_flat,
                                              key=child_key(key, "template_axial"))
        t = t_flat.reshape(b, nt, n, n, d)

        y = torch.cat([x[:, None], t], dim=1).movedim(1, 3).reshape(b * n * n, 1 + nt, d)
        y_mask = None
        if t_mask is not None and pair_mask is not None:
            ym = torch.cat([pair_mask[:, None], t_mask], dim=1)
            y_mask = ym.movedim(1, 3).reshape(b * n * n, 1 + nt)
        y = y + self.template_axis_attn(self.template_axis_norm(y), mask=y_mask,
                                        key=child_key(key, "template_axis_attn"))
        y = y.reshape(b, n, n, 1 + nt, d).movedim(3, 1)
        x, t = y[:, 0], y[:, 1:]
        t = t + self.template_ff(self.template_ff_norm(t), key=child_key(key, "template_ff"))
        return x, t


class Alphafold2(nn.Module):
    def __init__(
        self,
        dim: int,
        max_seq_len: int = 2048,
        depth: int = 6,
        heads: int = 8,
        dim_head: int = 64,
        num_tokens: int = constants.NUM_AMINO_ACIDS,
        max_num_msas: int = constants.MAX_NUM_MSA,
        gelu_exact: bool = False,
        msa_tie_row_attn: bool = False,
        dtype: torch.dtype = torch.float32,
        attn_dropout: float = 0.0,
        ff_dropout: float = 0.0,
        sparse_self_attn: Union[bool, Sequence[bool]] = False,
        sparse_config=None,
        remat: bool = False,
        remat_policy: Optional[str] = None,
        reversible: bool = False,
        scan_layers: bool = False,
        msa_row_shard: bool = False,
        grid_parallel: bool = False,
        context_parallel: Optional[str] = None,
        num_embedds: Optional[int] = None,
        max_num_templates: int = 0,
        template_attn_depth: int = 2,
        use_se3_template_embedder: bool = True,
        cross_attn_compress_ratio: int = 1,
    ):
        super().__init__()
        self.dim = dim
        self.max_seq_len = max_seq_len
        self.max_num_msas = max_num_msas
        self.max_num_templates = max_num_templates
        self.msa_row_shard = msa_row_shard
        self.dtype = dtype
        self.token_emb = nn.Embedding(num_tokens, dim)
        self.pos_emb = nn.Embedding(max_seq_len, dim)
        self.pos_emb_ax = nn.Embedding(max_seq_len, dim)
        self.msa_pos_emb = self.msa_num_pos_emb = self.embedd_project = None
        if num_embedds is None:
            self.msa_pos_emb = nn.Embedding(max_seq_len, dim)
            self.msa_num_pos_emb = nn.Embedding(max_num_msas, dim)
        self.trunk = Trunk(dim, depth, heads, dim_head, gelu_exact=gelu_exact,
                           msa_tie_row_attn=msa_tie_row_attn,
                           sparse_self_attn=sparse_self_attn, seq_len=max_seq_len,
                           sparse_config=sparse_config, remat=remat,
                           remat_policy=remat_policy, reversible=reversible,
                           scan_layers=scan_layers, msa_row_shard=msa_row_shard,
                           grid_parallel=grid_parallel, context_parallel=context_parallel,
                           dtype=dtype, attn_dropout=attn_dropout, ff_dropout=ff_dropout,
                           cross_attn_compress_ratio=cross_attn_compress_ratio)
        self.distogram_norm = LayerNorm(dim)
        self.distogram_proj = Dense(dim, constants.DISTOGRAM_BUCKETS)
        if num_embedds is not None:
            self.embedd_project = Dense(num_embedds, dim)
        self.template_attn_depth = template_attn_depth if max_num_templates > 0 else 0
        self.template_sidechain_emb = None
        if max_num_templates > 0:
            if use_se3_template_embedder:
                from alphafold2_tpu_torch.models.se3 import SE3TemplateEmbedder

                self.template_sidechain_emb = SE3TemplateEmbedder(dim)
            self.template_dist_emb = nn.Embedding(constants.DISTOGRAM_BUCKETS, dim)
            self.template_num_pos_emb = nn.Embedding(max_num_templates, dim)
            self.template_pos_emb = nn.Embedding(max_seq_len, dim)
            self.template_pos_emb_ax = nn.Embedding(max_seq_len, dim)
            for i in range(template_attn_depth):
                self.add_module(f"template_block_{i}", TemplateBlock(
                    dim, heads, dim_head, dropout=attn_dropout, gelu_exact=gelu_exact))

    def forward(
        self,
        seq: torch.Tensor,  # (B, N) int tokens
        msa: Optional[torch.Tensor] = None,  # (B, M, Nm) int tokens
        mask: Optional[torch.Tensor] = None,  # (B, N) bool
        msa_mask: Optional[torch.Tensor] = None,  # (B, M, Nm) bool
        templates_seq: Optional[torch.Tensor] = None,  # (B, T, N) int
        templates_dist: Optional[torch.Tensor] = None,  # (B, T, N, N) int buckets
        templates_mask: Optional[torch.Tensor] = None,  # (B, T, N) bool
        templates_coors: Optional[torch.Tensor] = None,  # (B, T, N, 3)
        templates_sidechains: Optional[torch.Tensor] = None,  # (B, T, N, 3)
        embedds: Optional[torch.Tensor] = None,  # (B, N, num_embedds)
        dropout_key: Optional[DropoutKey] = None,
    ) -> torch.Tensor:
        b, n = seq.shape
        if n > self.max_seq_len:
            raise ValueError(
                f"sequence length {n} exceeds max_seq_len {self.max_seq_len}"
            )
        if msa is not None:
            if msa.shape[-1] > self.max_seq_len:
                raise ValueError(f"MSA length {msa.shape[-1]} exceeds "
                                 f"max_seq_len {self.max_seq_len}")
            if msa.shape[1] > self.max_num_msas:
                raise ValueError(f"MSA depth {msa.shape[1]} exceeds "
                                 f"max_num_msas {self.max_num_msas}")
        if templates_seq is not None:
            if self.max_num_templates == 0:
                raise ValueError("templates given to a model built without template "
                                 "modules (max_num_templates=0)")
            if templates_seq.shape[1] > self.max_num_templates:
                raise ValueError(f"{templates_seq.shape[1]} templates exceed "
                                 f"max_num_templates {self.max_num_templates}")
        dt = self.dtype
        n_range = torch.arange(n, device=seq.device)
        mesh = active_mesh()
        e = self.token_emb(seq).to(dt)
        e_rows = e_cols = e
        r_range = c_range = n_range
        m_rows = m_cols = mask
        # templates on a mesh run on this dp slice's whole grid, the block taken after
        whole = mesh is not None and templates_seq is not None
        if mesh is not None:
            check_divisible(n, mesh)
            lay = pair_layout(mesh)
            p_rows, p_cols = lay.rows(n), lay.cols(n)
            if not whole:  # this rank's block of the outer sum
                e_rows, e_cols = e[:, p_rows], e[:, p_cols]
                r_range, c_range = n_range[p_rows], n_range[p_cols]
                if mask is not None:
                    m_rows, m_cols = mask[:, p_rows], mask[:, p_cols]

        x = e_rows[:, :, None, :] + e_cols[:, None, :, :]
        x = (x + self.pos_emb(r_range).to(dt)[None, :, None, :]
             + self.pos_emb_ax(c_range).to(dt)[None, None, :, :])
        x = tag("embed.pair", x if whole else shard_pair(x, n))
        pair_mask = m_rows[:, :, None] & m_cols[:, None, :] if mask is not None else None

        m = m_mask = rows = None
        if msa is not None:
            if self.msa_pos_emb is None:
                raise ValueError("an msa given to a model built for embedds (num_embedds "
                                 "set: no MSA embeddings)")
            nm, mm = msa.shape[-1], msa.shape[1]
            index = torch.arange(mm, device=seq.device)
            if mesh is not None and self.msa_row_shard:  # this rank's rows
                rows = msa_row_block(mm, mesh)
                if rows.pad and msa_mask is None:
                    msa_mask = torch.ones(msa.shape, dtype=torch.bool, device=seq.device)
                msa, index = rows.take(msa), rows.take(index, 0, fill=mm - 1)
                msa_mask = rows.take(msa_mask, fill=False) if msa_mask is not None else None
            m = self.token_emb(msa).to(dt)
            m = m + self.msa_pos_emb(torch.arange(nm, device=seq.device)).to(dt)[None, None]
            m = m + self.msa_num_pos_emb(index).to(dt)[None, :, None]
            m_mask = msa_mask
        elif embedds is not None:
            if self.embedd_project is None:
                raise ValueError("embedds given to a model built without embedd_project "
                                 "(num_embedds=None)")
            pe = self.embedd_project(embedds.to(dt))
            pe_rows, mask_rows = pe, mask
            if mesh is not None and self.msa_row_shard:  # this rank's rows of the grid
                rows = msa_row_block(n, mesh)
                if rows.pad and mask is None:
                    mask = torch.ones((b, n), dtype=torch.bool, device=seq.device)
                pe_rows = rows.take(pe)
                mask_rows = rows.take(mask, fill=False) if mask is not None else None
            m = pe_rows[:, :, None, :] + pe[:, None, :, :]  # (B, N or its rows, N, D)
            if mask is not None:
                m_mask = mask_rows[:, :, None] & mask[:, None, :]
        if m is not None:
            m = tag("embed.msa", shard_msa(m, b, rows=rows))

        if templates_seq is not None:
            x = self._templates(x, pair_mask, n_range, templates_seq, templates_dist,
                                templates_mask, templates_coors, templates_sidechains,
                                dropout_key)
            if mesh is not None:  # this rank's block of the templated grid
                x = shard_pair(x[:, p_rows, p_cols], n)
                pair_mask = pair_mask[:, p_rows, p_cols] if pair_mask is not None else None

        x, m = self.trunk(x, m, pair_mask=pair_mask, msa_mask=m_mask,
                          key=child_key(dropout_key, "trunk"), msa_rows=rows)

        xt = x.transpose(1, 2) if mesh is None else transpose_pair(x, n, mesh)
        x = 0.5 * (x + xt)
        logits = self.distogram_proj(self.distogram_norm(x).to(dt))
        return tag("distogram.logits", logits.float())

    def _templates(self, x, pair_mask, n_range, templates_seq, templates_dist,
                   templates_mask, templates_coors, templates_sidechains, dropout_key):
        """The template stream (JAX :228-285): embed the templates, then run
        the template blocks; returns the pair grid."""
        if templates_coors is None:
            raise ValueError("template residue coordinates must be supplied via "
                             "`templates_coors`")
        b, nt, n = templates_seq.shape
        dt, d = self.dtype, self.dim
        if templates_dist is None:
            t_valid = (templates_mask if templates_mask is not None else
                       torch.ones((b, nt, n), dtype=torch.bool, device=x.device))
            templates_dist = get_bucketed_distance_matrix(
                templates_coors, t_valid, constants.DISTOGRAM_BUCKETS).clamp_min(0)

        t_seq = self.token_emb(templates_seq).to(dt)  # (B, T, N, D)
        if templates_sidechains is not None and self.template_sidechain_emb is not None:
            t_seq = self.template_sidechain_emb(
                t_seq.reshape(b * nt, n, d), templates_sidechains.reshape(b * nt, n, 3),
                templates_coors.reshape(b * nt, n, 3),
                mask=(templates_mask.reshape(b * nt, n) if templates_mask is not None
                      else None),
            ).reshape(b, nt, n, d)

        t = (t_seq[:, :, :, None, :] + t_seq[:, :, None, :, :]
             + self.template_dist_emb(templates_dist).to(dt))
        t = t + self.template_num_pos_emb(
            torch.arange(nt, device=x.device)).to(dt)[None, :, None, None]
        t = (t + self.template_pos_emb(n_range).to(dt)[None, None, :, None]
             + self.template_pos_emb_ax(n_range).to(dt)[None, None, None, :])
        t_mask = None
        if templates_mask is not None:
            t_mask = templates_mask[..., :, None] & templates_mask[..., None, :]
        for i in range(self.template_attn_depth):
            x, t = getattr(self, f"template_block_{i}")(
                x, t, pair_mask, t_mask, key=child_key(dropout_key, f"template_block_{i}"))
        return x
