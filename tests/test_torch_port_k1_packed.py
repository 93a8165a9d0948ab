"""K1's two Hopper redesigns of the forward on the CPU: the plain versions
of their walks held against the JAX package.

1. Short problems (the template axis, the MSA column pass): the packed
   kernel (``csrc/fused_attention_packed_sm90.cuh``) cuts the problems of
   one head into tiles of G consecutive ones
   (G = min(2 * (64 // nq), 128 // nk)) and takes each tile's softmax at
   once under a block-diagonal mask.
   ``axial.packed_walk_reference`` (that walk, tile by tile) is held
   against JAX's ``fused_attention`` (run on the CPU as
   tests/test_torch_port_k1_split.py runs it): f32 at 1e-5 on rows with a
   valid key, bf16 within chip_smoke.py's bf16 bound, at n 5, 16 and 33,
   B*n not a multiple of G, ragged key masks, masked queries, a problem
   with no valid key and nq != nk; its lse against the port's
   ``fused_attention_lse_reference``. ``axial.packed_plan`` is held to the
   header's constants and to the shapes of the port's paths, and refuses
   problems of 64 tokens or more and head dims it is not built for.
2. Head dims past 128 that are multiples of 64: the wrapper runs K1 on
   K2's Hopper walk with the head dim read as rows of 64 under tie scale 1.
   ``tied_row.hopper_walk_reference`` on ``axial.head_rows`` views (strided,
   no copy) is held against JAX's ``fused_attention`` at head dims 192, 256
   and 320.

The wrappers on CPU tensors launch nothing. Inputs are drawn with numpy
from seeds and handed to both frameworks."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops.pallas.axial import fused_attention as jax_fused
from alphafold2_tpu_torch.ops.cuda import axial, tied_row

ATOL = 1e-5
BF16_MAX_REL, BF16_L2_REL = 2**-6, 4e-3  # chip_smoke.py TOL["bfloat16"]
HEADER = (Path(axial.__file__).resolve().parents[2] / "csrc"
          / "fused_attention_packed_sm90.cuh")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# name: (b, h, nq, nk, d, mask kind); G = min(2 * (64 // nq), 128 // nk)
CASES = {
    "n5, B not a multiple of G": (53, 2, 5, 5, 16, "ragged"),  # G 24: tiles of 24, 24, 5
    "n16 masked queries": (19, 2, 16, 16, 8, "queries"),  # G 8
    "n33 ragged keys": (7, 1, 33, 33, 8, "ragged"),  # G 2
    "n5 a problem with no valid key": (30, 2, 5, 5, 16, "dead"),
    "nq 5, nk 9": (31, 2, 5, 9, 8, "ragged"),  # G 14
    "nq 13, nk 3": (20, 1, 13, 3, 8, "queries"),  # G 8
    "n5 unmasked": (27, 1, 5, 5, 16, None),
}


def _case(name, seed):
    """q, k, v (B, H, N, D) f32 numpy, q_mask, kv_mask (bool or None) and
    sm_scale of one named case."""
    b, h, nq, nk, d, kind = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (nq, nk, nk))
    if kind is None:
        return q, k, v, None, None, d**-0.5
    q_mask = np.ones((b, nq), bool)
    kv_mask = rng.random((b, nk)) > 0.25
    kv_mask[:, 0] = True
    if kind == "queries":
        q_mask = rng.random((b, nq)) > 0.3
    elif kind == "dead":
        kv_mask[[3, 17, 29]] = False  # problems with no valid key, in two tiles
        q_mask[5, 1:3] = False
    return q, k, v, q_mask, kv_mask, d**-0.5


def _jax(name, dtype, seed):
    q, k, v, qm, km, scale = _case(name, seed)
    jm = lambda m: None if m is None else jnp.asarray(m)
    out = jax_fused(*(jnp.asarray(a, dtype=dtype) for a in (q, k, v)), q_mask=jm(qm),
                    kv_mask=jm(km), sm_scale=scale)
    return np.asarray(out, dtype=np.float32)


def _torch(name, dtype, seed):
    q, k, v, qm, km, scale = _case(name, seed)
    tm = lambda m: None if m is None else torch.from_numpy(m)
    return (*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), tm(qm), tm(km), scale)


def _keyed(name):
    """(B, H, Nq, D) bool: entries of query rows that have a valid key (JAX
    averages the padding where none is; the kernels give 0)."""
    b, h, nq, _, d, _ = CASES[name]
    _, _, _, _, km, _ = _case(name, 0)
    keyed = np.ones(b, bool) if km is None else km.any(-1)
    return np.broadcast_to(keyed[:, None, None, None], (b, h, nq, d))


@pytest.mark.parametrize("name", list(CASES))
def test_packed_walk_matches_jax_f32(name):
    want = _jax(name, jnp.float32, seed=1)
    out, _ = axial.packed_walk_reference(*_torch(name, torch.float32, seed=1))
    rows = _keyed(name)
    np.testing.assert_allclose(out.numpy()[rows], want[rows], atol=ATOL)
    assert np.isfinite(out.numpy()).all()
    assert (out.numpy()[~rows] == 0).all()  # a row with no valid key gives exactly 0


@pytest.mark.parametrize("name", list(CASES))
def test_packed_walk_matches_jax_bf16(name):
    """bf16 operands: both round p to bf16 before P V and the output to
    bf16, the sums in another order, so the output is held to the card's
    bf16 bound."""
    want = _jax(name, jnp.bfloat16, seed=2)
    out, _ = axial.packed_walk_reference(*_torch(name, torch.bfloat16, seed=2))
    rows = _keyed(name)
    diff = out.float().numpy()[rows] - want[rows]
    assert np.abs(diff).max() <= BF16_MAX_REL * np.abs(want[rows]).max()
    assert np.linalg.norm(diff) <= BF16_L2_REL * np.linalg.norm(want[rows])


@pytest.mark.parametrize("name", list(CASES))
def test_packed_walk_equals_the_plain_reference(name):
    """The packed walk and the plain version the wrappers run on the CPU:
    out on every row (0 for masked queries and rows with no valid key) and
    the lse (+inf exactly where a row has no valid key; a masked query keeps
    its lse)."""
    args = _torch(name, torch.float32, seed=3)
    out, lse = axial.packed_walk_reference(*args)
    ref, ref_lse = axial.fused_attention_lse_reference(*args)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    np.testing.assert_allclose(lse[fin].numpy(), ref_lse[fin].numpy(), atol=ATOL)


@pytest.mark.parametrize("group", [1, 2, 7, 25])
def test_packed_walk_does_not_depend_on_the_group(group):
    """Problems never see one another: any tile size gives the same rows."""
    args = _torch("n5 a problem with no valid key", torch.float32, seed=4)
    ref, ref_lse = axial.packed_walk_reference(*args)
    out, lse = axial.packed_walk_reference(*args, group=group)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))


def _header_constant(name):
    match = re.search(rf"constexpr \w+ {name} = ([0-9.]+)", HEADER.read_text())
    assert match, name
    return int(match.group(1))


def test_plan_mirror_uses_the_kernel_constants():
    assert axial.PACKED_TILE == _header_constant("kRows")
    assert axial.PACKED_MAX_N == _header_constant("kMaxN")
    assert axial.PACKED_MAX_STAGES == _header_constant("kMaxStages")
    assert axial.PACKED_RING_BYTES == _header_constant("kRingBytes")
    assert axial.SM_COUNT == _header_constant("kSMs")
    # the ring's control block: 8 full and 8 empty barriers (8 bytes each),
    # 8 x 4 mask words and 8 tile indices (4 bytes each), and a byte each for
    # a warpgroup row's problem and token
    s = axial.PACKED_MAX_STAGES
    assert axial.PACKED_CONTROL_BYTES == 2 * s * 8 + 4 * s * 4 + s * 4 + 2 * 64


# (b, h, nq, nk, d) -> (G, tiles, blocks, stages): the port's short passes
# and the edges of the rule G = min(2 * (64 // nq), 128 // nk)
PLANS = {
    "template axis (crop 384, 4 templates)": ((384 * 384, 8, 5, 5, 64), (24, 49_152, 132, 4)),
    "serve MSA column (bucket 128, batch 4)": ((512, 8, 5, 5, 64), (24, 176, 132, 4)),
    "train MSA column (crop 128, MSA 5 x 64)": ((64, 8, 5, 5, 64), (24, 24, 24, 4)),
    "config_4 MSA column (MSA 16 x 128)": ((128, 8, 16, 16, 64), (8, 128, 128, 4)),
    "config_3 MSA column (MSA 8 x 128)": ((128, 8, 8, 8, 64), (16, 64, 64, 4)),
    "63 tokens: two problems a tile": ((9, 2, 63, 63, 64), (2, 10, 10, 4)),
    "keys bound G to one warpgroup's problems": ((30, 2, 5, 40, 64), (3, 20, 20, 4)),
    "head dim 32": ((100, 4, 7, 7, 32), (18, 24, 24, 8)),
    "head dim 128": ((100, 4, 7, 7, 128), (18, 24, 24, 2)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_packed_plan_on_the_port_shapes(name):
    shape, (g, tiles, blocks, stages) = PLANS[name]
    plan = axial.packed_plan(*shape)
    assert (plan["group"], plan["tiles"], plan["blocks"], plan["stages"]) == (g, tiles, blocks,
                                                                              stages)
    assert plan["kernel"] == f"attention_packed_kernel_sm90<{shape[4]}>"
    assert plan["threads"] == 288
    # the ring's whole stages fill 192 KB at every head dim: one block an SM
    assert plan["dynamic_smem"] == 1024 + 196_608 + axial.PACKED_CONTROL_BYTES
    assert plan["dynamic_smem"] <= tied_row.SMEM_LIMIT
    assert 2 * (plan["dynamic_smem"] + 1024) > tied_row.SMEM_PER_SM
    # a warpgroup's problems fill at most its 64 query rows, a tile's keys
    # at most one 128-key stage
    nq, nk = shape[2], shape[3]
    assert min(g, 64 // nq) * nq <= 64 and g <= 2 * (64 // nq) and g * nk <= axial.PACKED_TILE


@pytest.mark.parametrize("shape", [
    (5, 8, 64, 64, 64),  # 64 tokens: the training MSA row pass keeps its kernel
    (4, 8, 65, 5, 64),
    (4, 8, 5, 200, 64),
    (64, 8, 5, 5, 16),  # head dims the kernel is not built for
    (64, 8, 5, 5, 256),
])
def test_packed_plan_refuses(shape):
    assert axial.packed_plan(*shape) is None


# ------------------------------------------------------------ head dims > 128


@pytest.mark.parametrize("d", [192, 256, 320])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_rows_walk_matches_jax(d, dtype):
    """K1 past head dim 128 as the card runs it: the head dim read as R =
    D/64 rows of 64 (``head_rows`` views of the projections' layout, no
    copy) through K2's Hopper walk at tie scale 1, against JAX's
    fused_attention at that head dim; f32 at 1e-5 of the output's scale,
    bf16 at the card's bound."""
    b, h, nq, nk = 2, 2, 70, 90
    rng = np.random.default_rng(d)
    q = rng.standard_normal((b, nq, h, d)).astype(np.float32).transpose(0, 2, 1, 3)
    k, v = (rng.standard_normal((b, h, nk, d)).astype(np.float32) for _ in range(2))
    qm = np.arange(nq)[None, :] < np.array([[70], [51]])
    km = rng.random((b, nk)) > 0.2
    scale = d**-0.5
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax_fused(*(jnp.asarray(a, dtype=jdt) for a in (q, k, v)),
                                q_mask=jnp.asarray(qm), kv_mask=jnp.asarray(km),
                                sm_scale=scale), dtype=np.float32)
    tdt = getattr(torch, dtype)
    tq = torch.from_numpy(np.ascontiguousarray(q.transpose(0, 2, 1, 3))).to(tdt).transpose(1, 2)
    tk, tv = (torch.from_numpy(a).to(tdt) for a in (k, v))
    views = [axial.head_rows(t) for t in (tq, tk, tv)]
    assert views[0].shape == (b, d // 64, nq, h, 64)
    assert views[0].data_ptr() == tq.data_ptr()  # a view, not a copy
    out5, lse = tied_row.hopper_walk_reference(*views, torch.from_numpy(qm),
                                               torch.from_numpy(km), scale, 1.0, columns=128)
    out = out5.permute(0, 3, 2, 1, 4).reshape(b, h, nq, d).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, want, atol=ATOL * np.abs(want).max())
    else:
        diff = out - want
        assert np.abs(diff).max() <= BF16_MAX_REL * np.abs(want).max()
        assert np.linalg.norm(diff) <= BF16_L2_REL * np.linalg.norm(want)
    _, ref_lse = axial.fused_attention_lse_reference(tq.float(), tk.float(), tv.float(),
                                                     torch.from_numpy(qm),
                                                     torch.from_numpy(km), scale)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-4)


def test_row_route_plans_the_hopper_walk():
    """The shapes the row route sends to K2's plan: head dim 256 at the pair
    axial pass and head_dim_case's problem take the resident Hopper walk
    (R*D 256 <= 512) at 128 columns a block where the grid then fills a
    wave; 576 takes the wide route."""
    pair = tied_row.hopper_plan(128, 4, 8, 128, 64)
    assert pair["kernel"] == "tied_row_attention_kernel_sm90<64,128>" and pair["groups"] == 2
    assert tied_row.hopper_plan(2, 4, 4, 200, 64)["kernel"].startswith(
        "tied_row_attention_kernel_sm90<64,")
    assert tied_row.hopper_plan(2, 9, 4, 200, 64) is None
    assert tied_row.wide_plan(2, 9, 4, 200, 150, 64) is not None
    assert axial.row_width(256) == 64 and axial.row_width(200) == 200


# ------------------------------------------------------------------ wrappers


def test_wrappers_on_cpu_tensors_launch_nothing():
    args = _torch("n5 a problem with no valid key", torch.bfloat16, seed=5)
    fn = axial.fused_attention
    before = (fn.launches, fn.sm90_launches, fn.packed_launches, fn.row_launches)
    calls = (axial.fused_attention_reference.calls, axial.fused_attention_lse_reference.calls)
    out = fn(*args[:3], q_mask=args[3], kv_mask=args[4], sm_scale=args[5])
    out_lse, lse = axial.fused_attention_lse(*args)
    wide = [torch.zeros((1, 2, 9, 256), dtype=torch.bfloat16) for _ in range(3)]
    fn(*wide)
    assert (fn.launches, fn.sm90_launches, fn.packed_launches, fn.row_launches) == before
    assert (axial.fused_attention_reference.calls,
            axial.fused_attention_lse_reference.calls) == (calls[0] + 2, calls[1] + 1)
    assert torch.equal(out, out_lse) and lse.dtype == torch.float32
