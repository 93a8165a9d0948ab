"""The port's parallel layer (``alphafold2_tpu_torch/parallel``) against the
JAX package's on its CPU meshes.

Ranks are gloo process groups of 2 and 4 processes (``torch_mesh_ranks.py``,
one spawn a world size, every check batched into it); the JAX side runs on
the 8 virtual CPU devices of ``tests/conftest.py``:

- ``grid_axial_attention`` on a grid mesh (1x2x2 from 4 ranks, 1x1x2 from 2)
  and on a 1D ``(1, sp)`` mesh (rows over ``sp``, one column shard), both
  axes, with and without a padding mask, against JAX's on
  ``make_grid_mesh(1, 2, 2)`` (``1, 1, 2``) and meshless, at 1e-5;
  with the K1 hook (its plain version on the CPU) equal to the meshless
  hook;
- ring and Ulysses attention on ``(1, sp)`` against JAX's
  ``sequence_parallel_attention`` on ``make_mesh(1, sp)``, at 1e-5, with
  rank blocks whose keys are all masked;
- the merged MSA<-pair pass (``Attention.forward_sharded_context``: K1 with
  lse on each rank's keys, one all_reduce of the max and one of the sums)
  against the meshless pass, at 1e-5;
- the pair stream's block-sparse axial passes (K4's plain version) on a
  rank's block against the meshless module, and the block-alignment
  refusal;
- the distogram model on a grid, a 1D, a context-parallel (ring, Ulysses)
  and a data-parallel mesh against the meshless model, at 1e-5;
- ``describe_mesh`` / ``parse_mesh_spec`` strings equal to JAX's; the
  census of one row pass; ``initialize`` a no-op in one process.
"""

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu.parallel import grid_parallel as jgrid
from alphafold2_tpu.parallel import seq_parallel as jseq
from alphafold2_tpu.parallel.sharding import describe_mesh as jdescribe
from alphafold2_tpu.parallel.sharding import make_mesh as jmake_mesh
from torch_mesh_ranks import run_ranks

ATOL = 1e-5
WORLDS = (2, 4)


def _payload():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    m = np.ones((1, 8), bool)
    m[:, 6:] = False
    grid = {"q": f(1, 8, 8, 2, 8), "k": f(1, 8, 8, 2, 8), "v": f(1, 8, 8, 2, 8),
            "mask": m[:, :, None] & m[:, None, :]}
    seq_mask = np.ones((2, 16), bool)
    seq_mask[0, 7:] = False  # batch row 0: the last ranks' keys are all masked
    seq = {"q": f(2, 4, 16, 8), "k": f(2, 4, 16, 8), "v": f(2, 4, 16, 8), "mask": seq_mask}
    x_mask = np.ones((2, 6), bool)
    x_mask[1, 4:] = False
    ctx_mask = np.ones((2, 16), bool)
    ctx_mask[1, 5:] = False  # batch row 1: the last ranks' keys are all masked
    cross = {"x": f(2, 6, 16), "ctx": f(2, 16, 16), "mask": x_mask, "ctx_mask": ctx_mask}
    sm = np.ones((1, 64), bool)
    sm[:, 57:] = False
    sparse = {"x": f(1, 64, 64, 16), "mask": sm[:, :, None] & sm[:, None, :]}
    mm = np.ones((2, 24), bool)
    mm[1, 20:] = False  # a padded batch slot's tail
    model = {"seq": rng.integers(0, 20, (2, 24)), "msa": rng.integers(0, 20, (2, 2, 24)),
             "mask": mm, "msa_mask": np.repeat(mm[:, None], 2, axis=1)}
    return {"grid": grid, "seq": seq, "cross": cross, "sparse": sparse, "model": model}


PAYLOAD = _payload()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    return world, run_ranks("parallel", world, tmp_path_factory.mktemp(f"w{world}"), PAYLOAD)


def _jax_grid_mesh(world):
    return (jgrid.make_grid_mesh(1, 2, 2, devices=jax.devices()[:4]) if world == 4
            else jgrid.make_grid_mesh(1, 1, world, devices=jax.devices()[:world]))


@pytest.mark.parametrize("axis", (1, 2))
@pytest.mark.parametrize("masked", (False, True), ids=("unmasked", "masked"))
def test_grid_axial_attention_matches_jax(ranks, axis, masked):
    world, got = ranks
    g = PAYLOAD["grid"]
    want = jgrid.grid_axial_attention(g["q"], g["k"], g["v"], mask=g["mask"] if masked else None,
                                      mesh=_jax_grid_mesh(world), attend_axis=axis)
    np.testing.assert_allclose(got[("grid", axis, masked)], np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("axis", (1, 2))
@pytest.mark.parametrize("masked", (False, True), ids=("unmasked", "masked"))
def test_line_mesh_pass_matches_jax(ranks, axis, masked):
    """A 1D (1, sp) mesh: rows over sp, one column shard; JAX's grid pass
    runs meshless there (GSPMD shards it from the constraints)."""
    _, got = ranks
    g = PAYLOAD["grid"]
    want = jgrid.grid_axial_attention(g["q"], g["k"], g["v"], mask=g["mask"] if masked else None,
                                      attend_axis=axis)
    np.testing.assert_allclose(got[("line", axis, masked)], np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("label", ("grid", "line"))
def test_k1_hook_on_the_gathered_rows_equals_meshless(ranks, label):
    _, got = ranks
    for axis in (1, 2):
        for masked in (False, True):
            np.testing.assert_allclose(got[(label, axis, masked, "hook")],
                                       got[("meshless", axis, masked, "hook")], atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ("ring", "ulysses"))
def test_sequence_parallel_matches_jax(ranks, impl):
    world, got = ranks
    s = PAYLOAD["seq"]
    mesh = jmake_mesh(1, world, devices=jax.devices()[:world])
    want = jseq.sequence_parallel_attention(s["q"], s["k"], s["v"], mask=s["mask"], mesh=mesh,
                                            impl=impl)
    np.testing.assert_allclose(got[impl], np.asarray(want), atol=ATOL, rtol=0)


def test_merged_msa_from_pair_pass_equals_meshless(ranks):
    """Each rank's keys a quarter (a half) of the context, some all masked:
    the merged partials equal one pass over every key."""
    _, got = ranks
    valid = PAYLOAD["cross"]["mask"][..., None]
    np.testing.assert_allclose(got["cross"] * valid, got["cross_meshless"] * valid, atol=ATOL,
                               rtol=0)
    assert np.isfinite(got["cross"]).all()


@pytest.mark.parametrize("label", ("grid", "line"))
def test_sharded_block_sparse_axial_equals_meshless(ranks, label):
    """The pair stream's block-sparse AxialAttention (K4's plain version on
    the CPU) on this rank's block, the attended axis gathered; and JAX's
    block-alignment refusal on a grid mesh."""
    _, got = ranks
    np.testing.assert_allclose(got[("sparse", label)], got["sparse_meshless"], atol=ATOL,
                               rtol=0)
    assert "block-aligned" in got["sparse_unaligned"]


@pytest.mark.parametrize("label", ("grid", "line", "ring", "ulysses", "dp"))
def test_sharded_model_equals_meshless(ranks, label):
    """The distogram model on each rank's block (the sharded axial passes,
    the merged MSA<-pair pass or the context-parallel ring / Ulysses cross
    passes, the transposed symmetrisation), its logits blocks gathered,
    against the meshless model at the valid pairs; ``dp`` a (2, 1, 2) mesh
    of 4 ranks (2, 1, 1 of 2), each taking its half of the batch."""
    _, got = ranks
    m = PAYLOAD["model"]["mask"]
    valid = (m[:, :, None] & m[:, None, :])[..., None]
    np.testing.assert_allclose(got[("model", label)] * valid, got["model_meshless"] * valid,
                               atol=ATOL, rtol=0)


def test_mesh_strings_match_jax(ranks):
    world, got = ranks
    grid, line, parsed_line, parsed_grid, none, empty = got["describe"]
    assert grid == parsed_grid == jdescribe(_jax_grid_mesh(world))
    assert line == parsed_line == jdescribe(jmake_mesh(1, world, devices=jax.devices()[:world]))
    assert none is None and empty is None
    assert (grid, line) == (("dp1.spr2.spc2", "dp1.sp4") if world == 4
                            else ("dp1.spr1.spc2", "dp1.sp2"))


def test_census_of_one_row_pass(ranks):
    """A masked row pass on the grid mesh: q, k, v and the mask gathered and
    the output scattered, one all_to_all each over spc, nothing else."""
    world, got = ranks
    c = got["census_row_pass"]
    assert set(c) == {"all_to_all@spc"}
    assert c["all_to_all@spc"]["count"] == 5
    n_local = 8 // (2 if world == 4 else 1) * 8 // 2  # this rank's block: rows x cols
    assert c["all_to_all@spc"]["bytes"] == 4 * n_local * 2 * 8 * 4 + n_local


def test_the_package_exports_the_jax_names():
    import ast
    import importlib.util
    import pathlib

    import alphafold2_tpu_torch.parallel as port

    path = pathlib.Path(importlib.util.find_spec("alphafold2_tpu.parallel").origin)
    jax_names = {a.asname or a.name for node in ast.walk(ast.parse(path.read_text()))
                 if isinstance(node, ast.ImportFrom) for a in node.names}
    assert set(port.__all__) == jax_names
    assert (port.DATA_AXIS, port.SEQ_AXIS) == ("dp", "sp")
    assert all(hasattr(port, name) for name in port.__all__)


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    from alphafold2_tpu_torch.parallel import distributed, sharding

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS",
                "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        sharding.make_mesh(1, 1)
    assert sharding.active_mesh() is None


def test_a_world_of_one_serves_pod_mesh_and_global_batch():
    from alphafold2_tpu_torch.parallel import distributed, sharding

    with distributed.local_world("cpu") as made:
        assert made and torch.distributed.get_world_size() == 1
        mesh = distributed.pod_mesh()
        assert sharding.describe_mesh(mesh) == "dp1.sp1"
        batch = {"seq": np.arange(6).reshape(2, 3)}
        np.testing.assert_array_equal(distributed.global_batch(batch, mesh)["seq"],
                                      batch["seq"])
        with pytest.raises(ValueError, match="ranks"):
            distributed.pod_mesh(2, 1)
    assert not torch.distributed.is_initialized()


def test_a_world_of_one_records_every_collective_and_copies_nothing():
    """Over axes of one rank each wrapper records what it would send and
    returns its input itself: the census is whole, nothing is copied."""
    from alphafold2_tpu_torch.parallel import distributed, sharding
    from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh

    gen = torch.Generator().manual_seed(0)
    t = torch.randn((2, 4, 6, 3), generator=gen)
    with distributed.local_world("cpu"):
        mesh = make_grid_mesh(1, 1, 1)
        sharding.reset_census()
        assert sharding.all_to_all(t, mesh, "spr", 1, 2) is t
        assert sharding.all_to_all_uneven(t, [2], [2], mesh, "seq") is t
        assert sharding.all_gather(t, mesh, "world", dim=1) is t
        assert sharding.all_reduce(t, mesh, "seq", op="max") is t
        (moved,) = sharding.ring_shift([t], mesh, "spc")
        assert moved is t
        obj = {"op": "forward"}
        assert sharding.broadcast_object(obj) is obj
        got = sharding.census()
    nbytes = t.numel() * t.element_size()
    assert {k: (v["count"], v["bytes"]) for k, v in got.items()} == {
        "all_to_all@spr": (1, nbytes), "all_to_all@seq": (1, nbytes),
        "all_gather@world": (1, nbytes), "all_reduce@seq": (1, nbytes),
        "send_recv@spc": (1, nbytes), "broadcast@world": (1, got["broadcast@world"]["bytes"])}
    assert got["broadcast@world"]["bytes"] > 0


def test_layer_boundaries_check_the_local_blocks():
    """shard_pair, shard_msa and shard_batch pass this rank's blocks through
    unchanged and refuse any other shape under a mesh; without one they
    check nothing."""
    from alphafold2_tpu_torch.parallel import distributed, sharding
    from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh

    x, m = torch.zeros((2, 6, 6, 4)), torch.zeros((2, 3, 6, 4))
    assert sharding.shard_msa(m[:1], 2) is not None  # no mesh: nothing checked
    with distributed.local_world("cpu"):
        mesh = make_grid_mesh(1, 1, 1)
        with sharding.use_mesh(mesh):
            assert sharding.shard_pair(x, 6) is x
            assert sharding.shard_msa(m, 2) is m
            assert sharding.shard_batch(m, 2) is m
            with pytest.raises(ValueError, match="pair block"):
                sharding.shard_pair(x[:, :3], 6)
            with pytest.raises(ValueError, match="MSA block"):
                sharding.shard_msa(m[:1], 2)
            with pytest.raises(ValueError, match="MSA block"):
                sharding.shard_msa(m[0], 2)
            with pytest.raises(ValueError, match="batch block"):
                sharding.shard_batch(m[:1], 2)
