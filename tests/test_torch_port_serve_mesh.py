"""Mesh-sharded serving in the port against the JAX package's, following
``tests/test_serve_mesh.py``.

The port's sharded engine runs on 4 gloo ranks (``torch_mesh_ranks.py``
``case_serve``: a ``(1, 2, 2)`` grid mesh, ``model.grid_parallel``, the
long rung 24 at ``long_max_batch`` 1, synchronous dispatch, then pipelined
and through a fleet): rank 0 serves,
the others follow. JAX's single-device and sharded engines (its
``make_grid_mesh(1, 2, 2)`` over 4 of the 8 virtual CPU devices) serve the
same requests with the same parameters (``convert.to_state_dict``). Held:

- the gate (long rungs without a mesh raise JAX's ``ValueError``), their
  admission with a mesh and ``batch_for``, a grid mesh needing
  ``grid_parallel`` and the dp divisibility of both batch sizes;
- pipelined dispatch on the mesh bit-equal to the serial engine, and a
  two-replica fleet on it (``FleetFrontend.build(..., mesh=)``) whose
  results equal the single engine's;
- the mesh in the executables' keys, the compile records (with this rank's
  ``program_bytes``) and the result cache's key;
- distogram logits and weights against JAX's sharded and single engines at
  1e-4, a padded batch slot included; the 20-residue request on rung 24;
- the async frontend over the sharded engine: a long-rung batch at
  ``long_max_batch`` and in-flight dedup under the mesh key.

Coordinates are held finite and shaped only: MDS on an untrained model's
distogram amplifies reassociation noise (JAX's
``test_realization_chaos_attribution``; ROADMAP section 3).
"""

import dataclasses

import jax
import numpy as np
import pytest

from alphafold2_tpu.config import Config as JConfig, DataConfig as JDataConfig
from alphafold2_tpu.config import ModelConfig as JModelConfig, ServeConfig as JServeConfig
from alphafold2_tpu.parallel.grid_parallel import make_grid_mesh as jmake_grid_mesh
from alphafold2_tpu.serve import ServeEngine as JServeEngine
from alphafold2_tpu.serve import ServeRequest as JServeRequest
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.predict import build_model
from alphafold2_tpu_torch.serve.cache import result_key
from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest
from torch_mesh_ranks import run_ranks

ATOL = 1e-4
MODEL = dict(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=3 * 64, bfloat16=False)
SERVE = dict(buckets=(8, 16), max_batch=2, mds_iters=20, return_distogram=True)
REQUESTS = [("ACDEFG", 0), ("MKVLITDSW", 1), ("ACDEFGHKLMNPQR", 2)]
LONG = ("ACDEFGHKLMNPQRSTVWYA", 3)


def _jcfg(grid=False, **serve):
    return JConfig(model=JModelConfig(**MODEL, grid_parallel=grid),
                   data=JDataConfig(msa_depth=2), serve=JServeConfig(**SERVE, **serve))


def _cfg(**serve):
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, **MODEL)
    cfg.data.msa_depth = 2
    cfg.serve = dataclasses.replace(cfg.serve, **SERVE, pipeline_depth=0, **serve)
    return cfg


@pytest.fixture(scope="module")
def jax_side():
    single = JServeEngine(_jcfg())
    sharded = JServeEngine(_jcfg(grid=True, long_buckets=(24,), long_max_batch=1),
                           params=single.params,
                           mesh=jmake_grid_mesh(1, 2, 2, devices=jax.devices()[:4]))
    run = lambda eng, s, i: eng.predict_many([JServeRequest(s, seed=i)])[0]  # noqa: E731
    out = {"single": {s: run(single, s, i) for s, i in REQUESTS},
           "sharded": {s: run(sharded, s, i) for s, i in REQUESTS},
           "padded": single.predict_many([JServeRequest("ACDEFG", seed=11)])[0],
           "long": run(sharded, *LONG)}
    return jax.tree.map(np.asarray, single.params), out


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    params, _ = jax_side
    cfg = _cfg()
    cfg.model.grid_parallel = True
    sd = convert.to_state_dict(params, build_model(cfg))
    spec = {"model": dict(MODEL, grid_parallel=True), "msa_depth": 2,
            "serve": dict(SERVE, pipeline_depth=0)}
    return run_ranks("serve", 4, tmp_path_factory.mktemp("serve"),
                     {"spec": spec, "state_dict": sd, "requests": REQUESTS})


def test_long_buckets_rejected_without_mesh():
    with pytest.raises(ValueError, match="require a device mesh"):
        ServeEngine(_cfg(long_buckets=(24,)), device="cpu")


def test_long_buckets_admitted_with_mesh(port):
    buckets, long, b8, b24, desc = port["ladder"]
    assert buckets == (8, 16, 24) and long == (24,)
    assert b8 == 2 and b24 == 1
    assert desc == "dp1.spr2.spc2"


def test_long_request_rejected_single_device():
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        ServeEngine(_cfg(), device="cpu").predict_many(["A" * 20])


def test_grid_mesh_requires_grid_parallel_model(port):
    kind, msg = port["errors"]["grid_needs_grid_parallel"]
    assert kind == "ValueError" and "grid_parallel" in msg


def test_mesh_batch_divisibility_validated(port):
    kind, msg = port["errors"]["dp_divides_batch"]
    assert kind == "ValueError" and "divide by the mesh's dp axis" in msg


def test_pipelined_dispatch_refused_on_a_mesh(port):
    """No longer refused: pipelined dispatch (``serve.pipeline_depth`` 2) on
    the (1, 2, 2) mesh gives the serial engine's results bit for bit."""
    assert port["pipeline_desc"] == "depth2"
    for (seq, _), (status, weights, disto, atom14) in zip(REQUESTS, port["pipelined"]):
        _, _, w_ref, d_ref, xyz_ref = port[("single", seq)]
        assert status == "ok"
        assert np.array_equal(weights, w_ref) and np.array_equal(disto, d_ref)
        assert np.array_equal(atom14, xyz_ref)


def test_fleet_on_a_mesh_equals_one_engine(port):
    """FleetFrontend.build(..., mesh=): two replicas sharing one module on
    the (1, 2, 2) mesh, both dispatching, each result the single sharded
    engine's bit for bit; the followers ran one follow() loop for both."""
    assert port["fleet_shares_module"] and all(n > 0 for n in port["fleet_dispatches"])
    for (seq, _), (status, weights, disto, atom14) in zip(REQUESTS, port["fleet"]):
        _, _, w_ref, d_ref, xyz_ref = port[("single", seq)]
        assert status == "ok"
        assert np.array_equal(weights, w_ref) and np.array_equal(disto, d_ref)
        assert np.array_equal(atom14, xyz_ref)


def test_executable_keys_and_records_carry_the_mesh(port):
    assert port["keys"] and all(k[2] == "dp1.spr2.spc2" for k in port["keys"])
    rec = port["records"][0]
    assert rec["mesh"] == "dp1.spr2.spc2"
    assert rec.get("program_bytes", 0) > 0
    assert set(rec["collectives"]) >= {"all_to_all@spr", "all_to_all@spc", "all_reduce@seq",
                                       "all_gather@world", "broadcast@world"}


def test_result_cache_key_carries_mesh():
    assert result_key("ACD", 1, None) != result_key("ACD", 1, "dp1.spr2.spc2")


@pytest.mark.parametrize("seq", [s for s, _ in REQUESTS])
def test_cross_mesh_model_output_parity(port, jax_side, seq):
    """The sharded port against JAX's sharded and single engines: logits
    and weights at 1e-4; coordinates finite and shaped."""
    _, ref = jax_side
    status, bucket, weights, disto, atom14 = port[("single", seq)]
    assert status == "ok"
    for which in ("sharded", "single"):
        want = ref[which][seq]
        assert bucket == want.bucket
        np.testing.assert_allclose(weights, want.weights, atol=ATOL, rtol=0)
        np.testing.assert_allclose(disto, want.distogram, atol=ATOL, rtol=0)
    assert np.isfinite(atom14).all() and atom14.shape == ref["single"][seq].atom14.shape


def test_cross_mesh_parity_includes_padded_batch_slots(port, jax_side):
    _, ref = jax_side
    solo_w, solo_xyz, batched_w, batched_d, batched_xyz = port["padded"]
    np.testing.assert_allclose(batched_w, solo_w, atol=1e-6, rtol=0)
    np.testing.assert_allclose(batched_xyz, solo_xyz, atol=1e-5, rtol=0)
    np.testing.assert_allclose(batched_w, ref["padded"].weights, atol=ATOL, rtol=0)
    np.testing.assert_allclose(batched_d, ref["padded"].distogram, atol=ATOL, rtol=0)


def test_long_rung_serves_end_to_end(port, jax_side):
    _, ref = jax_side
    status, bucket, atom14, weights, disto = port["long"]
    assert status == "ok" and bucket == 24 == ref["long"].bucket
    assert atom14.shape == (20, 14, 3) and np.isfinite(atom14).all()
    np.testing.assert_allclose(weights, ref["long"].weights, atol=ATOL, rtol=0)
    np.testing.assert_allclose(disto, ref["long"].distogram, atol=ATOL, rtol=0)


def test_frontend_over_sharded_engine(port):
    status1, bucket1, status2, hit2, cached = port["frontend"]
    assert status1 == "ok" and bucket1 == 24
    assert status2 == "ok" and hit2  # in-flight dedup under the mesh key
    assert cached


def test_follower_entry_points_are_refused_off_a_mesh():
    eng = ServeEngine(_cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="ranks after 0"):
        eng.follow()
    assert eng.mesh is None and eng.mesh_desc is None and eng.rank == 0
