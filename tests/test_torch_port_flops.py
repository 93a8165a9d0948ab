"""The port's flops accounting (``observe/flops.py``) against JAX's, and the
serving engine's cost ledger on it.

- ``attention_flops_attribution`` equals JAX's on the same shapes.
- The K1/K2 wrappers' analytic counts (what they add to an open
  ``ops.cuda.build.flop_tally`` where they launch on the card) equal
  ``FlopCounterMode``'s count of their plain versions at three shapes each,
  so the card's count of a forward (the mode's ops plus the kernels'
  tallies) equals the CPU's (the mode's ops, the plain versions among
  them). On the CPU the wrappers launch nothing and tally nothing.
- The engine's ``compile_records`` carry ``flops`` and
  ``flops_breakdown``, ``executed_flops`` adds a key's flops a dispatch,
  and each result's ``cost["flops_share"]`` is the key's flops over the
  batch's real members, as in JAX (``serve/engine.py:764-798``).
- The published peaks: 989.4e12 for "NVIDIA H100 80GB HBM3", None on the
  CPU; ``mesh_mfu`` divides by every rank's published peak on a mesh and
  falls back to a measured matmul rate (no multiplier) off the table.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from alphafold2_tpu.observe import flops as jflops
from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, ServeConfig
from alphafold2_tpu_torch.observe import flops
from alphafold2_tpu_torch.ops.cuda import axial, build, tied_row
from alphafold2_tpu_torch.serve import ServeEngine, ServeRequest


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(batch=4, pair_len=384, msa_depth=5, msa_len=128, depth=6, heads=8, dim_head=64,
         tie_rows=True, total_flops=3.0e13),
    dict(batch=2, pair_len=48, msa_depth=2, msa_len=16, depth=1, heads=2, dim_head=16),
    dict(batch=1, pair_len=96, msa_depth=16, msa_len=32, depth=2, heads=4, dim_head=32,
         tie_rows=False, total_flops=1.0),
])
def test_attention_flops_attribution_equals_jax(kw):
    assert flops.attention_flops_attribution(**kw) == jflops.attention_flops_attribution(**kw)


def _counted(fn, *args, **kw):
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kw)
    return counter.get_total_flops()


@pytest.mark.parametrize("b,h,nq,nk,d", [(2, 3, 16, 16, 32), (1, 8, 5, 5, 64),
                                         (3, 2, 40, 17, 16)])
def test_k1_analytic_count_equals_the_plain_versions(b, h, nq, nk, d):
    g = torch.Generator().manual_seed(b * 100 + nq)
    q, k, v = (torch.randn(b, h, n, d, generator=g) for n in (nq, nk, nk))
    q_mask = torch.ones(b, nq, dtype=torch.bool)
    kv_mask = torch.rand(b, nk, generator=g) > 0.2
    want = axial.attention_flops(b, h, nq, nk, d)
    assert _counted(axial.fused_attention_reference, q, k, v, q_mask, kv_mask, 0.1) == want
    assert _counted(axial.fused_attention_lse_reference, q, k, v, q_mask, kv_mask, 0.1) == want
    # CPU tensors: the wrapper runs the plain version and tallies nothing
    with build.flop_tally() as tally:
        assert _counted(axial.fused_attention, q, k, v, q_mask, kv_mask, 0.1) == want
    assert tally == {}


@pytest.mark.parametrize("b,r,nq,nk,h,d", [(1, 5, 16, 16, 2, 32), (2, 3, 8, 12, 4, 16),
                                           (1, 1, 24, 24, 8, 64)])
def test_k2_analytic_count_equals_the_plain_versions(b, r, nq, nk, h, d):
    g = torch.Generator().manual_seed(b * 10 + r)
    q = torch.randn(b, r, nq, h, d, generator=g)
    k, v = (torch.randn(b, r, nk, h, d, generator=g) for _ in range(2))
    kv_mask = torch.rand(b, nk, generator=g) > 0.2
    want = tied_row.tied_row_flops(b, r, h, nq, nk, d)
    assert _counted(tied_row.tied_row_attention_reference, q, k, v, None, kv_mask, 0.1) == want
    assert _counted(tied_row.tied_row_attention_lse_reference, q, k, v, None, kv_mask,
                    0.1) == want
    with build.flop_tally() as tally:
        assert _counted(tied_row.tied_row_attention, q, k, v, None, kv_mask, 0.1) == want
    assert tally == {}


def test_tally_is_per_thread_and_nests():
    with build.flop_tally() as outer:
        build.tally_flops("fused_attention", 5)
        with build.flop_tally() as inner:
            build.tally_flops("tied_row_attention", 7)
        build.tally_flops("fused_attention", 1)
    build.tally_flops("fused_attention", 100)  # nothing open: dropped
    assert outer == {"fused_attention": 6.0} and inner == {"tied_row_attention": 7.0}


def test_count_forward_reads_ops_and_kernel_tallies():
    def fn(x):
        build.tally_flops("fused_attention", 1000)
        return x @ x

    run = flops.count_forward(fn, torch.ones(4, 4), device="cpu")
    assert (run.op_flops, run.kernel_flops, run.peak_bytes) == (128.0, {"fused_attention": 1000.0},
                                                                 None)
    assert flops.executable_costs(run) == {"flops": 1128.0, "bytes_accessed": None}
    assert flops.executable_memory(run) == {}


def _cfg(**serve_kw):
    serve_kw = dict(dict(buckets=(8, 16), max_batch=2, mds_iters=10), **serve_kw)
    return Config(model=ModelConfig(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=48,
                                    bfloat16=False, msa_tie_row_attn=True),
                  data=DataConfig(msa_depth=2), serve=ServeConfig(**serve_kw))


def test_engine_records_flops_and_splits_them_over_real_members():
    eng = ServeEngine(_cfg(pipeline_depth=0), device="cpu")
    try:
        out = eng.predict_many([ServeRequest(s, seed=i) for i, s in
                                enumerate(("ACDEFG", "MKVLIT", "WY", "ACDEFGHKLMNP"))])
    finally:
        eng.close()
    recs = {(r["bucket"], r["batch"]): r for r in eng.compile_records}
    assert set(recs) == {(8, 2), (16, 2)}
    for (bucket, batch), rec in recs.items():
        assert rec["flops"] > 0 and "peak_bytes" not in rec  # no allocator stats on the CPU
        bd = rec["flops_breakdown"]
        assert bd == flops.attention_flops_attribution(
            batch=batch, pair_len=3 * bucket, msa_depth=2, msa_len=bucket, depth=1, heads=2,
            dim_head=16, tie_rows=True, total_flops=rec["flops"])
        assert bd["tied_row"] > 0 and bd["other"] > 0
    # bucket 8: [ACDEFG, MKVLIT] and [WY] (padded to 2); bucket 16: one request
    assert [r.bucket for r in out] == [8, 8, 8, 16]
    for r in out:
        members = 2 if r.seq in ("ACDEFG", "MKVLIT") else 1
        assert r.cost["flops_share"] == round(recs[(r.bucket, 2)]["flops"] / members, 3) > 0
    dispatches = {8: 2, 16: 1}
    assert eng.executed_flops == pytest.approx(
        sum(recs[(b, 2)]["flops"] * n for b, n in dispatches.items()))
    assert eng.executed_flops_breakdown["tied_row"] == pytest.approx(
        sum(recs[(b, 2)]["flops_breakdown"]["tied_row"] * n for b, n in dispatches.items()))


def test_engine_count_is_the_plain_forward_count():
    """The engine's recorded flops are FlopCounterMode's count of one masked
    forward of the key (on the CPU every kernel runs its plain version)."""
    eng = ServeEngine(_cfg(pipeline_depth=0, buckets=(8,)), device="cpu")
    try:
        eng.warmup()
        masked = eng._to_device(eng._stack_host(8, [], 2), 8)
        with FlopCounterMode(display=False) as counter:
            eng._forward(masked)
    finally:
        eng.close()
    assert eng.compile_records[0]["flops"] == counter.get_total_flops()


def test_published_peaks_and_mfu():
    assert flops.peak_flops_for_kind("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.peak_flops_for_kind("NVIDIA H100 PCIe") == 756e12
    assert flops.peak_flops_for_kind("NVIDIA H100 NVL") is None  # not in the table
    assert flops.peak_flops_for_kind("TPU v5 lite") is None
    assert flops.device_peak_flops("cpu") is None
    assert flops.SANITY_FLOPS_CEILING == jflops.SANITY_FLOPS_CEILING
    assert flops.mesh_mfu(None, 1.0) == {"mfu": None}
    got = flops.mesh_mfu(1e9, 1.0, device="cpu")
    assert got["mfu_basis"] == "calibrated-matmul" and got["mfu"] > 0

    class FourRanks:  # a mesh's size is all mesh_mfu reads
        def size(self):
            return 4

    # on the measured rate the ranks share one machine: no multiplier (JAX's)
    assert flops.mesh_mfu(1e9, 1.0, mesh=FourRanks(), device="cpu") == got
    with pytest.MonkeyPatch.context() as mp:  # a published peak: every rank's
        mp.setattr(flops, "device_peak_flops", lambda device=None: 1e12)
        assert flops.mesh_mfu(2e12, 1.0) == {"mfu": 2.0, "mfu_basis": "published-peak"}
        assert flops.mesh_mfu(2e12, 1.0, mesh=FourRanks()) == {
            "mfu": 0.5, "mfu_basis": "published-peak"}
    assert flops.calibrated_peak_flops("cpu") == flops.calibrated_peak_flops("cpu")  # cached
    if not torch.cuda.is_available():  # the card by default: no quiet CPU fallback
        with pytest.raises(RuntimeError):
            flops.device_peak_flops()
