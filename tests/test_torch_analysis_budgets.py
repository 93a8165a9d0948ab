"""``analysis/budgets.py``'s lattice report against the JAX package's:
``check_budget`` and ``format_budget`` give JAX's verdicts and lines on the
same records, and ``lattice_report`` walks a serving engine's ladder at
``warmup``'s geometry from its compile records, warming only what the
engine has not run, with a seeded over-budget rung flagged."""

import pytest
import torch

from alphafold2_tpu.analysis import budgets as jbudgets
from alphafold2_tpu_torch.analysis import budgets
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.serve.engine import ServeEngine

RECORDS = [(None, None), (100, None), (None, 100), (80, 100), (100, 100), (130, 100),
           (1, 10**12)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("program,budget", RECORDS)
def test_verdicts_and_lines_match_jax(program, budget):
    ours, theirs = budgets.check_budget(program, budget), jbudgets.check_budget(program, budget)
    assert ours["verdict"] == theirs["verdict"]
    assert {k: v for k, v in ours.items() if k != "reason"} == {
        k: v for k, v in theirs.items() if k != "reason"}
    if ours["verdict"] != "no-data":
        assert budgets.format_budget("bucket 64", ours) == jbudgets.format_budget("bucket 64",
                                                                                theirs)
    assert budgets.DEFAULT_HBM_FRACTION == jbudgets.DEFAULT_HBM_FRACTION


class _FakeEngine:
    """The engine surface lattice_report reads, with records as the card's
    warm runs leave them (peak_bytes) and a counter of rungs run."""

    def __init__(self, peaks, pad=True):
        self.cfg = Config()
        self.cfg.serve.pad_batches = pad
        self.buckets = tuple(peaks)
        self.max_batch = 4
        self.device = torch.device("cpu")
        self.mesh_desc = None
        self.model = torch.nn.Linear(10, 10)  # 110 float32 parameters: 440 bytes
        self.peaks = peaks
        self.compile_records = []
        self.ran = []

    def _padded_batch(self, bucket, n_real):
        return self.max_batch if self.cfg.serve.pad_batches else n_real

    def _device_scope(self):
        return torch.no_grad()

    def _get_executable(self, bucket, batch):
        self.ran.append((bucket, batch))
        self.compile_records.append({"bucket": bucket, "batch": batch, "seconds": 0.1,
                                     "flops": 1e9 * bucket, "peak_bytes": self.peaks[bucket]})


def test_lattice_report_reads_warmed_rungs_and_warms_the_rest():
    engine = _FakeEngine({64: 1000, 128: 4000, 256: 9000})
    engine._get_executable(64, 4)  # warmed before the report
    report = budgets.lattice_report(engine, hbm_bytes=5000)
    assert engine.ran == [(64, 4), (128, 4), (256, 4)]
    assert report["mesh"] is None and report["hbm_budget_bytes"] == 5000
    assert [r["bucket"] for r in report["rungs"]] == [64, 128, 256]
    for r in report["rungs"]:
        assert r["batch"] == 4 and r["param_bytes"] == 440
        assert r["collectives"] == {} and r["comm_bytes"] == 0
        want = jbudgets.check_budget(engine.peaks[r["bucket"]] + 440, 5000)
        assert r["budget"] == want and r["flops"] == 1e9 * r["bucket"]
    # the seeded defect: bucket 256 does not fit, and the whole lattice fails
    assert [r["budget"]["verdict"] for r in report["rungs"]] == ["pass", "pass", "over-budget"]
    assert report["verdict"] == "over-budget"
    again = budgets.lattice_report(engine, hbm_bytes=10**6)
    assert engine.ran == [(64, 4), (128, 4), (256, 4)] and again["verdict"] == "pass"


def test_lattice_budget_from_the_device(monkeypatch):
    engine = _FakeEngine({64: 1000}, pad=False)
    assert budgets.lattice_report(engine)["verdict"] == "no-data"  # the CPU has no figure
    assert engine.ran == [(64, 1)]  # unpadded batches: warmup's batch of 1
    monkeypatch.setattr(budgets, "device_hbm_bytes", lambda device: 2000)
    report = budgets.lattice_report(engine, hbm_fraction=0.5)
    assert report["hbm_budget_bytes"] == 1000 and report["verdict"] == "over-budget"


def test_lattice_on_a_cpu_engine_and_the_cli(capsys):
    cfg = Config()
    m = cfg.model
    m.dim, m.depth, m.heads, m.dim_head, m.max_seq_len = 16, 1, 2, 8, 48
    cfg.serve.buckets, cfg.serve.max_batch, cfg.serve.mds_iters = (8, 16), 2, 2
    engine = ServeEngine(cfg, device="cpu")
    try:
        engine.warmup()
        n = len(engine.compile_records)
        report = budgets.lattice_report(engine)
    finally:
        engine.close()
    assert len(engine.compile_records) == n == 2
    assert report["verdict"] == "no-data"
    assert [r["flops"] for r in report["rungs"]] == [r["flops"] for r in engine.compile_records]
    assert budgets.main(["--device=cpu", "model.dim=16", "model.depth=1", "model.heads=2",
                         "model.dim_head=8", "model.max_seq_len=48", "serve.buckets=8",
                         "serve.max_batch=2", "serve.mds_iters=2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("bucket 8 x batch 2: no-data") and out[-1].startswith(
        "lattice: no-data")
