"""The port's collective audit (``alphafold2_tpu_torch/analysis/hlo_audit.py``),
JAX's ``analysis/hlo_audit.py`` counterpart: the census of the eager
program's collectives on gloo ranks, rules AF2A107-AF2A110, the committed
``analysis/hlo_contracts.json`` and the CLI's exit codes.

Three spawns of ranks: the whole registry on 4 ranks through ``--check``
(the committed baseline), the sharded targets on 2, and the negative
control (``AF2TPU_AUDIT_DROP_SHARD_PAIR``) on 4; the exit-code cases reuse
the first run's document.
"""

import copy
import json

import pytest
import torch

from alphafold2_tpu_torch.analysis import budgets, hlo_audit, targets

SHARDED = "serve_fwd_grid,serve_fwd_long"


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    """``--check`` of every audited target on 4 gloo ranks: its rc and doc."""
    out = tmp_path_factory.mktemp("hlo") / "check.json"
    rc = hlo_audit.main(["--check", "--device", "cpu", "--json", str(out)])
    with open(out, encoding="utf-8") as fh:
        return rc, json.load(fh)


def test_committed_baseline_passes_check(checked):
    rc, got = checked
    with open(hlo_audit.DEFAULT_BASELINE, encoding="utf-8") as fh:
        base = json.load(fh)
    assert rc == 0, got["summary"]
    want = "pass" if base["torch_version"] == torch.__version__ else "stale-baseline"
    assert got["check"]["verdict"] == want
    assert base["world"] == got["doc"]["world"] == 4 and base["platform"] == "cpu"
    assert set(base["targets"]) == set(hlo_audit.AUDITED)


def test_census_of_the_sharded_targets(checked):
    doc = checked[1]["doc"]["targets"]
    grid, long = doc["serve_fwd_grid"], doc["serve_fwd_long"]
    assert grid["mesh"] == "dp1.spr2.spc2" and long["mesh"] == "dp1.sp4"
    assert grid["seq_ranks"] == long["seq_ranks"] == 4
    counts = {k: v["count"] for k, v in grid["collectives"].items()}
    # one trunk layer: 2 axial passes (q, k, v, mask in; out back) a mesh
    # axis each, the MSA<-pair merge (max, sums), the symmetrisation's
    # transpose, the logits gather
    assert counts == {"all_to_all@spr": 5, "all_to_all@spc": 5, "all_reduce@seq": 2,
                      "all_to_all@seq": 1, "all_gather@world": 1}
    counts = {k: v["count"] for k, v in long["collectives"].items()}
    assert counts == {"all_to_all@sp": 5, "all_reduce@seq": 2, "all_to_all@seq": 1,
                      "all_gather@world": 1}
    for rec in (grid, long):
        pair = rec["pair_state"]
        assert pair["held_bytes"] * 4 == pair["whole_bytes"]  # a quarter a rank
        assert rec["budget"]["verdict"] == "no-data"  # the CPU measures no device memory
    for name in ("model_fwd", "serve_fwd", "serve_fwd_bf16"):
        assert doc[name]["collectives"] == {} and not doc[name]["sharded"]
    assert hlo_audit.findings_of(checked[1]["doc"]) == []


def test_two_ranks_shard_the_columns_only(tmp_path):
    doc = hlo_audit.spawn_doc(2, "cpu", SHARDED)
    grid, long = doc["targets"]["serve_fwd_grid"], doc["targets"]["serve_fwd_long"]
    assert (grid["mesh"], long["mesh"]) == ("dp1.spr1.spc2", "dp1.sp2")
    assert grid["seq_ranks"] == long["seq_ranks"] == 2
    assert grid["pair_state"]["held_bytes"] * 2 == grid["pair_state"]["whole_bytes"]
    assert hlo_audit.findings_of(doc) == []


def test_negative_control_fires_af2a107_and_af2a108(monkeypatch, capsys):
    monkeypatch.setenv("AF2TPU_AUDIT_DROP_SHARD_PAIR", "1")
    assert hlo_audit.main(["--check", "--device", "cpu", "--targets", SHARDED]) == 1
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    rules = {f["rule"] for f in summary["findings"]}
    assert {"AF2A107", "AF2A108"} <= rules
    assert "all_gather@seq count drift" in out and "the whole N^2 grid" in out


def _rec(**kw):
    rec = {"sharded": True, "seq_ranks": 4, "collective_count": 3, "comm_bytes": 30,
           "collectives": {"all_to_all@spr": {"count": 3, "bytes": 30, "max_bytes": 10}},
           "pair_state": {"held_bytes": 25, "whole_bytes": 100}, "hbm_budget_bytes": None,
           "budget": budgets.check_budget(None, None)}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("case, rule", [
    (dict(sharded=False), "AF2A109"),
    (dict(collective_count=0, collectives={}), "AF2A108"),
    (dict(pair_state={"held_bytes": 100, "whole_bytes": 100}), "AF2A108"),
    (dict(collectives={"all_to_all@spc": {"count": 1, "bytes": 100, "max_bytes": 100}}),
     "AF2A108"),
    (dict(budget=budgets.check_budget(20, 10)), "AF2A110"),
], ids=("collective-in-single-device", "inert-sharding", "replicated-pair",
        "blowup", "over-budget"))
def test_structural_rules(case, rule):
    assert [f.rule for f in hlo_audit.audit_record("t", _rec())] == []
    assert rule in [f.rule for f in hlo_audit.audit_record("t", _rec(**case))]


def test_one_sequence_rank_is_not_held_to_af2a108():
    """A world of one rank (the card's mesh) moves nothing across ranks."""
    rec = _rec(seq_ranks=1, pair_state={"held_bytes": 100, "whole_bytes": 100},
               collectives={"all_to_all@spc": {"count": 1, "bytes": 100, "max_bytes": 100}})
    assert hlo_audit.audit_record("t", rec) == []


def test_a_sharded_budget_holds_only_where_the_target_shards():
    """JAX's budgets of the sharded targets are per device of their sharded
    layout: on as many sequence ranks or more the rank's peak is held to
    the declared budget; on fewer (the card's world of one) the budget is
    scaled by the missing shards and the verdict stays measured;
    single-device targets always hold their own."""
    whole = budgets.check_rank_budget(70, 10, seq_ranks=1, budget_seq_ranks=8)
    assert whole["verdict"] == "pass" and whole["budget_bytes"] == 80
    assert (whole["declared_budget_bytes"], whole["budget_seq_ranks"], whole["seq_ranks"]) == (
        10, 8, 1)
    assert budgets.check_rank_budget(90, 10, seq_ranks=1, budget_seq_ranks=8)["verdict"] == (
        "over-budget")
    assert budgets.check_rank_budget(30, 10, seq_ranks=4, budget_seq_ranks=8)["budget_bytes"] == 20
    assert budgets.check_rank_budget(20, 10, seq_ranks=4, budget_seq_ranks=4) == (
        budgets.check_budget(20, 10))
    assert budgets.check_rank_budget(20, 10, seq_ranks=8, budget_seq_ranks=4) == (
        budgets.check_budget(20, 10))
    assert budgets.check_rank_budget(20, 10, seq_ranks=1) == budgets.check_budget(20, 10)
    assert budgets.check_rank_budget(None, 10, seq_ranks=1, budget_seq_ranks=8)["verdict"] == (
        "no-data")
    assert budgets.check_rank_budget(20, None, seq_ranks=1, budget_seq_ranks=8) == (
        budgets.check_budget(20, None))
    by_name = {t.name: t for t in targets.default_targets()}
    assert (by_name["serve_fwd_grid"].budget_seq_ranks,
            by_name["serve_fwd_long"].budget_seq_ranks) == (4, 8)


def test_update_check_and_exit_codes(checked, tmp_path, monkeypatch, capsys):
    doc = checked[1]["doc"]
    served = {"doc": doc}
    monkeypatch.setattr(hlo_audit, "spawn_doc", lambda *a, **k: copy.deepcopy(served["doc"]))
    base = str(tmp_path / "hlo.json")
    assert hlo_audit.main(["--check", "--device", "cpu", "--baseline", base]) == 2  # missing
    assert hlo_audit.main(["--update", "--device", "cpu", "--baseline", base]) == 0
    assert hlo_audit.main(["--check", "--device", "cpu", "--baseline", base]) == 0
    drifted = copy.deepcopy(doc)
    drifted["targets"]["serve_fwd_grid"]["collectives"]["all_to_all@spr"]["count"] += 1
    served["doc"] = drifted
    capsys.readouterr()
    assert hlo_audit.main(["--check", "--device", "cpu", "--baseline", base]) == 1
    assert "all_to_all@spr count drift: 5 -> 6" in capsys.readouterr().out
    stale = copy.deepcopy(doc)
    stale["torch_version"] = "0.0"
    served["doc"] = stale
    assert hlo_audit.main(["--check", "--device", "cpu", "--baseline", base]) == 0
    assert "STALE BASELINE" in capsys.readouterr().out
    bad = copy.deepcopy(doc)
    bad["targets"]["serve_fwd"]["collective_count"] = 1
    served["doc"] = bad
    assert hlo_audit.main(["--update", "--device", "cpu", "--baseline", base]) == 1
    assert "REFUSING" in capsys.readouterr().out
    assert hlo_audit.main(["--device", "cpu"]) == 2  # no mode
    assert hlo_audit.main(["--check", "--device", "cpu", "--targets", "nope"]) == 2


def test_the_audited_targets_stand_for_jax_hlo_targets():
    from alphafold2_tpu.analysis import targets as jax_targets

    jax_hlo = {t.name for t in jax_targets.default_targets() if t.hlo}
    assert set(hlo_audit.AUDITED) == jax_hlo
    ours = {t.name: t for t in targets.default_targets()}
    assert {n for n in hlo_audit.AUDITED if ours[n].sharded} == set(SHARDED.split(","))
    jax_budget = {t.name: t.hbm_budget_bytes for t in jax_targets.default_targets()}
    for name in SHARDED.split(","):
        assert ours[name].hbm_budget_bytes == jax_budget[name]
