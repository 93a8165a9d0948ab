"""``analysis/contracts.py``: the committed op census holds on the tree, a
seeded extra op is reported as drift with a per-op diff, another torch
version reads as a stale baseline (rc 0) and a missing one as rc 2, as
JAX's graph contracts do."""

import json

import pytest
import torch

from alphafold2_tpu_torch.analysis import contracts, targets


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def baseline():
    with open(contracts.DEFAULT_BASELINE, encoding="utf-8") as fh:
        return json.load(fh)


def test_committed_census_covers_the_registry(baseline):
    assert baseline["format"] == contracts.FORMAT_VERSION
    names = {t.name for t in targets.default_targets()}
    assert set(baseline["targets"]) == names
    assert not names & set(targets.NOT_PORTED)
    for fp in baseline["targets"].values():
        assert fp["n_ops"] == sum(fp["ops"].values()) > 0
        assert fp["inputs"] and fp["outputs"]


def test_check_is_clean_on_the_tree(baseline, capsys):
    assert contracts.main(["--check"]) == 0
    out = capsys.readouterr().out
    same = baseline["torch_version"] == torch.__version__
    want = "pass" if same else "stale-baseline"
    assert out.strip().splitlines()[-1].startswith(f"graph_contracts: verdict={want}")
    assert "DRIFT" not in out


def test_a_seeded_extra_op_is_drift_with_a_per_op_diff(baseline, tmp_path, monkeypatch):
    monkeypatch.setattr(contracts.torch, "__version__", baseline["torch_version"])
    target = targets.target_by_name("attn_tied_row")
    build = target.build

    def doubled(device):
        fn, args = build(device)
        return (lambda *a: fn(*a) * 2.0), args  # one more aten.mul

    seeded = targets.TraceTarget(name=target.name, build=doubled)
    path = tmp_path / "graph_contracts.json"
    contracts.write_contracts(str(path), {**baseline, "targets": {
        target.name: baseline["targets"][target.name]}})
    result = contracts.check_against(str(path), targets=[seeded])
    assert result["verdict"] == "drift"
    old = baseline["targets"][target.name]["ops"].get("mul.Tensor", 0)
    assert f"attn_tied_row: op count drift: mul.Tensor: {old} -> {old + 1} (+1)" in \
        result["diffs"]
    n = baseline["targets"][target.name]["n_ops"]
    assert f"attn_tied_row: n_ops: {n} -> {n + 1}" in result["diffs"]
    clean = contracts.check_against(str(path), targets=[target])
    assert clean["verdict"] == "pass" and clean["diffs"] == []


def test_signature_changes_and_target_sets_are_named(baseline):
    name = "attn_axial"
    cur = {"targets": {name: dict(baseline["targets"][name], inputs=["float32[9]"]),
                       "new_one": {"ops": {}}}}
    lines = contracts.diff_contracts({"targets": {name: baseline["targets"][name],
                                                  "gone": {}}}, cur)
    assert "gone: target removed (was under contract)" in lines
    assert "new_one: new target (no committed contract)" in lines
    assert any(line.startswith(f"{name}: input signature changed") for line in lines)


def test_foreign_version_is_stale_and_missing_is_rc2(baseline, tmp_path, capsys):
    path = tmp_path / "graph_contracts.json"
    contracts.write_contracts(str(path), {**baseline, "torch_version": "0.0.0"})
    assert contracts.check_against(str(path))["verdict"] == "stale-baseline"
    assert contracts.main(["--check", "--baseline", str(path)]) == 0
    assert "stale-baseline" in capsys.readouterr().out
    assert contracts.main(["--check", "--baseline", str(tmp_path / "none.json")]) == 2
