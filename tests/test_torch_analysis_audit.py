"""The port's graph audit (alphafold2_tpu_torch/analysis/audit.py): each rule
flags its fixture (the backward of an autograd.Function included), a clean
module gives nothing, waivers need reasons, every registered target audits
clean on the CPU, the targets stand for the JAX registry's, and the CLI's
exit codes hold."""

import numpy as np
import pytest
import torch
from torch import nn

from alphafold2_tpu.analysis import targets as jax_targets
from alphafold2_tpu_torch.analysis import audit, budgets, lowering, targets

torch.set_num_threads(1)


def _target(fn, *args, **kw):
    return targets.TraceTarget(name="fixture", build=lambda device: (fn, args), **kw)


def _rules(fn, *args, **kw):
    report = audit.audit_target(_target(fn, *args, **kw), "cpu")
    return sorted({f.rule for f in report.findings}), report


def _x():
    return torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32))


class Clean(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(8, 8)

    def forward(self, x, mask):
        return self.lin(x) * mask[:, None].to(x.dtype)


def test_clean_module_gives_no_finding():
    model, mask = Clean(), torch.tensor([True, False, True, True])
    rules, report = _rules(lambda x: model(x, mask).sum().backward(), _x().requires_grad_())
    assert rules == [] and report.ops > 0
    assert "AddmmBackward0" in report.nodes  # the backward ran under the recorder


def test_float64_flagged():
    rules, report = _rules(lambda x: (x.double() * 2).float(), _x())
    assert rules == ["AF2A101"]
    assert "float64" in report.findings[0].message


def test_item_in_forward_flagged():
    class Syncs(nn.Module):
        def forward(self, x):
            return x / x.abs().max().item()

    assert _rules(Syncs(), _x())[0] == ["AF2A102"]


class _SyncInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        if g.abs().max().item() > 1e6:  # a host sync on every backward
            return g * 0
        return g * 2


def test_item_buried_in_autograd_function_backward_flagged():
    """Counterpart of the JAX auditor's callback buried in a custom VJP's
    backward: the recorder sees the backward and names its node."""
    rules, report = _rules(lambda x: _SyncInBackward.apply(x).sum().backward(),
                           _x().requires_grad_())
    assert rules == ["AF2A102"]
    assert "_SyncInBackwardBackward" in report.nodes
    assert "in _SyncInBackwardBackward" in report.findings[0].message


def test_large_host_tensor_per_call_flagged():
    table = np.ones((512, 1024), np.float32)  # 2 MiB

    def fwd(x):
        return x.sum() + torch.tensor(table).sum()

    rules, report = _rules(fwd, _x())
    assert rules == ["AF2A103"]
    assert "2097152 bytes" in report.findings[0].message
    small = np.ones((4, 4), np.float32)
    assert _rules(lambda x: x.sum() + torch.tensor(small).sum(), _x())[0] == []


def test_bool_float_product_flagged():
    mask = torch.tensor([True, False, True, True])
    rules, report = _rules(lambda x: x * mask[:, None], _x())
    assert rules == ["AF2A105"]
    assert "bool/float32" in report.findings[0].message


def test_mixed_float_widths_flagged_but_scalars_and_conditions_exempt():
    y = _x().to(torch.bfloat16)
    assert _rules(lambda x: x + y, _x())[0] == ["AF2A105"]
    mask = torch.tensor([True, False, True, True])

    def exempt(x):
        a = x.to(torch.bfloat16) * 2.0  # a Python scalar
        b = torch.where(mask[:, None], x, 0.0)  # a condition and a 0-d fill
        c = x.masked_fill(~mask[:, None], float("-inf"))  # a mask
        d = x.to(torch.bfloat16) * torch.tensor(0.5)  # a 0-d float tensor
        return a, b, c, d

    assert _rules(exempt, _x())[0] == []


def test_waived_rule_is_reported_apart():
    mask = torch.tensor([True, False, True, True])
    target = _target(lambda x: x * mask[:, None], _x(), allow=frozenset({"AF2A105"}),
                     allow_reasons={"AF2A105": "fixture"})
    report = audit.audit_target(target, "cpu")
    assert report.findings == [] and [f.rule for f in report.waived] == ["AF2A105"]


def test_waiver_without_reason_raises():
    with pytest.raises(ValueError, match="without a reason"):
        targets.TraceTarget(name="t", build=lambda device: None, allow=frozenset({"AF2A105"}))


def test_failing_target_is_af2a100():
    def boom(x):
        raise RuntimeError("no")

    assert _rules(boom, _x())[0] == ["AF2A100"]
    broken = targets.TraceTarget(name="b", build=lambda device: 1 / 0)
    assert [f.rule for f in audit.audit_target(broken, "cpu").findings] == ["AF2A100"]


@pytest.mark.parametrize("name", [t.name for t in targets.default_targets()])
def test_default_target_audits_clean_on_cpu(name):
    report = audit.audit_target(targets.target_by_name(name), "cpu")
    assert report.findings == [], "\n".join(f.format() for f in report.findings)
    assert report.ops > 0
    assert report.budget["verdict"] == "no-data"  # device memory is the card's to measure


def test_backward_nodes_of_the_attention_functions_are_recorded():
    """The audit must see the wrappers' backward work, not only the
    forward: FusedAttention and BlockSparseAttention's backward nodes."""
    grad = audit.audit_target(targets.target_by_name("train_grad"), "cpu")
    assert "FusedAttentionBackward" in grad.nodes
    sparse = audit.audit_target(targets.target_by_name("train_step_sparse"), "cpu")
    assert {"FusedAttentionBackward", "BlockSparseAttentionBackward"} <= set(sparse.nodes)


def test_target_names_stand_for_the_jax_registry():
    jax_names = {t.name for t in jax_targets.default_targets()}
    ours = {t.name for t in targets.default_targets()}
    assert ours == set(targets.JAX_COUNTERPARTS)
    mapped = {v for v in targets.JAX_COUNTERPARTS.values() if v is not None}
    assert mapped | set(targets.NOT_PORTED) == jax_names
    assert not mapped & set(targets.NOT_PORTED)


def test_budgets_match_the_jax_registry():
    jax_budget = {t.name: t.hbm_budget_bytes for t in jax_targets.default_targets()}
    for t in targets.default_targets():
        counterpart = targets.JAX_COUNTERPARTS[t.name]
        if counterpart in ("model_fwd", "serve_fwd", "serve_fwd_bf16"):
            assert t.hbm_budget_bytes == jax_budget[counterpart] == 64 << 20


def test_check_budget_verdicts():
    assert budgets.check_budget(10, 20) == {"program_bytes": 10, "budget_bytes": 20,
                                            "headroom_frac": 0.5, "verdict": "pass"}
    assert budgets.check_budget(30, 20)["verdict"] == "over-budget"
    assert budgets.check_budget(None, 20)["verdict"] == "no-data"
    assert budgets.check_budget(10, None)["verdict"] == "no-data"
    assert budgets.device_hbm_bytes("cpu") is None
    assert budgets.DEVICE_HBM_BYTES["H100 80GB HBM3"] == 80 << 30


def test_build_findings_fold_the_gate(monkeypatch):
    def failed(names):
        return ([{"case": "flash_axial_256", "status": "failed", "ok": False,
                  "launches": [{"problems": ["2048 threads a block"]}]},
                 {"case": "tied_row_bwd_256", "status": "not_ported", "ok": False},
                 {"case": lowering.CONTROL_CASE, "status": "failed", "ok": False,
                  "error": "the mis-tiled control BUILT"}], {})

    monkeypatch.setattr(lowering, "run_gate", failed)
    found = audit.build_findings()
    assert [(f.rule, f.target) for f in found] == [
        ("AF2A106", "flash_axial_256"), ("AF2A106", lowering.CONTROL_CASE)]

    def missing(names):
        raise lowering.ToolMissing("nvcc not found")

    monkeypatch.setattr(lowering, "run_gate", missing)
    assert [f.rule for f in audit.build_findings()] == ["AF2A106"]


def test_cli_exit_codes(monkeypatch, tmp_path, capsys):
    out = tmp_path / "audit.json"
    assert audit.main(["--device", "cpu", "--targets", "attn_axial", "--json", str(out)]) == 0
    assert '"tool": "audit"' in out.read_text()
    assert audit.main(["--device", "cpu", "--rules", "bogus"]) == 2
    assert audit.main(["--device", "cpu", "--targets", "nope"]) == 2
    # no card and no --device: the default is the card, so a usage error
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert audit.main(["--targets", "attn_axial"]) == 2
    assert "no CUDA device" in capsys.readouterr().out

    def findings(targets=None, device="cpu"):
        return [audit.TargetReport("t", "cpu", [audit._finding("AF2A105", "t", "x")], [])]

    monkeypatch.setattr(audit, "audit", findings)
    assert audit.main(["--device", "cpu"]) == 1
