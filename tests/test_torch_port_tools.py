"""The port's tools against the JAX package's scripts:
``profile_step`` (``scripts/profile_step.py``), ``bisect_perf``
(``scripts/bisect_perf.py``) and ``validate_structure_math``
(``scripts/validate_structure_math.py``), on the CPU at tiny shapes.

- ``profile_step --device cpu`` writes a Chrome trace and summarizes it;
  ``summarize`` sums a hand-made trace's device lanes (kernels, memcpys,
  memsets) and nothing of the host's, and falls back to the CPU ops with
  a warning where the trace has no device lane.
- ``bisect_perf``: each module's flops under each kernel policy equal a
  separate ``observe/flops.py count_call`` of the same module and inputs.
- ``validate_structure_math``: the verdict lines of the JAX script, its
  Kabsch, noise and PDB metrics within 1e-4, and its MDS round trip from
  the same start within 2e-3 on RMSD and TMscore and 1% on the final
  stress (float32 roundoff over 200 SMACOF iterations: 3.7e-3 relative on
  the stress between the two packages from one start); the start itself
  bit-equal to JAX's draw.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu_torch import bisect_perf, profile_step, validate_structure_math

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"AF2TPU_BENCH_DIM": "32", "AF2TPU_BENCH_DEPTH": "1", "AF2TPU_BENCH_CROP": "16",
        "AF2TPU_BENCH_MSA_DEPTH": "2", "AF2TPU_BENCH_MSA_LEN": "16"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def tiny(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)


# ------------------------------------------------------------ profile_step


def test_profile_step_writes_a_trace_on_the_cpu(tiny, monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("AF2TPU_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("AF2TPU_PROFILE_STEPS", "2")
    assert profile_step.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    path = tmp_path / "trace_steps_0_1.json"
    assert path.exists() and json.loads(path.read_text())["traceEvents"]
    assert "WARNING: no device lane" in err
    assert f"trace: {path}" in out and "CPU op time (nested) total" in out
    assert re.search(r"^\s+\d+\s+[\d.]+\s+aten::", out, re.M)
    cfg = profile_step.bench_config()
    assert (cfg.model.dim, cfg.model.depth, cfg.data.crop_len, cfg.model.max_seq_len) == (
        32, 1, 16, 32)
    assert cfg.model.msa_tie_row_attn and cfg.model.bfloat16


def _event(cat, name, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "dur": dur, "ts": 0, "pid": 0, "tid": 0}


def test_summarize_sums_only_the_device_lanes(tmp_path):
    """Host spans (CPU ops, the runtime's launches, Python frames, user
    annotations) cover the kernels' wall time again: only kernel, memcpy
    and memset events are summed, by name, µs a step."""
    events = [
        _event("cpu_op", "aten::mm", 900.0), _event("cuda_runtime", "cudaLaunchKernel", 50.0),
        _event("python_function", "step", 5000.0), _event("user_annotation", "train", 4000.0),
        _event("gpu_user_annotation", "train", 4000.0),
        _event("kernel", "attention_kernel_sm90<64>", 300.0),
        _event("kernel", "attention_kernel_sm90<64>", 100.0),
        _event("kernel", "gemm", 200.0),
        _event("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 60.0),
        _event("gpu_memset", "Memset (Device)", 40.0),
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = io.StringIO()
    rows = profile_step.summarize(str(path), n_steps=2, out=out)
    assert rows == [("attention_kernel_sm90<64>", 200.0, pytest.approx(4 / 7)),
                    ("gemm", 100.0, pytest.approx(2 / 7)),
                    ("Memcpy DtoD (Device -> Device)", 30.0, pytest.approx(0.6 / 7)),
                    ("Memset (Device)", 20.0, pytest.approx(0.4 / 7))]
    assert "device op time total: 0.70 ms over 2 steps (0.35 ms/step)" in out.getvalue()


def test_summarize_without_a_device_lane_sums_cpu_ops_with_a_warning(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        _event("cpu_op", "aten::mm", 90.0), _event("cpu_op", "aten::add", 10.0),
        _event("python_function", "step", 500.0)]}))
    rows = profile_step.summarize(str(path), n_steps=1, out=io.StringIO())
    assert rows == [("aten::mm", 90.0, 0.9), ("aten::add", 10.0, 0.1)]
    assert "WARNING: no device lane" in capsys.readouterr().err


# ------------------------------------------------------------- bisect_perf


@pytest.mark.parametrize("ab", ["1", "0"])
def test_bisect_perf_flops_are_count_calls(tiny, monkeypatch, capsys, ab):
    """Under each kernel policy: the policies count different work (the
    hand kernels' backward recomputes S and dP, SDPA's formula counts its
    own), so each is held to its own count. ``AF2TPU_BENCH_AB=0`` runs the
    hand kernels alone."""
    from alphafold2_tpu_torch.observe.flops import count_call
    from alphafold2_tpu_torch.ops.kernels import parse_policy, use_kernel_policy

    monkeypatch.setattr(bisect_perf, "ITERS", 1)
    monkeypatch.setenv("AF2TPU_BENCH_AB", ab)
    got = bisect_perf.measure(device="cpu")
    want_policies = list(bisect_perf.POLICIES) if ab == "1" else ["hand kernels"]
    assert list(got) == want_policies
    out = capsys.readouterr().out
    assert out.count("sum of micro-times (one of each)") == len(want_policies)
    modules = bisect_perf.hot_modules("cpu")
    names = [m[0] for m in modules]
    assert names == ["pair AxialAttention (grid)", "msa AxialAttention tied", "cross pair<-msa",
                     "cross msa<-pair", "pair FeedForward", "msa FeedForward"]
    for label, rec in got.items():
        for (name, module, args, kwargs), row in zip(modules, rec["rows"]):
            with use_kernel_policy(parse_policy(bisect_perf.POLICIES[label])):
                want = count_call(bisect_perf._fwd_bwd, module, args, kwargs, device="cpu")[1]
            assert row["name"] == name and row["ms"] > 0
            assert row["flops"] == want.flops > 0, (label, name)
        assert rec["total_ms"] == pytest.approx(sum(r["ms"] for r in rec["rows"]))


# ------------------------------------------------- validate_structure_math


def _run(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = fn()
    return code, buf.getvalue()


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", line)]


@pytest.fixture(scope="module")
def validations():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_structure_math", os.path.join(REPO, "scripts",
                                                    "validate_structure_math.py"))
    module = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = ["validate_structure_math.py"]
    try:
        spec.loader.exec_module(module)
        jax_code, jax_out = _run(module.main)
    finally:
        sys.argv = argv
    port_code, port_out = _run(lambda: validate_structure_math.main([]))
    return (jax_code, jax_out.splitlines()), (port_code, port_out.splitlines())


def test_validate_structure_math_matches_the_jax_script(validations):
    (jax_code, jax_lines), (port_code, port_lines) = validations
    assert jax_code == port_code == 0
    assert port_lines[-1] == jax_lines[-1] == "ALL OK"
    verdict = re.compile(r"^\s+\[(ok|FAIL)\] ([^:]+):")
    assert ([verdict.match(x).groups() for x in port_lines if verdict.match(x)]
            == [verdict.match(x).groups() for x in jax_lines if verdict.match(x)])
    assert len(port_lines) == len(jax_lines)
    for mine, theirs in zip(port_lines, jax_lines):
        assert re.sub(r"-?\d+\.\d+(?:e[-+]\d+)?", "#", mine) == re.sub(
            r"-?\d+\.\d+(?:e[-+]\d+)?", "#", theirs)
        a, b = _numbers(mine), _numbers(theirs)
        if "final stress" in mine:  # stress, rmsd, tm after 200 iterations
            assert a[0] == pytest.approx(b[0], rel=1e-2)
            np.testing.assert_allclose(a[1:], b[1:], atol=2e-3, rtol=0)
        elif "mds " not in mine:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=mine)


def test_the_mds_start_is_jaxs_draw():
    for n in (5, 96):
        want = 2.0 * jax.random.uniform(jax.random.key(0), (1, n, 3), np.float32) - 1.0
        np.testing.assert_array_equal(validate_structure_math.jax_default_start(n),
                                      np.asarray(want))


def test_validate_structure_math_on_a_pdb_file(tmp_path, capsys):
    from alphafold2_tpu_torch.utils import pdb as pdbio

    ca = validate_structure_math.load_ca(None).T
    path = tmp_path / "chain.pdb"
    path.write_text(pdbio.to_pdb_string(pdbio.backbone_to_pdb("A" * len(ca), ca)))
    assert validate_structure_math.main(["--pdb", str(path)]) == 0
    out = capsys.readouterr().out
    assert f"loaded {path}: 96 residues" in out and out.strip().endswith("ALL OK")
