"""The port's examples (``alphafold2_tpu_torch/examples``, the counterparts
of the repo's ``examples/01-05``) run as a user runs them: each in its own
process at ``EX_TINY=1`` with ``--device cpu``, exiting 0 and ending in
``ok``; 05 under ``torchrun`` with 4 gloo ranks, a 2 x 2 (dp, sp) mesh with
ring context parallelism; the runner (``python -m
alphafold2_tpu_torch.examples``) runs several in one process."""

import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "alphafold2_tpu_torch", "examples", "0*.py")))
SINGLE = [p for p in EXAMPLES if not os.path.basename(p).startswith("05")]


def _env():
    env = dict(os.environ, EX_TINY="1", OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    return env


def test_the_five_examples_exist():
    assert [os.path.basename(p)[:2] for p in EXAMPLES] == ["01", "02", "03", "04", "05"]


@pytest.mark.parametrize("path", SINGLE, ids=[os.path.basename(p) for p in SINGLE])
def test_example_runs_on_the_cpu(path):
    proc = subprocess.run([sys.executable, path, "--device", "cpu"], env=_env(),
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, f"{path} failed:\n{proc.stdout}\n{proc.stderr}"
    assert proc.stdout.strip().endswith("ok"), proc.stdout


def test_distributed_example_on_four_gloo_ranks():
    path = EXAMPLES[-1]
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "4", path, "--device", "cpu"], env=_env(),
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, f"{path} failed:\n{proc.stdout}\n{proc.stderr}"
    out = proc.stdout
    assert "mesh: 2 data-parallel x 2 sequence-parallel (gloo, cpu)" in out
    assert out.count("step ") == 3 and out.strip().endswith("ok"), out


def test_the_runner_runs_examples_in_one_process():
    proc = subprocess.run([sys.executable, "-m", "alphafold2_tpu_torch.examples", "01", "04",
                           "--device", "cpu"], env=_env(), capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    chunks = proc.stdout.split("== ")[1:]
    assert [c.splitlines()[0] for c in chunks] == ["01_distogram_basics.py",
                                                  "04_structure_realization.py"]
    assert all(c.strip().endswith("ok") for c in chunks), proc.stdout
