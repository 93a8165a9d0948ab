"""``python -m alphafold2_tpu_torch.predict`` against the JAX package's
end-to-end model on the same parameters.

The JAX model's parameters go through ``convert.to_state_dict`` into a
checkpoint the port's ``CheckpointManager`` writes; the CLI restores it
with ``--checkpoint``. The two packages draw the MDS start differently
(threefry against the port's position-keyed draw), so the CLI gets JAX's
start injected where ``realize_structure`` draws it. The distogram and the
confidence weights compare at 1e-4 before MDS; the structure after Kabsch
alignment (RMSD at most 1e-3 A), never point by point. The kernel policy
reaches the CLI through ``serve.kernels`` and ``AF2TPU_KERNELS``.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.train.end2end import End2EndModel as JEnd2End
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch import predict as tpredict
from alphafold2_tpu_torch.config import Config, parse_cli
from alphafold2_tpu_torch.ops.cuda import axial
from alphafold2_tpu_torch.train.checkpoint import CheckpointManager
from alphafold2_tpu_torch.train.loop import TrainState
from alphafold2_tpu_torch.train.optim import build_optimizer
from alphafold2_tpu_torch.utils import pdb as tpdb
from alphafold2_tpu_torch.utils.metrics import kabsch

SEQ = "MKTAYIAKQRQI"
DEPTH = 2  # synthesized MSA rows
OVERRIDES = ["model.dim=16", "model.depth=1", "model.heads=2", "model.dim_head=8",
             "model.max_seq_len=48", "model.bfloat16=false", f"data.msa_depth={DEPTH}"]
RMSD_BOUND = 1e-3  # Angstrom, Kabsch-aligned


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.delenv("AF2TPU_KERNELS", raising=False)


def _jax_start(n):
    draw = jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(jax.random.key(0), i), (3,), jnp.float32))(jnp.arange(n))
    return np.array(2.0 * draw - 1.0)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(JAX outputs, checkpoint dir) for SEQ at --seed 0."""
    tokens = tpredict.encode_sequence(SEQ)
    msa = tpredict.synthesize_msa(tokens, DEPTH, seed=0)
    mask, msa_mask = np.ones((1, len(SEQ)), bool), np.ones((1, DEPTH, len(SEQ)), bool)
    cfg = parse_cli(OVERRIDES, Config())
    m = cfg.model
    jm = JEnd2End(dim=m.dim, depth=m.depth, heads=m.heads, dim_head=m.dim_head,
                  max_seq_len=m.max_seq_len, mds_iters=200, msa_tie_row_attn=False,
                  mds_per_position_init=True)
    params = jax.jit(lambda: jm.init(jax.random.key(3), tokens, msa, mask=mask,
                                     msa_mask=msa_mask))()
    ref = jax.jit(lambda p: jm.apply(p, tokens, msa, mask=mask, msa_mask=msa_mask))(params)
    model = tpredict.build_model(cfg)
    model.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), model))
    ckpt = tmp_path_factory.mktemp("ckpt")
    CheckpointManager(str(ckpt)).save(
        1, TrainState(model=model, optimizer=build_optimizer(cfg, list(model.parameters()))))
    out = jax.tree.map(lambda a: np.asarray(a)[0], ref)
    return out, str(ckpt)


def _main(argv, monkeypatch):
    """Run the CLI with JAX's MDS start injected; returns its Prediction."""
    seen = []
    real = tpredict.predict

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(tpredict, "predict", spy)
    monkeypatch.setattr(tpredict, "position_keyed_init", lambda n, seed: _jax_start(n))
    assert tpredict.main(argv) == 0
    return seen[0]


def test_cli_matches_the_jax_end_to_end_model(reference, tmp_path, monkeypatch, capsys):
    ref, ckpt = reference
    out = tmp_path / "pred.pdb"
    pred = _main(["--seq", SEQ, "--checkpoint", ckpt, "--out", str(out), "--device=cpu",
                  *OVERRIDES], monkeypatch)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert np.abs(pred.distogram - ref["distogram"]).max() < 1e-4
    assert np.abs(pred.weights - ref["weights"]).max() < 1e-4
    x = torch.from_numpy(pred.atom14.reshape(-1, 3).T[None].astype(np.float64))
    y = torch.from_numpy(ref["refined"].reshape(-1, 3).T[None].astype(np.float64))
    xa, yc = kabsch(x, y)
    assert float(torch.sqrt(((xa - yc) ** 2).sum(1).mean())) < RMSD_BOUND
    # the PDB holds the backbone at three decimals; the line is JAX's
    back = tpdb.load_pdb(str(out))
    assert len(np.unique(back.resseq)) == len(SEQ)
    assert np.abs(back.coords - pred.backbone.reshape(-1, 3)).max() <= 5.1e-4
    ca = pred.backbone[:, 1]
    d = np.linalg.norm(ca[1:] - ca[:-1], axis=-1)
    assert line == (f"wrote {out}: {len(SEQ)} residues, mean consecutive CA-CA distance "
                    f"{d.mean():.2f} A, mean confidence weight {pred.weights.mean():.3f}")


@pytest.mark.parametrize("how", ["serve.kernels", "AF2TPU_KERNELS"])
def test_the_kernel_policy_reaches_the_cli(how, reference, tmp_path, monkeypatch):
    _, ckpt = reference
    argv = ["--seq", SEQ, "--checkpoint", ckpt, "--out", str(tmp_path / "p.pdb"),
            "--device=cpu", *OVERRIDES]
    axial.fused_attention_reference.calls = 0
    base = _main(argv, monkeypatch)
    # K1's route (its plain version on the CPU): the pair axial passes, the
    # MSA's two axial passes (untied rows) and the two cross passes
    assert axial.fused_attention_reference.calls == 6
    if how == "serve.kernels":
        argv.append("serve.kernels=axial=stock,flash=on")
    else:
        monkeypatch.setenv("AF2TPU_KERNELS", "axial=stock,flash=on")
    axial.fused_attention_reference.calls = 0
    stock = _main(argv, monkeypatch)
    assert axial.fused_attention_reference.calls == 0  # SDPA on every K1 pass
    assert np.abs(stock.distogram - base.distogram).max() < 1e-4


def test_module_runs_as_a_program(tmp_path):
    out = tmp_path / "p.pdb"
    proc = subprocess.run([sys.executable, "-m", "alphafold2_tpu_torch.predict", "--seq",
                           "ACDEFGHIK", "--out", str(out), "--device=cpu", *OVERRIDES],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith(f"wrote {out}: 9 residues, ")
    assert out.exists()
