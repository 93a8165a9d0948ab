"""The kernel switchboard (``ops/kernels.py``) against the JAX package's.

Specs parse, describe and fail as JAX's do. Every route a policy selects
(K1, SDPA, the plain version; K2 or its plain version; K4, the plain
gather version or SDPA with the layout mask) agrees with JAX's flax
modules on converted weights within 1e-4 on valid positions, masked and
padded; the whole model's logits under ``auto``, ``stock`` and ``dense``
agree with JAX's; gradients under ``stock`` and ``dense`` agree with
``jax.grad``. The policy is thread-local, and a serving engine's holds on
its pipeline's device worker; its key and compile records carry it. On the
CPU the kernel routes run the wrappers' plain versions, so "which route
ran" is read from the plain versions' ``.calls`` and from spies.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models.alphafold2 import Alphafold2 as JAlphafold2
from alphafold2_tpu.ops import attention as jattn
from alphafold2_tpu.ops import kernels as jkernels
from alphafold2_tpu.ops import sparse as jsparse
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.observe.regress import comparable_reason
from alphafold2_tpu_torch.ops import attention as tattn
from alphafold2_tpu_torch.ops import kernels as tkernels
from alphafold2_tpu_torch.ops import sparse as tsparse
from alphafold2_tpu_torch.ops.cuda import axial, block_sparse, tied_row
from alphafold2_tpu_torch.ops.kernels import KernelPolicy, parse_policy, use_kernel_policy
from alphafold2_tpu_torch.serve.engine import ServeEngine

ATOL = 1e-4
DIM, HEADS, DH = 16, 2, 8


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.delenv("AF2TPU_KERNELS", raising=False)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tail(b, n, lengths):
    m = np.zeros((b, n), bool)
    for i, L in enumerate(lengths):
        m[i, :L] = True
    return m


# ----------------------------------------------------------------- specs

SPECS = ["", None, "auto", "  auto ", "tied_row=pallas", "axial=pallas,tied_row=pallas",
         "axial=stock,flash=on", "axial=dense,flash=off,tied_row=dense",
         "block_sparse=splash", "flash=off,block_sparse=jnp", "axial=pallas, ,",
         "axial=stock,axial=dense", " axial = stock", "axial=bogus", "bogus=1", "axial",
         "flash=on,tied_row=stock", "=pallas", "block_sparse=auto,flash=auto"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_describe_match_jax(spec):
    try:
        want = jkernels.parse_policy(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_policy(spec)
        assert str(got.value) == str(e)
        return
    ours = parse_policy(spec)
    assert ours.describe() == want.describe()
    assert {f: getattr(ours, f) for f in tkernels._CHOICES} == {
        f: getattr(want, f) for f in jkernels._CHOICES}


def test_choices_env_and_thread_locality(monkeypatch):
    assert tkernels._CHOICES == jkernels._CHOICES and tkernels.ENV_VAR == jkernels.ENV_VAR
    with pytest.raises(ValueError) as got:
        KernelPolicy(axial="flash")
    with pytest.raises(ValueError) as want:
        jkernels.KernelPolicy(axial="flash")
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("AF2TPU_KERNELS", "axial=stock")
    assert tkernels.current_policy().describe() == "axial=stock"
    seen = {}

    def other():
        seen["other"] = tkernels.current_policy().describe()

    with use_kernel_policy(KernelPolicy(tied_row="dense")):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        seen["here"] = tkernels.current_policy().describe()
        with use_kernel_policy(None):
            seen["none"] = tkernels.current_policy().describe()
    assert seen == {"other": "axial=stock", "here": "tied_row=dense", "none": "tied_row=dense"}
    assert tkernels.current_policy().describe() == "axial=stock"


def test_resolution_means_the_hand_kernels_under_auto():
    auto = KernelPolicy()
    assert (tkernels.resolve_axial(auto), tkernels.resolve_flash(auto),
            tkernels.resolve_tied_row(auto), tkernels.resolve_block_sparse(auto)) == (
        "pallas", "pallas", "pallas", "pallas")
    # JAX's auto for the axial pass is its stock kernel: the one settled difference
    assert jkernels.resolve_axial(jkernels.KernelPolicy()) == "stock"
    on, off = KernelPolicy(flash="on"), KernelPolicy(flash="off")
    assert (tkernels.resolve_flash(on), tkernels.resolve_flash(off)) == ("stock", "dense")
    assert tkernels.resolve_flash(auto, use_flash=True) == "stock"
    assert tkernels.resolve_flash(on, use_flash=False) == "dense"
    for choice in ("pallas", "jnp", "splash"):
        assert tkernels.resolve_block_sparse(KernelPolicy(block_sparse=choice)) == choice


# ---------------------------------------------------------------- routes


_REFS: dict = {}


def _load(key, jax_module, torch_module, *args, **kwargs):
    """Init ``jax_module`` on the inputs and apply it (once per ``key``:
    the policies of one case share the reference), and load its weights
    into ``torch_module``; returns (params, JAX output as numpy)."""
    if key not in _REFS:
        jargs = [jnp.asarray(a) for a in args]
        arrays = {k: jnp.asarray(v) for k, v in kwargs.items() if isinstance(v, np.ndarray)}
        static = {k: v for k, v in kwargs.items() if not isinstance(v, np.ndarray)}
        # one compiled program each: far cheaper than flax's op-by-op dispatch
        params = jax.jit(lambda *a, **k: jax_module.init(jax.random.key(0), *a, **k, **static))(
            *jargs, **arrays)
        ref = np.asarray(jax.jit(lambda p, *a, **k: jax_module.apply(p, *a, **k, **static))(
            params, *jargs, **arrays))
        _REFS[key] = params, ref
    params, ref = _REFS[key]
    torch_module.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params),
                                                       torch_module))
    return params, ref


def _run(torch_module, policy, *args, **kwargs):
    targs = [torch.from_numpy(a) for a in args]
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    with torch.no_grad(), use_kernel_policy(policy):
        return torch_module(*targs, **tkw).numpy()


def _close(ref, out, valid):
    valid = np.broadcast_to(valid, ref.shape)
    assert out.shape == ref.shape
    assert np.abs(np.where(valid, out - ref, 0)).max() < ATOL


def _calls():
    return (axial.fused_attention_reference.calls, tied_row.tied_row_attention_reference.calls)


@pytest.fixture
def counts():
    axial.fused_attention_reference.calls = 0
    tied_row.tied_row_attention_reference.calls = 0
    block_sparse.block_sparse_attention_reference.calls = 0
    return _calls


FLASH = {"auto": 1, "on": 0, "off": 1}  # K1's plain version runs (the kernel route on the CPU)


@pytest.mark.parametrize("flash", ["auto", "on", "off"])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_flat_attention_routes_match_flax(kind, flash, counts):
    jmod = jattn.Attention(dim=DIM, heads=HEADS, dim_head=DH)
    tmod = tattn.Attention(DIM, HEADS, DH)
    x, mask = _randn(1, 2, 9, DIM), _tail(2, 9, [9, 6])
    kw = {"mask": mask}
    if kind == "cross":
        kw.update(context=_randn(3, 2, 11, DIM), context_mask=_tail(2, 11, [8, 11]))
    _, ref = _load(f"flat-{kind}", jmod, tmod, x, **kw)
    out = _run(tmod, KernelPolicy(flash=flash), x, **kw)
    _close(ref, out, mask[..., None])
    assert counts() == (FLASH[flash], 0)


@pytest.mark.parametrize("tied", ["auto", "pallas", "dense"])
def test_tied_row_routes_match_flax(tied, counts):
    jmod = jattn.Attention(dim=DIM, heads=HEADS, dim_head=DH)
    tmod = tattn.Attention(DIM, HEADS, DH)
    x = _randn(4, 6, 10, DIM)
    mask = _tail(6, 10, [8, 8, 8, 7, 0, 7])  # column padding, one fully masked row
    _, ref = _load("tied", jmod, tmod, x, mask=mask, tie_dim=3)
    out = _run(tmod, KernelPolicy(tied_row=tied), x, mask=mask, tie_dim=3)
    _close(ref, out, mask[..., None])
    assert counts() == (0, 1)


AXIAL = {"auto": 2, "pallas": 2, "stock": 0, "dense": 2}


@pytest.mark.parametrize("choice", ["auto", "pallas", "stock", "dense"])
@pytest.mark.parametrize("route", ["grid", "flat_context", "flat_tied"])
def test_axial_attention_routes_match_flax(route, choice, counts):
    b, h, w = 2, 6, 7
    x = _randn(5, b, h, w, DIM)
    mask = _tail(b, h, [6, 4])[:, :, None] & _tail(b, w, [7, 5])[:, None, :]
    tie = route == "flat_tied"
    jmod = jattn.AxialAttention(dim=DIM, heads=HEADS, dim_head=DH, tie_row_attn=tie)
    tmod = tattn.AxialAttention(DIM, HEADS, DH, tie_row_attn=tie)
    kw = {"mask": mask}
    if route == "flat_context":
        kw.update(context=_randn(6, b, 5, DIM), context_mask=_tail(b, 5, [5, 3]))
    _, ref = _load(f"axial-{route}", jmod, tmod, x, **kw)
    # the grid passes follow axial, the flat ones flash, tied rows tied_row
    policy = {"grid": KernelPolicy(axial=choice),
              "flat_context": KernelPolicy(flash={"pallas": "auto", "stock": "on",
                                                  "dense": "off"}.get(choice, choice)),
              "flat_tied": KernelPolicy(axial=choice, tied_row="dense" if choice == "dense"
                                        else "auto")}[route]
    out = _run(tmod, policy, x, **kw)
    _close(ref, out, mask[..., None])
    k1 = {"grid": AXIAL[choice], "flat_context": AXIAL[choice], "flat_tied": 1}[route]
    assert counts() == (k1, int(tie))


@pytest.mark.parametrize("use_flash", [True, False])
def test_use_flash_wins_over_the_policy(use_flash, counts, monkeypatch):
    """An explicit use_flash bool (model.flash_attention) is JAX's: it wins
    over flash, and over axial=auto on the grid passes."""
    jmod = jattn.AxialAttention(dim=DIM, heads=HEADS, dim_head=DH, use_flash=use_flash)
    tmod = tattn.AxialAttention(DIM, HEADS, DH)
    for m in (tmod.attn_width, tmod.attn_height):
        m.use_flash = use_flash
    x, mask = _randn(7, 1, 5, 5, DIM), np.ones((1, 5, 5), bool)
    _, ref = _load(f"use_flash-{use_flash}", jmod, tmod, x, mask=mask)
    out = _run(tmod, KernelPolicy(flash="on" if not use_flash else "off"), x, mask=mask)
    _close(ref, out, mask[..., None])
    assert counts() == (0 if use_flash else 2, 0)
    # axial set explicitly wins over use_flash on the grid passes
    _run(tmod, KernelPolicy(axial="pallas"), x, mask=mask)
    assert counts() == (2 if use_flash else 4, 0)
    # model.flash_attention reaches every Attention through build_model
    from alphafold2_tpu_torch.train.loop import build_model

    cfg = Config()
    cfg.model.dim, cfg.model.depth, cfg.model.heads, cfg.model.dim_head = 16, 1, 2, 8
    cfg.model.flash_attention = use_flash
    mods = [m for m in build_model(cfg).modules() if isinstance(m, tattn.Attention)]
    assert mods and all(m.use_flash is use_flash for m in mods)


def test_default_policy_is_the_kernel_wrappers(monkeypatch):
    """auto calls exactly the wrappers the parent called, with the same
    arguments, so its outputs are the parent's bit for bit."""
    seen = []
    real = tattn.fused_attention

    def spy(*a, **k):
        seen.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tattn, "fused_attention", spy)
    tmod = tattn.AxialAttention(DIM, HEADS, DH)
    x, mask = _randn(8, 1, 4, 6, DIM), _tail(1, 4, [3])[:, :, None] & np.ones((1, 1, 6), bool)
    auto = _run(tmod, KernelPolicy(), x, mask=mask)
    named = _run(tmod, KernelPolicy(axial="pallas", flash="auto"), x, mask=mask)
    assert len(seen) == 4 and np.array_equal(auto, named)


@pytest.mark.parametrize("policy", ["auto", "axial=stock,flash=on",
                                    "axial=dense,flash=off,tied_row=dense"])
def test_model_logits_match_flax(policy):
    rng = np.random.default_rng(9)
    b, n, rows = 2, 9, 3
    seq = rng.integers(0, 20, (b, n)).astype(np.int32)
    msa = rng.integers(0, 20, (b, rows, n)).astype(np.int32)
    mask = _tail(b, n, [9, 6])
    msa_mask = np.broadcast_to(mask[:, None], (b, rows, n)).copy()
    jmod = JAlphafold2(dim=DIM, depth=1, heads=HEADS, dim_head=DH, max_seq_len=32,
                       msa_tie_row_attn=True)
    tmod = Alphafold2(DIM, max_seq_len=32, depth=1, heads=HEADS, dim_head=DH,
                      msa_tie_row_attn=True)
    _, ref = _load("model", jmod, tmod, seq, msa, mask=mask, msa_mask=msa_mask)
    out = _run(tmod, parse_policy(policy), seq.astype(np.int64), msa.astype(np.int64),
               mask=mask, msa_mask=msa_mask)
    _close(ref, out, (mask[:, :, None] & mask[:, None, :])[..., None])


@pytest.mark.parametrize("policy", ["axial=stock,flash=on", "axial=dense,flash=off,tied_row=dense"])
@pytest.mark.parametrize("route", ["grid", "flat_tied"])
def test_gradients_match_jax_grad(route, policy):
    b, h, w = 2, 5, 6
    x = _randn(11, b, h, w, DIM)
    mask = _tail(b, h, [5, 3])[:, :, None] & _tail(b, w, [6, 4])[:, None, :]
    tie = route == "flat_tied"
    jmod = jattn.AxialAttention(dim=DIM, heads=HEADS, dim_head=DH, tie_row_attn=tie)
    tmod = tattn.AxialAttention(DIM, HEADS, DH, tie_row_attn=tie)
    params, _ = _load(f"grad-{route}", jmod, tmod, x, mask=mask)
    weight = _randn(12, b, h, w, DIM) * mask[..., None]

    def jloss(p, xx):
        return jnp.sum(jmod.apply(p, xx, mask=jnp.asarray(mask)) * weight)

    if f"jgrad-{route}" not in _REFS:
        _REFS[f"jgrad-{route}"] = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    jgp, jgx = _REFS[f"jgrad-{route}"]
    tx = torch.from_numpy(x).requires_grad_()
    with use_kernel_policy(parse_policy(policy)):
        loss = (tmod(tx, mask=torch.from_numpy(mask)) * torch.from_numpy(weight)).sum()
        loss.backward()
    # a masked query's output is 0 in the port and uniform attention in JAX,
    # so the input gradient compares at valid positions
    gx = np.where(mask[..., None], tx.grad.numpy() - np.asarray(jgx), 0)
    assert np.abs(gx).max() < ATOL
    want = convert.to_state_dict(jax.tree.map(np.asarray, jgp), tmod)
    for name, prm in tmod.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("choice", ["pallas", "jnp", "splash"])
def test_block_sparse_routes_match_flax(choice, counts):
    cfg_t = tsparse.BlockSparseConfig(block_size=16, num_random_blocks=1)
    cfg_j = jsparse.BlockSparseConfig(block_size=16, num_random_blocks=1)
    jmod = jsparse.SparseAttention(dim=DIM, heads=HEADS, dim_head=DH, seq_len=64,
                                   config=cfg_j, use_pallas=False)
    tmod = tsparse.SparseAttention(DIM, HEADS, DH, seq_len=64, config=cfg_t)
    x, mask = _randn(13, 2, 60, DIM), _tail(2, 60, [60, 37])
    _, ref = _load("sparse", jmod, tmod, x, mask=mask)
    out = _run(tmod, KernelPolicy(block_sparse=choice), x, mask=mask)
    _close(ref, out, mask[..., None])
    # on the CPU pallas runs K4's plain version through the wrapper, jnp calls it
    # directly: both count a call; splash runs SDPA
    assert block_sparse.block_sparse_attention_reference.calls == (choice != "splash")


def test_block_sparse_precedence_is_jax():
    """A non-auto backend, then the policy."""
    with use_kernel_policy(KernelPolicy(block_sparse="splash")):
        assert tsparse.SparseAttention(DIM, HEADS, DH)._impl() == "splash"
        for backend in ("pallas", "jnp"):
            cfg = tsparse.BlockSparseConfig(backend=backend)
            assert tsparse.SparseAttention(DIM, HEADS, DH, config=cfg)._impl() == backend


# ---------------------------------------------------------------- engine


def _tiny_cfg(kernels="", depth=2):
    cfg = Config()
    m = cfg.model
    m.dim, m.depth, m.heads, m.dim_head, m.max_seq_len, m.bfloat16 = 16, 1, 2, 8, 48, False
    m.msa_tie_row_attn = True
    cfg.serve.buckets, cfg.serve.max_batch, cfg.serve.mds_iters = (8,), 2, 4
    cfg.serve.msa_depth, cfg.serve.pipeline_depth, cfg.serve.kernels = 2, depth, kernels
    cfg.serve.return_distogram = True
    return cfg


def test_engine_policy_holds_on_the_pipeline_worker_and_keys_its_records(counts):
    reqs = ["ACDEFG", "MKVLAG"]
    runs = {}
    for spec in ("", "axial=stock,flash=on"):
        engine = ServeEngine(_tiny_cfg(spec), device="cpu")
        try:
            engine.warmup()
            counts()  # the warm and counted runs ran already
            axial.fused_attention_reference.calls = 0
            # a caller's own thread-local policy does not reach the engine's forward
            with use_kernel_policy(KernelPolicy(axial="dense", flash="off")):
                results = engine.predict_many(reqs)
        finally:
            engine.close()
        assert engine.pipeline_desc == "depth2"
        runs[spec] = (engine, results, axial.fused_attention_reference.calls)
    (auto, auto_res, auto_k1), (stock, stock_res, stock_k1) = runs[""], runs[
        "axial=stock,flash=on"]
    assert auto_k1 == 5 and stock_k1 == 0  # 2 pair axial + column + 2 cross a layer
    assert auto.kernels_desc == "auto" and auto.kernel_policy is None
    assert stock.kernels_desc == "axial=stock,flash=on"
    assert auto._exe_key(8, 2)[-1] == "auto" and stock._exe_key(8, 2)[-1] == stock.kernels_desc
    assert "kernels" not in auto.compile_records[0]
    assert stock.compile_records[0]["kernels"] == "axial=stock,flash=on"
    # the same work counted under either policy
    assert auto.compile_records[0]["flops"] == stock.compile_records[0]["flops"] > 0
    for a, s in zip(auto_res, stock_res):
        assert np.abs(a.distogram - s.distogram).max() < ATOL
    rec = {"metric": "serve forward ms", "device": "cpu"}
    why = comparable_reason({**rec, **stock.compile_records[0]}, {**rec, **auto.compile_records[0]})
    assert why is not None and why.startswith("kernels mismatch")
    assert comparable_reason({**rec, **auto.compile_records[0]},
                             {**rec, **auto.compile_records[0]}) is None


def test_engine_takes_the_process_policy_at_construction(monkeypatch, counts):
    monkeypatch.setenv("AF2TPU_KERNELS", "axial=dense,flash=off,tied_row=dense")
    engine = ServeEngine(_tiny_cfg(depth=0), device="cpu")
    monkeypatch.setenv("AF2TPU_KERNELS", "axial=stock,flash=on")
    try:
        engine.predict_many(["ACDEFG"])
    finally:
        engine.close()
    assert engine.kernels_desc == "tied_row=dense,axial=dense,flash=off"
    assert engine.kernel_policy is None
    k1, k2 = counts()
    assert k1 > 0 and k2 > 0
