"""The training step's flop count, MFU and on-device prefetch on the port.

- Every backward and block-sparse wrapper's analytic count (what it
  announces to ``FlopCounterMode`` through ``ops.cuda.build.tally_flops``
  where it launches on the card) equals the mode's count of its plain
  version: K3a/K3b, K4 with
  and without lse, K5a/K5b, K2's backward (its dq, its dk/dv and the
  one-call ``grads`` of the wide route) and K2's split passes, so the
  card's count of a training step equals the CPU's. On the CPU the
  wrappers run their plain versions and announce nothing. A block-sparse
  layout's active flops count its listed block pairs.
- A counted step whose backward runs on another thread under the caller's
  dispatch modes (autograd's device thread on the card) counts the
  backward's kernels, and a remat replay's forward kernels, to the plain
  versions' total; a thread without them counts nothing. A reversible
  step counts, and leaves what an uncounted step leaves.
- ``observe.flops.mfu`` equals JAX's ``mfu`` with JAX's None cases.
- ``train`` counts its first step and logs ``step_flops``, then
  ``model_flops_per_s`` and ``mfu`` beside ``steps_per_sec``; its
  parameters are bit-equal to a hand loop of ``make_train_step``;
  ``train_end2end`` and a run on a mesh log neither (JAX's gate).
- ``device_prefetch`` gives JAX's order and exhaustion on the same
  iterators.

Model widths: dim 16, depth 1, heads 2, dim_head 8, crop 12.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (
    _disable_current_modes, _get_current_dispatch_mode_stack, _pop_mode, _push_mode,
)
from torch.utils.flop_counter import FlopCounterMode

from alphafold2_tpu.observe import flops as jflops
from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
from alphafold2_tpu_torch.models.trunk import remat_call
from alphafold2_tpu_torch.observe import flops
from alphafold2_tpu_torch.ops.attention import DropoutKey
from alphafold2_tpu_torch.ops.cuda import axial, block_sparse, build, tied_row
from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig, config_layout
from alphafold2_tpu_torch.train import end2end, loop


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _counted(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def _rand(g, *shape):
    return torch.randn(*shape, generator=g)


def _k3_counts(g, b, h, nq, nk, d):
    q, dout = _rand(g, b, h, nq, d), _rand(g, b, h, nq, d)
    k, v = _rand(g, b, h, nk, d), _rand(g, b, h, nk, d)
    lse, dsum = _rand(g, b, h, nq), _rand(g, b, h, nq)
    args = (q, k, v, dout, lse, dsum, None, torch.rand(b, nk, generator=g) > 0.2, 0.3)
    return [(_counted(axial.fused_attention_dq_reference, *args),
             axial.attention_grad_flops(b, h, nq, nk, d, "dq"), axial.fused_attention_dq, args),
            (_counted(axial.fused_attention_dkv_reference, *args),
             axial.attention_grad_flops(b, h, nq, nk, d, "dkv"), axial.fused_attention_dkv,
             args),
            # the one-pass backward: S and dP once, 10 units against K3a's 6 + K3b's 8
            (_counted(axial.fused_attention_bwd_reference, *args),
             axial.attention_bwd_flops(b, h, nq, nk, d), axial.fused_attention_bwd, args)]


def _sparse_counts(g, b, h, n, d, cfg):
    layout = config_layout(cfg, n)
    q, k, v, dout = (_rand(g, b, h, n, d) for _ in range(4))
    kv_mask = torch.rand(b, n, generator=g) > 0.2
    fwd = (q, k, v, layout, kv_mask, 0.3)
    bwd = (q, k, v, dout, _rand(g, b, h, n), _rand(g, b, h, n), layout, kv_mask, 0.3)
    return [(_counted(block_sparse.block_sparse_attention_reference, *fwd),
             layout.flops(b, h, d, "fwd"), block_sparse.block_sparse_attention, fwd),
            (_counted(block_sparse.block_sparse_attention_lse_reference, *fwd),
             layout.flops(b, h, d, "fwd"), block_sparse.block_sparse_attention_lse, fwd),
            (_counted(block_sparse.block_sparse_attention_dq_reference, *bwd),
             layout.flops(b, h, d, "dq"), block_sparse.block_sparse_attention_dq, bwd),
            (_counted(block_sparse.block_sparse_attention_dkv_reference, *bwd),
             layout.flops(b, h, d, "dkv"), block_sparse.block_sparse_attention_dkv, bwd)]


def _k2_counts(g, b, r, nq, nk, h, d):
    q, dout = _rand(g, b, r, nq, h, d), _rand(g, b, r, nq, h, d)
    k, v = _rand(g, b, r, nk, h, d), _rand(g, b, r, nk, h, d)
    args = (q, k, v, dout, _rand(g, b, h, nq), _rand(g, b, h, nq), None,
            torch.rand(b, nk, generator=g) > 0.2, 0.3, 0.5)
    dq = tied_row.tied_row_grad_flops(b, r, h, nq, nk, d, "dq")
    dkv = tied_row.tied_row_grad_flops(b, r, h, nq, nk, d, "dkv")
    return [(_counted(tied_row.tied_row_attention_dq_reference, *args), dq,
             tied_row.tied_row_attention_dq, args),
            (_counted(tied_row.tied_row_attention_dkv_reference, *args), dkv,
             tied_row.tied_row_attention_dkv, args),
            (_counted(tied_row.tied_row_attention_grads, *args), dq + dkv,
             tied_row.tied_row_attention_grads, args)]


def _split_counts(g, b, r, na, nb, h, d):
    a, x = _rand(g, b, r, na, h, d), _rand(g, b, r, nb, h, d)
    flops_ = tied_row.split_pass_flops(b, h, na, nb, r, d)
    s = tied_row.tied_split_logits_reference(a, x)
    p = torch.rand(b, h, na, nb, generator=g)
    grad = (s, _rand(g, b, h, na, nb), _rand(g, b, h, na), _rand(g, b, h, na), na, nb)
    return [(_counted(tied_row.tied_split_logits_reference, a, x), flops_,
             tied_row.tied_split_logits, (a, x)),
            (_counted(tied_row.tied_split_product_reference, p, x, na), flops_,
             tied_row.tied_split_product, (p, x, na)),
            # elementwise: the mode counts 0, and the pass tallies nothing
            (_counted(tied_row.tied_split_grad_reference, *grad), 0,
             tied_row.tied_split_grad, grad)]


CASES = {
    "k3 2x3x16x12x32": (_k3_counts, (2, 3, 16, 12, 32)),
    "k3 1x8x5x5x64": (_k3_counts, (1, 8, 5, 5, 64)),
    "k3 3x2x40x17x16": (_k3_counts, (3, 2, 40, 17, 16)),
    # lists of 4-6 blocks out of 16, row and column widths apart
    "k4k5 n256 bs16 sparse": (_sparse_counts, (1, 2, 256, 16, BlockSparseConfig(
        block_size=16, num_global_blocks=0, num_random_blocks=1, seed=3))),
    # a global block: row 0 lists every block, so the padded width is the axis
    "k4k5 n128 bs16 global": (_sparse_counts, (2, 2, 128, 16, BlockSparseConfig(
        block_size=16, num_random_blocks=2, seed=1))),
    "k4k5 n192 bs32": (_sparse_counts, (1, 3, 192, 32, BlockSparseConfig(
        block_size=32, num_local_blocks=2, num_global_blocks=0, num_random_blocks=1))),
    "k2 bwd 1x5x16x12x2x16": (_k2_counts, (1, 5, 16, 12, 2, 16)),
    "k2 bwd 2x3x8x8x4x32": (_k2_counts, (2, 3, 8, 8, 4, 32)),
    # R*D 576, past the resident kernels: the wide route's shape
    "k2 bwd wide 1x9x8x8x1x64": (_k2_counts, (1, 9, 8, 8, 1, 64)),
    "k2 split 1x3x16x12x2x16": (_split_counts, (1, 3, 16, 12, 2, 16)),
    "k2 split 2x1x8x24x4x32": (_split_counts, (2, 1, 8, 24, 4, 32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_analytic_counts_equal_the_plain_versions(case):
    fn, shape = CASES[case]
    g = torch.Generator().manual_seed(len(case))
    for counted, analytic, wrapper, args in fn(g, *shape):
        assert counted == analytic, wrapper.__name__
        # CPU tensors: the wrapper runs the plain version and announces nothing
        run = flops.count_forward(wrapper, *args)
        assert (run.flops, run.kernel_flops) == (counted, {}), wrapper.__name__


@pytest.mark.parametrize("case", sorted(c for c in CASES if c.startswith("k4k5")))
def test_active_flops_count_the_listed_block_pairs(case):
    """BlockLayout.active_flops: the kernels' work over the block pairs the
    layout lists (the dense layout's True blocks), never above the padded
    count the plain version makes."""
    _, (b, h, n, d, cfg) = CASES[case]
    layout = config_layout(cfg, n)
    pairs = int(np.asarray(cfg.layout(n)).sum())
    assert layout.active_pairs() == pairs
    for which, mult in (("fwd", 4), ("dq", 6), ("dkv", 8)):
        assert layout.active_flops(b, h, d, which) == mult * b * h * pairs * cfg.block_size ** 2 * d
        assert layout.active_flops(b, h, d, which) <= layout.flops(b, h, d, which)


def _as_on_the_card(monkeypatch, module, announced):
    """Make the CPU wrappers of ``module`` behave as the card's do under the
    counter: each announces its analytic count (``announced[name](*args)``:
    ``{tally name: flops}``) and its plain version runs unseen by the mode,
    as a kernel launch is."""
    for name, counts in announced.items():
        real = getattr(module, name)

        def fake(*args, _real=real, _counts=counts, **kw):
            for kernel, n in _counts(*args).items():
                build.tally_flops(kernel, n)
            with _disable_current_modes():
                return _real(*args, **kw)

        monkeypatch.setattr(module, name, fake)


def _backward_on_another_thread(loss, carry: bool):
    """``loss.backward()`` on a new thread; with ``carry``, under this
    thread's dispatch modes, as autograd's device thread runs a backward
    under its caller's thread-local state on the card."""
    modes = _get_current_dispatch_mode_stack() if carry else []
    errors = []

    def run():
        for mode in modes:
            _push_mode(mode)
        try:
            loss.backward()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        finally:
            for _ in modes:
                _pop_mode()

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    assert not errors, errors


def _k3_announced(q, k, v, *rest):
    shape = (*q.shape[:3], k.shape[2], q.shape[3])
    return lambda which: {f"fused_attention_{which}": axial.attention_grad_flops(*shape, which)}


def _case(monkeypatch, kind, g):
    """(a call of ``kind``'s differentiable wrapper, a function that makes
    its backward wrappers announce as on the card)."""
    if kind == "k1_k3":
        q, k, v = (_rand(g, 1, 2, 8, 16).requires_grad_() for _ in range(3))
        announce = lambda: _as_on_the_card(monkeypatch, axial, {
            "fused_attention_dq": lambda *a: _k3_announced(*a)("dq"),
            "fused_attention_dkv": lambda *a: _k3_announced(*a)("dkv")})
        return lambda: axial.fused_attention(q, k, v), announce
    if kind == "k2":
        q, k, v = (_rand(g, 1, 3, 8, 2, 16).requires_grad_() for _ in range(3))

        def grads(q, k, *rest):
            shape = (q.shape[0], q.shape[1], q.shape[3], q.shape[2], k.shape[2], q.shape[4])
            return {f"tied_row_attention_{w}": tied_row.tied_row_grad_flops(*shape, w)
                    for w in ("dq", "dkv")}

        announce = lambda: _as_on_the_card(monkeypatch, tied_row,
                                           {"tied_row_attention_grads": grads})
        return lambda: tied_row.tied_row_attention(q, k, v), announce
    layout = config_layout(BlockSparseConfig(block_size=16), 64)
    q, k, v = (_rand(g, 1, 2, 64, 16).requires_grad_() for _ in range(3))
    announce = lambda: _as_on_the_card(monkeypatch, block_sparse, {
        f"block_sparse_attention_{w}": (lambda *a, _w=w: {
            f"block_sparse_attention_{_w}": layout.flops(1, 2, 16, _w)}) for w in ("dq", "dkv")})
    return lambda: block_sparse.block_sparse_attention(q, k, v, layout), announce


@pytest.mark.parametrize("kind", ["k1_k3", "k2", "k4_k5"])
def test_a_backward_on_autograds_thread_counts_its_kernels(monkeypatch, kind):
    """A step counted on this thread whose backward runs on another under
    this thread's dispatch modes (autograd's device thread on the card)
    counts the backward's kernels: with the backward wrappers announcing
    as the card's, the total equals the plain versions'. A backward on a
    thread without those modes adds nothing."""
    call, announce = _case(monkeypatch, kind, torch.Generator().manual_seed(7))
    plain = flops.count_forward(lambda: call().square().sum().backward())
    announce()
    run = flops.count_forward(lambda: _backward_on_another_thread(call().square().sum(), True))
    assert run.flops == plain.flops and plain.kernel_flops == {}
    assert run.kernel_flops and all(v > 0 for v in run.kernel_flops.values()), run.kernel_flops
    forward = flops.count_forward(lambda: _backward_on_another_thread(call().square().sum(),
                                                                      False))
    assert forward.kernel_flops == {} and forward.flops < run.flops


def test_a_remat_replay_counts_where_its_forward_did(monkeypatch):
    """remat_call's recompute, run on the backward's thread, counts its
    kernels: twice the forward's, as FlopCounterMode counts the replayed
    plain version on the CPU."""
    once = axial.attention_flops(1, 2, 8, 8, 16)
    _as_on_the_card(monkeypatch, axial, {"_lse_forward": lambda *a: {"fused_attention": once}})
    g = torch.Generator().manual_seed(3)
    q, k, v = (_rand(g, 1, 2, 8, 16).requires_grad_() for _ in range(3))
    call = lambda: remat_call(lambda a, b, c: axial.fused_attention(a, b, c) * 2, None,
                              q, k, v).sum()
    assert flops.count_forward(call).kernel_flops == {"fused_attention": once}
    run = flops.count_forward(lambda: _backward_on_another_thread(call(), True))
    assert run.kernel_flops == {"fused_attention": 2 * once}


def test_a_reversible_step_counts(tmp_path):
    """The reversible engine's backward runs torch.autograd.grad inside a
    custom backward; the counter tracks no module there (FlopCounterMode's
    module tracker hooks break it), so a counted step runs, counts its
    inversion's replayed forwards, and leaves the parameters an uncounted
    step leaves."""
    cfg = _cfg(tmp_path)
    cfg.model.reversible, cfg.model.ff_dropout = True, 0.0
    batch = next(iter(SyntheticDataset(cfg.data, seed=cfg.train.seed)))
    states = []
    for counted in (False, True):
        state = loop.init_state(cfg, loop.build_model(cfg), device="cpu")
        step = loop.make_train_step(state.model)
        args = (state, loop.device_put_batch(batch, "cpu"), DropoutKey.for_step(1, 0))
        if counted:
            (state, _), run = flops.count_call(step, *args)
        else:
            state, _ = step(*args)
        states.append(state)
    for a, b in zip(*(s.model.parameters() for s in states)):
        assert torch.equal(a, b)
    cfg.model.reversible = False
    state = loop.init_state(cfg, loop.build_model(cfg), device="cpu")
    plain = flops.count_forward(loop.make_train_step(state.model), state,
                                loop.device_put_batch(batch, "cpu"), DropoutKey.for_step(1, 0))
    # the inversion replays every layer's forward in the backward
    assert run.flops > plain.flops > 0


@pytest.mark.parametrize("args", [(1e12, 1.0, 1e13), (3.5e9, 0.25, 1e12), (None, 1.0, 1e13),
                                  (0.0, 1.0, 1e13), (1e12, 0.0, 1e13), (1e12, -1.0, 1e13),
                                  (1e12, 1.0, 0.0), (1e12, 1.0, None)])
def test_mfu_equals_jax(args):
    """Same flops, seconds and peak; without a peak JAX asks its first
    device (the CPU here: no published peak) and the port the card (none
    here): both None."""
    flops_, seconds, peak = args
    assert flops.mfu(flops_, seconds, peak=peak) == jflops.mfu(flops_, seconds, peak=peak)
    assert flops.mfu(flops_, seconds, device="cpu", peak=peak) == jflops.mfu(
        flops_, seconds, peak=peak)
    run = flops.CountedRun(op_flops=flops_ or 0.0, kernel_flops={}, peak_bytes=None)
    assert flops.step_flops(run) == (flops_ or None)
    assert flops.estimate_mfu(run, seconds) is None  # no peak off the card


def _cfg(tmp, **train):
    cfg = Config(
        model=ModelConfig(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=32, bfloat16=False,
                          ff_dropout=0.1),
        data=DataConfig(crop_len=12, msa_depth=2, msa_len=12, batch_size=1, min_len_filter=8),
        train=TrainConfig(gradient_accumulate_every=1, warmup_steps=1, log_every=1,
                          checkpoint_dir=str(tmp), checkpoint_every=1000, numerics="off"))
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _records(tmp):
    with open(os.path.join(str(tmp), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_train_logs_step_flops_and_mfu_and_matches_a_hand_loop(tmp_path, monkeypatch):
    """The counted first step is the real one: 3 steps (dropout on) leave
    the parameters of a hand loop of make_train_step bit for bit; its
    count equals a count of the hand loop's first step; later logs carry
    model_flops_per_s and, with a known peak, mfu (JAX's tests/test_numerics.py
    first-step metrics)."""
    monkeypatch.setattr(flops, "device_peak_flops", lambda device=None: 1e12)
    cfg = _cfg(tmp_path)
    batches = [b for _, b in zip(range(3), SyntheticDataset(cfg.data, seed=cfg.train.seed))]
    got = loop.train(cfg, num_steps=3, dataset=list(batches), device="cpu")

    def hand_loop(count_first):
        state = loop.init_state(cfg, loop.build_model(cfg), device="cpu")
        step = loop.make_train_step(state.model)
        counted = None
        for i, batch in enumerate(batches[:None if not count_first else 1]):
            args = (state, loop.device_put_batch(batch, "cpu"),
                    DropoutKey.for_step(cfg.train.seed + 1, i))
            if count_first:
                (state, _), counted = flops.count_call(step, *args)
            else:
                state, _ = step(*args)
        return state, counted

    state, _ = hand_loop(count_first=False)  # uncounted
    for a, b in zip(got.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    assert int(got.skipped) == int(state.skipped) == 0
    _, counted = hand_loop(count_first=True)

    recs = _records(tmp_path)
    (first,) = [r for r in recs if "step_flops" in r]
    assert first["step"] == 0 and first["step_flops"] == flops.step_flops(counted) > 0
    later = [r for r in recs if "steps_per_sec" in r]
    assert [r["step"] for r in later] == [1, 2]
    for r in later:
        assert r["model_flops_per_s"] == pytest.approx(first["step_flops"] * r["steps_per_sec"])
        assert r["mfu"] == round(first["step_flops"] * r["steps_per_sec"] / 1e12, 4)
    assert not any("mfu" in r or "model_flops_per_s" in r for r in recs if "first_step_s" in r)


def test_only_the_meshless_train_counts(tmp_path, monkeypatch):
    """train counts where JAX's does (no mesh, one process): a mesh run
    passes count_flops=False; train_end2end logs neither key."""
    seen = []
    monkeypatch.setattr(loop, "run_steps", lambda *a, **kw: seen.append(kw["count_flops"]))
    cfg = _cfg(tmp_path / "pre")
    cfg.model.ff_dropout = 0.0  # a mesh refuses dropout
    loop.train(cfg, num_steps=1, device="cpu")
    monkeypatch.setattr(loop, "make_train_mesh", lambda cfg: object())
    loop.train(cfg, num_steps=1, device="cpu")
    assert seen == [True, False]
    monkeypatch.undo()

    cfg = Config(
        model=ModelConfig(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48, bfloat16=False),
        data=DataConfig(crop_len=8, msa_depth=2, msa_len=8, batch_size=1, min_len_filter=6),
        train=TrainConfig(gradient_accumulate_every=1, warmup_steps=1, log_every=1,
                          checkpoint_dir=str(tmp_path / "e2e"), checkpoint_every=1000))
    end2end.train_end2end(cfg, num_steps=2, device="cpu")
    recs = _records(tmp_path / "e2e")
    assert any("steps_per_sec" in r for r in recs)
    assert not any({"step_flops", "model_flops_per_s", "mfu"} & set(r) for r in recs)


def test_device_prefetch_order_and_exhaustion_equal_jax():
    """JAX's tests/test_train.py device_prefetch cases, through both."""
    from alphafold2_tpu.train.loop import device_prefetch as jax_prefetch

    batches = [{"seq": np.full((1, 4), i)} for i in range(5)]
    for items, size in ((batches, 2), (batches[:1], 3), ([], 2), (batches, 1), (batches, 7)):
        want = [int(b["seq"][0, 0]) for b in jax_prefetch(iter(items), size=size)]
        got = list(loop.device_prefetch(iter(items), device="cpu", size=size))
        assert [int(b["seq"][0, 0]) for b in got] == want
        assert all(b["seq"].dtype == torch.int64 and b["seq"].device.type == "cpu"
                   for b in got)
