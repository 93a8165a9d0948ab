#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (alphafold2_tpu_torch) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. build    — compile every kernel source under alphafold2_tpu_torch/csrc
              with nvcc (sm_90a), one process per source, and load them;
1b. gate    — the port's pre-hardware analysis layer: the Hopper build gate
              (analysis/lowering.py: every case's launch plans and ptxas
              resources within sm_90's limits, f32 and bf16, and X's
              mis-tiled negative control refused by ptxas; K3's Hopper
              kernels and their merge at head dim 64 without a spill); X's valid
              counterpart (scale_rows) bitwise against 2 * x at (4, 512),
              timed beside torch.mul; the launch-level control, a
              2048-thread block the card must refuse with
              cudaErrorInvalidConfiguration; and the graph audit
              (analysis/audit.py) of every target on the card, clean apart
              from reasoned waivers, its backward seen on the autograd
              engine's device threads;
2. kernels  — K1's plan on its nine main-path passes must name the Hopper
              kernel (attention_kernel_sm90<64>, and combine_kernel<64>
              where the key axis splits); hold each forward kernel (K1, K2)
              against its plain PyTorch version on the card at the serving
              path's shapes (f32 and bf16) plus ragged tails, a 5-key pass,
              fully masked rows, other head dims and a negative scale, each
              bf16 serving pass launching the Hopper kernel and repeating
              bit for bit; time the kernel (and its host time a call), the
              plain version and torch's scaled_dot_product_attention (a
              yardstick the port never calls);
3. backward — the same for K1's training forward (with the row logsumexp,
              the split pass repeating bit for bit) and K1's combine pass
              alone, and the backward kernels K3a (dq) and K3b (dk, dv) at
              the training path's shapes and the edge cases, per tensor: K3's
              plans on the five training passes must name dq_kernel_sm90<64>
              and dkv_kernel_sm90<64> with their splits (7 on the cross
              passes), each bf16 training pass must launch them, and the
              merge pass exactly where it splits; a negative control that
              drops each row's last key tile (dq) or query tile (dk, dv); on
              the split passes the merge kernel alone against its plain
              version and a merge that drops the last split, which must be
              rejected; two runs bit-identical; SDPA's backward as the
              yardstick;
3b. head dims — K1, K1 with lse, K3a and K3b at head dims 48 (zero-padded
              to 64) and 256 (D-chunked) against their plain versions, f32
              and bf16; the autograd route through the kernels alone, bit
              for bit the direct calls;
3c. tied    — K2 with the row logsumexp and K2's backward (dq; dk and dv,
              csrc/tied_row_attention_bwd.cu) against their plain versions
              at the tied training shape (1x5x64x8x64, R*D 320) and JAX's
              gate shape (1x8x256x4x64, R*D 512), f32 and bf16, with ragged
              rows and masked columns; a negative control per kernel that
              drops the last 64-wide feature chunk; two backward runs
              bit-identical; the autograd route through the kernels alone;
              SDPA on the folded (B, H, N, R*D) tensors as the yardstick,
              with the backend that takes that head dim named;
4. serve    — a small model must agree between the card and the CPU's
              plain versions; the refiner's streamed edge attention must
              agree with its dense path on the card (f32, threshold
              lowered); a ServeEngine at full model width (dim 256, depth
              6, heads 8, dim_head 64, bf16 compute, tied MSA rows, the
              default ladder 64/96/128/192/256 at batch 4, buckets 192 and
              256 streaming the refiner) warms up every bucket and serves
              twelve requests of 50-256 residues; launch counts must show
              both forward kernels on the path and no plain-version call; a
              request served alone and in a batch must agree; one request
              with serve.return_distogram must bring back (3L, 3L, 37)
              logits; a bucket-128 and a bucket-256 batch are profiled;
5. train    — distogram pretraining at the same width (untied MSA rows,
              crop 128, MSA 5x64, batch 1, accumulation 16): 32 steps whose
              launch counts must show K1, K3a and K3b on every attention
              (every K1 and K3 launch on its Hopper kernel, K3's merge pass
              on the 11 split passes a step) and no plain-version call, the
              first accumulated update at lr 0;
              20 steps on one repeated batch whose loss must fall; a small
              f32 model whose gradients must agree between the card and the
              CPU; one step under torch.profiler; then all of it again with
              model.msa_tie_row_attn=True (K2 with lse and K2's backward on
              every MSA row pass);
6. sparse   — the block-sparse kernels K4 (forward, with and without the
              row logsumexp), K5a (dq) and K5b (dk, dv) against their plain
              versions per tensor at the sparse training path's pair pass
              and at a long, an unaligned, a block-128 and a dead-row
              problem, f32 and bf16; rows without a valid key exactly 0; a
              negative control dropping each query block's last valid
              active block (K4, K5a) or each key block's last query block
              (K5b); two backward runs bit-identical; SDPA with the
              element-level layout and key mask as the yardstick;
7. sparse train — the training phase's checks with
              model.sparse_self_attn=True: every pair axial pass through
              K4/K5a/K5b, the rest through K1/K3a/K3b, small-model
              gradients on the grid route (crop 48) and the flat route
              (crop 40), one step under torch.profiler.

``phase_k1_time`` (not part of the run) times K1 alone on its nine
main-path passes beside SDPA: ``python3 -c "import chip_smoke as c;
c.phase_build(); c.phase_k1_time()"``; ``phase_k3_time`` likewise times K3a
and K3b on the five training passes beside SDPA's backward, per pass and
per step. ``chip_compare.sh`` runs them, or any other phases, for two
checkouts in turns.

Prints the card's name and power limit, then a JSON line describing every
kernel, and last ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; f32 CUDA core

# Each case is held to bounds scaled to its own output, so a shape whose
# outputs are small (a long key axis averages them down) is held as tightly
# as one whose outputs are large: max|kernel - plain| <= MAX_REL * max|plain|
# and ||kernel - plain||_2 <= L2_REL * ||plain||_2.
# On an H100 the kernels came to rel_l2 <= 2.6e-3 and max ratio <= 5.5e-3
# in bf16, and rel_l2 <= 4.9e-6 in f32; a kernel skipping its last key tile
# comes to rel_l2 >= 2.4e-2 (the 640 x 147456 cross pass) and is rejected.
TOL = {  # (MAX_REL, L2_REL)
    "float32": (1e-4, 2e-5),  # same f32 arithmetic, other summation order
    # the kernel rounds probabilities to bf16 for P @ V (2^-9 relative),
    # both round the output to bf16 (one ulp apart is 2^-8..2^-7 relative)
    "bfloat16": (2**-6, 4e-3),
}
MAX_PLAIN_LOGITS_BYTES = 2 << 30  # the plain version runs in batch slices below this
# a small f32 model's gradients, card vs CPU: per-leaf relative L2 error
GRAD_REL_L2 = 1e-4
STEP_REPS = 10  # steps timed back to back in the training phase


class PhaseError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------- timing


def cuda_ms(fn, reps=3, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- phase 1


def phase_build():
    from alphafold2_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    paths = build.build_all()
    for name in paths:
        build.library(name)
    secs = time.perf_counter() - t0
    # each instantiation's registers, spills and shared memory: the gate phase
    log(f"[build] {len(paths)} kernels built and loaded in {secs:.1f} s")
    return secs


# --------------------------------------------------------------- phase 1b


def _log_gate(records, summary):
    from alphafold2_tpu_torch.analysis import lowering

    for rec in records:
        if rec["case"] == lowering.CONTROL_CASE:
            log(f"[gate] {rec['case']}: nvcc exit {rec['nvcc_exit']}, "
                f"{'refused' if rec['rejected'] else 'NOT REFUSED'}: "
                f"{rec.get('refusal') or rec.get('error')}")
            continue
        for ln in rec["launches"]:
            log(f"[gate] {rec['case']} {ln['role']} {ln['dtype']} {ln.get('kernel', '?')}: "
                f"blocks {ln.get('blocks')}, threads {ln.get('threads')}, registers "
                f"{ln.get('registers')}, barriers {ln.get('barriers')}, smem "
                f"{ln.get('static_smem')} static + {ln.get('dynamic_smem')} dynamic, stack "
                f"{ln.get('stack_frame')}, spills {ln.get('spill_stores')}/"
                f"{ln.get('spill_loads')} B; {'; '.join(ln['problems']) or 'ok'}")
        for w in rec.get("warning", ()):
            log(f"[gate] {rec['case']} warning: {w}")
    log(f"[gate] {json.dumps(summary)}")


def phase_gate():
    """The analysis layer on the card: the build gate, X's counterpart and
    its launch-level control, the audit of every target. Every part runs;
    the phase then fails with all the problems found."""
    import torch

    from alphafold2_tpu_torch.analysis import audit, lowering
    from alphafold2_tpu_torch.ops.cuda import build, controls

    problems = []

    def check(cond, msg):
        if not cond:
            log(f"[gate] FAILED: {msg}")
            problems.append(msg)

    t0 = time.perf_counter()
    try:
        records, summary = lowering.run_gate()
    except (lowering.ToolMissing, RuntimeError, OSError, subprocess.SubprocessError) as e:
        traceback.print_exc()
        check(False, f"the build gate did not run: {type(e).__name__}: {e}")
    else:
        _log_gate(records, summary)
        log(f"[gate] build gate: {summary['cases']} cases in {time.perf_counter() - t0:.1f} s")
        check(not summary["failed"], f"build gate failed: {summary['failed']}")
        check(summary["control_rejected"], "the mis-tiled control was not refused by ptxas")
        # K3's Hopper kernels and their merge at the main path's head dim
        # must not spill
        spills = {ln["kernel"]: (ln.get("spill_stores"), ln.get("spill_loads"))
                  for rec in records for ln in rec.get("launches", ())
                  if ln.get("kernel") in (*K3_SM90, "grad_merge_kernel<64>")}
        check(set(spills) == {*K3_SM90, "grad_merge_kernel<64>"},
              f"the gate planned K3's Hopper kernels only as {sorted(spills)}")
        check(all(x == (0, 0) for x in spills.values()), f"K3's Hopper kernels spill: {spills}")

    # X at its own shape: the path is one launch at (4, 512) f32
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(controls.X_SHAPE, device="cuda", generator=gen)
    controls.scale_rows.launches = 0
    out = controls.scale_rows(x)
    torch.cuda.synchronize()
    launches = controls.scale_rows.launches
    ref = controls.scale_rows_reference(x)
    check(launches == 1, f"scale_rows launched {launches} times")
    check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
          "scale_rows is not bitwise 2 * x")
    err = float((out - ref).abs().max())
    nbytes = 2 * x.numel() * x.element_size()  # read x once, write o once: 16 KiB
    row = {"label": "X (4, 512) f32", "kernel": "scale_rows", "dtype": "float32",
           "max_abs_err": err, **_bound(float(x.numel()), nbytes, torch.float32)}
    row["ms"] = cuda_ms(lambda: controls.scale_rows(x), reps=200, warmup=10)
    row["plain_ms"] = cuda_ms(lambda: controls.scale_rows_reference(x), reps=200, warmup=10)
    row["library_ms"] = cuda_ms(lambda: torch.mul(x, 2), reps=200, warmup=10)
    log(f"[gate] scale_rows (4, 512) f32: bitwise equal to 2 * x (max_abs_err {err}); kernel "
        f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, torch.mul {row['library_ms']:.5f} "
        f"ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}, {nbytes} bytes)")

    # the launch-level control: the same kernel with a (1, 2048)-thread block
    try:
        controls.scale_rows(torch.zeros(controls.LAUNCH_CONTROL_SHAPE, device="cuda"))
        check(False, "a 2048-thread block of scale_rows launched")
    except build.KernelLaunchError as e:
        log(f"[gate] launch control (1, 2048): refused, {e}")
        check(e.code == controls.INVALID_CONFIGURATION,
              f"the launch control failed with CUDA error {e.code}, not "
              f"cudaErrorInvalidConfiguration ({controls.INVALID_CONFIGURATION})")
    torch.cuda.synchronize()

    # the graph audit of every target, on the card
    t0 = time.perf_counter()
    reports = audit.audit(device="cuda")
    for r in reports:
        log(f"[gate] audit {r.target} on {r.device}: {r.ops} ops, {len(r.findings)} findings, "
            f"{len(r.waived)} waived; memory {r.budget['verdict']} "
            f"({r.budget.get('program_bytes')} of {r.budget.get('budget_bytes')} bytes); "
            f"autograd nodes {list(r.nodes)}")
        for f in r.findings:
            log(f"[gate] audit finding {f.format()}")
        for f in r.waived:
            log(f"[gate] audit waived {f.format()}")
    log(f"[gate] audit: {len(reports)} targets in {time.perf_counter() - t0:.1f} s")
    check(not any(r.findings for r in reports), "the audit has findings on the card")
    nodes = {r.target: set(r.nodes) for r in reports}
    check("FusedAttentionBackward" in nodes["train_grad"]
          and "BlockSparseAttentionBackward" in nodes["train_step_sparse"],
          "the audit did not see the attention backward on the card")
    require(not problems, "gate phase: " + "; ".join(problems))
    return {"launches": launches, "row": row}


# --------------------------------------------------------------- phase 2


def _sliced(fn, args, kwargs, logits_bytes_per_batch):
    """Run the plain version over batch slices small enough to hold its
    logits; concatenate along the batch."""
    import torch

    b = args[0].shape[0]
    step = max(1, int(MAX_PLAIN_LOGITS_BYTES // max(1, logits_bytes_per_batch)))
    outs = []
    for lo in range(0, b, step):
        sl = slice(lo, lo + step)
        kw = {k: (v[sl] if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == b
                  else v) for k, v in kwargs.items()}
        outs.append(fn(*(a[sl] for a in args), **kw))
    return torch.cat(outs)


def _prefix(n, lengths):
    """(len(lengths), n) bool masks valid on a prefix of each row."""
    import torch

    idx = torch.arange(n, device="cuda")
    return idx[None, :] < torch.as_tensor(lengths, device="cuda")[:, None]


def _drop_last_tile(mask):
    """``mask`` without each row's last 64 valid keys (its last valid key
    where it has 64 or fewer): the keys a kernel that skipped its last key
    tile would see."""
    import torch

    from_end = mask.flip(-1).long().cumsum(-1).flip(-1)  # valid keys at or after j
    cut = torch.where(mask.sum(-1, keepdim=True) > 64, 64, 1)
    return mask & (from_end > cut)


def _k1_operands(b, h, nq, nk, d, dtype, gen, serving):
    """q (B, H, Nq, D), k/v (B, H, Nk, D). With ``serving`` they are built
    as ops/attention.py builds them: (B, H, N, D) views of a (B, Nq, H*D)
    query projection and of the two halves of a (B, Nk, 2*H*D) key/value
    projection, so k and v have token stride 2*H*D and v starts H*D in."""
    import torch

    dev = torch.device("cuda")
    if not serving:
        return tuple(torch.randn((b, h, n, d), device=dev, generator=gen).to(dtype)
                     for n in (nq, nk, nk))
    q = torch.randn((b, nq, h * d), device=dev, generator=gen).to(dtype)
    kv = torch.randn((b, nk, 2 * h * d), device=dev, generator=gen).to(dtype)
    k, v = (t.view(b, nk, h, d).transpose(1, 2) for t in kv.chunk(2, -1))
    return q.view(b, nq, h, d).transpose(1, 2), k, v


def _host_us(fn, calls=20):
    """Host time per call of ``fn`` in microseconds: the enqueue, measured
    without synchronising inside (the card runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _sm90_launched(fn, what):
    """Run ``fn`` once; require that K1 launched attention_kernel_sm90.
    Returns fn's result and how many combine passes it launched."""
    from alphafold2_tpu_torch.ops.cuda import axial

    before = (axial.fused_attention.sm90_launches, axial.fused_attention_combine.launches)
    result = fn()
    sm90 = axial.fused_attention.sm90_launches - before[0]
    combine = axial.fused_attention_combine.launches - before[1]
    require(sm90 == 1, f"{what}: K1 did not launch attention_kernel_sm90")
    return result, combine


def k1_case(label, b, h, nq, nk, d, dtype, q_mask=None, kv_mask=None, reps=3,
            library=False, gen=None, serving=False, sm_scale=None):
    """One fused_attention check; returns a result row. ``serving`` builds
    the operands in the serving path's strided layout and also checks that
    a kernel skipping its last key tile would fail the bound. A bf16 main
    path case (``serving``) must launch attention_kernel_sm90 and, where
    the key axis splits, its combine pass; two runs must agree bit for
    bit."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda.axial import (
        fused_attention, fused_attention_reference, key_splits)

    dev = torch.device("cuda")
    q, k, v = _k1_operands(b, h, nq, nk, d, dtype, gen, serving)
    scale = d**-0.5 if sm_scale is None else sm_scale
    run = lambda: fused_attention(q, k, v, q_mask=q_mask, kv_mask=kv_mask, sm_scale=scale)
    if serving and dtype == torch.bfloat16:
        splits = key_splits(b, h, nq, nk, d)
        out, combined = _sm90_launched(run, label)
        require(combined == (splits > 1), f"{label}: combine launches {combined}, "
                                          f"{splits} key splits")
        require(torch.equal(out, run()), f"{label}: two K1 runs differ")
        log(f"[kernels] fused_attention {label}: attention_kernel_sm90, {splits} key "
            f"split(s), two runs bit-identical")
    else:
        out = run()
    torch.cuda.synchronize()
    plain = lambda: _sliced(
        fused_attention_reference, (q, k, v),
        {"q_mask": q_mask, "kv_mask": kv_mask, "sm_scale": scale},
        h * nq * nk * 4 * 3,
    )
    ref = plain()
    row = _compare(label, "fused_attention", out, ref, dtype)
    if serving:
        short = fused_attention(q, k, v, q_mask=q_mask, kv_mask=_drop_last_tile(kv_mask),
                                sm_scale=scale)
        _control(label, "fused_attention", short, ref, dtype)
        del short
    qv = q_mask.sum(1) if q_mask is not None else torch.full((b,), nq, device=dev)
    kv = kv_mask.sum(1) if kv_mask is not None else torch.full((b,), nk, device=dev)
    ops = 4.0 * h * d * float((qv * kv).sum())
    nbytes = (2 * b * h * nq * d + 2 * b * h * nk * d) * q.element_size() + (
        (b * nq if q_mask is not None else 0) + (b * nk if kv_mask is not None else 0))
    row.update(_bound(ops, nbytes, dtype))
    if reps:
        row["ms"] = cuda_ms(run, reps)
        row["host_us"] = _host_us(run)
        row["plain_ms"] = cuda_ms(plain, reps=1, warmup=0)
        if library:
            am = kv_mask[:, None, None, :] if kv_mask is not None else None
            try:
                row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=am, scale=scale), reps)
            except (RuntimeError, torch.OutOfMemoryError) as e:
                log(f"[kernels] {label}: scaled_dot_product_attention failed: {e}")
                row["library_ms"] = None
    del q, k, v, out, ref
    torch.cuda.empty_cache()
    return row


def k2_case(label, b, r, n, h, d, dtype, length=None, reps=3, library=False, gen=None):
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda.tied_row import (
        tied_row_attention, tied_row_attention_reference)

    dev = torch.device("cuda")
    shape = (b, r, n, h, d)
    q = torch.randn(shape, device=dev, generator=gen)
    k = torch.randn(shape, device=dev, generator=gen)
    v = torch.randn(shape, device=dev, generator=gen)
    mask = _prefix(n, length) if length is not None else None
    tie = r**-0.5
    if mask is not None:  # padded columns abstain, as ops/attention.py does
        q, k, v = (t * mask[:, None, :, None, None] for t in (q, k, v))
        n_rows = (mask.any(-1).long() * r).clamp_min(1)
        tie = n_rows.float() ** -0.5
    q, k, v = (t.to(dtype).contiguous() for t in (q, k, v))
    scale = d**-0.5
    run = lambda: tied_row_attention(q, k, v, q_mask=mask, kv_mask=mask,
                                     sm_scale=scale, tie_scale=tie)
    out = run()
    torch.cuda.synchronize()
    plain = lambda: tied_row_attention_reference(q, k, v, mask, mask, scale, tie)
    ref = plain()
    row = _compare(label, "tied_row_attention", out, ref, dtype)
    if mask is not None:
        short = tied_row_attention(q, k, v, q_mask=mask, kv_mask=_drop_last_tile(mask),
                                   sm_scale=scale, tie_scale=tie)
        _control(label, "tied_row_attention", short, ref, dtype)
    nv = mask.sum(1) if mask is not None else torch.full((b,), n, device=dev)
    ops = 4.0 * h * r * d * float((nv * nv).sum())
    nbytes = 4 * b * r * n * h * d * q.element_size() + (2 * b * n if mask is not None else 0)
    row.update(_bound(ops, nbytes, dtype))
    if reps:
        row["ms"] = cuda_ms(run, reps)
        row["plain_ms"] = cuda_ms(plain, reps)
        if library:
            # the same function through SDPA: fold rows into the head dim
            def fold(t):
                return t.permute(0, 3, 2, 1, 4).reshape(b, h, n, r * d)

            tie_t = torch.as_tensor(tie, device=dev, dtype=torch.float32).reshape(-1)
            qs = (fold(q).float() * tie_t.reshape(-1, 1, 1, 1)).to(dtype)
            kf, vf = fold(k), fold(v)
            am = mask[:, None, None, :] if mask is not None else None
            row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, kf, vf, attn_mask=am, scale=scale), reps)
    return row


def _errors(out, ref, dtype):
    """(dtype name, max abs error, its ratio to max|plain|, relative L2
    error, whether both ratios are within TOL)."""
    import torch

    name = "float32" if dtype == torch.float32 else "bfloat16"
    max_rel, l2_rel = TOL[name]
    diff = out.float() - ref.float()
    err = float(diff.abs().max())
    rel_max = err / max(float(ref.float().abs().max()), 1e-30)
    rel_l2 = float(diff.norm()) / max(float(ref.float().norm()), 1e-30)
    return name, err, rel_max, rel_l2, rel_max <= max_rel and rel_l2 <= l2_rel


def _compare(label, kernel, out, ref, dtype):
    import torch

    require(bool(torch.isfinite(out).all()), f"{label}: non-finite kernel output")
    name, err, rel_max, rel_l2, ok = _errors(out, ref, dtype)
    max_rel, l2_rel = TOL[name]
    log(f"[kernels] {kernel} {label} {name}: max_abs_err={err:.3e} "
        f"max_abs_err/max|plain|={rel_max:.3e} (tol {max_rel:g}) "
        f"rel_l2={rel_l2:.3e} (tol {l2_rel:g}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{kernel} {label} {name}: disagrees with its plain version "
                f"(max_abs_err {err:.3e}, relative {rel_max:.3e}, rel_l2 {rel_l2:.3e})")
    return {"label": label, "kernel": kernel, "dtype": name, "max_abs_err": err,
            "rel_max": rel_max, "rel_l2": rel_l2}


def _control(label, kernel, short, ref, dtype, tile="key"):
    """Negative control: the kernel run without each row's last key (or
    query) tile must fail the bound its full run passes."""
    name, _, rel_max, rel_l2, ok = _errors(short, ref, dtype)
    log(f"[kernels] {kernel} {label} {name}: control without the last {tile} tile: "
        f"max_abs_err/max|plain|={rel_max:.3e} rel_l2={rel_l2:.3e} "
        f"{'passes (BAD)' if ok else 'rejected'}")
    require(not ok, f"{kernel} {label} {name}: the bound does not reject a kernel "
                    f"that skips its last {tile} tile")


def _bound(ops, nbytes, dtype):
    import torch

    name = "float32" if dtype == torch.float32 else "bfloat16"
    t_ops = ops / PEAK_OPS[name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "ops_ms": t_ops, "bytes_ms": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# K1's nine main-path passes (b, h, nq, nk, d): the four serving passes at
# bucket 128 and the five training passes of TRAIN_CASES (heads 8, d 64)
K1_MAIN_PATH = {
    "serve pair axial": (1536, 8, 384, 384, 64),
    "serve pair<-MSA": (4, 8, 147456, 640, 64),
    "serve MSA<-pair": (4, 8, 640, 147456, 64),
    "serve MSA column": (512, 8, 5, 5, 64),
    "train pair axial": (128, 8, 128, 128, 64),
    "train MSA column": (64, 8, 5, 5, 64),
    "train MSA row": (5, 8, 64, 64, 64),
    "train pair<-MSA": (1, 8, 16384, 320, 64),
    "train MSA<-pair": (1, 8, 320, 16384, 64),
}
K1_SM90 = "attention_kernel_sm90<64>"


def check_k1_plans():
    """K1's plan on each main-path shape (bf16, TMA-aligned operands) must
    name the redesigned kernel, and a split shape the combine pass."""
    import ctypes

    from alphafold2_tpu_torch.ops.cuda import build
    from alphafold2_tpu_torch.ops.cuda.axial import key_splits

    lib = build.library("fused_attention")
    for label, (b, h, nq, nk, d) in K1_MAIN_PATH.items():
        splits = key_splits(b, h, nq, nk, d)
        plan = build.LaunchPlan()
        build.check(lib, lib.af2_fused_attention_plan(1, b, h, nq, nk, d, splits, 1,
                                                      ctypes.byref(plan)), "K1 plan")
        name = plan.kernel.decode()
        line = f"{name}, {plan.blocks} blocks of {plan.threads}, {plan.dynamic_smem} B"
        if splits > 1:
            comb = build.LaunchPlan()
            build.check(lib, lib.af2_fused_attention_combine_plan(b, h, nq, d,
                                                                  ctypes.byref(comb)),
                        "K1 combine plan")
            line += f"; {splits} key splits, then {comb.kernel.decode()} ({comb.blocks} blocks)"
            require(comb.kernel.decode() == "combine_kernel<64>",
                    f"{label}: the combine pass plans {comb.kernel.decode()}")
        log(f"[kernels] K1 plan, {label} {(b, h, nq, nk, d)}: {line}")
        require(name == K1_SM90, f"{label}: K1 plans {name}, not {K1_SM90}")


SERVE_LENGTHS = [128, 110, 97, 0]  # a bucket-128 batch of 4: one dummy slot


def _serve_masks():
    """The serving path's K1 masks at bucket 128, batch 4 (one dummy slot):
    the pair axial pass (rows fold into the batch), the MSA column pass and
    the flat pair and MSA token masks of the cross passes."""
    lens = SERVE_LENGTHS
    pair_valid = _prefix(384, [3 * l for l in lens])  # (4, 384) elongated tokens
    pair_mask = pair_valid[:, :, None] & pair_valid[:, None, :]  # (4, 384, 384)
    msa_valid = _prefix(128, lens)  # (4, 128) residues
    msa_mask = msa_valid[:, None, :].expand(4, 5, 128)  # (4, 5, 128)
    return (pair_mask.reshape(4 * 384, 384), msa_mask.transpose(1, 2).reshape(4 * 128, 5),
            pair_mask.reshape(4, 384 * 384), msa_mask.reshape(4, 5 * 128))


def phase_k1_time(reps=10):
    """K1 alone on its nine main-path passes, bf16, operands laid out as
    the path lays them out: the four serving passes (no lse) and the five
    training passes (with lse), each timed beside SDPA on the same masked
    problem, with the host time of a call. No checks: phase_kernels and
    phase_backward hold K1 to its plain version. Returns {label: row}."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial

    gen = torch.Generator(device="cuda").manual_seed(4)
    pair_axial, msa_col, pair_flat, msa_flat = _serve_masks()
    serve = {"serve pair axial": (pair_axial, pair_axial), "serve MSA column": (msa_col, msa_col),
             "serve pair<-MSA": (pair_flat, msa_flat), "serve MSA<-pair": (msa_flat, pair_flat)}
    train = dict(zip(list(K1_MAIN_PATH)[4:], (_train_masks(t) for t in TRAIN_CASES)))
    rows = {}
    for label, (b, h, nq, nk, d) in K1_MAIN_PATH.items():
        qm, km = {**serve, **train}[label]
        with_lse = label in train
        q, k, v = _k1_operands(b, h, nq, nk, d, torch.bfloat16, gen, serving=True)
        scale = d**-0.5
        run = ((lambda: axial.fused_attention_lse(q, k, v, qm, km, scale)) if with_lse else
               (lambda: axial.fused_attention(q, k, v, q_mask=qm, kv_mask=km, sm_scale=scale)))
        am = km[:, None, None, :]
        row = {"ms": cuda_ms(run, reps), "host_us": _host_us(run),
               "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=am, scale=scale), reps)}
        rows[label] = row
        log(f"[k1 time] {label} {(b, h, nq, nk, d)}{' lse' if with_lse else ''}: K1 "
            f"{row['ms']:.4f} ms, host {row['host_us']:.1f} us a call; SDPA {row['sdpa_ms']:.4f} ms")
        del q, k, v
    layer = {"serve pair axial": 2, "serve MSA column": 1, "serve pair<-MSA": 1,
             "serve MSA<-pair": 1}
    step = {label: 6 * calls for label, (*_, calls) in zip(train, TRAIN_CASES.values())}
    for what, weights in (("serving trunk layer", layer), ("training step", step)):
        k1 = sum(w * rows[lb]["ms"] for lb, w in weights.items())
        sdpa = sum(w * rows[lb]["sdpa_ms"] for lb, w in weights.items())
        log(f"[k1 time] per {what}: K1 {k1:.3f} ms, SDPA {sdpa:.3f} ms")
    return rows


def _device_ms(fn, calls=10):
    """Device time per call of ``fn`` in ms: every device-side event that
    torch.profiler records over ``calls`` calls, free of the host's pace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return us / calls / 1e3


def phase_k3_time(reps=10):
    """K3a and K3b alone on the five training passes, bf16, operands laid
    out as the training path lays them out, each beside SDPA's whole
    backward (dq, dk and dv in one call) on the same masked problem: a
    call's time by CUDA events over ``reps`` calls (paced by the host where
    the call is short), its device time under torch.profiler (kernels only,
    the merge pass included where it splits) and its host time; then per
    training step. No checks: phase_backward holds K3 to its plain versions.
    Uses only what every tree of the port has, so chip_compare.sh can run it
    for a parent that lacks it. Returns {label: row}."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = {}
    for label, (b, nq, nk, _) in TRAIN_CASES.items():
        h, d = 8, 64
        qm, km = _train_masks(label)
        q, k, v, do = _grad_operands(b, h, nq, nk, d, torch.bfloat16, gen, strided=True)
        scale = d**-0.5
        out, lse = axial.fused_attention_lse(q, k, v, qm, km, scale)
        args = (q, k, v, do, lse, axial.attention_dsum(out, do), qm, km, scale)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=km[:, None, None, :], scale=scale)
        calls = {"dq": lambda: axial.fused_attention_dq(*args),
                 "dkv": lambda: axial.fused_attention_dkv(*args),
                 "sdpa": lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)}
        row = {}
        for name, fn in calls.items():
            row[f"{name}_ms"] = cuda_ms(fn, reps)
            row[f"{name}_device_ms"] = _device_ms(fn)
            row[f"{name}_host_us"] = _host_us(fn)
        rows[label] = row
        splits = (tuple(axial.grad_splits(b, h, nq, nk, d, w) for w in ("dq", "dkv"))
                  if hasattr(axial, "grad_splits") else "-")
        log(f"[k3 time] {label} {(b, h, nq, nk, d)} splits {splits}: " + "; ".join(
            f"{what} {row[f'{n}_ms']:.4f} ms, device {row[f'{n}_device_ms']:.4f} ms, host "
            f"{row[f'{n}_host_us']:.1f} us a call"
            for n, what in (("dq", "K3a"), ("dkv", "K3b"), ("sdpa", "SDPA backward"))))
        del q, k, v, do, out, lse, args, leaves, o, calls
    weights = _step_weights(backward=True)
    step = {key: sum(w * rows[lb][key] for lb, w in weights.items()) for key in rows[label]}
    for kind in ("", "device_"):
        k3a, k3b = step[f"dq_{kind}ms"], step[f"dkv_{kind}ms"]
        log(f"[k3 time] per training step, {kind or 'event '}ms: K3a {k3a:.3f} + K3b {k3b:.3f} "
            f"= {k3a + k3b:.3f} ms; SDPA backward {step[f'sdpa_{kind}ms']:.3f} ms")
    return rows


def phase_kernels():
    import torch

    check_k1_plans()

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    # serving path at bucket 128, batch 4 (one dummy slot), dim_head 64:
    # per trunk layer K1 runs two pair axial passes, the MSA column pass
    # and both cross-attentions; K2 the tied MSA row pass
    lens = SERVE_LENGTHS
    axial, msa_col, pair_flat, msa_flat = _serve_masks()
    main = []
    for dt in (bf16, f32):
        reps = 3 if dt == bf16 else 0
        lib = dt == bf16
        main.append(k1_case("pair axial pass (1536x8, 384x384, d64)", 4 * 384, 8, 384, 384,
                            64, dt, axial, axial, reps=reps, library=lib, gen=gen,
                            serving=True))
        main.append(k1_case("MSA column pass (512x8, 5x5, d64)", 4 * 128, 8, 5, 5, 64, dt,
                            msa_col, msa_col, reps=reps, library=lib, gen=gen,
                            serving=True))
        main.append(k1_case("pair<-MSA cross (4x8, 147456x640, d64)", 4, 8, 384 * 384, 640,
                            64, dt, pair_flat, msa_flat, reps=reps, library=lib, gen=gen,
                            serving=True))
        main.append(k1_case("MSA<-pair cross (4x8, 640x147456, d64)", 4, 8, 640, 384 * 384,
                            64, dt, msa_flat, pair_flat, reps=reps, library=lib, gen=gen,
                            serving=True))
        main.append(k2_case("tied MSA rows (4x5x128x8x64, R*D=320)", 4, 5, 128, 8, 64, dt,
                            length=lens, reps=reps, library=lib, gen=gen))
    rows += main
    # edge cases, both dtypes
    for dt in (f32, bf16):
        rows.append(k1_case("ragged tails 200x91 d32", 2, 2, 200, 91, 32, dt,
                            _prefix(200, [197, 150]), _prefix(91, [84, 91]), reps=0,
                            gen=gen))
        rows.append(k1_case("Nk=5 d64", 3, 4, 70, 5, 64, dt, _prefix(70, [70, 60, 5]),
                            _prefix(5, [5, 3, 1]), reps=0, gen=gen))
        rows.append(k1_case("fully masked batch row d16", 2, 2, 64, 64, 16, dt,
                            _prefix(64, [64, 64]), _prefix(64, [0, 64]), reps=0, gen=gen))
        rows.append(k1_case("unmasked 130x130 d128", 1, 2, 130, 130, 128, dt, reps=0,
                            gen=gen))
        # a negative scale: the Hopper kernel's softmax then tracks each
        # row's smallest raw logit
        rows.append(k1_case("negative sm_scale 150x300 d64", 2, 2, 150, 300, 64, dt,
                            _prefix(150, [150, 99]), _prefix(300, [300, 170]), reps=0,
                            gen=gen, sm_scale=-0.125))
        rows.append(k2_case("R*D=1280 (20 rows, d64)", 1, 20, 48, 2, 64, dt, length=[41],
                            reps=0, gen=gen))
        rows.append(k2_case("R*D=80 unmasked (5 rows, d16)", 2, 5, 33, 2, 16, dt, reps=0,
                            gen=gen))
    # fully masked query rows must come out exactly 0
    from alphafold2_tpu_torch.ops.cuda.axial import fused_attention

    q = torch.randn((2, 2, 64, 16), device="cuda", generator=gen)
    none = torch.zeros((2, 64), dtype=torch.bool, device="cuda")
    out = fused_attention(q, q, q, kv_mask=none, sm_scale=0.25)
    require(bool((out == 0).all()), "rows with no valid key are not exactly 0")
    log("[kernels] rows with no valid key: exactly 0")
    return rows


# --------------------------------------------------------------- phase 3


def _ones(b, n):
    import torch

    return torch.ones((b, n), dtype=torch.bool, device="cuda")


def _grad_operands(b, h, nq, nk, d, dtype, gen, strided):
    """q/k/v as _k1_operands builds them, and the output cotangent dO: with
    ``strided`` a (B, H, Nq, D) view of a (B, Nq, H*D) buffer, the layout
    autograd hands back through ops/attention.py's head fold."""
    import torch

    q, k, v = _k1_operands(b, h, nq, nk, d, dtype, gen, strided)
    if strided:
        do = torch.randn((b, nq, h * d), device="cuda", generator=gen).to(dtype)
        do = do.view(b, nq, h, d).transpose(1, 2)
    else:
        do = torch.randn((b, h, nq, d), device="cuda", generator=gen).to(dtype)
    return q, k, v, do


def _check_lse(label, lse, ref, kernel="fused_attention (lse)"):
    import torch

    require(bool((torch.isinf(lse) == torch.isinf(ref)).all()),
            f"{label}: logsumexp rows without a valid key disagree")
    fin = torch.isfinite(ref)
    err = float((lse[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
    log(f"[backward] {kernel} {label}: lse max_abs_err={err:.3e} (tol 1e-4)")
    require(err <= 1e-4, f"{label}: logsumexp disagrees with its plain version")


def _k3_sm90_launched(args, what):
    """K3a and K3b once each on ``args``; require that both ran the Hopper
    kernels. Returns ((dq, dk, dv), how many merge passes they launched)."""
    from alphafold2_tpu_torch.ops.cuda import axial

    before = (axial.fused_attention_dq.sm90_launches, axial.fused_attention_dkv.sm90_launches,
              axial.fused_attention_bwd_merge.launches)
    dq = axial.fused_attention_dq(*args)
    dk, dv = axial.fused_attention_dkv(*args)
    require(axial.fused_attention_dq.sm90_launches - before[0] == 1,
            f"{what}: K3a did not launch dq_kernel_sm90")
    require(axial.fused_attention_dkv.sm90_launches - before[1] == 1,
            f"{what}: K3b did not launch dkv_kernel_sm90")
    return (dq, dk, dv), axial.fused_attention_bwd_merge.launches - before[2]


def k3_case(label, b, h, nq, nk, d, dtype, q_mask=None, kv_mask=None, reps=3,
            library=False, gen=None, strided=False):
    """K1's training forward, K3a and K3b on one problem, each held against
    its plain version; a negative control; two backward runs bit-identical.
    Returns result rows for K1 (lse), K3a and K3b."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial

    q, k, v, do = _grad_operands(b, h, nq, nk, d, dtype, gen, strided)
    scale = d**-0.5
    forward = lambda: axial.fused_attention_lse(q, k, v, q_mask, kv_mask, scale)
    if strided and dtype == torch.bfloat16:  # a training main-path pass
        splits = axial.key_splits(b, h, nq, nk, d)
        (out, lse), combined = _sm90_launched(forward, label)
        require(combined == (splits > 1), f"{label}: combine launches {combined}, "
                                          f"{splits} key splits")
        out2, lse2 = forward()
        require(torch.equal(out, out2) and torch.equal(lse, lse2),
                f"{label}: two K1 (lse) runs differ")
        log(f"[backward] fused_attention (lse) {label}: attention_kernel_sm90, {splits} key "
            f"split(s), two runs bit-identical (out and lse)")
        del out2, lse2
    else:
        out, lse = forward()
    torch.cuda.synchronize()
    ref_out, ref_lse = axial.fused_attention_lse_reference(q, k, v, q_mask, kv_mask, scale)
    fwd = _compare(label, "fused_attention (lse)", out, ref_out, dtype)
    _check_lse(label, lse, ref_lse)
    dsum = axial.attention_dsum(out, do)
    args = (q, k, v, do, lse, dsum, q_mask, kv_mask, scale)
    if strided and dtype == torch.bfloat16:  # a training main-path pass
        (dq, dk, dv), merged = _k3_sm90_launched(args, label)
        splits = (axial.grad_splits(b, h, nq, nk, d, "dq"),
                  axial.grad_splits(b, h, nq, nk, d, "dkv"))
        require(merged == sum(s > 1 for s in splits),
                f"{label}: merge launches {merged}, splits (K3a, K3b) {splits}")
        log(f"[backward] {label}: dq_kernel_sm90 and dkv_kernel_sm90, splits (K3a, K3b) "
            f"{splits}, {merged} merge pass(es)")
    else:
        dq = axial.fused_attention_dq(*args)
        dk, dv = axial.fused_attention_dkv(*args)
    torch.cuda.synchronize()
    rq = axial.fused_attention_dq_reference(*args)
    rk, rv = axial.fused_attention_dkv_reference(*args)
    row_q = _compare(label, "fused_attention_bwd_dq", dq, rq, dtype)
    row_k = _compare(label, "fused_attention_bwd_dkv dk", dk, rk, dtype)
    row_v = _compare(label, "fused_attention_bwd_dkv dv", dv, rv, dtype)
    row_kv = dict(row_k, kernel="fused_attention_bwd_dkv",
                  max_abs_err=max(row_k["max_abs_err"], row_v["max_abs_err"]))
    row_q["kernel"] = "fused_attention_bwd_dq"
    require(torch.equal(dq, axial.fused_attention_dq(*args)), f"{label}: K3a not deterministic")
    dk2, dv2 = axial.fused_attention_dkv(*args)
    require(torch.equal(dk, dk2) and torch.equal(dv, dv2), f"{label}: K3b not deterministic")
    log(f"[backward] {label} {fwd['dtype']}: two backward runs bit-identical")
    if strided:
        # negative control: without each row's last key tile (dq), without
        # each key's last query tile (dk, dv)
        qm = q_mask if q_mask is not None else _ones(b, nq)
        km = kv_mask if kv_mask is not None else _ones(b, nk)
        short = axial.fused_attention_dq(q, k, v, do, lse, dsum, qm, _drop_last_tile(km), scale)
        _control(label, "fused_attention_bwd_dq", short, rq, dtype)
        sk, sv = axial.fused_attention_dkv(q, k, v, do, lse, dsum, _drop_last_tile(qm), km,
                                           scale)
        _control(label, "fused_attention_bwd_dkv dk", sk, rk, dtype, tile="query")
        _control(label, "fused_attention_bwd_dkv dv", sv, rv, dtype, tile="query")
        del short, sk, sv
        if dtype == torch.bfloat16:
            merge_checks(label, args, (rq, rk, rv))
    qv = q_mask.sum(1) if q_mask is not None else torch.full((b,), nq, device="cuda")
    kvn = kv_mask.sum(1) if kv_mask is not None else torch.full((b,), nk, device="cuda")
    pairs = h * float((qv * kvn).sum())
    es = q.element_size()
    reads = (2 * b * h * nq * d + 2 * b * h * nk * d) * es + (
        (b * nq if q_mask is not None else 0) + (b * nk if kv_mask is not None else 0))
    rows_lse = 4 * b * h * nq
    # the forward reads q, k, v and writes out (as many bytes as q, k, v, dO)
    fwd.update(_bound(4.0 * d * pairs, reads + rows_lse, dtype))
    # K3a: q.k recompute, dO.v, ds.k; K3b: q.k recompute, dO.v, p^T dO, ds^T q
    row_q.update(_bound(6.0 * d * pairs, reads + 2 * rows_lse + b * h * nq * d * es, dtype))
    row_kv.update(_bound(8.0 * d * pairs, reads + 2 * rows_lse + 2 * b * h * nk * d * es,
                         dtype))
    if reps:
        fwd["ms"] = cuda_ms(forward, reps)
        fwd["host_us"] = _host_us(forward)
        fwd["plain_ms"] = cuda_ms(lambda: axial.fused_attention_lse_reference(
            q, k, v, q_mask, kv_mask, scale), reps=1, warmup=0)
        row_q["ms"] = cuda_ms(lambda: axial.fused_attention_dq(*args), reps)
        row_kv["ms"] = cuda_ms(lambda: axial.fused_attention_dkv(*args), reps)
        row_q["plain_ms"] = cuda_ms(lambda: axial.fused_attention_dq_reference(*args),
                                    reps=1, warmup=0)
        row_kv["plain_ms"] = cuda_ms(lambda: axial.fused_attention_dkv_reference(*args),
                                     reps=1, warmup=0)
        if library:
            # the same masked problem through SDPA: its forward once, then
            # its backward (dq, dk and dv in one call) timed
            am = kv_mask[:, None, None, :] if kv_mask is not None else None
            try:
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o = F.scaled_dot_product_attention(*leaves, attn_mask=am, scale=scale)
                fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=am, scale=scale), reps)
                bwd = cuda_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                              reps)
                row_q["library_ms"] = row_kv["library_ms"] = bwd
                del o, leaves
            except (RuntimeError, torch.OutOfMemoryError) as e:
                log(f"[backward] {label}: scaled_dot_product_attention failed: {e}")
                fwd["library_ms"] = row_q["library_ms"] = row_kv["library_ms"] = None
    del q, k, v, do, out, lse, dq, dk, dv, rq, rk, rv
    torch.cuda.empty_cache()
    return [fwd, row_q, row_kv]


def merge_checks(label, args, refs):
    """Where K3a or K3b splits this pass: K3's merge kernel alone on the
    plain per-split partials against the plain merge, the merged gradient
    against the plain whole one, and the negative control, a merge that
    drops the last split, which the bound must reject."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial

    q, k, v = args[:3]
    b, h, nq, d = q.shape
    nk = k.shape[2]
    scale = args[-1]
    for which in ("dq", "dkv"):
        splits = axial.grad_splits(b, h, nq, nk, d, which)
        if splits == 1:
            continue
        if which == "dq":
            parts = {"dq": (axial.dq_partials_reference(*args, splits=splits), scale, refs[0])}
        else:
            pk, pv = axial.dkv_partials_reference(*args, splits=splits)
            parts = {"dk": (pk, scale, refs[1]), "dv": (pv, 1.0, refs[2])}
        for name, (part, sc, ref) in parts.items():
            before = axial.fused_attention_bwd_merge.launches
            merged = axial.fused_attention_bwd_merge(part, sc)
            torch.cuda.synchronize()
            require(axial.fused_attention_bwd_merge.launches == before + 1,
                    f"{label}: the merge kernel did not launch")
            plain = axial.merge_grad_partials_reference(part, sc, torch.bfloat16)
            _compare(f"{label}, {name}, {splits} splits", "fused_attention_bwd_merge", merged,
                     plain, torch.bfloat16)
            _compare(f"{label}, {name} merged", "fused_attention_bwd_merge", merged, ref,
                     torch.bfloat16)
            short = axial.fused_attention_bwd_merge(part[:-1], sc)
            _control(f"{label}, {name}", "fused_attention_bwd_merge", short, ref,
                     torch.bfloat16, tile="split")
            del part, merged, plain, short
        del parts


# training shapes: crop 128, batch 1, heads 8, dim_head 64, one synthetic
# chain of TRAIN_LEN residues (its MSA, 5 x 64, is fully valid); per trunk
# layer two pair axial passes, the MSA column and row passes, both crosses
TRAIN_LEN = 110
TRAIN_CASES = {  # label: (b, nq, nk, per-layer calls)
    "pair axial (128x8, 128x128)": (128, 128, 128, 2),
    "MSA column (64x8, 5x5)": (64, 5, 5, 1),
    "MSA row (5x8, 64x64)": (5, 64, 64, 1),
    "pair<-MSA (1x8, 16384x320)": (1, 16384, 320, 1),
    "MSA<-pair (1x8, 320x16384)": (1, 320, 16384, 1),
}


def _train_masks(label):
    res = _prefix(128, [TRAIN_LEN])  # (1, 128) residues
    pair = (res[:, :, None] & res[:, None, :])[0]  # (128, 128)
    msa = _ones(1, 5 * 64)
    return {
        "pair axial (128x8, 128x128)": (pair, pair),
        "MSA column (64x8, 5x5)": (_ones(64, 5), _ones(64, 5)),
        "MSA row (5x8, 64x64)": (_ones(5, 64), _ones(5, 64)),
        "pair<-MSA (1x8, 16384x320)": (pair.reshape(1, -1), msa),
        "MSA<-pair (1x8, 320x16384)": (msa, pair.reshape(1, -1)),
    }[label]


def combine_case(label, b, h, nq, nk, d, q_mask, kv_mask, gen):
    """K1's combine pass alone against its plain version, on the plain
    per-split partials of one problem (with the lse)."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial

    q, k, v = _k1_operands(b, h, nq, nk, d, torch.bfloat16, gen, serving=False)
    splits = axial.key_splits(b, h, nq, nk, d)
    m, l, acc = axial.attention_partials_reference(q, k, v, kv_mask, d**-0.5, splits)
    before = axial.fused_attention_combine.launches
    out, lse = axial.fused_attention_combine(m, l, acc, q_mask, with_lse=True)
    torch.cuda.synchronize()
    require(axial.fused_attention_combine.launches == before + 1,
            f"{label}: the combine kernel did not launch")
    ref, ref_lse = axial.combine_partials_reference(m, l, acc, q_mask, with_lse=True)
    row = _compare(f"{label}, {splits} splits", "fused_attention_combine", out, ref,
                   torch.bfloat16)
    _check_lse(label, lse, ref_lse, "fused_attention_combine")
    return row


# K3's five main-path passes (the training passes of TRAIN_CASES, heads 8,
# d 64) and the split counts (K3a, K3b) of ops/cuda/axial.py grad_splits
K3_SPLITS = {
    "pair axial (128x8, 128x128)": (1, 1),
    "MSA column (64x8, 5x5)": (1, 1),
    "MSA row (5x8, 64x64)": (1, 1),
    "pair<-MSA (1x8, 16384x320)": (1, 7),
    "MSA<-pair (1x8, 320x16384)": (7, 1),
}
K3_SM90 = ("dq_kernel_sm90<64>", "dkv_kernel_sm90<64>")


def check_k3_plans():
    """K3a's and K3b's plans on each training pass (bf16, TMA-aligned
    operands) must name the Hopper kernels with the expected splits, and a
    split pass the merge kernel."""
    import ctypes

    from alphafold2_tpu_torch.ops.cuda import build
    from alphafold2_tpu_torch.ops.cuda.axial import grad_splits

    lib = build.library("fused_attention_bwd")
    for label, (b, nq, nk, _) in TRAIN_CASES.items():
        h, d = 8, 64
        for which, name, want, outs, rows in ((0, "dq", K3_SM90[0], 1, nq),
                                              (1, "dkv", K3_SM90[1], 2, nk)):
            splits = grad_splits(b, h, nq, nk, d, name)
            require(splits == K3_SPLITS[label][which],
                    f"{label}: grad_splits gives {splits} for {name}, not "
                    f"{K3_SPLITS[label][which]}")
            plan = build.LaunchPlan()
            build.check(lib, lib.af2_fused_attention_bwd_plan(which, 1, b, h, nq, nk, d, splits,
                                                              1, ctypes.byref(plan)), "K3 plan")
            kernel = plan.kernel.decode()
            line = f"{kernel}, {plan.blocks} blocks of {plan.threads}, {plan.dynamic_smem} B"
            if splits > 1:
                merge = build.LaunchPlan()
                build.check(lib, lib.af2_fused_attention_bwd_merge_plan(
                    outs, b, h, rows, d, ctypes.byref(merge)), "K3 merge plan")
                line += f"; {splits} splits, then {merge.kernel.decode()} ({merge.blocks} blocks)"
                require(merge.kernel.decode() == "grad_merge_kernel<64>",
                        f"{label}: the merge pass plans {merge.kernel.decode()}")
            log(f"[backward] K3{'ab'[which]} plan, {label}: {line}")
            require(kernel == want, f"{label}: K3{'ab'[which]} plans {kernel}, not {want}")


def unaligned_k3_case(gen):
    """bf16 operands TMA cannot describe (views one element into a buffer
    with rows of 65): the plan must take the older tile kernels, which
    launch no Hopper kernel and no merge, and agree with the plain
    versions."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial

    b, h, nq, nk, d = 2, 2, 150, 200, 64
    q, k, v, do = (torch.randn((b, h, n, d + 1), device="cuda", generator=gen)
                   .to(torch.bfloat16)[..., 1:] for n in (nq, nk, nk, nq))
    qm, km = _prefix(nq, [150, 111]), _prefix(nk, [200, 77])
    out, lse = axial.fused_attention_lse(q, k, v, qm, km, d**-0.5)
    args = (q, k, v, do, lse, axial.attention_dsum(out, do), qm, km, d**-0.5)
    counts = lambda: (axial.fused_attention_dq.sm90_launches,
                      axial.fused_attention_dkv.sm90_launches,
                      axial.fused_attention_bwd_merge.launches)
    before = counts()
    dq = axial.fused_attention_dq(*args)
    dk, dv = axial.fused_attention_dkv(*args)
    torch.cuda.synchronize()
    require(counts() == before, "unaligned bf16 operands reached a Hopper K3 kernel")
    label = "unaligned operands 150x200 d64"
    _compare(label, "fused_attention_bwd_dq", dq, axial.fused_attention_dq_reference(*args),
             torch.bfloat16)
    for name, got, ref in zip(("dk", "dv"), (dk, dv), axial.fused_attention_dkv_reference(*args)):
        _compare(label, f"fused_attention_bwd_dkv {name}", got, ref, torch.bfloat16)
    log(f"[backward] {label}: dq_kernel_mma and dkv_kernel_mma, no merge")


def phase_backward():
    import torch

    check_k3_plans()
    gen = torch.Generator(device="cuda").manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    for dt in (bf16, f32):
        for label, (b, nq, nk, _) in TRAIN_CASES.items():
            qm, km = _train_masks(label)
            rows += k3_case(label, b, 8, nq, nk, 64, dt, qm, km, reps=3 if dt == bf16 else 0,
                            library=dt == bf16, gen=gen, strided=True)
    label = "MSA<-pair (1x8, 320x16384)"
    combine_case(label, 1, 8, 320, 16384, 64, *_train_masks(label), gen)
    for dt in (f32, bf16):
        rows += k3_case("ragged tails 200x91 d32", 2, 2, 200, 91, 32, dt,
                        _prefix(200, [197, 150]), _prefix(91, [84, 91]), reps=0, gen=gen)
        rows += k3_case("Nk=5 d64", 3, 4, 70, 5, 64, dt, _prefix(70, [70, 60, 5]),
                        _prefix(5, [5, 3, 1]), reps=0, gen=gen)
        rows += k3_case("fully masked batch row d16", 2, 2, 64, 64, 16, dt,
                        _prefix(64, [64, 64]), _prefix(64, [0, 64]), reps=0, gen=gen)
        rows += k3_case("unmasked 130x130 d128", 1, 2, 130, 130, 128, dt, reps=0, gen=gen)
    unaligned_k3_case(gen)
    # a batch row with no valid key: zero, finite gradients
    from alphafold2_tpu_torch.ops.cuda.axial import fused_attention

    q, k, v = (torch.randn((2, 2, 64, 16), device="cuda", generator=gen).requires_grad_()
               for _ in range(3))
    km = _prefix(64, [0, 64])
    fused_attention(q, k, v, kv_mask=km, sm_scale=0.25).sum().backward()
    for g in (q.grad, k.grad, v.grad):
        require(bool(torch.isfinite(g).all()) and bool((g[0] == 0).all()),
                "a row with no valid key has nonzero or non-finite gradients")
    log("[backward] rows with no valid key: gradients exactly 0, all finite")
    return rows


# --------------------------------------------------------------- phase 3b


HEAD_DIM_CASES = (48, 256)  # padded to 64; D-chunked past 128


def head_dim_case(d, dtype, gen):
    """K1, K1 with lse, K3a and K3b at a head dim no kernel is built for,
    each against its plain version (k1_case, k3_case); then the autograd
    route, which must launch K1 (lse), K3a and K3b once each, call no plain
    version, and give the direct calls' results bit for bit."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial

    b, h, nq, nk = 2, 4, 200, 150
    label = f"head dim {d} (2x4, 200x150)"
    qm, km = _prefix(nq, [200, 123]), _prefix(nk, [150, 77])
    rows = k3_case(label, b, h, nq, nk, d, dtype, qm, km, reps=0, gen=gen)
    rows.append(k1_case(label, b, h, nq, nk, d, dtype, qm, km, reps=0, gen=gen))
    q, k, v, do = _grad_operands(b, h, nq, nk, d, dtype, gen, strided=True)
    scale = d**-0.5
    plain = (axial.fused_attention_reference, axial.fused_attention_lse_reference,
             axial.fused_attention_dq_reference, axial.fused_attention_dkv_reference)
    wrappers = (axial.fused_attention, axial.fused_attention_dq, axial.fused_attention_dkv)
    calls, launches = [f.calls for f in plain], [f.launches for f in wrappers]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = axial.fused_attention(*leaves, q_mask=qm, kv_mask=km, sm_scale=scale)
    out.backward(do)
    torch.cuda.synchronize()
    ran = [f.launches - n for f, n in zip(wrappers, launches)]
    require(ran == [1, 1, 1], f"{label}: the autograd route launched {ran} (K1, K3a, K3b)")
    require([f.calls for f in plain] == calls, f"{label}: a plain version ran on the card")
    out2, lse = axial.fused_attention_lse(q, k, v, qm, km, scale)
    args = (q, k, v, do, lse, axial.attention_dsum(out2, do), qm, km, scale)
    dk, dv = axial.fused_attention_dkv(*args)
    require(torch.equal(out.detach(), out2) and torch.equal(leaves[0].grad,
                                                            axial.fused_attention_dq(*args))
            and torch.equal(leaves[1].grad, dk) and torch.equal(leaves[2].grad, dv),
            f"{label}: the autograd route differs from the direct kernel calls")
    log(f"[head dims] {label} {rows[0]['dtype']}: through kernels only, at head dim "
        f"{axial.kernel_head_dim(d)}; autograd route bit-identical to the direct calls")
    return rows


def phase_head_dims():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for d in HEAD_DIM_CASES:
        for dt in (torch.float32, torch.bfloat16):
            rows += head_dim_case(d, dt, gen)
    return rows


# --------------------------------------------------------------- phase 3c


# K2's shapes (b, r, n, h, d) under grad: the tied training path (MSA 5 x 64,
# 8 heads, R*D 320; 6 layers, one call each a step) and JAX's gate case
# case_tied_row_bwd (R*D 512)
TIED_TRAIN_LABEL = "tied rows, training (1x5x64x8x64, R*D 320)"
TIED_CASES = {TIED_TRAIN_LABEL: (1, 5, 64, 8, 64),
              "tied rows, gate (1x8x256x4x64, R*D 512)": (1, 8, 256, 4, 64)}


def _tied_operands(b, r, n, h, d, dtype, gen):
    """q, k, v, dO (B, R, N, H, D) and the shared mask and tie scale as
    ops/attention.py builds them: the last n/8 columns masked, row 1 ragged
    (half as long), a middle row absent (the last row keeps its data, which
    the feature-chunk controls drop), padded entries of q, k, v zeroed, the
    tie scale counting the voting rows."""
    import torch

    rows = torch.ones((b, r, n), dtype=torch.bool, device="cuda")
    rows[:, :, n - n // 8:] = False
    rows[:, 1, n // 2:] = False
    rows[:, r // 2] = False
    q, k, v, do = (torch.randn((b, r, n, h, d), device="cuda", generator=gen)
                   for _ in range(4))
    q, k, v = (t * rows[..., None, None] for t in (q, k, v))
    tie = rows.any(-1).sum(-1).clamp_min(1).float() ** -0.5
    return (*(t.to(dtype).contiguous() for t in (q, k, v, do)), rows.any(1), tie)


def _drop_last_chunk(t, chunk=64):
    """A copy of (B, R, N, H, D) ``t`` whose last ``chunk`` fused features
    (f = r*D + d) are 0: what a kernel that skipped its last feature chunk
    would read."""
    t = t.clone()
    r, d = t.shape[1], t.shape[-1]
    for row in range(r):
        lo = max(0, r * d - chunk - row * d)
        if lo < d:
            t[:, row, ..., lo:] = 0
    return t


def _sdpa_backend(fn):
    """The first SDPA backend (flash, memory-efficient, cuDNN, math) that
    runs ``fn``, or None."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                fn()
                torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    return None


def tied_case(label, b, r, n, h, d, dtype, gen, reps=3, library=False):
    """K2 with lse, and K2's backward (dq; dk and dv), at one tied shape,
    each against its plain version; a negative control per kernel (the
    last feature chunk dropped from its recomputation); two backward runs
    bit-identical; the autograd route through the kernels alone. Returns
    result rows for the three kernels."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import tied_row as tr

    q, k, v, do, mask, tie = _tied_operands(b, r, n, h, d, dtype, gen)
    scale = d**-0.5
    forward = lambda: tr.tied_row_attention_lse(q, k, v, mask, mask, scale, tie)
    out, lse = forward()
    torch.cuda.synchronize()
    ref_out, ref_lse = tr.tied_row_attention_lse_reference(q, k, v, mask, mask, scale, tie)
    fwd = _compare(label, "tied_row_attention (lse)", out, ref_out, dtype)
    _check_lse(label, lse, ref_lse, "tied_row_attention (lse)")
    _control(label, "tied_row_attention (lse)",
             tr.tied_row_attention_lse(_drop_last_chunk(q), k, v, mask, mask, scale, tie)[0],
             ref_out, dtype, tile="feature")
    dsum = tr.tied_row_dsum(out, do)
    args = (q, k, v, do, lse, dsum, mask, mask, scale, tie)
    dq = tr.tied_row_attention_dq(*args)
    dk, dv = tr.tied_row_attention_dkv(*args)
    torch.cuda.synchronize()
    rq = tr.tied_row_attention_dq_reference(*args)
    rk, rv = tr.tied_row_attention_dkv_reference(*args)
    row_q = _compare(label, "tied_row_attention_bwd_dq", dq, rq, dtype)
    row_k = _compare(label, "tied_row_attention_bwd_dkv dk", dk, rk, dtype)
    row_v = _compare(label, "tied_row_attention_bwd_dkv dv", dv, rv, dtype)
    row_kv = dict(row_k, kernel="tied_row_attention_bwd_dkv",
                  max_abs_err=max(row_k["max_abs_err"], row_v["max_abs_err"]))
    require(torch.equal(dq, tr.tied_row_attention_dq(*args)), f"{label}: dq not deterministic")
    dk2, dv2 = tr.tied_row_attention_dkv(*args)
    require(torch.equal(dk, dk2) and torch.equal(dv, dv2), f"{label}: dk/dv not deterministic")
    # negative controls: q and dO feed only S and dO.V^T in the dq kernel, k
    # and v only S and dO.V^T in the dk/dv kernel
    short = tr.tied_row_attention_dq(_drop_last_chunk(q), k, v, _drop_last_chunk(do), lse,
                                     dsum, mask, mask, scale, tie)
    _control(label, "tied_row_attention_bwd_dq", short, rq, dtype, tile="feature")
    sk, sv = tr.tied_row_attention_dkv(q, _drop_last_chunk(k), _drop_last_chunk(v), do, lse,
                                       dsum, mask, mask, scale, tie)
    _control(label, "tied_row_attention_bwd_dkv dk", sk, rk, dtype, tile="feature")
    _control(label, "tied_row_attention_bwd_dkv dv", sv, rv, dtype, tile="feature")
    # the autograd route: K2 (lse), then both backward kernels, nothing else
    wrappers = (tr.tied_row_attention, tr.tied_row_attention_dq, tr.tied_row_attention_dkv)
    before = [f.launches for f in wrappers]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    tr.tied_row_attention(*leaves, q_mask=mask, kv_mask=mask, sm_scale=scale,
                          tie_scale=tie).backward(do)
    ran = [f.launches - n0 for f, n0 in zip(wrappers, before)]
    require(ran == [1, 1, 1], f"{label}: the autograd route launched {ran}")
    require(all(torch.equal(a.grad, x) for a, x in zip(leaves, (dq, dk, dv))),
            f"{label}: the autograd route differs from the direct kernel calls")
    log(f"[tied] {label} {fwd['dtype']}: autograd route bit-identical to the direct calls")
    # bounds: each of q, k, v, dO read once, each output written once
    nv = mask.sum(1).double()
    pairs = h * float((nv * nv).sum())
    f_ = r * d
    es = q.element_size()
    operand = b * r * n * h * d * es
    stats = 4 * b * h * n
    fwd.update(_bound(4.0 * f_ * pairs, 4 * operand + stats + 2 * b * n, dtype))
    row_q.update(_bound(6.0 * f_ * pairs, 5 * operand + 2 * stats + 2 * b * n, dtype))
    row_kv.update(_bound(8.0 * f_ * pairs, 6 * operand + 2 * stats + 2 * b * n, dtype))
    if reps:
        fwd["ms"] = cuda_ms(forward, reps)
        row_q["ms"] = cuda_ms(lambda: tr.tied_row_attention_dq(*args), reps)
        row_kv["ms"] = cuda_ms(lambda: tr.tied_row_attention_dkv(*args), reps)
        fwd["plain_ms"] = cuda_ms(lambda: tr.tied_row_attention_lse_reference(
            q, k, v, mask, mask, scale, tie), reps)
        row_q["plain_ms"] = cuda_ms(lambda: tr.tied_row_attention_dq_reference(*args), reps)
        row_kv["plain_ms"] = cuda_ms(lambda: tr.tied_row_attention_dkv_reference(*args), reps)
        if library:
            # SDPA on the folded (B, H, N, R*D) tensors, the tie scale in q
            from torch.nn.attention import sdpa_kernel

            fold = lambda t: t.permute(0, 3, 2, 1, 4).reshape(b, h, n, r * d)
            qf = (fold(q).float() * tie[:, None, None, None]).to(dtype)
            leaves = [t.detach().requires_grad_() for t in (qf, fold(k), fold(v))]
            am = mask[:, None, None, :]
            sdpa = lambda *t: F.scaled_dot_product_attention(*t, attn_mask=am, scale=scale)
            backend = _sdpa_backend(lambda: sdpa(*leaves).backward(fold(do)))
            fwd["library"] = row_q["library"] = row_kv["library"] = (
                backend.name if backend is not None else None)
            if backend is None:
                fwd["library_ms"] = row_q["library_ms"] = row_kv["library_ms"] = None
            else:
                with sdpa_kernel([backend]):
                    o = sdpa(*leaves)
                    g = fold(do)
                    fwd["library_ms"] = cuda_ms(lambda: sdpa(*(t.detach() for t in leaves)),
                                                reps)
                    row_q["library_ms"] = row_kv["library_ms"] = cuda_ms(
                        lambda: torch.autograd.grad(o, leaves, g, retain_graph=True), reps)
            log(f"[tied] {label} {fwd['dtype']}: SDPA takes head dim {r * d} on its "
                f"{fwd['library']} backend")
    return [fwd, row_q, row_kv]


def phase_tied():
    """K2 with lse and K2's backward at the tied training shape and the
    gate's shape, f32 and bf16."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for label, shape in TIED_CASES.items():
            timed = dt == torch.bfloat16 and label == TIED_TRAIN_LABEL
            rows += tied_case(label, *shape, dt, gen, reps=10 if timed else 0, library=timed)
    return rows


# --------------------------------------------------------------- phase 5


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def phase_train(sparse=False, tied=False):
    """The training checks at the slice configuration; with ``sparse``,
    model.sparse_self_attn=True (log tag ``[sparse train]``), with ``tied``
    model.msa_tie_row_attn=True (``[tied train]``: the MSA row pass through
    K2 with lse and K2's backward)."""
    import itertools

    import numpy as np
    import torch

    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.ops.cuda import axial, block_sparse, tied_row
    from alphafold2_tpu_torch.train import loop

    tag = "[sparse train]" if sparse else "[tied train]" if tied else "[train]"
    plain = (axial.fused_attention_reference, axial.fused_attention_lse_reference,
             axial.fused_attention_dq_reference, axial.fused_attention_dkv_reference,
             tied_row.tied_row_attention_reference, tied_row.tied_row_attention_lse_reference,
             tied_row.tied_row_attention_dq_reference, tied_row.tied_row_attention_dkv_reference,
             block_sparse.block_sparse_attention_reference,
             block_sparse.block_sparse_attention_lse_reference,
             block_sparse.block_sparse_attention_dq_reference,
             block_sparse.block_sparse_attention_dkv_reference)
    kernels = {"fused_attention": axial.fused_attention,
               "fused_attention_combine": axial.fused_attention_combine,
               "fused_attention_bwd_dq": axial.fused_attention_dq,
               "fused_attention_bwd_dkv": axial.fused_attention_dkv,
               "fused_attention_bwd_merge": axial.fused_attention_bwd_merge,
               "tied_row_attention": tied_row.tied_row_attention,
               "tied_row_attention_bwd_dq": tied_row.tied_row_attention_dq,
               "tied_row_attention_bwd_dkv": tied_row.tied_row_attention_dkv,
               "block_sparse_attention": block_sparse.block_sparse_attention_lse,
               "block_sparse_attention (no lse)": block_sparse.block_sparse_attention,
               "block_sparse_attention_bwd_dq": block_sparse.block_sparse_attention_dq,
               "block_sparse_attention_bwd_dkv": block_sparse.block_sparse_attention_dkv}

    # (a) the slice configuration: 32 steps = 2 accumulated updates
    cfg = Config()
    cfg.model.sparse_self_attn = sparse
    cfg.model.msa_tie_row_attn = tied
    depth = cfg.model.depth
    steps = 2 * cfg.train.gradient_accumulate_every
    snap, changed, times, losses, oks = {}, [], [], [], []

    def watch(i, state, metrics):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        if "p0" not in snap:
            snap["p0"] = _params(state.model)  # after step 0 (lr 0 or no update)
        same = all(torch.equal(a, b) for a, b in zip(snap["p0"], state.model.parameters()))
        changed.append(not same)
        losses.append(float(metrics["loss"]))
        oks.append((bool(metrics["grads_ok"]), int(metrics["skipped"])))

    for fn in kernels.values():
        fn.launches = 0
    for fn in (axial.fused_attention, axial.fused_attention_dq, axial.fused_attention_dkv):
        fn.sm90_launches = 0
    for fn in plain:
        fn.calls = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = loop.train(cfg, num_steps=steps, callbacks=[watch])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    sm90 = {name: kernels[name].sm90_launches
            for name in ("fused_attention", "fused_attention_bwd_dq", "fused_attention_bwd_dkv")}
    launches["block_sparse_attention"] += launches.pop("block_sparse_attention (no lse)")
    plain_calls = sum(fn.calls for fn in plain)
    peak = torch.cuda.max_memory_allocated()
    lat = np.diff(times[1:]) * 1e3  # steps 2 .. 32, warm
    log(f"{tag} {steps} steps at dim {cfg.model.dim}, depth {depth}, crop "
        f"{cfg.data.crop_len}, MSA {cfg.data.msa_depth}x{cfg.data.msa_len}, accumulation "
        f"{cfg.train.gradient_accumulate_every}: {wall:.2f} s incl. init; with per-step "
        f"norms and parameter checks, warm step latency median {np.median(lat):.2f} ms "
        f"(min {lat.min():.2f}, max {lat.max():.2f}), {1e3 / np.median(lat):.2f} steps/s; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    log(f"{tag} losses: first {losses[0]:.4f}, last {losses[-1]:.4f}; all finite: "
        f"{bool(np.isfinite(losses).all())}; skipped {oks[-1][1]}")
    log(f"{tag} kernel launches: {launches}; plain-version calls: {plain_calls}")
    require(bool(np.isfinite(losses).all()), "non-finite training loss")
    require(all(ok for ok, _ in oks) and oks[-1][1] == 0, "a training step was skipped")
    # every attention's forward runs K1, or K4 for the pair axial passes of a
    # sparse model, or K2 for the tied MSA row pass; every attention whose
    # output reaches the loss runs the backward (the last layer's MSA<-pair
    # update does not)
    sparse_calls = 2 * depth if sparse else 0
    tied_calls = depth if tied else 0
    require(launches["fused_attention"] == (6 * depth - sparse_calls - tied_calls) * steps,
            "K1 launches per step")
    require(sm90["fused_attention"] == launches["fused_attention"],
            "a K1 launch of the training path did not run attention_kernel_sm90")
    # the MSA<-pair pass, one a layer, is the one that splits its key axis
    require(launches["fused_attention_combine"] == depth * steps,
            "K1 combine launches per step")
    for name in ("fused_attention_bwd_dq", "fused_attention_bwd_dkv"):
        require(launches[name] == (6 * depth - 1 - sparse_calls - tied_calls) * steps,
                f"{name} launches per step")
        require(sm90[name] == launches[name],
                f"a {name} launch of the training path did not run {name[20:]}_kernel_sm90")
    # K3b splits on each layer's pair<-MSA pass, K3a on every MSA<-pair pass
    # that runs a backward (not the last layer's)
    require(launches["fused_attention_bwd_merge"] == (2 * depth - 1) * steps,
            "K3 merge launches per step")
    for name in ("tied_row_attention", "tied_row_attention_bwd_dq",
                 "tied_row_attention_bwd_dkv"):
        require(launches[name] == tied_calls * steps, f"{name} launches per step")
    for name in ("block_sparse_attention", "block_sparse_attention_bwd_dq",
                 "block_sparse_attention_bwd_dkv"):
        require(launches[name] == sparse_calls * steps, f"{name} launches per step")
    require(plain_calls == 0, "a plain version ran on the training path")
    require(not any(changed[:steps - 1]),
            "parameters moved before the second accumulated update (schedule(0) must be 0)")
    require(changed[steps - 1], "parameters did not move at the second accumulated update")
    log(f"{tag} parameters unchanged through step {steps - 1}, changed after step {steps}")
    del state
    torch.cuda.empty_cache()

    # (b) no accumulation, warmup 1, one repeated batch: the loss must fall
    cfg_b = Config()
    cfg_b.model.sparse_self_attn = sparse
    cfg_b.model.msa_tie_row_attn = tied
    cfg_b.train.gradient_accumulate_every = 1
    cfg_b.train.warmup_steps = 1
    batch = next(iter(SyntheticDataset(cfg_b.data, seed=cfg_b.train.seed)))
    rep = []
    loop.train(cfg_b, num_steps=20, dataset=itertools.repeat(batch),
               callbacks=[lambda i, s, m: rep.append(float(m["loss"]))])
    log(f"{tag} repeated batch, 20 steps: losses " + " ".join(f"{x:.3f}" for x in rep))
    require(bool(np.isfinite(rep).all()) and np.mean(rep[-5:]) < np.mean(rep[:5]) and
            rep[-1] < rep[0], "the loss did not fall on a repeated batch")

    # (c) a small f32 model: the same step's gradients on the card (kernels)
    # and on the CPU (plain versions); a sparse model on the grid route
    # (crop 48, a block multiple) and the flat route (crop 40, padded to 48)
    for crop in (48, 40) if sparse else (48,):
        small = Config()
        small.model.dim, small.model.depth, small.model.heads, small.model.dim_head = (
            64, 2, 4, 16)
        small.model.bfloat16 = False
        small.model.sparse_self_attn = sparse
        small.model.msa_tie_row_attn = tied
        small.data.crop_len, small.data.msa_depth, small.data.msa_len = crop, 3, 32
        small.data.batch_size = 2
        batch = next(iter(SyntheticDataset(small.data, seed=3)))
        grads = {}
        for dev in ("cpu", "cuda"):
            st = loop.init_state(small, loop.build_model(small), device=dev)
            st, _ = loop.make_train_step(st.model)(
                st, loop.batch_to_device(batch, torch.device(dev)))
            grads[dev] = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                          for n, p in st.model.named_parameters()}
        worst, worst_name = 0.0, ""
        for name, g_cpu in grads["cpu"].items():
            g_gpu = grads["cuda"][name]
            norm = float(g_cpu.norm())
            if norm == 0.0:
                require(bool((g_gpu == 0).all()), f"{name}: zero on the CPU, nonzero on the card")
                continue
            rel = float((g_gpu - g_cpu).norm()) / norm
            if rel > worst:
                worst, worst_name = rel, name
        log(f"{tag} small f32 model (crop {crop}), card vs CPU gradients: worst per-leaf "
            f"relative L2 {worst:.3e} ({worst_name}; tol {GRAD_REL_L2:g})")
        require(worst <= GRAD_REL_L2,
                "small-model gradients disagree between the card and the CPU")

    # (d) the step alone (numerics off, no callbacks, one batch on the
    # card): its rate, then one step under the profiler
    st = loop.init_state(cfg, loop.build_model(cfg))
    step = loop.make_train_step(st.model)
    data = iter(SyntheticDataset(cfg.data, seed=cfg.train.seed))
    b = loop.batch_to_device(next(data), torch.device("cuda"))
    step(st, b)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEP_REPS):
        step(st, b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEP_REPS * 1e3
    log(f"{tag} the step alone, {STEP_REPS} steps: {step_ms:.2f} ms per step, "
        f"{1e3 / step_ms:.2f} steps/s")
    kind = "sparse " if sparse else "tied " if tied else ""
    profile_device(f"one {kind}training step", lambda: step(st, b), host=True)
    return {"launches": launches, "steps": steps, "wall_s": wall,
            "step_ms": step_ms, "peak_bytes": peak}


# --------------------------------------------------------------- phase 6


# the sparse training path's pair axial pass: crop 128, 110 valid residues,
# so the pair mask leaves rows 110+ without a valid key; 2 per trunk layer
SPARSE_TRAIN_LABEL = "pair axial (128x8, 128x128, block 16)"
SPARSE_GATHER_BYTES = 2 << 30  # the plain versions run in batch slices below this


def _dense_layout(layout):
    """The (nb, nb) bool layout a BlockLayout's row lists describe."""
    import numpy as np

    lay = np.zeros((layout.num_blocks, layout.num_blocks), dtype=bool)
    for i in range(layout.num_blocks):
        lay[i, layout.rows[i, :layout.row_counts[i]]] = True
    return lay


def _reached_keys(layout, kv_mask, b):
    """(B, nb) f32: the valid keys each query block's active blocks hold."""
    import torch

    nb, bs = layout.num_blocks, layout.block_size
    lay = torch.as_tensor(_dense_layout(layout), device="cuda", dtype=torch.float32)
    if kv_mask is None:
        keys = torch.full((b, nb), float(bs), device="cuda")
    else:
        keys = kv_mask.reshape(b, nb, bs).sum(-1).float()
    return keys @ lay.T


def _shortened(layout, kv_mask, rows):
    """``layout`` without each query block's last listed block that holds a
    valid key (``rows``), or without each key block's last listed query
    block: the work of a kernel that stopped one block early."""
    import numpy as np

    from alphafold2_tpu_torch.ops.cuda.block_sparse import BlockLayout

    nb, bs = layout.num_blocks, layout.block_size
    if not rows:
        return BlockLayout(layout.rows, layout.row_counts, layout.cols,
                           np.maximum(layout.col_counts - 1, 0), bs)
    has_key = (np.ones(nb, bool) if kv_mask is None
               else kv_mask.reshape(-1, nb, bs).any(-1).any(0).cpu().numpy())
    idx, cnt = np.zeros_like(layout.rows), layout.row_counts.copy()
    for i in range(nb):
        keep = list(layout.rows[i, :cnt[i]])
        valid = [j for j, blk in enumerate(keep) if has_key[blk]]
        if valid:
            del keep[valid[-1]]
        idx[i, :len(keep)], cnt[i] = keep, len(keep)
    return BlockLayout(idx, cnt, layout.cols, layout.col_counts, bs)


def _plain_sliced(fn, tensors, layout, kv_mask, scale):
    """A sparse plain version over batch slices whose gathered blocks stay
    under SPARSE_GATHER_BYTES; outputs concatenated along the batch."""
    import torch

    b, h, n, d = tensors[0].shape
    per_row = 4 * 4 * h * layout.num_blocks * layout.rows.shape[1] * layout.block_size * d
    step = max(1, SPARSE_GATHER_BYTES // per_row)
    outs = []
    for lo in range(0, b, step):
        sl = slice(lo, lo + step)
        outs.append(fn(*(t[sl] for t in tensors), layout,
                       kv_mask[sl] if kv_mask is not None else None, scale))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def sparse_case(label, b, h, n, d, dtype, lengths, config, gen, reps=0, library=False,
                control=True):
    """K4 (with and without lse), K5a and K5b on one problem, each held
    against its plain version per tensor; rows without a valid key exactly
    0 (lse +inf, dq 0) and masked keys' dk, dv exactly 0; with ``control``
    the negative controls; two backward runs bit-identical. ``lengths``:
    each batch row's valid keys (a prefix), or None. q, k, v and dO are
    strided as the grid route lays them out. Returns result rows for K4,
    K5a and K5b."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial
    from alphafold2_tpu_torch.ops.cuda import block_sparse as bsa
    from alphafold2_tpu_torch.ops.sparse import config_layout

    layout = config_layout(config, n)
    q, k, v, do = _grad_operands(b, h, n, n, d, dtype, gen, strided=True)
    km = _prefix(n, lengths) if lengths is not None else None
    scale = d**-0.5
    out_nl = bsa.block_sparse_attention(q, k, v, layout, km, scale)
    out, lse = bsa.block_sparse_attention_lse(q, k, v, layout, km, scale)
    torch.cuda.synchronize()
    plain_fwd = lambda: _plain_sliced(bsa.block_sparse_attention_lse_reference, (q, k, v),
                                      layout, km, scale)
    ref_out, ref_lse = plain_fwd()
    _compare(label, "block_sparse_attention (no lse)", out_nl, ref_out, dtype)
    fwd = _compare(label, "block_sparse_attention", out, ref_out, dtype)
    _check_lse(label, lse, ref_lse, "block_sparse_attention")
    dsum = axial.attention_dsum(out, do)
    grad_in = (q, k, v, do, lse, dsum)
    args = (*grad_in, layout, km, scale)
    dq = bsa.block_sparse_attention_dq(*args)
    dk, dv = bsa.block_sparse_attention_dkv(*args)
    torch.cuda.synchronize()
    plain_dq = lambda: _plain_sliced(bsa.block_sparse_attention_dq_reference, grad_in,
                                     layout, km, scale)
    plain_dkv = lambda: _plain_sliced(bsa.block_sparse_attention_dkv_reference, grad_in,
                                      layout, km, scale)
    rq = plain_dq()
    rk, rv = plain_dkv()
    row_q = _compare(label, "block_sparse_attention_bwd_dq", dq, rq, dtype)
    row_k = _compare(label, "block_sparse_attention_bwd_dkv dk", dk, rk, dtype)
    row_v = _compare(label, "block_sparse_attention_bwd_dkv dv", dv, rv, dtype)
    row_kv = dict(row_k, kernel="block_sparse_attention_bwd_dkv",
                  max_abs_err=max(row_k["max_abs_err"], row_v["max_abs_err"]))
    require(torch.equal(dq, bsa.block_sparse_attention_dq(*args)),
            f"{label}: K5a not deterministic")
    dk2, dv2 = bsa.block_sparse_attention_dkv(*args)
    require(torch.equal(dk, dk2) and torch.equal(dv, dv2), f"{label}: K5b not deterministic")
    # rows whose active blocks hold no valid key, and masked keys
    reached = _reached_keys(layout, km, b)  # (B, nb)
    dead = (reached == 0).repeat_interleave(layout.block_size, 1)[:, None, :]  # (B, 1, N)
    masked = (~km if km is not None else torch.zeros((b, n), dtype=torch.bool,
                                                     device="cuda"))[:, None, :]
    require(bool((out.masked_select(dead[..., None]) == 0).all())
            and bool((out_nl.masked_select(dead[..., None]) == 0).all())
            and bool(torch.isposinf(lse.masked_select(dead)).all())
            and bool((dq.masked_select(dead[..., None]) == 0).all()),
            f"{label}: a row without a valid key is not exactly 0 (out, lse +inf, dq)")
    require(bool((dk.masked_select(masked[..., None]) == 0).all())
            and bool((dv.masked_select(masked[..., None]) == 0).all()),
            f"{label}: a masked key has a nonzero dk or dv")
    log(f"[sparse] {label} {fwd['dtype']}: two backward runs bit-identical; "
        f"{int(dead.sum())} rows without a valid key exactly 0, "
        f"{int(masked.sum())} masked keys with dk = dv = 0")
    if control:
        rows_short = _shortened(layout, km, rows=True)
        cols_short = _shortened(layout, km, rows=False)
        short, _ = bsa.block_sparse_attention_lse(q, k, v, rows_short, km, scale)
        _control(label, "block_sparse_attention", short, ref_out, dtype,
                 tile="valid active block's")
        short = bsa.block_sparse_attention_dq(*grad_in, rows_short, km, scale)
        _control(label, "block_sparse_attention_bwd_dq", short, rq, dtype,
                 tile="valid active block's")
        sk, sv = bsa.block_sparse_attention_dkv(*grad_in, cols_short, km, scale)
        _control(label, "block_sparse_attention_bwd_dkv dk", sk, rk, dtype,
                 tile="query block's")
        _control(label, "block_sparse_attention_bwd_dkv dv", sv, rv, dtype,
                 tile="query block's")
        del short, sk, sv
    # the bound counts only the (query, key) pairs of active blocks whose
    # key is valid; every input read once and every output written once
    pairs = float(h * layout.block_size * reached.sum())
    es = q.element_size()
    tensor = b * h * n * d * es
    masks = b * n if km is not None else 0
    stats = 4 * b * h * n
    lists = 4 * (layout.rows.size + layout.row_counts.size)
    lists_t = 4 * (layout.cols.size + layout.col_counts.size)
    fwd.update(_bound(4.0 * d * pairs, 4 * tensor + masks + stats + lists, dtype))
    # K5a: q.k recompute, dO.v, ds.k; K5b: q.k recompute, dO.v, p^T dO, ds^T q
    row_q.update(_bound(6.0 * d * pairs, 5 * tensor + masks + 2 * stats + lists, dtype))
    row_kv.update(_bound(8.0 * d * pairs, 6 * tensor + masks + 2 * stats + lists_t, dtype))
    log(f"[sparse] {label}: layout {layout.num_blocks}x{layout.num_blocks} blocks of "
        f"{layout.block_size}, {layout.active_pairs()} active block pairs (density "
        f"{layout.active_pairs() / layout.num_blocks**2:.3f}); {pairs:.4e} valid "
        f"(query, key) pairs")
    if reps:
        fwd["ms"] = cuda_ms(lambda: bsa.block_sparse_attention_lse(q, k, v, layout, km, scale),
                            reps)
        no_lse = cuda_ms(lambda: bsa.block_sparse_attention(q, k, v, layout, km, scale), reps)
        log(f"[sparse] {label}: K4 without lse {no_lse:.4f} ms")
        fwd["plain_ms"] = cuda_ms(plain_fwd, reps=1)
        row_q["ms"] = cuda_ms(lambda: bsa.block_sparse_attention_dq(*args), reps)
        row_kv["ms"] = cuda_ms(lambda: bsa.block_sparse_attention_dkv(*args), reps)
        row_q["plain_ms"] = cuda_ms(plain_dq, reps=1)
        row_kv["plain_ms"] = cuda_ms(plain_dkv, reps=1)
        if library:
            # the same function through SDPA: the element-level layout and
            # the key mask as one boolean mask; its forward, then its
            # backward (dq, dk and dv in one call)
            lay = torch.as_tensor(_dense_layout(layout), device="cuda")
            bs = layout.block_size
            am = lay.repeat_interleave(bs, 0).repeat_interleave(bs, 1)[None, None]
            if km is not None:
                am = am & km[:, None, None, :]
            try:
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o = F.scaled_dot_product_attention(*leaves, attn_mask=am, scale=scale)
                fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=am, scale=scale), reps)
                bwd = cuda_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                              reps)
                row_q["library_ms"] = row_kv["library_ms"] = bwd
                del o, leaves
            except (RuntimeError, torch.OutOfMemoryError) as e:
                log(f"[sparse] {label}: scaled_dot_product_attention failed: {e}")
                fwd["library_ms"] = row_q["library_ms"] = row_kv["library_ms"] = None
    del q, k, v, do, out, out_nl, lse, dq, dk, dv, rq, rk, rv, ref_out, ref_lse
    torch.cuda.empty_cache()
    return [fwd, row_q, row_kv]


def phase_sparse():
    import torch

    from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig

    gen = torch.Generator(device="cuda").manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    default = BlockSparseConfig()
    rows = []
    for dt in (bf16, f32):
        # 20 launches back to back, so the card, not the host's launch
        # latency, sets the time of the short calls
        timed = dict(reps=20 if dt == bf16 else 0, library=dt == bf16, gen=gen)
        # the training path: one pair axial pass (128 grid rows fold into
        # the batch); the pair mask leaves rows 110+ without a valid key
        rows += sparse_case(SPARSE_TRAIN_LABEL, 128, 8, 128, 64, dt,
                            [TRAIN_LEN] * TRAIN_LEN + [0] * (128 - TRAIN_LEN), default,
                            **timed)
        # a length where the layout is really sparse (density 0.388)
        rows += sparse_case("pair axial (512x8, 512x512, block 16)", 512, 8, 512, 64, dt,
                            [500] * 500 + [0] * 12, default, **timed)
        # the flat route: a 100-long axis padded to 112, padding masked
        rows += sparse_case("flat route (64x8, 100 padded to 112, block 16)", 64, 8, 112,
                            64, dt, [100] * 56 + [81] * 8, default, **timed)
        rows += sparse_case("block 128 (16x4, 512x512, d128)", 16, 4, 512, 128, dt,
                            [512] * 8 + [300] * 8, BlockSparseConfig(block_size=128),
                            **timed)
        rows += sparse_case("block 32 (8x4, 256x256, d32)", 8, 4, 256, 32, dt,
                            [256, 200, 97, 256, 33, 256, 160, 1],
                            BlockSparseConfig(block_size=32, num_random_blocks=1), **timed)
        # half the batch rows without a valid key: exactly 0 (no control:
        # rows of zeros cannot tell a short kernel from a whole one)
        rows += sparse_case("dead rows (6x2, 64x64, d16)", 6, 2, 64, 16, dt,
                            [64, 0, 40, 0, 17, 0], default, control=False, **timed)
    return rows


# --------------------------------------------------------------- phase 4


def _kabsch_rmsd(a, b):
    import torch

    from alphafold2_tpu_torch.utils.metrics import kabsch

    x = torch.as_tensor(a, dtype=torch.float64).reshape(-1, 3).T[None]
    y = torch.as_tensor(b, dtype=torch.float64).reshape(-1, 3).T[None]
    xa, yc = kabsch(x, y)
    return float(torch.sqrt(((xa - yc) ** 2).sum(1).mean()))


def phase_reference():
    """A small model, same weights, on the card (kernels) and on the CPU
    (plain versions), in float32."""
    import numpy as np
    import torch

    from alphafold2_tpu_torch.predict import init_params
    from alphafold2_tpu_torch.train.end2end import End2EndModel

    model = init_params(End2EndModel(dim=64, depth=2, heads=4, dim_head=16,
                                     max_seq_len=256, mds_iters=50,
                                     msa_tie_row_attn=True), seed=1).eval()
    rng = np.random.default_rng(0)
    b, l, m = 2, 24, 5
    seq = torch.from_numpy(rng.integers(0, 20, (b, l)))
    msa = torch.from_numpy(rng.integers(0, 20, (b, m, l)))
    mask = torch.ones((b, l), dtype=torch.bool)
    mask[1, 17:] = False
    msa_mask = mask[:, None].expand(b, m, l).contiguous()
    with torch.inference_mode():
        cpu = model(seq, msa, mask=mask, msa_mask=msa_mask)
        model.cuda()
        gpu = model(seq.cuda(), msa.cuda(), mask=mask.cuda(), msa_mask=msa_mask.cuda())
    m3 = mask.repeat_interleave(3, 1)
    pv = (m3[:, :, None] & m3[:, None, :])[..., None]
    err = float(((gpu["distogram"].cpu() - cpu["distogram"]).abs() * pv).max())
    log(f"[reference] small model distogram card vs cpu: max_abs_err={err:.3e} (tol 1e-3)")
    require(err <= 1e-3, "small model distogram disagrees between card and CPU")
    for i in range(b):
        L = int(mask[i].sum())
        r = _kabsch_rmsd(gpu["refined"][i, :L].cpu().numpy(), cpu["refined"][i, :L].numpy())
        log(f"[reference] small model refined coords, element {i}: Kabsch RMSD "
            f"{r:.3e} A (tol 0.5 A)")
        require(r <= 0.5, "small model structure disagrees between card and CPU")


def phase_se3_streamed():
    """The refiner's streamed edge attention against its dense path on the
    card, in f32, at the serving refiner's width (dim 64, 8 vector
    channels, 4 heads) and a bucket-128 batch of 2 (1792 atoms, padded to
    2048 in 1024-edge blocks): the threshold lowered so the same layer runs
    both paths; valid atoms held to the f32 bound."""
    import torch

    from alphafold2_tpu_torch.models import se3

    gen = torch.Generator(device="cuda").manual_seed(8)
    b, n = 2, 14 * 128
    layer = se3.EquivariantLayer(64, 8, 4).cuda()
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.2)
    s = torch.randn((b, n, 64), device="cuda", generator=gen)
    v = torch.randn((b, n, 8, 3), device="cuda", generator=gen)
    coords = torch.randn((b, n, 3), device="cuda", generator=gen) * 10
    mask = _prefix(n, [n, 14 * 97])
    threshold = se3.CHUNK_THRESHOLD
    require(not se3.should_chunk(b * layer.num_basis, n, n), "the dense path would stream")
    with torch.inference_mode():
        dense = layer(s, v, coords, mask=mask)
        se3.CHUNK_THRESHOLD = 1
        try:
            t0 = time.perf_counter()
            streamed = layer(s, v, coords, mask=mask)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            se3.CHUNK_THRESHOLD = threshold
    for name, a, r in zip(("scalars", "vectors"), streamed, dense):
        _compare(f"streamed vs dense, {b}x{n} atoms, valid atoms", f"SE(3) edge attention "
                 f"{name}", a[mask], r[mask], torch.float32)
    log(f"[se3] streamed layer ({b}x{n} atoms, {-(-n // 1024)}x{-(-n // 1024)} tiles), first "
        f"call: {secs * 1e3:.1f} ms")
    # one layer at a bucket-256 batch's size (4 x 3584 atoms, 4 x 4 tiles),
    # where serving streams it at the default threshold
    b, n = 4, 14 * 256
    s, v, coords = (torch.randn(shape, device="cuda", generator=gen)
                    for shape in ((b, n, 64), (b, n, 8, 3), (b, n, 3)))
    require(se3.should_chunk(b * layer.num_basis, n, n), "bucket 256 does not stream")
    with torch.inference_mode():
        ms = cuda_ms(lambda: layer(s, v, coords * 10, mask=_prefix(n, [n] * b)), reps=3)
    log(f"[se3] streamed layer at a bucket-256 batch ({b}x{n} atoms, 4x4 tiles, f32): "
        f"{ms:.2f} ms a layer")


def phase_serve():
    import numpy as np
    import torch

    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.ops.cuda.axial import (
        fused_attention, fused_attention_combine, fused_attention_reference)
    from alphafold2_tpu_torch.ops.cuda.tied_row import (
        tied_row_attention, tied_row_attention_reference)
    from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest

    from alphafold2_tpu_torch.constants import DISTOGRAM_BUCKETS
    from alphafold2_tpu_torch.models import se3

    cfg = Config()  # the default ladder: buckets 64, 96, 128, 192, 256 at batch 4
    cfg.model.msa_tie_row_attn = True
    cfg.serve.msa_depth = 5
    require(cfg.serve.buckets == (64, 96, 128, 192, 256) and cfg.serve.max_batch == 4
            and cfg.serve.mds_iters == 200, "ServeConfig's defaults changed")
    streamed = [bk for bk in cfg.serve.buckets
                if se3.should_chunk(cfg.serve.max_batch * 16, 14 * bk, 14 * bk)]
    require(streamed == [192, 256], f"buckets {streamed} stream the SE(3) edge attention")
    t0 = time.perf_counter()
    engine = ServeEngine(cfg)
    engine.warmup()
    torch.cuda.synchronize()
    log(f"[serve] engine built and warmed ({len(cfg.serve.buckets)} buckets "
        f"{cfg.serve.buckets}, refiner streamed at {streamed}) in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(7)
    alphabet = "ACDEFGHIKLMNPQRSTVWY"
    lengths = [50, 64, 77, 96, 110, 128, 129, 150, 192, 193, 230, 256]
    seqs = ["".join(rng.choice(list(alphabet), n)) for n in lengths]
    reqs = [ServeRequest(seq=s, seed=i) for i, s in enumerate(seqs)]

    for fn in (fused_attention, tied_row_attention, fused_attention_combine):
        fn.launches = 0
    fused_attention.sm90_launches = 0
    plain = (fused_attention_reference, tied_row_attention_reference)
    for fn in plain:
        fn.calls = 0
    torch.cuda.reset_peak_memory_stats()
    # the six requests of 50-128 residues that earlier runs served, then the
    # six of 129-256 that only the full ladder serves, each timed alone
    results, walls = [], []
    for part in (reqs[:6], reqs[6:]):
        t0 = time.perf_counter()
        results += engine.predict_many(part)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {"fused_attention": fused_attention.launches,
                "fused_attention_combine": fused_attention_combine.launches,
                "tied_row_attention": tied_row_attention.launches}
    require(fused_attention.sm90_launches == fused_attention.launches,
            f"{fused_attention.launches - fused_attention.sm90_launches} of K1's serving "
            f"launches did not run attention_kernel_sm90")
    plain_calls = sum(fn.calls for fn in plain)
    peak = torch.cuda.max_memory_allocated()

    for r in results:
        require(r.ok, f"request of {len(r.seq)} residues failed: {r.error}")
        require(r.atom14.shape == (len(r.seq), 14, 3), f"atom14 shape {r.atom14.shape}")
        require(bool(np.isfinite(r.atom14).all()), "non-finite atom14")
        log(f"[serve] {len(r.seq):4d} residues -> bucket {r.bucket}: "
            f"latency {r.latency_s * 1e3:.1f} ms")
    rates = []
    for what, part, wall in (("buckets 64-128", lengths[:6], walls[0]),
                             ("buckets 192-256", lengths[6:], walls[1])):
        rates.append(sum(part) / wall)
        log(f"[serve] {what}: {len(part)} requests, {sum(part)} residues in {wall:.3f} s: "
            f"{rates[-1]:.2f} residues/s")
    log(f"[serve] {len(reqs)} requests in {engine.counters['batches']} batches; peak device "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"[serve] kernel launches on the path: {launches}; plain-version calls: "
        f"{plain_calls}")
    require(all(v > 0 for v in launches.values()), "a kernel never launched on the path")
    require(plain_calls == 0, "a plain version ran on the serving path")

    alone = engine.predict_many([reqs[4]])[0]
    diff = float(np.abs(alone.atom14 - results[4].atom14).max())
    log(f"[serve] same (sequence, seed) alone vs batched: max |d atom14| = {diff:.3e} A "
        "(tol 1e-3 A)")
    require(diff <= 1e-3, "batched and solo serving disagree")
    require(all(r.distogram is None for r in results), "a distogram came back unasked")

    # serve.return_distogram: the (3L, 3L, K) logits of each request
    cfg_d = Config()
    cfg_d.model.msa_tie_row_attn = True
    cfg_d.serve.msa_depth = 5
    cfg_d.serve.return_distogram = True
    disto = ServeEngine(cfg_d, state_dict=engine.model.state_dict()).predict_many(
        [reqs[7]])[0]
    n3 = 3 * len(reqs[7].seq)
    require(disto.ok and disto.distogram is not None
            and disto.distogram.shape == (n3, n3, DISTOGRAM_BUCKETS)
            and bool(np.isfinite(disto.distogram).all()),
            f"return_distogram gave {getattr(disto.distogram, 'shape', None)}, not "
            f"{(n3, n3, DISTOGRAM_BUCKETS)}")
    log(f"[serve] return_distogram: a {len(reqs[7].seq)}-residue request came back with "
        f"finite {disto.distogram.shape} logits")

    profile_device(f"one bucket-{results[4].bucket} serving batch",
                   lambda: engine.predict_many(reqs[4:6]))
    profile_device(f"one bucket-{results[-1].bucket} serving batch (streamed refiner)",
                   lambda: engine.predict_many(reqs[9:]))
    for lo, hi in ((4, 6), (9, 12)):
        spans, total = _module_spans({"trunk and distogram head": engine.model.af2,
                                      "SE(3) refiner": engine.model.refiner},
                                     lambda: engine.predict_many(reqs[lo:hi]))
        log(f"[serve] bucket-{results[lo].bucket} batch, device timeline {total:.1f} ms: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in spans.items())
            + f", the rest (featurization, realization, copies) {total - sum(spans.values()):.1f} ms")
    return {"launches": launches, "wall_s": walls, "residues_per_s": rates,
            "peak_bytes": peak,
            "latency_ms": [round(r.latency_s * 1e3, 3) for r in results]}


def _module_spans(modules, fn):
    """Device-timeline ms from entry to exit of each named module over
    ``fn()`` (CUDA events recorded by forward hooks), and the whole
    ``fn()``'s."""
    import torch

    marks = {name: [] for name in modules}
    hooks = []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    for name, mod in modules.items():
        hooks.append(mod.register_forward_pre_hook(
            lambda m, a, name=name: marks[name].append([event()])))
        hooks.append(mod.register_forward_hook(
            lambda m, a, o, name=name: marks[name][-1].append(event())))
    try:
        start = event()
        fn()
        end = event()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return ({name: sum(a.elapsed_time(b) for a, b in spans) for name, spans in marks.items()},
            start.elapsed_time(end))


def profile_device(what, fn, host=False):
    """Device time by kernel over ``fn()`` (torch.profiler), and the share of
    its wall time the device was busy; with ``host``, also the host ops that
    took the most time of their own and the count of kernel launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []  # device-side events only: kernels and memcpy/memset
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        log(f"[profile] {what}: the profiler recorded no device time: not measured")
        return
    busy = sum(r[0] for r in rows)
    log(f"[profile] {what}: wall {wall_ms:.1f} ms (profiler on), device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%}), idle {1 - busy / wall_ms:.1%}")
    # K1 shows as attention_kernel_sm90<64> (and combine_kernel<64> where it
    # splits the key axis), K2 as attention_kernel_mma<64>, K3a/K3b as
    # dq_kernel_sm90 / dkv_kernel_sm90 (and grad_merge_kernel<64> where they
    # split), K2's backward as chunked_dq_kernel_mma / chunked_dkv_kernel_mma
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        log(f"[profile] {ms:9.2f} ms {ms / busy:6.1%} x{count:<6d} {name[:90]}")
    if not host:
        return
    cpu = [(e.self_cpu_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
           if e.device_type == DeviceType.CPU]
    launches = sum(c for _, c, k in cpu if k in ("cudaLaunchKernel", "cuLaunchKernel",
                                                  "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    log(f"[profile] {what}, host: {sum(r[0] for r in cpu):.1f} ms of host ops' own time, "
        f"{launches} kernel launches")
    for ms, count, name in sorted(cpu, reverse=True)[:10]:
        log(f"[profile] host {ms:9.2f} ms x{count:<6d} {name[:80]}")


# --------------------------------------------------------------- main


def _entry(name, source, replaces, launches, rows, weights, dtype="bfloat16"):
    """One kernel's JSON entry: ``weights`` maps a result-row label to its
    calls; times and bounds are the weighted sums over the rows of
    ``dtype``."""
    timed = [r for r in rows if r["kernel"] == name and r["label"] in weights
             and r["dtype"] == dtype]
    w = [weights[r["label"]] for r in timed]
    lib = [r.get("library_ms") for r in timed]
    ops_ms = sum(c * r["ops_ms"] for c, r in zip(w, timed))
    bytes_ms = sum(c * r["bytes_ms"] for c, r in zip(w, timed))
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
        "ms": sum(c * r["ms"] for c, r in zip(w, timed)),
        "plain_ms": sum(c * r["plain_ms"] for c, r in zip(w, timed)),
        "bound_ms": sum(c * r["bound_ms"] for c, r in zip(w, timed)),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": (None if any(x is None for x in lib)
                       else sum(c * x for c, x in zip(w, lib))),
    }


def _step_weights(backward, depth=6):
    """Calls per training step of each TRAIN_CASES label: every attention
    runs K1; the last layer's MSA<-pair update runs no backward."""
    weights = {label: depth * calls for label, (_, _, _, calls) in TRAIN_CASES.items()}
    if backward:
        weights["MSA<-pair (1x8, 320x16384)"] -= 1
    return weights


def kernel_line(rows, serve, train, tied_train, sparse_train, gate):
    """One entry per kernel. K1 sums one serving trunk layer's K1 calls at
    bucket 128 (two pair axial passes, the MSA column pass, both cross
    attentions; a call's time includes its combine pass where it splits),
    K2 its tied-row call, bf16, with the serving run's launches. K3a and
    K3b sum one training step's calls (6 layers; the last layer's MSA<-pair
    update runs no backward; a call's time includes its merge pass where it
    splits), with the training run's launches; their library_ms is SDPA's
    whole backward (dq, dk and dv in one call) on the same problems. K4 (its
    training forward, with lse), K5a and K5b sum one sparse training step's
    12 pair axial passes, with
    the sparse training run's launches; library_ms is SDPA with the
    element-level layout and key mask (its whole backward for K5a/K5b).
    K2's backward (tied_row_attention_bwd_dq and _dkv) sums one tied training
    step's six tied MSA row passes (1x5x64x8x64, R*D 320), with the tied
    training run's launches; library_ms is SDPA's whole backward on the
    folded (B, H, N, R*D) tensors. scale_rows (X's counterpart) is the gate
    phase's one launch at X's (4, 512) f32, timed alone in f32; library_ms is
    torch.mul(x, 2)."""
    serve_k1 = {"pair axial pass (1536x8, 384x384, d64)": 2,
                "MSA column pass (512x8, 5x5, d64)": 1,
                "pair<-MSA cross (4x8, 147456x640, d64)": 1,
                "MSA<-pair cross (4x8, 640x147456, d64)": 1}
    step_k3 = _step_weights(backward=True)
    step_k4 = {SPARSE_TRAIN_LABEL: 12}  # 2 pair axial passes x 6 layers
    bwd = "alphafold2_tpu_torch/csrc/fused_attention_bwd.cu"
    tied_bwd = "alphafold2_tpu_torch/csrc/tied_row_attention_bwd.cu"
    step_tied = {TIED_TRAIN_LABEL: 6}  # one tied MSA row pass a layer
    sparse_bwd = "alphafold2_tpu_torch/csrc/block_sparse_attention_bwd.cu"
    return {"kernels": [
        _entry("fused_attention", "alphafold2_tpu_torch/csrc/fused_attention.cu",
               "alphafold2_tpu/ops/pallas/axial.py:249",
               serve["launches"]["fused_attention"], rows, serve_k1),
        _entry("tied_row_attention", "alphafold2_tpu_torch/csrc/tied_row_attention.cu",
               "alphafold2_tpu/ops/pallas/tied_row.py:53",
               serve["launches"]["tied_row_attention"], rows,
               {"tied MSA rows (4x5x128x8x64, R*D=320)": 1}),
        _entry("fused_attention_bwd_dq", bwd, "alphafold2_tpu/ops/pallas/axial.py:275",
               train["launches"]["fused_attention_bwd_dq"], rows, step_k3),
        _entry("fused_attention_bwd_dkv", bwd, "alphafold2_tpu/ops/pallas/axial.py:313",
               train["launches"]["fused_attention_bwd_dkv"], rows, step_k3),
        _entry("tied_row_attention_bwd_dq", tied_bwd, "alphafold2_tpu/ops/pallas/axial.py:275",
               tied_train["launches"]["tied_row_attention_bwd_dq"], rows, step_tied),
        _entry("tied_row_attention_bwd_dkv", tied_bwd, "alphafold2_tpu/ops/pallas/axial.py:313",
               tied_train["launches"]["tied_row_attention_bwd_dkv"], rows, step_tied),
        _entry("block_sparse_attention", "alphafold2_tpu_torch/csrc/block_sparse_attention.cu",
               "alphafold2_tpu/ops/pallas/block_sparse.py:296",
               sparse_train["launches"]["block_sparse_attention"], rows, step_k4),
        _entry("block_sparse_attention_bwd_dq", sparse_bwd,
               "alphafold2_tpu/ops/pallas/block_sparse.py:339",
               sparse_train["launches"]["block_sparse_attention_bwd_dq"], rows, step_k4),
        _entry("block_sparse_attention_bwd_dkv", sparse_bwd,
               "alphafold2_tpu/ops/pallas/block_sparse.py:388",
               sparse_train["launches"]["block_sparse_attention_bwd_dkv"], rows, step_k4),
        _entry("scale_rows", "alphafold2_tpu_torch/csrc/controls/scale_rows.cu",
               "alphafold2_tpu/analysis/lowering.py:267", gate["launches"], [gate["row"]],
               {gate["row"]["label"]: 1}, dtype="float32"),
    ]}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "alphafold2_tpu_torch")):
        log("chip_smoke.py must run from a checkout that holds alphafold2_tpu_torch/")
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py drives the port on the card only")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"[device] {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    try:
        phase_build()
        gate = phase_gate()
        rows = (phase_kernels() + phase_backward() + phase_head_dims() + phase_tied()
                + phase_sparse())
        for r in rows:
            if "ms" in r:
                host = f", host {r['host_us']:.1f} us a call" if "host_us" in r else ""
                log(f"[kernels] time {r['kernel']} {r['label']} {r['dtype']}: "
                    f"kernel {r['ms']:.4f} ms{host}, plain {r['plain_ms']:.3f} ms, "
                    f"sdpa {r.get('library_ms')} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}; {r['ops']:.3e} ops, {r['bytes']:.3e} bytes; "
                    f"{r['bound_ms'] / r['ms']:.1%} of the bound)")
        for name, weights in (("fused_attention (lse)", _step_weights(backward=False)),
                              ("fused_attention_bwd_dq", _step_weights(backward=True)),
                              ("fused_attention_bwd_dkv", _step_weights(backward=True))):
            e = _entry(name, "", "", None, rows, weights)
            log(f"[backward] per training step, {name}: kernel {e['ms']:.3f} ms, plain "
                f"{e['plain_ms']:.3f} ms, sdpa {e['library_ms']} ms, bound "
                f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
        for name in ("tied_row_attention (lse)", "tied_row_attention_bwd_dq",
                     "tied_row_attention_bwd_dkv"):
            e = _entry(name, "", "", None, rows, {TIED_TRAIN_LABEL: 6})
            log(f"[tied] per tied training step, {name}: kernel {e['ms']:.4f} ms, plain "
                f"{e['plain_ms']:.3f} ms, sdpa {e['library_ms']} ms, bound "
                f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
        for name in ("block_sparse_attention", "block_sparse_attention_bwd_dq",
                     "block_sparse_attention_bwd_dkv"):
            e = _entry(name, "", "", None, rows, {SPARSE_TRAIN_LABEL: 12})
            log(f"[sparse] per sparse training step, {name}: kernel {e['ms']:.4f} ms, plain "
                f"{e['plain_ms']:.3f} ms, sdpa {e['library_ms']} ms, bound "
                f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
        phase_reference()
        phase_se3_streamed()
        serve = phase_serve()
        train = phase_train()
        tied_train = phase_train(tied=True)
        sparse_train = phase_train(sparse=True)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        log("chip_smoke: FAILED")
        return 1
    log(card)
    print(json.dumps(kernel_line(rows, serve, train, tied_train, sparse_train, gate)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
