#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (alphafold2_tpu_torch) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. build    — compile every kernel source under alphafold2_tpu_torch/csrc
              with nvcc (sm_90a), one process per source, and load them;
1b. gate    — the port's pre-hardware analysis layer: the Hopper build gate
              (analysis/lowering.py: every case's launch plans and ptxas
              resources within sm_90's limits, f32 and bf16, and X's
              mis-tiled negative control refused by ptxas); X's valid
              counterpart (scale_rows) bitwise against 2 * x at (4, 512),
              timed beside torch.mul; the launch-level control, a
              2048-thread block the card must refuse with
              cudaErrorInvalidConfiguration; and the graph audit
              (analysis/audit.py) of every target on the card, clean apart
              from reasoned waivers, its backward seen on the autograd
              engine's device threads;
2. kernels  — hold each forward kernel (K1, K2) against its plain PyTorch
              version on the card at the serving path's shapes (f32 and
              bf16) plus ragged tails, a 5-key pass, fully masked rows and
              other head dims; time the kernel, the plain version and
              torch's scaled_dot_product_attention (a yardstick the port
              never calls);
3. backward — the same for K1's training forward (with the row logsumexp)
              and the backward kernels K3a (dq) and K3b (dk, dv) at the
              training path's shapes and the edge cases, per tensor; a
              negative control that drops each row's last key tile (dq) or
              query tile (dk, dv); two runs bit-identical; SDPA's backward
              as the yardstick;
4. serve    — a ServeEngine at full model width (dim 256, depth 6, heads 8,
              dim_head 64, bf16 compute, tied MSA rows, buckets 64/96/128,
              batch 4) serves six requests; launch counts must show both
              forward kernels on the path and no plain-version call; a
              request served alone and in a batch must agree; a small model
              must agree between the card and the CPU's plain versions;
5. train    — distogram pretraining at the same width (untied MSA rows,
              crop 128, MSA 5x64, batch 1, accumulation 16): 32 steps whose
              launch counts must show K1, K3a and K3b on every attention and
              no plain-version call, the first accumulated update at lr 0;
              20 steps on one repeated batch whose loss must fall; a small
              f32 model whose gradients must agree between the card and the
              CPU; one step under torch.profiler;
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
        if rec["status"] == "not_ported":
            log(f"[gate] {rec['case']}: not_ported ({rec['reason']})")
            continue
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
        check(summary["not_ported"] == ["tied_row_bwd_256"],
              f"not-ported cases {summary['not_ported']}")

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


def k1_case(label, b, h, nq, nk, d, dtype, q_mask=None, kv_mask=None, reps=3,
            library=False, gen=None, serving=False):
    """One fused_attention check; returns a result row. ``serving`` builds
    the operands in the serving path's strided layout and also checks that
    a kernel skipping its last key tile would fail the bound."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda.axial import (
        fused_attention, fused_attention_reference)

    dev = torch.device("cuda")
    q, k, v = _k1_operands(b, h, nq, nk, d, dtype, gen, serving)
    scale = d**-0.5
    out = fused_attention(q, k, v, q_mask=q_mask, kv_mask=kv_mask, sm_scale=scale)
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
        row["ms"] = cuda_ms(lambda: fused_attention(
            q, k, v, q_mask=q_mask, kv_mask=kv_mask, sm_scale=scale), reps)
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


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    # serving path at bucket 128, batch 4 (one dummy slot), dim_head 64:
    # per trunk layer K1 runs two pair axial passes, the MSA column pass
    # and both cross-attentions; K2 the tied MSA row pass
    lens = [128, 110, 97, 0]
    pair_valid = _prefix(384, [3 * l for l in lens])  # (4, 384) elongated tokens
    pair_mask = pair_valid[:, :, None] & pair_valid[:, None, :]  # (4, 384, 384)
    msa_valid = _prefix(128, lens)  # (4, 128) residues
    msa_mask = msa_valid[:, None, :].expand(4, 5, 128)  # (4, 5, 128)
    axial = pair_mask.reshape(4 * 384, 384)  # rows fold into the batch
    msa_col = msa_mask.transpose(1, 2).reshape(4 * 128, 5)
    pair_flat = pair_mask.reshape(4, 384 * 384)
    msa_flat = msa_mask.reshape(4, 5 * 128)
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
    out, lse = axial.fused_attention_lse(q, k, v, q_mask, kv_mask, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = axial.fused_attention_lse_reference(q, k, v, q_mask, kv_mask, scale)
    fwd = _compare(label, "fused_attention (lse)", out, ref_out, dtype)
    _check_lse(label, lse, ref_lse)
    dsum = axial.attention_dsum(out, do)
    args = (q, k, v, do, lse, dsum, q_mask, kv_mask, scale)
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
        fwd["ms"] = cuda_ms(lambda: axial.fused_attention_lse(q, k, v, q_mask, kv_mask, scale),
                            reps)
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


def phase_backward():
    import torch

    from alphafold2_tpu_torch.ops.cuda.tied_row import tied_row_attention

    gen = torch.Generator(device="cuda").manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    for dt in (bf16, f32):
        for label, (b, nq, nk, _) in TRAIN_CASES.items():
            qm, km = _train_masks(label)
            rows += k3_case(label, b, 8, nq, nk, 64, dt, qm, km, reps=3 if dt == bf16 else 0,
                            library=dt == bf16, gen=gen, strided=True)
    for dt in (f32, bf16):
        rows += k3_case("ragged tails 200x91 d32", 2, 2, 200, 91, 32, dt,
                        _prefix(200, [197, 150]), _prefix(91, [84, 91]), reps=0, gen=gen)
        rows += k3_case("Nk=5 d64", 3, 4, 70, 5, 64, dt, _prefix(70, [70, 60, 5]),
                        _prefix(5, [5, 3, 1]), reps=0, gen=gen)
        rows += k3_case("fully masked batch row d16", 2, 2, 64, 64, 16, dt,
                        _prefix(64, [64, 64]), _prefix(64, [0, 64]), reps=0, gen=gen)
        rows += k3_case("unmasked 130x130 d128", 1, 2, 130, 130, 128, dt, reps=0, gen=gen)
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
    # K2 has no backward kernel: with grad it must raise, never return an
    # output that carries no gradient
    qt = torch.randn((1, 2, 8, 2, 16), device="cuda", generator=gen, requires_grad=True)
    try:
        tied_row_attention(qt, qt, qt)
        raise PhaseError("tied_row_attention on the card returned an output under grad")
    except NotImplementedError:
        log("[backward] tied_row_attention under grad on the card raises NotImplementedError")
    return rows


# --------------------------------------------------------------- phase 5


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def phase_train(sparse=False):
    """The training checks at the slice configuration; with ``sparse``,
    model.sparse_self_attn=True (log tag ``[sparse train]``)."""
    import itertools

    import numpy as np
    import torch

    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.ops.cuda import axial, block_sparse, tied_row
    from alphafold2_tpu_torch.train import loop

    tag = "[sparse train]" if sparse else "[train]"
    plain = (axial.fused_attention_reference, axial.fused_attention_lse_reference,
             axial.fused_attention_dq_reference, axial.fused_attention_dkv_reference,
             tied_row.tied_row_attention_reference,
             block_sparse.block_sparse_attention_reference,
             block_sparse.block_sparse_attention_lse_reference,
             block_sparse.block_sparse_attention_dq_reference,
             block_sparse.block_sparse_attention_dkv_reference)
    kernels = {"fused_attention": axial.fused_attention,
               "fused_attention_bwd_dq": axial.fused_attention_dq,
               "fused_attention_bwd_dkv": axial.fused_attention_dkv,
               "block_sparse_attention": block_sparse.block_sparse_attention_lse,
               "block_sparse_attention (no lse)": block_sparse.block_sparse_attention,
               "block_sparse_attention_bwd_dq": block_sparse.block_sparse_attention_dq,
               "block_sparse_attention_bwd_dkv": block_sparse.block_sparse_attention_dkv}

    # (a) the slice configuration: 32 steps = 2 accumulated updates
    cfg = Config()
    cfg.model.sparse_self_attn = sparse
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
    for fn in plain:
        fn.calls = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = loop.train(cfg, num_steps=steps, callbacks=[watch])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
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
    # sparse model; every attention whose output reaches the loss runs the
    # backward (the last layer's MSA<-pair update does not)
    sparse_calls = 2 * depth if sparse else 0
    require(launches["fused_attention"] == (6 * depth - sparse_calls) * steps,
            "K1 launches per step")
    for name in ("fused_attention_bwd_dq", "fused_attention_bwd_dkv"):
        require(launches[name] == (6 * depth - 1 - sparse_calls) * steps,
                f"{name} launches per step")
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
    profile_device(f"one {'sparse ' if sparse else ''}training step", lambda: step(st, b),
                   host=True)
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


def phase_serve():
    import numpy as np
    import torch

    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.ops.cuda.axial import (
        fused_attention, fused_attention_reference)
    from alphafold2_tpu_torch.ops.cuda.tied_row import (
        tied_row_attention, tied_row_attention_reference)
    from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest

    cfg = Config()
    cfg.model.msa_tie_row_attn = True
    cfg.serve.buckets = (64, 96, 128)
    cfg.serve.max_batch = 4
    cfg.serve.msa_depth = 5
    cfg.serve.mds_iters = 200
    t0 = time.perf_counter()
    engine = ServeEngine(cfg)
    engine.warmup()
    torch.cuda.synchronize()
    log(f"[serve] engine built and warmed (3 buckets) in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(7)
    alphabet = "ACDEFGHIKLMNPQRSTVWY"
    lengths = [50, 64, 77, 96, 110, 128]
    seqs = ["".join(rng.choice(list(alphabet), n)) for n in lengths]
    reqs = [ServeRequest(seq=s, seed=i) for i, s in enumerate(seqs)]

    for fn in (fused_attention, tied_row_attention):
        fn.launches = 0
    for fn in (fused_attention_reference, tied_row_attention_reference):
        fn.calls = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = engine.predict_many(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_attention": fused_attention.launches,
                "tied_row_attention": tied_row_attention.launches}
    plain_calls = fused_attention_reference.calls + tied_row_attention_reference.calls
    peak = torch.cuda.max_memory_allocated()

    for r in results:
        require(r.ok, f"request of {len(r.seq)} residues failed: {r.error}")
        require(r.atom14.shape == (len(r.seq), 14, 3), f"atom14 shape {r.atom14.shape}")
        require(bool(np.isfinite(r.atom14).all()), "non-finite atom14")
        log(f"[serve] {len(r.seq):4d} residues -> bucket {r.bucket}: "
            f"latency {r.latency_s * 1e3:.1f} ms")
    residues = sum(lengths)
    log(f"[serve] {len(reqs)} requests, {residues} residues, {engine.counters['batches']} "
        f"batches in {wall:.3f} s: {residues / wall:.2f} residues/s; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    log(f"[serve] kernel launches on the path: {launches}; plain-version calls: "
        f"{plain_calls}")
    require(all(v > 0 for v in launches.values()), "a kernel never launched on the path")
    require(plain_calls == 0, "a plain version ran on the serving path")

    alone = engine.predict_many([reqs[4]])[0]
    diff = float(np.abs(alone.atom14 - results[4].atom14).max())
    log(f"[serve] same (sequence, seed) alone vs batched: max |d atom14| = {diff:.3e} A "
        "(tol 1e-3 A)")
    require(diff <= 1e-3, "batched and solo serving disagree")
    profile_device(f"one bucket-{results[4].bucket} serving batch",
                   lambda: engine.predict_many(reqs[4:]))
    return {"launches": launches, "wall_s": wall, "residues_per_s": residues / wall,
            "peak_bytes": peak,
            "latency_ms": [round(r.latency_s * 1e3, 3) for r in results]}


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
    # K1 and K2 instantiate one kernel template: at head dim 64 both show
    # as attention_kernel_mma<64>; K3a/K3b as dq_kernel_mma / dkv_kernel_mma
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


def kernel_line(rows, serve, train, sparse_train, gate):
    """One entry per kernel. K1 sums one serving trunk layer's K1 calls at
    bucket 128 (two pair axial passes, the MSA column pass, both cross
    attentions), K2 its tied-row call, bf16, with the serving run's
    launches. K3a and K3b sum one training step's calls (6 layers; the last
    layer's MSA<-pair update runs no backward), with the training run's
    launches; their library_ms is SDPA's whole backward (dq, dk and dv in
    one call) on the same problems. K4 (its training forward, with lse),
    K5a and K5b sum one sparse training step's 12 pair axial passes, with
    the sparse training run's launches; library_ms is SDPA with the
    element-level layout and key mask (its whole backward for K5a/K5b).
    scale_rows (X's counterpart) is the gate phase's one launch at X's
    (4, 512) f32, timed alone in f32; library_ms is torch.mul(x, 2)."""
    serve_k1 = {"pair axial pass (1536x8, 384x384, d64)": 2,
                "MSA column pass (512x8, 5x5, d64)": 1,
                "pair<-MSA cross (4x8, 147456x640, d64)": 1,
                "MSA<-pair cross (4x8, 640x147456, d64)": 1}
    step_k3 = _step_weights(backward=True)
    step_k4 = {SPARSE_TRAIN_LABEL: 12}  # 2 pair axial passes x 6 layers
    bwd = "alphafold2_tpu_torch/csrc/fused_attention_bwd.cu"
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
        rows = phase_kernels() + phase_backward() + phase_sparse()
        for r in rows:
            if "ms" in r:
                log(f"[kernels] time {r['kernel']} {r['label']} {r['dtype']}: "
                    f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
                    f"sdpa {r.get('library_ms')} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}; {r['ops']:.3e} ops, {r['bytes']:.3e} bytes)")
        for name, weights in (("fused_attention (lse)", _step_weights(backward=False)),
                              ("fused_attention_bwd_dq", _step_weights(backward=True)),
                              ("fused_attention_bwd_dkv", _step_weights(backward=True))):
            e = _entry(name, "", "", None, rows, weights)
            log(f"[backward] per training step, {name}: kernel {e['ms']:.3f} ms, plain "
                f"{e['plain_ms']:.3f} ms, sdpa {e['library_ms']} ms, bound "
                f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
        for name in ("block_sparse_attention", "block_sparse_attention_bwd_dq",
                     "block_sparse_attention_bwd_dkv"):
            e = _entry(name, "", "", None, rows, {SPARSE_TRAIN_LABEL: 12})
            log(f"[sparse] per sparse training step, {name}: kernel {e['ms']:.4f} ms, plain "
                f"{e['plain_ms']:.3f} ms, sdpa {e['library_ms']} ms, bound "
                f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
        phase_reference()
        serve = phase_serve()
        train = phase_train()
        sparse_train = phase_train(sparse=True)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        log("chip_smoke: FAILED")
        return 1
    log(card)
    print(json.dumps(kernel_line(rows, serve, train, sparse_train, gate)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
