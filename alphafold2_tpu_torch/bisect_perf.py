"""Microbenchmark the trunk's hot modules at the bench shapes: each one's
forward plus backward time and achieved FLOP/s, to find where a training
step's time goes.

Port of ``scripts/bisect_perf.py``::

    python -m alphafold2_tpu_torch.bisect_perf [--device cpu]

Shapes: the pair grid (1, CROP, CROP, DIM) and the MSA (1, MSA_DEPTH,
MSA_LEN, DIM) in bf16, from ``AF2TPU_BENCH_CROP`` (256),
``AF2TPU_BENCH_MSA_DEPTH`` (16), ``AF2TPU_BENCH_MSA_LEN`` (256) and
``AF2TPU_BENCH_DIM`` (256); heads 8, dim_head 64. The modules are one trunk
layer's: the pair ``AxialAttention``, the tied MSA ``AxialAttention``, both
cross ``Attention`` passes and both ``FeedForward``\\ s. Each runs
``sum(out.float() ** 2)`` and its backward once warm, then ITERS times
between CUDA events (the host clock on the CPU); its flops are one counted
call's (``observe/flops.py count_call``, the kernels' analytic counts
included). The last line sums the micro-times, one of each module.

JAX's A/B (``AF2TPU_BENCH_AB``, default on) runs its pair module with and
without flash and on its flat route. The port's A/B is the kernel policy
(``ops/kernels.py use_kernel_policy``): the whole table under the hand
kernels, then under ``axial=stock,flash=on`` (PyTorch's
``scaled_dot_product_attention``) and under the plain versions. The flat
route is a JAX debug escape with no counterpart here.
"""

from __future__ import annotations

import os
import time

ITERS = 10
HEADS, DIM_HEAD = 8, 64
POLICIES = {  # label: the kernel policy's spec
    "hand kernels": "",
    "axial=stock,flash=on": "axial=stock,flash=on",
    "plain": "axial=dense,flash=off,tied_row=dense,block_sparse=jnp",
}


def shapes() -> dict:
    e = lambda k, d: int(os.environ.get(k, d))  # noqa: E731
    return {"crop": e("AF2TPU_BENCH_CROP", 256), "msa_depth": e("AF2TPU_BENCH_MSA_DEPTH", 16),
            "msa_len": e("AF2TPU_BENCH_MSA_LEN", 256), "dim": e("AF2TPU_BENCH_DIM", 256)}


def hot_modules(device, dtype=None) -> list:
    """``(name, module, args, kwargs)`` of each hot module at the bench
    shapes, its inputs seeded and on ``device`` (bf16 by default), its
    parameters f32 from the port's seeded init."""
    import torch

    from alphafold2_tpu_torch.ops.attention import Attention, AxialAttention, FeedForward
    from alphafold2_tpu_torch.predict import init_params

    dtype = dtype or torch.bfloat16
    s = shapes()
    crop, dim = s["crop"], s["dim"]
    gen = torch.Generator().manual_seed(1)
    pair = torch.randn((1, crop, crop, dim), generator=gen).to(device, dtype)
    msa = torch.randn((1, s["msa_depth"], s["msa_len"], dim), generator=gen).to(device, dtype)
    pair_flat, msa_flat = pair.reshape(1, -1, dim), msa.reshape(1, -1, dim)
    attn = lambda: Attention(dim, HEADS, DIM_HEAD)  # noqa: E731
    mods = [
        ("pair AxialAttention (grid)", AxialAttention(dim, HEADS, DIM_HEAD, pair_grid=True),
         (pair,), {}),
        ("msa AxialAttention tied", AxialAttention(dim, HEADS, DIM_HEAD, tie_row_attn=True),
         (msa,), {}),
        ("cross pair<-msa", attn(), (pair_flat,), {"context": msa_flat}),
        ("cross msa<-pair", attn(), (msa_flat,), {"context": pair_flat}),
        ("pair FeedForward", FeedForward(dim), (pair,), {}),
        ("msa FeedForward", FeedForward(dim), (msa,), {}),
    ]
    return [(name, init_params(m, i).to(device), args, kw)
            for i, (name, m, args, kw) in enumerate(mods)]


def _fwd_bwd(module, args, kwargs):
    for p in module.parameters():
        p.grad = None
    loss = module(*args, **kwargs).float().pow(2).sum()
    loss.backward()
    return loss


def timed(name, module, args, kwargs, device) -> dict:
    """One module's forward plus backward: ms a call over ITERS after a warm
    call, and one counted call's flops."""
    import torch

    from alphafold2_tpu_torch.observe.flops import count_call

    cuda = torch.device(device).type == "cuda"
    _fwd_bwd(module, args, kwargs)  # warm: the kernels build and load
    flops = count_call(_fwd_bwd, module, args, kwargs, device=device)[1].flops
    if cuda:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(ITERS):
            _fwd_bwd(module, args, kwargs)
        stop.record()
        stop.synchronize()
        ms = start.elapsed_time(stop) / ITERS
    else:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            _fwd_bwd(module, args, kwargs)
        ms = (time.perf_counter() - t0) * 1e3 / ITERS
    print(f"{name:42s} {ms:8.2f} ms  {flops / ms / 1e9:6.1f} TF/s  ({flops / 1e9:.1f} GFLOP)",
          flush=True)
    return {"name": name, "ms": ms, "flops": flops}


def measure(device=None) -> dict:
    """The table under each kernel policy (``POLICIES``; only the hand
    kernels with ``AF2TPU_BENCH_AB=0``): ``{policy: {"rows": [...],
    "total_ms": sum}}``."""
    import torch

    from alphafold2_tpu_torch.device import resolve_device
    from alphafold2_tpu_torch.ops.kernels import parse_policy, use_kernel_policy

    dev = resolve_device(device)
    ab = os.environ.get("AF2TPU_BENCH_AB", "1") == "1"
    policies = list(POLICIES) if ab else ["hand kernels"]
    s = shapes()
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (host clock)"
    print(f"crop={s['crop']} msa={s['msa_depth']}x{s['msa_len']} dim={s['dim']} "
          f"device={kind}", flush=True)
    modules = hot_modules(dev)
    out = {}
    for label in policies:
        print(f"\nkernel policy: {label} ({POLICIES[label] or 'auto'})", flush=True)
        with use_kernel_policy(parse_policy(POLICIES[label])):
            rows = [timed(name, m, args, kw, dev) for name, m, args, kw in modules]
        total = sum(r["ms"] for r in rows)
        print(f"sum of micro-times (one of each): {total:.2f} ms", flush=True)
        out[label] = {"rows": rows, "total_ms": total}
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Time the trunk's hot modules (the knobs are "
                                 "AF2TPU_BENCH_* variables).")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    measure(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
