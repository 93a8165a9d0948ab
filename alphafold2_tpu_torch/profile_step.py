"""Profile the benchmark training step and print the top ops by time.

Port of ``scripts/profile_step.py``::

    python -m alphafold2_tpu_torch.profile_step [--device cpu]

The step is ``train/loop.py``'s distogram training step at the bench
shapes, set by the same environment knobs as the JAX script:
``AF2TPU_BENCH_DIM`` (256), ``AF2TPU_BENCH_DEPTH`` (2), ``AF2TPU_BENCH_CROP``
(256), ``AF2TPU_BENCH_MSA_DEPTH`` (16), ``AF2TPU_BENCH_MSA_LEN`` (256) and
``AF2TPU_BENCH_BATCH`` (1); heads 8, dim_head 64, tied MSA rows, bf16
compute. Three warm steps run, then ``AF2TPU_PROFILE_STEPS`` (3) steps under
``torch.profiler`` (``observe/profiler.py``), whose Chrome trace goes to
``AF2TPU_TRACE_DIR`` (default: ``profile`` under the per-user cache
directory, :func:`user_cache_dir`).

:func:`summarize` sums the trace's device lanes only: kernels, memcpys and
memsets (the Chrome trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events). The host's spans cover the same wall time and would count it
again, as JAX's non-"XLA Ops" lanes would. It prints each name's µs a step
and share, so copies show as rows of their own. A trace without a device
lane (``--device cpu``) sums the CPU ops instead, with a warning: they nest,
so the total overcounts.
"""

from __future__ import annotations

import collections
import json
import os
import sys

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
CPU_CATEGORY = "cpu_op"


def user_cache_dir() -> str:
    """Per-user scratch root (mode 0700), as ``alphafold2_tpu.user_cache_dir``:
    ``~/.cache/af2tpu``, or ``/tmp/af2tpu_u<uid>`` without a home. A
    directory owned by another user is refused; one open to the group or
    others is tightened to 0700."""
    home = os.path.expanduser("~")
    root = (os.path.join(home, ".cache", "af2tpu") if home != "~"
            else "/tmp/af2tpu_u%d" % os.getuid())
    os.makedirs(root, mode=0o700, exist_ok=True)
    st = os.stat(root)
    if st.st_uid != os.getuid():
        raise RuntimeError(f"refusing cache dir {root}: owned by uid {st.st_uid}, not "
                           f"{os.getuid()}; set AF2TPU_TRACE_DIR to a directory you own")
    if st.st_mode & 0o077:
        os.chmod(root, 0o700)
    return root


def bench_config():
    """The bench step's configuration from the ``AF2TPU_BENCH_*`` knobs."""
    from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig

    e = lambda k, d: int(os.environ.get(k, d))  # noqa: E731
    crop = e("AF2TPU_BENCH_CROP", 256)
    return Config(
        model=ModelConfig(dim=e("AF2TPU_BENCH_DIM", 256), depth=e("AF2TPU_BENCH_DEPTH", 2),
                          heads=8, dim_head=64, max_seq_len=crop * 2, msa_tie_row_attn=True,
                          bfloat16=True),
        data=DataConfig(crop_len=crop, msa_depth=e("AF2TPU_BENCH_MSA_DEPTH", 16),
                        msa_len=e("AF2TPU_BENCH_MSA_LEN", 256),
                        batch_size=e("AF2TPU_BENCH_BATCH", 1), min_len_filter=crop),
        train=TrainConfig(gradient_accumulate_every=1, warmup_steps=10),
    )


def run_profiled_steps(trace_dir: str, n_steps: int = 3, device=None) -> str:
    """Three warm steps, then ``n_steps`` under the profiler; returns the
    Chrome trace's path."""
    import torch

    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.device import resolve_device
    from alphafold2_tpu_torch.observe.profiler import Profiler
    from alphafold2_tpu_torch.train.loop import (
        build_model, device_put_batch, init_state, make_train_step,
    )

    dev = resolve_device(device)
    cfg = bench_config()
    batch = next(iter(SyntheticDataset(cfg.data, seed=0)))
    state = init_state(cfg, build_model(cfg), device=dev)
    step = make_train_step(state.model)
    dev_batch = device_put_batch(batch, dev)
    for _ in range(3):  # warm: the kernels build and load on the first
        state, metrics = step(state, dev_batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prof = Profiler(trace_dir, steps=(0, n_steps - 1), device=dev)
    for i in range(n_steps):
        prof.maybe_start(i)
        state, metrics = step(state, dev_batch)
        prof.maybe_stop(i)
    return prof.path


def summarize(path: str, n_steps: int, top: int = 30, out=None) -> list:
    """Print and return the top ``(name, µs a step, share)`` rows of the
    Chrome trace at ``path``: its device events (:data:`DEVICE_CATEGORIES`)
    summed by name, or, where it has none, its CPU ops with a warning."""
    out = out or sys.stdout
    with open(path, encoding="utf-8") as fh:
        events = [ev for ev in json.load(fh).get("traceEvents", []) if ev.get("ph") == "X"]
    device = [ev for ev in events if ev.get("cat") in DEVICE_CATEGORIES]
    lane = "device"
    if not device:
        lane = CPU_CATEGORY
        print("WARNING: no device lane (kernel, gpu_memcpy, gpu_memset) in the trace: "
              "summing the CPU ops, which nest, so the total overcounts wall time",
              file=sys.stderr)
        device = [ev for ev in events if ev.get("cat") == CPU_CATEGORY]
    by_name: dict = collections.defaultdict(float)
    for ev in device:
        by_name[ev.get("name", "?")] += float(ev.get("dur", 0.0))  # microseconds
    total = sum(by_name.values())
    steps = max(n_steps, 1)
    what = "CPU op time (nested)" if lane == CPU_CATEGORY else "device op time"
    print(f"\ntrace: {path}", file=out)
    print(f"{what} total: {total / 1e3:.2f} ms over {n_steps} steps "
          f"({total / 1e3 / steps:.2f} ms/step)\n", file=out)
    print(f"{'us/step':>10}  {'%':>5}  op", file=out)
    rows = []
    for name, dur in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        share = dur / total if total else 0.0
        rows.append((name, dur / steps, share))
        print(f"{dur / steps:10.0f}  {100 * share:5.1f}  {name[:110]}", file=out)
    return rows


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Profile the bench training step (the knobs "
                                 "are AF2TPU_BENCH_* variables).")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    trace_dir = os.environ.get("AF2TPU_TRACE_DIR") or os.path.join(user_cache_dir(), "profile")
    n = int(os.environ.get("AF2TPU_PROFILE_STEPS", 3))
    summarize(run_profiled_steps(trace_dir, n, device=args.device), n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
