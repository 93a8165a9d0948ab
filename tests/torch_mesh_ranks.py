"""Rank bodies of the port's multi-rank CPU tests: gloo process groups of 2
and 4 ranks, each rank one process that imports no JAX.

``run_ranks(case, world, tmp, payload)`` writes ``payload`` under ``tmp``,
starts ``world`` processes of this file (``python tests/torch_mesh_ranks.py
<case> <rank> <world> <dir>``, a file store under ``tmp``: no TCP port, so
parallel test workers cannot collide), waits, and returns what rank 0 of
``case`` saved. Each case runs many checks in one spawn and returns arrays;
the test files compare them with the JAX package's on its CPU meshes.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def run_ranks(case: str, world: int, tmp, payload=None, timeout: float = 300.0):
    tmp = str(tmp)
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("AF2TPU_AUDIT_DROP_SHARD_PAIR", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r),
                               str(world), tmp], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{case} rank {r} of {world} exited {p.returncode}:\n{log[-4000:]}")
    return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)


# ------------------------------------------------------------------ cases


def _block(t, lay, n):  # this rank's (b, rows, cols, ...) block of a global grid
    return t[:, lay.rows(n), lay.cols(n)]


def case_parallel(payload, rank, world):
    """grid_axial_attention on a grid and a 1D mesh (both axes, with and
    without a mask, JAX's dense pass and the K1 hook), ring and Ulysses on
    the 1D mesh, the merged MSA<-pair pass, the mesh strings, the census."""
    from alphafold2_tpu_torch.ops.attention import Attention
    from alphafold2_tpu_torch.ops.cuda.axial import fused_attention
    from alphafold2_tpu_torch.parallel.grid_parallel import grid_axial_attention, make_grid_mesh
    from alphafold2_tpu_torch.parallel.seq_parallel import sequence_parallel_attention
    from alphafold2_tpu_torch.parallel.sharding import (
        all_gather, census, describe_mesh, gather_pair, make_mesh, pair_layout,
        parse_mesh_spec, reset_census,
    )

    out = {}
    grid = make_grid_mesh(1, 2, 2) if world == 4 else make_grid_mesh(1, 1, world)
    line = make_mesh(1, world)
    g = {k: torch.from_numpy(v) for k, v in payload["grid"].items()}
    n = g["q"].shape[1]
    d = g["q"].shape[-1]

    def hook(q, k, v, m):
        return fused_attention(q, k, v, q_mask=m, kv_mask=m, sm_scale=d**-0.5)

    for label, mesh in (("grid", grid), ("line", line)):
        lay = pair_layout(mesh)
        for axis in (1, 2):
            for masked in (False, True):
                m = _block(g["mask"], lay, n) if masked else None
                args = [_block(g[x], lay, n) for x in ("q", "k", "v")]
                if label == "grid" and axis == 2 and masked:
                    reset_census()
                local = grid_axial_attention(*args, mask=m, mesh=mesh, attend_axis=axis)
                if label == "grid" and axis == 2 and masked:
                    out["census_row_pass"] = census()
                out[(label, axis, masked)] = gather_pair(local, mesh).numpy()
                local = grid_axial_attention(*args, mask=m, mesh=mesh, attend_axis=axis,
                                             attn_fn=hook)
                out[(label, axis, masked, "hook")] = gather_pair(local, mesh).numpy()
    if rank == 0:
        for axis in (1, 2):
            for masked in (False, True):
                full = grid_axial_attention(g["q"], g["k"], g["v"],
                                            mask=g["mask"] if masked else None,
                                            attend_axis=axis, attn_fn=hook)
                out[("meshless", axis, masked, "hook")] = full.numpy()

    s = {k: torch.from_numpy(v) for k, v in payload["seq"].items()}
    step = s["q"].shape[2] // world
    sl = slice(rank * step, (rank + 1) * step)
    for impl in ("ring", "ulysses"):
        local = sequence_parallel_attention(s["q"][:, :, sl], s["k"][:, :, sl], s["v"][:, :, sl],
                                            mask=s["mask"][:, sl], mesh=line, impl=impl)
        out[impl] = all_gather(local, line, "sp", dim=2).numpy()

    c = {k: torch.from_numpy(v) for k, v in payload["cross"].items()}
    torch.manual_seed(0)
    attn = Attention(c["x"].shape[-1], heads=2, dim_head=8).eval()
    step = c["ctx"].shape[1] // world
    sl = slice(rank * step, (rank + 1) * step)
    with torch.no_grad():
        out["cross"] = attn.forward_sharded_context(c["x"], c["ctx"][:, sl], grid,
                                                    mask=c["mask"],
                                                    context_mask=c["ctx_mask"][:, sl]).numpy()
        out["cross_meshless"] = attn(c["x"], context=c["ctx"], mask=c["mask"],
                                     context_mask=c["ctx_mask"]).numpy()
    from alphafold2_tpu_torch.ops.attention import AxialAttention
    from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig
    from alphafold2_tpu_torch.parallel.sharding import use_mesh

    sp = {k: torch.from_numpy(v) for k, v in payload["sparse"].items()}
    cfg = BlockSparseConfig(block_size=16, num_local_blocks=1, num_global_blocks=1,
                            num_random_blocks=1)
    torch.manual_seed(0)
    axial = AxialAttention(sp["x"].shape[-1], heads=2, dim_head=8, sparse_attn=True,
                           seq_len=64, sparse_config=cfg, pair_grid=True,
                           grid_parallel=True).eval()
    nx = sp["x"].shape[1]
    with torch.no_grad():
        for label, mesh in (("grid", grid), ("line", line)):
            lay = pair_layout(mesh)
            with use_mesh(mesh):
                local = axial(_block(sp["x"], lay, nx), mask=_block(sp["mask"], lay, nx))
            out[("sparse", label)] = gather_pair(local, mesh).numpy()
        out["sparse_meshless"] = axial(sp["x"], mask=sp["mask"]).numpy()
        unaligned = AxialAttention(sp["x"].shape[-1], heads=2, dim_head=8, sparse_attn=True,
                                   seq_len=64, sparse_config=BlockSparseConfig(block_size=32),
                                   pair_grid=True, grid_parallel=True)
        try:
            with use_mesh(grid):
                unaligned(_block(sp["x"][:, :48, :48], pair_layout(grid), 48))
            out["sparse_unaligned"] = None
        except ValueError as e:
            out["sparse_unaligned"] = str(e)
    from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
    from alphafold2_tpu_torch.predict import init_params

    md = {k: torch.from_numpy(v) for k, v in payload["model"].items()}
    meshes = [("grid", grid, None), ("line", line, None), ("ring", line, "ring"),
              ("ulysses", line, "ulysses"), ("dp", make_grid_mesh(2, 1, world // 2), None)]
    with torch.no_grad():
        for label, mesh, cp in meshes:
            model = init_params(Alphafold2(dim=16, depth=1, heads=4, dim_head=8,
                                           max_seq_len=64, grid_parallel=True,
                                           context_parallel=cp), seed=0).eval()
            if rank == 0 and "model_meshless" not in out:
                out["model_meshless"] = model(md["seq"], md["msa"], mask=md["mask"],
                                              msa_mask=md["msa_mask"]).numpy()
            bs = pair_layout(mesh).batch(md["seq"].shape[0])
            with use_mesh(mesh):
                local = model(md["seq"][bs], md["msa"][bs], mask=md["mask"][bs],
                              msa_mask=md["msa_mask"][bs])
            out[("model", label)] = gather_pair(local, mesh).numpy()
    out["describe"] = (describe_mesh(grid), describe_mesh(line),
                       describe_mesh(parse_mesh_spec(f"1x{world}")),
                       describe_mesh(parse_mesh_spec("1x2x2" if world == 4 else f"1x1x{world}")),
                       describe_mesh(None), parse_mesh_spec(""))
    return out


def _serve_cfg(spec, **kw):
    import dataclasses

    from alphafold2_tpu_torch.config import Config

    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, **spec["model"])
    cfg.data.msa_depth = spec["msa_depth"]
    serve = dict(spec["serve"])
    serve.update(kw.pop("serve", {}))
    cfg.serve = dataclasses.replace(cfg.serve, **serve)
    for k, v in kw.items():
        setattr(cfg.model, k, v)
    return cfg


def case_serve(payload, rank, world):
    """The sharded engine on a (1, 2, 2) grid mesh: its refusals on every
    rank, then rank 0 serves (JAX's test_serve_mesh.py cases) while the
    others follow."""
    from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh
    from alphafold2_tpu_torch.serve.cache import result_key
    from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from alphafold2_tpu_torch.serve.scheduler import AsyncServeFrontend

    spec, sd = payload["spec"], payload["state_dict"]
    mesh = make_grid_mesh(1, 2, 2)
    mesh_dp = make_grid_mesh(2, 1, 2)
    out = {"errors": {}}
    for label, make in (
            ("grid_needs_grid_parallel",
             lambda: ServeEngine(_serve_cfg(spec, grid_parallel=False), device="cpu",
                                 mesh=mesh)),
            ("dp_divides_batch",
             lambda: ServeEngine(_serve_cfg(spec, serve={"max_batch": 3}), device="cpu",
                                 mesh=mesh_dp)),
            ("pipelined_on_mesh",
             lambda: ServeEngine(_serve_cfg(spec, serve={"pipeline_depth": 2}), device="cpu",
                                 mesh=mesh))):
        try:
            make()
            out["errors"][label] = None
        except (ValueError, NotImplementedError) as e:
            out["errors"][label] = (type(e).__name__, str(e))
    engine = ServeEngine(_serve_cfg(spec, serve={"long_buckets": (24,), "long_max_batch": 1}),
                         state_dict=sd, device="cpu", mesh=mesh)
    if rank != 0:
        engine.follow()
        return None
    out["ladder"] = (engine.buckets, engine.long_buckets, engine.batch_for(8),
                     engine.batch_for(24), engine.mesh_desc)
    for seq, seed in payload["requests"]:
        r = engine.predict_many([ServeRequest(seq, seed=seed)])[0]
        out[("single", seq)] = (r.status, r.bucket, r.weights, r.distogram, r.atom14)
    req = ServeRequest("ACDEFG", seed=11)
    solo = engine.predict_many([req])[0]
    batched = engine.predict_many([ServeRequest("MKVLIT", seed=5), req])[1]
    out["padded"] = (solo.weights, solo.atom14, batched.weights, batched.distogram,
                     batched.atom14)
    long = engine.predict_many([ServeRequest("ACDEFGHKLMNPQRSTVWYA", seed=3)])[0]
    out["long"] = (long.status, long.bucket, long.atom14, long.weights, long.distogram)
    out["keys"] = list(engine._executables)
    out["records"] = list(engine.compile_records)
    fe = AsyncServeFrontend(engine, start=False)
    h_long = fe.submit(ServeRequest("ACDEFGHKLMNPQRSTVWYA", seed=9))
    h_dup = fe.submit(ServeRequest("ACDEFGHKLMNPQRSTVWYA", seed=9))
    fe.pump()
    r1, r2 = h_long.result(timeout=120), h_dup.result(timeout=120)
    out["frontend"] = (r1.status, r1.bucket, r2.status, r2.cache_hit,
                       fe.cache.peek(result_key("ACDEFGHKLMNPQRSTVWYA", 9, engine.mesh_desc))
                       is not None)
    fe.close()
    engine.close()
    return out


CASES = {"parallel": case_parallel, "serve": case_serve}


def main(case, rank, world, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world)
    try:
        payload = torch.load(os.path.join(tmp, "payload.pt"), weights_only=False)
        out = CASES[case](payload, rank, world)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
