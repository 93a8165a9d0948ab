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

import numpy as np
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


def _pipelined_and_fleet(spec, sd, mesh, rank, requests):
    """A pipelined engine (``serve.pipeline_depth`` 2) and a fleet of two
    replicas on ``mesh``: rank 0 serves ``requests`` through each (the fleet
    in two waves, so both replicas dispatch), every other rank follows
    each; rank 0 gets their (weights, distogram, atom14) by request."""
    from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from alphafold2_tpu_torch.serve.fleet import FleetFrontend

    cfg = _serve_cfg(spec, serve={"pipeline_depth": 2})
    engine = ServeEngine(cfg, state_dict=sd, device="cpu", mesh=mesh)
    if rank != 0:
        engine.follow()
    else:
        got = engine.predict_many([ServeRequest(s, seed=i) for s, i in requests])
        out = {"pipelined": [(r.status, r.weights, r.distogram, r.atom14) for r in got],
               "pipeline_desc": engine.pipeline_desc}
        engine.close()
    fleet = FleetFrontend.build(cfg, 2, state_dict=sd, device="cpu", mesh=mesh)
    if rank != 0:
        fleet.follow()
        return None
    handles = [fleet.submit(ServeRequest(s, seed=i)) for s, i in requests]
    got = [h.result(timeout=300) for h in handles]
    out["fleet"] = [(r.status, r.weights, r.distogram, r.atom14) for r in got]
    out["fleet_dispatches"] = [c.engine.counters.get("serve.batches") for c in fleet.cells]
    out["fleet_shares_module"] = fleet.cells[1].engine.model is fleet.cells[0].engine.model
    fleet.close()
    return out


def case_serve(payload, rank, world):
    """The sharded engine on a (1, 2, 2) grid mesh: its refusals on every
    rank, then rank 0 serves (JAX's test_serve_mesh.py cases) while the
    others follow; then a pipelined engine and a two-replica fleet on the
    same mesh (``_pipelined_and_fleet``)."""
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
                                 mesh=mesh_dp))):
        try:
            make()
            out["errors"][label] = None
        except (ValueError, NotImplementedError) as e:
            out["errors"][label] = (type(e).__name__, str(e))
    engine = ServeEngine(_serve_cfg(spec, serve={"long_buckets": (24,), "long_max_batch": 1}),
                         state_dict=sd, device="cpu", mesh=mesh)
    if rank != 0:
        engine.follow()
        return _pipelined_and_fleet(spec, sd, mesh, rank, payload["requests"])
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
    out.update(_pipelined_and_fleet(spec, sd, mesh, rank, payload["requests"]))
    return out


# ------------------------------------------------------ the sharded backward


def _leaf(t):
    return torch.from_numpy(t).requires_grad_()


def _gather_grad_pair(block_grad, mesh):
    from alphafold2_tpu_torch.parallel.sharding import gather_pair

    return gather_pair(block_grad, mesh).numpy()


def case_mesh_grads(payload, rank, world):
    """Each differentiable collective against the meshless gradients of the
    same composed function; grid_axial_attention (JAX's dense pass and the
    K1 hook), ring and Ulysses, the merged MSA<-pair pass and the sharded
    sparse grid pass under autograd; the census of a backward."""
    from alphafold2_tpu_torch.ops.attention import Attention, AxialAttention
    from alphafold2_tpu_torch.ops.cuda.axial import fused_attention
    from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig
    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.parallel.grid_parallel import grid_axial_attention, make_grid_mesh
    from alphafold2_tpu_torch.parallel.seq_parallel import sequence_parallel_attention

    out = {}
    grid = make_grid_mesh(1, 2, 2) if world == 4 else make_grid_mesh(1, 1, world)
    line = sharding.make_mesh(1, world)
    c = payload["coll"]
    x, w = c["x"], c["w"]  # (8, 8) values and weights
    n = x.shape[0]
    rows = slice(rank * n // world, (rank + 1) * n // world)
    share = (rank + 1) / (world * (world + 1) / 2)  # partial weights summing to 1
    wt = torch.from_numpy(w)

    def grad_of(leaf, loss):
        loss.backward()
        return leaf.grad.numpy()

    t = _leaf(x[rows])
    y = sharding.all_to_all(t, line, "sp", 1, 0)  # whole rows, this rank's columns
    out[("all_to_all", rank)] = grad_of(t, (wt[:, rows] * y ** 2).sum())
    t = _leaf(x[rows])
    y = sharding.all_gather(t, line, "sp")
    out[("all_gather", rank)] = grad_of(t, (share * wt * y ** 2).sum())
    t = _leaf(x * share)
    y = sharding.reduce_scatter(t, line, "sp")
    out[("reduce_scatter", rank)] = grad_of(t, (wt[rows] * y ** 2).sum())
    t = _leaf(x * share)
    y = sharding.all_reduce(t, line, "sp")
    out[("all_reduce", rank)] = grad_of(t, (share * wt * y ** 2).sum())
    t = _leaf(x[rows])
    (moved,) = sharding.ring_shift([t], line, "sp")
    out[("ring_shift", rank)] = grad_of(t, (wt[rows] * moved ** 2).sum())
    # the pair grid's transpose and gather on the grid mesh
    lay = sharding.pair_layout(grid)
    px, pw = c["pair"], c["pair_w"]
    n = px.shape[1]
    t = _leaf(_block(px, lay, n))
    sharding.reset_census()
    y = sharding.transpose_pair(t, n, grid)
    (torch.from_numpy(_block(pw, lay, n)) * y ** 2).sum().backward()
    out["census_transpose"] = sharding.census()
    out["transpose_pair"] = _gather_grad_pair(t.grad, grid)
    t = _leaf(_block(px, lay, n))
    (share * torch.from_numpy(pw) * sharding.gather_pair(t, grid) ** 2).sum().backward()
    out["gather_pair"] = _gather_grad_pair(t.grad, grid)

    # grid_axial_attention, JAX's dense pass and the K1 hook
    g = payload["grid"]
    d = g["q"].shape[-1]

    def hook(q, k, v, m):
        return fused_attention(q, k, v, q_mask=m, kv_mask=m, sm_scale=d**-0.5)

    for label, mesh in (("grid", grid), ("line", line)):
        lay = sharding.pair_layout(mesh)
        n = g["q"].shape[1]
        for axis in (1, 2):
            for fn_label, fn in (("dense", None), ("hook", hook)):
                leaves = [_leaf(_block(g[k], lay, n)) for k in ("q", "k", "v")]
                blk = {k: torch.from_numpy(_block(g[k], lay, n)) for k in ("mask", "valid", "w")}
                res = grid_axial_attention(*leaves, mask=blk["mask"], mesh=mesh, attend_axis=axis,
                                           attn_fn=fn)
                torch.where(blk["valid"][..., None, None], res * blk["w"], 0.0).sum().backward()
                out[("grid_axial", label, axis, fn_label)] = [
                    _gather_grad_pair(leaf.grad, mesh) for leaf in leaves]

    # ring and Ulysses on the line mesh
    sq = payload["seq"]
    step = sq["q"].shape[2] // world
    sl = slice(rank * step, (rank + 1) * step)
    for impl in ("ring", "ulysses"):
        leaves = [_leaf(np.ascontiguousarray(sq[k][:, :, sl])) for k in ("q", "k", "v")]
        res = sequence_parallel_attention(*leaves, mask=torch.from_numpy(sq["mask"][:, sl]),
                                          mesh=line, impl=impl)
        (res ** 2).sum().backward()
        out[impl] = [sharding.all_gather(leaf.grad, line, "sp", dim=2).numpy() for leaf in leaves]

    # the merged MSA<-pair pass: queries replicated, keys this rank's block
    cr = payload["cross"]
    torch.manual_seed(0)
    attn = Attention(cr["x"].shape[-1], heads=2, dim_head=8)
    step = cr["ctx"].shape[1] // world
    sl = slice(rank * step, (rank + 1) * step)
    xq, ctx = _leaf(cr["x"]), _leaf(np.ascontiguousarray(cr["ctx"][:, sl]))
    res = attn.forward_sharded_context(xq, ctx, grid, mask=torch.from_numpy(cr["mask"]),
                                       context_mask=torch.from_numpy(cr["ctx_mask"][:, sl]))
    weight = torch.from_numpy(cr["w"]) * torch.from_numpy(cr["mask"])[..., None]
    (share * weight * res).sum().backward()
    out["cross"] = {"x": sharding.all_reduce(xq.grad, grid, "seq").numpy(),
                    "ctx": sharding.all_gather(ctx.grad, grid, "seq", dim=1).numpy(),
                    **{n_: sharding.all_reduce(p.grad, grid, "seq").numpy()
                       for n_, p in attn.named_parameters()}}
    if rank == 0:
        attn.zero_grad()
        xq, ctx = _leaf(cr["x"]), _leaf(cr["ctx"])
        res = attn(xq, context=ctx, mask=torch.from_numpy(cr["mask"]),
                   context_mask=torch.from_numpy(cr["ctx_mask"]))
        (weight * res).sum().backward()
        out["cross_meshless"] = {"x": xq.grad.numpy(), "ctx": ctx.grad.numpy(),
                                 **{n_: p.grad.numpy() for n_, p in attn.named_parameters()}}

    # the sharded block-sparse grid passes (K4's plain version) under autograd
    sp = payload["sparse"]
    cfg = BlockSparseConfig(block_size=16, num_local_blocks=1, num_global_blocks=1,
                            num_random_blocks=1)
    torch.manual_seed(0)
    axial = AxialAttention(sp["x"].shape[-1], heads=2, dim_head=8, sparse_attn=True,
                           seq_len=64, sparse_config=cfg, pair_grid=True, grid_parallel=True)
    nx = sp["x"].shape[1]
    lay = sharding.pair_layout(grid)
    xb = _leaf(_block(sp["x"], lay, nx))
    with sharding.use_mesh(grid):
        res = axial(xb, mask=torch.from_numpy(_block(sp["mask"], lay, nx)))
    (torch.from_numpy(_block(sp["w"], lay, nx)) * res).sum().backward()
    out["sparse"] = {"x": _gather_grad_pair(xb.grad, grid),
                     **{n_: sharding.all_reduce(p.grad, grid, "world").numpy()
                        for n_, p in axial.named_parameters()}}
    if rank == 0:
        axial.zero_grad()
        xf = _leaf(sp["x"])
        (torch.from_numpy(sp["w"]) * axial(xf, mask=torch.from_numpy(sp["mask"]))).sum().backward()
        out["sparse_meshless"] = {"x": xf.grad.numpy(),
                                  **{n_: p.grad.numpy() for n_, p in axial.named_parameters()}}
    # every rank's blocks of the collectives' gradients, gathered
    parts = {k: v for k, v in out.items() if isinstance(k, tuple) and len(k) == 2
             and isinstance(k[1], int)}
    gathered = [None] * world
    import torch.distributed as dist

    dist.all_gather_object(gathered, parts)
    for p_ in gathered:
        out.update(p_)
    return out


def _tiny_cfg(spec, mesh=None, **model):
    from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig

    cfg = Config(model=ModelConfig(**spec["model"]), data=DataConfig(**spec["data"]),
                 train=TrainConfig(**spec["train"]))
    for k, v in model.items():
        setattr(cfg.model, k, v)
    return cfg


def _flat_params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _same_on_every_rank(model, mesh):
    from alphafold2_tpu_torch.parallel import sharding

    flat = _flat_params(model)
    every = sharding.all_gather(flat[None], mesh, "world")
    return bool((every == flat[None]).all())


TRAIN_MESHES = {  # label: (world, mesh spec, model fields)
    "2x1": (2, "2x1", {}), "1x2": (2, "1x2", {}), "1x1x2": (2, "1x1x2", {"grid_parallel": True}),
    "ring 1x2": (2, "1x2", {"context_parallel": "ring"}),
    "ulysses 1x2": (2, "1x2", {"context_parallel": "ulysses"}),
    "remat 1x1x2": (2, "1x1x2", {"grid_parallel": True, "remat": True}),
    "2x2": (4, "2x2", {}), "1x4": (4, "1x4", {}),
    "1x2x2": (4, "1x2x2", {"grid_parallel": True}),
    "1x2x2 sparse tied": (4, "1x2x2", {"grid_parallel": True, "sparse_self_attn": True,
                                       "msa_tie_row_attn": True}),
    "ring 1x4": (4, "1x4", {"context_parallel": "ring"}),
    "ulysses 2x2": (4, "2x2", {"context_parallel": "ulysses"}),
    "scan 2x2": (4, "2x2", {"scan_layers": True, "remat": True}),
    "reversible 2x1": (2, "2x1", {"reversible": True}),
    "reversible 1x2": (2, "1x2", {"reversible": True}),
}


def case_train_mesh(payload, rank, world):
    """The distogram step on each mesh of TRAIN_MESHES at this world size,
    from the payload's parameters and batch: each step's loss, the first
    step's gradients (summed over the world), the parameters after the
    steps, and whether every rank holds the same parameters after each."""
    from alphafold2_tpu_torch.parallel.sharding import parse_mesh_spec
    from alphafold2_tpu_torch.train import loop
    from alphafold2_tpu_torch.train.optim import build_optimizer

    spec = payload["spec"]
    out = {}
    for label, (w, mesh_spec, fields) in TRAIN_MESHES.items():
        if w != world:
            continue
        cfg = _tiny_cfg(spec, **fields)
        mesh = parse_mesh_spec(mesh_spec)
        model = loop.build_model(cfg)
        key = ("sparse tied" if fields.get("sparse_self_attn") else
               "reversible" if fields.get("reversible") else "dense")
        sd = payload["state_dicts"][key + (" scan" if fields.get("scan_layers") else "")]
        model.load_state_dict(sd)
        state = loop.TrainState(model=model,
                                optimizer=build_optimizer(cfg, list(model.parameters())),
                                skipped=torch.zeros((), dtype=torch.int32))
        step = loop.make_train_step(model, mesh)
        rec = {"losses": [], "same": [], "entropy": []}
        for i in range(payload["steps"]):
            batch = loop.device_put_batch(payload["batch"], "cpu", mesh)
            state, m = step(state, batch)
            rec["losses"].append(float(m["loss"]))
            rec["entropy"].append(float(m["distogram_entropy"]))
            rec["same"].append(_same_on_every_rank(model, mesh))
            if i == 0:
                grads = loop.reduce_gradients(
                    [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in model.parameters()], mesh)
                rec["grads"] = {n: g.numpy().copy()
                                for (n, _), g in zip(model.named_parameters(), grads)}
                rec["grads_ok"] = bool(m["grads_ok"])
        rec["params"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
        rec["skipped"] = int(state.skipped)
        out[label] = rec
    # the triage step on a mesh: the world's loss and gradients
    cfg = _tiny_cfg(spec, grid_parallel=True)
    mesh = parse_mesh_spec("1x1x2" if world == 2 else "1x2x2")
    model = loop.build_model(cfg)
    model.load_state_dict(payload["state_dicts"]["dense"])
    stats = loop.make_triage_step(model, mesh)(loop.device_put_batch(payload["batch"], "cpu", mesh))
    out["triage"] = {k: v for k, v in stats.items() if k == "loss" or k.startswith("grad/")}
    return out


def case_e2e_mesh(payload, rank, world):
    """One end-to-end step on a (2, 1) and a (1, 2) mesh from the payload's
    parameters, batch and MDS start: rank 0's metrics, the gradients summed
    over the world, the parameters after the update, and whether every rank
    holds them; then the reversible engine's step meshless and on (2, 1)."""
    from alphafold2_tpu_torch.parallel.sharding import parse_mesh_spec
    from alphafold2_tpu_torch.predict import init_params
    from alphafold2_tpu_torch.train import end2end, loop
    from alphafold2_tpu_torch.train.optim import build_optimizer

    torch.set_flush_denormal(True)
    spec = payload["spec"]
    out = {}
    for mesh_spec in ("2x1", "1x2"):
        cfg = _tiny_cfg(spec)
        mesh = parse_mesh_spec(mesh_spec)
        model = end2end.End2EndModel(**payload["kw"], mds_iters=payload["mds_iters"])
        model.load_state_dict(payload["state_dict"])
        state = loop.TrainState(model=model,
                                optimizer=build_optimizer(cfg, list(model.parameters())),
                                skipped=torch.zeros((), dtype=torch.int32))
        batch = loop.batch_to_device(payload["batch"], torch.device("cpu"))
        state, m = end2end.make_end2end_step(model, mesh)(state, batch,
                                                          torch.from_numpy(payload["coords0"]))
        grads = loop.reduce_gradients([p.grad if p.grad is not None else torch.zeros_like(p)
                                       for p in model.parameters()], mesh)
        out[mesh_spec] = {"metrics": {k: float(v) for k, v in m.items()},
                          "grads": {n: g.numpy().copy()
                                    for (n, _), g in zip(model.named_parameters(), grads)},
                          "params": {n: p.detach().numpy().copy()
                                     for n, p in model.named_parameters()},
                          "same": _same_on_every_rank(model, mesh), "skipped": int(state.skipped)}
    # the reversible engine end to end: meshless and on a (2, 1) mesh, from
    # one seeded init
    cfg = _tiny_cfg(spec)
    coords0 = torch.from_numpy(payload["coords0"])
    whole = loop.batch_to_device(payload["batch"], torch.device("cpu"))  # every rank's
    sd = init_params(end2end.End2EndModel(**payload["kw"], reversible=True), 1).state_dict()
    recs = {}
    for name, mesh in (("meshless", None), ("2x1", parse_mesh_spec("2x1"))):
        model = end2end.End2EndModel(**payload["kw"], reversible=True,
                                     mds_iters=payload["mds_iters"])
        model.load_state_dict(sd)
        step = end2end.make_end2end_step(model, mesh)
        recs[name] = _step_record(model, cfg, mesh, [payload["batch"]],
                                  step_fn=lambda st, _, step=step: step(st, whole, coords0))
    out["reversible"] = recs
    return out


def case_resume(payload, rank, world):
    """Both training loops on a mesh through their entry points, with
    checkpoints: an uninterrupted run of 4 steps against 2 steps, then a
    fresh start that resumes from the step-2 checkpoint to 4; the
    parameters after each and the losses each step logged."""
    import os as _os

    from alphafold2_tpu_torch.train import end2end, loop

    spec, root = payload["spec"], payload["dir"]
    out = {}
    for loop_name, fields in (("distogram", {"grid_parallel": True}), ("end2end", {})):
        runs = {}
        for run, steps in (("whole", (4,)), ("resumed", (2, 4))):
            cfg = _tiny_cfg(spec, **fields)
            if loop_name == "end2end":
                cfg.model.max_seq_len = 3 * cfg.data.crop_len
                cfg.data.crop_len = 8
                cfg.mesh.data_parallel = 2
            else:
                cfg.mesh.grid_cols = 2
            cfg.train.checkpoint_dir = _os.path.join(root, f"{loop_name}_{run}")
            cfg.train.checkpoint_every = 2
            cfg.train.log_every = 1
            losses = []
            for n in steps:
                fn = loop.train if loop_name == "distogram" else end2end.train_end2end
                state = fn(cfg, num_steps=n, device="cpu",
                           callbacks=[lambda i, s, m: losses.append((i, float(m["loss"])))])
            runs[run] = {"losses": losses, "step": state.step,
                         "params": {k: v.detach().numpy().copy()
                                    for k, v in state.model.named_parameters()}}
        out[loop_name] = runs
    return out


MSA_ROWS_MESHES = {  # label: (world, mesh spec, model fields, reference run)
    "tied 1x2": (2, "1x2", {"msa_tie_row_attn": True}, "tied8"),
    "tied ring 1x2": (2, "1x2", {"msa_tie_row_attn": True, "context_parallel": "ring"}, "tied8"),
    "dense remat 1x2": (2, "1x2", {"remat": True}, "dense8"),
    "tied uneven 1x2": (2, "1x2", {"msa_tie_row_attn": True}, "tied5"),
    "tied 1x4": (4, "1x4", {"msa_tie_row_attn": True}, "tied8"),
    "dense 2x2": (4, "2x2", {}, "dense8"),
    "tied scan remat 2x2": (4, "2x2", {"msa_tie_row_attn": True, "scan_layers": True,
                                       "remat": True}, "tied8"),
    "tied 1x2x2": (4, "1x2x2", {"msa_tie_row_attn": True, "grid_parallel": True}, "tied8"),
    "dense 1x2x2": (4, "1x2x2", {"grid_parallel": True}, "dense8"),
    "tied uneven 1x2x2": (4, "1x2x2", {"msa_tie_row_attn": True, "grid_parallel": True},
                          "tied5"),
}


def _step_record(model, cfg, mesh, batches, step_fn=None):
    """Steps of ``model`` on ``batches`` (numpy, global): each loss, the
    first step's gradients summed over the world, the parameters after,
    and whether every rank holds them after each step."""
    from alphafold2_tpu_torch.train import loop
    from alphafold2_tpu_torch.train.optim import build_optimizer

    state = loop.TrainState(model=model, optimizer=build_optimizer(cfg, list(model.parameters())),
                            skipped=torch.zeros((), dtype=torch.int32))
    step = step_fn or loop.make_train_step(model, mesh)
    rec = {"losses": [], "same": []}
    for i, batch_np in enumerate(batches):
        state, m = step(state, loop.device_put_batch(batch_np, "cpu", mesh))
        rec["losses"].append(float(m["loss"]))
        if mesh is not None:
            rec["same"].append(_same_on_every_rank(model, mesh))
        if i == 0:
            grads = loop.reduce_gradients([p.grad if p.grad is not None else torch.zeros_like(p)
                                           for p in model.parameters()], mesh)
            rec["grads"] = {n: g.numpy().copy()
                            for (n, _), g in zip(model.named_parameters(), grads)}
            rec["grads_ok"] = bool(m["grads_ok"])
    rec["params"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    rec["skipped"] = int(state.skipped)
    return rec


def case_msa_rows(payload, rank, world):
    """``msa_row_shard``: JAX's ``tied_row_attention`` on a (1, world) mesh
    (values, the q-gradient of sum(out^2) summed over the world); the
    distogram step on each MSA_ROWS_MESHES mesh of this world size from the
    payload's parameters and batches; the PLM grid's rows on a (1, world)
    mesh and, at world 2, the end-to-end step on a (1, 2) mesh, each with
    the same step without a mesh beside it; the collectives of one tied
    step."""
    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.parallel.seq_parallel import tied_row_attention
    from alphafold2_tpu_torch.train import end2end, loop

    out = {}
    t = {k: torch.from_numpy(v) for k, v in payload["tied"].items()}
    line = sharding.make_mesh(1, world)
    q = t["q"].clone().requires_grad_()
    got = tied_row_attention(q, t["k"], t["v"], line)
    (got ** 2).sum().div(world).backward()
    out["tied_row_attention"] = (got.detach().numpy(),
                                 sharding.all_reduce(q.grad, line, "world").numpy())
    spec = payload["spec"]
    for label, (w, mesh_spec, fields, ref) in MSA_ROWS_MESHES.items():
        if w != world:
            continue
        cfg = _tiny_cfg(spec, msa_row_shard=True, **fields)
        mesh = sharding.parse_mesh_spec(mesh_spec)
        model = loop.build_model(cfg)
        model.load_state_dict(payload["state_dicts"][ref + (" scan" if fields.get("scan_layers")
                                                            else "")])
        c0 = sharding.census()
        out[label] = _step_record(model, cfg, mesh, payload["batches"][ref])
        out[label]["census"] = {k: v["count"] for k, v in
                                sharding.census_delta(c0, sharding.census()).items()}
    # the PLM grid's rows (the first N of its N x N grid, tied at R*D = N*dh)
    plm = payload["plm"]
    recs = {}
    for name, mesh in (("meshless", None), ("mesh", line)):
        cfg = _tiny_cfg(spec, msa_row_shard=True, msa_tie_row_attn=True)
        model = loop.build_model(cfg, num_embedds=plm[0]["embedds"].shape[-1])
        model.load_state_dict(payload["state_dicts"]["plm"])
        recs[name] = _step_record(model, cfg, mesh, plm)
    out["plm"] = recs
    if world == 2:
        e2e = payload["e2e"]
        cfg = _tiny_cfg(e2e, msa_row_shard=True, msa_tie_row_attn=True)
        coords0 = torch.from_numpy(e2e["coords0"])
        recs = {}
        for name, mesh in (("meshless", None), ("mesh", line)):
            model = end2end.End2EndModel(**e2e["kw"], msa_tie_row_attn=True, msa_row_shard=True)
            model.load_state_dict(payload["state_dicts"]["e2e"])
            step = end2end.make_end2end_step(model, mesh)
            recs[name] = _step_record(
                model, cfg, mesh, [e2e["batch"]],
                step_fn=lambda st, b, step=step: step(st, b, coords0))
        out["e2e"] = recs
    return out


def case_templates_mesh(payload, rank, world):
    """``Alphafold2`` with templates on a (2, 1) and a (1, 2) mesh from the
    payload's parameters and inputs: the logits gathered over the world and
    the gradients of sum(logits * w), summed over the world."""
    from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.train import loop

    inputs = {k: torch.from_numpy(v) for k, v in payload["inputs"].items()}
    w = torch.from_numpy(payload["w"])
    n = inputs["seq"].shape[1]
    out = {}
    for spec in ("2x1", "1x2"):
        mesh = sharding.parse_mesh_spec(spec)
        lay = sharding.pair_layout(mesh)
        bs = lay.batch(inputs["seq"].shape[0])
        model = Alphafold2(**payload["kw"])
        model.load_state_dict(payload["state_dict"])
        local = {k: v[bs] for k, v in inputs.items()}
        with sharding.use_mesh(mesh):
            logits = model(local.pop("seq"), local.pop("msa"), **local)
        (logits * w[bs][:, lay.rows(n), lay.cols(n)]).sum().backward()
        grads = loop.reduce_gradients([p.grad if p.grad is not None else torch.zeros_like(p)
                                       for p in model.parameters()], mesh)
        out[spec] = {"logits": sharding.gather_pair(logits.detach(), mesh, "world").numpy(),
                     "grads": {n_: g.numpy().copy()
                               for (n_, _), g in zip(model.named_parameters(), grads)}}
    return out


CASES = {"msa_rows": case_msa_rows, "templates_mesh": case_templates_mesh, "parallel": case_parallel, "serve": case_serve, "mesh_grads": case_mesh_grads,
         "train_mesh": case_train_mesh, "e2e_mesh": case_e2e_mesh, "resume": case_resume}


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
