"""Local real data on the port against the JAX package, on the CPU.

- ``NpzShardDataset``: the same shards and seed give batches bit-equal to
  JAX's (CA-only and atomic shards, a stored MSA shorter than the batch's
  rows, a chain longer than the crop, one below the length filter);
  ``load_npz_chains`` and ``shards_carry_msa`` equal JAX's; the shape
  validation and the length filter raise as JAX's do.
- The native loader (``data/native.py``, the port's ctypes binding and its
  build of ``native/dataloader.cc``): ``bucketize_distances`` against
  JAX's ``get_bucketed_distance_matrix`` and the port's own; held against
  JAX's binding on the same library (inside each test JAX's ``_LIB_PATH``
  points at the port-built library): one synthetic batch, the synthetic
  and shard loaders' streams bit-equal, deterministic across worker
  counts, ``close`` idempotent; a failed build raises with the compiler's
  output, and builds racing in threads each load a whole library.
- ``make_dataset`` routes ``npz`` and ``native`` as JAX's does (shards
  with stored MSAs to the numpy pipeline with ``MSA_FALLBACK_WARNING``);
  ``sidechainnet`` raises; the training loop closes a loader it made.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from alphafold2_tpu.config import DataConfig as JDataConfig
from alphafold2_tpu.data import native as jnative
from alphafold2_tpu.data import pipeline as jpipeline
from alphafold2_tpu.utils.structure import get_bucketed_distance_matrix as jbucketed
from alphafold2_tpu_torch import config as tconfig
from alphafold2_tpu_torch.data import native, pipeline
from alphafold2_tpu_torch.train import loop
from alphafold2_tpu_torch.utils.structure import get_bucketed_distance_matrix


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(data_dir=None, **kw):
    base = dict(crop_len=24, msa_depth=3, msa_len=16, batch_size=2, min_len_filter=8,
                max_len_filter=60, data_dir=data_dir)
    base.update(kw)
    return JDataConfig(**base), tconfig.DataConfig(**base)


def _write_shards(root, msa=True):
    """Five shards: CA-only, atomic (L, 4, 3), a long chain (cropped), one
    below the length filter and, with ``msa``, one storing 2 MSA rows."""
    rng = np.random.default_rng(0)

    def walk(n):
        return np.cumsum(rng.standard_normal((n, 3)) * 2.2, axis=0).astype(np.float32)

    shards = {
        "a_ca": dict(seq=rng.integers(0, 20, 20), coords=walk(20)),
        "b_atomic": dict(seq=rng.integers(0, 20, 30),
                         coords=np.stack([walk(30) for _ in range(4)], axis=1)),
        "c_long": dict(seq=rng.integers(0, 20, 50), coords=walk(50)),
        "d_short": dict(seq=rng.integers(0, 20, 5), coords=walk(5)),
    }
    if msa:
        shards["e_msa"] = dict(seq=rng.integers(0, 20, 18), coords=walk(18),
                               msa=rng.integers(0, 20, (2, 18)))
    root.mkdir(exist_ok=True)
    for name, arrays in shards.items():
        np.savez(root / f"{name}.npz", **arrays)
    return str(root)


def _equal_batches(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ------------------------------------------------------------ npz shards


@pytest.mark.parametrize("msa", [True, False])
def test_npz_batches_equal_jax(tmp_path, msa):
    jcfg, cfg = _cfgs(_write_shards(tmp_path / "shards", msa))
    theirs, ours = iter(jpipeline.NpzShardDataset(jcfg, seed=3)), iter(
        pipeline.NpzShardDataset(cfg, seed=3))
    for _ in range(5):  # past one epoch: the reshuffle too
        _equal_batches(next(ours), next(theirs))
    got, any_msa = pipeline.load_npz_chains(cfg, seed=4)
    want, want_msa = jpipeline.load_npz_chains(jcfg, seed=4)
    assert any_msa == want_msa == msa == pipeline.shards_carry_msa(cfg)
    assert len(got) == len(want) == 3 + msa
    for (s, b), (js, jb) in zip(got, want):
        assert np.array_equal(s, js) and np.array_equal(b, jb)


def test_npz_validation_and_length_filter_raise_as_jax(tmp_path):
    root = tmp_path / "bad"
    root.mkdir()
    for pkg in (pipeline, jpipeline):
        with pytest.raises(ValueError, match="need data.data_dir"):
            pkg._npz_paths(None)
        with pytest.raises(FileNotFoundError, match="no .npz shards"):
            pkg._npz_paths(str(root))
    np.savez(root / "coords.npz", seq=np.zeros(6, np.int32), coords=np.zeros((5, 3)))
    np.savez(root / "msa.npz", seq=np.zeros(6, np.int32), coords=np.zeros((6, 3)),
             msa=np.zeros((2, 5)))
    for name, match in (("coords", "coords shape"), ("msa", "msa shape")):
        path = str(root / f"{name}.npz")
        with pytest.raises(ValueError, match=match) as ours:
            pipeline._read_shard(path)
        with pytest.raises(ValueError, match=match) as theirs:
            jpipeline._read_shard(path)
        assert str(ours.value) == str(theirs.value)
    short = tmp_path / "short"
    short.mkdir()
    np.savez(short / "x.npz", seq=np.zeros(5, np.int32), coords=np.zeros((5, 3)))
    jcfg, cfg = _cfgs(str(short))
    for fn, c in ((pipeline.load_npz_chains, cfg), (jpipeline.load_npz_chains, jcfg)):
        with pytest.raises(ValueError, match="passes the length filter"):
            fn(c)
    for cls, c in ((pipeline.NpzShardDataset, cfg), (jpipeline.NpzShardDataset, jcfg)):
        with pytest.raises(ValueError, match="passes the length filter"):
            next(iter(cls(c)))


# ------------------------------------------------------------ native


@pytest.fixture
def jax_on_port_library(monkeypatch):
    """JAX's binding loading the library the port built."""
    monkeypatch.setattr(jnative, "_LIB_PATH", str(native.build()))
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative.available()
    return jnative


def test_bucketize_matches_the_structure_labels():
    rng = np.random.default_rng(0)
    coords = rng.normal(scale=8.0, size=(48, 3)).astype(np.float32)
    mask = np.ones(48, bool)
    mask[40:] = False
    got = native.bucketize_distances(coords, mask)
    want = np.asarray(jbucketed(coords[None], mask[None]))[0]
    port = get_bucketed_distance_matrix(torch.from_numpy(coords[None]),
                                        torch.from_numpy(mask[None]))[0].numpy()
    # float association may move a distance on a bin edge by one bucket
    assert (got != want).mean() < 1e-3 and (got != port).mean() < 1e-3
    assert (got[~mask[:, None] | ~mask[None, :]] == -100).all()


def test_synthetic_batch_and_loader_equal_jax(jax_on_port_library):
    jcfg, cfg = _cfgs()
    _equal_batches(native.synthesize_batch(cfg, seed=7), jnative.synthesize_batch(jcfg, 7))
    with native.NativeSyntheticLoader(cfg, seed=1) as ours, \
            jnative.NativeSyntheticLoader(jcfg, seed=1) as theirs:
        for _ in range(3):
            batch = next(ours)
            _equal_batches(batch, next(theirs))
            assert batch["labels"].shape == (2, 24, 24)
    labels = np.stack([native.bucketize_distances(c, m)
                       for c, m in zip(batch["coords"], batch["mask"])])
    assert np.array_equal(batch["labels"], labels)


def test_shard_loader_equals_jax_and_ignores_worker_count(tmp_path, jax_on_port_library):
    jcfg, cfg = _cfgs(_write_shards(tmp_path / "shards", msa=False))
    streams = []
    for workers in (1, 3):
        with native.NativeShardLoader(cfg, seed=2, num_workers=workers) as loader:
            assert loader.num_chains == 3
            streams.append([next(loader) for _ in range(4)])
    with jnative.NativeShardLoader(jcfg, seed=2, num_workers=2) as theirs:
        ref = [next(theirs) for _ in range(4)]
    for a, b, c in zip(*streams, ref):
        _equal_batches(a, b)
        _equal_batches(a, c)


def test_close_is_idempotent_and_stops_the_stream():
    _, cfg = _cfgs()
    loader = native.NativeSyntheticLoader(cfg, seed=0, queue_capacity=2)
    next(loader)
    assert loader.queue_size() >= 0
    loader.close()
    loader.close()
    assert loader.queue_size() == 0
    with pytest.raises(StopIteration):
        next(loader)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "dataloader.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not list((tmp_path / "build").iterdir())  # no temporary left behind


def test_racing_builds_each_load_a_whole_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].name]


# ------------------------------------------------------------ routing


def test_make_dataset_routes_npz_and_native(tmp_path):
    with_msa = _write_shards(tmp_path / "msa", msa=True)
    without = _write_shards(tmp_path / "plain", msa=False)
    route = lambda source, data_dir: pipeline.make_dataset(
        _cfgs(data_dir, source=source)[1], seed=0)
    assert isinstance(route("npz", with_msa), pipeline.NpzShardDataset)
    loader = route("native", without)
    assert isinstance(loader, native.NativeShardLoader)
    loader.close()
    loader = route("native", None)
    assert isinstance(loader, native.NativeSyntheticLoader)
    loader.close()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert isinstance(route("native", with_msa), pipeline.NpzShardDataset)
    assert any(str(w.message) == pipeline.MSA_FALLBACK_WARNING for w in seen)
    assert pipeline.MSA_FALLBACK_WARNING == jpipeline.MSA_FALLBACK_WARNING
    with pytest.raises(NotImplementedError, match="sidechainnet"):
        route("sidechainnet", None)
    with pytest.raises(ValueError, match="unknown data source"):
        route("nope", None)


def test_the_loop_closes_the_loader_it_made(monkeypatch):
    closed = []
    close = native.NativeSyntheticLoader.close
    monkeypatch.setattr(native.NativeSyntheticLoader, "close",
                        lambda self: (closed.append(self._handle is not None), close(self)))
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=32,
                                  bfloat16=False),
        data=tconfig.DataConfig(crop_len=12, msa_depth=2, msa_len=12, batch_size=1,
                                min_len_filter=8, source="native"),
        train=tconfig.TrainConfig(gradient_accumulate_every=1, warmup_steps=1,
                                  numerics="off", log_every=1))
    state = loop.train(cfg, num_steps=1, device="cpu")
    assert state.step == 1 and closed[0]  # closed while it was still open
