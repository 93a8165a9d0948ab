"""The native (C++) data loader: the port's own ctypes binding.

Counterpart of ``alphafold2_tpu/data/native.py`` over the repository's
``native/dataloader.cc``: host threads synthesize or crop fixed-shape
batches and bucketize their distogram labels behind a bounded prefetch
queue, so a training step never waits on the Python interpreter (ctypes
releases the GIL during the blocking ``next`` call).

The library is built on first use with ``g++ -O3 -std=c++17 -fPIC
-pthread -shared`` (the flags of ``native/Makefile``) into
``build/native/libaf2data-<hash>.so`` at the repository's root, the name
keyed by a hash of the source, as ``ops/cuda/build.py`` keys the kernels;
nothing is written under ``native/``. The compiler writes a temporary name
that is then renamed into place, so processes that build at once each
load a whole library. A failed build raises with the compiler's output:
the port always builds the library, so JAX's "library absent, fall back to
numpy" case does not exist here.

- :func:`bucketize_distances`: the native twin of
  ``utils.structure.get_bucketed_distance_matrix``;
- :func:`synthesize_batch`: one synthetic batch, deterministic by seed;
- :class:`NativeSyntheticLoader` / :class:`NativeShardLoader`: prefetching
  iterators of batch dicts with precomputed ``labels``, deterministic in
  (seed, batch index) for any worker count; ``close`` (idempotent), the
  context manager and ``__del__`` stop the worker threads.

Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.config import DataConfig

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "dataloader.cc"
BUILD_DIR = REPO_DIR / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
BUILD_TIMEOUT_S = 300

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libaf2data-{digest}.so"


def build() -> Path:
    """Build the library unless the current source's is there; returns its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed ({cxx}, exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        i, f = ctypes.c_int, ctypes.c_float
        lib.af2_bucketize_distances.argtypes = [f32p, u8p, i, i, f, f, ctypes.c_int32, i32p]
        lib.af2_bucketize_distances.restype = None
        lib.af2_synthesize_batch.argtypes = [i] * 5 + [ctypes.c_uint64, i32p, i32p, u8p, u8p,
                                                       f32p, f32p]
        lib.af2_synthesize_batch.restype = None
        lib.af2_loader_create.argtypes = [i] * 5 + [ctypes.c_uint64, i, i, i, f, f,
                                                    ctypes.c_int32]
        lib.af2_loader_create.restype = ctypes.c_void_p
        lib.af2_real_loader_create.argtypes = [i, i32p, i32p, f32p, i, i, i, i,
                                               ctypes.c_double, ctypes.c_uint64, i, i, i, f,
                                               f, ctypes.c_int32]
        lib.af2_real_loader_create.restype = ctypes.c_void_p
        lib.af2_loader_next.argtypes = [ctypes.c_void_p, i32p, i32p, u8p, u8p, f32p, f32p,
                                        i32p]
        lib.af2_loader_next.restype = ctypes.c_int
        lib.af2_loader_queue_size.argtypes = [ctypes.c_void_p]
        lib.af2_loader_queue_size.restype = ctypes.c_int
        lib.af2_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.af2_loader_destroy.restype = None
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def bucketize_distances(
    coords: np.ndarray,
    mask: np.ndarray,
    num_buckets: int = constants.DISTOGRAM_BUCKETS,
    min_dist: float = constants.DISTOGRAM_MIN_DIST,
    max_dist: float = constants.DISTOGRAM_MAX_DIST,
    ignore_index: int = -100,
) -> np.ndarray:
    """(N, 3) float32 coords + (N,) bool mask -> (N, N) int32 labels."""
    lib = _load()
    coords = np.ascontiguousarray(coords, np.float32)
    mask_u8 = np.ascontiguousarray(mask, np.uint8)
    n = coords.shape[0]
    out = np.empty((n, n), np.int32)
    lib.af2_bucketize_distances(_ptr(coords, ctypes.c_float), _ptr(mask_u8, ctypes.c_uint8),
                                n, num_buckets, min_dist, max_dist, ignore_index,
                                _ptr(out, ctypes.c_int32))
    return out


def _alloc(B, L, M, NM, labels: bool) -> dict:
    out = {
        "seq": np.empty((B, L), np.int32),
        "msa": np.empty((B, M, NM), np.int32),
        "_mask_u8": np.empty((B, L), np.uint8),
        "_msa_mask_u8": np.empty((B, M, NM), np.uint8),
        "coords": np.empty((B, L, 3), np.float32),
        "backbone": np.empty((B, L * 3, 3), np.float32),
    }
    if labels:
        out["labels"] = np.empty((B, L, L), np.int32)
    return out


def _batch_ptrs(out: dict) -> tuple:
    return (_ptr(out["seq"], ctypes.c_int32), _ptr(out["msa"], ctypes.c_int32),
            _ptr(out["_mask_u8"], ctypes.c_uint8), _ptr(out["_msa_mask_u8"], ctypes.c_uint8),
            _ptr(out["coords"], ctypes.c_float), _ptr(out["backbone"], ctypes.c_float))


def _finish(out: dict) -> dict:
    out["mask"] = out.pop("_mask_u8").astype(bool)
    out["msa_mask"] = out.pop("_msa_mask_u8").astype(bool)
    return out


def synthesize_batch(config: DataConfig, seed: int) -> dict:
    """One synthetic batch, deterministic by seed (no labels)."""
    lib = _load()
    c = config
    out = _alloc(c.batch_size, c.crop_len, c.msa_depth, c.msa_len, labels=False)
    lib.af2_synthesize_batch(c.batch_size, c.crop_len, c.msa_depth, c.msa_len,
                             c.min_len_filter, seed, *_batch_ptrs(out))
    return _finish(out)


class NativeSyntheticLoader:
    """Prefetching iterator of synthetic batches made by C++ worker threads:
    the batch dicts of ``data/pipeline.py`` plus ``labels``. Workers claim
    sequential batch indices and the consumer pops them in order, so the
    stream depends on the seed alone. Close it (or use it as a context
    manager) to stop the workers."""

    _handle = None

    def _bind(self, config: DataConfig) -> ctypes.CDLL:
        self._lib = _load()
        self.config = config
        return self._lib

    def __init__(self, config: DataConfig, seed: int = 0, num_workers: int = 2,
                 queue_capacity: int = 4, ignore_index: int = -100):
        lib = self._bind(config)
        self._handle = lib.af2_loader_create(
            config.batch_size, config.crop_len, config.msa_depth, config.msa_len,
            config.min_len_filter, seed, num_workers, queue_capacity,
            constants.DISTOGRAM_BUCKETS, constants.DISTOGRAM_MIN_DIST,
            constants.DISTOGRAM_MAX_DIST, ignore_index)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._handle is None:
            raise StopIteration("loader is closed")
        c = self.config
        out = _alloc(c.batch_size, c.crop_len, c.msa_depth, c.msa_len, labels=True)
        rc = self._lib.af2_loader_next(self._handle, *_batch_ptrs(out),
                                       _ptr(out["labels"], ctypes.c_int32))
        if rc != 0:
            raise StopIteration
        return _finish(out)

    def queue_size(self) -> int:
        """Batches ready in the prefetch queue (0 once closed)."""
        if self._handle is None:
            return 0
        return int(self._lib.af2_loader_queue_size(self._handle))

    def close(self) -> None:
        """Stop and join the worker threads; a second call does nothing."""
        if self._handle is not None:
            handle, self._handle = self._handle, None
            self._lib.af2_loader_destroy(handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown; close() is the API
            pass


class NativeShardLoader(NativeSyntheticLoader):
    """The real-data twin: chains from a directory of ``.npz`` shards
    (``data.pipeline.load_npz_chains``, loaded once and copied into the C++
    loader), cropped, padded, given mutation-synthesized MSAs and labels by
    the worker threads. Each sample's chain is drawn uniformly from the
    seed, so the stream is deterministic in (seed, batch index) for any
    worker count. Shards with stored MSAs warn ``MSA_FALLBACK_WARNING``:
    this loader replaces them."""

    def __init__(self, config: DataConfig, seed: int = 0, num_workers: int = 2,
                 queue_capacity: int = 4, ignore_index: int = -100,
                 mutation_rate: float = 0.15, chains: Optional[list] = None):
        from alphafold2_tpu_torch.data.pipeline import MSA_FALLBACK_WARNING, load_npz_chains

        lib = self._bind(config)
        if chains is None:
            chains, any_msa = load_npz_chains(config, seed=seed)
            if any_msa:
                import warnings

                warnings.warn(MSA_FALLBACK_WARNING)
        lens = np.asarray([len(s) for s, _ in chains], np.int32)
        seq_cat = np.ascontiguousarray(np.concatenate([s for s, _ in chains]), np.int32)
        bb_cat = np.ascontiguousarray(np.concatenate([b.reshape(-1) for _, b in chains]),
                                      np.float32)
        self.num_chains = len(chains)
        self._handle = lib.af2_real_loader_create(
            len(chains), _ptr(lens, ctypes.c_int32), _ptr(seq_cat, ctypes.c_int32),
            _ptr(bb_cat, ctypes.c_float), config.batch_size, config.crop_len,
            config.msa_depth, config.msa_len, mutation_rate, seed, num_workers,
            queue_capacity, constants.DISTOGRAM_BUCKETS, constants.DISTOGRAM_MIN_DIST,
            constants.DISTOGRAM_MAX_DIST, ignore_index)
        if not self._handle:
            raise RuntimeError("af2_real_loader_create failed")
