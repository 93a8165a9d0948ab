"""The port's import and config surface against the JAX package's: the
subpackages' exports, ``Config.from_json`` and the tracer's
``from_env`` / ``device_idle_fraction``.

The port's engine and pipeline name the two spans the idle share reads
exactly as JAX's engine does: ``serve.dispatch`` (the forward's launch, on
the serial path and on the pipeline's device stage) and
``serve.device_get`` (the wait for its results), so
``device_idle_fraction`` reads JAX's names (``DEVICE_SPAN_NAMES``).
"""

import ast
import dataclasses
import importlib
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import alphafold2_tpu.config as jconfig
from alphafold2_tpu.observe import tracing as jtracing
from alphafold2_tpu_torch import config as tconfig
from alphafold2_tpu_torch.observe import tracing as ttracing


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_exports(sub: str) -> set:
    """The names JAX's ``alphafold2_tpu/<sub>/__init__.py`` re-exports."""
    path = pathlib.Path(importlib.util.find_spec(f"alphafold2_tpu.{sub}").origin)
    return {a.asname or a.name for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.ImportFrom) for a in node.names}


# SidechainnetDataset needs sidechainnet and stays out
@pytest.mark.parametrize("sub", ["models", "train", "ops", "data"])
def test_subpackages_export_the_jax_names(sub):
    port = importlib.import_module(f"alphafold2_tpu_torch.{sub}")
    assert set(port.__all__) == _jax_exports(sub) - {"SidechainnetDataset"}
    for name in port.__all__:
        assert getattr(port, name).__module__.startswith(f"alphafold2_tpu_torch.{sub}.")


def test_readme_first_usage_imports_under_the_port_name():
    from alphafold2_tpu_torch.models import Alphafold2
    from alphafold2_tpu_torch.ops import Attention, AxialAttention, FeedForward
    from alphafold2_tpu_torch.train import build_optimizer, device_put_batch
    from alphafold2_tpu_torch.data import SyntheticDataset, make_dataset

    assert Alphafold2.__module__ == "alphafold2_tpu_torch.models.alphafold2"
    assert {Attention, AxialAttention, FeedForward} and SyntheticDataset and make_dataset
    assert build_optimizer.__module__ == "alphafold2_tpu_torch.train.optim"
    batch = device_put_batch({"seq": np.zeros((1, 4), np.int32),
                              "mask": np.ones((1, 4), bool)}, device="cpu")
    assert batch["seq"].dtype == torch.int64 and batch["mask"].dtype == torch.bool


def _every_tuple_field_set(cfg_mod):
    cfg = cfg_mod.Config()
    cfg.train.profile_steps = (3, 7)
    cfg.serve.buckets = (16, 48, 96)
    cfg.serve.long_buckets = (512, 1024)
    # fields the port keeps for JAX's configs and serves no purpose of its
    # own: they round-trip all the same
    cfg.serve.long_max_batch = 2
    cfg.serve.donate_buffers = False
    cfg.data.casp_version = 7
    cfg.data.thinning = 90
    cfg.serve.kernels = "axial=stock,flash=on"
    return cfg


@pytest.mark.parametrize("which", ["default", "tuples"])
def test_from_json_round_trips_and_equals_jax(which):
    cfg = tconfig.Config() if which == "default" else _every_tuple_field_set(tconfig)
    back = tconfig.Config.from_json(cfg.to_json())
    assert back == cfg
    for t in (back.train.profile_steps, back.serve.buckets, back.serve.long_buckets):
        assert isinstance(t, tuple)
    jcfg = jconfig.Config() if which == "default" else _every_tuple_field_set(jconfig)
    jback = jconfig.Config.from_json(cfg.to_json())
    assert dataclasses.asdict(jback) == dataclasses.asdict(back)
    assert json.loads(jcfg.to_json()) == json.loads(cfg.to_json())
    assert back.serve.long_max_batch == cfg.serve.long_max_batch
    assert back.serve.donate_buffers == cfg.serve.donate_buffers
    assert (back.data.casp_version, back.data.thinning) == (cfg.data.casp_version,
                                                            cfg.data.thinning)


def test_tracer_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv("AF2TPU_TRACE_EVENTS", raising=False)
    assert not ttracing.Tracer.from_env().enabled
    assert not jtracing.Tracer.from_env().enabled
    path = tmp_path / "trace.json"
    monkeypatch.setenv("AF2TPU_TRACE_EVENTS", str(path))
    tracer = ttracing.Tracer.from_env()
    assert tracer.enabled
    with tracer.span("serve.dispatch", bucket=8):
        pass
    tracer.close()
    events = ttracing.load_trace_events(str(path))
    assert [e["name"] for e in events] == ["serve.dispatch"]


def _events():
    # two dispatches overlapping a device_get, a gap, a featurize span the
    # share ignores, one non-X event and a span of another name
    def x(name, ts, dur):
        return {"name": name, "ph": "X", "ts": ts, "dur": dur}

    return [x("serve.featurize", 0.0, 5e5), x("serve.dispatch", 1e6, 2e5),
            x("serve.device_get", 1.1e6, 3e5), x("serve.dispatch", 2e6, 1e5),
            {"name": "serve.dispatch", "ph": "i", "ts": 2.5e6},
            x("serve.device_get", 2.1e6, 4e5), x("serve.unpad", 2.6e6, 1e6)]


def test_device_idle_fraction_matches_jax():
    assert ttracing.DEVICE_SPAN_NAMES == jtracing.DEVICE_SPAN_NAMES
    ours, theirs = ttracing.device_idle_fraction(_events()), jtracing.device_idle_fraction(
        _events())
    assert ours == theirs
    assert ours == {"device_idle_frac": 0.4, "busy_s": 0.9, "window_s": 1.5,
                    "dispatches": 2}
    assert ttracing.device_idle_fraction(_events()[:1]) is None
    assert jtracing.device_idle_fraction(_events()[:1]) is None
    from alphafold2_tpu_torch.observe import device_idle_fraction

    assert device_idle_fraction is ttracing.device_idle_fraction


def test_engine_spans_feed_the_idle_share():
    """The port's serial and pipelined engines emit the spans the share
    reads, under JAX's names."""
    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.serve.engine import ServeEngine

    cfg = Config()
    m = cfg.model
    m.dim, m.depth, m.heads, m.dim_head, m.max_seq_len = 16, 1, 2, 8, 48
    cfg.serve.buckets, cfg.serve.max_batch, cfg.serve.mds_iters = (8,), 2, 4
    for depth in (0, 2):
        cfg.serve.pipeline_depth = depth
        engine = ServeEngine(cfg, device="cpu", tracer=ttracing.Tracer(enabled=True))
        try:
            engine.predict_many(["ACDEFG", "MKVLA", "GHIKL"])
        finally:
            engine.close()
        share = ttracing.device_idle_fraction(engine.tracer.events())
        assert share is not None and share["dispatches"] == 2
        assert 0.0 <= share["device_idle_frac"] <= 1.0
