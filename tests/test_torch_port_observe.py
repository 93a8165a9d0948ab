"""The training loops' telemetry on the port (``observe/tracing.py``,
``observe/metrics.py``, ``observe/profiler.py``, ``train/observe.py``), on
the CPU: the port of ``tests/test_observe.py``'s tracer, ``MetricsLogger``
and profiler-window tests, the training loop's spans (``train.step``,
``train.next_batch``, ``train.checkpoint``, ``train.nan_triage``, the
``numerics.nan_triage`` instant and the ``numerics/*`` counters), a real
``torch.profiler`` window written into ``train.profile_dir``, and the
repair of ``train_end2end``, which refused configs JAX runs: with dropout,
``numerics``, ``profile_dir`` and ``trace_events`` set it trains bit-equal
to the run without them, as JAX's ``train_end2end`` reads none of them,
and it writes ``metrics.jsonl``.

Model widths: dim 16, depth 1-2, heads 2, dim_head 8, crop <= 12.
"""

import json
import os
import threading
import time

import pytest
import torch

from alphafold2_tpu_torch import observe
from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from alphafold2_tpu_torch.observe import MetricsLogger, Profiler, Tracer, flatten_metrics
from alphafold2_tpu_torch.observe.tracing import (
    load_trace_events, load_trace_events_lenient, merge_intervals,
)
from alphafold2_tpu_torch.train import end2end, loop


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _assert_valid_chrome_events(events):
    """The Chrome trace-event keys with their types, as Perfetto reads them."""
    assert events, "no events emitted"
    for e in events:
        assert isinstance(e["name"], str) and e["name"]
        assert e["ph"] in ("X", "i", "C")
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
        assert isinstance(e["pid"], int)
        if e["ph"] == "X":
            assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
            assert isinstance(e["tid"], int)


# ------------------------------------------------------------------ tracer


def test_tracer_emits_nested_spans_to_file(tmp_path):
    path = str(tmp_path / "trace.json")
    tracer = Tracer(path)
    with tracer.span("outer", kind="test"):
        with tracer.span("inner"):
            time.sleep(0.01)
    tracer.instant("marker", note="hi")
    tracer.counter("mem", bytes=123)
    t0 = time.perf_counter()
    tracer.span_event("after", t0 - 0.002, t0, k=1)
    tracer.close()
    events = load_trace_events(path)
    _assert_valid_chrome_events(events)
    by_name = {e["name"]: e for e in events}
    assert set(by_name) == {"outer", "inner", "marker", "mem", "after"}
    outer, inner = by_name["outer"], by_name["inner"]
    assert inner["ts"] >= outer["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert inner["dur"] >= 10_000 * 0.5
    assert outer["args"] == {"kind": "test"}
    assert 1500 <= by_name["after"]["dur"] <= 2500 and by_name["after"]["args"] == {"k": 1}


def test_tracer_file_is_a_streaming_chrome_array(tmp_path):
    path = str(tmp_path / "trace.json")
    tracer = Tracer(path)
    with tracer.span("a"):
        pass
    lines = open(path).read().splitlines()  # flushed before close
    assert lines[0] == "[" and len(lines) == 2
    tracer.close()
    for line in lines[1:]:
        json.loads(line.rstrip(","))


def test_tracer_span_records_exception_and_reraises(tmp_path):
    tracer = Tracer(str(tmp_path / "t.json"))
    with pytest.raises(ValueError):
        with tracer.span("dies"):
            raise ValueError("boom")
    (event,) = tracer.events()
    assert event["args"]["error"] == "ValueError"
    tracer.close()


def test_tracer_disabled_is_a_noop(tmp_path):
    tracer = Tracer(enabled=False)
    with tracer.span("x") as sp:
        sp.set(a=1)
    tracer.instant("y")
    tracer.counter("z", v=1)
    assert tracer.events() == [] and tracer.span_totals() == {}
    assert Tracer(None).enabled is False
    assert not os.listdir(tmp_path)


def test_tracer_span_totals_and_set():
    tracer = Tracer(enabled=True)  # in memory only
    for _ in range(3):
        with tracer.span("work") as sp:
            sp.set(verdict="hit")
    totals = tracer.span_totals()
    assert totals["work"]["count"] == 3 and totals["work"]["total_s"] >= 0.0
    assert all(e["args"]["verdict"] == "hit" for e in tracer.events())


def test_tracer_threads_get_distinct_tids():
    tracer = Tracer(enabled=True)
    barrier = threading.Barrier(4)

    def work():
        with tracer.span("t"):
            barrier.wait(timeout=10)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len({e["tid"] for e in tracer.events()}) == 4


def test_sinks_run_outside_the_lock_and_cannot_lose_the_trace():
    """A sink that emits into the same tracer would deadlock under the
    lock; a sink that raises must not lose the event."""
    tracer = Tracer(enabled=True)
    seen = []

    def echo(event):
        seen.append(event["name"])
        if event["ph"] == "X":
            tracer.instant("echo")

    tracer.add_sink(echo)
    tracer.add_sink(echo)  # added once
    tracer.add_sink(lambda e: 1 / 0)
    with tracer.span("s"):
        pass
    assert seen == ["s", "echo"]
    assert [e["name"] for e in tracer.events()] == ["s", "echo"]


def test_lenient_loader_and_merge_intervals(tmp_path):
    path = tmp_path / "cut.json"
    path.write_text('[\n{"name": "a", "ph": "X", "ts": 1, "dur": 2, "pid": 1, "tid": 1},\n'
                    '{"name": "b", "ph": "X", "ts"\n')
    events, errors = load_trace_events_lenient(str(path))
    assert [e["name"] for e in events] == ["a"] and len(errors) == 1
    assert errors[0].startswith("line 3:")
    with pytest.raises(json.JSONDecodeError):
        load_trace_events(str(path))
    whole = tmp_path / "whole.json"
    whole.write_text(json.dumps({"traceEvents": [{"name": "c"}]}))
    assert load_trace_events(str(whole)) == [{"name": "c"}]
    assert merge_intervals([(3, 4), (0, 1), (0.5, 2), (5, 5)]) == [(0, 2), (3, 4)]


# ------------------------------------------------------------ metrics logger


def test_metrics_logger_jsonl_output(tmp_path, capsys):
    logger = MetricsLogger(str(tmp_path))
    logger.log(0, {"loss": 1.5, "note": "warm"})
    logger.log(1, {"loss": 0.5})
    rec0, rec1 = (json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines())
    assert rec0 == {"step": 0, "time": rec0["time"], "loss": 1.5, "note": "warm"}
    assert rec1["step"] == 1 and rec1["loss"] == 0.5 and rec1["time"] >= rec0["time"]
    out = capsys.readouterr().out
    assert "[step 0]" in out and "loss=1.5" in out and logger.enabled
    assert logger.path == str(tmp_path / "metrics.jsonl")


def test_metrics_logger_disabled_and_echo_off(tmp_path, capsys):
    MetricsLogger(str(tmp_path / "sub"), enabled=False).log(0, {"loss": 1.0})
    assert not (tmp_path / "sub").exists()
    assert capsys.readouterr().out == ""
    MetricsLogger(str(tmp_path), echo=False).log(0, {"v": 1})
    assert capsys.readouterr().out == ""
    assert (tmp_path / "metrics.jsonl").exists()
    MetricsLogger(None).log(0, {"v": 2})  # stdout only
    assert "v=2" in capsys.readouterr().out


def test_flatten_metrics():
    flat = flatten_metrics({"loss": torch.tensor(1.5), "ok": torch.tensor(True),
                            "numerics": {"embed.pair": {"l2": torch.tensor(2.0), "index": 0}},
                            "event": "nan_triage", "bad": ["a"]})
    assert flat == {"loss": 1.5, "ok": 1.0, "numerics/embed.pair/l2": 2.0,
                    "numerics/embed.pair/index": 0.0, "event": "nan_triage", "bad": ["a"]}


# ---------------------------------------------------------------- profiler


class _FakeProfile:
    calls: list = []

    def __init__(self, activities):
        self.activities = activities

    def __enter__(self):
        self.calls.append("start")
        return self

    def __exit__(self, *exc):
        self.calls.append("stop")

    def export_chrome_trace(self, path):
        self.calls.append(("export", os.path.basename(path)))


@pytest.fixture
def fake_profile(monkeypatch):
    import torch.profiler

    _FakeProfile.calls = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    return _FakeProfile.calls


def test_profiler_window_boundaries(fake_profile, tmp_path):
    p = Profiler(str(tmp_path), steps=(2, 4))
    for step in range(6):
        p.maybe_start(step)
        p.maybe_stop(step)
    # starts at step 2; maybe_stop(2) and (3) must not stop it; stops at 4
    assert fake_profile == ["start", "stop", ("export", "trace_steps_2_4.json")]
    assert p.path == str(tmp_path / "trace_steps_2_4.json")


def test_profiler_no_dir_never_starts(fake_profile):
    p = Profiler(None, steps=(0, 1))
    for step in range(3):
        p.maybe_start(step)
        p.maybe_stop(step)
    assert fake_profile == []


def test_profiler_reentry_safety(fake_profile, tmp_path):
    p = Profiler(str(tmp_path), steps=(1, 2))
    p.maybe_start(1)
    p.maybe_start(1)
    assert fake_profile.count("start") == 1
    p.maybe_stop(5)
    p.maybe_stop(6)
    assert fake_profile == ["start", "stop", ("export", "trace_steps_1_2.json")]
    p.maybe_start(1)  # a window opens again at its start step
    assert fake_profile[-1] == "start"


# ------------------------------------------------------------------- loops


def _cfg(**train):
    cfg = Config(
        model=ModelConfig(dim=16, depth=2, heads=2, dim_head=8, max_seq_len=32, bfloat16=False),
        data=DataConfig(crop_len=12, msa_depth=2, msa_len=12, batch_size=1, min_len_filter=8),
        train=TrainConfig(gradient_accumulate_every=1, warmup_steps=1, log_every=1,
                          numerics="off"))
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def test_train_loop_emits_spans_instants_and_counters(tmp_path):
    """Spans of every step, batch fetch and checkpoint; with a poisoned
    weight the triage span and instant; under "full" the numerics
    counters."""
    path = str(tmp_path / "train_trace.json")

    def poison(i, state, metrics):
        if i == 1:
            with torch.no_grad():
                next(state.model.parameters()).fill_(float("nan"))

    cfg = _cfg(trace_events=path, numerics="full", checkpoint_dir=str(tmp_path / "ck"),
               checkpoint_every=2)
    loop.train(cfg, num_steps=3, device="cpu", callbacks=[poison])
    events = load_trace_events(path)
    _assert_valid_chrome_events(events)
    steps = [e["args"]["step"] for e in events if e["name"] == "train.step"]
    assert steps == [0, 1, 2]
    assert [e["args"]["step"] for e in events if e["name"] == "train.next_batch"] == [0, 1, 2]
    assert [e["args"]["step"] for e in events if e["name"] == "train.checkpoint"] == [2]
    assert [e["args"]["step"] for e in events if e["name"] == "train.nan_triage"] == [2]
    (instant,) = [e for e in events if e["name"] == "numerics.nan_triage"]
    assert instant["ph"] == "i" and instant["args"]["first_nonfinite"] == "embed.pair"
    counters = [e for e in events if e["name"] == "numerics/embed.pair"]
    assert len(counters) == 3 and set(counters[0]["args"]) == {
        "l2", "max_abs", "nan_count", "inf_count"}


def test_a_real_profiler_window_writes_its_trace(tmp_path):
    prof = tmp_path / "prof"
    loop.train(_cfg(profile_dir=str(prof), profile_steps=(1, 2)), num_steps=4, device="cpu")
    (name,) = os.listdir(prof)
    assert name == "trace_steps_1_2.json"
    with open(prof / name) as f:
        trace = json.load(f)
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


def test_train_observe_shim_reexports():
    from alphafold2_tpu_torch.train import observe as shim

    assert (shim.MetricsLogger, shim.Profiler, shim.Span, shim.Tracer) == (
        observe.MetricsLogger, observe.Profiler, observe.Span, observe.Tracer)


# ------------------------------------------------- the repair: train_end2end


def _e2e_cfg(tmp, **change):
    cfg = Config(
        model=ModelConfig(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48, bfloat16=False),
        data=DataConfig(crop_len=8, msa_depth=2, msa_len=8, batch_size=2, min_len_filter=6),
        train=TrainConfig(gradient_accumulate_every=1, warmup_steps=1, log_every=1,
                          numerics="off", checkpoint_dir=str(tmp / "ck")))
    for k, v in change.items():
        section, field = k.split(".")
        setattr(getattr(cfg, section), field, v)
    return cfg


def test_train_end2end_runs_the_options_jax_ignores_bit_equal(tmp_path):
    """JAX's ``train_end2end`` reads none of these options; the port raised
    ``NotImplementedError`` for them."""
    def run(tmp, **change):
        losses = []
        state = end2end.train_end2end(
            _e2e_cfg(tmp, **change), num_steps=2, device="cpu",
            callbacks=[lambda i, s, m: losses.append(float(m["loss"]))])
        return state, losses

    plain, plain_losses = run(tmp_path / "plain")
    opts = tmp_path / "opts"
    state, losses = run(opts, **{"model.attn_dropout": 0.1, "model.ff_dropout": 0.1,
                                 "train.numerics": "full",
                                 "train.profile_dir": str(opts / "prof"),
                                 "train.profile_steps": (0, 1),
                                 "train.trace_events": str(opts / "trace.json")})
    assert losses == plain_losses and len(losses) == 2
    sp, so = plain.model.state_dict(), state.model.state_dict()
    assert all(torch.equal(sp[k], so[k]) for k in sp)
    assert not (opts / "prof").exists() and not (opts / "trace.json").exists()
    model = end2end.build_end2end_model(_e2e_cfg(opts, **{"model.attn_dropout": 0.1}))
    assert all(getattr(m, "dropout", 0.0) == 0.0 for m in model.modules())
    records = [json.loads(line) for line in open(opts / "ck" / "metrics.jsonl")]
    assert [r["step"] for r in records if "loss" in r] == [0, 1]
    assert "rmsd" in records[0] and "first_step_s" in records[0]
    # a mesh trains under torchrun: in one process with no process group
    # building it raises, naming parallel.distributed.initialize
    with pytest.raises(RuntimeError, match=r"initialize\(\)"):
        end2end.train_end2end(_e2e_cfg(tmp_path, **{"mesh.data_parallel": 2}), num_steps=1,
                              device="cpu")


def test_train_pre_cli_takes_dropout_numerics_and_traces(tmp_path, capsys):
    from alphafold2_tpu_torch.train_pre import main as train_pre_main

    trace = tmp_path / "trace.json"
    train_pre_main(["train.num_steps=3", "train.log_every=1", "data.crop_len=12",
                    "data.msa_len=12", "data.min_len_filter=8", "model.dim=16",
                    "model.heads=2", "model.dim_head=8", "model.max_seq_len=32",
                    "model.attn_dropout=0.1", "model.ff_dropout=0.1", "train.numerics=full",
                    f"train.trace_events={trace}", f"train.profile_dir={tmp_path / 'prof'}",
                    "train.profile_steps=1,1", "--device=cpu"])
    out = capsys.readouterr().out
    assert "[step 2]" in out and "numerics/loss.distogram_nll/l2=" in out
    assert [e["args"]["step"] for e in load_trace_events(str(trace))
            if e["name"] == "train.step"] == [0, 1, 2]
    assert os.listdir(tmp_path / "prof") == ["trace_steps_1_1.json"]
