"""The port's observability and run-loop modules against the JAX
package's, on the CPU: obs/goodput.py, obs/prom.py,
obs/flight_recorder.py, profiler/__init__.py and distributed/trainer.py,
with the ledger hooks of ScanTrainStep and ChunkPrefetcher.

- The phase ledger books the same seconds as the JAX one for the same
  frames on a fake clock, and on a faulted gpt2-tiny run through the
  port's ResilientTrainer(goodput=True) its phases tile the wall clock
  within 1% with the waste phases populated.
- TrainingMetrics renders the same Prometheus families, with the same
  values, as the JAX one for the same events, tracker, ledger and
  checkpoint statistics.
- The recompile sentinel counts kernel-library builds (the port's only
  compile), HBMTelemetry maps torch's allocator statistics to the JAX
  names, and oom_forensics catches torch.cuda.OutOfMemoryError.
- RecordEvent, record_instant, ThroughputTracker, the flight recorder
  and DeviceWorker/MultiTrainer behave as the JAX ones do.
"""
import importlib
import json
import os
import time

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
import paddle_tpu.obs.goodput as jgood
import paddle_tpu.obs.prom as jprom
import paddle_tpu.profiler as jprof
import paddle_tpu_torch.obs.goodput as tgood
import paddle_tpu_torch.obs.prom as tprom
import paddle_tpu_torch.profiler as tprof

# both packages' obs export a function of the module's name
jfr = importlib.import_module("paddle_tpu.obs.flight_recorder")
tfr = importlib.import_module("paddle_tpu_torch.obs.flight_recorder")


pytestmark = pytest.mark.usefixtures("one_torch_thread")


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def _script(ledger, clock):
    """Nested frames, an inner book() and an unbooked stretch."""
    ledger.start()
    clock.tick(0.5)                          # idle
    with ledger.measure("compute"):
        clock.tick(1.0)
        with ledger.measure("h2d"):
            clock.tick(0.25)
        ledger.book("compile", 0.125)
        with ledger.measure("checkpoint"):
            clock.tick(0.5)
    with ledger.measure("data_wait"):
        clock.tick(0.0625)
    ledger.add_steps(3)
    ledger.add_steps(1, productive=False)
    ledger.book_async_checkpoint(2.0)
    ledger.set_flops(1e9, 1e10)
    clock.tick(0.25)
    return ledger.snapshot()


def test_ledger_books_as_jax_on_a_fake_clock():
    assert tgood.PHASES == jgood.PHASES
    snaps = []
    for mod in (jgood, tgood):
        clock = FakeClock()
        snaps.append(_script(mod.GoodputLedger(clock=clock), clock))
    assert snaps[0] == snaps[1]
    s = snaps[1]
    assert s["phase_seconds"]["compute"] == pytest.approx(1.0 - 0.125)
    assert s["phase_seconds"]["idle"] == pytest.approx(0.75)
    assert s["checkpoint_async_seconds"] == 2.0
    assert abs(sum(s["phase_seconds"].values()) - s["wall_seconds"]) < 1e-9


def test_ledger_reset_and_unstarted_snapshot_match_jax():
    for mod in (jgood, tgood):
        clock = FakeClock()
        led = mod.GoodputLedger(clock=clock)
        assert led.snapshot()["wall_seconds"] == 0.0
        _script(led, clock)
        led.reset()
        clock.tick(1.0)
        s = led.snapshot()
        assert s["wall_seconds"] == 1.0 and s["productive_steps"] == 0
        assert s["phase_seconds"]["idle"] == 1.0


def test_faulted_gpt_run_tiles_wall_clock(tmp_path):
    """gpt2-tiny (one layer) through the port's ScanTrainStep(scan_steps=2) under
    ResilientTrainer(goodput=True) with a retry, a ring rollback and a
    stalled input: phases tile the wall clock within 1%."""
    from paddle_tpu_torch.checkpoint import AsyncCheckpointManager
    from paddle_tpu_torch.distributed.resilient import (ResilientConfig,
                                                        ResilientTrainer)
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep
    from paddle_tpu_torch.utils.fault_injection import FaultPlan
    gen = torch.Generator()
    gen.manual_seed(0)
    model = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                       generator=gen, num_hidden_layers=1)
    model.train()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = ScanTrainStep(model, opt, scan_steps=2, device="cpu")
    ids = np.random.RandomState(0).randint(0, 512, (8, 2, 32))

    def batch_fn(i):
        time.sleep(0.005)                 # a stalled input pipeline
        return ids[i:i + 2], ids[i:i + 2]

    ckpt = AsyncCheckpointManager(str(tmp_path), max_to_keep=2,
                                  device="cpu")
    t = ResilientTrainer(
        step, ckpt,
        get_state=lambda: {"model": model.state_dict(),
                           "opt": opt.state_dict()},
        set_state=lambda s: (model.set_state_dict(s["model"]),
                             opt.set_state_dict(s["opt"])),
        config=ResilientConfig(save_interval=2, retry_backoff=0.03),
        fault_plan=FaultPlan.from_spec("raise@2;nan_loss@5"),
        goodput=True)
    assert step.ledger is t.ledger and t.worker.ledger is t.ledger
    summary = t.run(batch_fn, num_steps=8)
    ckpt.close()
    g = summary["goodput"]
    ph = g["phase_seconds"]
    assert sum(ph.values()) == pytest.approx(g["wall_seconds"], rel=0.01)
    assert ph["compute"] > 0 and ph["h2d"] > 0
    assert ph["data_wait"] >= 5 * 0.005 * 0.5
    assert ph["rollback_waste"] >= 0.03 * 0.5
    assert ph["checkpoint"] > 0 and g["checkpoint_async_seconds"] > 0
    assert g["productive_steps"] == 10 and g["wasted_steps"] == 0
    assert summary["rollbacks"] == 1 and summary["retries"] == 1
    assert 0.0 < g["goodput"] < 1.0


def test_live_mfu_matches_the_offline_formula(tmp_path):
    """The ledger's live MFU against the one computed around the run with
    the same obs.flops helpers (tests/test_goodput.py's acceptance)."""
    from paddle_tpu_torch.distributed.resilient import (ResilientConfig,
                                                        ResilientTrainer)
    from paddle_tpu_torch.obs.flops import (H100_BF16_PEAK_FLOPS,
                                            train_flops_per_step)
    state = {"w": 0.0}

    def train_fn(step):
        time.sleep(0.02)
        state["w"] += 1.0
        return 1.0 / (step + 1)

    t = ResilientTrainer(train_fn, str(tmp_path), get_state=dict,
                         set_state=state.update, device="cpu",
                         config=ResilientConfig(save_interval=100),
                         goodput=True)
    flops = train_flops_per_step(1e9, tokens_per_step=4096)
    t.ledger.set_flops(flops, H100_BF16_PEAK_FLOPS)
    t0 = time.perf_counter()
    summary = t.run(lambda i: i, num_steps=8)
    wall = time.perf_counter() - t0
    live = summary["goodput"]["mfu"]
    assert live == pytest.approx(flops * 8 / wall / H100_BF16_PEAK_FLOPS,
                                 rel=0.05)
    flat = tprom.parse_exposition(t.metrics.render())
    assert flat["pdtpu_train_mfu"] == pytest.approx(live, rel=0.05)


def test_prefetcher_books_data_wait():
    from paddle_tpu_torch.io.prefetch import ChunkPrefetcher

    def slow():
        for i in range(4):
            time.sleep(0.02)
            yield np.full((2,), i, np.float32)

    clock_ledger = tgood.GoodputLedger()
    pf = ChunkPrefetcher(slow(), scan_steps=2,
                         put_fn=lambda s: tuple(torch.from_numpy(a)
                                                for a in s))
    pf.ledger = clock_ledger
    with pf:
        chunks = list(pf)
    assert len(chunks) == 2
    assert clock_ledger.snapshot()["phase_seconds"]["data_wait"] > 0.02


# ---- Prometheus families ----

def _metrics(prom, good, prof, ck, tmp):
    """TrainingMetrics of one package over the same events, tracker,
    fake-clock ledger, sentinel, memory stats and checkpoint stats."""
    tracker = prof.ThroughputTracker()
    tracker.update(steps=2, seconds=0.5, tokens=128)
    tracker.update(steps=2, seconds=0.25, tokens=128)
    clock = FakeClock()
    ledger = good.GoodputLedger(clock=clock)
    _script(ledger, clock)
    sentinel = good.RecompileSentinel(ledger)
    sentinel.on_compile(0.5)
    hbm = good.HBMTelemetry(stats_fn=lambda: {
        "bytes_in_use": 10, "peak_bytes_in_use": 20, "bytes_limit": 80})
    hbm.attribute("params", 6)
    kw = {"use_orbax": False} if ck.__name__ == "paddle_tpu.checkpoint" \
        else {"device": "cpu"}
    mgr = ck.AsyncCheckpointManager(tmp, **({} if "use_orbax" in kw
                                            else kw))
    mgr.snapshot(1, {"w": np.ones(4, np.float32)})
    mgr.wait_until_finished()
    m = prom.TrainingMetrics(tracker=tracker, ledger=ledger, hbm=hbm,
                             sentinel=sentinel, ckpt=mgr)
    for kind, step in (("retry", 1), ("rollback", 2), ("skip", 3),
                       ("bad_loss", 3), ("checkpoint_save", 4),
                       ("resumed", 4), ("unknown_kind", 9)):
        m.on_event(kind, step)
    m.set_step(12)
    text = m.render()
    mgr.close()
    return text


def test_training_metrics_render_the_jax_families(tmp_path):
    from paddle_tpu import checkpoint as jck
    from paddle_tpu_torch import checkpoint as tck
    texts = [_metrics(jprom, jgood, jprof, jck, str(tmp_path / "j")),
             _metrics(tprom, tgood, tprof, tck, str(tmp_path / "t"))]
    types = [sorted(l for l in t.splitlines() if l.startswith("# TYPE"))
             for t in texts]
    assert types[0] == types[1]
    flat = [tprom.parse_exposition(t) for t in texts]
    assert set(flat[0]) == set(flat[1])
    timing = ("seconds", "lag")          # wall clocks of the two writers
    for k, v in flat[0].items():
        if not any(w in k for w in timing) or "phase" in k:
            assert flat[1][k] == v or (np.isnan(v) and np.isnan(flat[1][k])),\
                k
    assert flat[1]["pdtpu_train_retries_total"] == 1
    assert flat[1]["pdtpu_train_last_step"] == 12
    assert flat[1]["pdtpu_train_ckpt_persisted_total"] == 1
    assert flat[1]['pdtpu_train_hbm_attributed_bytes{component="params"}'] \
        == 6


def test_prom_builder_and_parse_match_jax():
    def build(prom):
        b = prom.PromBuilder()
        b.family("x_total", "counter")
        b.sample("x_total", 3, labels={"tenant": 'a"b\\c\nd'})
        b.sample("x_total", None, labels={"k": "v"})
        b.sample("y", 1.234567, round_to=3)
        return b.render()

    assert build(tprom) == build(jprom)
    assert tprom.parse_exposition(build(tprom)).keys() == \
        jprom.parse_exposition(build(jprom)).keys()


def test_metrics_server_serves_metrics_and_flight_recorder():
    import urllib.request
    srv = tprom.MetricsServer([lambda: "a_total 1\n"], port=0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        assert urllib.request.urlopen(base + "/metrics").read() == \
            b"a_total 1\n"
        doc = json.loads(urllib.request.urlopen(
            base + "/debug/flightrecorder").read())
        assert doc["version"] == 1
        assert urllib.request.urlopen(base + "/healthz").read() == b"ok\n"
    finally:
        srv.stop()


# ---- sentinel, memory telemetry, OOM forensics ----

def test_sentinel_counts_kernel_library_builds(caplog):
    from paddle_tpu_torch.ops import _kernels
    ledger = tgood.GoodputLedger()
    s = tgood.RecompileSentinel(ledger, storm_threshold=2).install()
    try:
        assert s.installed == "kernel_build"
        assert tgood._build_dispatch in _kernels._BUILD_LISTENERS
        assert s.install() is s          # idempotent
        for fn in list(_kernels._BUILD_LISTENERS):
            fn(1.5)                      # a build during warm-up
        s.mark_warm()
        with caplog.at_level("WARNING"):
            for fn in list(_kernels._BUILD_LISTENERS):
                fn(0.5)
                fn(0.25)
        assert s.snapshot() == {"compiles": 3, "recompiles": 2,
                                "compile_seconds": 2.25}
        assert ledger.snapshot()["phase_seconds"]["compile"] == 2.25
        assert "recompile storm" in caplog.text
        kinds = [e["kind"] for e in tfr.flight_recorder().snapshot()[
            "events"]]
        assert kinds.count("train_recompile") >= 2
    finally:
        s.uninstall()
    assert tgood._build_dispatch not in _kernels._BUILD_LISTENERS
    with pytest.raises(ValueError, match="kernel_build"):
        tgood.RecompileSentinel().install(source="monitoring")
    with pytest.raises(ValueError, match=">= 1"):
        tgood.RecompileSentinel(storm_threshold=0)


def test_hbm_telemetry_matches_jax_and_reads_torch_names():
    def stats():
        return {"bytes_in_use": 5, "peak_bytes_in_use": 9,
                "bytes_limit": 100, "other": 1}

    snaps = []
    for mod in (jgood, tgood):
        h = mod.HBMTelemetry(stats_fn=stats)
        h.attribute("params", 3)
        snaps.append(h.snapshot())
    assert snaps[0] == snaps[1]
    assert tgood.HBMTelemetry(device="cpu").sample() == {
        "available": False}
    tree = {"a": [torch.zeros(4), np.zeros(3, np.float64)],
            "b": (torch.zeros(2, dtype=torch.bfloat16), 7)}
    assert tgood.HBMTelemetry.tree_nbytes(tree) == 16 + 24 + 4


def test_oom_forensics_catches_torch_oom(tmp_path, monkeypatch):
    monkeypatch.setenv(tfr.DUMP_DIR_ENV, str(tmp_path))
    hbm = tgood.HBMTelemetry(stats_fn=lambda: {
        "bytes_in_use": 700, "peak_bytes_in_use": 1000,
        "bytes_limit": 1024})
    hbm.attribute("params", 600)
    assert tgood.oom_forensics(RuntimeError("RESOURCE_EXHAUSTED"),
                               hbm) is None
    path = tgood.oom_forensics(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"), hbm)
    assert path is not None and os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["reason"] == "oom"
    oom = [e for e in doc["events"] if e["kind"] == "train_oom"][-1]
    assert oom["hbm_peak_bytes_in_use"] == 1000
    assert oom["attr_params_bytes"] == 600
    assert "out of memory" in oom["error"]


# ---- profiler, flight recorder, run loops ----

def test_record_events_and_export_match_jax(tmp_path):
    docs = []
    for prof in (jprof, tprof):
        prof.start_profiler()
        with prof.RecordEvent("outer"):
            with prof.RecordEvent("inner"):
                pass
        prof.record_instant("resilient/bad_loss", {"step": 3})
        prof.emit_events([{"name": "goodput/compute", "ph": "X",
                           "ts": 1.0, "dur": 2.0, "pid": 0, "tid": 0}])
        path = str(tmp_path / f"{prof.__name__}.json")
        prof.stop_profiler(profile_path=path)
        with open(path) as f:
            docs.append(json.load(f)["traceEvents"])
        summary = prof.Profiler(timer_only=True).summary()
        assert "inner" in summary and "outer" in summary
    shape = [[(e["name"], e["ph"], sorted(e)) for e in d] for d in docs]
    assert shape[0] == shape[1]
    assert not tprof.profiler_enabled()


def test_start_profiler_writes_a_torch_trace(tmp_path):
    tprof.start_profiler(trace_dir=str(tmp_path / "trace"))
    torch.ones(8).sum()
    tprof.stop_profiler(profile_path=str(tmp_path / "host.json"))
    files = os.listdir(tmp_path / "trace")
    assert files == [f"torch_trace_{os.getpid()}.json"]
    assert os.path.exists(tmp_path / "host.json")


def test_throughput_tracker_matches_jax():
    outs = []
    for prof in (jprof, tprof):
        t = prof.ThroughputTracker(window=2)
        t.register_flops(1e6, 1e9)
        for steps, secs, tokens in ((2, 0.5, 64), (2, 0.0, 64),
                                    (4, 0.25, 128), (2, 0.25, 64)):
            t.update(steps=steps, seconds=secs, tokens=tokens)
        outs.append(t.summary())
    assert outs[0] == outs[1]


def test_flight_recorder_matches_jax(tmp_path):
    docs = []
    for fr in (jfr, tfr):
        rec = fr.FlightRecorder(capacity=2)
        for i in range(3):
            rec.record("train_retry", step=i)
        path = rec.dump(str(tmp_path / f"{fr.__name__}.json"),
                        reason="test")
        with open(path) as f:
            doc = json.load(f)
        docs.append({k: doc[k] for k in ("version", "capacity", "recorded",
                                         "dropped", "reason")})
        docs.append([(e["kind"], e["step"], e["seq"])
                     for e in doc["events"]])
        with pytest.raises(ValueError):
            fr.FlightRecorder(capacity=0)
    assert docs[0] == docs[2] and docs[1] == docs[3]
    assert tfr.DUMP_DIR_ENV == jfr.DUMP_DIR_ENV


def test_device_worker_and_multitrainer_match_jax():
    from paddle_tpu.distributed.trainer import DeviceWorker as JaxWorker
    from paddle_tpu.distributed.trainer import MultiTrainer as JaxMulti
    from paddle_tpu_torch.distributed.trainer import (DeviceWorker,
                                                      MultiTrainer,
                                                      train_from_dataset)
    args = (np.zeros((4, 2, 16), np.int32), np.zeros((4,), np.int32))
    assert DeviceWorker._chunk_tokens(args) == \
        JaxWorker._chunk_tokens(args) == 128
    assert DeviceWorker._chunk_tokens(
        tuple(torch.from_numpy(a) for a in args)) == 128

    class FakeScan:
        """A K=2 step of either package: stacked chunks in, K losses out
        (torch tensors for the port, numpy for JAX)."""
        scan_steps = 2

        def __init__(self, port):
            self.port = port
            self.calls = 0

        def device_put_chunk(self, stacked):
            return tuple(torch.from_numpy(a) for a in stacked) \
                if self.port else stacked

        def __call__(self, xs):
            self.calls += 1
            out = np.full((2,), float(self.calls), np.float32)
            return torch.from_numpy(out) if self.port else out

    steps = []
    for Multi in (JaxMulti, MultiTrainer):
        fn = FakeScan(Multi is MultiTrainer)
        m = Multi(fn, print_period=0)
        m.train_from_dataset([np.zeros((2, 3))] * 5, epochs=1, prefetch=2)
        steps.append((m.steps, fn.calls))
        with pytest.raises(ValueError, match="scan-fused"):
            Multi(lambda b: 0.0).train_from_dataset([1], prefetch=2)
    assert steps[0] == steps[1] == (4, 2)
    eager = []
    last = train_from_dataset(lambda b: eager.append(b) or 0.5,
                              [1, 2, 3], epochs=2, print_period=0)
    assert last == 0.5 and eager == [1, 2, 3, 1, 2, 3]
