"""The port's BatchingEngine, ServingMetrics and serving.sim against the
JAX package's.

One numpy predict_fn stands behind both packages' engines on SimClocks,
and one seeded `sim.poisson_trace` (built by each package's own `sim`,
held equal) is replayed through each with `sim.replay`: the dispatch
sizes and padding, every request's outcome and output, the rejects with
their `retry_after_s`, the deadline drops, a failed dispatch, the
request timelines and `ServingMetrics.snapshot()` must agree, and so must
the flight-recorder events. The circuit-breaker scenario of
tests/test_serving.py runs through both, with the Prometheus rendering.
"""
import numpy as np
import pytest

from _torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EVENT_DROP = ("t_mono", "t_wall", "seq", "rid")


def _pkgs():
    import paddle_tpu.serving as jserving
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu.utils.fault_injection import FaultPlan as JPlan
    import paddle_tpu_torch.serving as tserving
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    from paddle_tpu_torch.utils.fault_injection import FaultPlan as TPlan
    return (jserving, jfr, JPlan), (tserving, tfr, TPlan)


def _make_inputs(i):
    rows = (1, 2, 1, 3, 1, 5)[i % 6]          # 5 rows: over max_request_rows
    width = 3 if i % 7 else 4                 # another trailing shape
    return [np.full((rows, width), i, np.float32)
            + np.arange(rows * width, dtype=np.float32).reshape(rows, width)]


def _predictor(calls):
    def predict(args):
        calls.append(args[0].shape)
        x = args[0]
        return [x * 2.0 + 1.0, x.sum(axis=1), np.float32(x.shape[0])]
    return predict


def _replay(serving, fr, Plan):
    fr().clear()
    calls = []
    cfg = serving.EngineConfig(max_batch_size=8, max_wait_ms=2.0,
                               max_queue_depth=5, max_request_rows=4,
                               retry_after_s=0.25, breaker_threshold=3)
    eng = serving.BatchingEngine(_predictor(calls), cfg,
                                 clock=serving.SimClock(),
                                 fault_plan=Plan.from_spec("dispatch_raise@2"))
    trace = serving.poisson_trace(40, rate_hz=4000.0,
                                  make_inputs=_make_inputs, seed=7)
    for i, a in enumerate(trace):
        if i % 5 == 4:
            a.deadline_ms = 0.5
    report = serving.replay(eng, trace)
    return eng, report, calls, trace


def _traced(serving):
    """A traced request after the replay, on a fresh engine: its
    timeline."""
    clock = serving.SimClock()
    eng = serving.BatchingEngine(_predictor([]),
                                 serving.EngineConfig(max_wait_ms=1.0),
                                 clock=clock)
    eng.submit([np.ones((2, 3), np.float32)], rid="ab12cd34", trace=True)
    clock.advance(0.002)
    eng.pump()
    return eng.timelines.get("ab12cd34")


def _view(report):
    out = []
    for o, r, e in zip(report.outcomes, report.results, report.errors):
        err = None if e is None else (type(e).__name__,
                                      getattr(e, "reason", None),
                                      getattr(e, "retry_after_s", None))
        res = None if r is None else [np.asarray(x).tolist() for x in r]
        out.append((o, res, err))
    return out


def _events(fr):
    return [{k: v for k, v in e.items() if k not in EVENT_DROP}
            for e in fr().snapshot()["events"]]


def test_replay_matches_jax():
    (js, jfr, JPlan), (ts, tfr, TPlan) = _pkgs()
    je, jr, jcalls, jtrace = _replay(js, jfr, JPlan)
    jev = _events(jfr)
    te, tr, tcalls, ttrace = _replay(ts, tfr, TPlan)
    assert [a.t for a in ttrace] == [a.t for a in jtrace]
    assert tcalls == jcalls                   # dispatch sizes, pow2 padded
    assert tr.dispatches == jr.dispatches
    assert _view(tr) == _view(jr)
    assert tr.metrics == jr.metrics
    assert _events(tfr) == jev
    for k in ("completed", "rejected", "expired"):
        assert getattr(tr, k) == getattr(jr, k) > 0, k
    assert tr.outcomes.count("failed") == jr.outcomes.count("failed") > 0
    assert tr.metrics["pad_overhead_rows"] > 0
    assert tr.metrics["dispatch_failures"] == {"raise": 1}
    assert {e[2][1] for e in _view(tr) if e[0] == "rejected"} == {
        "queue_full", "too_many_rows"}
    assert te.supervisor.snapshot() == je.supervisor.snapshot()
    assert _traced(ts) == _traced(js)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_breaker_opens_after_repeated_dispatch_failures(package):
    """tests/test_serving.py's breaker scenario, in both packages, with
    the same snapshot and rendered gauges."""
    serving, _, Plan = _pkgs()[0 if package == "jax" else 1]
    plan = Plan.from_spec("dispatch_raise@0;dispatch_raise@1")
    broke = []
    eng = serving.BatchingEngine(
        lambda a: [a[0] * 2],
        serving.EngineConfig(max_batch_size=2, max_wait_ms=0.0,
                             breaker_threshold=2),
        clock=serving.SimClock(), fault_plan=plan,
        on_break=lambda: broke.append(1))
    f1 = eng.submit([np.ones((1, 2), np.float32)])
    eng.pump()
    with pytest.raises(serving.DispatchFailedError):
        f1.result(timeout=0)
    assert not eng.broken
    f2 = eng.submit([np.ones((1, 2), np.float32)])
    eng.pump()
    with pytest.raises(serving.DispatchFailedError):
        f2.result(timeout=0)
    assert eng.broken and broke == [1]
    with pytest.raises(serving.RejectedError, match="circuit") as exc:
        eng.submit([np.ones((1, 2), np.float32)])
    assert exc.value.reason == "circuit_open"
    snap = eng.metrics.snapshot()
    assert snap["circuit_open"] is True
    assert snap["dispatch_failures"] == {"raise": 2}
    flat = serving.parse_exposition(eng.metrics.render())
    assert flat["pdtpu_serving_circuit_open"] == 1
    assert flat['pdtpu_serving_dispatch_failures_total{kind="raise"}'] == 2
    eng.stop(drain=False)


def test_port_refuses_what_waits_for_later_slices():
    from paddle_tpu_torch import serving
    with pytest.raises(NotImplementedError, match="item 9"):
        serving.EngineConfig(observatory=True)
    assert not hasattr(serving.BatchingEngine, "from_predictor")
    # the serving-observability slice landed: economics arms, and the
    # LLM exposition renders
    assert serving.EngineConfig(economics=True).economics is True
    flat = serving.parse_exposition(serving.LLMMetrics().render())
    assert flat["pdtpu_llm_tokens_total"] == 0
