"""Serving observability of the port against the JAX package's: the
economics ledger, the SLO burn monitor, `LLMMetrics.render`, request
timelines in `LLMEngine`, and `BatchingEngine(economics=True)`.

- `ServingLedger` and `SLOBurnMonitor`: both packages' take the same
  `book` / `book_dispatch` / `observe` sequence on a scripted clock; the
  snapshots and the `slo_burn` flight events must be equal exactly (the
  same float operations in the same order).
- `LLMMetrics.render()` and `ServingMetrics.render()` with the providers
  attached: the same hook calls (the clock is the caller's, so nothing
  reads the wall clock) give the same text, family by family: names,
  types, label sets, order and values.
- `LLMEngine(economics=True)` with traced requests, two tenants and two
  SLO classes, through `engine_pair` on SimClocks advanced alike between
  pumps (a dispatch then spans 0 s on both sides): after a drain the
  ledger snapshots (token economics, per-owner token counters, phases),
  the burn monitors' snapshots and fired records, the economics
  exposition lines and every timeline's event names, marks and outcome
  are equal exactly.
- Through an abandoned (hung) attempt, a raised one and a quarantine:
  one timeline a request, its events in time order, concluded once, equal
  to the JAX engine's; the ledgers equal.
- A disarmed port engine builds no ledger and reads its clock as often as
  the engine before the ledger was ported (33 reads in the scenario
  below, counted on that engine).
- `BatchingEngine(economics=True)` on a replayed trace: the ledger
  snapshots are equal.
"""
import numpy as np
import pytest

from _torch_port import drain, engine_pair, one_torch_thread  # noqa: F401
from _torch_port import tiny_models

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EVENT_DROP = ("t_mono", "t_wall", "seq")


class _Clock:
    """A scripted clock: `now()` returns `t`, which the test moves."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _ledger_run(mod):
    clk = _Clock()
    led = mod.ServingLedger(clock=clk)
    led.set_decode_flops(2.0e6, 1.0e12)
    with led.measure("host"):
        clk.t += 0.5
        led.book_dispatch(0.25, prefill_positions=24, decode_positions=3,
                          total_positions=64,
                          owners=[("a", "interactive", 16),
                                  ("b", "batch", 8), ("a", "interactive", 1),
                                  ("b", "batch", 2)])
        led.book("sample_mask", 0.015625)
        clk.t += 0.25
    clk.t += 1.0
    with led.measure("host"):
        with led.measure("kv_onboard"):
            clk.t += 0.125
        led.book_dispatch(0.375, prefill_positions=0, decode_positions=5,
                          total_positions=64,
                          owners=[("a", "batch", 3), ("c", "batch", 2)],
                          adapter_owners=[("base", 3), ("ad1", 2)])
        led.book_dispatch(0.0625, prefill_positions=0, decode_positions=0,
                          total_positions=8, owners=[("a", "batch", 4)],
                          draft_positions=4)
        led.book_dispatch(0.03125, 0, 0, 64, owners=[])
        clk.t += 0.75
    clk.t += 0.5
    return led.snapshot()


def test_serving_ledger_matches_jax():
    import paddle_tpu.obs.serving_ledger as jl
    import paddle_tpu_torch.obs.serving_ledger as tl
    assert tl.SERVING_LEDGER_PHASES == jl.SERVING_LEDGER_PHASES
    js, ts = _ledger_run(jl), _ledger_run(tl)
    assert ts == js
    assert ts["decode_tokens"] == 8 and ts["draft_positions"] == 4
    assert ts["tenants"]["c"]["device_seconds"] > 0
    assert abs(sum(ts["phase_seconds"].values())
               - ts["wall_seconds"]) < 1e-12


def _burn_run(mod, fr, capture_path):
    fr().clear()
    clk = _Clock()
    mon = mod.SLOBurnMonitor(clock=clk, budget=0.1, threshold=5.0,
                             fast_window_s=2.0, slow_window_s=6.0,
                             min_events=3, capture_s=1.5,
                             capture_path=capture_path)
    snaps = []
    for i in range(24):
        clk.t += 0.375
        cls = ("interactive", "batch")[i % 2]
        good = i < 6 or (cls == "batch" and i % 4 != 1)
        mon.observe(cls, good, outcome="ttft")
        if i % 5 == 0:
            snaps.append(mon.snapshot())
    events = [{k: v for k, v in e.items() if k not in EVENT_DROP
               and k != "path"}
              for e in fr().snapshot()["events"]
              if e["kind"].startswith("slo_burn")]
    return snaps, events


def test_slo_burn_monitor_matches_jax(tmp_path):
    import paddle_tpu.obs.serving_ledger as jl
    import paddle_tpu_torch.obs.serving_ledger as tl
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    js, je = _burn_run(jl, jfr, str(tmp_path / "jax.json"))
    ts, te = _burn_run(tl, tfr, str(tmp_path / "port.json"))
    assert ts == js and te == je
    kinds = [e["kind"] for e in te]
    assert kinds == ["slo_burn", "slo_burn_capture"], kinds
    assert te[0]["slo"] == "interactive" and te[0]["capture_s"] == 1.5
    assert (tmp_path / "port.json").exists()
    for kw in (dict(budget=0.0), dict(threshold=0.0),
               dict(fast_window_s=5.0, slow_window_s=1.0),
               dict(min_events=0)):
        with pytest.raises(ValueError) as jerr:
            jl.SLOBurnMonitor(**kw)
        with pytest.raises(ValueError) as terr:
            tl.SLOBurnMonitor(**kw)
        assert str(terr.value) == str(jerr.value)


def _feed_metrics(mod, serving_mod):
    """One hook sequence through an LLMMetrics and a ServingMetrics of
    `serving_mod`, with `mod`'s ledger and burn monitor attached; returns
    both renders."""
    clk = _Clock()
    m = serving_mod.LLMMetrics()
    m.ledger = mod.ServingLedger(clock=clk)
    m.ledger.set_decode_flops(2.0e6, 1.0e12)
    m.burn = mod.SLOBurnMonitor(clock=clk, min_events=1)
    m.set_slots(0, 4)
    m.observe_occupancy(clk.t)
    for i in range(6):
        cls = ("interactive", "batch", "best_effort")[i % 3]
        ten = ("t0", "t1")[i % 2]
        m.on_submit(i + 1, slo=cls, tenant=ten)
        m.on_prefix_lookup(ten, 8 * (i % 2), 16)
        m.set_slots(min(i + 1, 4), 4)
        clk.t += 0.25
        m.observe_occupancy(clk.t)
        m.on_prefill(10.0 + 7 * i, slo=cls)
        m.burn.observe(cls, i % 3 != 1, outcome="ttft")
        with m.ledger.measure("host"):
            clk.t += 0.125
            m.ledger.book_dispatch(0.0625, prefill_positions=16,
                                   decode_positions=i, total_positions=64,
                                   owners=[(ten, cls, 16 + i)])
        m.on_decode_step(i + 1, 3.5 + i, tokens=i + 1)
        m.on_sample_token(("sampled", "constrained")[i % 2])
        m.on_mask_overhead(0.25 * i)
    m.set_sample_slots({"greedy": 2, "sampled": 1, "constrained": 1})
    m.set_grammars(2)
    m.on_complete(50.0, slo="interactive", tenant="t0")
    m.on_reject("shed", tenant="t1")
    m.on_shed("best_effort")
    m.on_reject("token_budget")
    m.on_expire(2)
    m.on_fail()
    m.on_quarantine()
    m.on_dispatch_failure("raise")
    m.set_circuit_open(True)
    m.set_brownout(True)
    m.set_inflight_tokens(321)
    m.set_fragmentation(0.375)
    m.set_tenant_inflight({"t0": 100})
    m.set_prefix_cache(5, 2, {"t0": 3, "t1": 2})
    m.set_host_kv(dict(pages=3, bytes=4096, spills=4, onboards=1,
                       evictions=1, hits=1, misses=2, rejected=0))
    s = serving_mod.ServingMetrics()
    s.ledger = mod.ServingLedger(clock=clk)
    with s.ledger.measure("host"):
        s.on_submit(1)
        clk.t += 0.5
        s.ledger.book_dispatch(0.25, prefill_positions=3,
                               decode_positions=0, total_positions=4,
                               owners=())
        s.on_dispatch(3, 2, 4, 2.5, 0)
        s.on_complete(4.0)
    clk.t += 0.25
    return m.render(), s.render()


def _families(text):
    """[(name, type, [(sample name, sorted label keys, value text)])] in
    render order."""
    fams = []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ")
            fams.append((name, typ, []))
        else:
            head, _, val = line.rpartition(" ")
            name, _, labels = head.partition("{")
            keys = sorted(kv.split("=")[0] for kv in labels.rstrip("}")
                          .split(",") if kv)
            fams[-1][2].append((name, keys, val))
    return fams


def test_llm_metrics_render_matches_jax():
    import paddle_tpu.obs.serving_ledger as jl
    import paddle_tpu.serving as jserving
    import paddle_tpu_torch.obs.serving_ledger as tl
    import paddle_tpu_torch.serving as tserving
    jr, jsr = _feed_metrics(jl, jserving)
    tr, tsr = _feed_metrics(tl, tserving)
    assert _families(tr) == _families(jr)
    assert tr == jr and tsr == jsr
    names = [f[0] for f in _families(tr)]
    for fam in ("pdtpu_llm_ttft_ms", "pdtpu_llm_slot_occupancy_avg",
                "pdtpu_llm_kv_fragmentation", "pdtpu_llm_class_ttft_ms",
                "pdtpu_llm_spec_windows_total", "pdtpu_llm_decode_mfu",
                "pdtpu_llm_tenant_device_seconds_total",
                "pdtpu_llm_slo_burn_rate", "pdtpu_llm_kv_host_pages_total"):
        assert fam in names, fam
    assert "pdtpu_serving_token_efficiency" in [f[0] for f in
                                                _families(tsr)]


# ---- the engines ----

OBS = dict(num_slots=2, block_len=8, n_blocks=6, prefill_chunk=8,
           economics=True, slo_burn_min_events=2, slo_burn_threshold=10.0,
           slo_ttft_target_ms={"interactive": 25.0, "batch": 1000.0},
           enable_prefix_cache=True)
TICK_S = 0.01
ECON_FAMILIES = ("phase_seconds_total", "wall_seconds", "token_efficiency",
                 "host_fraction", "decode_mfu", "tenant_device_seconds_total",
                 "tenant_device_tokens_total", "class_device_seconds_total",
                 "class_device_tokens_total", "slo_burn_rate",
                 "slo_burn_fired")


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def jax_steps():
    return {}


def _observed_run(eng):
    """Six traced requests of two tenants and two classes (the second
    prompt shares the first's prefix), the engine pumped to drain with its
    SimClock advanced TICK_S before every pump."""
    base = np.arange(3, 28, dtype=np.int32)
    prompts = [base, np.r_[base[:16], 60:66], base + 40, base[:9] + 90,
               base[:12] + 7, base[:18] + 1]
    hs = []
    for i, p in enumerate(prompts):
        hs.append(eng.submit(p.astype(np.int32), max_new_tokens=4 + i % 3,
                             slo=("interactive", "batch")[i % 2],
                             tenant=("t0", "t1")[i % 3 == 2], trace=True))
    while eng.has_work():
        eng.clock.advance(TICK_S)
        eng.pump()
    return hs


def _econ_lines(text):
    px = "pdtpu_llm_"
    return [ln for ln in text.splitlines()
            if any(ln.split(" ")[-2 if ln.startswith("#") else 0]
                   .split("{")[0] == px + f for f in ECON_FAMILIES)]


def _timeline(h):
    tl = h.timeline()
    return (tl["outcome"], sorted(tl["marks_ms"]), tl["marks_ms"],
            [e["name"] for e in tl["events"]], tl["ttft_ms"],
            [p["name"] for p in tl["phases"]])


def test_engine_economics_and_timelines_match_jax(models, jax_steps):
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    jm, tm = models
    je, te = engine_pair(jm, tm, OBS, jax_steps=jax_steps)
    jfr().clear()
    tfr().clear()
    jh, th = _observed_run(je), _observed_run(te)
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(b.result(0), a.result(0))
        assert _timeline(b) == _timeline(a)
    js, ts = je.ledger.snapshot(), te.ledger.snapshot()
    assert ts == js
    assert ts["decode_tokens"] == te.metrics.snapshot()["tokens_out"]
    assert ts["prefill_tokens"] == te.prefill_tokens
    assert ts["total_positions"] == te.steps * 2 * 8
    assert set(ts["tenants"]) == {"t0", "t1"}
    assert te.burn.snapshot() == je.burn.snapshot()
    fired = te.burn.snapshot()["fired"]
    assert set(fired) == {"interactive"}, fired
    assert _econ_lines(te.metrics.render()) == _econ_lines(
        je.metrics.render())
    assert te.metrics.snapshot()["slot_occupancy_avg"] == \
        je.metrics.snapshot()["slot_occupancy_avg"]

    def burns(fr):
        return [{k: v for k, v in e.items() if k not in EVENT_DROP}
                for e in fr().snapshot()["events"] if e["kind"] == "slo_burn"]
    assert burns(tfr) == burns(jfr) and len(burns(tfr)) == 1
    assert sorted(te.timelines.ids()) == sorted(h.rid for h in th)
    for h in th:
        tl = te.timelines.get(h.rid)
        assert tl["outcome"] == "completed"
        assert sum(p["dur_ms"] for p in tl["phases"]) == \
            pytest.approx(tl["latency_ms"], abs=1e-9)
        m = tl["marks_ms"]
        assert m["submitted"] < m["admitted"] <= m["first_token"] <= \
            m["finished"]
    assert te.pool.check_balance()


def test_traced_requests_through_supervision_match_jax(models, jax_steps):
    """A hung (abandoned) attempt, a raised one and a quarantine: every
    request keeps one timeline, its events in time order, concluded once,
    with the JAX engine's event names and outcomes."""
    jm, tm = models
    spec = "dispatch_hang@2:30.0;dispatch_raise@4;poison_request@1:decode"
    je, te = engine_pair(jm, tm, dict(num_slots=2, block_len=8, n_blocks=6,
                                      prefill_chunk=8, economics=True),
                         fault_plan=spec, jax_steps=jax_steps)
    hs = {}
    for name, eng in (("jax", je), ("port", te)):
        hs[name] = [eng.submit(np.arange(3, 14, dtype=np.int32) + 5 * i,
                               max_new_tokens=5, trace=True)
                    for i in range(3)]
        while eng.has_work():
            eng.clock.advance(TICK_S)
            eng.pump()
    assert te.plan.log == je.plan.log and len(te.plan.log) == 3
    assert te.abandoned_attempts and te.abandoned_attempts[0].revoked
    for a, b in zip(hs["jax"], hs["port"]):
        assert _timeline(b) == _timeline(a)
        ts = [e["t_ms"] for e in b.timeline()["events"]]
        assert ts == sorted(ts)
    outcomes = [h.timeline()["outcome"] for h in hs["port"]]
    assert outcomes == ["completed", "quarantined", "completed"], outcomes
    assert len(te.timelines) == 3
    assert te.ledger.snapshot() == je.ledger.snapshot()


def test_engine_config_validates_observability_fields_as_jax():
    from paddle_tpu.serving.llm import LLMEngineConfig as JaxConfig
    from paddle_tpu_torch.serving.llm import LLMEngineConfig
    for kw in (dict(trace_buffer=0), dict(slo_burn_budget=1.5),
               dict(slo_burn_threshold=-1.0),
               dict(slo_burn_fast_window_s=9.0, slo_burn_slow_window_s=3.0),
               dict(slo_burn_min_events=0),
               dict(slo_ttft_target_ms={"gold": 5.0}),
               dict(slo_ttft_target_ms={"batch": 0.0})):
        with pytest.raises(ValueError) as jerr:
            JaxConfig(**kw)
        with pytest.raises(ValueError) as terr:
            LLMEngineConfig(**kw)
        assert str(terr.value) == str(jerr.value), kw


class _CountingClock:
    """A SimClock that counts `now()` reads."""

    def __new__(cls):
        from paddle_tpu_torch.serving.clock import SimClock

        class Counting(SimClock):
            reads = 0

            def now(self):
                self.reads += 1
                return super().now()
        return Counting()


def test_disarmed_engine_builds_no_ledger_nor_reads_the_clock_more():
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    m = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                   num_hidden_layers=1)
    clk = _CountingClock()
    eng = LLMEngine(m, LLMEngineConfig(num_slots=2, block_len=8, n_blocks=4,
                                       prefill_chunk=8), clock=clk)
    assert eng.ledger is None and eng.burn is None
    assert eng.metrics.ledger is None and eng.metrics.burn is None
    hs = [eng.submit(np.arange(1, 12, dtype=np.int32) + i, max_new_tokens=4)
          for i in range(3)]
    while eng.has_work():
        clk.advance(0.01)
        eng.pump()
    assert all(h.trace is None and h.timeline() is None for h in hs)
    assert len(eng.timelines) == 0
    # the engine before the ledger was ported read its clock 33 times
    assert clk.reads == 33
    assert "pdtpu_llm_phase_seconds_total" not in eng.metrics.render()


def _batch_replay(serving, fr, Plan):
    fr().clear()
    cfg = serving.EngineConfig(max_batch_size=8, max_wait_ms=2.0,
                               economics=True)

    def predict(args):
        return [args[0] * 2.0]
    eng = serving.BatchingEngine(predict, cfg, clock=serving.SimClock(),
                                 fault_plan=Plan.from_spec(
                                     "dispatch_raise@1"))
    trace = serving.poisson_trace(
        20, rate_hz=3000.0, seed=3,
        make_inputs=lambda i: [np.full((1 + i % 3, 2), i, np.float32)])
    report = serving.replay(eng, trace)
    return eng, report


def test_batching_engine_economics_matches_jax():
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu.utils.fault_injection import FaultPlan as JPlan
    import paddle_tpu.serving as jserving
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    from paddle_tpu_torch.utils.fault_injection import FaultPlan as TPlan
    import paddle_tpu_torch.serving as tserving
    je, jrep = _batch_replay(jserving, jfr, JPlan)
    te, trep = _batch_replay(tserving, tfr, TPlan)
    assert trep.outcomes == jrep.outcomes
    js, ts = je.ledger.snapshot(), te.ledger.snapshot()
    assert ts == js
    assert ts["dispatches"] == te.metrics.snapshot()["dispatches"]
    assert ts["useful_positions"] < ts["total_positions"]
    assert te.metrics.render() == je.metrics.render()
