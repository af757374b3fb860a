"""Serving supervision of the port's LLMEngine against the JAX engine.

Each case runs one of the JAX package's supervision scenarios (its fault
spec, engine configuration and prompts, from tests/test_llm_engine.py,
tests/test_paged_attention.py and tests/test_prefix_cache.py) through
both engines on SimClocks, gpt2-tiny weights bridged into the port, and
compares: the streams, each failed handle's reason and partial tokens,
rejects, `plan.log`, `supervisor.snapshot()`, the supervision metrics,
the order of the flight-recorder events, and the pool ledger.

Then what the JAX engine cannot show, because its step is functional:
- the write fence: a step attempt really abandoned by the 0.05 s
  watchdog on a MonotonicClock (held at layer 1 of 2 after layer 0 wrote
  its stripe) stops at its next KV write once the engine has retried and
  run on, and the slabs and stream equal a fault-free engine's; with the
  fence's check made a no-op the same run corrupts committed KV;
- a blame probe's masking: after a decode-scoped quarantine each
  survivor's KV is bit-equal to a fault-free run's; with the probe's
  other rows masked as the JAX engine masks them (pos 0) the same run
  overwrites the survivors' positions 0..C-1.
"""
import threading
import time

import numpy as np
import pytest

from _torch_port import drain, engine_pair, one_torch_thread  # noqa: F401
from _torch_port import tiny_models

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SUP = dict(num_slots=2, block_len=8, n_blocks=4)
PROBE = dict(SUP, num_slots=3, prefill_chunk=4)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def jax_steps():
    return {}


def _ar(a, b):
    return np.arange(a, b, dtype=np.int32)


def _submit(eng, prompt, n, out):
    """Submit, keeping the handle or the reject (reason, retry_after_s)."""
    from paddle_tpu.serving import RejectedError as JaxRejected
    from paddle_tpu_torch.serving import RejectedError
    try:
        out.append(eng.submit(prompt, max_new_tokens=n))
    except (RejectedError, JaxRejected) as e:
        out.append(("rejected", e.reason, e.retry_after_s))


def _two(prompts, n):
    def run(eng, out):
        for p in prompts:
            _submit(eng, p, n, out)
        drain(eng)
    return run


def _breaker(eng, out):
    """test_llm_engine.py's breaker scenario: two unattributable decode
    failures at threshold 2."""
    for i in range(2):
        _submit(eng, [i + 1, i + 2], 4, out)
    eng.pump()
    eng.pump()
    for i in range(2):
        _submit(eng, [i + 5, i + 6], 4, out)
    eng.pump()
    eng.pump()
    _submit(eng, [9], 2, out)


def _chunked(eng, out):
    """test_paged_attention.py's: a poisoned prefill chunk beside an
    innocent decode row."""
    _submit(eng, _ar(1, 4), 6, out)
    eng.pump()
    _submit(eng, _ar(10, 20), 4, out)
    drain(eng)


def _sibling(eng, out):
    """test_prefix_cache.py's: two requests attach one cached prefix; the
    poisoned one is quarantined mid-decode; a later request still attaches
    the shared blocks."""
    rng = np.random.RandomState(3)
    shared = rng.randint(1, 500, size=32).astype(np.int32)
    ps = [np.concatenate([shared, rng.randint(1, 500, size=8)
                          .astype(np.int32)]) for _ in range(4)]
    _submit(eng, ps[0], 2, out)
    drain(eng)
    _submit(eng, ps[1], 6, out)
    _submit(eng, ps[2], 6, out)
    drain(eng)
    _submit(eng, ps[3], 6, out)
    drain(eng)


CASES = {
    "raise_mid_decode": ("dispatch_raise@3", SUP,
                         _two([_ar(1, 5), _ar(11, 15)], 6)),
    "hang": ("dispatch_hang@1:30.0", {**SUP, "num_slots": 1},
             _two([_ar(1, 7)], 5)),
    "poisoned_prefill": ("poison_request@0", SUP,
                         _two([_ar(1, 5), _ar(21, 25)], 4)),
    "poisoned_decode": ("poison_request@1:decode", SUP,
                        _two([_ar(1, 5), _ar(11, 15)], 6)),
    "breaker": ("dispatch_raise@1;dispatch_raise@2;dispatch_raise@3;"
                "dispatch_raise@5;dispatch_raise@6;dispatch_raise@7",
                {**SUP, "dispatch_retries": 0, "breaker_threshold": 2},
                _breaker),
    "poisoned_chunk_beside_decode": (
        "poison_request@1", dict(num_slots=2, block_len=8, n_blocks=4,
                                 prefill_chunk=4, dispatch_retries=0),
        _chunked),
    "poisoned_sibling_shared_blocks": (
        "poison_request@2:decode", dict(num_slots=4, block_len=8,
                                        n_blocks=6, prefill_chunk=16),
        _sibling),
}

METRIC_KEYS = ("dispatch_failures", "quarantined", "completed", "failed",
               "submitted", "rejected", "circuit_open", "prefix_hits",
               "decode_steps", "tokens_out")
EVENT_DROP = ("t_mono", "t_wall", "seq", "rid")


def _outcome(h):
    """What a handle (or a reject) ended as."""
    if isinstance(h, tuple):
        return h
    exc = h.future.exception(timeout=0)
    if exc is None:
        return ("completed", h.tokens_so_far())
    return (type(exc).__name__, getattr(exc, "reason", None),
            h.tokens_so_far())


def _events(fr):
    return [{k: v for k, v in e.items() if k not in EVENT_DROP}
            for e in fr().snapshot()["events"]]


@pytest.mark.parametrize("case", sorted(CASES))
def test_supervision_matches_jax_engine(models, jax_steps, case):
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    spec, cfg, run = CASES[case]
    trips = ([], [])
    je, te = engine_pair(*models, cfg, fault_plan=spec, jax_steps=jax_steps,
                         on_break=(lambda: trips[0].append(1),
                                   lambda: trips[1].append(1)))
    jfr().clear()
    tfr().clear()
    jh, th = [], []
    run(je, jh)
    run(te, th)
    assert [_outcome(h) for h in th] == [_outcome(h) for h in jh]
    assert te.plan.log == je.plan.log and te.plan.log
    assert te.supervisor.snapshot() == je.supervisor.snapshot()
    js, ts = je.metrics.snapshot(), te.metrics.snapshot()
    for k in METRIC_KEYS:
        assert ts[k] == js[k], (k, js[k], ts[k])
    assert te.metrics.reject_reasons == je.metrics.reject_reasons
    assert te.broken == je.broken and trips[1] == trips[0]
    assert te._dispatch_idx == je._dispatch_idx
    assert te.pool.check_balance() and je.pool.check_balance()
    assert te.pool.active_slots() == je.pool.active_slots() == 0
    assert te.pool.refcount == je.pool.refcount
    je.stop()
    te.stop()
    assert _events(tfr) == _events(jfr)
    if case == "breaker":
        assert te.broken and trips[1] == [1]
        assert ts["circuit_open"] is True and ts["failed"] == 4
    elif case != "raise_mid_decode" and case != "hang":
        assert ts["quarantined"] == 1 and not te.broken


# ---- the write fence ----

FENCE = dict(num_slots=1, block_len=8, n_blocks=4, prefill_chunk=4,
             max_new_tokens=20, enable_prefix_cache=False)
FENCE_PROMPT = _ar(3, 8)
GATED_STEP = 3       # the first attempt of the step after 3 committed
WAIT_S = 10.0


def _fault_free(tm):
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    eng = LLMEngine(tm, LLMEngineConfig(**FENCE), clock=SimClock())
    h = eng.submit(FENCE_PROMPT)
    drain(eng)
    return eng, h.result(0)


def _abandoned_run(tm):
    """The threaded engine with the watchdog at 0.05 s. A pre-hook on
    layer 1 holds the first attempt of step GATED_STEP (layer 0 has
    written its stripe); the watchdog abandons it, the retry commits, the
    engine runs 3 more steps, then the hook lets the attempt go on.
    Returns (engine, stream, the held attempt's write token, the steps
    committed when it was let go)."""
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    eng = LLMEngine(tm, LLMEngineConfig(**FENCE, dispatch_timeout_s=0.05))
    gate, held = threading.Event(), threading.Event()
    box = {}

    def hold(module, args):
        if not held.is_set() and eng.steps >= GATED_STEP:
            box["fence"] = attention._KV_GUARD.guard
            box["step"] = eng.steps
            held.set()
            gate.wait(WAIT_S)

    hook = tm.gpt.layers[1].register_forward_pre_hook(hold)
    try:
        eng.start()
        h = eng.submit(FENCE_PROMPT)
        assert held.wait(WAIT_S)
        t0 = time.monotonic()
        while eng.steps < box["step"] + 4 and not h.future.done():
            assert time.monotonic() - t0 < WAIT_S
            time.sleep(0.005)
        let_go = eng.steps
        gate.set()
        out = h.result(WAIT_S)
        for t in threading.enumerate():
            if t.name == "pdtt-llm-dispatch":
                t.join(WAIT_S)
    finally:
        gate.set()
        hook.remove()
        eng.stop(drain=True, timeout=WAIT_S)
    return eng, out, box, let_go


def _committed_kv(eng, n, slot=0):
    """A slot's K and V stripes at positions 0..n-1 of every layer."""
    return [(k[slot, :, :n].clone(), v[slot, :, :n].clone())
            for k, v in eng.pool.slabs]


def test_fence_stops_abandoned_attempt(models):
    _, tm = models
    ref_eng, ref = _fault_free(tm)
    eng, out, box, let_go = _abandoned_run(tm)
    fence = box["fence"]
    assert fence in eng.abandoned_attempts and fence.revoked
    assert let_go >= box["step"] + 4            # retry + 3 more steps
    assert fence.stopped.wait(WAIT_S)           # it reached its next write
    from paddle_tpu_torch.serving.llm.llm_engine import _AttemptRevoked
    assert isinstance(fence.error, _AttemptRevoked)
    assert eng.supervisor.snapshot()["watchdog_fires"] >= 1
    assert eng.metrics.snapshot()["dispatch_failures"]["hang"] >= 1
    np.testing.assert_array_equal(out, ref)
    n = len(FENCE_PROMPT) + len(out) - 1        # committed positions
    for (k, v), (rk, rv) in zip(_committed_kv(eng, n),
                                _committed_kv(ref_eng, n)):
        assert torch_equal(k, rk) and torch_equal(v, rv)


def test_without_the_fence_the_abandoned_write_corrupts_kv(models,
                                                           monkeypatch):
    """The control: the same run with the fence's check a no-op. The held
    attempt then writes its old C-wide stripe at layer 1 over positions
    the later steps committed."""
    from paddle_tpu_torch.serving.llm import llm_engine
    monkeypatch.setattr(llm_engine._WriteFence, "check", lambda self: None)
    _, tm = models
    ref_eng, ref = _fault_free(tm)
    eng, out, box, _ = _abandoned_run(tm)
    assert box["fence"].error is None
    n = len(FENCE_PROMPT) + len(out) - 1
    got, want = _committed_kv(eng, n), _committed_kv(ref_eng, n)
    assert torch_equal(got[0][0], want[0][0])   # layer 0: same values
    assert not (torch_equal(got[1][0], want[1][0])
                and torch_equal(got[1][1], want[1][1]))


def torch_equal(a, b):
    import torch
    return bool(torch.equal(a, b))


# ---- the blame probe's masking ----

def _probe_run(tm):
    """(fault-free engine, its handles, supervised engine, its handles) of
    poison_request@2:decode over three prompts: slots 0 and 1 survive."""
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.utils.fault_injection import FaultPlan
    runs = []
    for spec in ("", "poison_request@2:decode"):
        eng = LLMEngine(tm, LLMEngineConfig(**PROBE), clock=SimClock(),
                        fault_plan=FaultPlan.from_spec(spec))
        hs = [eng.submit(p, max_new_tokens=6) for p in PROBE_PROMPTS]
        drain(eng)
        runs += [eng, hs]
    return runs


PROBE_PROMPTS = [_ar(1, 5), _ar(11, 15), _ar(21, 25)]


def _survivor_kv_equal(eng, hs, ref, n_of):
    return [all(torch_equal(k, rk) and torch_equal(v, rv)
                for (k, v), (rk, rv) in zip(_committed_kv(eng, n_of(s), s),
                                            _committed_kv(ref, n_of(s), s)))
            for s in (0, 1)]


def test_probe_leaves_survivor_kv_bit_equal(models):
    """poison_request@2:decode: each survivor's probe runs the step with
    the other survivor masked, after both committed their prompts and
    first tokens. Every survivor's committed KV equals a fault-free run's,
    bit for bit, and so do their streams."""
    ref, rh, eng, hs = _probe_run(models[1])
    assert eng.metrics.snapshot()["quarantined"] == 1
    assert hs[2].future.exception(0).reason == "poisoned"
    for s in (0, 1):
        np.testing.assert_array_equal(hs[s].result(0), rh[s].result(0))
    n_of = lambda s: len(PROBE_PROMPTS[s]) + len(rh[s].result(0)) - 1  # noqa
    assert min(n_of(0), n_of(1)) >= eng.config.prefill_chunk
    assert _survivor_kv_equal(eng, hs, ref, n_of) == [True, True]


def test_jax_probe_masking_would_overwrite_survivor_kv(models, monkeypatch):
    """The control: probes masked as the JAX engine masks them (pos 0)
    write token 0's stripe over the other survivor's positions 0..C-1."""
    from paddle_tpu_torch.serving.llm import LLMEngine
    probe_rows = LLMEngine._probe_rows

    def jax_masking(self, args, slot):
        toks, pos, adv = probe_rows(self, args, slot)
        pos[np.arange(len(pos)) != slot] = 0
        return toks, pos, adv

    monkeypatch.setattr(LLMEngine, "_probe_rows", jax_masking)
    ref, rh, eng, hs = _probe_run(models[1])
    C = eng.config.prefill_chunk
    assert _survivor_kv_equal(eng, hs, ref, lambda s: C) == [False, False]
