"""Overload control of the port's LLMEngine against the JAX engine.

Both engines (gpt2-tiny weights bridged into the port, SimClocks) take the
same submissions under `default_slo`, an engine-wide token budget
(`max_inflight_tokens`), a per-tenant quota and brownout; the admitted,
shed and rejected requests with their reasons and `retry_after_s`, the
reject order (tenant quota, then shedding, then the reject), the brownout
entries and exits by queue depth, the capped `max_new_tokens`, the
in-flight token gauge and the streams must agree.
"""
import numpy as np
import pytest

from _torch_port import drain, engine_pair, one_torch_thread  # noqa: F401
from _torch_port import tiny_models

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE = dict(num_slots=2, block_len=8, n_blocks=4, prefill_chunk=16,
            enable_prefix_cache=False, retry_after_s=0.5)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def jax_steps():
    return {}


def _p(seed, n):
    return np.random.RandomState(seed).randint(1, 500, n).astype(np.int32)


def _submit(eng, out, seed, n, new, **kw):
    from paddle_tpu.serving import RejectedError as JaxRejected
    from paddle_tpu_torch.serving import RejectedError
    try:
        out.append(eng.submit(_p(seed, n), max_new_tokens=new, **kw))
    except (RejectedError, JaxRejected) as e:
        out.append(("rejected", e.reason, e.retry_after_s))
    snap = eng.metrics.snapshot()
    return (snap["queue_depth"], snap["inflight_tokens"], snap["brownout"])


def _budget(eng, out):
    """Queued before any step, each request its own tenant but "hog":
    best_effort by default, then a batch request; an interactive one over
    the budget sheds the newest best_effort; a best_effort one over it is
    rejected "token_budget"; hog's second request, over its quota, is
    rejected before anything is shed; a full queue sheds, then rejects
    "queue_full". Then the survivors run."""
    def sub(seed, n, new, **kw):
        kw.setdefault("tenant", f"t{seed}")
        return _submit(eng, out, seed, n, new, **kw)
    trail = [sub(i, 4, 8) for i in range(3)]
    trail.append(sub(3, 4, 8, slo="batch"))
    trail.append(sub(4, 4, 16, slo="interactive"))
    trail.append(sub(5, 4, 8))
    trail.append(sub(6, 4, 8, slo="interactive", tenant="hog"))
    trail.append(sub(7, 4, 8, slo="interactive", tenant="hog"))
    trail.append(sub(8, 2, 2, slo="batch"))
    trail.append(sub(9, 2, 2, slo="interactive"))
    trail.append(sub(10, 2, 2))
    drain(eng)
    return trail


def _brownout(eng, out):
    """Six requests queue; the fifth and sixth arrive in brownout and are
    capped. Admission drains the queue to half the threshold (exit); a
    second wave then enters brownout again."""
    trail = [_submit(eng, out, 20 + i, 3, 6) for i in range(6)]
    second = False
    while eng.has_work():
        eng.pump()
        snap = eng.metrics.snapshot()
        trail.append((snap["queue_depth"], snap["brownout"],
                      snap["brownout_entries"]))
        if not second and not snap["brownout"]:
            second = True
            trail += [_submit(eng, out, 30 + i, 3, 6) for i in range(5)]
    return trail


CASES = {
    "token_budget": (dict(default_slo="best_effort", max_inflight_tokens=60,
                          tenant_max_inflight_tokens=20,
                          max_queue_depth=5), _budget),
    "brownout": (dict(brownout_queue_depth=4, brownout_max_new_tokens=3),
                 _brownout),
}


def _outcome(h):
    if isinstance(h, tuple):
        return h
    exc = h.future.exception(timeout=0)
    if exc is None:
        return ("completed", h.max_new_tokens, h.slo, h.tokens_so_far())
    return (type(exc).__name__, getattr(exc, "reason", None),
            getattr(exc, "retry_after_s", None), h.slo)


@pytest.mark.parametrize("case", sorted(CASES))
def test_overload_matches_jax_engine(models, jax_steps, case):
    over, run = CASES[case]
    je, te = engine_pair(*models, {**BASE, **over}, jax_steps=jax_steps)
    jh, th = [], []
    jt, tt = run(je, jh), run(te, th)
    assert tt == jt
    got = [_outcome(h) for h in th]
    assert got == [_outcome(h) for h in jh]
    js, ts = je.metrics.snapshot(), te.metrics.snapshot()
    for k in ("shed", "rejected", "completed", "brownout_entries",
              "brownout", "inflight_tokens", "classes", "submitted"):
        assert ts[k] == js[k], (k, js[k], ts[k])
    assert te.metrics.reject_reasons == je.metrics.reject_reasons
    assert te.pool.check_balance() and je.pool.check_balance()
    reasons = {o[1] for o in got if o[0] in ("rejected",
                                             "RejectedError")}
    if case == "token_budget":
        assert reasons == {"shed", "token_budget", "tenant_quota",
                           "queue_full"}
        assert all(o[2] == 0.5 for o in got
                   if o[0] in ("rejected", "RejectedError"))
        # default_slo: the first request named no class and was shed as
        # best_effort
        assert got[0] == ("RejectedError", "shed", 0.5, "best_effort")
    else:
        assert ts["brownout_entries"] == 2
        assert {o[1] for o in got if o[0] == "completed"} == {6, 3}


def test_default_slo_is_validated_as_in_jax():
    from paddle_tpu.serving.llm import LLMEngineConfig as JaxConfig
    from paddle_tpu_torch.serving.llm import LLMEngineConfig
    for cls in (JaxConfig, LLMEngineConfig):
        with pytest.raises(ValueError, match="default_slo"):
            cls(default_slo="gold")
        with pytest.raises(ValueError, match="brownout_max_new_tokens"):
            cls(brownout_max_new_tokens=0)
        with pytest.raises(ValueError, match="retry counts"):
            cls(dispatch_retries=-1)
        with pytest.raises(ValueError, match="breaker_threshold"):
            cls(breaker_threshold=0)
