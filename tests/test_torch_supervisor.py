"""The port's EngineSupervisor against the JAX one.

The same call sequences go through both packages' supervisors: the
typed errors, their reasons, the stats, the breaker protocol (threshold,
absolve, exempt failures, on_trip once) and the snapshots must agree;
so must the flight-recorder events each records. The wall-clock watchdog
runs in both over an Event-gated callable with a 0.05 s budget.
"""
import threading

import pytest

from _torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _packages():
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu.serving import supervisor as jsup
    from paddle_tpu.utils import fault_injection as jfi
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    from paddle_tpu_torch.serving import supervisor as tsup
    from paddle_tpu_torch.utils import fault_injection as tfi
    return (jsup, jfi, jfr), (tsup, tfi, tfr)


def _boom(exc):
    def fn():
        raise exc
    return fn


def _script(sup_mod, fi_mod, trips):
    """One call sequence: (outcome, reason or value) of each step, the
    stats after it, and the snapshot at the end."""
    sup = sup_mod.EngineSupervisor(breaker_threshold=2, name="llm",
                                   on_trip=lambda: trips.append(1))
    calls = [
        ("run", lambda: 42, {}),
        ("run", _boom(ValueError("boom")), {}),
        ("run", _boom(fi_mod.InjectedDispatchHang(3.0)), {}),
        ("run", _boom(RuntimeError("draft")), {"exempt": True}),
        ("record_failure",), ("record_success",), ("record_failure",),
        ("absolve",), ("record_failure",), ("record_failure",),
        ("record_failure",), ("run", lambda: 7, {"label": "decode"}),
    ]
    log = []
    for c in calls:
        if c[0] == "run":
            try:
                log.append(("ok", sup.run(c[1], **c[2])))
            except sup_mod.DispatchFailedError as e:
                log.append((type(e).__name__, e.reason,
                            type(e.__cause__).__name__))
        else:
            log.append((c[0], getattr(sup, c[0])()))
        log.append(dict(sup.stats))
    return log, sup.snapshot(), sup.open


def test_call_sequences_match_jax():
    (jsup, jfi, jfr), (tsup, tfi, tfr) = _packages()
    jfr().clear()
    tfr().clear()
    jt, tt = [], []
    jlog, jsnap, jopen = _script(jsup, jfi, jt)
    tlog, tsnap, topen = _script(tsup, tfi, tt)
    assert tlog == jlog
    assert tsnap == jsnap and topen == jopen is True
    assert tt == jt == [1]               # on_trip fired exactly once
    assert tsnap["exempt_failures"] == 1 and tsnap["quarantines"] == 1

    def kinds(fr):
        return [(e["kind"], e.get("label"), e.get("exempt"))
                for e in fr().snapshot()["events"]]
    assert kinds(tfr) == kinds(jfr)
    assert [k for k, _, _ in kinds(tfr)] == [
        "dispatch_failure", "dispatch_hang", "dispatch_failure",
        "breaker_absolved", "breaker_open"]


def test_threshold_validation_matches_jax():
    (jsup, _, _), (tsup, _, _) = _packages()
    for mod in (jsup, tsup):
        with pytest.raises(ValueError, match="breaker_threshold"):
            mod.EngineSupervisor(breaker_threshold=0)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_wall_clock_watchdog_abandons_hung_dispatch(package):
    """A dispatch blocked on an Event past a 0.05 s budget raises
    DispatchHungError; the supervisor then serves a healthy dispatch, and
    the abandoned worker finishes once the gate opens."""
    pk = _packages()[0 if package == "jax" else 1]
    sup_mod = pk[0]
    release, finished = threading.Event(), threading.Event()

    def hung():
        release.wait(5)
        finished.set()
        return 0

    sup = sup_mod.EngineSupervisor(dispatch_timeout_s=0.05, name="llm")
    with pytest.raises(sup_mod.DispatchHungError, match="watchdog") as exc:
        sup.run(hung, label="decode")
    assert exc.value.reason == "hang"
    assert sup.stats["watchdog_fires"] == 1
    assert sup.run(lambda: 42) == 42
    release.set()
    assert finished.wait(5)
    with pytest.raises(sup_mod.DispatchFailedError, match="ValueError"):
        sup.run(_boom(ValueError("x")))
    assert sup.snapshot()["dispatch_failures"] == 1
