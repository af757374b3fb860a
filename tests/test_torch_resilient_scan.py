"""The recovery matrix over gpt2-tiny: the same `PDTPU_FAULTS` spec
drives the JAX and the port `ResilientTrainer` around each package's
`ScanTrainStep(scan_steps=2)` from the same (bridged) weights, with a
CheckpointManager or an AsyncCheckpointManager; both give the same event
kinds at the same steps (a retry, a rollback from disk or from the ring,
an abort) and the same summary counts, and every chunk's losses agree
within 1e-5 (fp32 sums in another order, as
tests/test_torch_train_step.py states).
"""
import numpy as np
import pytest
import torch

from _torch_port import (one_cpu_mesh, one_torch_thread,  # noqa: F401
                         train_models)

import paddle_tpu.distributed.resilient as jres
import paddle_tpu_torch.distributed.resilient as tres
from paddle_tpu import checkpoint as jck
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch import checkpoint as tck
from paddle_tpu_torch.utils import fault_injection as tfi

pytestmark = pytest.mark.usefixtures("one_torch_thread")


SIDES = {"jax": (jres, jck, jfi, {"use_orbax": False}),
         "port": (tres, tck, tfi, {"device": "cpu"})}


K, STEPS = 2, 6


class _Recorded:
    """A ScanTrainStep of either package that records each chunk's
    losses under its first step (set by the batch fn)."""

    def __init__(self, step):
        self.step = step
        self.scan_steps = step.scan_steps
        self.start = None
        self.chunks = []

    def __call__(self, *args):
        out = self.step(*args)
        vec = out.tolist() if torch.is_tensor(out) else \
            np.asarray(out.data).tolist()
        self.chunks.append((self.start, vec))
        return out


@pytest.fixture(scope="module")
def gpt_cells():
    """Both packages' gpt2-tiny ScanTrainSteps from the same weights, with
    get/set_state hooks and their initial states: the JAX step's chunk is
    compiled once for every case."""
    import jax
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parallel import ScanTrainStep as JaxScan
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep
    jm, tm = train_models()
    jstep = JaxScan(jm, jopt.AdamW(learning_rate=1e-3,
                                   parameters=jm.parameters()),
                    one_cpu_mesh(), scan_steps=K, zero_stage=0,
                    donate=False)
    topt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    tstep = ScanTrainStep(tm, topt, scan_steps=K, device="cpu")

    def put(x, like):
        """A restored leaf placed as the live one is: the chunk's
        executable is reused, not compiled again."""
        return jax.device_put(np.asarray(getattr(x, "data", x)),
                              like.sharding)

    def jget():
        return {"params": dict(jstep._params), "opt": jstep._opt_state,
                "step": jstep._step_count}

    def jset(s):
        jstep._params = {k: put(v, jstep._params[k])
                         for k, v in s["params"].items()}
        jstep._opt_state = {k: {n: put(v, jstep._opt_state[k][n])
                                for n, v in slots.items()}
                            for k, slots in s["opt"].items()}
        jstep._step_count = int(s["step"])

    def tget():
        return {"model": tm.state_dict(), "opt": topt.state_dict(),
                "step": tstep._step_count}

    def tset(s):
        tm.set_state_dict(s["model"])
        topt.set_state_dict(s["opt"])
        tstep._step_count = int(s["step"])

    from paddle_tpu.framework_io import _unpack
    tstep(*_chunk(0))            # the slots exist from here, as in JAX
    jstep(*_chunk(0))
    jinit, tinit = jck._host_copy(jget()), tck._host_copy(tget())
    return {"jax": (jstep, jget, jset, lambda: _unpack(jinit)),
            "port": (tstep, tget, tset,
                     lambda: tck._to_device(tinit, torch.device("cpu")))}


def _chunk(i):
    rng = np.random.RandomState(100)
    ids = rng.randint(0, 512, (STEPS, 2, 32)).astype(np.int32)
    labels = np.roll(ids, -1, axis=2)
    return ids[i:i + K], labels[i:i + K]


GPT_CASES = {
    "clean": ("", "sync", {"save_interval": 2}),
    "nan_rollback_from_disk": ("nan_loss@5", "sync", {"save_interval": 2}),
    "retries_then_rollback": ("raise@2;raise@2;raise@2", "sync", {
        "save_interval": 2, "retry_backoff": 0.01}),
    "async_retry_and_ring_rollback": ("raise@3;nan_loss@5", "async", {
        "save_interval": 2, "retry_backoff": 0.01}),
    "inf_abort": ("inf_loss@4", "sync", {"nan_policy": "abort"}),
}


def _gpt_run(cells, side, d, spec, tier, cfg):
    res, ck, fi, kw = SIDES[side]
    step, get_state, set_state, initial = cells[side]
    set_state(initial())
    ckpt = (ck.CheckpointManager(d, max_to_keep=2, **kw) if tier == "sync"
            else ck.AsyncCheckpointManager(d, max_to_keep=2, **(
                {} if side == "jax" else kw)))
    fn = _Recorded(step)

    def batch_fn(i):
        fn.start = i
        return _chunk(i)

    t = res.ResilientTrainer(fn, ckpt, get_state=get_state,
                             set_state=set_state,
                             config=res.ResilientConfig(**cfg),
                             fault_plan=fi.FaultPlan.from_spec(spec))
    try:
        s = t.run(batch_fn, num_steps=STEPS)
        out = {k: s[k] for k in ("completed_steps", "retries",
                                 "rollbacks")}
    except (jres.UnrecoverableError, tres.UnrecoverableError) as e:
        out = {"raised": str(e)}
    out["events"] = [(e["kind"], e["step"], e.get("source"))
                     for e in t.events]
    if tier == "async":
        ckpt.close()
    return out, fn.chunks


@pytest.mark.parametrize("case", sorted(GPT_CASES))
def test_gpt_scan_recovery_matches_jax(tmp_path, gpt_cells, case):
    spec, tier, cfg = GPT_CASES[case]
    out, chunks = {}, {}
    for side in SIDES:
        out[side], chunks[side] = _gpt_run(
            gpt_cells, side, str(tmp_path / side), spec, tier, cfg)
    assert out["port"] == out["jax"]
    assert [c[0] for c in chunks["port"]] == [c[0] for c in chunks["jax"]]
    got = np.array([c[1] for c in chunks["port"]])
    want = np.array([c[1] for c in chunks["jax"]])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if case == "async_retry_and_ring_rollback":
        assert out["port"]["events"] == [
            ("step_error", 2, None), ("retry", 2, None),
            ("bad_loss", 5, None), ("rollback", 4, "ring")]
    if case == "inf_abort":
        assert "step 4" in out["port"]["raised"]
