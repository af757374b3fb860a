"""The port's resilient training runtime against the JAX package's, on
the CPU: paddle_tpu_torch/distributed/resilient.py,
utils/fault_injection.py and flags.py beside their paddle_tpu
counterparts.

- `FaultPlan` parses every spec of the `PDTPU_FAULTS` grammar as the JAX
  one does (or refuses it alike), and its injection points fire alike.
- The flags have the same names and defaults; the fault-spec flag
  installs the global plan; the deterministic-cuDNN flag sets torch's.
- The recovery matrix over a toy step: the same fault spec drives the
  JAX and the port `ResilientTrainer`, and both give the same event
  kinds at the same steps, summary counts and saved steps
  (tests/test_torch_resilient_scan.py does it over gpt2-tiny).
- A port run killed by SIGKILL in the checkpoint writer
  (`kill@6:persist`) and resumed in a fresh process gives, bit for bit,
  the losses and final state of an uninterrupted run (three processes).
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
import paddle_tpu.distributed.resilient as jres
import paddle_tpu.flags as jflags
import paddle_tpu_torch.distributed.resilient as tres
import paddle_tpu_torch.flags as tflags
from paddle_tpu import checkpoint as jck
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch import checkpoint as tck
from paddle_tpu_torch.utils import fault_injection as tfi

pytestmark = pytest.mark.usefixtures("one_torch_thread")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "fixtures", "torch_resilient_worker.py")

SIDES = {"jax": (jres, jck, jfi, {"use_orbax": False}),
         "port": (tres, tck, tfi, {"device": "cpu"})}


# ---- the fault grammar ----

SPECS = ["nan_loss@3", "inf_loss@3; raise@5:OSError",
         "nan_loss@3; raise@5:OSError; delay@7:2.5; kill@4:mid_save",
         "nan_input@3:1;inf_input@4", "kill@4:persist;kill@6:step",
         "ckpt_io_stall@4:2.0;ckpt_torn_write@8",
         "dispatch_raise@5;dispatch_hang@6:3.0;poison_request@2:decode",
         "replica_crash@1;replica_hang@1:30.0;replica_slow@2:50",
         "swap_stall@1:2.5;deploy_bad_weights@0", " ; nan_loss@0 ;",
         "", "nan_loss", "nan_loss@x", "raise@"]


def _parse(fi, spec):
    try:
        return [(f.kind, f.step, f.arg, repr(f))
                for f in fi.FaultPlan.from_spec(spec).faults]
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parses_as_jax(spec):
    assert _parse(tfi, spec) == _parse(jfi, spec)


def _drive(fi):
    """The same injection-point calls on a plan of each package: what
    each returns or raises, and the plan's log."""
    plan = fi.FaultPlan.from_spec(
        "raise@2:OSError;delay@3:0.01;dispatch_raise@1;dispatch_hang@2:4;"
        "poison_request@7:decode;replica_crash@0;replica_hang@1:2;"
        "replica_slow@2:5;swap_stall@1:0.5;deploy_bad_weights@0;"
        "ckpt_io_stall@9:0.01")
    out = []

    def call(fn, *a, **kw):
        try:
            out.append(repr(fn(*a, **kw)))
        except Exception as e:     # noqa: BLE001 - the outcome is compared
            out.append(f"{type(e).__name__}: {e}")

    for step in (1, 2, 2):
        call(plan.maybe_raise, step)
    call(plan.maybe_delay, 3)
    for idx in (1, 2, 3):
        call(plan.maybe_dispatch_fault, idx, "decode", request_ids=[7])
    call(plan.maybe_dispatch_fault, 4, "prefill", request_ids=[7])
    for i in (0, 1, 2, 2, 3):
        call(plan.maybe_replica_fault, i)
    call(plan.maybe_swap_stall, 1)
    call(plan.maybe_swap_stall, 1)
    call(plan.maybe_bad_weights, 0)
    call(plan.maybe_bad_weights, 0)
    call(plan.maybe_ckpt_stall, 9)
    call(plan.maybe_kill, 5, "step")       # nothing scheduled: no kill
    out.append(plan.log)
    return out


def test_fault_points_fire_as_jax():
    assert _drive(tfi) == _drive(jfi)


def test_loss_and_batch_poisons_match_jax():
    jplan = jfi.FaultPlan.from_spec("nan_loss@5;inf_loss@9;nan_input@3:1")
    tplan = tfi.FaultPlan.from_spec("nan_loss@5;inf_loss@9;nan_input@3:1")
    vec = np.ones((4,), np.float32)
    for start in (4, 8, 12):
        want = np.asarray(jplan.corrupt_loss_vector(start, vec))
        got = tplan.corrupt_loss_vector(start, torch.from_numpy(vec))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    clean = torch.ones(4)
    assert tplan.corrupt_loss_vector(12, clean) is clean
    ids = np.arange(12, dtype=np.int32).reshape(3, 4)
    want = jplan.corrupt_batch(2, (ids, ids), k=3)
    got = tplan.corrupt_batch(2, (torch.from_numpy(ids),
                                  torch.from_numpy(ids)), k=3)
    assert got[0] is not None and torch.equal(got[0],
                                              torch.from_numpy(ids))
    assert got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert tplan.log == jplan.log


def test_corrupt_loss_keeps_the_tensor_and_scalar_forms():
    plan = tfi.FaultPlan.from_spec("nan_loss@0;inf_loss@1")
    loss = torch.tensor(2.5, dtype=torch.float32)
    got = plan.corrupt_loss(0, loss)
    assert torch.is_tensor(got) and got.shape == loss.shape
    assert got.dtype == loss.dtype and got.device == loss.device
    assert torch.isnan(got)
    assert np.isinf(plan.corrupt_loss(1, 1.0))
    assert plan.corrupt_loss(2, loss) is loss


# ---- flags ----

def test_flag_names_and_defaults_equal_jax():
    assert tflags._FLAGS == jflags._FLAGS
    names = sorted(jflags._FLAGS)
    assert tflags.get_flags(names) == jflags.get_flags(names)
    for mod in (tflags, jflags):
        with pytest.raises(ValueError, match="unknown flag"):
            mod.get_flags("FLAGS_nope")
        with pytest.raises(ValueError, match="unknown flag"):
            mod.set_flags({"FLAGS_nope": 1})


def test_fault_flag_installs_global_plan_and_cudnn_flag_sets_torch():
    import paddle_tpu_torch
    assert paddle_tpu_torch.get_flags is tflags.get_flags
    old = torch.backends.cudnn.deterministic
    try:
        tflags.set_flags({"FLAGS_fault_injection_spec": "raise@7"})
        assert [f.kind for f in tfi.global_plan().faults] == ["raise"]
        tflags.set_flags({"FLAGS_cudnn_deterministic": True})
        assert torch.backends.cudnn.deterministic is True
    finally:
        tflags.set_flags({"FLAGS_fault_injection_spec": "",
                          "FLAGS_cudnn_deterministic": False})
        torch.backends.cudnn.deterministic = old
        tfi.set_global_plan(None)
    assert tflags.get_flags("FLAGS_cudnn_deterministic")[
        "FLAGS_cudnn_deterministic"] is False


def test_observatory_and_numerics_are_refused_by_name(tmp_path):
    with pytest.raises(NotImplementedError, match="item 9"):
        tres.ResilientTrainer(lambda b: 0.0, str(tmp_path),
                              get_state=dict, set_state=print,
                              device="cpu", observatory=True)
    # the numerics observatory is ported: numerics=True arms it
    from paddle_tpu_torch.obs.numerics import NumericsObservatory
    t = tres.ResilientTrainer(lambda b: 0.0, str(tmp_path),
                              get_state=dict, set_state=print,
                              device="cpu", numerics=True,
                              numerics_interval=3)
    assert isinstance(t.numerics, NumericsObservatory)
    assert t.numerics.interval == 3 and t.metrics.numerics is t.numerics


# ---- the recovery matrix over a toy step ----

class _Toy:
    """A float 'model' the train fn increments (tests/test_resilient.py)."""

    def __init__(self, kill_at=None):
        self.w = 0.0
        self.trained = []
        self.kill_at = kill_at

    def train_fn(self, step):
        if step == self.kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        self.w += 1.0
        self.trained.append(step)
        return 1.0 / (step + 1)


def _toy_run(side, d, spec, steps, kill_at=None, tier="sync", **cfg):
    res, ck, fi, kw = SIDES[side]
    toy = _Toy(kill_at)
    ckpt = (ck.CheckpointManager(d, **kw) if tier == "sync" else
            ck.AsyncCheckpointManager(d, max_to_keep=10,
                                      **({} if side == "jax" else kw)))
    t = res.ResilientTrainer(
        toy.train_fn, ckpt, get_state=lambda: {"w": toy.w},
        set_state=lambda s: setattr(toy, "w", s["w"]),
        config=res.ResilientConfig(**cfg),
        fault_plan=fi.FaultPlan.from_spec(spec))
    try:
        s = t.run(lambda i: i, num_steps=steps)
        out = {k: s[k] for k in ("completed_steps", "retries", "rollbacks",
                                 "preempted")}
    except BaseException as e:     # noqa: BLE001 - the outcome is compared
        if not isinstance(e, (SystemExit, jres.UnrecoverableError,
                              tres.UnrecoverableError)):
            raise
        out = {"raised": type(e).__name__, "code": getattr(e, "code", None)}
    out["events"] = [(e["kind"], e["step"], e.get("source"))
                     for e in t.events]
    out.update(trained=toy.trained, w=toy.w, latest=ckpt.latest_step())
    marker = os.path.join(d, res.PREEMPT_MARKER)
    if os.path.exists(marker):
        with open(marker) as f:
            doc = json.load(f)
        out["marker"] = {k: doc[k] for k in ("step", "resumable")}
    if tier == "async":
        ckpt.close()
    return out


TOY_CASES = {
    "clean": ("", 3, {}),
    "nan_skip": ("nan_loss@2", 5, {}),
    "nan_escalates": ("nan_loss@2;nan_loss@3;nan_loss@4", 6,
                      {"max_consecutive_skips": 2}),
    "nan_abort": ("nan_loss@1", 3, {"nan_policy": "abort"}),
    "retry_backoff": ("raise@1:OSError", 3, {"retry_backoff": 0.01}),
    "retries_exhausted": ("raise@1;raise@1", 3, {
        "max_step_retries": 0, "retry_backoff": 0.01, "max_rollbacks": 3}),
    "rollback_budget": ("raise@1;raise@1;raise@1", 3, {
        "max_step_retries": 0, "retry_backoff": 0.01, "max_rollbacks": 1}),
    "watchdog": ("delay@1:1.0", 3, {"watchdog_timeout": 0.2,
                                    "retry_backoff": 0.01}),
    "sigterm": ("", 10, {"kill_at": 2}),
    "async_ring_rollback": ("nan_loss@5", 8, {
        "tier": "async", "nan_policy": "rollback", "save_interval": 2}),
}


@pytest.mark.parametrize("case", sorted(TOY_CASES))
def test_toy_recovery_matches_jax(tmp_path, case):
    spec, steps, cfg = TOY_CASES[case]
    got = {side: _toy_run(side, str(tmp_path / side), spec, steps, **cfg)
           for side in SIDES}
    assert got["port"] == got["jax"]
    if case == "sigterm":
        assert got["port"]["code"] == 143
        assert got["port"]["marker"] == {"step": 3, "resumable": True}
    if case == "async_ring_rollback":
        assert ("rollback", 4, "ring") in got["port"]["events"]


def test_toy_resume_matches_jax(tmp_path):
    got = {}
    for side in SIDES:
        d = str(tmp_path / side)
        first = _toy_run(side, d, "", 3)
        got[side] = [first, _toy_run(side, d, "", 6)]
    assert got["port"] == got["jax"]
    assert got["port"][1]["trained"] == [3, 4, 5]
    assert ("resumed", 3, None) in got["port"][1]["events"]


def test_callbacks_and_profiler_see_the_fault_events(tmp_path):
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.callbacks import Callback
    seen = []

    class Spy(Callback):
        def on_fault(self, kind, step, logs=None):
            seen.append((kind, step))

    toy = _Toy()
    t = tres.ResilientTrainer(
        toy.train_fn, str(tmp_path), get_state=lambda: {"w": toy.w},
        set_state=lambda s: setattr(toy, "w", s["w"]),
        fault_plan=tfi.FaultPlan.from_spec("nan_loss@1"),
        callbacks=[Spy()], device="cpu")
    profiler.start_profiler()
    try:
        t.run(lambda i: i, num_steps=3)
    finally:
        profiler._SINK.enabled = False
    assert ("bad_loss", 1) in seen and ("skip", 1) in seen
    names = [e["name"] for e in profiler.get_events()]
    assert "resilient/bad_loss" in names and "resilient/step" in names


# ---- kill in the writer, resume in a fresh process ----

def _worker(workdir, steps, faults=None):
    env = dict(os.environ)
    env.pop(tfi.ENV_VAR, None)
    env["OMP_NUM_THREADS"] = "1"     # every child sums in the same order
    if faults:
        env[tfi.ENV_VAR] = faults
    os.makedirs(workdir, exist_ok=True)
    return subprocess.Popen([sys.executable, WORKER, str(workdir),
                             str(steps)], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _losses(workdir):
    out = {}
    with open(os.path.join(workdir, "losses.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            for i, v in enumerate(rec["losses"]):
                out.setdefault(rec["start"] + i, []).append(v)
    return out


def test_kill_in_writer_then_resume_is_bit_equal(tmp_path):
    clean, faulty = tmp_path / "clean", tmp_path / "faulty"
    procs = [_worker(clean, 16), _worker(faulty, 8, "kill@6:persist")]
    (_, clean_err), (_, kill_err) = [p.communicate(timeout=180)
                                     for p in procs]
    assert procs[0].returncode == 0, clean_err[-3000:]
    assert procs[1].returncode == -signal.SIGKILL, kill_err[-3000:]
    certified = tck.CheckpointManager(str(faulty / "ckpt"),
                                      device="cpu").all_steps()
    assert certified == [2, 4]        # snapshot 6 died in the writer
    proc = _worker(faulty, 16)
    _, err = proc.communicate(timeout=180)
    assert proc.returncode == 0, err[-3000:]
    with open(faulty / "report.json") as f:
        report = json.load(f)
    assert report["resumed_from"] == 4 and report["completed"] == 16
    want, got = _losses(clean), _losses(faulty)
    assert set(want) == set(got) == set(range(16))
    for s in range(16):
        assert len(want[s]) == 1
        assert all(v == want[s][0] for v in got[s]), (s, got[s], want[s])
    a = torch.load(clean / "final.pt")
    b = torch.load(faulty / "final.pt")
    assert a["step"] == b["step"] == 16
    for part in ("model", "opt"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            va, vb = a[part][k], b[part][k]
            assert torch.equal(va, vb) if torch.is_tensor(va) \
                else va == vb, k
