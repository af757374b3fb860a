"""The port's training numerics observatory against the JAX package's.

- `telemetry_groups` / `telemetry_keys` over the port model's parameter
  names equal the JAX ones over its own names.
- In-step telemetry: gpt2-tiny in fp32 with weights bridged, one
  `ShardedTrainStep(numerics=True)` step (AdamW, global-norm clip) on
  both sides; then one fp16 AMP step of a strategy with `numerics` set
  (the sample carries loss_scale, good_steps and bad_steps), and a
  skipped fp16 step (an overflowing loss scale), whose update ratios are
  0 on both sides. Every value within rtol 1e-4, atol 1e-6; the counters
  and the loss scale exactly.
- `nonfinite_blame` on a leaf poisoned in 5 elements: the grad and param
  census equal the JAX probe's exactly.
- The probe changes nothing: a step taken after a probe is bit-equal to
  one taken without (parameters, losses, optimizer slots, BatchNorm
  statistics, dropout draws), the live gradients stay None; with lr 0 the
  probe of step s reproduces step s's loss bit for bit, dropout included.
- `NumericsObservatory`: the spike sentinel, `observe_sample`,
  `observe_nonfinite` and `render_prom` on the same inputs give what the
  JAX observatory gives, flight events included; `/debug/numerics`
  answers on a `MetricsServer`.
- `ResilientTrainer(numerics=True)` over an armed ScanTrainStep: samples
  on the interval, and a NaN written into a parameter is blamed by name
  before the rollback.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

from _torch_port import one_cpu_mesh, one_torch_thread  # noqa: F401
from _torch_port import tiny_models, train_batches, train_models

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LR = 1e-3
EVENT_DROP = ("t_mono", "t_wall", "seq", "probe_seconds")


def _adamw(jm, tm, lr=LR):
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    return (jopt.AdamW(learning_rate=lr, parameters=jm.parameters(),
                       weight_decay=0.01,
                       grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)),
            topt.AdamW(learning_rate=lr, parameters=tm.parameters(),
                       weight_decay=0.01,
                       grad_clip=ClipGradByGlobalNorm(1.0)))


def _assert_samples(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k in ("loss_scale", "good_steps", "bad_steps"):
            assert got[k] == want[k], (k, got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_telemetry_groups_and_keys_match_jax():
    import paddle_tpu.obs.numerics as jn
    import paddle_tpu_torch.obs.numerics as tn
    jm, tm = tiny_models()
    jnames = list(jm.functional_state()[0])
    tnames = [k for k, p in tm.named_parameters() if p.requires_grad]
    jg, tg = jn.telemetry_groups(jnames), tn.telemetry_groups(tnames)
    assert tg == jg
    assert tn.telemetry_keys(tg) == jn.telemetry_keys(jg)
    names = ["h.3.attn.wq.weight", "h.10.mlp.b", "embed.weight", "x"]
    assert tn.telemetry_groups(names) == jn.telemetry_groups(names)
    assert [tn.bracket_path(n) for n in names] == \
        [jn.bracket_path(n) for n in names]


def test_sharded_step_telemetry_matches_jax():
    from paddle_tpu.parallel.api import ShardedTrainStep as JaxStep
    from paddle_tpu_torch.parallel import ShardedTrainStep
    jm, tm = train_models()
    jo, to = _adamw(jm, tm)
    js = JaxStep(jm, jo, one_cpu_mesh(), donate=False, numerics=True)
    ts = ShardedTrainStep(tm, to, device="cpu", numerics=True)
    ids, labels = train_batches(0, K=1)
    js(ids[0], labels[0])
    ts(ids[0], labels[0])
    got, want = ts.numerics_host_sample(), js.numerics_host_sample()
    _assert_samples(got, want)
    assert got["update_ratio/_total"] > 0
    assert all(p.grad is None for p in tm.parameters())
    # disarmed: no telemetry, no sample
    assert ShardedTrainStep(tm, to, device="cpu").numerics_host_sample() \
        is None


def _fp16_steps(fields):
    from paddle_tpu.distributed.fleet.strategy_compiler import \
        StrategyCompiler
    from paddle_tpu.distributed.strategy import DistributedStrategy as JS
    from paddle_tpu.parallel.api import ShardedTrainStep as JaxStep
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.parallel import ShardedTrainStep, parallelize
    jm, tm = train_models()
    jo, to = _adamw(jm, tm)
    strategies = []
    for s in (JS(), DistributedStrategy()):
        s.amp = True
        s.amp_configs = dict(fields)
        s.numerics = True
        strategies.append(s)
    plan = StrategyCompiler().compile(strategies[0], jo, one_cpu_mesh())
    assert "numerics" in plan.applied
    js = JaxStep(jm, jo, one_cpu_mesh(), plan=plan, donate=False)
    ts = parallelize(tm, to, strategy=strategies[1], device="cpu")
    assert isinstance(ts, ShardedTrainStep) and ts.numerics_armed
    assert "numerics" in ts.plan.applied
    return js, ts


@pytest.mark.parametrize("case", ["applied", "skipped"])
def test_fp16_strategy_step_telemetry_matches_jax(case):
    fields = {"dtype": "float16", "incr_every_n_steps": 2}
    if case == "skipped":
        fields.update(init_loss_scaling=1e12, decr_every_n_nan_or_inf=1)
    js, ts = _fp16_steps(fields)
    ids, labels = train_batches(1, K=1)
    js(ids[0], labels[0])
    ts(ids[0], labels[0])
    got, want = ts.numerics_host_sample(), js.numerics_host_sample()
    _assert_samples(got, want)
    for k in ("loss_scale", "good_steps", "bad_steps"):
        assert k in got
    ratios = [v for k, v in got.items() if k.startswith("update_ratio/")]
    if case == "skipped":
        assert got["bad_steps"] == 0.0 and got["loss_scale"] < 1e12
        assert ratios == [0.0] * len(ratios)
        assert got["grad_norm/_total"] == 0.0
    else:
        assert min(ratios) > 0


def _poison(js, ts, name, k):
    import jax.numpy as jnp
    idx = np.arange(0, 3 * k, 3)
    arr = js._params[name]
    js._params[name] = arr.reshape(-1).at[idx].set(jnp.nan).reshape(
        arr.shape)
    p = dict(ts.model.named_parameters())[name]
    with torch.no_grad():
        p.view(-1)[torch.from_numpy(idx)] = float("nan")


def test_nonfinite_blame_matches_jax():
    from paddle_tpu.parallel.api import ShardedTrainStep as JaxStep
    from paddle_tpu_torch.parallel import ShardedTrainStep
    jm, tm = train_models()
    jo, to = _adamw(jm, tm)
    js = JaxStep(jm, jo, one_cpu_mesh(), donate=False)
    ts = ShardedTrainStep(tm, to, device="cpu")
    ids, labels = train_batches(2, K=1)
    clean = ts.nonfinite_blame(1, ids[0], labels[0])
    assert clean["grads"] == {} and clean["params"] == {}
    name = "gpt.layers.1.linear2.weight"
    _poison(js, ts, name, 5)
    want = js.nonfinite_blame(1, ids[0], labels[0])
    got = ts.nonfinite_blame(1, ids[0], labels[0])
    assert got["params"] == want["params"] == {name: 5}
    assert got["grads"] == want["grads"] and got["grads"]
    assert got["sizes"] == want["sizes"]
    assert np.isnan(got["loss"]) and np.isnan(want["loss"])
    assert all(p.grad is None for p in tm.parameters())


class _Net(torch.nn.Module):
    """Linear, BatchNorm, dropout, Linear: every piece of state a probe
    could disturb."""

    def __init__(self):
        from paddle_tpu_torch import nn
        super().__init__()
        self.fc1 = nn.Linear(8, 16)
        self.bn = nn.BatchNorm1D(16)
        self.drop = nn.Dropout(0.3)
        self.fc2 = nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(self.drop(torch.relu(self.bn(self.fc1(x)))))


def _net_step(lr, seed=0):
    from paddle_tpu_torch.core.random import seed as set_seed
    from paddle_tpu_torch.nn.layer.layers import init_parameters
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainStep
    net = _Net()
    gen = torch.Generator()
    gen.manual_seed(seed)
    init_parameters(net, gen)
    net.train()
    set_seed(7)
    opt = AdamW(learning_rate=lr, parameters=net.parameters(),
                weight_decay=0.0)

    def loss_fn(out, y):
        return torch.nn.functional.cross_entropy(out.float(), y.long())
    return net, opt, ShardedTrainStep(net, opt, device="cpu",
                                      loss_fn=loss_fn, numerics=True)


def _state(net, opt):
    out = {k: v.detach().clone() for k, v in net.state_dict().items()}
    for i, (p, slots) in enumerate(opt.state.items()):
        for k, t in slots.items():
            out[f"opt.{i}.{k}"] = t.detach().clone()
    return out


def test_blame_probe_leaves_the_next_step_bit_equal():
    from paddle_tpu_torch.core.random import rng_snapshot
    rng = np.random.RandomState(3)
    xs = rng.randn(3, 32, 8).astype(np.float32)
    ys = rng.randint(0, 4, (3, 32)).astype(np.int32)
    runs = []
    for probe in (False, True):
        net, opt, step = _net_step(lr=1e-2)
        losses = [step(xs[0], ys[0]).item()]
        if probe:
            before = rng_snapshot()
            rep = step.nonfinite_blame(1, xs[1], ys[1])
            assert rep["grads"] == {} and rep["params"] == {}
            after = rng_snapshot()
            assert before[:2] == after[:2]
            assert all(torch.equal(before[2][d], after[2][d])
                       for d in before[2])
            assert all(p.grad is None for p in net.parameters())
        losses += [step(xs[i], ys[i]).item() for i in (1, 2)]
        runs.append((losses, _state(net, opt), step.numerics_host_sample()))
    (l0, s0, n0), (l1, s1, n1) = runs
    assert l1 == l0
    assert s1.keys() == s0.keys()
    assert all(torch.equal(s1[k], s0[k]) for k in s0), \
        [k for k in s0 if not torch.equal(s1[k], s0[k])]
    assert n1 == n0


def test_blame_probe_replays_the_step_dropout():
    rng = np.random.RandomState(4)
    x = rng.randn(32, 8).astype(np.float32)
    y = rng.randint(0, 4, (32,)).astype(np.int32)
    net, opt, step = _net_step(lr=0.0)
    loss1 = step(x, y).item()
    for p in net.parameters():
        p.grad = None
    bn = {k: v.clone() for k, v in net.named_buffers()}
    # lr 0 and no decay: the parameters did not move, so step 1's probe
    # sees step 1's loss exactly when it replays step 1's dropout draws
    rep = step.nonfinite_blame(1, x, y)
    assert rep["loss"] == loss1
    assert all(torch.equal(v, dict(net.named_buffers())[k])
               for k, v in bn.items())
    # another step number has no kept state: the current draws
    other = step.nonfinite_blame(5, x, y)
    assert other["loss"] != loss1


def _observatory_run(mod, fr):
    fr().clear()
    obs = mod.NumericsObservatory(interval=3, spike_window=16,
                                  spike_zscore=4.0, spike_min_points=4,
                                  storm_threshold=2)
    zs = []
    losses = [2.5, 2.49, 2.51, 2.48, 2.5, 2.47, 9.0, 2.46, float("nan"),
              2.45, 40.0, 2.44, 2.44]
    for i, v in enumerate(losses):
        zs.append(obs.observe_loss(i, v))
        if obs.should_sample(i + 1):
            obs.observe_sample(i + 1, {"grad_norm/gpt": 1.0 + i,
                                       "grad_norm/_total": 2.0 + i,
                                       "param_norm/gpt": 3.25,
                                       "update_ratio/gpt": 1e-4 * i,
                                       "loss_scale": 32768.0,
                                       "good_steps": float(i),
                                       "bad_steps": 0.0})
    report = {"loss": float("nan"),
              "sizes": {"gpt.layers.0.linear1.weight": 2_000_000,
                        "lm_head.weight": 3000},
              "grads": {"gpt.layers.0.linear1.weight": 1_500_000,
                        "lm_head.weight": 3000},
              "params": {"lm_head.weight": 7}, "probe_seconds": 0.5}
    culprit = obs.observe_nonfinite(9, report)
    culprit2 = obs.observe_nonfinite(11, {"grads": {}, "params": {}})
    snap = obs.snapshot()
    events = [{k: v for k, v in e.items() if k not in EVENT_DROP}
              for e in fr().snapshot()["events"]
              if e["kind"].startswith("train_")]
    return zs, culprit, culprit2, snap, events, obs.render_prom(), \
        mod.debug_snapshot()


def test_numerics_observatory_matches_jax(tmp_path, monkeypatch):
    import paddle_tpu.obs.numerics as jn
    import paddle_tpu_torch.obs.numerics as tn
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    from paddle_tpu_torch.obs.prom import MetricsServer, parse_exposition
    monkeypatch.setenv("PDTPU_FLIGHT_DIR", str(tmp_path))
    assert tn.render_prom() == jn.render_prom() or tn.current_numerics()
    want = _observatory_run(jn, jfr)
    got = _observatory_run(tn, tfr)
    for a, b, what in zip(got, want, ("zscores", "culprit", "culprit2",
                                      "snapshot", "events", "prom",
                                      "debug")):
        if what == "zscores":
            assert [z is None for z in a] == [z is None for z in b]
            np.testing.assert_allclose([z for z in a if z is not None],
                                       [z for z in b if z is not None],
                                       rtol=0, atol=0)
        else:
            assert a == b, what
    assert got[1] == ("params['gpt']['layers'][0]['linear1']['weight']"
                      ".grad: 1500000 non-finite of 2.0e6")
    kinds = [e["kind"] for e in got[4]]
    assert kinds.count("train_loss_spike") == 2
    assert kinds.count("train_nonfinite") == 2
    flat = parse_exposition(got[5])
    assert flat['pdtpu_train_numerics_grad_norm{group="gpt"}'] == 12.0
    server = MetricsServer([lambda: tn.render_prom()]).start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(url + "/debug/numerics",
                                    timeout=10) as r:
            doc = json.loads(r.read())
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            text = r.read().decode()
    finally:
        server.stop()
    assert doc["armed"] is True and doc["nonfinite_events"] == 2
    assert "pdtpu_train_numerics_loss_spikes_total 2" in text
    tn.set_current(None)
    jn.set_current(None)
    assert tn.debug_snapshot() == {"armed": False}
    assert tn.render_prom() == ""


def test_resilient_trainer_blames_a_poisoned_leaf(tmp_path, monkeypatch):
    """A parameter corrupted after a chunk's updates, with the chunk's loss
    read as NaN (the nan_loss fault): the probe's census names the leaf
    with exactly the elements written (had the chunk itself run on the
    corrupted value, its update would have spread NaN into every leaf, as
    in JAX), before the rollback restores the state of step 4."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.resilient import (ResilientConfig,
                                                        ResilientTrainer)
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep
    from paddle_tpu_torch.utils.fault_injection import FaultPlan
    name = "gpt.layers.0.linear1.weight"

    class PoisonAt4(ScanTrainStep):
        done = False

        def __call__(self, *args):
            losses = super().__call__(*args)
            if self._step_count == 6 and not self.done:
                self.done = True
                with torch.no_grad():
                    dict(m.named_parameters())[name].view(-1)[:3] = \
                        float("nan")
            return losses

    m = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                   num_hidden_layers=1)
    m.train()
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    step = PoisonAt4(m, opt, scan_steps=2, device="cpu", numerics=True)
    ids, labels = train_batches(5, K=8, S=32)

    def get_state():
        return {"model": m.state_dict(), "opt": opt.state_dict(),
                "step": step._step_count}

    def set_state(s):
        m.set_state_dict(s["model"])
        opt.set_state_dict(s["opt"])
        step._step_count = int(s["step"])

    monkeypatch.setenv("PDTPU_FLIGHT_DIR", str(tmp_path))
    flight_recorder().clear()
    trainer = ResilientTrainer(
        step, CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2,
                                device="cpu"),
        get_state=get_state, set_state=set_state,
        config=ResilientConfig(save_interval=2),
        fault_plan=FaultPlan.from_spec("nan_loss@4"), numerics=True,
        numerics_interval=2, goodput=True)
    summary = trainer.run(lambda i: (ids[i:i + 2], labels[i:i + 2]),
                          num_steps=8)
    assert summary["completed_steps"] == 8
    kinds = [(e["kind"], e["step"]) for e in summary["events"]]
    assert kinds == [("bad_loss", 4), ("rollback", 4)], kinds
    assert torch.isfinite(dict(m.named_parameters())[name]).all()
    snap = trainer.numerics.snapshot()
    assert snap["nonfinite_events"] == 1
    assert [h["step"] for h in snap["history"]] == [2, 4, 6, 8]
    ev = [e for e in flight_recorder().snapshot()["events"]
          if e["kind"] == "train_nonfinite"]
    assert len(ev) == 1 and ev[0]["step"] == 4
    assert ev[0]["param_leaves"] == 1 and ev[0]["param_nonfinite"] == 3
    assert ev[0]["grad_leaves"] > 1
    assert trainer.ledger.snapshot()["phase_seconds"]["rollback_waste"] > 0
    assert "pdtpu_train_numerics_sample_step 8" in trainer.metrics.render()
