"""The strategy-driven train step at degree 1: the port's
`parallelize(model, opt, strategy=s)` against the JAX package's step with
the same plan on a one-device CPU mesh.

gpt2-tiny in fp32 master weights, B=2, S=64, labels with ignored tokens;
both sides start from the same weights (bridged) and take the same
batches; the JAX step is built from the JAX compiler's plan exactly as
the JAX `parallelize` builds it (selective recompute wrapped first), with
`donate=False` so its model stays usable. After every chunk:

- the loss scale, the good and bad counters and the gradient-merge count
  are EXACTLY equal (they are decided on the device from the finite
  census, so equal counters mean the same steps were skipped and
  banked);
- losses: fp32 within atol = rtol = 1e-5 (sums in another order); AMP
  bf16 within 1e-3 and fp16 within 2.5e-4 absolute (the two packages
  round a GELU, a bias add or a product's output to the low dtype at
  other places; ~3e-4 and ~3e-5 were seen on losses of ~6);
- weights: fp32 as tests/test_torch_train_step.py holds them; under AMP
  every element within 2 x lr x steps (Adam's step is at most ~lr, and a
  gradient near 0 may flip its sign on one side) and at most 1% of the
  elements more than lr / 2 apart (0.18% bf16, 0.06% fp16 were seen); a
  wrong cast, scale or merge moves most of them. LARS's update is
  proportional to the gradient, so its weights are held to 1e-5; Lamb's
  step is Adam's update scaled per leaf by the trust ratio |w| / |r|, in
  fp32 here: within 1e-4 (3.3e-5 was seen; the norms' fp32 sums run in
  another order).
"""
import warnings

import numpy as np
import pytest
import torch

from _torch_port import assert_params_match, one_cpu_mesh, train_batches, \
    train_models

LR = 1e-3
CASES = {
    # name: (strategy fields, optimizer, K a chunk, chunks)
    "amp_bf16": ({"amp": True}, "adamw", 4, 1),
    "amp_fp16": ({"amp": True, "amp_configs": {
        "dtype": "float16", "incr_every_n_steps": 2}}, "adamw", 1, 5),
    "fp16_overflow_recovers": ({"amp": True, "amp_configs": {
        "dtype": "float16", "init_loss_scaling": 1e12,
        "decr_every_n_nan_or_inf": 1, "decr_ratio": 1e-10}}, "adamw", 1, 4),
    "fp16_overflow_decays_by_0.8": ({"amp": True, "amp_configs": {
        "dtype": "float16", "init_loss_scaling": 1e12,
        "decr_every_n_nan_or_inf": 1}}, "adamw", 1, 4),
    "merge_k2_avg": ({"gradient_merge": True, "gradient_merge_configs": {
        "k_steps": 2}}, "adamw", 4, 2),
    "merge_k3_sum_across_chunks": ({"gradient_merge": True,
                                    "gradient_merge_configs": {
                                        "k_steps": 3, "avg": False}},
                                   "adamw", 4, 2),
    "merge_k2_fp16_overflow": ({"amp": True, "amp_configs": {
        "dtype": "float16", "init_loss_scaling": 1e12,
        "decr_every_n_nan_or_inf": 1, "decr_ratio": 1e-10},
        "gradient_merge": True, "gradient_merge_configs": {"k_steps": 2}},
        "adamw", 3, 2),
    "recompute_bf16": ({"amp": True, "recompute": True,
                        "gradient_merge": True,
                        "gradient_merge_configs": {"k_steps": 2}},
                       "adamw", 4, 1),
    "selective_recompute": ({"amp": True, "recompute": True,
                             "recompute_configs": {
                                 "checkpoints": ["gpt.layers.1"]}},
                            "adamw", 3, 1),
    "offload": ({"sharding": True, "sharding_configs": {
        "stage": 2, "offload": True}}, "adamw", 3, 2),
    "fp16_allreduce": ({"fp16_allreduce": True}, "adamw", 3, 1),
    "lars": ({"lars": True}, "momentum", 3, 1),
    "lamb": ({"lamb": True, "lamb_configs": {
        "exclude_from_weight_decay": ["bias", "norm"]}}, "adamw", 3, 1),
}


def _optimizers(kind, jm, tm):
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    jc, tc = paddle.nn.ClipGradByGlobalNorm(1.0), ClipGradByGlobalNorm(1.0)
    if kind == "momentum":
        return (jopt.Momentum(learning_rate=LR, momentum=0.9,
                              parameters=jm.parameters(), grad_clip=jc),
                topt.Momentum(learning_rate=LR, momentum=0.9,
                              parameters=tm.parameters(), grad_clip=tc))
    return (jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                       weight_decay=0.01, grad_clip=jc),
            topt.AdamW(learning_rate=LR, parameters=tm.parameters(),
                       weight_decay=0.01, grad_clip=tc))


def _strategies(fields, K):
    from paddle_tpu.distributed.strategy import DistributedStrategy as JS
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    out = []
    for s in (JS(), DistributedStrategy()):
        for k, v in fields.items():
            setattr(s, k, v)
        s.scan_steps = K
        out.append(s)
    return out


def _jax_step(jm, jo, js):
    """The JAX step as the JAX parallelize builds it, without donation."""
    from paddle_tpu.distributed.fleet.strategy_compiler import \
        StrategyCompiler
    from paddle_tpu.parallel.api import (ScanTrainStep, ShardedTrainStep,
                                         apply_selective_remat)
    mesh = one_cpu_mesh()
    plan = StrategyCompiler().compile(js, jo, mesh)
    if plan.remat and plan.recompute_checkpoints:
        assert apply_selective_remat(jm, plan.recompute_checkpoints)
    if plan.scan_steps > 1:
        return ScanTrainStep(jm, jo, mesh, plan=plan, donate=False)
    return ShardedTrainStep(jm, jo, mesh, plan=plan, donate=False)


def _scalars(extras):
    return {k: np.asarray(v).item() for k, v in extras.items()
            if k != "accum"}


def _run_case(name):
    from paddle_tpu_torch.bridge import export_state
    from paddle_tpu_torch.parallel import ScanTrainStep, parallelize
    fields, kind, K, chunks = CASES[name]
    jm, tm = train_models()
    p0 = export_state(tm)
    jo, to = _optimizers(kind, jm, tm)
    js, ts = _strategies(fields, K)
    jstep = _jax_step(jm, jo, js)
    step = parallelize(tm, to, strategy=ts, device="cpu")
    assert isinstance(step, ScanTrainStep) == (K > 1)
    ids, labels = train_batches(0, K=K * chunks)
    losses, trajectory = [], []
    for c in range(chunks):
        sl = slice(c * K, (c + 1) * K)
        a, b = (ids[sl], labels[sl]) if K > 1 else (ids[c], labels[c])
        want = np.atleast_1d(np.asarray(jstep(a, b).data))
        got = np.atleast_1d(step(a, b).numpy())
        losses.append((got, want))
        jx, tx = _scalars(jstep._extras), _scalars(step._extras)
        assert tx == jx, (c, tx, jx)
        trajectory.append(tx)
    return jstep, step, tm, p0, losses, trajectory


def _assert_amp_weights(jax_params, tm, steps):
    from paddle_tpu_torch.bridge import export_state
    got = export_state(tm)
    far = total = 0
    for k, v in jax_params.items():
        d = np.abs(got[k] - np.asarray(v, np.float32))
        assert d.max() <= 2 * LR * steps, (k, float(d.max()))
        far += int((d > LR / 2).sum())
        total += d.size
    assert far <= 0.01 * total, (far, total)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_step_matches_jax(name):
    fields, kind, K, chunks = CASES[name]
    jstep, step, tm, p0, losses, traj = _run_case(name)
    steps = K * chunks
    amp = fields.get("amp_configs", {}).get("dtype", "bfloat16") \
        if fields.get("amp") else None
    atol = {None: 1e-5, "bfloat16": 1e-3, "float16": 2.5e-4}[amp]
    for got, want in losses:
        np.testing.assert_allclose(got, want, atol=atol,
                                   rtol=1e-5 if amp is None else 0)
    assert step._step_count == jstep._step_count == steps
    if kind == "momentum":
        from paddle_tpu_torch.bridge import export_state
        got = export_state(tm)
        for k, v in jstep._params.items():
            np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-5,
                                       rtol=1e-5)
        assert type(step.optimizer).__name__ == "LarsMomentum"
    elif "lamb" in fields:
        assert type(step.optimizer).__name__ == "Lamb"
        from paddle_tpu_torch.bridge import export_state
        got = export_state(tm)
        for k, v in jstep._params.items():
            np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-4,
                                       rtol=0)
    elif amp is None:
        assert_params_match(jstep._params, tm, steps, lr=LR)
    else:
        _assert_amp_weights(jstep._params, tm, steps)
    if name.startswith("fp16_overflow"):
        assert traj[0]["loss_scale"] == np.float32(1e12) * np.float32(
            fields["amp_configs"].get("decr_ratio", 0.8))
    if name == "fp16_overflow_decays_by_0.8":
        # every step overflows: nothing moved, and the scale is 0.8^4 of
        # where it began, rounded in fp32 at each step
        from paddle_tpu_torch.bridge import export_state
        got = export_state(tm)
        for k in p0:
            np.testing.assert_array_equal(got[k], p0[k])
        s = np.float32(1e12)
        for t in traj:
            s = np.float32(s * np.float32(0.8))
            assert t["loss_scale"] == s and t["bad_steps"] == 0
    if name == "amp_fp16":
        assert [t["loss_scale"] for t in traj] == [32768.0, 65536.0,
                                                   65536.0, 131072.0,
                                                   131072.0]


def test_offload_keeps_state_on_the_host_between_updates():
    jstep, step, tm, p0, losses, traj = _run_case("offload")
    slots = [t for s in step.optimizer.state.values() for t in s.values()]
    assert slots and all(t.device.type == "cpu" for t in slots)
    assert step.zero_stage == 2


def test_bridge_carries_step_extras():
    from paddle_tpu_torch.bridge import load_jax_step_extras
    from paddle_tpu_torch.parallel import parallelize
    fields, kind, K, chunks = CASES["merge_k2_fp16_overflow"]
    jm, tm = train_models()
    jo, to = _optimizers(kind, jm, tm)
    js, ts = _strategies(fields, K)
    jstep = _jax_step(jm, jo, js)
    ids, labels = train_batches(0, K=K)
    jstep(ids, labels)
    step = parallelize(tm, to, strategy=ts, device="cpu")
    load_jax_step_extras(step, {k: (v if k != "accum" else
                                    {n: np.asarray(a) for n, a in v.items()})
                                for k, v in jstep._extras.items()})
    assert _scalars(step._extras) == _scalars(jstep._extras)
    for n, a in jstep._extras["accum"].items():
        np.testing.assert_array_equal(step._extras["accum"][n].numpy(),
                                      np.asarray(a))


_ITEM8, _ITEM9 = "ROADMAP §1 item 8", "ROADMAP §1 item 9"
# the mp_degree case ran under item 8 until multi-rank training came: now
# it runs in a running hybrid group of 2 ranks
# (tests/test_torch_tensor_parallel.py), and outside one it raises on
# the missing group; its id stays
_REFUSED_CASES = [
    ({"pipeline": True}, _ITEM8 + "b", NotImplementedError),
    ({"localsgd": True}, _ITEM8 + "d", NotImplementedError),
    ({"adaptive_localsgd": True}, _ITEM8 + "d", NotImplementedError),
    ({"hybrid_configs": {"sep_degree": 2}}, _ITEM8 + "c",
     NotImplementedError),
    ({"hybrid_configs": {"mp_degree": 2}}, "running hybrid group",
     RuntimeError),
    ({"asp": True}, _ITEM9, NotImplementedError),
    ({"qat": True}, _ITEM9, NotImplementedError),
    ({"hybrid_configs": {"pp_degree": 2}}, _ITEM8 + "b",
     NotImplementedError),
]


@pytest.mark.parametrize("fields,match,exc", [
    pytest.param(f, m, e, id=f"fields{i}-{_ITEM9 if m == _ITEM9 else _ITEM8}")
    for i, (f, m, e) in enumerate(_REFUSED_CASES)])
def test_refused_fields_raise_naming_their_item(fields, match, exc):
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.parallel import parallelize
    _, tm = train_models()
    s = DistributedStrategy()
    for k, v in fields.items():
        setattr(s, k, v)
    before = [m.forward for m in tm.modules()]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(exc, match=match):
            parallelize(tm, None, strategy=s, device="cpu")
    assert [m.forward for m in tm.modules()] == before


def test_multi_device_mesh_and_sequence_parallel():
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import parallelize
    _, tm = train_models()
    opt = AdamW(parameters=tm.parameters())
    with pytest.raises(NotImplementedError, match="one process a rank"):
        parallelize(tm, opt, mesh=["cpu", "cpu"])
    s = DistributedStrategy()
    s.sequence_parallel = True
    with pytest.warns(UserWarning, match="WITHOUT sequence parallelism"):
        step = parallelize(tm, opt, strategy=s, device="cpu")
    ids, labels = train_batches(1)
    assert torch.isfinite(step(ids[0], labels[0]))


def test_selective_recompute_that_matches_nothing_falls_back():
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import parallelize
    _, tm = train_models()
    s = DistributedStrategy()
    s.recompute = True
    s.recompute_configs = {"checkpoints": ["no.such.layer"]}
    with pytest.warns(UserWarning, match="whole-loss"):
        step = parallelize(tm, AdamW(parameters=tm.parameters()),
                           strategy=s, device="cpu")
    assert step.plan.recompute_checkpoints == []
    ids, labels = train_batches(2)
    assert torch.isfinite(step(ids[0], labels[0]))
