"""A BatchNorm network through `parallelize(model, opt, strategy=s)`
against the JAX step with the same plan on a one-device CPU mesh (built
as the JAX `parallelize` builds it: the model rewritten first, then the
step from the compiler's plan, without donation).

- `sync_batch_norm`: both sides convert every BatchNorm to SyncBatchNorm
  before the step is built; at one device it is BatchNorm.
- whole-loss `recompute`: the JAX step's `jax.checkpoint` returns the
  running statistics of its one forward; the port reruns the forward in
  the backward without moving them a second time.

The network is ResNet's pieces in small: conv, BatchNorm, ReLU, max
pool, conv, BatchNorm, ReLU, adaptive average pool, flatten, linear
(tests/test_torch_resnet_train.py trains the whole resnet18); as in
ResNet the convs have no bias, which a BatchNorm after them would leave
with a gradient of exactly 0, so Adam would move it by rounding noise;
fp32,
4 x 3 x 16 x 16 images (the BatchNorms reduce 1024 and 256 values a
channel), AdamW lr 1e-4, wd 0.01, one chunk of scan_steps = 3. Limits as
tests/test_torch_resnet_train.py states them: losses and running
statistics atol = rtol = 1e-4, parameters by `assert_params_match`.
"""
import warnings

import numpy as np
import pytest

from _torch_port import assert_params_match, one_cpu_mesh, resnet_batches
from test_torch_resnet_train import LR, TOL, _optimizers, \
    assert_buffers_match

CASES = {"sync_batch_norm": {"sync_batch_norm": True},
         "recompute": {"recompute": True}}
K = 3


def _net(nn, **kw):
    return nn.Sequential(
        ("conv1", nn.Conv2D(3, 8, 3, padding=1, bias_attr=False, **kw)),
        ("bn1", nn.BatchNorm2D(8, **kw)), ("relu1", nn.ReLU()),
        ("pool", nn.MaxPool2D(2)),
        ("conv2", nn.Conv2D(8, 8, 3, padding=1, bias_attr=False, **kw)),
        ("bn2", nn.BatchNorm2D(8, **kw)), ("relu2", nn.ReLU()),
        ("gap", nn.AdaptiveAvgPool2D(1)), ("flat", nn.Flatten()),
        ("fc", nn.Linear(8, 10, **kw)))


def _twins():
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.bridge import load_jax_state
    paddle.seed(0)
    jm, tm = _net(jnn), _net(tnn, device="cpu")
    params, bufs = jm.functional_state()
    load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()},
                   {k: np.asarray(v) for k, v in bufs.items()})
    return jm, tm


def _strategy(pkg, fields):
    if pkg == "jax":
        from paddle_tpu.distributed.strategy import DistributedStrategy
    else:
        from paddle_tpu_torch.distributed.strategy import \
            DistributedStrategy
    s = DistributedStrategy()
    for k, v in fields.items():
        setattr(s, k, v)
    s.scan_steps = K
    return s


def _jax_step(jm, jo, js):
    import paddle_tpu.nn as jnn
    from paddle_tpu.distributed.fleet.strategy_compiler import \
        StrategyCompiler
    from paddle_tpu.nn.layer.norm import SyncBatchNorm
    from paddle_tpu.parallel.api import ScanTrainStep
    mesh = one_cpu_mesh()
    plan = StrategyCompiler().compile(js, jo, mesh)
    if plan.sync_batch_norm:
        jm = SyncBatchNorm.convert_sync_batchnorm(jm)
    return ScanTrainStep(jm, jo, mesh, plan=plan, donate=False,
                         loss_fn=jnn.CrossEntropyLoss()), jm


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_norm_plan_step_matches_jax(name):
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.bridge import export_buffers
    from paddle_tpu_torch.parallel import ScanTrainStep, parallelize
    jm, tm = _twins()
    b0 = export_buffers(tm)
    jo, to = _optimizers(jm, tm)
    jstep, jm = _jax_step(jm, jo, _strategy("jax", CASES[name]))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step = parallelize(tm, to, strategy=_strategy("port", CASES[name]),
                           loss_fn=tnn.CrossEntropyLoss(), device="cpu")
    assert isinstance(step, ScanTrainStep)
    kinds = {type(m).__name__ for m in tm.modules()}
    assert ("SyncBatchNorm" in kinds) == (name == "sync_batch_norm")
    assert ("BatchNorm2D" in kinds) == (name != "sync_batch_norm")
    assert bool(step.plan.remat) == (name == "recompute")
    x, y = resnet_batches(3, K=K, S=16)
    want = np.asarray(jstep(x, y).data)
    got = step(x, y).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert_buffers_match(jstep._buffers, tm)
    assert_params_match(jstep._params, tm, K, lr=LR)
    moved = export_buffers(tm)
    assert all(not np.array_equal(moved[k], b0[k]) for k in b0)
