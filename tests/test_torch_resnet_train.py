"""ResNet training through the port's `ScanTrainStep` against the JAX
package's, on the CPU: BASELINE config 1's path (CrossEntropyLoss over
the logits, AdamW) at a small size.

`resnet18` (10 classes) in fp32, both sides from the same weights and
buffers (bridged), K = 3 steps over three batches of 4 x 3 x 64 x 64
images (so every BatchNorm reduces at least 16 values a channel;
tests/test_torch_conv_pool_bn.py says why), AdamW at bench.py's lr 1e-4,
weight decay 0.01. The JAX step runs on a one-CPU mesh without donation.
At lr 1e-3 the first step's loss still agrees to 5e-6, but with 4 images
and random labels the next steps amplify fp32 rounding (sums in another
order) chaotically: 31% of the weights were more than 1e-5 apart after 3
steps, on a path whose every piece is held to JAX on its own above; at
bench.py's lr the trajectories stay together. Limits:

- losses within atol = rtol = 1e-4 (fp32 logits ~1e-5 apart, as
  tests/test_torch_resnet.py holds them);
- parameters as `assert_params_match` holds them (every element within
  2 x lr x steps; at most 1e-4 of them more than 1e-5 apart);
- the running statistics, which the step moves once a step inside its
  forward, within atol = rtol = 1e-4, as the logits.
"""
import numpy as np
import pytest
import torch

from _torch_port import (assert_params_match, one_cpu_mesh, resnet_batches,
                         resnet_twins)

K = 3
LR = 1e-4
TOL = 1e-4


def _optimizers(jm, tm):
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch.optimizer import AdamW
    return (jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                       weight_decay=0.01),
            AdamW(learning_rate=LR, parameters=tm.parameters(),
                  weight_decay=0.01))


def assert_buffers_match(jax_buffers, tm):
    from paddle_tpu_torch.bridge import export_buffers
    got = export_buffers(tm)
    assert got.keys() == jax_buffers.keys()
    for k, v in jax_buffers.items():
        np.testing.assert_allclose(got[k], np.asarray(v, np.float32),
                                   atol=TOL, rtol=TOL, err_msg=k)


def test_resnet_scan_train_step_matches_jax():
    import paddle_tpu.nn as jnn
    from paddle_tpu.parallel import ScanTrainStep as JaxScan
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.bridge import export_buffers
    from paddle_tpu_torch.parallel import ScanTrainStep
    jm, tm = resnet_twins(18, num_classes=10)
    b0 = export_buffers(tm)
    jo, to = _optimizers(jm, tm)
    x, y = resnet_batches(0, K=K)
    jstep = JaxScan(jm, jo, one_cpu_mesh(), scan_steps=K, zero_stage=0,
                    donate=False, loss_fn=jnn.CrossEntropyLoss())
    want = np.asarray(jstep(x, y).data)
    step = ScanTrainStep(tm, to, scan_steps=K, device="cpu",
                         loss_fn=tnn.CrossEntropyLoss())
    got = step(x, y)
    assert got.shape == (K,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert_params_match(jstep._params, tm, K, lr=LR)
    assert_buffers_match(jstep._buffers, tm)
    moved = export_buffers(tm)
    assert all(not np.array_equal(moved[k], b0[k]) for k in b0)
    assert all(p.grad is None for p in tm.parameters())


def _conv_bn(nn, **kw):
    return nn.Sequential(("conv", nn.Conv2D(3, 4, 3, padding=1, **kw)),
                         ("bn", nn.BatchNorm2D(4, **kw)),
                         ("pool", nn.AdaptiveAvgPool2D(1)),
                         ("flat", nn.Flatten()), ("fc", nn.Linear(4, 10,
                                                                  **kw)))


def test_selective_recompute_of_batch_norm_is_refused_as_jax_cannot():
    """Selective recompute of a sublayer holding BatchNorm buffers (a
    conv, BatchNorm, pool, linear net, recomputing `bn`): the JAX step
    cannot trace it (the running statistics leak a tracer out of
    jax.checkpoint); the port refuses it before wrapping anything."""
    import jax
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.distributed.fleet.strategy_compiler import \
        StrategyCompiler as JaxCompiler
    from paddle_tpu.distributed.strategy import \
        DistributedStrategy as JaxStrategy
    from paddle_tpu.parallel.api import ShardedTrainStep as JaxStep
    from paddle_tpu.parallel.api import \
        apply_selective_remat as jax_selective
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.parallel import parallelize
    paddle.seed(0)
    jm, tm = _conv_bn(jnn), _conv_bn(tnn, device="cpu")
    jo, to = _optimizers(jm, tm)
    js = JaxStrategy()
    js.recompute = True
    js.recompute_configs = {"checkpoints": ["bn"]}
    mesh = one_cpu_mesh()
    plan = JaxCompiler().compile(js, jo, mesh)
    assert jax_selective(jm, plan.recompute_checkpoints) == ["bn"]
    jstep = JaxStep(jm, jo, mesh, plan=plan, donate=False,
                    loss_fn=jnn.CrossEntropyLoss())
    x, y = resnet_batches(1, K=1, S=8)
    with pytest.raises(jax.errors.UnexpectedTracerError):
        jstep(x[0], y[0])
    ts = DistributedStrategy()
    ts.recompute = True
    ts.recompute_configs = {"checkpoints": ["bn"]}
    before = [m.forward for m in tm.modules()]
    with pytest.raises(NotImplementedError,
                       match=r"bn\._mean.*whole loss"):
        parallelize(tm, to, strategy=ts, loss_fn=tnn.CrossEntropyLoss(),
                    device="cpu")
    assert [m.forward for m in tm.modules()] == before
