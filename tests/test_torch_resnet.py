"""The port's ResNet family against the JAX package's, on the CPU.

- `resnet18` and `resnet50` have the JAX model's parameter and buffer
  names, shapes and order (`functional_state()`), and `vision.models`
  exports the family.
- With the JAX weights and buffers bridged in, a training-mode forward
  of 4 x 3 x 64 x 64 images (10 classes) gives the same logits and
  leaves the same running statistics; an eval-mode forward then gives
  the same logits. Limits: atol = rtol = 1e-4 for logits and running
  statistics. fp32 sums of up to 4608 products a convolution, in another
  order on the two sides, differ by ~1e-7 of their size; 17 conv and
  BatchNorm layers in a row, each BatchNorm dividing by a batch standard
  deviation computed from such sums, carry that to ~1e-5 at the logits
  (O(1)); a wrong stride, padding, momentum or variance moves them by
  far more.
- `paddle_tpu_torch.flops` equals `paddle_tpu.flops` as an integer at
  [1, 3, 64, 64], and, in training mode, moves the buffers as the JAX
  counter does (zero input: means stay 0, variances fall to 0.9).
- The bridge carries buffers and refuses missing, extra or mis-shaped
  ones by name.

Sizes: at 64 x 64 the last stage is 2 x 2, so with 4 images every
BatchNorm reduces at least 16 values a channel (tests/
test_torch_conv_pool_bn.py says why that matters).
"""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU)

from _torch_port import resnet_twins

LOGIT_TOL = 1e-4


def _jax_resnet(depth, **kw):
    import paddle_tpu as paddle
    paddle.seed(0)
    return getattr(paddle.vision.models, f"resnet{depth}")(**kw)


def _images(seed, B=4, S=64):
    return np.random.RandomState(seed).standard_normal(
        (B, 3, S, S)).astype(np.float32)


@pytest.mark.parametrize("depth", [18, 50])
def test_names_shapes_and_order_match_jax(depth):
    from paddle_tpu_torch.vision import models
    jm = _jax_resnet(depth)
    params, bufs = jm.functional_state()
    tm = getattr(models, f"resnet{depth}")(device="cpu")
    assert [(k, tuple(p.shape)) for k, p in tm.named_parameters()] == \
        [(k, tuple(v.shape)) for k, v in params.items()]
    assert [(k, tuple(b.shape)) for k, b in tm.named_buffers()] == \
        [(k, tuple(v.shape)) for k, v in bufs.items()]
    assert tm.training
    if depth == 50:
        assert len(params) == 161 and len(bufs) == 106
        assert "layer1.0.downsample.1._mean" in bufs


def test_family_exports_and_widths():
    """Every ResNet name the JAX package exports, with its parameter
    count (the JAX models' own)."""
    import paddle_tpu.vision.models as jmodels
    from paddle_tpu_torch.vision import models
    for name in ("resnet34", "wide_resnet50_2"):
        jn = sum(int(np.prod(p.shape))
                 for p in getattr(jmodels, name)(num_classes=10)
                 .parameters())
        tn = sum(p.numel() for p in getattr(models, name)(
            num_classes=10, device="cpu").parameters())
        assert tn == jn
    for name in ("ResNet", "BasicBlock", "BottleneckBlock", "resnet101",
                 "resnet152", "wide_resnet101_2"):
        assert hasattr(models, name)


def test_logits_and_running_stats_match_jax():
    import paddle_tpu as paddle
    from paddle_tpu_torch.bridge import export_buffers
    jm, tm = resnet_twins(18, num_classes=10)
    x = _images(0)
    want = np.asarray(jm(paddle.to_tensor(x)).data)
    got = tm(torch.from_numpy(x))
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    jb = {k: np.asarray(v) for k, v in jm.functional_state()[1].items()}
    tb = export_buffers(tm)
    for k in jb:
        np.testing.assert_allclose(tb[k], jb[k], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=k)
    assert not np.array_equal(tb["layer4.1.bn2._variance"],
                              np.ones_like(tb["layer4.1.bn2._variance"]))
    jm.eval()
    tm.eval()
    x = _images(1)
    want = np.asarray(jm(paddle.to_tensor(x)).data)
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert export_buffers(tm).keys() == tb.keys()
    for k, v in export_buffers(tm).items():
        np.testing.assert_array_equal(v, tb[k])   # eval moves nothing


@pytest.mark.parametrize("depth", [50])
def test_flops_matches_jax_and_moves_buffers_alike(depth):
    import paddle_tpu as paddle
    import paddle_tpu_torch
    from paddle_tpu_torch.bridge import export_buffers
    jm, tm = resnet_twins(depth)
    want = paddle.flops(jm, input_size=[1, 3, 64, 64])
    got = paddle_tpu_torch.flops(tm, input_size=[1, 3, 64, 64])
    assert isinstance(got, int) and got == want
    jb = {k: np.asarray(v) for k, v in jm.functional_state()[1].items()}
    tb = export_buffers(tm)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert np.all(tb[k] == (0.0 if k.endswith("_mean")
                                else np.float32(0.9)))


def test_bridge_carries_buffers_and_names_bad_ones():
    from paddle_tpu_torch.bridge import (export_buffers, export_state,
                                         load_jax_state)
    from paddle_tpu_torch.vision.models import resnet18
    tm = resnet18(num_classes=10, device="cpu")
    params, bufs = export_state(tm), export_buffers(tm)
    bufs = {k: v + 1 for k, v in bufs.items()}
    load_jax_state(tm, params, bufs)
    for k, v in export_buffers(tm).items():
        np.testing.assert_array_equal(v, bufs[k])
    tm.to(torch.bfloat16)
    load_jax_state(tm, params, bufs)
    assert tm.bn1._mean.dtype == torch.bfloat16
    missing = dict(bufs)
    missing.pop("bn1._mean")
    with pytest.raises(KeyError, match=r"missing \['bn1._mean'\]"):
        load_jax_state(tm, params, missing)
    with pytest.raises(KeyError, match=r"extra \['bn9._mean'\]"):
        load_jax_state(tm, params, {**bufs, "bn9._mean": np.zeros(3)})
    bad = {**bufs, "bn1._variance": np.zeros(3, np.float32)}
    before = export_state(tm)["conv1.weight"]
    with pytest.raises(ValueError, match=r"bn1._variance: jax \(3,\)"):
        load_jax_state(tm, {k: v * 0 for k, v in params.items()}, bad)
    # nothing was copied
    np.testing.assert_array_equal(export_state(tm)["conv1.weight"], before)

