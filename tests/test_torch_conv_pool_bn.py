"""The port's convolutions, pools and BatchNorm against the JAX package.

Inputs come from numpy seeds and go through the JAX functional (on the
CPU) and the port's (`device="cpu"`), forward and backward: the output
and the gradients of sum(out * cot) for a random cotangent, from one
`jax.vjp` and from autograd. fp32 throughout, except the bf16 BatchNorm
buffers.

Tolerances, each stated at its test:
- convolutions: atol = rtol = 1e-5. Each output sums at most 72
  products and each weight gradient at most ~150, in another order on
  the two sides (XLA's and oneDNN's/ATen's convolutions): ~1e-6 of their
  magnitudes (O(1)-O(10)).
- pools: max pools' outputs and masks exactly equal (a max is one of the
  inputs; random normal inputs hold no ties); their gradients, and
  averages, atol = rtol = 1e-6 (an input under several overlapping
  windows sums up to 8 cotangents, in another order; an average sums at
  most 27 terms, then divides).
- BatchNorm: atol = rtol = 1e-5 for the output, the gradients and fp32
  running statistics (fp32 means and variances over 64 values a channel,
  summed in another order). bf16 buffers and outputs: within one bf16
  ulp of the larger magnitude (+1e-6): both sides round an fp32 value
  that differs by ~1e-7 between them.

Sizes: every BatchNorm reduces at least 16 values a channel (4 x 4 x 4
for 4-D inputs, 16 rows for [N, C]). With 2 values a channel both
frameworks divide by a variance that rounding dominates, and their
outputs part by far more than these limits for no fault of either; 16
keeps the comparison about the port, not about that conditioning.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import ulp_bf16

CONV_TOL = 1e-5
AVG_TOL = 1e-6
BN_TOL = 1e-5


def _jax_vjp(fn, arrays, seed):
    """(out, [gradients of sum(out * cot) w.r.t. every array], cot) of the
    JAX functional fn over paddle_tpu Tensors, in one `jax.vjp`; cot is
    drawn from `seed` in out's shape."""
    from paddle_tpu.core.tensor import Tensor

    def f(*arrs):
        out = fn(*[Tensor(a) for a in arrs])
        return (out[0] if isinstance(out, tuple) else out).data

    out, vjp = jax.vjp(f, *[jnp.asarray(a) for a in arrays])
    cot = np.random.RandomState(seed).standard_normal(out.shape).astype(
        np.float32)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))], \
        cot


def _port_vjp(fn, arrays, cot):
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    out = fn(*ts)
    out = out[0] if isinstance(out, tuple) else out
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(got, want, tol, grad_tol=None):
    np.testing.assert_allclose(got[0], want[0], atol=tol, rtol=tol)
    grad_tol = tol if grad_tol is None else grad_tol
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, atol=grad_tol, rtol=grad_tol)


def _conv_case(n, padding, stride, dilation, groups, bias, channel_last,
               seed=0):
    rng = np.random.RandomState(seed)
    spatial = {1: (9,), 2: (7, 6), 3: (5, 4, 5)}[n]
    cin, cout, k = 4, 6, 3
    x = rng.standard_normal((2, cin) + spatial).astype(np.float32)
    if channel_last:
        x = np.moveaxis(x, 1, -1).copy()
    w = rng.standard_normal((cout, cin // groups) + (k,) * n).astype(
        np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    fmt = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"),
           3: ("NCDHW", "NDHWC")}[n][int(channel_last)]
    return x, w, b, fmt


CONV_CASES = {
    "int": dict(padding=1),
    "zero": dict(padding=0),
    "per_dim": dict(padding="per_dim"),
    "pairs_flat": dict(padding="pairs_flat"),
    "pairs_nested": dict(padding="pairs_nested"),
    "same": dict(padding="SAME"),
    "same_stride2": dict(padding="SAME", stride=2),
    "valid": dict(padding="VALID"),
    "stride2": dict(padding=1, stride=2),
    "dilation2": dict(padding=2, dilation=2),
    "same_dilation2": dict(padding="same", dilation=2),
    "groups2": dict(padding=1, groups=2),
    "no_bias": dict(padding=1, bias=False),
    "channel_last": dict(padding=1, channel_last=True),
    "channel_last_pairs": dict(padding="pairs_flat", channel_last=True,
                               stride=2),
}


def _padding_form(form, n):
    if form == "per_dim":
        return [1 + i % 2 for i in range(n)]
    if form == "pairs_flat":
        return [v for i in range(n) for v in (i % 2, 1 + (i + 1) % 2)]
    if form == "pairs_nested":
        return [[1, 0] if i % 2 == 0 else [0, 2] for i in range(n)]
    return form


# every case in 2-D; the forms that reach other code paths in 1-D and 3-D
CONV_1D_3D = ("int", "pairs_flat", "same_stride2", "groups2", "channel_last")


@pytest.mark.parametrize("n,case", [(2, c) for c in sorted(CONV_CASES)]
                         + [(n, c) for n in (1, 3) for c in CONV_1D_3D])
def test_conv_matches_jax(n, case):
    """conv1d/2d/3d forward and the gradients of x, weight and bias:
    atol = rtol = CONV_TOL (module docstring)."""
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    c = dict(stride=1, dilation=1, groups=1, bias=True, channel_last=False)
    c.update(CONV_CASES[case])
    x, w, b, fmt = _conv_case(n, c["padding"], c["stride"], c["dilation"],
                              c["groups"], c["bias"], c["channel_last"])
    kw = dict(stride=c["stride"], padding=_padding_form(c["padding"], n),
              dilation=c["dilation"], groups=c["groups"], data_format=fmt)
    name = f"conv{n}d"
    arrays = [x, w, b] if c["bias"] else [x, w]

    def call(F):
        return lambda *a: getattr(F, name)(*a[:2], *a[2:], **kw)

    *want, cot = _jax_vjp(call(JF), arrays, 1)
    got = _port_vjp(call(TF), arrays, cot)
    assert got[0].shape == want[0].shape
    _close(got, want, CONV_TOL)


def test_conv_layers_match_jax_names_and_init():
    """Conv1D/2D/3D: the JAX layers' parameter names and shapes, no bias
    with bias_attr=False, weights and bias within the init's
    Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)), and the forward equal to
    the functional."""
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.nn.functional as TF
    gen = torch.Generator().manual_seed(0)
    for cls, n in (("Conv1D", 1), ("Conv2D", 2), ("Conv3D", 3)):
        for bias_attr in (None, False):
            jl = getattr(jnn, cls)(4, 6, 3, stride=2, padding=1, groups=2,
                                   bias_attr=bias_attr)
            tl = getattr(tnn, cls)(4, 6, 3, stride=2, padding=1, groups=2,
                                   bias_attr=bias_attr, device="cpu")
            tl.reset_parameters(gen)
            want = {k: tuple(p.shape) for k, p in jl.named_parameters()}
            assert {k: tuple(p.shape) for k, p in tl.named_parameters()} \
                == want
            assert (tl.bias is None) == (bias_attr is False)
            bound = 1 / np.sqrt(2 * 3 ** n)
            for p in tl.parameters():
                top = float(p.detach().abs().max())
                assert bound / 2 < top <= bound
            x = torch.randn((2, 4) + (5,) * n, generator=gen)
            np.testing.assert_array_equal(
                tl(x).detach().numpy(),
                getattr(TF, f"conv{n}d")(x, tl.weight, tl.bias, 2, 1, 1,
                                         2).detach().numpy())


def _pool_input(n, seed=0, channel_last=False):
    rng = np.random.RandomState(seed)
    spatial = {1: (11,), 2: (9, 8), 3: (7, 6, 7)}[n]
    x = rng.standard_normal((2, 3) + spatial).astype(np.float32)
    return np.moveaxis(x, 1, -1).copy() if channel_last else x


POOL_CASES = {
    "k3s2p1": dict(kernel_size=3, stride=2, padding=1),
    "k3s2p1_ceil": dict(kernel_size=3, stride=2, padding=1, ceil_mode=True),
    "k2_default_stride": dict(kernel_size=2),
    "k2_ceil": dict(kernel_size=2, ceil_mode=True),
    "k3s2_pad2": dict(kernel_size=3, stride=2, padding=2),
    "k3s2_pad2_ceil": dict(kernel_size=3, stride=2, padding=2,
                           ceil_mode=True),
    "k3s2_pairs": dict(kernel_size=3, stride=2, padding="pairs"),
    "k3s2_pairs_ceil": dict(kernel_size=3, stride=2, padding="pairs",
                            ceil_mode=True),
    "k3s2_same": dict(kernel_size=3, stride=2, padding="SAME"),
    "k3s2_valid": dict(kernel_size=3, stride=2, padding="VALID"),
}


def _pool_padding(p, n):
    return [[0, 1] if i % 2 == 0 else [1, 0] for i in range(n)] \
        if p == "pairs" else p


# every case in 2-D; torch's own padding, explicit padding and the ceil
# extension in 1-D and 3-D
POOL_1D_3D = ("k3s2p1_ceil", "k3s2_pad2", "k3s2_pairs_ceil")


@pytest.mark.parametrize("n,case", [(2, c) for c in sorted(POOL_CASES)]
                         + [(n, c) for n in (1, 3) for c in POOL_1D_3D])
@pytest.mark.parametrize("kind", ["max", "avg_exclusive", "avg_inclusive"])
def test_pool_matches_jax(kind, case, n):
    """max_pool*d (exactly equal; gradient AVG_TOL) and avg_pool*d with
    exclusive on and off (AVG_TOL) over every padding form, with and
    without ceil_mode."""
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    kw = dict(POOL_CASES[case])
    kw["padding"] = _pool_padding(kw.get("padding", 0), n)
    name = f"{'max' if kind == 'max' else 'avg'}_pool{n}d"
    if kind != "max":
        kw["exclusive"] = kind == "avg_exclusive"
    x = _pool_input(n)
    *want, cot = _jax_vjp(lambda a: getattr(JF, name)(a, **kw), [x], 2)
    got = _port_vjp(lambda a: getattr(TF, name)(a, **kw), [x], cot)
    assert got[0].shape == want[0].shape
    _close(got, want, 0.0 if kind == "max" else AVG_TOL, AVG_TOL)


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool_channel_last_and_divisor_match_jax(kind):
    """NHWC and NDHWC pools, and avg's divisor_override: as above."""
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    for n, fmt in ((2, "NHWC"), (3, "NDHWC")):
        x = _pool_input(n, seed=3, channel_last=True)
        kw = dict(kernel_size=3, stride=2, padding=1, data_format=fmt,
                  ceil_mode=True)
        if kind == "avg":
            kw["divisor_override"] = 5
        name = f"{kind}_pool{n}d"
        want = np.asarray(getattr(JF, name)(x, **kw).data)
        got = getattr(TF, name)(torch.from_numpy(x), **kw).numpy()
        np.testing.assert_allclose(got, want, atol=AVG_TOL, rtol=AVG_TOL)


@pytest.mark.parametrize("n,padding", [(2, p) for p in (0, 1, 2, "pairs")]
                         + [(1, 1), (1, "pairs"), (3, 2)])
def test_max_pool_mask_matches_jax(n, padding):
    """return_mask: each max's flat index in its (N, C) input volume,
    int32, exactly equal (torch's own padding and explicit padding)."""
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    x = _pool_input(n, seed=4)
    kw = dict(kernel_size=3, stride=2, padding=_pool_padding(padding, n),
              return_mask=True)
    wo, wm = getattr(JF, f"max_pool{n}d")(x, **kw)
    go, gm = getattr(TF, f"max_pool{n}d")(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(go.numpy(), np.asarray(wo.data))
    assert gm.dtype == torch.int32
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm.data))


@pytest.mark.parametrize("n,out", [(1, 3), (2, 3), (3, 3), (2, 1), (2, 7)])
@pytest.mark.parametrize("kind", ["avg", "max"])
def test_adaptive_pool_matches_jax(n, kind, out):
    """adaptive_{avg,max}_pool*d from 7 to 3 (uneven bins [0,3) [2,5)
    [4,7)), 1 and 7 a dim, forward and gradient; max's output and mask
    exactly, the rest within AVG_TOL."""
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    x = np.random.RandomState(5).standard_normal(
        (2, 3) + (7,) * n).astype(np.float32)
    name = f"adaptive_{kind}_pool{n}d"
    *want, cot = _jax_vjp(lambda a: getattr(JF, name)(a, out), [x], 6)
    got = _port_vjp(lambda a: getattr(TF, name)(a, out), [x], cot)
    _close(got, want, 0.0 if kind == "max" else AVG_TOL, AVG_TOL)
    if kind == "max":
        wo, wm = getattr(JF, name)(x, out, return_mask=True)
        go, gm = getattr(TF, name)(torch.from_numpy(x), out,
                                   return_mask=True)
        assert gm.dtype == torch.int32
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm.data))


def test_adaptive_avg_pool_channel_last_matches_jax():
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    x = np.random.RandomState(7).standard_normal((2, 7, 5, 3)).astype(
        np.float32)
    want = np.asarray(JF.adaptive_avg_pool2d(x, (3, 2),
                                             data_format="NHWC").data)
    got = TF.adaptive_avg_pool2d(torch.from_numpy(x), (3, 2),
                                 data_format="NHWC").numpy()
    np.testing.assert_allclose(got, want, atol=AVG_TOL, rtol=AVG_TOL)


def test_pool_refuses_ceil_mode_with_valid():
    import paddle_tpu_torch.nn.functional as TF
    with pytest.raises(ValueError, match="VALID"):
        TF.max_pool2d(torch.zeros(1, 1, 4, 4), 2, padding="VALID",
                      ceil_mode=True)


def _bn_data(shape, ch_axis, seed):
    rng = np.random.RandomState(seed)
    C = shape[ch_axis]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (C,)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    rm = rng.standard_normal((C,)).astype(np.float32) * 0.1
    rv = rng.uniform(0.5, 2.0, (C,)).astype(np.float32)
    return x, w, b, rm, rv


BN_SHAPES = {"NCHW": ((4, 5, 4, 4), 1), "NHWC": ((4, 4, 4, 5), 3),
             "NC": ((16, 5), 1), "NCL": ((4, 5, 16), 1),
             "NLC": ((4, 16, 5), 2), "NCDHW": ((2, 5, 2, 4, 4), 1)}


@pytest.mark.parametrize("layout", sorted(BN_SHAPES))
@pytest.mark.parametrize("mode", ["training", "eval", "global_stats"])
def test_batch_norm_matches_jax(layout, mode):
    """batch_norm's output, its gradients (x, weight, bias) and the
    running statistics it leaves, in training (batch statistics, buffers
    moved), eval (running statistics) and training with use_global_stats
    (running statistics, buffers left alone): BN_TOL."""
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.core.tensor import Tensor
    import paddle_tpu_torch.nn.functional as TF
    shape, ch = BN_SHAPES[layout]
    x, w, b, rm, rv = _bn_data(shape, ch, seed=len(layout))
    fmt = layout if len(shape) > 2 else "NCHW"
    kw = dict(training=mode != "eval", momentum=0.9, epsilon=1e-5,
              data_format=fmt,
              use_global_stats=True if mode == "global_stats" else None)
    # the running statistics of one eager JAX call
    jrm, jrv = Tensor(jnp.asarray(rm)), Tensor(jnp.asarray(rv))
    JF.batch_norm(Tensor(jnp.asarray(x)), jrm, jrv, Tensor(jnp.asarray(w)),
                  Tensor(jnp.asarray(b)), **kw)
    # the output and gradients from a traced call on throwaway buffers
    # (its eager buffer update would leave tracers in them)
    *want, cot = _jax_vjp(
        lambda a, ww, bb: JF.batch_norm(a, Tensor(jnp.asarray(rm)),
                                        Tensor(jnp.asarray(rv)), ww, bb,
                                        **kw),
        [x, w, b], 8)
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    got = _port_vjp(
        lambda a, ww, bb: TF.batch_norm(a, trm, trv, ww, bb, **kw),
        [x, w, b], cot)
    _close(got, want, BN_TOL)
    np.testing.assert_allclose(trm.numpy(), np.asarray(jrm.data),
                               atol=BN_TOL, rtol=BN_TOL)
    np.testing.assert_allclose(trv.numpy(), np.asarray(jrv.data),
                               atol=BN_TOL, rtol=BN_TOL)
    moved = mode == "training"
    assert (not np.array_equal(trm.numpy(), rm)) == moved
    assert (not np.array_equal(trv.numpy(), rv)) == moved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cls,shape,fmt", [
    ("BatchNorm2D", (4, 6, 4, 4), "NCHW"),
    ("BatchNorm2D", (4, 4, 4, 6), "NHWC"),
    ("BatchNorm1D", (16, 6), "NCHW"),
    ("BatchNorm", (4, 6, 4, 4), "NCHW")])
def test_batch_norm_layer_running_stats_match_jax(cls, shape, fmt, dtype):
    """Three training forwards of a BatchNorm layer over three inputs:
    the outputs and the `_mean`/`_variance` buffers after each, with
    Paddle's momentum (0.9 on the old value) and the unbiased variance;
    then one eval forward. fp32: BN_TOL. bf16 (the layer cast with its
    buffers, as `model.to(dtype="bfloat16")` casts them in both
    packages): outputs and buffers within one bf16 ulp (module
    docstring), and the buffers stay bf16."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch.nn as tnn
    C = shape[-1] if fmt == "NHWC" else shape[1]
    kw = {"data_layout": fmt} if cls == "BatchNorm" else \
        {"data_format": fmt}
    jl = getattr(jnn, cls)(C, **kw)
    tl = getattr(tnn, cls)(C, device="cpu", **kw)
    tl.reset_parameters()
    assert [k for k, _ in tl.named_buffers()] == ["_mean", "_variance"] \
        == [k for k, _ in jl.named_buffers()]
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        jl.to(dtype="bfloat16")
        tl.to(torch.bfloat16)
    rng = np.random.RandomState(9)

    def close(got, want):
        got = got.detach().float().numpy()
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=BN_TOL, rtol=BN_TOL)
        else:
            bound = ulp_bf16(np.maximum(np.abs(got), np.abs(want))) + 1e-6
            assert (np.abs(got - want) <= bound).all(), float(
                np.abs(got - want).max())

    for i in range(4):
        if i == 3:
            jl.eval()
            tl.eval()
        x = (rng.standard_normal(shape) * (1 + i) + i).astype(np.float32)
        jx = paddle.to_tensor(x)
        if dtype == "bfloat16":
            jx = jx.astype("bfloat16")
        want = np.asarray(jl(jx).data.astype(jnp.float32))
        got = tl(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        close(got.detach(), want)
        close(tl._mean, np.asarray(jl._mean.data.astype(jnp.float32)))
        close(tl._variance,
              np.asarray(jl._variance.data.astype(jnp.float32)))
        assert tl._mean.dtype == tl._variance.dtype == tdt


def test_sync_batch_norm_convert_keeps_tensors():
    """convert_sync_batchnorm swaps every BatchNorm below a layer (and a
    BatchNorm itself) for a SyncBatchNorm holding the same parameters and
    buffers, under the same names; at one process it computes what the
    BatchNorm did, and moves the same buffers."""
    import paddle_tpu_torch.nn as tnn
    gen = torch.Generator().manual_seed(0)
    net = tnn.Sequential(tnn.Conv2D(3, 4, 3, device="cpu"),
                         tnn.BatchNorm2D(4, device="cpu"),
                         tnn.Sequential(("bn", tnn.BatchNorm2D(
                             4, device="cpu"))))
    net[0].reset_parameters(gen)
    params = dict(net.named_parameters())
    bufs = dict(net.named_buffers())
    x = torch.randn(4, 3, 6, 6, generator=gen)
    want = net(x).detach()
    moved = {k: b.clone() for k, b in bufs.items()}
    for k, b in bufs.items():
        b.copy_(torch.zeros_like(b) if k.endswith("_mean")
                else torch.ones_like(b))
    assert tnn.SyncBatchNorm.convert_sync_batchnorm(net) is net
    assert [type(m).__name__ for m in (net[1], net[2].bn)] == \
        ["SyncBatchNorm"] * 2
    assert list(dict(net.named_parameters())) == list(params)
    assert all(t is params[k] for k, t in net.named_parameters())
    assert all(t is bufs[k] for k, t in net.named_buffers())
    np.testing.assert_array_equal(net(x).detach().numpy(), want.numpy())
    for k, b in net.named_buffers():
        np.testing.assert_array_equal(b.numpy(), moved[k].numpy())
    bn = tnn.BatchNorm2D(4, device="cpu").eval()
    sbn = tnn.SyncBatchNorm.convert_sync_batchnorm(bn)
    assert type(sbn).__name__ == "SyncBatchNorm" and not sbn.training
    assert sbn.weight is bn.weight and sbn._mean is bn._mean


def test_conv_layer_refuses_other_padding_modes():
    """The JAX layer takes padding_mode and pads with zeros whatever it
    says; the port pads with zeros and refuses any other mode."""
    import paddle_tpu_torch.nn as tnn
    with pytest.raises(NotImplementedError, match="padding_mode='reflect'"):
        tnn.Conv2D(3, 4, 3, padding_mode="reflect", device="cpu")
