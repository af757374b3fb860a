"""AMP in the PyTorch port against the JAX package: `auto_cast`'s op lists
at the op boundaries both packages share, `GradScaler`, `decorate`,
`all_finite`, and recompute under `auto_cast`.

- Each autocast op (linear, matmul, softmax, log_softmax) gives the dtype
  the JAX op gives for the same input dtypes, under bf16 and fp16 and with
  custom lists overriding the defaults; values agree within 4 ulps of the
  output dtype at the larger magnitude, plus 1e-6 (a product is rounded
  once after fp32 sums in another order; a low-precision softmax rounds
  its exponentials, their sum and the quotient, in other orders: 2 ulps
  were seen).
- `GradScaler` over a sequence of gradients with injected infs and NaNs:
  the scale, the good and bad counters and which steps were skipped equal
  the JAX class's exactly (decr_ratio 0.8 gives scales that are not powers
  of two); parameters within 1e-6 (SGD on the same unscaled gradients).
- Recompute under `auto_cast` (the model's per-layer recompute, the
  whole-loss and the selective recompute of the strategy step) gives
  gradients bit-equal to the run without recompute: the recomputed
  forward runs under the autocast state of the first.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp


def _ulp(x, dtype):
    """One unit in the last place of `dtype` at |x|."""
    bits = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    a = np.maximum(np.abs(x), np.float32(2.0 ** -14))
    return np.exp2(np.floor(np.log2(a)) - bits)


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    big = np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want) <= 4 * _ulp(big, dtype) + 1e-6).all(), \
        float(np.abs(got - want).max())


def _jdt(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
            torch.float16: jnp.float16}[dtype]


_OPS = ("linear", "matmul", "softmax", "log_softmax")
_CASES = [
    # (autocast dtype, input dtype, custom white, custom black)
    ("bfloat16", torch.float32, None, None),
    ("float16", torch.float32, None, None),
    ("bfloat16", torch.bfloat16, None, None),
    ("float16", torch.float16, None, None),
    ("bfloat16", torch.float32, None, ["linear", "matmul"]),
    ("float16", torch.float16, ["softmax", "log_softmax"], None),
    (None, torch.float32, None, None),
]


def _run_op(op, pkg, x, w, b):
    if pkg == "jax":
        import paddle_tpu as paddle
        from paddle_tpu.nn import functional as F
        t = paddle.to_tensor
        if op == "linear":
            return F.linear(t(x), t(w), t(b)).data
        if op == "matmul":
            return paddle.matmul(t(x), t(w)).data
        return getattr(F, op)(t(x)).data
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.tensor import matmul
    if op == "linear":
        return F.linear(x, w, b)
    if op == "matmul":
        return matmul(x, w)
    return getattr(F, op)(x)


@pytest.mark.parametrize("amp_dtype,in_dtype,white,black", _CASES)
@pytest.mark.parametrize("op", _OPS)
def test_autocast_op_dtypes_match_jax(op, amp_dtype, in_dtype, white, black):
    import contextlib
    from paddle_tpu.amp import auto_cast as jax_cast
    from paddle_tpu_torch.amp import auto_cast
    rng = np.random.RandomState(0)
    xs = rng.standard_normal((3, 8)).astype(np.float32)
    ws = rng.standard_normal((8, 5)).astype(np.float32)
    bs = rng.standard_normal((5,)).astype(np.float32)
    tx = torch.from_numpy(xs).to(in_dtype)
    jx = jnp.asarray(xs, _jdt(in_dtype))
    # weights stay fp32, as the model's master weights
    tw, tb = torch.from_numpy(ws), torch.from_numpy(bs)
    jw, jb = jnp.asarray(ws), jnp.asarray(bs)
    kw = dict(custom_white_list=white, custom_black_list=black)
    if amp_dtype is None:
        jctx, tctx = contextlib.nullcontext(), contextlib.nullcontext()
    else:
        jctx = jax_cast(True, dtype=amp_dtype, **kw)
        tctx = auto_cast(True, dtype=amp_dtype, **kw)
    with jctx:
        want = _run_op(op, "jax", jx, jw, jb)
    with tctx:
        got = _run_op(op, "port", tx, tw, tb)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got, want, got.dtype)


def test_auto_cast_nests_and_restores():
    from paddle_tpu_torch.amp import amp_enabled, amp_state, auto_cast
    assert not amp_enabled()
    with auto_cast(True, dtype="float16", custom_black_list=["linear"]):
        assert amp_state().dtype == torch.float16
        with auto_cast(False):
            assert not amp_enabled()
        assert amp_enabled() and amp_state().custom_black == {"linear"}
    assert not amp_enabled() and amp_state().custom_black == frozenset()


def test_gray_op_and_disabled_levels_leave_inputs():
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.core.amp import autocast_inputs
    x = torch.ones(2, dtype=torch.float32)
    h = torch.ones(2, dtype=torch.bfloat16)
    with auto_cast(True):
        assert autocast_inputs("gelu", x, h) == (x, h)
        assert autocast_inputs("linear", x, None, 3)[1:] == (None, 3)
    with auto_cast(True, level="O0"):
        assert autocast_inputs("linear", x)[0].dtype == torch.float32


def _jax_params(n, seed):
    import paddle_tpu as paddle
    rng = np.random.RandomState(seed)
    params = [paddle.create_parameter([4, 3], "float32") for _ in range(n)]
    for p in params:
        p.data = jnp.asarray(rng.standard_normal((4, 3)).astype(np.float32))
    return params


def _grad_sequence(steps):
    """Per-step gradients (two leaves, scaled by the loss scale later):
    steps 2, 3 and 6 hold an inf or a NaN."""
    rng = np.random.RandomState(7)
    seq = []
    for i in range(steps):
        g = [rng.standard_normal((4, 3)).astype(np.float32) * 3
             for _ in range(2)]
        if i in (2, 3):
            g[i - 2][1, 2] = np.inf
        if i == 6:
            g[1][0, 0] = np.nan
        seq.append(g)
    return seq


def test_grad_scaler_trajectory_matches_jax():
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.amp import GradScaler as JaxScaler
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.optimizer import SGD
    kw = dict(init_loss_scaling=1000.0, incr_ratio=2.0, decr_ratio=0.8,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
    jp = _jax_params(2, 3)
    tp = [torch.nn.Parameter(torch.from_numpy(np.asarray(p.data)).clone())
          for p in jp]
    jo = jopt.SGD(learning_rate=0.1, parameters=jp)
    to = SGD(learning_rate=0.1, parameters=tp)
    js, ts = JaxScaler(**kw), GradScaler(**kw)
    for g in _grad_sequence(9):
        for p, q, a in zip(jp, tp, g):
            # the scaled gradient, as a backward of the scaled loss gives it
            p.grad = paddle.to_tensor(a * np.float32(js._scale))
            q.grad = torch.from_numpy(a) * ts._scale
        js.step(jo)
        ts.step(to)
        assert ts._found_inf == js._found_inf
        js.update()
        ts.update()
        assert ts._scale == js._scale
        assert (ts._good_steps, ts._bad_steps) == (js._good_steps,
                                                    js._bad_steps)
        for p, q in zip(jp, tp):
            np.testing.assert_allclose(q.detach().numpy(),
                                       np.asarray(p.data), atol=1e-6,
                                       rtol=1e-6)
    assert ts.state_dict() == js.state_dict()
    assert ts._scale not in (1000.0 * 2 ** k for k in range(-8, 8))


def test_grad_scaler_unscales_by_division():
    """(g / scale) in fp32, back to g's dtype: at a scale that is not a
    power of two, a multiply by 1 / scale parts from it in the last bit."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.optimizer import SGD
    p = torch.nn.Parameter(torch.zeros(4096))
    p.grad = torch.from_numpy(np.random.RandomState(1).standard_normal(
        4096).astype(np.float32))
    g = p.grad.clone()
    sc = GradScaler(init_loss_scaling=0.8 ** 7 * 2 ** 15)
    sc.unscale_(SGD(parameters=[p]))
    assert torch.equal(p.grad, g / sc._scale)
    assert not torch.equal(p.grad, g * (1.0 / sc._scale))


def test_decorate_o2_casts_and_o1_keeps():
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.nn import Linear
    m = Linear(4, 3, device="cpu")
    assert decorate(m, level="O1") is m and m.weight.dtype == torch.float32
    opt = object()
    m2, o2 = decorate(m, opt, level="O2", dtype="float16")
    assert m2 is m and o2 is opt and m.weight.dtype == torch.float16


@pytest.mark.parametrize("poison", [None, np.inf, -np.inf, np.nan])
def test_all_finite_matches_jax(poison):
    from paddle_tpu.obs.numerics import all_finite as jax_all_finite
    from paddle_tpu_torch.obs.numerics import all_finite
    rng = np.random.RandomState(2)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((3, 4), (7,), ())]
    if poison is not None:
        arrs[1][5] = poison
    got = all_finite([torch.from_numpy(a) for a in arrs])
    assert got.dtype == torch.bool and got.ndim == 0
    assert bool(got) == bool(jax_all_finite([jnp.asarray(a) for a in arrs]))
    assert bool(all_finite([]))


def _grads_under_autocast(tm, ids, labels, dtype, wrap=None):
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed.fleet.utils.recompute import recompute
    with auto_cast(True, dtype=dtype):
        if wrap == "loss":
            loss = recompute(tm, ids, labels, use_reentrant=False)
        else:
            loss = tm(ids, labels)
    loss.backward()
    out = {k: p.grad.clone() for k, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return loss.detach(), out


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("how", ["layers", "loss", "selective"])
def test_recompute_under_autocast_is_bit_equal(dtype, how):
    """The model's per-layer recompute (use_recompute), the step's
    whole-loss recompute and its selective recompute of named sublayers
    each give the gradients of the run without recompute, bit for bit,
    under auto_cast in both dtypes."""
    from _torch_port import train_batches, train_models
    from paddle_tpu_torch.parallel import apply_selective_remat
    _, base = train_models()
    over = {"use_recompute": True} if how == "layers" else {}
    _, tm = train_models(**over)
    ids, labels = (torch.from_numpy(a[0]) for a in train_batches(5))
    if how == "selective":
        assert apply_selective_remat(tm, ["gpt.layers"]) == [
            "gpt.layers"]
    want_loss, want = _grads_under_autocast(base, ids, labels, dtype)
    got_loss, got = _grads_under_autocast(
        tm, ids, labels, dtype, wrap="loss" if how == "loss" else None)
    assert torch.equal(got_loss, want_loss)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_recompute_replays_the_first_runs_dropout():
    """With hidden dropout the recomputed forward draws the first run's
    keep-masks (the port's dropout generator is restored around it), so
    recompute still gives the gradients of the run without it."""
    from _torch_port import train_batches, train_models
    from paddle_tpu_torch.core.random import seed
    _, base = train_models(hidden_dropout_prob=0.1)
    _, tm = train_models(hidden_dropout_prob=0.1, use_recompute=True)
    ids, labels = (torch.from_numpy(a[0]) for a in train_batches(6))
    seed(11)
    want_loss, want = _grads_under_autocast(base, ids, labels, "bfloat16")
    seed(11)
    got_loss, got = _grads_under_autocast(tm, ids, labels, "bfloat16")
    assert torch.equal(got_loss, want_loss)
    for k in want:
        assert torch.equal(got[k], want[k]), k
