"""Adam, AdamW and gradient clipping in the PyTorch port against the JAX
package's compiled train path (`Optimizer.apply_gradients_fn` and
`Optimizer.clip_gradients_fn`).

Both sides start from the same numpy parameters and take the same
numpy gradients, step after step. fp32 parameters and moments: atol =
rtol = 1e-6 (the same op sequence, `_adam_math`'s order; a square root or
quotient may round one ulp apart). bf16 parameters or moments: within one
bf16 ulp (+ 1e-7) of the JAX value (both round one fp32 value once, so
only values that land near a rounding midpoint can part).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

SHAPES = {"a.weight": (6, 5), "a.bias": (5,), "b.weight": (5, 3),
          "norm.weight": (3,)}


def _params(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _ulp_close(got, want):
    from _torch_port import ulp_bf16
    big = np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want) <= ulp_bf16(big) + 1e-7).all(), \
        float(np.abs(got - want).max())


def _run_both(jax_opt, port_opt_fn, dtype, steps=4, lr=1e-2):
    """Step both optimizers `steps` times; returns (jax params, port
    params, jax state, port optimizer, port tensors by name)."""
    p0 = _params(0)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jparams = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    jstate = jax_opt.init_state(jparams)
    apply = jax_opt.apply_gradients_fn()
    tparams = {k: torch.from_numpy(v).to(dtype) for k, v in p0.items()}
    opt = port_opt_fn(list(tparams.values()))
    for i in range(steps):
        g = _grads(10 + i)
        jgrads = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        jparams, jstate = apply(jparams, jgrads, jstate,
                                jnp.float32(lr), jnp.int32(i + 1))
        opt.apply_gradients([(tparams[k], torch.from_numpy(g[k]).to(dtype))
                             for k in sorted(tparams)], lr)
    return jparams, jstate, opt, tparams


@pytest.mark.parametrize("kind,dtype,moments,mp,wd", [
    ("adamw", torch.float32, "float32", False, 0.01),
    ("adamw", torch.float32, "bfloat16", False, 0.01),
    ("adamw", torch.bfloat16, "float32", True, 0.01),
    ("adamw", torch.bfloat16, "float32", False, 0.01),
    ("adam", torch.float32, "float32", False, None),
    ("adam", torch.float32, "float32", False, "l2"),
    ("adam", torch.bfloat16, "bfloat16", True, "l2"),
])
def test_adam_family_matches_apply_gradients_fn(kind, dtype, moments, mp,
                                                wd):
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.regularizer import L2Decay as JL2
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.regularizer import L2Decay
    jwd = JL2(0.01) if wd == "l2" else wd
    twd = L2Decay(0.01) if wd == "l2" else wd
    JCls = jopt.AdamW if kind == "adamw" else jopt.Adam
    TCls = topt.AdamW if kind == "adamw" else topt.Adam
    kw = {} if wd is None else {"weight_decay": jwd}
    jax_opt = JCls(learning_rate=1e-2, multi_precision=mp,
                   moment_dtype=moments, **kw)
    tkw = {} if wd is None else {"weight_decay": twd}

    def make(params):
        return TCls(learning_rate=1e-2, parameters=params,
                    multi_precision=mp, moment_dtype=moments, **tkw)

    jparams, jstate, opt, tparams = _run_both(jax_opt, make, dtype)
    for k, t in tparams.items():
        got = t.float().numpy()
        want = np.asarray(jparams[k].astype(jnp.float32))
        slots = opt.state[t]
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        else:
            _ulp_close(got, want)
        for s in ("moment1", "moment2"):
            assert slots[s].dtype == (torch.bfloat16 if moments == "bfloat16"
                                      else torch.float32)
            g_s = slots[s].float().numpy()
            w_s = np.asarray(jstate[k][s].astype(jnp.float32))
            if moments == "bfloat16":
                _ulp_close(g_s, w_s)
            else:
                np.testing.assert_allclose(g_s, w_s, atol=1e-6, rtol=1e-6)
        for s in ("beta1_pow", "beta2_pow"):
            assert slots[s].dtype == torch.float32
            assert float(slots[s]) == float(jstate[k][s])
        if mp:
            np.testing.assert_allclose(
                slots["master_weight"].numpy(),
                np.asarray(jstate[k]["master_weight"]), atol=1e-6,
                rtol=1e-6)
        else:
            assert "master_weight" not in slots


def _clip_both(jclip, tclip, dtype):
    from paddle_tpu import optimizer as jopt
    g = _grads(20, scale=3.0)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    clip_fn = jopt.SGD(learning_rate=0.1, grad_clip=jclip).clip_gradients_fn()
    want = clip_fn({k: jnp.asarray(v, jdt) for k, v in g.items()})
    names = sorted(g)
    pairs = tclip([(k, torch.from_numpy(g[k]).to(dtype)) for k in names])
    assert [k for k, _ in pairs] == names
    return {k: t for k, t in pairs}, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["global", "norm", "value"])
def test_clip_matches_clip_gradients_fn(kind, dtype):
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch.nn import clip
    make = {"global": (jnn.ClipGradByGlobalNorm, clip.ClipGradByGlobalNorm,
                       (1.0,)),
            "norm": (jnn.ClipGradByNorm, clip.ClipGradByNorm, (2.0,)),
            "value": (jnn.ClipGradByValue, clip.ClipGradByValue, (1.5,))}
    JC, TC, args = make[kind]
    got, want = _clip_both(JC(*args), TC(*args), dtype)
    for k, t in got.items():
        assert t.dtype == dtype
        g = t.float().numpy()
        w = np.asarray(want[k].astype(jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
        else:
            _ulp_close(g, w)


def test_global_norm_leaves_small_gradients_alone():
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    g = torch.full((4,), 0.1)
    (_, out), = ClipGradByGlobalNorm(1.0)([("p", g)])
    assert torch.equal(out, g)


def test_step_updates_parameters_in_place_and_clear_grad():
    from paddle_tpu_torch.optimizer import AdamW
    p = torch.nn.Parameter(torch.ones(3))
    ptr = p.data_ptr()
    opt = AdamW(learning_rate=0.1, parameters=[p])
    p.grad = torch.ones(3)
    opt.step()
    assert p.data_ptr() == ptr and (p.data < 1).all()
    opt.clear_grad()
    assert torch.equal(p.grad, torch.zeros(3))
    opt.clear_grad(set_to_zero=False)
    assert p.grad is None
    sd = opt.state_dict()
    assert sd["_step_count"] == 1 and "0__moment1" in sd


def test_unported_options_raise():
    from paddle_tpu_torch.optimizer import Adam, AdamW
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AdamW(learning_rate=0.1, parameters=[], lr_ratio=lambda p: 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Adam(learning_rate=object(), parameters=[])
