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
    with pytest.raises(NotImplementedError, match="sparse"):
        Adam(learning_rate=0.1, parameters=[], lazy_mode=True)
    with pytest.raises(TypeError, match="LRScheduler"):
        Adam(learning_rate=object(), parameters=[])
    # a decay filter or lr_ratio needs the parameter's name, which the
    # train steps pass and a bare step() does not have
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.ones(3)
    for kw in (dict(lr_ratio=lambda q: 1.0),
               dict(apply_decay_param_fun=lambda n: True)):
        with pytest.raises(ValueError, match="name"):
            AdamW(learning_rate=0.1, parameters=[p], **kw).step()


def _decays(name):
    return not name.endswith("bias") and not name.startswith("norm")


def _ratio(param):
    return {"a.weight": 0.5, "b.weight": 2.0}.get(param.name, 1.0)


@pytest.mark.parametrize("kind,dtype,moments,mp,opts", [
    ("adamw", torch.float32, "float32", False, "filter"),
    ("adamw", torch.float32, "float32", False, "ratio"),
    ("adamw", torch.bfloat16, "bfloat16", True, "filter+ratio"),
    ("adam", torch.float32, "float32", False, "l1"),
    ("adamw", torch.float32, "float32", False, "l1"),
    ("adamw", torch.bfloat16, "float32", True, "schedule"),
])
def test_adam_options_match_apply_gradients_fn(kind, dtype, moments, mp,
                                               opts):
    """The decay filter by name, lr_ratio, L1Decay and an LRScheduler's
    value, from the same non-zero moments on both sides: the JAX optimizer
    steps twice alone, its state and parameters cross with
    `bridge.load_jax_optimizer_state`, then both step three more times.
    Tolerances as in the module docstring."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.regularizer import L1Decay as JL1
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.bridge import load_jax_optimizer_state
    from paddle_tpu_torch.regularizer import L1Decay
    jkw, tkw = {}, {}
    if "filter" in opts:
        jkw["apply_decay_param_fun"] = tkw["apply_decay_param_fun"] = _decays
    if "ratio" in opts:
        jkw["lr_ratio"] = tkw["lr_ratio"] = _ratio
    if opts == "l1":
        jkw["weight_decay"], tkw["weight_decay"] = JL1(0.01), L1Decay(0.01)
    elif kind == "adamw":
        jkw["weight_decay"] = tkw["weight_decay"] = 0.05
    lr = 1e-2
    if opts == "schedule":
        import paddle_tpu_torch.optimizer.lr as tlr
        tkw["learning_rate"] = tlr.ExponentialDecay(lr, gamma=0.5)
        tkw["learning_rate"].step()
        lr = tkw["learning_rate"]()             # what get_lr() now reads
    JCls = jopt.AdamW if kind == "adamw" else jopt.Adam
    TCls = topt.AdamW if kind == "adamw" else topt.Adam
    jax_opt = JCls(learning_rate=1e-2, multi_precision=mp,
                   moment_dtype=moments, **jkw)
    apply = jax_opt.apply_gradients_fn()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jparams = {k: jnp.asarray(v, jdt) for k, v in _params(0).items()}
    jstate = jax_opt.init_state(jparams)
    names = sorted(jparams)
    for i in range(5):
        g = _grads(30 + i)
        if i == 2:
            tparams = {k: torch.from_numpy(
                np.array(jparams[k].astype(jnp.float32))).to(dtype)
                for k in names}
            holder = _Named(tparams)
            opt = TCls(parameters=list(tparams.values()), multi_precision=mp,
                       moment_dtype=moments,
                       **({} if "learning_rate" in tkw
                          else {"learning_rate": 1e-2}), **tkw)
            load_jax_optimizer_state(opt, holder, {
                k: {s: np.asarray(v.astype(jnp.float32))
                    for s, v in jstate[k].items()} for k in names})
            assert float(opt.state[tparams["a.weight"]]["beta1_pow"]) == \
                float(jstate["a.weight"]["beta1_pow"])
        jparams, jstate = apply(jparams, {k: jnp.asarray(v, jdt)
                                          for k, v in g.items()},
                                jstate, jnp.float32(lr), jnp.int32(i + 1))
        if i >= 2:
            opt.apply_gradients(
                [(tparams[k], torch.from_numpy(g[k]).to(dtype))
                 for k in names], None if opts == "schedule" else lr,
                names=names)
    for k, t in tparams.items():
        want = np.asarray(jparams[k].astype(jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(t.numpy(), want, atol=1e-6, rtol=1e-6)
        else:
            _ulp_close(t.float().numpy(), want)
        for s in ("moment1", "moment2"):
            g_s = opt.state[t][s].float().numpy()
            w_s = np.asarray(jstate[k][s].astype(jnp.float32))
            if moments == "bfloat16":
                _ulp_close(g_s, w_s)
            else:
                np.testing.assert_allclose(g_s, w_s, atol=1e-6, rtol=1e-6)


class _Named(torch.nn.Module):
    """A module whose named_parameters() are `params` under their dotted
    names (what load_jax_optimizer_state walks)."""

    def __init__(self, params):
        super().__init__()
        self._named = params

    def named_parameters(self, *a, **k):
        return iter(self._named.items())


def test_state_dict_round_trip_carries_the_scheduler():
    import paddle_tpu_torch.optimizer.lr as tlr
    from paddle_tpu_torch.optimizer import AdamW

    def make():
        p = torch.nn.Parameter(torch.ones(4))
        sched = tlr.StepDecay(0.1, step_size=2, gamma=0.5)
        return p, sched, AdamW(learning_rate=sched, parameters=[p])

    p, sched, opt = make()
    for _ in range(3):
        p.grad = torch.full((4,), 0.3)
        opt.step()
        sched.step()
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    sd = opt.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 3 and opt.get_lr() == 0.05
    p2, sched2, opt2 = make()
    p2.data.copy_(p.data)
    opt2.set_state_dict(sd)
    assert opt2._step_count == 3 and sched2.last_epoch == 3
    assert opt2.get_lr() == opt.get_lr()
    for a, b in ((p, opt), (p2, opt2)):
        a.grad = torch.full((4,), -0.2)
        b.step()
    assert torch.equal(p, p2)
    assert torch.equal(opt.state[p]["moment2"], opt2.state[p2]["moment2"])


# ---- SGD, Momentum, LarsMomentum and Lamb (the strategy's LARS and LAMB
# swaps): plain PyTorch on both sides of the comparison, each `_rule` the
# JAX one in its op order. fp32: atol = rtol = 1e-6, except where a norm
# enters (LARS's local lr, Lamb's trust ratio), whose fp32 sums run in
# another order: 1e-5 (one such sum moves its leaf's step by ~1e-7 of
# itself; an error in the formula moves it by its own size). bf16
# parameters with an fp32 master: one bf16 ulp.
def _run_named(jax_opt, port_opt, dtype, steps=4, lr=1e-2, gates=None):
    """Both optimizers `steps` times over SHAPES' named leaves, the port's
    through apply_gradients(names=); `gates[i]` False skips step i on the
    port (do_update) and on the JAX side (its _tree_where)."""
    p0 = _params(0)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jparams = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    jstate = jax_opt.init_state(jparams)
    apply = jax_opt.apply_gradients_fn()
    names = sorted(p0)
    tparams = {k: torch.from_numpy(p0[k]).to(dtype) for k in names}
    # slots made in the JAX state's order (Dpsgd numbers its streams so)
    port_opt.init_slots([tparams[k] for k in p0])
    for i in range(steps):
        g = _grads(10 + i)
        ok = True if gates is None else gates[i]
        cand = apply(jparams, {k: jnp.asarray(v, jdt) for k, v in g.items()},
                     jstate, jnp.float32(lr), jnp.int32(i + 1))
        if ok:
            jparams, jstate = cand
        flag = None if gates is None else torch.tensor(ok)
        port_opt.apply_gradients(
            [(tparams[k], torch.from_numpy(g[k]).to(dtype)) for k in names],
            lr, names=names, do_update=flag)
    return jparams, jstate, tparams


def _plain_optimizers(kind, tp):
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as topt
    exclude = (lambda p: "norm" in p.name)
    return {
        "sgd": (jopt.SGD(learning_rate=1e-2, weight_decay=0.01),
                topt.SGD(learning_rate=1e-2, parameters=tp,
                         weight_decay=0.01)),
        "momentum": (jopt.Momentum(learning_rate=1e-2, momentum=0.9,
                                   weight_decay=0.01),
                     topt.Momentum(learning_rate=1e-2, momentum=0.9,
                                   parameters=tp, weight_decay=0.01)),
        "nesterov": (jopt.Momentum(learning_rate=1e-2, momentum=0.9,
                                   use_nesterov=True, rescale_grad=0.5),
                     topt.Momentum(learning_rate=1e-2, momentum=0.9,
                                   parameters=tp, use_nesterov=True,
                                   rescale_grad=0.5)),
        "momentum_mp": (jopt.Momentum(learning_rate=1e-2, momentum=0.9,
                                      multi_precision=True),
                        topt.Momentum(learning_rate=1e-2, momentum=0.9,
                                      parameters=tp, multi_precision=True)),
        "lars": (jopt.LarsMomentum(learning_rate=1e-2, momentum=0.9,
                                   lars_coeff=0.001,
                                   lars_weight_decay=0.0005, epsilon=1e-8),
                 topt.LarsMomentum(learning_rate=1e-2, momentum=0.9,
                                   lars_coeff=0.001, parameters=tp,
                                   lars_weight_decay=0.0005, epsilon=1e-8)),
        "lamb": (jopt.Lamb(learning_rate=1e-2, lamb_weight_decay=0.01,
                           exclude_from_weight_decay_fn=exclude),
                 topt.Lamb(learning_rate=1e-2, lamb_weight_decay=0.01,
                           parameters=tp,
                           exclude_from_weight_decay_fn=exclude)),
    }[kind]


@pytest.mark.parametrize("kind,dtype", [
    ("sgd", torch.float32), ("momentum", torch.float32),
    ("nesterov", torch.float32), ("lars", torch.float32),
    ("lamb", torch.float32), ("momentum_mp", torch.bfloat16),
    ("sgd", torch.bfloat16),
])
def test_plain_optimizers_match_apply_gradients_fn(kind, dtype):
    tp = [torch.zeros(1)]
    jo, to = _plain_optimizers(kind, tp)
    jparams, jstate, tparams = _run_named(jo, to, dtype)
    tol = 1e-5 if kind in ("lars", "lamb") else 1e-6
    for k, p in tparams.items():
        got = p.float().numpy()
        want = np.asarray(jparams[k], np.float32)
        if dtype == torch.bfloat16:
            _ulp_close(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        for slot, v in to.state[p].items():
            np.testing.assert_allclose(v.float().numpy(),
                                       np.asarray(jstate[k][slot],
                                                  np.float32),
                                       atol=tol, rtol=tol)
    assert set(to.state[tparams["a.weight"]]) == set(jstate["a.weight"])


@pytest.mark.parametrize("kind", ["adamw", "momentum", "lamb", "sgd"])
def test_skipped_update_keeps_every_bit(kind):
    """A do_update of False leaves every parameter and slot (beta powers
    too) bit for bit as it was, on the plain versions (the fused-Adam
    kernel's flag is held by tests/test_torch_cuda_kernels.py): apply,
    skip, apply equals the JAX optimizer's apply, apply with the skipped
    step's candidate discarded."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as topt
    tp = [torch.zeros(1)]
    if kind == "adamw":
        jo = jopt.AdamW(learning_rate=1e-2, weight_decay=0.01)
        to = topt.AdamW(learning_rate=1e-2, parameters=tp, weight_decay=0.01)
    else:
        jo, to = _plain_optimizers(kind, tp)
    gates = [True, False, True, False]
    jparams, jstate, tparams = _run_named(jo, to, torch.float32, gates=gates)
    tol = 1e-5 if kind == "lamb" else 1e-6
    for k, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                   atol=tol, rtol=tol)
        for slot, v in to.state[p].items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jstate[k][slot]),
                                       atol=tol, rtol=tol)
    # the skip itself, bit for bit
    p = tparams["a.weight"]
    before = p.clone(), {s: v.clone() for s, v in to.state[p].items()}
    to.apply_gradients([(p, torch.ones_like(p))], 1e-2, names=["a.weight"],
                       do_update=torch.tensor(False))
    assert torch.equal(p, before[0])
    for s, v in to.state[p].items():
        assert torch.equal(v, before[1][s]), s


@pytest.mark.parametrize("kind", ["nesterov", "lars", "lamb"])
def test_bridged_velocity_and_lamb_moments_continue_like_jax(kind):
    """The JAX optimizer steps twice alone; its parameters and slots (the
    velocity, Lamb's moments and beta powers) cross with
    `bridge.load_jax_optimizer_state`; both then step three more times and
    agree as test_plain_optimizers_match_apply_gradients_fn holds them."""
    from paddle_tpu_torch.bridge import load_jax_optimizer_state
    jo, _ = _plain_optimizers(kind, [torch.zeros(1)])
    apply = jo.apply_gradients_fn()
    jparams = {k: jnp.asarray(v) for k, v in _params(0).items()}
    jstate = jo.init_state(jparams)
    names = sorted(jparams)
    for i in range(5):
        g = _grads(40 + i)
        if i == 2:
            tparams = {k: torch.from_numpy(np.array(jparams[k]))
                       for k in names}
            _, to = _plain_optimizers(kind, list(tparams.values()))
            load_jax_optimizer_state(to, _Named(tparams), {
                k: {s: np.asarray(v) for s, v in jstate[k].items()}
                for k in names})
        jparams, jstate = apply(jparams, {k: jnp.asarray(v)
                                          for k, v in g.items()},
                                jstate, jnp.float32(1e-2), jnp.int32(i + 1))
        if i >= 2:
            to.apply_gradients([(tparams[k], torch.from_numpy(g[k]))
                                for k in names], 1e-2, names=names)
    tol = 1e-5 if kind in ("lars", "lamb") else 1e-6
    for k, t in tparams.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]),
                                   atol=tol, rtol=tol)
        for s, v in to.state[t].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k][s]),
                                       atol=tol, rtol=tol)



# ---- Adamax, Adagrad, RMSProp (plain, and centered with momentum),
# Adadelta, DecayedAdagrad, Ftrl, Dpsgd, ProximalAdagrad and ProximalGD:
# plain PyTorch, each `_rule` the JAX one in its op order with fp32
# slots (Dpsgd's two int32). fp32 parameters: atol = rtol = 1e-6 (the
# same fp32 ops; a square root, power or quotient may round one ulp
# apart), except Dpsgd: 1e-5, since its per-leaf gradient norm is an fp32
# sum in another order and its noise (threefry.normal) may be up to 3
# ulps from JAX's. bf16 parameters: within one bf16 ulp (+ 1e-7) of the
# JAX value (both round one fp32 value once), Dpsgd two.
NEW_OPTIMIZERS = {
    "adamax": ("Adamax", dict(learning_rate=1e-2, weight_decay=0.01)),
    "adagrad": ("Adagrad", dict(learning_rate=1e-2, weight_decay=0.01,
                                initial_accumulator_value=0.1)),
    "rmsprop": ("RMSProp", dict(learning_rate=1e-2, weight_decay=0.01)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=1e-2, momentum=0.9,
                                         centered=True)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, weight_decay=0.01)),
    "decayed_adagrad": ("DecayedAdagrad", dict(learning_rate=1e-2,
                                               weight_decay=0.01)),
    "ftrl": ("Ftrl", dict(learning_rate=1e-2, l1=0.01, l2=0.01)),
    "dpsgd": ("Dpsgd", dict(learning_rate=1e-2, clip=2.0, batch_size=4.0,
                            sigma=0.5, seed=7)),
    "proximal_adagrad": ("ProximalAdagrad", dict(learning_rate=1e-2,
                                                 l1=0.01, l2=0.01)),
    "proximal_gd": ("ProximalGD", dict(learning_rate=1e-2, l1=0.01,
                                       l2=0.01)),
}


def _new_pair(kind, jparams=None, tparams=None):
    """(JAX optimizer, port optimizer, lr) of a NEW_OPTIMIZERS kind, over
    the given parameter lists (none: the compiled path's)."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as topt
    cls, kw = NEW_OPTIMIZERS[kind]
    return (getattr(jopt, cls)(parameters=jparams, **kw),
            getattr(topt, cls)(parameters=tparams or [torch.zeros(1)],
                               **kw), kw["learning_rate"])


def _new_tol(kind):
    return 1e-5 if kind == "dpsgd" else 1e-6


def _assert_new_close(kind, got, want, dtype):
    if dtype == torch.bfloat16:
        from _torch_port import ulp_bf16
        big = np.maximum(np.abs(got), np.abs(want))
        n = 2 if kind == "dpsgd" else 1
        assert (np.abs(got - want) <= n * ulp_bf16(big) + 1e-7).all(), \
            float(np.abs(got - want).max())
    else:
        tol = _new_tol(kind)
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _assert_slots(kind, to, p, jslots):
    slots = to.state[p]
    assert set(slots) == set(jslots)
    for s, v in slots.items():
        w = np.asarray(jslots[s])
        assert v.dtype == (torch.int32 if w.dtype == np.int32
                           else torch.float32), (s, v.dtype)
        tol = _new_tol(kind)
        np.testing.assert_allclose(v.numpy(), w, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(NEW_OPTIMIZERS))
def test_new_optimizers_match_apply_gradients_fn(kind, dtype):
    """Three compiled-path steps (apply_gradients with names) against the
    JAX apply_gradients_fn: parameters and every slot, dtypes kept."""
    jo, to, lr = _new_pair(kind)
    jparams, jstate, tparams = _run_named(jo, to, dtype, steps=3, lr=lr)
    for k, p in tparams.items():
        assert p.dtype == dtype
        _assert_new_close(kind, p.float().numpy(),
                          np.asarray(jparams[k], np.float32), dtype)
        _assert_slots(kind, to, p, jstate[k])


def _eager_params(dtype, attrs=None):
    """({name: JAX Parameter}, {name: torch Parameter}) of _params(0) in
    `dtype`, each given the attributes attrs[name]."""
    from paddle_tpu.core.tensor import Parameter
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp, tp = {}, {}
    for k, v in _params(0).items():
        jp[k] = Parameter(jnp.asarray(v, jdt), name=k)
        tp[k] = torch.nn.Parameter(torch.from_numpy(v).to(dtype))
        for a, val in (attrs or {}).get(k, {}).items():
            setattr(jp[k], a, val)
            setattr(tp[k], a, val)
    return jp, tp


def _eager_steps(jo, to, jp, tp, dtype, steps, seed=50):
    """`steps` eager step()s of both, the same gradients each time."""
    from paddle_tpu.core.tensor import Tensor
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for i in range(steps):
        g = _grads(seed + i)
        for k in jp:
            jp[k].grad = Tensor(jnp.asarray(g[k], jdt))
            tp[k].grad = torch.from_numpy(g[k]).to(dtype)
        jo.step()
        to.step()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(NEW_OPTIMIZERS))
def test_new_optimizers_eager_step_matches_jax(kind, dtype):
    """Five eager step()s of both packages over the same parameters and
    gradients, to the limits above."""
    jp, tp = _eager_params(dtype)
    names = sorted(jp)
    jo, to, _ = _new_pair(kind, [jp[k] for k in names],
                          [tp[k] for k in names])
    _eager_steps(jo, to, jp, tp, dtype, 5)
    for k in names:
        _assert_new_close(kind, tp[k].detach().float().numpy(),
                          np.asarray(jp[k].data.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("kind", sorted(NEW_OPTIMIZERS))
def test_new_optimizers_skipped_step_keeps_every_bit(kind):
    """A do_update of False leaves every parameter and slot bit for bit
    (Dpsgd's noise step too); apply, skip, apply, skip equals the JAX
    optimizer's two applied steps."""
    jo, to, lr = _new_pair(kind)
    jparams, jstate, tparams = _run_named(
        jo, to, torch.float32, lr=lr, gates=[True, False, True, False])
    for k, p in tparams.items():
        _assert_new_close(kind, p.numpy(), np.asarray(jparams[k]),
                          torch.float32)
        _assert_slots(kind, to, p, jstate[k])
    p = tparams["a.weight"]
    before = p.clone(), {s: v.clone() for s, v in to.state[p].items()}
    to.apply_gradients([(p, torch.ones_like(p))], lr, names=["a.weight"],
                       do_update=torch.tensor(False))
    assert torch.equal(p, before[0])
    for s, v in to.state[p].items():
        assert torch.equal(v, before[1][s]), s


@pytest.mark.parametrize("kind", sorted(NEW_OPTIMIZERS))
def test_new_optimizers_bridged_slots_continue_like_jax(kind):
    """The JAX optimizer steps twice alone; its parameters and slots
    (Dpsgd's int32 salt and step included) cross with
    `bridge.load_jax_optimizer_state` unchanged; both then step three
    more times and agree to the limits above."""
    from paddle_tpu_torch.bridge import load_jax_optimizer_state
    jo, _, lr = _new_pair(kind)
    apply = jo.apply_gradients_fn()
    jparams = {k: jnp.asarray(v) for k, v in _params(0).items()}
    jstate = jo.init_state(jparams)
    names = sorted(jparams)
    for i in range(5):
        g = _grads(60 + i)
        if i == 2:
            tparams = {k: torch.from_numpy(np.array(jparams[k]))
                       for k in names}
            _, to, _ = _new_pair(kind, tparams=list(tparams.values()))
            load_jax_optimizer_state(to, _Named(tparams), {
                k: {s: np.asarray(v) for s, v in jstate[k].items()}
                for k in names})
            _assert_slots(kind, to, tparams["a.weight"], jstate["a.weight"])
        jparams, jstate = apply(jparams, {k: jnp.asarray(v)
                                          for k, v in g.items()},
                                jstate, jnp.float32(lr), jnp.int32(i + 1))
        if i >= 2:
            to.apply_gradients([(tparams[k], torch.from_numpy(g[k]))
                                for k in names], lr, names=names)
    for k, t in tparams.items():
        _assert_new_close(kind, t.numpy(), np.asarray(jparams[k]),
                          torch.float32)
        _assert_slots(kind, to, t, jstate[k])


def test_bridge_names_every_bad_slot():
    from paddle_tpu_torch.bridge import load_jax_optimizer_state
    from paddle_tpu_torch.optimizer import Adagrad
    tparams = {k: torch.from_numpy(v) for k, v in _params(0).items()}
    opt = Adagrad(learning_rate=0.1, parameters=list(tparams.values()))
    good = {k: {"moment": np.zeros(v.shape, np.float32)}
            for k, v in tparams.items()}
    bad = dict(good, **{"a.bias": {"moment": np.zeros((4,), np.float32)},
                        "norm.weight": {"moment": np.zeros((9,),
                                                           np.float32)}})
    with pytest.raises(ValueError) as err:
        load_jax_optimizer_state(opt, _Named(tparams), bad)
    assert "a.bias.moment" in str(err.value)
    assert "norm.weight.moment" in str(err.value)
    assert not opt.state                     # nothing was set
    wrong = dict(good, **{"a.bias": {"velocity": np.zeros(5)},
                          "b.weight": {}})
    with pytest.raises(KeyError) as err:
        load_jax_optimizer_state(opt, _Named(tparams), wrong)
    assert "a.bias" in str(err.value) and "b.weight" in str(err.value)


def test_dpsgd_noise_matches_jax_over_two_params_three_steps():
    """Dpsgd with a zero gradient moves each leaf by -lr · noise /
    batch_size, so the step shows the noise itself: two leaves (salts 1
    and 2, in the order first seen) over three steps, each step's noise
    within 4 ulps of JAX's (threefry.normal's limit, below), and the
    leaves' noises all different."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as topt
    kw = dict(learning_rate=1.0, clip=1.0, batch_size=1.0, sigma=1.0,
              seed=11)
    jo, to = jopt.Dpsgd(**kw), topt.Dpsgd(parameters=[torch.zeros(1)], **kw)
    shapes = {"p0": (3,), "p1": (2, 2)}
    jparams = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    jstate = jo.init_state(jparams)
    apply = jo.apply_gradients_fn()
    tparams = {k: torch.zeros(s) for k, s in shapes.items()}
    seen = []
    for step in range(3):
        before = {k: np.asarray(v) for k, v in jparams.items()}
        jparams, jstate = apply(jparams, {k: jnp.zeros(s) for k, s in
                                          shapes.items()},
                                jstate, jnp.float32(1.0), jnp.int32(step))
        tbefore = {k: t.clone() for k, t in tparams.items()}
        to.apply_gradients([(tparams[k], torch.zeros(s))
                            for k, s in shapes.items()], 1.0,
                           names=list(shapes))
        for k in shapes:
            want = float(np.asarray(jparams[k]).reshape(-1)[0]
                         - before[k].reshape(-1)[0])
            got = float((tparams[k] - tbefore[k]).reshape(-1)[0])
            ulp = np.spacing(np.float32(abs(want)))
            assert abs(got - want) <= 4 * ulp, (step, k, got, want)
            assert int(to.state[tparams[k]]["noise_salt"]) == \
                int(jstate[k]["noise_salt"])
            seen.append(want)
    assert len(set(seen)) == 6


def test_threefry_normal_matches_jax_random_normal():
    """threefry.normal against jax.random.normal over 4,096 keys x 64
    draws: the uniform bits are JAX's exactly and erf_inv is XLA's
    polynomial with its fused multiply-adds, but log1p is torch's, so a
    draw may land up to 3 ulps from JAX's (1% of them did when this was
    written): every draw within 4 ulps, at least 95% bit-equal."""
    import jax
    from paddle_tpu_torch.core import threefry
    salts = np.arange(4096)
    base = jax.random.PRNGKey(5)
    want = np.asarray(jax.vmap(lambda s: jax.random.normal(
        jax.random.fold_in(base, s), (64,)))(salts))
    got = threefry.normal(threefry.fold_in(threefry.prng_key(5),
                                           torch.from_numpy(salts)),
                          (64,)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4
    assert (ulps == 0).mean() >= 0.95
    assert float(threefry.normal(threefry.prng_key(3), ())) == \
        pytest.approx(float(jax.random.normal(jax.random.PRNGKey(3), ())),
                      abs=4e-7)


# ---- the eager step reads each parameter's optimize_attr (a lr scale)
# and no_weight_decay (no L2, decoupled or L1 decay), as the JAX eager
# step does; the compiled path (apply_gradients, the train steps) reads
# neither, as the JAX apply_gradients_fn does not. Limits as above.
ATTRS = {"a.bias": {"optimize_attr": {"learning_rate": 0.5}},
         "b.weight": {"no_weight_decay": True},
         "norm.weight": {"optimize_attr": {"learning_rate": 2.0},
                         "no_weight_decay": True}}


def _attr_pair(case, jparams=None, tparams=None):
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.regularizer import L1Decay as JL1
    from paddle_tpu.regularizer import L2Decay as JL2
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay
    tparams = tparams or [torch.zeros(1)]
    if case == "sgd_l2":
        return (jopt.SGD(0.1, jparams, weight_decay=JL2(0.05)),
                topt.SGD(0.1, tparams, weight_decay=L2Decay(0.05)))
    if case == "momentum_l1":
        return (jopt.Momentum(0.1, 0.9, jparams, weight_decay=JL1(0.05)),
                topt.Momentum(0.1, 0.9, tparams, weight_decay=L1Decay(0.05)))
    if case == "adamw_decoupled":
        return (jopt.AdamW(0.1, parameters=jparams, weight_decay=0.05),
                topt.AdamW(0.1, parameters=tparams, weight_decay=0.05))
    return (jopt.Adagrad(0.1, parameters=jparams, weight_decay=0.05),
            topt.Adagrad(0.1, parameters=tparams, weight_decay=0.05))


ATTR_CASES = ["sgd_l2", "momentum_l1", "adamw_decoupled", "adagrad_float"]


@pytest.mark.parametrize("case", ATTR_CASES)
def test_eager_step_honours_optimize_attr_and_no_weight_decay(case):
    jp, tp = _eager_params(torch.float32, ATTRS)
    names = sorted(jp)
    jo, to = _attr_pair(case, [jp[k] for k in names],
                        [tp[k] for k in names])
    _eager_steps(jo, to, jp, tp, torch.float32, 3, seed=70)
    for k in names:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k].data), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    # the attributes moved the step: a plain twin differs on those leaves
    jp2, tp2 = _eager_params(torch.float32)
    jo2, to2 = _attr_pair(case, [jp2[k] for k in names],
                          [tp2[k] for k in names])
    _eager_steps(jo2, to2, jp2, tp2, torch.float32, 3, seed=70)
    for k in names:
        moved = not np.allclose(tp[k].detach().numpy(),
                                tp2[k].detach().numpy(), atol=1e-7)
        assert moved == (k in ATTRS), k


def test_sgd_param_attr_learning_rate_halves_the_step():
    """The reproduction of the fault: ParamAttr(learning_rate=0.5) on a
    bias, SGD(0.1), a gradient of 1: the bias moves by -0.05."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn.layer.layers import ParamAttr
    from paddle_tpu_torch.optimizer import SGD
    lin = Linear(2, 3, bias_attr=ParamAttr(learning_rate=0.5))
    with torch.no_grad():
        lin.bias.zero_()
        lin.weight.fill_(1.0)
    opt = SGD(0.1, parameters=lin.parameters())
    lin.bias.grad = torch.ones(3)
    lin.weight.grad = torch.ones(2, 3)
    w0 = lin.weight.detach().clone()
    opt.step()
    np.testing.assert_allclose(lin.bias.detach().numpy(), -0.05, rtol=1e-6)
    np.testing.assert_allclose((lin.weight - w0).detach().numpy(), -0.1,
                               rtol=1e-5)


@pytest.mark.parametrize("case", ATTR_CASES)
def test_compiled_path_ignores_optimize_attr_and_no_weight_decay(case):
    """apply_gradients(names=) with the same attributed parameters: equal
    to the JAX apply_gradients_fn, which reads neither attribute."""
    jo, _ = _attr_pair(case)
    _, tp = _eager_params(torch.float32, ATTRS)
    names = sorted(tp)
    _, to = _attr_pair(case, tparams=[tp[k] for k in names])
    apply = jo.apply_gradients_fn()
    jparams = {k: jnp.asarray(v) for k, v in _params(0).items()}
    jstate = jo.init_state(jparams)
    for i in range(3):
        g = _grads(80 + i)
        jparams, jstate = apply(jparams, {k: jnp.asarray(v)
                                          for k, v in g.items()},
                                jstate, jnp.float32(0.1), jnp.int32(i + 1))
        to.apply_gradients([(tp[k], torch.from_numpy(g[k])) for k in names],
                           0.1, names=names)
    for k in names:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jparams[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("cls", sorted({c for c, _ in
                                        NEW_OPTIMIZERS.values()}))
def test_new_optimizers_take_the_jax_constructors_arguments(cls):
    """The same parameters in the same order, defaults included (Adagrad
    takes `name` before `initial_accumulator_value`, as Paddle's does),
    so positional calls bind alike."""
    import inspect
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as topt
    want = inspect.signature(getattr(jopt, cls)).parameters
    got = inspect.signature(getattr(topt, cls)).parameters
    assert [(k, p.default) for k, p in got.items()] == \
        [(k, p.default) for k, p in want.items()]
