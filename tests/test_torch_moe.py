"""Mixture of experts in the PyTorch port against the JAX package.

The port routes by index (`top_k_route`: expert, slot and kept flag a
(token, rank), weights [T, k]); the JAX package builds dense [T, E, C]
`dispatch`/`combine` tensors. Limits, each beside its assert:

- routing: the index form expanded (`dense_dispatch_combine`) equals
  JAX's dispatch exactly and its combine within 1e-6 (a weight is one
  gate value over a sum of at most two; the same fp32 ops); aux within
  1e-6 (two fp32 means over T summed in another order);
- `moe_forward` in fp32: the output and every gradient within 1e-5 of
  the leaf's largest magnitude (sums over T, H or F in another order;
  ~3e-7 of it was seen); in bf16: each output or gradient's error norm
  within 1.5% of its norm and every element within 3% of the leaf's
  largest (the two packages round a bias add, the GELU or a product's
  output to bf16 at other places: 0.3-0.8% and up to 1.5% were seen);
- ernie-moe-tiny whole, fp32: the loss within rtol 1e-5 and every
  gradient within rtol 1e-4 plus 1e-5 of its leaf's largest, as
  tests/test_torch_gpt.py holds the dense model's;
- the train steps: losses and weights as tests/test_torch_train_step.py
  and tests/test_torch_plan_step.py state and explain them.
"""
import numpy as np
import pytest
import torch

from _torch_port import (assert_params_match, one_cpu_mesh, train_batches,
                         train_models)

NAMES = ("x", "gate_w", "w1", "b1", "w2", "b2")


def _jax_route(gates, capacity, top_k):
    import jax.numpy as jnp
    from paddle_tpu.nn.layer.moe import _top_k_dispatch
    d, c, aux = _top_k_dispatch(jnp.asarray(gates), capacity, top_k)
    return np.asarray(d), np.asarray(c), float(aux)


def _softmax(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _gates(case):
    """(gates [T, E] fp32, capacity, top_k) of a routing case."""
    rng = np.random.RandomState(0)
    if case == "all_to_one":            # the JAX package's own test
        return np.tile([[0.97, 0.01, 0.01, 0.01]], (8, 1)).astype(
            np.float32), 2, 1
    if case == "all_to_one_top2":
        return np.tile([[0.97, 0.01, 0.01, 0.01]], (8, 1)).astype(
            np.float32), 2, 2
    if case == "ties":
        # equal gates: the first maximum wins, in both packages
        g = np.array([[0.25] * 4, [0.4, 0.4, 0.1, 0.1], [0.1, 0.3, 0.3, 0.3],
                      [0.5, 0.1, 0.1, 0.3]] * 3, np.float32)
        return g, 3, 2
    if case == "all_dropped":
        # every token prefers experts 0 then 1; with 2 slots each, the
        # third token onwards loses both choices: a zero weight row
        g = np.tile([[0.6, 0.3, 0.05, 0.05]], (5, 1)).astype(np.float32)
        return g, 2, 2
    T, E = 32, 4
    skew = np.array([1.5, 0.5, 0.0, -0.5]) if "overflow" in case else 0.0
    g = _softmax(rng.standard_normal((T, E)) + skew)
    top_k = 1 if case.startswith("top1") else 2
    capacity = 3 if "overflow" in case else T
    return g, capacity, top_k


ROUTE_CASES = ["top1_ample", "top2_ample", "top1_overflow", "top2_overflow",
               "all_to_one", "all_to_one_top2", "ties", "all_dropped"]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_routing_matches_jax_dispatch(case):
    from paddle_tpu_torch.nn.layer.moe import (dense_dispatch_combine,
                                               top_k_route)
    gates, capacity, top_k = _gates(case)
    d_want, c_want, aux_want = _jax_route(gates, capacity, top_k)
    expert, slot, kept, weight, aux = top_k_route(torch.from_numpy(gates),
                                                  capacity, top_k)
    assert expert.shape == slot.shape == kept.shape == weight.shape == \
        (gates.shape[0], top_k)
    d, c = dense_dispatch_combine(expert, slot, kept, weight,
                                  gates.shape[1], capacity)
    np.testing.assert_array_equal(d.numpy(), d_want)            # exact
    np.testing.assert_allclose(c.numpy(), c_want, atol=1e-6, rtol=0)
    assert abs(float(aux) - aux_want) <= 1e-6
    # a kept pair's slot is below capacity; weights vanish where dropped
    assert bool((slot[kept] < capacity).all())
    assert bool((weight[~kept] == 0).all())
    if case == "all_to_one":
        assert int(kept.sum()) == 2
    if case == "all_dropped":
        lost = ~kept.any(1)
        assert int(lost.sum()) == 3 and bool((weight[lost] == 0).all())


def _moe_arrays(seed, B=2, S=16, H=32, F=48, E=4):
    r = np.random.RandomState(seed)
    return {"x": r.standard_normal((B, S, H)),
            "gate_w": r.standard_normal((H, E)) * 0.5,
            "w1": r.standard_normal((E, H, F)) * 0.2,
            "b1": r.standard_normal((E, F)) * 0.1,
            "w2": r.standard_normal((E, F, H)) * 0.2,
            "b2": r.standard_normal((E, H)) * 0.1,
            "g": r.standard_normal((B, S, H))}


def _assert_close(got, want, dtype, what):
    scale = float(np.abs(want).max())
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(scale, 1.0),
                                   err_msg=what)
        return
    err = np.abs(got - want)
    assert np.linalg.norm(err) <= 1.5e-2 * np.linalg.norm(want), what
    assert err.max() <= 3e-2 * scale, what


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k,cf,act", [(1, 1.0, "gelu"),
                                          (2, 0.5, "gelu"),
                                          (2, 2.0, "gelu"),
                                          (2, 1.25, "relu"),
                                          (2, 1.25, "silu")])
def test_moe_forward_and_grads_match_jax_vjp(dtype, top_k, cf, act):
    """moe_forward's output, aux and the gradients of x, gate_w, w1, b1,
    w2 and b2 against jax.vjp of the JAX function, with overflow drops at
    capacity factor 0.5 (aux within 1e-6)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.nn.layer import moe as jmoe
    from paddle_tpu_torch.nn.layer import moe as tmoe
    a = _moe_arrays(1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jact = {"gelu": jax.nn.gelu, "relu": jax.nn.relu,
            "silu": jax.nn.silu}[act]
    (jo, jaux), vjp = jax.vjp(
        lambda *t: jmoe.moe_forward(*t, top_k, cf, jact),
        *[jnp.asarray(a[n], jdt) for n in NAMES])
    jgrads = vjp((jnp.asarray(a["g"], jdt), jnp.float32(0.7)))
    tin = [torch.tensor(a[n]).to(dtype).requires_grad_() for n in NAMES]
    out, aux = tmoe.moe_forward(*tin, top_k, cf, tmoe.ACTIVATIONS[act])
    assert out.dtype == dtype and aux.dtype == torch.float32
    torch.autograd.backward([out, aux], [torch.tensor(a["g"]).to(dtype),
                                         torch.tensor(0.7)])
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-6
    _assert_close(out.detach().float().numpy(),
                  np.asarray(jo.astype(jnp.float32)), dtype, "out")
    for n, t, jg in zip(NAMES, tin, jgrads):
        assert t.grad.dtype == dtype
        _assert_close(t.grad.float().numpy(),
                      np.asarray(jg.astype(jnp.float32)), dtype, n)


def test_moe_moves_tokens_by_index():
    """No [T, E, C] tensor on the path: the largest tensor moe_forward
    makes at T = 8192, E = 8, C = 2560 (ernie-moe-base's 8 x 1024) is an
    expert buffer, E·C·F elements, not T·E·C = 168 M. Shapes only (the
    meta device computes nothing)."""
    from paddle_tpu_torch.nn.layer.moe import capacity_of, moe_forward
    T, H, F, E = 8192, 768, 3072, 8
    C = capacity_of(T, 2, E, 1.25)
    assert C == 2560
    seen = []

    class Sizes(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, tuple) else (out,)):
                if torch.is_tensor(o):
                    seen.append(o.numel())
            return out

    meta = dict(device="meta")
    x = torch.empty(8, 1024, H, **meta)
    with Sizes():
        moe_forward(x, torch.empty(H, E, **meta),
                    torch.empty(E, H, F, **meta), torch.empty(E, F, **meta),
                    torch.empty(E, F, H, **meta), torch.empty(E, H, **meta),
                    2, 1.25)
    assert max(seen) == E * C * F < T * E * C


def test_moe_layer_parameters_init_and_exports():
    """The JAX layer's parameters (names, shapes, order), XavierUniform
    with the JAX package's fans on the 3-D stacks, zero biases; exported
    from nn and incubate; expert parallelism raises naming its item."""
    import math
    import paddle_tpu as paddle
    from paddle_tpu.nn.layer.moe import MoELayer as JaxMoE
    from paddle_tpu_torch import incubate, nn
    from paddle_tpu_torch.nn.layer.moe import MoELayer, moe_forward_ep
    assert nn.MoELayer is MoELayer and incubate.MoELayer is MoELayer
    paddle.seed(0)
    jl = JaxMoE(64, 96, 4, top_k=2)
    tl = MoELayer(64, 96, 4, top_k=2)
    with torch.no_grad():
        tl.reset_parameters(torch.Generator().manual_seed(0))
    want = [(k, tuple(p.shape)) for k, p in jl.named_parameters()]
    assert [(k, tuple(p.shape)) for k, p in tl.named_parameters()] == want
    limits = {"gate_weight": math.sqrt(6 / (64 + 4)),
              "w1": math.sqrt(6 / (64 * 96 + 4 * 96)),
              "w2": math.sqrt(6 / (96 * 64 + 4 * 64))}
    jp = dict(jl.named_parameters())
    for k, lim in limits.items():
        t = getattr(tl, k).detach()
        assert float(t.abs().max()) <= lim and float(t.abs().max()) > 0.9 * lim
        assert float(np.abs(np.asarray(jp[k].data)).max()) <= lim
    assert not tl.b1.any() and not tl.b2.any()
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 8"):
        moe_forward_ep()


def test_moe_layer_matches_jax_layer_and_keeps_routing():
    """The layer with the JAX layer's weights (fp32): output and aux_loss
    as moe_forward's limits; `routing` is the pairs' experts, slots and
    kept flags, with the fp32 gates."""
    import paddle_tpu as paddle
    from paddle_tpu.nn.layer.moe import MoELayer as JaxMoE
    from paddle_tpu_torch.nn.layer.moe import MoELayer
    paddle.seed(1)
    jl = JaxMoE(32, 48, 4, top_k=2, capacity_factor=0.75)
    tl = MoELayer(32, 48, 4, top_k=2, capacity_factor=0.75)
    with torch.no_grad():
        for k, p in jl.named_parameters():
            getattr(tl, k).copy_(torch.from_numpy(np.array(p.data)))
    x = np.random.RandomState(2).standard_normal((2, 12, 32)).astype(
        np.float32)
    want = np.asarray(jl(paddle.to_tensor(x)).data)
    got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    assert abs(float(tl.aux_loss.detach())
               - float(np.asarray(jl.aux_loss))) <= 1e-6
    expert, slot, kept, gates = tl.routing
    assert expert.shape == (24, 2) and gates.shape == (24, 4)
    assert gates.dtype == torch.float32 and not kept.all()


def _model_grads_match(jm, tm, ids, labels):
    import paddle_tpu as paddle
    jm.train()
    jloss = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jloss.backward()
    jgrads = {k: np.asarray(p.grad.data, np.float32)
              for k, p in jm.named_parameters()}
    loss = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               float(np.asarray(jloss.data)), rtol=1e-5)
    for k, p in tm.named_parameters():
        want = jgrads[k]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=k)


@pytest.mark.parametrize("recompute", [False, True])
def test_ernie_moe_tiny_loss_and_grads_match_jax(recompute):
    """ernie-moe-tiny (layers 1 and 3 MoE) with the JAX weights: the loss
    (cross-entropy + 0.01 x the summed aux) and every gradient. With
    `use_recompute` the port recomputes each block, aux included, against
    the JAX eager model without it (JAX's eager recompute differentiates
    no parameter; its compiled recompute is held by the train-step test
    below; recomputation changes no value)."""
    jm, _ = train_models("ernie-moe-tiny")
    _, tm = train_models("ernie-moe-tiny", use_recompute=recompute)
    assert [type(l.moe).__name__ for l in tm.gpt.layers if l.use_moe] == \
        ["MoELayer"] * 2
    ids, labels = train_batches(6)
    _model_grads_match(jm, tm, ids[0], labels[0])


def test_unfused_lm_ce_path_adds_the_aux_loss(monkeypatch):
    """FLAGS_fused_lm_ce=0 (logits and ParallelCrossEntropy) adds the aux
    loss as the chunked path does, in both packages."""
    jm, tm = train_models("ernie-moe-tiny")
    monkeypatch.setenv("FLAGS_fused_lm_ce", "0")
    ids, labels = train_batches(7)
    _model_grads_match(jm, tm, ids[0], labels[0])


@pytest.mark.parametrize("recompute", [False, True])
def test_moe_scan_train_step_matches_jax(recompute):
    """Three steps of both ScanTrainSteps (AdamW lr 1e-3, wd 0.01, clip
    1.0) over one batch repeated: losses, lr vector and weights, as
    tests/test_torch_train_step.py holds the dense model."""
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parallel import ScanTrainStep as JaxScan
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep
    jm, tm = train_models("ernie-moe-tiny", use_recompute=recompute)
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    weight_decay=0.01,
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    to = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
               weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    ids, labels = (np.repeat(a[:1], 3, axis=0) for a in train_batches(8))
    jstep = JaxScan(jm, jo, one_cpu_mesh(), scan_steps=3, zero_stage=0,
                    donate=False)
    want = np.asarray(jstep(ids, labels).data)
    step = ScanTrainStep(tm, to, scan_steps=3, device="cpu")
    got = step(ids, labels)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert got[-1] < got[0]
    assert_params_match(jstep._params, tm, 3)


MOE_PLANS = {
    # name: (strategy fields, K a chunk, loss atol, attention dtype)
    "amp_bf16": ({"amp": True}, 1, 1e-3, torch.bfloat16),
    "amp_fp16_recompute_merge_k2": (
        {"amp": True, "amp_configs": {"dtype": "float16"},
         "recompute": True, "gradient_merge": True,
         "gradient_merge_configs": {"k_steps": 2}}, 2, 2.5e-4,
        torch.float16),
}


@pytest.mark.parametrize("case", sorted(MOE_PLANS))
def test_moe_parallelize_amp_step_matches_jax(monkeypatch, case):
    """parallelize() under AMP O1 (fp32 master weights; bf16, or fp16
    with dynamic loss scaling, whole-loss recompute and gradient merge
    k = 2 over a chunk of 2) against the JAX step built from the same
    plan: the losses within the plan tests' limits, the loss scale and
    counters exactly equal, and the weights as
    tests/test_torch_plan_step.py holds AMP steps. Both packages run the
    experts in fp32: the MoE's input (LayerNorm's fp32 output under O1)
    reaches moe_forward as fp32, and nothing in it autocasts, while the
    attention projections run in the AMP dtype."""
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed.fleet.strategy_compiler import \
        StrategyCompiler
    from paddle_tpu.distributed.strategy import DistributedStrategy as JS
    from paddle_tpu.nn.layer import moe as jmoe
    from paddle_tpu.parallel.api import ScanTrainStep as JaxScan
    from paddle_tpu.parallel.api import ShardedTrainStep as JaxStep
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.layer import moe as tmoe
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import parallelize
    from test_torch_plan_step import _assert_amp_weights, _scalars
    fields, K, atol, attn_dtype = MOE_PLANS[case]
    jm, tm = train_models("ernie-moe-tiny")
    seen = {"jax": [], "port": [], "qkv": []}

    def spy(side, fn):
        def wrapped(x, *a, **k):
            seen[side].append(str(x.dtype))
            return fn(x, *a, **k)
        return wrapped

    monkeypatch.setattr(jmoe, "moe_forward", spy("jax", jmoe.moe_forward))
    monkeypatch.setattr(tmoe, "moe_forward", spy("port", tmoe.moe_forward))
    tm.gpt.layers[1].self_attn.qkv_proj.register_forward_hook(
        lambda m, i, o: seen["qkv"].append(o.dtype))
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    weight_decay=0.01,
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    to = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
               weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    js, ts = JS(), DistributedStrategy()
    for st in (js, ts):
        for k, v in fields.items():
            setattr(st, k, v)
        st.scan_steps = K
    plan = StrategyCompiler().compile(js, jo, one_cpu_mesh())
    jcls = JaxScan if K > 1 else JaxStep
    jstep = jcls(jm, jo, one_cpu_mesh(), plan=plan, donate=False)
    step = parallelize(tm, to, strategy=ts, device="cpu")
    ids, labels = train_batches(9, K=K)
    if K == 1:
        ids, labels = ids[0], labels[0]
    want = np.atleast_1d(np.asarray(jstep(ids, labels).data))
    got = np.atleast_1d(step(ids, labels).numpy())
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    assert _scalars(step._extras) == _scalars(jstep._extras)
    assert set(seen["jax"]) == {"float32"} and set(seen["port"]) == \
        {"torch.float32"}
    assert set(seen["qkv"]) == {attn_dtype}
    _assert_amp_weights(jstep._params, tm, K)


def test_ep_degree_is_refused_naming_its_item():
    import warnings
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import parallelize
    _, tm = train_models("ernie-moe-tiny")
    s = DistributedStrategy()
    s.hybrid_configs = {"ep_degree": 2}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 8"):
            parallelize(tm, AdamW(parameters=tm.parameters()), strategy=s,
                        device="cpu")


DECODE_REFUSAL = "KV-cache decode is not wired through MoE layers yet"


def test_moe_decode_is_refused_as_in_jax():
    """generate() and the engine refuse an MoE model with the JAX
    package's words (the JAX engine quarantines the request with them)."""
    from paddle_tpu.models.generation import generate as jax_generate
    from paddle_tpu.serving.clock import SimClock as JaxClock
    from paddle_tpu.serving.llm import LLMEngine as JaxEngine
    from paddle_tpu.serving.llm import LLMEngineConfig as JaxConfig
    from paddle_tpu_torch.models.generation import generate
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    jm, tm = train_models("ernie-moe-tiny")
    jm.eval()
    tm.eval()
    ids = np.array([[1, 2, 3]], np.int32)
    for fn in (lambda: jax_generate(jm, ids, max_new_tokens=2),
               lambda: generate(tm, ids, max_new_tokens=2)):
        with pytest.raises(NotImplementedError, match=DECODE_REFUSAL):
            fn()
    cfg = dict(num_slots=2, block_len=8, n_blocks=8)
    prompt = np.arange(1, 9, dtype=np.int32)
    for eng in (JaxEngine(jm, JaxConfig(**cfg), clock=JaxClock()),
                LLMEngine(tm, LLMEngineConfig(**cfg), clock=SimClock())):
        with pytest.raises(Exception, match=DECODE_REFUSAL):
            h = eng.submit(prompt, max_new_tokens=2)
            while eng.has_work():
                eng.pump()
            h.result(0)


def test_bridge_carries_expert_stacks_and_names_bad_keys():
    """The expert stacks cross with the identity map (no transpose), and
    a bad state names every offending key."""
    from paddle_tpu_torch.bridge import export_state, load_jax_state
    jm, tm = train_models("ernie-moe-tiny")
    params = {k: np.asarray(v) for k, v in jm.functional_state()[0].items()}
    got = export_state(tm)
    for k in ("gpt.layers.1.moe.w1", "gpt.layers.3.moe.w2",
              "gpt.layers.1.moe.gate_weight"):
        np.testing.assert_array_equal(got[k], params[k])
    bad = dict(params)
    bad["gpt.layers.1.moe.w1"] = np.swapaxes(params["gpt.layers.1.moe.w1"],
                                             1, 2)
    bad["gpt.layers.3.moe.b2"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError) as err:
        load_jax_state(tm, bad)
    assert "gpt.layers.1.moe.w1" in str(err.value)
    assert "gpt.layers.3.moe.b2" in str(err.value)
    short = {k: v for k, v in params.items() if "moe.b1" not in k}
    with pytest.raises(KeyError) as err:
        load_jax_state(tm, short)
    assert "gpt.layers.1.moe.b1" in str(err.value)
    assert "gpt.layers.3.moe.b1" in str(err.value)


def test_flops_count_active_parameters_like_jax():
    from paddle_tpu.obs.flops import train_flops_per_step as jax_flops
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.nn.layer.moe import MoELayer
    from paddle_tpu_torch.obs.flops import train_flops_per_step
    m = GPTForCausalLM.from_preset("ernie-moe-tiny", device="cpu")
    n = sum(p.numel() for p in m.parameters())
    expert = sum(p.numel() for mod in m.modules()
                 if isinstance(mod, MoELayer)
                 for k, p in mod.named_parameters() if k != "gate_weight")
    kw = dict(expert_params=expert, moe_top_k=2, moe_num_experts=4)
    assert train_flops_per_step(n, 4096, **kw) == jax_flops(n, 4096, **kw)
    assert train_flops_per_step(n, 4096, **kw) < train_flops_per_step(n,
                                                                      4096)


@pytest.mark.parametrize("kind", ["dpsgd", "rmsprop_centered", "ftrl"])
def test_moe_scan_train_step_with_other_optimizers_matches_jax(kind):
    """ernie-moe-tiny through both ScanTrainSteps with optimizers of the
    last slice: the compiled path makes the slots in the model's order,
    as the JAX step's init_state does, so Dpsgd's noise streams match;
    losses and weights to tests/test_torch_train_step.py's limits."""
    from paddle_tpu.parallel import ScanTrainStep as JaxScan
    from paddle_tpu_torch.parallel import ScanTrainStep
    from test_torch_optimizer import NEW_OPTIMIZERS
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as topt
    jm, tm = train_models("ernie-moe-tiny")
    cls, kw = NEW_OPTIMIZERS[kind]
    kw = dict(kw, learning_rate=1e-3)
    jo = getattr(jopt, cls)(parameters=jm.parameters(), **kw)
    to = getattr(topt, cls)(parameters=tm.parameters(), **kw)
    ids, labels = train_batches(10)
    jstep = JaxScan(jm, jo, one_cpu_mesh(), scan_steps=3, zero_stage=0,
                    donate=False)
    want = np.asarray(jstep(ids, labels).data)
    step = ScanTrainStep(tm, to, scan_steps=3, device="cpu")
    got = step(ids, labels)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert_params_match(jstep._params, tm, 3)
