"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are drawn with numpy from a seed and handed to both packages;
the JAX package runs on the CPU, the port with device="cpu" (its plain
versions). Tests of the CUDA kernels call `require_cuda()` first, which
decides inside the test whether there is a card. This module imports no
JAX at its top, so the CUDA tests also run where only PyTorch exists.
"""
import numpy as np
import pytest

_TINY_JAX = {}


def require_cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(its plain version is tested against the JAX package "
                    "instead)")


def _families(preset):
    """(JAX class, port class) of the model family a preset names."""
    if preset.startswith("llama"):
        from paddle_tpu.models.llama import LlamaForCausalLM as Jax
        from paddle_tpu_torch.models.llama import LlamaForCausalLM as Port
    else:
        from paddle_tpu.models.gpt import GPTForCausalLM as Jax
        from paddle_tpu_torch.models.gpt import GPTForCausalLM as Port
    return Jax, Port


def _port_twin(jm, preset, **overrides):
    """The port model of `preset` on the CPU with jm's weights bridged."""
    from paddle_tpu_torch.bridge import load_jax_state
    params, _ = jm.functional_state()
    tm = _families(preset)[1].from_preset(preset, device="cpu", **overrides)
    load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()})
    return tm


def tiny_models(preset="gpt2-tiny", **overrides):
    """(jax_model, port_model) pair of a tiny preset (gpt2-tiny or
    llama2-tiny, with config `overrides`) with the JAX weights bridged
    into the port. The JAX model is built once per process (seed 0)."""
    import paddle_tpu as paddle

    key = (preset, tuple(sorted(overrides.items())))
    if key not in _TINY_JAX:
        paddle.seed(0)
        _TINY_JAX[key] = _families(preset)[0].from_preset(preset,
                                                          **overrides)
    jm = _TINY_JAX[key]
    return jm, _port_twin(jm, preset, **overrides)


def jax_prefill(jm, ids, caches, pos, paged=None):
    """The JAX model's cached forward through its decoder functions:
    (logits as numpy, new caches)."""
    import jax.numpy as jnp
    from paddle_tpu.models.generation import make_decoder_fns
    params, prefill, _ = make_decoder_fns(jm)
    logits, new = prefill(params, jnp.asarray(ids), caches, pos, paged=paged)
    return np.asarray(logits), new


def jax_caches(jm, B, L):
    """The JAX model's init_cache(B, L) as raw (k, v) arrays."""
    return [(k.data, v.data) if hasattr(k, "data") else (k, v)
            for k, v in jm.init_cache(B, L)]


# The cached-decode cases both model families are held to (tests/
# test_torch_gpt.py, tests/test_torch_llama.py): a JAX model and its port
# twin with the same weights, fp32. Logits within CACHE_ATOL (sums in
# another order put them ~1e-6 apart); generated tokens equal.
CACHE_ATOL = 1e-4


def check_cache_scalar_pos(jm, tm):
    import jax.numpy as jnp
    import torch
    ids = np.random.RandomState(0).randint(0, 512, (2, 7)).astype(np.int32)
    ref, _ = jax_prefill(jm, ids, jax_caches(jm, 2, 24), jnp.int32(3))
    out, _ = tm.forward_with_cache(torch.from_numpy(ids),
                                   tm.init_cache(2, 24), 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=CACHE_ATOL, rtol=0)


def check_cache_vector_pos_two_steps(jm, tm):
    """Per-row offsets over a cache already holding a prefix: the second
    call reads the KV the first one wrote (and a rotary model rotates its
    tokens at each row's position past them)."""
    import jax.numpy as jnp
    import torch
    rng = np.random.RandomState(1)
    a = rng.randint(0, 512, (3, 5)).astype(np.int32)
    bb = rng.randint(0, 512, (3, 2)).astype(np.int32)
    pos = np.array([0, 4, 9], np.int32)
    jc = jax_caches(jm, 3, 24)
    _, jc = jax_prefill(jm, a, jc, jnp.asarray(pos))
    ref, _ = jax_prefill(jm, bb, jc, jnp.asarray(pos + 5))
    tc = tm.init_cache(3, 24)
    assert tuple(tc[0][0].shape) == tuple(jc[0][0].shape)
    _, tc = tm.forward_with_cache(torch.from_numpy(a), tc,
                                  torch.from_numpy(pos))
    out, _ = tm.forward_with_cache(torch.from_numpy(bb), tc,
                                   torch.from_numpy(pos + 5))
    np.testing.assert_allclose(out.numpy(), ref, atol=CACHE_ATOL, rtol=0)


def check_cache_paged(jm, tm):
    """The serving step's form: slab rows with chunk write-padding, per-row
    positions, block tables and ragged seq_lens."""
    import jax.numpy as jnp
    import torch
    rng = np.random.RandomState(2)
    N, bl, nb, C = 3, 8, 4, 6
    L = nb * bl + C
    toks = rng.randint(0, 512, (N, C)).astype(np.int32)
    pos = np.array([0, 3, nb * bl], np.int32)         # last: a free row
    adv = np.array([6, 2, 0], np.int32)
    table = (np.arange(N, dtype=np.int32)[:, None] * nb
             + np.arange(nb, dtype=np.int32)[None])
    seq = (pos + adv).astype(np.int32)
    ref, _ = jax_prefill(jm, toks, jax_caches(jm, N, L), jnp.asarray(pos),
                         paged=(jnp.asarray(table), jnp.asarray(seq), bl,
                                nb))
    out, _ = tm.forward_with_cache(
        torch.from_numpy(toks), tm.init_cache(N, L), torch.from_numpy(pos),
        paged=(torch.from_numpy(table), torch.from_numpy(seq), bl, nb))
    for r in range(N):      # real columns only; the rest are discarded
        n = int(adv[r])
        np.testing.assert_allclose(out.numpy()[r, :n], ref[r, :n],
                                   atol=CACHE_ATOL, rtol=0)


def check_generate(jm, tm, B, S0, new):
    """Greedy generate() against the JAX generate function (the JAX
    models' generate methods misbind their arguments)."""
    import torch
    from paddle_tpu.models.generation import generate as jax_generate
    from paddle_tpu_torch.models.generation import generate
    ids = np.random.RandomState(B + S0).randint(0, 512, (B, S0)).astype(
        np.int32)
    ref = np.asarray(jax_generate(jm, ids, max_new_tokens=new).data)
    out = generate(tm, ids, max_new_tokens=new)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert tm._last_decode_steps == jm._last_decode_steps == new - 1


def check_generate_eos(jm, tm):
    from paddle_tpu.models.generation import generate as jax_generate
    from paddle_tpu_torch.models.generation import generate
    ids = np.random.RandomState(7).randint(0, 512, (2, 6)).astype(np.int32)
    free = np.asarray(jax_generate(jm, ids, max_new_tokens=10).data)
    # EOS = row 0's 4th new token: row 0 stops there and pads with EOS
    eos = int(free[0, 6 + 3])
    ref = np.asarray(jax_generate(jm, ids, max_new_tokens=10,
                                  eos_token_id=eos).data)
    out = generate(tm, ids, max_new_tokens=10, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(out, ref)
    assert tm._last_decode_steps == jm._last_decode_steps
    # one row: the loop stops as soon as it emits EOS
    ref1 = np.asarray(jax_generate(jm, ids[:1], max_new_tokens=10,
                                   eos_token_id=eos).data)
    out1 = generate(tm, ids[:1], max_new_tokens=10, eos_token_id=eos)
    np.testing.assert_array_equal(out1.numpy(), ref1)
    assert tm._last_decode_steps == jm._last_decode_steps == 3


def check_generate_method(tm):
    """The port model's generate method binds by keyword, so it equals the
    generate() function, eos_token_id included (the JAX method would
    treat token 0 as EOS), and a sampled call too (the JAX method would
    pass its seed as top_p)."""
    from paddle_tpu_torch.models.generation import generate
    ids = np.array([[5, 6, 7]], np.int32)
    np.testing.assert_array_equal(tm.generate(ids, max_new_tokens=5),
                                  generate(tm, ids, max_new_tokens=5))
    np.testing.assert_array_equal(
        tm.generate(ids, max_new_tokens=5, eos_token_id=0),
        generate(tm, ids, max_new_tokens=5, eos_token_id=0))
    knobs = dict(do_sample=True, temperature=0.9, top_k=40, top_p=0.9,
                 seed=1234)
    np.testing.assert_array_equal(
        tm.generate(ids, max_new_tokens=6, **knobs),
        generate(tm, ids, max_new_tokens=6, **knobs))


def paged_inputs(seed, B=3, H=4, Hkv=2, Tq=6, D=16, bl=4, ppr=5, N=3,
                 pad=3, lens=(17, 9, 4), decode_rows=(1,)):
    """Slabs [N, Hkv, ppr*bl + pad, D], a table whose rows share pages
    (row 1 reuses row 0's first two pages) and pad with -1 past each
    row's length, q_pos = len - Tq for prefill rows, len - 1 for decode."""
    rng = np.random.RandomState(seed)
    L = ppr * bl + pad
    k = rng.standard_normal((N, Hkv, L, D)).astype(np.float32)
    v = rng.standard_normal((N, Hkv, L, D)).astype(np.float32)
    q = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    nb = ppr
    pages = rng.permutation(N * ppr).astype(np.int32)
    table = np.full((B, nb), -1, np.int32)
    for b, n in enumerate(lens):
        used = -(-n // bl)
        table[b, :used] = pages[b * nb:b * nb + used]
    table[1, :2] = table[0, :2]            # shared pages across rows
    q_pos = np.array([max(n - 1, 0) if b in decode_rows else max(n - Tq, 0)
                      for b, n in enumerate(lens)], np.int32)
    return dict(q=q, k=k, v=v, table=table,
                lens=np.asarray(lens, np.int32), q_pos=q_pos, bl=bl,
                ppr=ppr)


def layernorm_inputs(seed, shape, n):
    """x [shape] ~ N(0.5, 9), weight and bias [n] ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    w = rng.standard_normal((n,)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    return x, w, b


def ulp_bf16(a):
    """One bf16 unit in the last place at |a| (8 significant bits)."""
    a = np.maximum(np.abs(a.astype(np.float32)), np.float32(1.2e-38))
    return np.exp2(np.floor(np.log2(a)) - 7)


def train_batches(seed, K=3, B=2, S=64, vocab=512):
    """[K, B, S] token ids and next-token labels with ignored (-100)
    tokens: each row's last label and the first 7 of row 0."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (K, B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=2)
    labels[:, :, -1] = -100
    labels[:, 0, :7] = -100
    return ids, labels


def train_models(preset="gpt2-tiny", **overrides):
    """A fresh JAX model of a tiny preset (seed 0) and the port model with
    its weights, both built with the config `overrides`, the port's in
    train mode."""
    import paddle_tpu as paddle
    paddle.seed(0)
    jm = _families(preset)[0].from_preset(preset, **overrides)
    tm = _port_twin(jm, preset, **overrides)
    tm.train()
    return jm, tm


def resnet_twins(depth=18, **kw):
    """A fresh JAX ResNet (seed 0) and the port's on the CPU with its
    weights and buffers bridged in; both in training mode."""
    import paddle_tpu as paddle
    from paddle_tpu_torch.bridge import load_jax_state
    from paddle_tpu_torch.vision import models
    paddle.seed(0)
    jm = getattr(paddle.vision.models, f"resnet{depth}")(**kw)
    params, bufs = jm.functional_state()
    tm = getattr(models, f"resnet{depth}")(device="cpu", **kw)
    load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()},
                   {k: np.asarray(v) for k, v in bufs.items()})
    return jm, tm


def resnet_batches(seed, K=3, B=4, S=64, classes=10):
    """[K, B, 3, S, S] fp32 images and [K, B] int64 labels."""
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((K, B, 3, S, S)).astype(np.float32),
            rng.randint(0, classes, (K, B)).astype(np.int64))


def one_cpu_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _key_bias(name, d, n_heads=4):
    """The key columns of a qkv bias ([head][q | k | v] x head_dim)."""
    if not name.endswith("qkv_proj.bias"):
        return np.zeros(d.shape, bool)
    mask = np.zeros((n_heads, 3, d.size // (3 * n_heads)), bool)
    mask[:, 1] = True
    return mask.reshape(d.shape)


def assert_params_match(jax_params, tm, steps, lr=1e-3):
    """The port model's parameters against a JAX train step's, to the
    limits tests/test_torch_train_step.py states and explains: every
    element within 2 x lr x steps; outside the key part of the qkv biases
    at most 1e-4 of the elements more than 1e-5 apart."""
    from paddle_tpu_torch.bridge import export_state
    got = export_state(tm)
    assert set(got) == set(jax_params)
    far = total = 0
    for k, v in jax_params.items():
        d = np.abs(got[k] - np.asarray(v, np.float32))
        assert d.max() <= 2 * lr * steps, (k, float(d.max()))
        rest = d[~_key_bias(k, d)]
        far += int((rest > 1e-5).sum())
        total += rest.size
    assert far <= 1e-4 * total, (far, total)



def assert_bf16_attention_close(out, ref):
    """bf16 paged attention against its plain version, to the limits that
    chip_smoke.py states and explains beside its BF16_PA_* constants:
    every element within BF16_PA_ULPS bf16 ulps of the larger magnitude +
    BF16_PA_ATOL, and at most BF16_PA_SHARE of them past one ulp."""
    from chip_smoke import BF16_PA_ATOL, BF16_PA_SHARE, BF16_PA_ULPS
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    err = np.abs(out - ref)
    ulp = ulp_bf16(np.maximum(np.abs(out), np.abs(ref)))
    excess = float((err - BF16_PA_ULPS * ulp).max())
    assert excess <= BF16_PA_ATOL, \
        f"an element is {excess} past {BF16_PA_ULPS} bf16 ulps"
    share = float((err > ulp).mean())
    assert share <= BF16_PA_SHARE, \
        f"{share} of the elements are more than one bf16 ulp apart"


# ---- engines with the prefix cache (tests/test_torch_prefix_cache.py,
# tests/test_torch_host_kv.py) ----

def record_evictions(pool):
    """Wrap `pool.release_cached` to record the pages it releases, in
    order; returns the list it appends to."""
    pages = []
    orig = pool.release_cached

    def release(page):
        pages.append(int(page))
        return orig(page)

    pool.release_cached = release
    return pages


def engine_pair(jm, tm, cfg, **over):
    """(JAX engine, port engine) on SimClocks with the config `cfg` and
    `over`, each pool recording its evicted pages in `engine.evicted`."""
    from paddle_tpu.serving.clock import SimClock as JaxSimClock
    from paddle_tpu.serving.llm import LLMEngine as JaxEngine
    from paddle_tpu.serving.llm import LLMEngineConfig as JaxConfig
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    cfg = {**cfg, **over}
    je = JaxEngine(jm, JaxConfig(**cfg), clock=JaxSimClock())
    te = LLMEngine(tm, LLMEngineConfig(**cfg), clock=SimClock())
    assert (te.prefix_cache is not None) == te.config.enable_prefix_cache
    je.evicted = record_evictions(je.pool)
    te.evicted = record_evictions(te.pool)
    return je, te


def drain(engine):
    while engine.has_work():
        engine.pump()


PREFIX_KEYS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
               "prefix_lookup_tokens", "prefix_hit_rate", "cached_blocks",
               "cache_evictions", "tenants", "host_kv")


def assert_engines_equal(je, te, jh, th):
    """The JAX engine `je` and the port's `te` after the same requests
    (handles `jh`, `th`): equal streams and logprobs within 1e-4; equal
    prefill, onboard and import token counts and decode steps; equal
    prefix and host-tier metrics, reject reasons, pool stats, refcounts,
    cached pages, trie stats and evicted pages; both ledgers balanced."""
    for a, b in zip(jh, th):
        assert b.future.done() == a.future.done()
        np.testing.assert_array_equal(b.tokens_so_far(), a.tokens_so_far())
        lj, lt = a.logprobs_so_far(), b.logprobs_so_far()
        assert [x is None for x in lt] == [x is None for x in lj]
        if lj and lj[0] is not None:
            np.testing.assert_allclose(lt, lj, atol=1e-4, rtol=0)
    for attr in ("prefill_tokens", "host_onboard_tokens",
                 "kv_import_tokens", "decode_iterations"):
        assert getattr(te, attr) == getattr(je, attr), attr
    js, ts = je.metrics.snapshot(), te.metrics.snapshot()
    for k in PREFIX_KEYS:
        assert ts[k] == js[k], (k, js[k], ts[k])
    assert te.metrics.reject_reasons == je.metrics.reject_reasons
    assert te.pool.stats == je.pool.stats
    assert te.pool.snapshot() == je.pool.snapshot()
    assert te.pool.refcount == je.pool.refcount
    assert te.pool.cached == je.pool.cached
    assert te.evicted == je.evicted
    if je.prefix_cache is not None:
        assert te.prefix_cache.snapshot() == je.prefix_cache.snapshot()
        assert te.prefix_cache.spilled_pages == je.prefix_cache.spilled_pages
    assert te.pool.check_balance() and je.pool.check_balance()


def jax_abstract(build):
    """The JAX layer `build()` makes, built under `jax.eval_shape`: its
    layers, names and shapes, with no initializer run (so none compiles).
    Load real arrays (`set_state_dict`) before calling it."""
    import jax
    box = []

    def run():
        box.append(build())
        return 0

    jax.eval_shape(run)
    return box[0]


def jax_abstract_model(name, **kw):
    """`paddle.vision.models.<name>(**kw)` of the JAX package, built by
    `jax_abstract`."""
    import paddle_tpu as paddle
    return jax_abstract(lambda: getattr(paddle.vision.models, name)(**kw))


def jax_twin_of(tm, build):
    """The JAX layer `build()` makes (abstractly), holding port model
    tm's parameters and buffers."""
    from paddle_tpu_torch.bridge import export_buffers, export_state
    jm = jax_abstract(build)
    missing, unexpected = jm.set_state_dict({**export_state(tm),
                                             **export_buffers(tm)})
    assert missing == [] and unexpected == [], (missing, unexpected)
    return jm


def vision_twins(name, **kw):
    """(JAX model, port model on the CPU) of vision model `name` with the
    port's weights and buffers (drawn from seed 0) loaded into the JAX
    one through its own `set_state_dict`, both in training mode with
    every Dropout's p set to 0 (the two draw different masks)."""
    import paddle_tpu as paddle
    from paddle_tpu_torch.vision import models
    tm = getattr(models, name)(device="cpu", **kw)
    jm = jax_twin_of(tm, lambda: getattr(paddle.vision.models, name)(**kw))
    for m in list(jm.sublayers(include_self=True)) + list(tm.modules()):
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    return jm, tm


def jax_train_forward(jm, x):
    """(logits, new buffers) of one training-mode forward of JAX model jm
    on x, traced once under jax.jit (each eager op would compile on its
    own), as numpy."""
    import jax
    params, bufs = jm.functional_state()
    out, new = jax.jit(lambda p, b, a: jm.functional_call_with_state(
        p, b, a))(params, bufs, x)
    return np.asarray(out), {k: np.asarray(v) for k, v in new.items()}
