"""The port's sampling slice against the JAX package, on the CPU.

- `serving/llm/sampling.py`: `SamplingParams`, the grammar compiler (the
  same `trans`/`accept` arrays and the same rejections), the slot table,
  `select_tokens` and `select_next` (the same tokens and DFA states);
- `models/generation.py`: `_select_token` in both calling conventions,
  `_top_k_filter`, `_top_p_filter`, and `generate(do_sample=True)`
  against the JAX `generate()` function called by keywords (the JAX
  models' methods misbind their arguments);
- the engine: greedy, sampled and constrained requests submitted together
  to the port's and the JAX engine (SimClock, the same config, both
  prefix caches off) give the same streams, and
  logprobs within 1e-4, for gpt2-tiny and a llama2-tiny with grouped-query
  attention. Then the reference's contracts on the port alone, after
  tests/test_sampling.py minus speculative decoding and failover:
  bit-identity across batch composition and an engine restart,
  `sample_offset` resume, constrained replay with the DFA fast-forward,
  `grammar_capacity` rejects, metrics and `export_sampling_lanes`; and an
  all-greedy step that runs no sampling code.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import tiny_models

# the nested schema and token table of tests/test_sampling.py
TOKENS = {1: "{", 2: "}", 3: '"a"', 4: ":", 5: "1", 6: "23", 7: ",",
          8: '"b"', 9: "true", 10: "false", 11: '"o"', 12: '"x"'}
SCHEMA = {
    "type": "object",
    "properties": {
        "a": {"type": "integer"},
        "o": {"type": "object",
              "properties": {"x": {"type": "boolean"}},
              "required": ["x"]},
        "b": {"type": "boolean"},
    },
    "required": ["a", "o", "b"],
}
OTHER = {"type": "object", "properties": {"b": {"type": "boolean"}},
         "required": ["b"]}
ENUM_TOKENS = {1: "{", 2: "}", 3: '"c":', 4: '"red"', 5: '"blue"',
               6: ",", 7: '"n":', 8: "-", 9: "0", 10: "7", 11: "42",
               12: '"s":[', 13: "]", 14: "true", 15: "false"}
ENUM_SCHEMA = {"type": "object", "properties": {
    "c": {"enum": ["red", "blue"]},
    "n": {"type": "integer"},
    "s": {"type": "array", "items": {"type": "boolean"}}}}
GRAMMARS = {"nested": (SCHEMA, TOKENS), "bool": (OTHER, TOKENS),
            "enum_int_array": (ENUM_SCHEMA, ENUM_TOKENS),
            "const": ({"const": "ok"}, {1: '"o', 2: 'k"', 3: '"ok"'})}
V = 512
PROMPT = np.arange(1, 9, dtype=np.int32)
CFG = dict(num_slots=3, block_len=8, n_blocks=8, prefill_chunk=16,
           max_new_tokens=12, enable_prefix_cache=False)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- params
@pytest.mark.parametrize("bad", [
    dict(temperature=0.0), dict(temperature=-1.0), dict(top_k=-1),
    dict(top_p=0.0), dict(top_p=1.5), dict(seed=-1), dict(seed=2 ** 31),
    dict(grammar={"schema": {}})])
def test_sampling_params_rejects_as_jax(bad):
    from paddle_tpu.serving.llm.sampling import SamplingParams as JaxSP
    from paddle_tpu_torch.serving.llm.sampling import SamplingParams
    with pytest.raises(ValueError):
        JaxSP(**bad).validate()
    with pytest.raises(ValueError):
        SamplingParams(**bad).validate()


def test_sampling_params_from_payload():
    from paddle_tpu.serving.llm.sampling import SamplingParams as JaxSP
    from paddle_tpu_torch.serving.llm.sampling import (GREEDY,
                                                       SamplingParams)
    assert SamplingParams.from_payload({"input_ids": [1, 2]}) is None
    body = {"temperature": 0.8, "top_k": 40, "top_p": 0.9, "seed": 5,
            "grammar": {"schema": OTHER,
                        "tokens": {str(k): v for k, v in TOKENS.items()}}}
    sp, ref = SamplingParams.from_payload(body), JaxSP.from_payload(body)
    assert (sp.temperature, sp.top_k, sp.top_p, sp.seed, sp.grammar) == (
        ref.temperature, ref.top_k, ref.top_p, ref.seed, ref.grammar)
    assert sp.do_sample and sp.constrained
    assert sp.grammar_key() == ref.grammar_key()
    assert not GREEDY.do_sample and GREEDY.grammar_key() is None
    with pytest.raises(ValueError):
        SamplingParams.from_payload({"temperature": -1})


# ---------------------------------------------------------------- grammar
@pytest.mark.parametrize("name", sorted(GRAMMARS))
@pytest.mark.parametrize("eos", [None, 0])
def test_compile_grammar_equals_jax(name, eos):
    from paddle_tpu.serving.llm.sampling import compile_grammar as jax_cg
    from paddle_tpu_torch.serving.llm.sampling import compile_grammar
    schema, tokens = GRAMMARS[name]
    g = {"schema": schema, "tokens": tokens}
    ref, got = jax_cg(g, V, eos), compile_grammar(g, V, eos)
    assert got.trans.dtype == np.int32 and got.n_states == ref.n_states
    np.testing.assert_array_equal(got.trans, ref.trans)
    np.testing.assert_array_equal(got.accept, ref.accept)


@pytest.mark.parametrize("schema,tokens,vocab", [
    ({"type": "string"}, TOKENS, V),                 # free-form string
    ({"type": "array"}, TOKENS, V),                  # no items
    ({"type": "null"}, TOKENS, V),                   # outside the subset
    ([1, 2], TOKENS, V),                             # not a node
    (OTHER, {600: "{"}, V),                          # id outside vocab
    (OTHER, {1: "{", 2: "}"}, V),                    # unsatisfiable
])
def test_compile_grammar_rejects_as_jax(schema, tokens, vocab):
    from paddle_tpu.serving.llm.sampling import compile_grammar as jax_cg
    from paddle_tpu_torch.serving.llm.sampling import compile_grammar
    g = {"schema": schema, "tokens": tokens}
    with pytest.raises(ValueError) as want:
        jax_cg(g, vocab, None)
    with pytest.raises(ValueError) as got:
        compile_grammar(g, vocab, None)
    assert str(got.value) == str(want.value)


def test_slot_table_lifecycle():
    from paddle_tpu_torch.serving.llm.sampling import (
        SamplingParams, SlotSamplingTable, compile_grammar, lane_key)
    tab = SlotSamplingTable(3, V, max_grammars=1, max_dfa_states=32)
    assert tab.bank.shape == (2, 32, V) and (tab.bank[0, 0] == 0).all()
    dfa = compile_grammar({"schema": OTHER, "tokens": TOKENS}, V, None)
    g = {"schema": OTHER, "tokens": TOKENS}
    key = SamplingParams(grammar=g).grammar_key()
    assert tab.lookup(key) is None
    gid = tab.intern(key, dfa)
    assert gid == 1 and tab.intern(key, dfa) == 1
    assert tab.grammars_compiled == 1 and tab.lookup(key) == 1
    with pytest.raises(ValueError, match="bank full"):
        tab.intern("another", dfa)
    tab.bind(0, SamplingParams(temperature=0.5, top_k=3, seed=77))
    tab.bind(1, SamplingParams(grammar=g), gid=gid)
    assert tab.mode_counts([0, 1, 2]) == {
        "greedy": 1, "sampled": 1, "constrained": 1}
    args = tab.device_args()
    assert tab.device_args() is args                 # cached
    tab.set_dfa_state(1, 2)
    assert tab.device_args() is not args             # invalidated
    assert int(tab.device_args()[4][1]) == 2
    np.testing.assert_array_equal(
        tab.lane_keys(np.array([5, 0, 0], np.int32))[0].numpy(),
        lane_key(77, 5).numpy())
    # terminal: accepting and no legal continuation ('{"b":true}' done)
    q = 0
    for t in (1, 8, 4, 9, 2):
        q = int(tab.bank[gid, q, t])
    assert q >= 0 and dfa.accept[q] and tab.is_terminal(gid, q)
    assert not tab.is_terminal(gid, 0) and not tab.is_terminal(0, 0)
    tab.clear(1)
    assert tab.mode_counts([1]) == {"greedy": 1, "sampled": 0,
                                    "constrained": 0}
    assert int(tab.grammar_id[1]) == 0 and int(tab.dfa_state[1]) == 0
    assert tab.device_bank().shape == (2, 32, V)


# ---------------------------------------------------------------- selection
def _mix(seed, N):
    """Per-row knobs over every mode: greedy, temperature, top-k, top-p,
    top-k + top-p; a third of the rows constrained."""
    rng = np.random.RandomState(seed)
    modes = [(False, 1.0, 0, 1.0), (True, 0.7, 0, 1.0),
             (True, 1.0, 50, 1.0), (True, 1.0, 0, 0.9),
             (True, 0.8, 20, 0.8), (True, 1.3, 1, 1.0)]
    pick = [modes[(i + seed) % len(modes)] for i in range(N)]
    return dict(
        do_sample=np.array([m[0] for m in pick]),
        temperature=np.array([m[1] for m in pick], np.float32),
        top_k=np.array([m[2] for m in pick], np.int32),
        top_p=np.array([m[3] for m in pick], np.float32),
        seed=rng.randint(0, 2 ** 31, N).astype(np.int32),
        ctr=rng.randint(0, 300, N).astype(np.int32))


def _bank(dfas, S=64):
    bank = np.full((1 + len(dfas), S, V), -1, np.int32)
    bank[0, 0] = 0
    for i, d in enumerate(dfas):
        bank[1 + i, :d.n_states] = d.trans
    return bank


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_select_tokens_and_next_equal_jax(seed):
    from paddle_tpu.serving.llm import sampling as J
    from paddle_tpu_torch.serving.llm import sampling as T
    N, C = 12, 4
    rng = np.random.RandomState(100 + seed)
    dfa = J.compile_grammar({"schema": SCHEMA, "tokens": TOKENS}, V, 0)
    bank = _bank([dfa])
    k = _mix(seed, N)
    logits = (rng.standard_normal((N, C, V)) * 2.5).astype(np.float32)
    adv = rng.randint(0, C + 1, N).astype(np.int32)
    gid = (np.arange(N) % 3 == 0).astype(np.int32)
    # constrained rows sit at states their tokens reached
    dstate = np.where(gid > 0, rng.randint(0, 4, N), 0).astype(np.int32)
    order = ("temperature", "top_k", "top_p", "do_sample", "seed", "ctr")
    ref = J.select_tokens(jnp.asarray(logits), jnp.asarray(adv),
                          *(jnp.asarray(k[n]) for n in order),
                          jnp.asarray(dstate), jnp.asarray(gid),
                          jnp.asarray(bank))
    got = T.select_tokens(_t(logits), _t(adv), *(_t(k[n]) for n in order),
                          _t(dstate), _t(gid), _t(bank))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert (got[1].numpy()[gid > 0] >= 0).all()
    ref = J.select_next(jnp.asarray(logits[:, 0]),
                        *(jnp.asarray(k[n]) for n in order))
    got = T.select_next(_t(logits[:, 0]), *(_t(k[n]) for n in order))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_select_rows_is_select_tokens_emission_column():
    """The engine's one-emission-a-row selection gives select_tokens's
    emission column and DFA states: its lane is (seed, ctr + adv - 1)."""
    from paddle_tpu_torch.serving.llm import sampling as T
    N, C = 6, 5
    rng = np.random.RandomState(7)
    dfa = T.compile_grammar({"schema": SCHEMA, "tokens": TOKENS}, V, None)
    bank = _t(_bank([dfa]))
    k = _mix(5, N)
    logits = _t((rng.standard_normal((N, C, V)) * 2).astype(np.float32))
    adv = np.array([1, 5, 3, 2, 1, 4], np.int32)
    gid = _t(np.array([0, 1, 0, 1, 0, 0], np.int32))
    dstate = _t(np.zeros(N, np.int32))
    knobs = [_t(k[n]) for n in ("temperature", "top_k", "top_p",
                                "do_sample")]
    toks, states = T.select_tokens(logits, _t(adv), *knobs,
                                   _t(k["seed"]), _t(k["ctr"]), dstate,
                                   gid, bank)
    e = np.maximum(adv - 1, 0)
    keys = T.lane_key(_t(k["seed"]), _t(k["ctr"] + e))
    for b in (bank, None):
        if b is None:   # unconstrained rows alone: no bank needed
            rows = [0, 2, 4, 5]
            sel = torch.tensor(rows)
            got, st = T.select_rows(logits[sel, e[rows]], keys[sel],
                                    *(x[sel] for x in knobs),
                                    dstate[sel], gid[sel], None)
            np.testing.assert_array_equal(got.numpy(),
                                          toks.numpy()[rows, e[rows]])
            continue
        got, st = T.select_rows(logits[np.arange(N), e], keys, *knobs,
                                dstate, gid, b)
        np.testing.assert_array_equal(got.numpy(),
                                      toks.numpy()[np.arange(N), e])
        np.testing.assert_array_equal(st.numpy(), states.numpy())


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.7, top_k=0, top_p=1.0),
    dict(temperature=1.0, top_k=8, top_p=1.0),
    dict(temperature=1.2, top_k=0, top_p=0.85),
    dict(temperature=0.9, top_k=40, top_p=0.9)])
def test_select_token_static_branch_equals_jax(knobs):
    import jax
    from paddle_tpu.models.generation import _select_token as jax_sel
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.models.generation import _select_token
    lg = (np.random.RandomState(3).standard_normal((5, V)) * 3).astype(
        np.float32)
    for seed in (0, 9):
        ref = jax_sel(jnp.asarray(lg), True, key=jax.random.PRNGKey(seed),
                      **knobs)
        got = _select_token(_t(lg), True, key=threefry.prng_key(seed),
                            **knobs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    greedy = _select_token(_t(lg), False, key=None, **knobs)
    np.testing.assert_array_equal(greedy.numpy(), lg.argmax(-1))


def test_select_token_batched_branch_and_filters_equal_jax():
    import jax
    from paddle_tpu.models import generation as J
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.models import generation as T
    rng = np.random.RandomState(4)
    B = 12
    lg = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    lg[3, 7] = lg[3, 8] = lg[3].max() + 1        # ties at the kth value
    k = _mix(2, B)
    topk = np.array([0, 1, 2, 5, 50, 600, 0, 3, 0, 10, 511, 512], np.int32)
    topp = np.array([1.0, 0.5, 0.9, 0.99, 0.1, 1.0, 0.3, 0.95, 0.7, 0.6,
                     0.8, 0.05], np.float32)
    np.testing.assert_array_equal(
        T._top_k_filter(_t(lg), _t(topk)).numpy(),
        np.asarray(J._top_k_filter(jnp.asarray(lg), jnp.asarray(topk))))
    np.testing.assert_array_equal(
        T._top_p_filter(_t(lg), _t(topp)).numpy(),
        np.asarray(J._top_p_filter(jnp.asarray(lg), jnp.asarray(topp))))
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    ref = J._select_token(jnp.asarray(lg), jnp.asarray(k["do_sample"]),
                          jnp.asarray(k["temperature"]), jnp.asarray(topk),
                          keys, jnp.asarray(topp))
    got = T._select_token(_t(lg), _t(k["do_sample"]), _t(k["temperature"]),
                          _t(topk), threefry.split(threefry.prng_key(11), B),
                          _t(topp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- generate
@pytest.mark.parametrize("preset,over,knobs", [
    ("gpt2-tiny", {}, dict(temperature=0.8, top_k=0, top_p=1.0, seed=0)),
    ("gpt2-tiny", {}, dict(temperature=1.0, top_k=20, top_p=1.0, seed=5)),
    ("gpt2-tiny", {}, dict(temperature=0.7, top_k=0, top_p=0.9,
                           seed=2 ** 31 - 1)),
    ("gpt2-tiny", {}, dict(temperature=1.3, top_k=50, top_p=0.8, seed=77)),
    ("llama2-tiny", {"num_key_value_heads": 2},
     dict(temperature=0.9, top_k=30, top_p=0.95, seed=3))])
def test_sampled_generate_equals_jax(preset, over, knobs):
    from paddle_tpu.models.generation import generate as jax_generate
    from paddle_tpu_torch.models.generation import generate
    jm, tm = tiny_models(preset, **over)
    ids = np.random.RandomState(knobs["seed"] % 100).randint(
        0, V, (3, 7)).astype(np.int32)
    ref = np.asarray(jax_generate(jm, ids, max_new_tokens=10,
                                  do_sample=True, **knobs).data)
    out = generate(tm, ids, max_new_tokens=10, do_sample=True, **knobs)
    np.testing.assert_array_equal(out.numpy(), ref)
    greedy = generate(tm, ids, max_new_tokens=10)
    assert not np.array_equal(out.numpy(), greedy.numpy())


def test_sampled_generate_eos_equals_jax(models):
    from paddle_tpu.models.generation import generate as jax_generate
    from paddle_tpu_torch.models.generation import generate
    jm, tm = models
    ids = np.random.RandomState(8).randint(0, V, (2, 6)).astype(np.int32)
    knobs = dict(do_sample=True, temperature=1.0, top_k=10, seed=21)
    free = generate(tm, ids, max_new_tokens=10, **knobs).numpy()
    eos = int(free[0, 6 + 2])
    ref = np.asarray(jax_generate(jm, ids, max_new_tokens=10,
                                  eos_token_id=eos, **knobs).data)
    out = generate(tm, ids, max_new_tokens=10, eos_token_id=eos, **knobs)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert tm._last_decode_steps == jm._last_decode_steps


# ---------------------------------------------------------------- engine
def _port_engine(tm, **over):
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    return LLMEngine(tm, LLMEngineConfig(**{**CFG, **over}),
                     clock=SimClock())


def _drain(eng):
    steps = 0
    while eng.has_work():
        eng.clock.advance(0.01)
        eng.pump()
        steps += 1
        assert steps < 2000, "engine failed to converge"


def _sp(**kw):
    from paddle_tpu_torch.serving.llm.sampling import SamplingParams
    return SamplingParams(**kw)


def _grammar(seed=7, **kw):
    return _sp(seed=seed, grammar={"schema": SCHEMA, "tokens": TOKENS},
               **kw)


# greedy, sampled over every filter, constrained greedy and sampled
MIX = [None, dict(temperature=0.8, top_k=20, seed=3),
       dict(temperature=1.0, top_p=0.9, seed=4),
       dict(seed=5, grammar={"schema": SCHEMA, "tokens": TOKENS}),
       dict(grammar={"schema": OTHER, "tokens": TOKENS}),
       dict(temperature=0.7, top_k=30, top_p=0.8, seed=6), None]


@pytest.mark.parametrize("preset,over", [
    ("gpt2-tiny", {}), ("llama2-tiny", {"num_key_value_heads": 2})])
def test_mixed_streams_match_jax_engine(preset, over):
    from paddle_tpu.serving.clock import SimClock as JaxSimClock
    from paddle_tpu.serving.llm import LLMEngine as JaxEngine
    from paddle_tpu.serving.llm import LLMEngineConfig as JaxConfig
    from paddle_tpu.serving.llm.sampling import SamplingParams as JaxSP
    jm, tm = tiny_models(preset, **over)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, V, (n,)).astype(np.int32)
               for n in (5, 21, 9, 30, 3, 17, 12)]
    je = JaxEngine(jm, JaxConfig(**CFG),
                   clock=JaxSimClock())
    te = _port_engine(tm)
    rows = {}
    for name, eng in (("jax", je), ("port", te)):
        rows[name] = []
        build = eng._build_rows_locked

        def recording(*a, _build=build, _log=rows[name], **k):
            out = _build(*a, **k)
            _log.append((out[2].copy(), out[3].copy()))
            return out

        eng._build_rows_locked = recording
    jh, th = [], []
    for i, (p, s) in enumerate(zip(prompts, MIX)):
        mnt = 30 if s and "grammar" in s else None
        off = 2 if i == 1 else 0          # a resumed stream
        jh.append(je.submit(p, logprobs=True, max_new_tokens=mnt,
                            sample_offset=off,
                            sampling=None if s is None else JaxSP(**s)))
        th.append(te.submit(p, logprobs=True, max_new_tokens=mnt,
                            sample_offset=off,
                            sampling=None if s is None else _sp(**s)))
    _drain(je)
    _drain(te)
    # the port draws each row's emission column adv-1 on lane ctr; the
    # JAX engine backs a prefill row's column 0 off so that column lands
    # on the same lane
    assert len(rows["port"]) == len(rows["jax"])
    for (adv, ctr), (jadv, jctr) in zip(rows["port"], rows["jax"]):
        np.testing.assert_array_equal(adv, jadv)
        live = adv > 0
        np.testing.assert_array_equal(ctr[live],
                                      (jctr + adv - 1)[live])
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(b.result(0), a.result(0))
        np.testing.assert_allclose(b.logprobs_so_far(),
                                   a.logprobs_so_far(), atol=1e-4, rtol=0)
    js, ts = je.metrics.snapshot(), te.metrics.snapshot()
    for key in ("sampled_tokens", "constrained_tokens", "grammars_compiled",
                "tokens_out"):
        assert ts[key] == js[key], key
    assert ts["constrained_tokens"] > 0 and ts["sampled_tokens"] > 0
    assert te.pool.check_balance()


def test_seeded_bit_identity_across_batch_composition(models):
    _, tm = models
    eng = _port_engine(tm, num_slots=2)
    sp = _sp(temperature=0.9, top_p=0.95, seed=42)
    solo = eng.submit(PROMPT, max_new_tokens=10, sampling=sp)
    _drain(eng)
    mate = eng.submit(np.arange(3, 12, dtype=np.int32), max_new_tokens=12)
    batched = eng.submit(PROMPT, max_new_tokens=10, sampling=sp)
    _drain(eng)
    mate.result(0)
    np.testing.assert_array_equal(solo.result(0), batched.result(0))
    other = eng.submit(PROMPT, max_new_tokens=10,
                       sampling=_sp(temperature=0.9, top_p=0.95, seed=43))
    _drain(eng)
    assert not np.array_equal(solo.result(0), other.result(0))


def test_seeded_bit_identity_across_engine_restart(models):
    _, tm = models
    sp = _sp(temperature=0.8, top_k=50, seed=99)
    streams = []
    for _ in range(2):
        eng = _port_engine(tm)
        h = eng.submit(PROMPT, max_new_tokens=12, sampling=sp)
        _drain(eng)
        streams.append(h.result(0))
    np.testing.assert_array_equal(streams[0], streams[1])


def test_sample_offset_resumes_mid_stream(models):
    _, tm = models
    eng = _port_engine(tm)
    sp = _sp(temperature=0.9, top_p=0.9, seed=11)
    full = eng.submit(PROMPT, max_new_tokens=12, sampling=sp)
    _drain(eng)
    full = full.result(0)
    head = eng.submit(PROMPT, max_new_tokens=4, sampling=sp)
    _drain(eng)
    head = head.result(0)
    np.testing.assert_array_equal(head, full[:4])
    tail = eng.submit(np.concatenate([PROMPT, head]), max_new_tokens=8,
                      sampling=sp, sample_offset=4)
    _drain(eng)
    np.testing.assert_array_equal(tail.result(0), full[4:])
    with pytest.raises(ValueError, match="sample_offset"):
        eng.submit(PROMPT, sampling=sp, sample_offset=-1)


def test_constrained_emits_only_grammar_valid_json(models):
    from paddle_tpu_torch.serving.llm.sampling import compile_grammar
    _, tm = models
    eng = _port_engine(tm, max_new_tokens=40)
    hs = [eng.submit(PROMPT, sampling=_grammar(seed=s)) for s in (7, 8)]
    hs.append(eng.submit(PROMPT, sampling=_sp(
        grammar={"schema": SCHEMA, "tokens": TOKENS})))     # greedy
    _drain(eng)
    dfa = compile_grammar({"schema": SCHEMA, "tokens": TOKENS}, V, None)
    for h in hs:
        toks = h.result(0)
        state = 0
        for t in toks:
            state = int(dfa.trans[state, int(t)])
            assert state >= 0
        assert dfa.accept[state] and not (dfa.trans[state] >= 0).any()
        obj = json.loads("".join(TOKENS[int(t)] for t in toks))
        assert set(obj) == {"a", "o", "b"} and isinstance(obj["a"], int)
        assert set(obj["o"]) == {"x"} and isinstance(obj["b"], bool)


def test_constrained_ends_at_eos(models):
    """With an EOS id, EOS is legal exactly at acceptance, and emitting it
    finishes the stream."""
    _, tm = models
    eng = _port_engine(tm, max_new_tokens=40)
    h = eng.submit(PROMPT, eos_token_id=0, sampling=_grammar(seed=3))
    _drain(eng)
    toks = h.result(0)
    assert toks[-1] == 0
    json.loads("".join(TOKENS[int(t)] for t in toks[:-1]))


def test_constrained_replay_and_dfa_fast_forward(models):
    from paddle_tpu_torch.serving.engine import RejectedError
    _, tm = models
    eng = _port_engine(tm, max_new_tokens=40)
    sp = _grammar(seed=21)
    h1 = eng.submit(PROMPT, sampling=sp)
    _drain(eng)
    full = h1.result(0)
    h2 = eng.submit(PROMPT, sampling=sp)
    _drain(eng)
    np.testing.assert_array_equal(full, h2.result(0))
    k = 3
    h3 = eng.submit(np.concatenate([PROMPT, full[:k]]),
                    max_new_tokens=40 - k, sampling=sp, sample_offset=k)
    _drain(eng)
    np.testing.assert_array_equal(h3.result(0), full[k:])
    bad_tail = np.array([2, 2, 2], np.int32)    # "}}}" from the start
    with pytest.raises((ValueError, RejectedError)):
        eng.submit(np.concatenate([PROMPT, bad_tail]), max_new_tokens=8,
                   sampling=sp, sample_offset=3)


def test_lane_export_restores_the_stream(models):
    """export_sampling_lanes mid-stream, then a resubmission of prompt +
    emitted with sample_offset = next_index and the lane (its DFA state
    taken directly, no re-walk) finishes as the uninterrupted run."""
    _, tm = models
    sp = _grammar(seed=13)
    eng = _port_engine(tm, max_new_tokens=40)
    ref = eng.submit(PROMPT, sampling=sp)
    _drain(eng)
    ref = ref.result(0)
    h = eng.submit(PROMPT, sampling=sp)
    for _ in range(5):
        eng.pump()
    slot = next(iter(eng._active))
    lane = eng.export_sampling_lanes([slot])[slot]
    emitted = h.tokens_so_far()
    assert lane["seed"] == 13 and lane["next_index"] == len(emitted) > 0
    assert lane["grammar_key"] == sp.grammar_key()
    assert lane["dfa_state"] == int(eng.sampling_table.dfa_state[slot])
    with pytest.raises(ValueError, match="no active request"):
        eng.export_sampling_lanes([(slot + 1) % CFG["num_slots"]])
    _drain(eng)
    other = _port_engine(tm, max_new_tokens=40)
    # a lane that matches restores its DFA state even when the prompt's
    # tail would not walk there
    resumed = other.submit(
        np.concatenate([PROMPT, np.zeros(len(emitted), np.int32)]),
        max_new_tokens=40 - len(emitted), sampling=sp,
        sample_offset=len(emitted), lane=lane)
    _drain(other)
    np.testing.assert_array_equal(resumed.result(0), ref[len(emitted):])


def test_grammar_capacity_rejects(models):
    from paddle_tpu_torch.serving.engine import RejectedError
    _, tm = models
    eng = _port_engine(tm, max_grammars=1, max_new_tokens=40)
    h = eng.submit(PROMPT, sampling=_grammar())
    with pytest.raises(RejectedError) as ei:
        eng.submit(PROMPT, max_new_tokens=8, sampling=_sp(
            temperature=1.0, seed=1,
            grammar={"schema": OTHER, "tokens": TOKENS}))
    assert ei.value.reason == "grammar_capacity"
    with pytest.raises(ValueError, match="free-form"):
        eng.submit(PROMPT, sampling=_sp(
            grammar={"schema": {"type": "string"}, "tokens": TOKENS}))
    with pytest.raises(ValueError, match="temperature"):
        eng.submit(PROMPT, sampling=_sp(temperature=0.0, seed=1))
    _drain(eng)
    h.result(0)
    assert eng.metrics.snapshot()["reject_reasons"] == {
        "grammar_capacity": 1}
    with pytest.raises(ValueError, match="max_grammars"):
        _port_engine(tm, max_grammars=0)
    with pytest.raises(ValueError, match="max_dfa_states"):
        _port_engine(tm, max_dfa_states=0)


def test_sampling_metrics(models):
    _, tm = models
    eng = _port_engine(tm, max_new_tokens=40)
    h = eng.submit(PROMPT, max_new_tokens=8, sampling=_sp(temperature=0.9,
                                                          seed=5))
    hc = eng.submit(PROMPT, sampling=_grammar())
    hg = eng.submit(PROMPT, max_new_tokens=6)
    eng.pump()
    snap = eng.metrics.snapshot()
    assert snap["sample_slots"] == {"greedy": 1, "sampled": 1,
                                    "constrained": 1}
    _drain(eng)
    n_con = hc.result(0).size
    snap = eng.metrics.snapshot()
    assert snap["sampled_tokens"] == h.result(0).size == 8
    assert snap["constrained_tokens"] == n_con
    assert snap["tokens_out"] + snap["prefills"] == 8 + n_con + \
        hg.result(0).size
    assert snap["grammars_compiled"] == 1
    assert snap["sample_slots"] == {"greedy": 0, "sampled": 0,
                                    "constrained": 0}
    assert snap["mask_overhead_p50_ms"] is not None
    assert (eng.sampling_table.grammar_id == 0).all()      # all cleared


def test_all_greedy_steps_run_no_sampling_code(models, monkeypatch):
    """An engine whose active requests are all greedy selects with the
    greedy path alone: no lane keys, no sampling operands, no
    select_rows; its streams equal generate()."""
    from paddle_tpu_torch.models.generation import generate
    from paddle_tpu_torch.serving.llm import llm_engine, sampling

    def boom(*a, **k):
        raise AssertionError("sampling code ran in an all-greedy step")

    _, tm = models
    eng = _port_engine(tm)
    for name in ("lane_keys", "device_args", "device_bank"):
        monkeypatch.setattr(sampling.SlotSamplingTable, name, boom)
    monkeypatch.setattr(llm_engine, "select_rows", boom)
    monkeypatch.setattr(sampling.threefry, "threefry2x32", boom)
    prompts = [np.arange(n, 2 * n + 3, dtype=np.int32) for n in (2, 9, 20)]
    hs = [eng.submit(p) for p in prompts]
    _drain(eng)
    for p, h in zip(prompts, hs):
        ref = generate(tm, p[None], max_new_tokens=12).numpy()[0, len(p):]
        np.testing.assert_array_equal(h.result(0), ref)
    assert eng.metrics.snapshot()["mask_overhead_p50_ms"] is None
