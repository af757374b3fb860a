"""The prefix cache's device side on a GPU: shared pages, copy-on-write,
page export and import, defrag and free pinned rows, in bf16.

These tests need an NVIDIA GPU and skip without one; they import no JAX
(tests/test_torch_prefix_cache.py and tests/test_torch_host_kv.py hold
the same code to the JAX package on the CPU), so they run where only
PyTorch exists:

    python -m pytest --noconftest tests/test_torch_cuda_prefix.py -q

At gpt3-1.3b's widths cut to 2 layers (bf16, random weights) behind the
serve cell's engine (8 slots, block_len 8, 64 blocks, 64-token chunks):
a warm stream that attaches a 256-token shared prefix, and an exact
duplicate that copies a block on write, equal to the cold stream bit for
bit; and on a pool of that geometry: `cow_copy`, `export_page` ->
`import_page` and `defrag` bit-exact on the card, and a burst's free
rows, pinned by cached pages, writing only into the pad.
"""
import numpy as np
import pytest
import torch

from _torch_port import require_cuda

ENGINE = dict(num_slots=8, block_len=8, n_blocks=64, prefill_chunk=64,
              max_new_tokens=8)
VOCAB = 50304


def _model():
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return GPTForCausalLM.from_preset("gpt3-1.3b", device="cuda",
                                      dtype="bfloat16", generator=gen,
                                      num_hidden_layers=2)


def _engine(model, **over):
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    return LLMEngine(model, LLMEngineConfig(**{**ENGINE, **over}),
                     clock=SimClock())


def _drain(engine):
    while engine.has_work():
        engine.pump()


def _prompts(n_warm=7):
    rng = np.random.RandomState(2)
    shared = rng.randint(0, VOCAB, (256,)).astype(np.int32)
    return [np.concatenate([shared, rng.randint(0, VOCAB, (n,)).astype(
        np.int32)]) for n in [32] + [16 + 19 * i for i in range(n_warm)]]


def _run(engine, prompts):
    """The first prompt alone, then the rest at once, then the last one
    again; returns the streams."""
    hs = [engine.submit(prompts[0])]
    _drain(engine)
    hs += [engine.submit(p) for p in prompts[1:]]
    _drain(engine)
    hs.append(engine.submit(prompts[-1]))
    _drain(engine)
    return [h.result(0) for h in hs]


@pytest.mark.cuda
def test_cuda_warm_streams_equal_cold_bit_for_bit():
    require_cuda()
    model = _model()
    prompts = _prompts()
    cold = _run(_engine(model, enable_prefix_cache=False), prompts)
    warm_eng = _engine(model)
    warm = _run(warm_eng, prompts)
    for i, (w, c) in enumerate(zip(warm, cold)):
        np.testing.assert_array_equal(w, c, err_msg=f"stream {i}")
    snap = warm_eng.metrics.snapshot()
    assert snap["prefix_hits"] == len(prompts)        # warm ones + the dup
    assert warm_eng.pool.stats["cow_copies"] == 1
    assert warm_eng.prefill_tokens == len(prompts[0]) + sum(
        len(p) - 256 for p in prompts[1:]) + 1
    assert warm_eng.pool.check_balance()


def _pool(layers=2, hkv=16, d=128):
    from paddle_tpu_torch.serving.llm import SlotPagedKVPool
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def init_cache(b, max_len):
        return [tuple(torch.randn((b, hkv, max_len, d), generator=gen,
                                  device="cuda").to(torch.bfloat16)
                      for _ in range(2)) for _ in range(layers)]

    return SlotPagedKVPool(init_cache, 8, 8, 64, pad_tokens=64)


def _u16(t):
    return t.view(torch.int16)


@pytest.mark.cuda
def test_cuda_cow_copy_is_bit_exact():
    require_cuda()
    p = _pool()
    src = p.allocate(512)
    dst = p.allocate(512)
    before = [(k.clone(), v.clone()) for k, v in p.slabs]
    p.cow_copy(src * 64 + 40, dst)                 # block 40 of row src
    torch.cuda.synchronize()
    for (k, v), (k0, v0) in zip(p.slabs, before):
        for t, t0 in ((k, k0), (v, v0)):
            assert torch.equal(_u16(t[dst, :, 320:328]),
                               _u16(t0[src, :, 320:328]))
            t0[dst, :, 320:328] = t0[src, :, 320:328]
            assert torch.equal(_u16(t), _u16(t0))  # nothing else moved
    assert p.stats["cow_copies"] == 1


@pytest.mark.cuda
def test_cuda_export_import_page_round_trip_bf16():
    require_cuda()
    p = _pool()
    a = p.allocate(512)
    b = p.allocate(512)
    layers = p.export_page(a * 64 + 7)
    assert all(k.device.type == "cpu" and k.dtype == torch.bfloat16
               and tuple(k.shape) == (16, 8, 128) for k, _ in layers)
    p.import_page(b, 3, layers)
    torch.cuda.synchronize()
    for k, v in p.slabs:
        assert torch.equal(_u16(k[b, :, 24:32]), _u16(k[a, :, 56:64]))
        assert torch.equal(_u16(v[b, :, 24:32]), _u16(v[a, :, 56:64]))
    rows = p.export_rows([a])
    assert rows["rows"][a]["length"] == 0
    p.set_length(a, 100)
    rows = p.export_rows([a])
    got = p.import_rows(rows)
    for k, _ in p.slabs:
        assert torch.equal(_u16(k[got[a], :, :100]), _u16(k[a, :, :100]))


@pytest.mark.cuda
def test_cuda_defrag_leaves_cached_pages_bit_intact():
    require_cuda()
    p = _pool()
    s = p.allocate(512)
    p.set_length(s, 40)                            # pages 0..4
    p.register_cached(s * 64 + 1)
    p.register_cached(s * 64 + 3)
    kept = [(k[s, :, 8:16].clone(), k[s, :, 24:32].clone())
            for k, _ in p.slabs]
    other = [(k[1].clone(), v[1].clone()) for k, v in p.slabs]
    p.free(s)
    assert p.defrag() == 62
    for (k, v), (c1, c3), (k1, v1) in zip(p.slabs, kept, other):
        assert torch.equal(_u16(k[s, :, 8:16]), _u16(c1))
        assert torch.equal(_u16(k[s, :, 24:32]), _u16(c3))
        assert not k[s, :, :8].any() and not k[s, :, 32:].any()
        assert torch.equal(_u16(k[1]), _u16(k1))   # a live row: untouched
    p.release_cached(s * 64 + 1)
    p.release_cached(s * 64 + 3)
    assert p.check_balance()


# After the shared-prefix burst, free rows hold cached pages; another burst
# runs its steps with those rows free (their stripes at pos = capacity, in
# the pad): every cached page keeps its bits.
@pytest.mark.cuda
def test_cuda_free_pinned_rows_never_touch_cached_columns():
    require_cuda()
    model = _model()
    eng = _engine(model)
    _run(eng, _prompts(3))
    free_rows = [r for r in range(8) if not eng.pool.active[r]
                 and eng.pool._row_pinned(r)]
    assert len(free_rows) >= 2
    bl, nb = eng.pool.block_len, eng.pool.n_blocks

    def cached_bits():
        return {pg: [(_u16(k[pg // nb, :, (pg % nb) * bl:(pg % nb + 1) * bl])
                      .clone(),
                      _u16(v[pg // nb, :, (pg % nb) * bl:(pg % nb + 1) * bl])
                      .clone()) for k, v in eng.pool.slabs]
                for pg in sorted(eng.pool.cached)}

    before = cached_bits()
    rng = np.random.RandomState(5)
    hs = [eng.submit(rng.randint(0, VOCAB, (n,)).astype(np.int32))
          for n in (300, 70)]
    _drain(eng)
    assert all(len(h.result(0)) == ENGINE["max_new_tokens"] for h in hs)
    after = cached_bits()
    kept = [pg for pg in before if pg in after]
    assert len(kept) >= 32                          # the shared prefix
    for pg in kept:
        for (k0, v0), (k1, v1) in zip(before[pg], after[pg]):
            assert torch.equal(k0, k1) and torch.equal(v0, v1), pg
    assert eng.pool.check_balance()
