"""The port's shared block pool, radix prefix cache and tenant-aware
admission against the JAX package, on the CPU.

- `serving/llm/kv_pool.py`: the pool units of tests/test_prefix_cache.py
  (attach, refcounts and the block ledger; COW of one block; refcount-aware
  defrag; `allocate` skipping pinned rows and calling the pressure hook),
  plus `rewind_length` and the export/import round trips, each run on the
  JAX pool and the port's with a fake cache function: the same ledgers,
  refcounts, tables and slab bits after every step;
- `serving/llm/prefix_cache.py`: lookup, insert, the tail rule, tenant
  namespacing, LRU eviction order (ties included) and `clear(only=)` on
  both caches: the same plans, stats and evicted pages;
- the engine, with its cache on in both packages (SimClock, gpt2-tiny and
  a grouped-query llama2-tiny): shared prefixes cost one prefill, an exact
  duplicate prefills one token with one COW, eviction under pressure
  never reclaims a page with live readers, tenants never share KV, the
  tenant quota rejects typed and dequeue is tenant-fair. Every scenario
  holds the two engines to equal streams (logprobs within 1e-4), prefill
  tokens, prefix metrics, pool stats, trie stats and evicted pages, and
  both ledgers to `check_balance()`;
- free rows pinned by cached pages: a burst's discarded stripes land in
  the pad, and the cached pages stay bit-unchanged.
"""
import numpy as np
import pytest
import torch

from _torch_port import (assert_engines_equal, drain, engine_pair,
                         record_evictions, tiny_models)

CFG = dict(num_slots=4, block_len=8, n_blocks=6, prefill_chunk=16)


# ---- both pools, a fake cache function ----

def _pools(num_slots=4, block_len=4, n_blocks=2, pad=0):
    """(JAX pool, port pool) over one fp32 layer of [slots, 2, L, 3]."""
    import jax.numpy as jnp
    from paddle_tpu.serving.llm import SlotPagedKVPool as JaxPool
    from paddle_tpu_torch.serving.llm import SlotPagedKVPool

    def jax_init(b, max_len):
        return [(jnp.zeros((b, 2, max_len, 3), jnp.float32),
                 jnp.zeros((b, 2, max_len, 3), jnp.float32))]

    def port_init(b, max_len):
        return [(torch.zeros((b, 2, max_len, 3)),
                 torch.zeros((b, 2, max_len, 3)))]

    return (JaxPool(jax_init, num_slots, block_len, n_blocks,
                    pad_tokens=pad),
            SlotPagedKVPool(port_init, num_slots, block_len, n_blocks,
                            pad_tokens=pad))


def _fill(pool, slot, c0, c1, kval, vval):
    k, v = pool.slabs[0]
    if isinstance(k, torch.Tensor):
        k[slot, :, c0:c1] = torch.as_tensor(kval)
        v[slot, :, c0:c1] = torch.as_tensor(vval)
    else:
        pool.slabs[0] = (k.at[slot, :, c0:c1].set(kval),
                         v.at[slot, :, c0:c1].set(vval))


def _bits(pool):
    return [(np.asarray(k).view(np.int32).copy(),
             np.asarray(v).view(np.int32).copy()) for k, v in pool.slabs]


def _state(pool):
    return dict(stats=dict(pool.stats), refcount=dict(pool.refcount),
                cached=sorted(pool.cached),
                cache_owned=sorted(pool._cache_owned),
                table={s: list(b) for s, b in pool.block_table.items()},
                host_table=pool._host_table.tolist(),
                lengths=pool.lengths.tolist(), dirty=pool.dirty.tolist(),
                snapshot=pool.snapshot())


def _run_both(scenario, **kw):
    """Run `scenario(pool)` -> list of checkpoints on both pools; the
    checkpoints (states and slab bits) must be equal."""
    jp, tp = _pools(**kw)
    ja, ta = scenario(jp), scenario(tp)
    assert len(ja) == len(ta)
    for i, (a, b) in enumerate(zip(ja, ta)):
        if isinstance(a, list):          # slab bits
            for (ak, av), (bk, bv) in zip(a, b):
                np.testing.assert_array_equal(bk, ak, err_msg=str(i))
                np.testing.assert_array_equal(bv, av, err_msg=str(i))
        else:
            assert b == a, (i, a, b)
    return jp, tp


def test_attach_refcount_and_block_ledger():
    def scenario(p):
        out = []
        s0 = p.allocate(8)
        p.set_length(s0, 8)               # claims 2 own pages
        assert p.stats["blocks_allocated"] == 2 and p.blocks_active() == 2
        p.register_cached(0)
        p.register_cached(1)
        p.free(s0)                        # ownership passes to the cache
        assert p.blocks_cached() == 2 and p.stats["blocks_freed"] == 0
        assert p.check_balance()
        out.append(_state(p))
        s1 = p.allocate(8)
        assert s1 == 1                    # row 0 is pinned
        p.attach_blocks(s1, [0, 1])
        assert p.refcount == {0: 1, 1: 1}
        p.set_length(s1, 8)               # covered by attached pages
        assert p.stats["blocks_allocated"] == 2
        assert p.block_table[s1] == [0, 1]
        out.append(_state(p))
        with pytest.raises(ValueError, match="live reader"):
            p.release_cached(0)
        p.free(s1)
        assert p.refcount == {}
        p.release_cached(0)
        p.release_cached(1)
        assert p.stats["blocks_freed"] == 2 and p.blocks_cached() == 0
        assert p.check_balance()
        out.append(_state(p))
        s2 = p.allocate(4)
        with pytest.raises(ValueError, match="not cache-registered"):
            p.attach_blocks(s2, [0])
        with pytest.raises(ValueError, match="block offset"):
            p.register_cached(5)
            p.attach_blocks(s2, [5])
        out.append(_state(p))
        return out

    _run_both(scenario)


def test_cow_copy_moves_one_block_between_rows():
    rng = np.random.RandomState(0)
    kval = rng.standard_normal((2, 4, 3)).astype(np.float32)
    vval = rng.standard_normal((2, 4, 3)).astype(np.float32)

    def scenario(p):
        s0 = p.allocate(8)
        _fill(p, s0, 4, 8, kval, vval)    # slot 0's second block
        s1 = p.allocate(4)
        p.cow_copy(s0 * 2 + 1, s1)        # page 1 = slot 0, block 1
        k, v = (np.asarray(t) for t in p.slabs[0])
        np.testing.assert_array_equal(k[s1, :, 4:8], kval)
        np.testing.assert_array_equal(v[s1, :, 4:8], vval)
        assert not np.abs(k[s1, :, :4]).any()         # only that block
        p.cow_copy(s1 * 2 + 1, s1)        # its own row: no copy
        assert p.stats["cow_copies"] == 1
        return [_bits(p), _state(p)]

    _run_both(scenario, num_slots=2)


def test_defrag_is_refcount_aware_at_page_granularity():
    """Negative entries scrub to -0.0 in both pools (a masked multiply),
    so the slabs stay bit-equal; the cached page keeps its bits."""
    rng = np.random.RandomState(1)
    row = rng.standard_normal((2, 10, 3)).astype(np.float32)

    def scenario(p):
        s = p.allocate(8)
        _fill(p, s, 0, 10, row, -row)
        p.set_length(s, 8)
        p.register_cached(s * 2)          # pin the FIRST page only
        p.free(s)
        assert p.dirty_blocks() == 1
        assert p.defrag() == 1
        k = np.asarray(p.slabs[0][0])
        np.testing.assert_array_equal(k[s, :, :4], row[:, :4])
        assert not k[s, :, 4:].any()      # scrubbed, pad included
        assert np.signbit(k[s, :, 4:]).any()           # -0.0 survives
        out = [_bits(p), _state(p)]
        p.release_cached(s * 2)           # unpinned: scrubbable again
        assert p.dirty_blocks() == 2
        assert p.defrag() == 2
        assert p.defrag() == 0
        assert p.check_balance()
        return out + [_bits(p), _state(p)]

    _run_both(scenario, num_slots=2, pad=2)


def test_allocate_skips_pinned_rows_and_calls_pressure_hook():
    from paddle_tpu.serving.llm import SlotsExhaustedError as JaxExhausted
    from paddle_tpu_torch.serving.llm import SlotsExhaustedError

    def scenario(p):
        s = p.allocate(4)
        p.set_length(s, 4)
        p.register_cached(0)
        p.free(s)
        with pytest.raises((SlotsExhaustedError, JaxExhausted),
                           match="pinned"):
            p.allocate(4)                 # the only row is pinned, no hook
        calls = []

        def pressure():
            calls.append(1)
            p.release_cached(0)
            return 1

        p.on_pressure = pressure
        assert p.allocate(4) == 0         # the hook evicted: reusable
        assert calls == [1]
        assert p.check_balance()
        p.on_pressure = None
        return [_state(p)]

    _run_both(scenario, num_slots=1)


def test_rewind_length_returns_pages_down_to_a_cached_one():
    def scenario(p):
        out = []
        s = p.allocate(16)
        p.set_length(s, 16)               # 4 own pages
        p.register_cached(s * 4 + 1)      # block 1 pinned
        p.rewind_length(s, 5)             # blocks 2, 3 back; 1 stays
        out.append(_state(p))
        p.rewind_length(s, 1)             # stops at the cached page
        out.append(_state(p))
        with pytest.raises(ValueError, match="only shrink"):
            p.rewind_length(s, 9)
        p.set_length(s, 12)
        p.free(s)
        p.release_cached(s * 4 + 1)
        assert p.check_balance()
        out.append(_state(p))
        return out

    _run_both(scenario, num_slots=2, n_blocks=4)


def test_export_import_round_trips():
    """Page and row export are the JAX pool's values; within the port the
    round trips are bit-exact, through attached pages too."""
    rng = np.random.RandomState(2)
    data = rng.standard_normal((2, 2, 16, 3)).astype(np.float32)

    def scenario(p):
        s0 = p.allocate(16)
        _fill(p, s0, 0, 16, data[0], data[1])
        p.set_length(s0, 12)
        p.register_cached(0)
        p.register_cached(1)
        s1 = p.allocate(16)
        p.attach_blocks(s1, [0, 1])
        _fill(p, s1, 8, 16, data[1, :, :8], data[0, :, :8])
        p.set_length(s1, 14)
        page = p.export_page(1, width=3)
        rows = p.export_rows([s1])
        s2 = p.allocate(16)
        p.import_page(s2, 2, p.export_page(4 * s1 + 2))
        got = p.import_rows(rows)
        s3 = got[s1]
        assert int(p.lengths[s3]) == 14 and p.block_table[s3] == [
            4 * s3 + j for j in range(4)]
        k, v = (np.asarray(t) for t in p.slabs[0])
        np.testing.assert_array_equal(k[s3, :, :14],
                                      np.asarray(rows["rows"][s1]
                                                 ["layers"][0][0]))
        np.testing.assert_array_equal(k[s2, :, 8:12], k[s1, :, 8:12])
        with pytest.raises(ValueError, match="width"):
            p.export_page(0, width=5)
        return [_bits(p), _state(p),
                [(np.asarray(a), np.asarray(b)) for a, b in page],
                [(np.asarray(a), np.asarray(b))
                 for a, b in rows["rows"][s1]["layers"]]]

    _, tp = _run_both(scenario, num_slots=4, n_blocks=4)
    # within the port: export -> import of a page is bit-exact
    layers = tp.export_page(4 * 0 + 1)
    assert all(isinstance(k, torch.Tensor) and k.device.type == "cpu"
               and k.dtype == torch.float32 for k, _ in layers)
    s = tp.free_slots() and int(np.flatnonzero(~tp.active)[0])
    tp.import_page(s, 1, layers)
    np.testing.assert_array_equal(tp.slabs[0][0][s, :, 4:8].numpy(),
                                  tp.slabs[0][0][0, :, 4:8].numpy())


def test_device_block_table_is_version_gated():
    """Cold traffic uploads the table once; an attach uploads it again,
    with the shared page in the reader's row."""
    _, p = _pools(num_slots=2, n_blocks=3)
    t0 = p.device_block_table()
    np.testing.assert_array_equal(t0.numpy(), [[0, 1, 2], [3, 4, 5]])
    s = p.allocate(8)
    p.set_length(s, 8)
    assert p.device_block_table() is t0          # identity row: no upload
    p.register_cached(0)
    p.free(s)
    s1 = p.allocate(8)
    assert s1 == 1 and p.device_block_table() is t0
    p.attach_blocks(s1, [0])
    t1 = p.device_block_table()
    assert t1 is not t0 and p.device_block_table() is t1
    np.testing.assert_array_equal(t1.numpy(), [[0, 1, 2], [0, 4, 5]])


# ---- the radix index on both pools ----

def _caches(**kw):
    from paddle_tpu.serving.llm import PrefixCache as JaxCache
    from paddle_tpu_torch.serving.llm import PrefixCache
    jp, tp = _pools(**kw)
    return (JaxCache(jp), jp), (PrefixCache(tp), tp)


def _plan(plan):
    return (list(plan.pages), plan.attach_len, plan.tail_page,
            plan.tail_len)


def test_radix_lookup_insert_tail_and_tenant_namespacing():
    def scenario(cache, p):
        out = []
        s = p.allocate(10)
        toks = np.arange(100, 110, dtype=np.int32)  # 2 blocks + 2 tail
        p.set_length(s, 10)
        cache.insert("a", toks, s, [])
        assert cache.cached_blocks("a") == 3
        plan = cache.acquire("a", toks, max_tokens=9)
        assert plan.pages == [s * 4, s * 4 + 1]
        assert plan.tail_page == s * 4 + 2 and plan.tail_len == 1
        out.append(_plan(plan))
        cache.release_tail(plan)
        assert s * 4 + 2 not in p.refcount
        for pg in plan.pages:
            p.release_block(pg)
        other = np.concatenate([toks[:8], [1, 2, 3, 4]]).astype(np.int32)
        out.append(_plan(cache.acquire("a", other, max_tokens=11)))
        for pg in out[-1][0]:
            p.release_block(pg)
        # a full block pushed over the cap becomes a tail
        out.append(_plan(cache.acquire("a", toks[:8], max_tokens=7)))
        p.release_block(out[-1][2])
        # the tail rule: a longer remainder replaces a refcount-0 tail
        s2 = p.allocate(11)
        longer = np.concatenate([toks, [7]]).astype(np.int32)
        p.set_length(s2, 11)
        cache.insert("a", longer, s2, [s * 4, s * 4 + 1])
        out.append(_plan(cache.acquire("a", longer, max_tokens=11)))
        plan3 = cache.acquire("b", toks, max_tokens=9)
        assert plan3.attach_len == 0 and not plan3.pages
        assert cache.hit_rate("b") == 0.0 and cache.hit_rate("a") > 0.0
        assert cache.probe("a", toks) == 8 and cache.probe("b", toks) == 0
        out.append(cache.snapshot())
        out.append(_state(p))
        return out

    (jc, jp), (tc, tp) = _caches(num_slots=4, block_len=4, n_blocks=4)
    assert scenario(tc, tp) == scenario(jc, jp)


def test_lru_eviction_order_and_clear():
    """Three chains and a tail in two tenants, all rows pinned: pressure
    evicts in the same order in both caches, ties (nodes touched by one
    acquire or insert) included; then clear(only=) drops one tenant."""
    def scenario(cache, p):
        evicted = record_evictions(p)
        rng = np.random.RandomState(3)
        prompts = [rng.randint(0, 50, (n,)).astype(np.int32)
                   for n in (12, 9, 8)]
        for i, (tenant, pr) in enumerate(zip("aab", prompts)):
            s = p.allocate(len(pr))
            p.set_length(s, len(pr))
            cache.insert(tenant, pr, s, [])
            p.free(s)
        plan = cache.acquire("a", prompts[0], max_tokens=11)
        cache.release(plan)
        s = p.allocate(8)                   # pressure: rows all pinned
        out = [list(evicted), cache.snapshot()]
        p.set_length(s, 8)
        p.free(s)
        released = cache.clear(only=lambda t: t == "a")
        out += [released, list(evicted), cache.snapshot(), _state(p)]
        assert p.check_balance()
        return out

    (jc, jp), (tc, tp) = _caches(num_slots=3, block_len=4, n_blocks=3)
    assert scenario(tc, tp) == scenario(jc, jp)


# ---- the engines, cache on in both ----

def _prompts_shared(seed, n, prefix_len, suffix_len):
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 500, size=prefix_len).astype(np.int32)
    return [np.concatenate([shared, rng.randint(
        1, 500, size=suffix_len).astype(np.int32)]) for _ in range(n)]


@pytest.mark.parametrize("preset,over", [("gpt2-tiny", {}),
                                         ("llama2-tiny",
                                          {"num_key_value_heads": 2})])
def test_shared_prefix_requests_cost_one_prefill(preset, over):
    """8 requests sharing a 32-token prefix with unique 8-token suffixes:
    the donor prefills 40 tokens, each later one its 8-token suffix, 40 +
    7 x 8 in all, with streams equal to the JAX engine's and to the
    port's own generate()."""
    from paddle_tpu_torch.models.generation import generate
    jm, tm = tiny_models(preset, **over)
    prompts = _prompts_shared(7, 8, 32, 8)
    je, te = engine_pair(jm, tm, CFG)
    jh, th = [je.submit(prompts[0], max_new_tokens=4, logprobs=True)], \
        [te.submit(prompts[0], max_new_tokens=4, logprobs=True)]
    drain(je)
    drain(te)
    assert te.prefill_tokens == 40
    jh += [je.submit(p, max_new_tokens=4, logprobs=True)
           for p in prompts[1:]]
    th += [te.submit(p, max_new_tokens=4, logprobs=True)
           for p in prompts[1:]]
    drain(je)
    drain(te)
    assert te.prefill_tokens == 40 + 7 * 8
    assert_engines_equal(je, te, jh, th)
    snap = te.metrics.snapshot()
    assert snap["prefix_hits"] == 7 and snap["prefix_misses"] == 1
    assert snap["prefix_hit_tokens"] == 7 * 32
    assert snap["cached_blocks"] >= 5
    ref = generate(tm, np.stack(prompts), max_new_tokens=4).numpy()[:, 40:]
    for h, r in zip(th, ref):
        np.testing.assert_array_equal(h.result(0), r)


def test_exact_duplicate_prefills_one_token_with_one_cow():
    jm, tm = tiny_models()
    prompt = np.random.RandomState(11).randint(1, 500, size=40).astype(
        np.int32)
    je, te = engine_pair(jm, tm, CFG)
    jh, th = [], []
    for _ in range(2):
        jh.append(je.submit(prompt, max_new_tokens=4, logprobs=True))
        th.append(te.submit(prompt, max_new_tokens=4, logprobs=True))
        drain(je)
        drain(te)
    assert te.prefill_tokens == 40 + 1
    assert te.pool.stats["cow_copies"] == 1
    np.testing.assert_array_equal(th[1].result(0), th[0].result(0))
    assert_engines_equal(je, te, jh, th)


def test_eviction_under_pressure_never_reclaims_live_readers():
    jm, tm = tiny_models()
    rng = np.random.RandomState(5)
    pA = rng.randint(1, 500, size=16).astype(np.int32)     # 2 blocks
    pC = rng.randint(1, 500, size=16).astype(np.int32)
    je, te = engine_pair(jm, tm, CFG, num_slots=2, n_blocks=4)
    handles = ([], [])
    for eng, hs in zip((je, te), handles):
        hs.append(eng.submit(pA, max_new_tokens=2))    # donor
        drain(eng)
        hs.append(eng.submit(pA, max_new_tokens=8))    # attaches block 0
        eng.pump()
        with eng._cond:
            (_, req), = eng._active.items()
            shared = list(req.attached_pages)
        assert len(shared) == 1 and eng.pool.refcount[shared[0]] == 1
        hs.append(eng.submit(pC, max_new_tokens=2))    # pressure
        eng.pump()
        assert shared[0] in eng.pool.cached            # live reader: kept
        assert eng.pool.refcount.get(shared[0]) == 1
        drain(eng)
        assert eng.prefix_cache.stats["evictions"] >= 1
        assert eng.pool.active_slots() == 0
    from paddle_tpu_torch.models.generation import generate
    ref = generate(tm, pA[None], max_new_tokens=8).numpy()[0, 16:]
    np.testing.assert_array_equal(handles[1][1].result(0), ref)
    assert_engines_equal(je, te, *handles)


def test_tenant_namespacing_isolates_kv():
    jm, tm = tiny_models()
    prompt = np.random.RandomState(9).randint(1, 500, size=16).astype(
        np.int32)
    je, te = engine_pair(jm, tm, CFG)
    handles = ([], [])
    for eng, hs in zip((je, te), handles):
        for tenant in ("acme", "bravo", "acme"):
            hs.append(eng.submit(prompt, max_new_tokens=3, tenant=tenant))
            drain(eng)
        assert eng.prefill_tokens == 2 * 16 + 1
        assert eng.prefix_cache.cached_blocks("acme") == 2
        assert eng.prefix_cache.cached_blocks("bravo") == 2
    snap = te.metrics.snapshot()
    assert snap["tenants"]["bravo"]["prefix_misses"] == 1
    assert snap["tenants"]["bravo"]["prefix_hit_tokens"] == 0
    assert snap["tenants"]["acme"]["prefix_hits"] == 1
    np.testing.assert_array_equal(handles[1][1].result(0),
                                  handles[1][0].result(0))
    assert_engines_equal(je, te, *handles)


def test_tenant_quota_rejects_typed_and_dequeue_is_tenant_fair():
    from paddle_tpu.serving.engine import RejectedError as JaxRejected
    from paddle_tpu_torch.serving.engine import RejectedError
    jm, tm = tiny_models()
    je, te = engine_pair(jm, tm, CFG, num_slots=2, enable_prefix_cache=False,
                      tenant_max_inflight_tokens=50)
    handles = ([], [])
    orders = []
    for eng, hs, err in zip((je, te), handles, (JaxRejected, RejectedError)):
        rng = np.random.RandomState(17)
        mk = lambda: rng.randint(1, 500, size=8).astype(np.int32)  # noqa
        hs.append(eng.submit(mk(), max_new_tokens=2, tenant="a"))
        hs.append(eng.submit(mk(), max_new_tokens=8, tenant="a"))
        eng.pump()                                     # a1, a2 take both
        hs.append(eng.submit(mk(), max_new_tokens=6, tenant="a"))
        with pytest.raises(err) as ei:
            eng.submit(mk(), max_new_tokens=6, tenant="a")   # 54 > 50
        assert ei.value.reason == "tenant_quota"
        hs.append(eng.submit(mk(), max_new_tokens=6, tenant="b"))
        while not hs[0].future.done():
            eng.pump()
        eng.pump()                                     # a1's slot refills
        with eng._cond:
            active = sorted(r.tenant for r in eng._active.values())
            queued = [r.tenant for q in eng._queues.values() for r in q]
        orders.append((active, queued))
        drain(eng)
        assert eng.metrics.tenants["a"]["rejected"] == 1
        assert eng.metrics.reject_reasons == {"tenant_quota": 1}
    assert orders[0] == orders[1] == (["a", "b"], ["a"])
    assert_engines_equal(je, te, *handles)
    with pytest.raises(ValueError, match="tenant"):
        te.submit(np.arange(1, 5, dtype=np.int32), tenant="")


def test_free_pinned_rows_never_touch_cached_pages():
    """Two rows hold cached pages while free; a burst on the other rows
    runs many steps in which the free rows write their discarded stripes
    at pos = capacity. Every cached page keeps its bits, and a warm hit
    afterwards still equals the cold stream."""
    _, tm = tiny_models()
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    eng = LLMEngine(tm, LLMEngineConfig(**{**CFG, "n_blocks": 8}),
                    clock=SimClock())
    rng = np.random.RandomState(21)
    donors = [rng.randint(1, 500, size=n).astype(np.int32) for n in (29, 17)]
    cold = []
    for p in donors:
        cold.append(eng.submit(p, max_new_tokens=3))
        drain(eng)
    pinned = sorted(eng.pool.cached)
    rows = sorted({p // eng.pool.n_blocks for p in pinned})
    assert len(rows) == 2 and not eng.pool.active[rows].any()

    def page_bits():
        bl, nb = eng.pool.block_len, eng.pool.n_blocks
        return {p: [(k[p // nb, :, (p % nb) * bl:(p % nb + 1) * bl].clone(),
                     v[p // nb, :, (p % nb) * bl:(p % nb + 1) * bl].clone())
                    for k, v in eng.pool.slabs] for p in pinned}

    before = page_bits()
    burst = [eng.submit(rng.randint(1, 500, size=n).astype(np.int32),
                        max_new_tokens=6) for n in (45, 3)]
    drain(eng)
    assert all(h.future.done() for h in burst)
    after = page_bits()
    for p in pinned:
        for (k0, v0), (k1, v1) in zip(before[p], after[p]):
            assert torch.equal(k0.view(torch.int32), k1.view(torch.int32))
            assert torch.equal(v0.view(torch.int32), v1.view(torch.int32))
    warm = eng.submit(donors[0], max_new_tokens=3)
    drain(eng)
    np.testing.assert_array_equal(warm.result(0), cold[0].result(0))
    assert eng.pool.check_balance()


def test_config_checks_match_jax():
    from paddle_tpu.serving.llm import LLMEngineConfig as JaxConfig
    from paddle_tpu_torch.serving.llm import LLMEngineConfig
    for bad in (dict(default_tenant=""),
                dict(tenant_max_inflight_tokens=0),
                dict(host_kv_bytes=-1)):
        for cls in (JaxConfig, LLMEngineConfig):
            with pytest.raises(ValueError):
                cls(**bad)
    assert LLMEngineConfig().enable_prefix_cache is True
    assert JaxConfig().enable_prefix_cache is True
