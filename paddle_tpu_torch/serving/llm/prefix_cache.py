"""Radix prefix cache over shared KV blocks (counterpart of
paddle_tpu/serving/llm/prefix_cache.py).

A per-tenant radix index over token prefixes, one level per full
`block_len`-token chunk, each node naming the KV page that holds that
chunk's keys and values. On admission the engine looks the prompt up:
every matched full block is ATTACHED (the new slot's block table points
at the donor's pages, refcounted for the reader's lifetime) and a matched
partial block — a trie tail, or a full block cut by the
always-prefill-one-token cap — is copied-on-write into the slot's own
page. The engine then prefills only the uncovered suffix.

Correctness lever: chunked prefill equals whole-prompt prefill bit for
bit, and a row's KV depends only on its own tokens and positions, so KV
attached from a donor row (or copied out of one) is the KV the request
would have computed itself: warm streams equal cold ones.

Lifecycle: pages enter the cache only when their prefill completed and
are pinned with `register_cached`; readers hold a refcount per attached
page until their slot frees, and `release_cached` refuses such pages, so
eviction can never reclaim a page a stream reads. Eviction is LRU over
refcount-0 leaves and tails (a monotonic tick, no wall clock), driven by
the pool's `on_pressure` hook inside `allocate()`; with a host tier it
spills each evicted full block there first. Each tenant has its own
root, so tenants never share KV.

Host-side bookkeeping only: dict hops per block, no device work except
the spill's page export.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .kv_pool import SlotPagedKVPool


class _Node:
    """One radix node = one full cached block. `children` is keyed by the
    next block's token tuple; `page` holds THIS node's block (None only at
    roots). A node may carry one cached partial-block `tail`, usable by
    COW up to its longest common prefix with a new prompt's remainder."""

    __slots__ = ("children", "page", "tick",
                 "tail_tokens", "tail_page", "tail_tick")

    def __init__(self, page: Optional[int] = None):
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.page = page
        self.tick = 0
        self.tail_tokens: Optional[Tuple[int, ...]] = None
        self.tail_page: Optional[int] = None
        self.tail_tick = 0


class AttachPlan:
    """Result of a lookup, refcounts already taken.

    `pages` back the prompt's leading full blocks; `tail_page` holds
    `tail_len` further tokens to COW into the slot's own page (its
    refcount is transient: `PrefixCache.release_tail` after the copy).
    `attach_len = len(pages) * block_len + tail_len` is the number of
    prompt tokens the engine may skip prefilling."""

    __slots__ = ("pages", "attach_len", "tail_page", "tail_len")

    def __init__(self, pages: List[int], attach_len: int,
                 tail_page: Optional[int], tail_len: int):
        self.pages = pages
        self.attach_len = attach_len
        self.tail_page = tail_page
        self.tail_len = tail_len


def _tenant_stats() -> dict:
    return {"hits": 0, "misses": 0, "hit_tokens": 0, "lookup_tokens": 0,
            "insertions": 0, "evictions": 0, "cached_blocks": 0}


class PrefixCache:
    """Per-tenant radix index over cached KV pages of a SlotPagedKVPool.

    Constructing the cache wires it as the pool's `on_pressure` hook.
    `host_pool` (a HostKVPool) receives every evicted full block;
    `clock` (a callable returning seconds) times those spills into
    `spill_seconds`."""

    def __init__(self, pool: SlotPagedKVPool, name: str = "target",
                 host_pool=None, clock=None):
        self.pool = pool
        self.name = name
        self.block_len = pool.block_len
        self._roots: Dict[str, _Node] = {}
        self._tick = 0
        self.stats = _tenant_stats()
        self.tenant_stats: Dict[str, dict] = {}
        self.host_pool = host_pool
        self.clock = clock
        self.spill_seconds = 0.0
        self.spilled_pages = 0
        pool.on_pressure = self.evict_for_pressure

    def _ts(self, tenant: str) -> dict:
        return self.tenant_stats.setdefault(tenant, _tenant_stats())

    # ---- lookup ----
    def acquire(self, tenant: str, tokens, max_tokens: int) -> AttachPlan:
        """Match `tokens` against the tenant's trie and take refcounts on
        every matched page. `max_tokens` caps the covered length (the
        engine passes len(prompt)-1, so one prompt token always prefills);
        a full matched block pushed over the cap becomes a partially used
        COW tail, so an exact duplicate costs a one-token prefill."""
        self._tick += 1
        ts = self._ts(tenant)
        n = len(tokens)
        ts["lookup_tokens"] += n
        self.stats["lookup_tokens"] += n
        bl = self.block_len
        node = self._roots.get(tenant)
        chain: List[int] = []
        i = 0
        if node is not None:
            while i + bl <= n:
                child = node.children.get(
                    tuple(int(t) for t in tokens[i:i + bl]))
                if child is None:
                    break
                child.tick = self._tick
                chain.append(child.page)
                node = child
                i += bl
        n_full = min(len(chain), max(0, int(max_tokens)) // bl)
        pages = chain[:n_full]
        attach_len = n_full * bl
        tail_page: Optional[int] = None
        tail_len = 0
        if n_full < len(chain):
            # the next matched block exists but the cap truncates it
            u = int(max_tokens) - attach_len
            if u > 0:
                tail_page = chain[n_full]
                tail_len = u
        elif node is not None and node.tail_tokens is not None:
            rem = [int(t) for t in tokens[attach_len:]]
            m = 0
            for a, b in zip(node.tail_tokens, rem):
                if a != b:
                    break
                m += 1
            u = min(m, int(max_tokens) - attach_len)
            if u > 0:
                tail_page = node.tail_page
                tail_len = u
                node.tail_tick = self._tick
        hit_tokens = attach_len + tail_len
        if hit_tokens > 0:
            ts["hits"] += 1
            self.stats["hits"] += 1
            ts["hit_tokens"] += hit_tokens
            self.stats["hit_tokens"] += hit_tokens
        else:
            ts["misses"] += 1
            self.stats["misses"] += 1
        for p in pages:
            self.pool.refcount[p] = self.pool.refcount.get(p, 0) + 1
        if tail_page is not None:
            self.pool.refcount[tail_page] = \
                self.pool.refcount.get(tail_page, 0) + 1
        return AttachPlan(pages, attach_len + tail_len, tail_page, tail_len)

    def probe(self, tenant: str, tokens) -> int:
        """Read-only lookup: the longest block-aligned cached prefix of
        `tokens` in the tenant's trie, in tokens. No refcounts, ticks or
        stats move."""
        node = self._roots.get(tenant)
        if node is None:
            return 0
        bl = self.block_len
        n = len(tokens)
        i = 0
        while i + bl <= n:
            child = node.children.get(
                tuple(int(t) for t in tokens[i:i + bl]))
            if child is None:
                break
            node = child
            i += bl
        return i

    def release_tail(self, plan: AttachPlan):
        """Drop the transient tail refcount once its KV was copied."""
        if plan.tail_page is not None:
            self.pool.release_block(plan.tail_page)
            plan.tail_page = None

    def release(self, plan: AttachPlan):
        """Drop ALL of acquire()'s transient refcounts, once the reader
        holds its own (attach_blocks) and its tail copy. Idempotent."""
        for p in plan.pages:
            self.pool.release_block(p)
        plan.pages = []
        self.release_tail(plan)

    # ---- insertion ----
    def insert(self, tenant: str, tokens, slot: int,
               attached_pages: List[int]):
        """Index a completed prefill while its slot is still active. Path
        nodes the prompt attached from already exist; every NEW node
        claims the slot's own page for its block and pins it. The
        sub-block remainder becomes the last node's tail, replacing a
        shorter refcount-0 tail only."""
        self._tick += 1
        ts = self._ts(tenant)
        bl = self.block_len
        nb_pool = self.pool.n_blocks
        node = self._roots.setdefault(tenant, _Node())
        n_full = len(tokens) // bl
        for j in range(n_full):
            key = tuple(int(t) for t in tokens[j * bl:(j + 1) * bl])
            child = node.children.get(key)
            if child is None:
                page = (attached_pages[j] if j < len(attached_pages)
                        else slot * nb_pool + j)
                if page in self.pool.cached:
                    # never double-register (an attached page is only
                    # reachable through an existing node)
                    node = node.children.setdefault(key, _Node(page))
                    continue
                self.pool.register_cached(page)
                child = _Node(page)
                node.children[key] = child
                ts["insertions"] += 1
                self.stats["insertions"] += 1
                ts["cached_blocks"] += 1
                self.stats["cached_blocks"] += 1
            child.tick = self._tick
            node = child
        rem = tuple(int(t) for t in tokens[n_full * bl:])
        if rem:
            if node.tail_tokens is None or (
                    len(rem) > len(node.tail_tokens)
                    and self.pool.refcount.get(node.tail_page, 0) == 0):
                page = slot * nb_pool + n_full
                if page in self.pool.cached or page == node.tail_page:
                    return
                if node.tail_page is not None:
                    self.pool.release_cached(node.tail_page)
                    ts["cached_blocks"] -= 1
                    self.stats["cached_blocks"] -= 1
                self.pool.register_cached(page)
                node.tail_tokens = rem
                node.tail_page = page
                node.tail_tick = self._tick
                ts["insertions"] += 1
                self.stats["insertions"] += 1
                ts["cached_blocks"] += 1
                self.stats["cached_blocks"] += 1

    # ---- eviction ----
    def _lru_victim(self):
        """Least recently touched evictable entry across all tenants:
        refcount-0 tails, and refcount-0 leaf nodes (no children and no
        tail). The walk pops a stack over insertion-ordered dicts, as the
        JAX cache does, so ties fall to the same victim. Each candidate
        carries the victim block's full token path, the host tier's
        key."""
        best = None   # (tick, kind, tenant, node_or_parent, key, path)
        for tenant, root in self._roots.items():
            stack: List[Tuple[_Node, Optional[_Node],
                              Optional[Tuple[int, ...]],
                              Tuple[int, ...]]] = \
                [(root, None, None, ())]
            while stack:
                node, parent, key, path = stack.pop()
                if (node.tail_page is not None
                        and self.pool.refcount.get(node.tail_page, 0) == 0):
                    cand = (node.tail_tick, "tail", tenant, node, None, path)
                    if best is None or cand[0] < best[0]:
                        best = cand
                if (parent is not None and not node.children
                        and node.tail_page is None
                        and self.pool.refcount.get(node.page, 0) == 0):
                    cand = (node.tick, "node", tenant, parent, key, path)
                    if best is None or cand[0] < best[0]:
                        best = cand
                for k, c in node.children.items():
                    stack.append((c, node, k, path + k))
        return best

    def evict_for_pressure(self) -> int:
        """Pool pressure hook: evict LRU refcount-0 entries until the pool
        has an allocatable row or nothing evictable remains; a full block
        goes to the host tier first when there is one. Returns pages
        released."""
        released = 0
        while not self.pool.has_allocatable_row():
            victim = self._lru_victim()
            if victim is None:
                break
            _, kind, tenant, holder, key, path = victim
            ts = self._ts(tenant)
            if kind == "tail":
                self.pool.release_cached(holder.tail_page)
                holder.tail_tokens = None
                holder.tail_page = None
                holder.tail_tick = 0
            else:
                child = holder.children.pop(key)
                if self.host_pool is not None:
                    # refcount 0: the page is quiescent, and the export
                    # is the exact KV the trie indexed
                    t0 = self.clock() if self.clock is not None else None
                    self.host_pool.put(
                        tenant, path, self.pool.export_page(child.page))
                    self.spilled_pages += 1
                    if t0 is not None:
                        self.spill_seconds += self.clock() - t0
                self.pool.release_cached(child.page)
            ts["evictions"] += 1
            self.stats["evictions"] += 1
            ts["cached_blocks"] -= 1
            self.stats["cached_blocks"] -= 1
            released += 1
        return released

    def clear(self, only=None) -> int:
        """Release cached pages and drop their trie(s), keeping the pool
        ledger balanced (the caller holds the engine idle). `only` is an
        optional namespace predicate; None drops everything, the host
        tier's pages included. Returns pages released."""
        released = 0
        victims = [t for t in self._roots
                   if only is None or only(t)]
        for tenant in victims:
            root = self._roots[tenant]
            ts = self._ts(tenant)
            stack: List[Tuple[_Node, bool]] = [(root, True)]
            while stack:
                node, is_root = stack.pop()
                if node.tail_page is not None:
                    self.pool.release_cached(node.tail_page)
                    node.tail_tokens = None
                    node.tail_page = None
                    released += 1
                    ts["evictions"] += 1
                    self.stats["evictions"] += 1
                if not is_root and node.page is not None:
                    self.pool.release_cached(node.page)
                    released += 1
                    ts["evictions"] += 1
                    self.stats["evictions"] += 1
                for c in node.children.values():
                    stack.append((c, False))
            self.stats["cached_blocks"] -= ts["cached_blocks"]
            ts["cached_blocks"] = 0
            del self._roots[tenant]
        if only is None:
            self._roots.clear()
            self.stats["cached_blocks"] = 0
        if self.host_pool is not None:
            self.host_pool.clear(only=only)
        return released

    # ---- views ----
    def cached_blocks(self, tenant: Optional[str] = None) -> int:
        if tenant is None:
            return self.stats["cached_blocks"]
        return self._ts(tenant)["cached_blocks"]

    def hit_rate(self, tenant: Optional[str] = None) -> float:
        s = self.stats if tenant is None else self._ts(tenant)
        if s["lookup_tokens"] == 0:
            return 0.0
        return s["hit_tokens"] / s["lookup_tokens"]

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            **self.stats,
            "hit_rate": self.hit_rate(),
            "tenants": {t: {**s, "hit_rate":
                            (s["hit_tokens"] / s["lookup_tokens"]
                             if s["lookup_tokens"] else 0.0)}
                        for t, s in self.tenant_stats.items()},
        }
