"""Host-RAM KV spill tier (counterpart of paddle_tpu/serving/llm/host_kv.py).

Under slot pressure `PrefixCache.evict_for_pressure` releases exactly
the pages later traffic wants back. `HostKVPool` is the tier below the
device pool: a bounded, byte-budgeted LRU of owned host copies of
evicted full-block KV pages, namespaced per tenant, which a later
admission onboards instead of prefilling again.

Keying: a page's KV depends on every token before it, so a block is
addressed by its FULL token path from the prefix start,
``(tenant, (t0, ..., t_{(j+1)*block_len - 1}))`` — content-addressed as
the device trie is, and a block is onboardable only when all of its
predecessors are covered (the engine walks block by block). Only full
blocks spill; COW tails are dropped on eviction.

Values are per-layer ``(k, v)`` pairs shaped ``[kv_heads, block_len,
head_dim]``: CPU torch tensors in the slab dtype (numpy has no bfloat16),
the payload `SlotPagedKVPool.export_page` produces and `import_page`
lands back bit for bit. A page costs the same bytes as the JAX tier's
`.nbytes`, so the two budgets evict alike.

One lock around the OrderedDict keeps it safe should callers ever run
outside the engine lock.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

Layers = List[Tuple[torch.Tensor, torch.Tensor]]
_Key = Tuple[str, Tuple[int, ...]]


def _owned(t) -> torch.Tensor:
    """An owned contiguous CPU copy of a tensor or array, same dtype."""
    return torch.as_tensor(t, device="cpu").clone(
        memory_format=torch.contiguous_format)


class HostKVPool:
    """Bounded LRU of spilled KV pages, keyed ``(tenant, token_path)``."""

    def __init__(self, byte_budget: int, block_len: int):
        if byte_budget <= 0:
            raise ValueError(f"byte_budget must be > 0, got {byte_budget}")
        if block_len <= 0:
            raise ValueError(f"block_len must be > 0, got {block_len}")
        self.byte_budget = int(byte_budget)
        self.block_len = int(block_len)
        self._lock = threading.Lock()
        self._pages: "OrderedDict[_Key, Layers]" = OrderedDict()
        self._sizes: Dict[_Key, int] = {}
        self.bytes_used = 0
        self.stats: Dict[str, int] = {
            "spills": 0,        # pages accepted by put()
            "onboards": 0,      # pages served by get()
            "hits": 0,          # get() found the key
            "misses": 0,        # get() did not
            "evictions": 0,     # pages LRU-evicted to stay under budget
            "rejected": 0,      # pages refused (single page over budget)
        }

    @staticmethod
    def _key(tenant: str, path) -> _Key:
        return (str(tenant), tuple(int(t) for t in path))

    # ---- spill side ----
    def put(self, tenant: str, path, layers) -> bool:
        """Admit one evicted full-block page, copied so the tier owns its
        bytes. `path` is the block's full token path (a block_len
        multiple). Returns False when the page alone exceeds the budget
        (refused, counted)."""
        key = self._key(tenant, path)
        if len(key[1]) == 0 or len(key[1]) % self.block_len != 0:
            raise ValueError(
                f"path length {len(key[1])} is not a positive multiple of "
                f"block_len={self.block_len}")
        owned = [(_owned(k), _owned(v)) for k, v in layers]
        size = sum(k.nbytes + v.nbytes for k, v in owned)
        with self._lock:
            if size > self.byte_budget:
                self.stats["rejected"] += 1
                return False
            if key in self._pages:        # refresh in place
                self.bytes_used -= self._sizes[key]
                self._pages.pop(key)
            while self._pages and self.bytes_used + size > self.byte_budget:
                old_key, _ = self._pages.popitem(last=False)
                self.bytes_used -= self._sizes.pop(old_key)
                self.stats["evictions"] += 1
            self._pages[key] = owned
            self._sizes[key] = size
            self.bytes_used += size
            self.stats["spills"] += 1
            return True

    # ---- onboard side ----
    def get(self, tenant: str, path) -> Optional[Layers]:
        """One page for onboarding, bumping its LRU recency; None on a
        miss. The stored tensors are returned (read-only by convention)."""
        key = self._key(tenant, path)
        with self._lock:
            layers = self._pages.get(key)
            if layers is None:
                self.stats["misses"] += 1
                return None
            self._pages.move_to_end(key)
            self.stats["hits"] += 1
            self.stats["onboards"] += 1
            return layers

    def probe(self, tenant: str, tokens) -> int:
        """Read-only: the longest prefix of `tokens`, in whole blocks, in
        tokens, covered by spilled pages. No LRU bump, no stats."""
        toks = [int(t) for t in tokens]
        bl = self.block_len
        covered = 0
        with self._lock:
            j = 0
            while (j + 1) * bl <= len(toks):
                key = (str(tenant), tuple(toks[:(j + 1) * bl]))
                if key not in self._pages:
                    break
                covered = (j + 1) * bl
                j += 1
        return covered

    # ---- maintenance / views ----
    def clear(self, only=None):
        """Drop spilled pages: all, or those whose namespace satisfies
        the predicate `only`."""
        with self._lock:
            if only is None:
                self._pages.clear()
                self._sizes.clear()
                self.bytes_used = 0
                return
            for key in [k for k in self._pages if only(k[0])]:
                self._pages.pop(key)
                self.bytes_used -= self._sizes.pop(key)

    @property
    def pages(self) -> int:
        with self._lock:
            return len(self._pages)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "pages": len(self._pages),
                "bytes": self.bytes_used,
                "byte_budget": self.byte_budget,
                **dict(self.stats),
            }
