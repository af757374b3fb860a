"""Slot-paged static KV cache pool with a shared, refcounted block pool
(counterpart of paddle_tpu/serving/llm/kv_pool.py).

A fixed pool of `num_slots` cache slots backed by one static slab per
layer, `[num_slots, Hkv, block_len * n_blocks + pad_tokens, D]` — exactly
the model's `init_cache(num_slots, slab_len)` layout. Slots are the unit
of admission; blocks are the unit of accounting and sharing: a slot's
block table lists the `block_len`-wide pages that back its committed
length. `pad_tokens` extends each slab past the addressable capacity so
the engine's fixed-width chunk writes near the capacity edge, and free
rows' discarded writes, land in scratch columns no table addresses.

The slabs are torch tensors that the model's cached forward writes IN
PLACE (the JAX pool threads new immutable slabs through each call), so
every copy here is an in-place copy inside each layer's slab on its own
device: copy-on-write and import never round-trip through the host, and
export copies exactly the columns it returns.

The write path always lands a row's new KV in that row's own stripe at
its logical column, so a slot's OWN page for logical block j is page
`slot * n_blocks + j`; only the READ side (the paged kernel's block
table) redirects. Prefix sharing is therefore:

- `attach_blocks(slot, pages)` points a slot's leading logical blocks at
  cache-registered pages living in other rows, refcounting each;
- `cow_copy(src_page, dst_slot)` copies one shared (partial) block into
  the slot's own page at the same offset so its suffix can diverge;
- the prefix cache pins pages with `register_cached`/`release_cached`;
  a row holding a pinned page is never handed out by `allocate`, which
  under pressure calls the `on_pressure` hook (the cache's LRU eviction)
  once; pages with live readers cannot be released;
- `defrag` scrubs freed rows except their cached pages;
- every page ever claimed is freed, active or cached:
  `blocks_allocated == blocks_freed + blocks_active + blocks_cached`,
  which `check_balance()` proves beside the slot ledger.

The block table and lengths are host numpy, mirrored to the slab device
on change (`device_block_table`, `device_seq_lens`): cold traffic keeps
identity rows and uploads the table once; a stale table would silently
read the wrong pages, so every row change bumps the version.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch


class SlotsExhaustedError(RuntimeError):
    """allocate() found no usable free slot — every row is decoding or
    pinned by cached blocks with live readers. The engine maps this to
    queueing, never to a reallocation: the pool size is fixed."""


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """An owned, contiguous CPU copy of `t` in its dtype (one copy)."""
    out = torch.empty(tuple(t.shape), dtype=t.dtype, device="cpu")
    out.copy_(t)
    return out


class SlotPagedKVPool:
    """Fixed pool of KV cache slots with block/length accounting and a
    shared, refcounted block pool for prefix sharing.

    init_cache_fn(batch, max_len, dtype=...) must return the model's cache
    — a list of (k, v) tensors shaped [batch, Hkv, max_len, D] — and is
    called once with batch=num_slots, max_len=block_len*n_blocks + pad.
    Models enforce their own limits there (GPT refuses capacity beyond its
    learned position table)."""

    def __init__(self, init_cache_fn: Callable, num_slots: int,
                 block_len: int, n_blocks: int, dtype=None,
                 pad_tokens: int = 0):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if block_len < 1 or n_blocks < 1:
            raise ValueError(
                f"block_len/n_blocks must be >= 1, got "
                f"{block_len}/{n_blocks}")
        if pad_tokens < 0:
            raise ValueError(f"pad_tokens must be >= 0, got {pad_tokens}")
        self.num_slots = int(num_slots)
        self.block_len = int(block_len)
        self.n_blocks = int(n_blocks)
        self.capacity = self.block_len * self.n_blocks  # tokens per slot
        self.pad_tokens = int(pad_tokens)
        self.slab_len = self.capacity + self.pad_tokens
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.slabs: List[Tuple[torch.Tensor, torch.Tensor]] = [
            (k, v) for k, v in init_cache_fn(self.num_slots, self.slab_len,
                                             **kwargs)]
        self.device = self.slabs[0][0].device
        self.lengths = np.zeros((self.num_slots,), np.int32)
        self.active = np.zeros((self.num_slots,), bool)
        # freed rows whose non-cached pages still hold stale KV until
        # defrag() zeroes them (hygiene: prefill overwrites on reuse)
        self.dirty = np.zeros((self.num_slots,), bool)
        # slot -> page ids backing its length: attached (shared) pages
        # first, then the slot's own identity pages
        self.block_table: Dict[int, List[int]] = {}
        self._attached: Dict[int, List[int]] = {}   # slot -> shared pages
        self._own_claimed: Dict[int, int] = {}      # slot -> own pages
        self.refcount: Dict[int, int] = {}          # page -> live readers
        self.cached: Set[int] = set()               # pages pinned by cache
        self._cache_owned: Set[int] = set()         # cached, owner freed
        # called by allocate() when free rows exist but all are pinned;
        # the prefix cache wires its LRU eviction here
        self.on_pressure: Optional[Callable[[], int]] = None
        self.stats = {"allocs": 0, "frees": 0, "reuses": 0,
                      "alloc_failures": 0, "defrags": 0, "peak_active": 0,
                      "blocks_allocated": 0, "blocks_freed": 0,
                      "cow_copies": 0}
        self._host_table = self._identity_table()
        self._table_version = 1
        self._table_uploaded = 0
        self._dev_table: Optional[torch.Tensor] = None
        self._lens_version = 1
        self._lens_uploaded = 0
        self._dev_lens: Optional[torch.Tensor] = None

    def _identity_table(self) -> np.ndarray:
        return (np.arange(self.num_slots, dtype=np.int32)[:, None]
                * self.n_blocks
                + np.arange(self.n_blocks, dtype=np.int32)[None, :])

    def _identity_row(self, slot: int) -> List[int]:
        return [slot * self.n_blocks + j for j in range(self.n_blocks)]

    def _row_pinned(self, row: int) -> bool:
        """A row holding ANY cached page cannot be handed to a fresh
        sequence: its prefill would overwrite shared KV in place."""
        base = row * self.n_blocks
        return any((base + j) in self.cached for j in range(self.n_blocks))

    def has_allocatable_row(self) -> bool:
        return any(not self.active[r] and not self._row_pinned(r)
                   for r in range(self.num_slots))

    # ---- allocation ----
    def allocate(self, need_tokens: int) -> int:
        """Claim the first free, unpinned slot for a sequence that will
        grow to `need_tokens`. Raises ValueError when it can never fit and
        SlotsExhaustedError when the pool is momentarily full. When every
        free row is pinned, `on_pressure` gets one chance to release
        refcount-0 cached pages before the verdict."""
        if need_tokens > self.capacity:
            raise ValueError(
                f"sequence needs {need_tokens} tokens but slot capacity is "
                f"{self.capacity} (block_len={self.block_len} x "
                f"n_blocks={self.n_blocks})")
        free = np.flatnonzero(~self.active)
        if free.size == 0:
            self.stats["alloc_failures"] += 1
            raise SlotsExhaustedError(f"all {self.num_slots} slots active")
        slot = next((int(r) for r in free if not self._row_pinned(r)), None)
        if slot is None and self.on_pressure is not None:
            self.on_pressure()
            slot = next((int(r) for r in free if not self._row_pinned(r)),
                        None)
        if slot is None:
            self.stats["alloc_failures"] += 1
            raise SlotsExhaustedError(
                f"every free slot is pinned by cached blocks with live "
                f"readers ({free.size} free of {self.num_slots})")
        self.active[slot] = True
        if self.dirty[slot]:
            self.stats["reuses"] += 1
            self.dirty[slot] = False
        if self.lengths[slot] != 0:
            self._lens_version += 1
        self.lengths[slot] = 0
        self.block_table[slot] = []
        self._attached[slot] = []
        self._own_claimed[slot] = 0
        self.set_block_row(slot, self._identity_row(slot))
        self.stats["allocs"] += 1
        self.stats["peak_active"] = max(self.stats["peak_active"],
                                        int(self.active.sum()))
        return slot

    def free(self, slot: int):
        """Release a slot: drop its refcount on every attached page and
        settle its own pages — registered ones pass to the cache, the rest
        are freed."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        for p in self._attached.get(slot, ()):
            self.release_block(p)
        n_att = len(self._attached.get(slot, ()))
        for j in range(n_att, n_att + self._own_claimed.get(slot, 0)):
            p = slot * self.n_blocks + j
            if p in self.cached:
                self._cache_owned.add(p)
            else:
                self.stats["blocks_freed"] += 1
        self._attached.pop(slot, None)
        self._own_claimed.pop(slot, None)
        self.active[slot] = False
        self.dirty[slot] = True
        if self.lengths[slot] != 0:
            self._lens_version += 1
        self.lengths[slot] = 0
        self.block_table.pop(slot, None)
        self.stats["frees"] += 1

    def _table_for(self, slot: int, blocks: int) -> List[int]:
        attached = self._attached.get(slot, [])
        return (attached[:blocks]
                + [slot * self.n_blocks + j
                   for j in range(len(attached), blocks)])

    def set_length(self, slot: int, length: int):
        """Record `length` valid tokens in `slot`, growing its block table
        to ceil(length / block_len) pages: the attached prefix first, then
        own identity pages. Newly claimed own pages charge the ledger."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        if length > self.capacity:
            raise ValueError(
                f"length {length} exceeds slot capacity {self.capacity}")
        if int(self.lengths[slot]) != int(length):
            self._lens_version += 1
        self.lengths[slot] = length
        blocks = -(-int(length) // self.block_len)
        own_needed = max(0, blocks - len(self._attached.get(slot, [])))
        claimed = self._own_claimed.get(slot, 0)
        if own_needed > claimed:
            self.stats["blocks_allocated"] += own_needed - claimed
            self._own_claimed[slot] = own_needed
        self.block_table[slot] = self._table_for(slot, blocks)

    def rewind_length(self, slot: int, length: int):
        """Shrink `slot`'s committed length to `length`, returning own
        pages past the new block count to the ledger, from the top down,
        stopping at the first cache-registered page (the cache owns its
        lifetime). Attached pages are never touched. A larger `length`
        raises: growing is `set_length`'s job."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        length = int(length)
        cur = int(self.lengths[slot])
        if length > cur:
            raise ValueError(
                f"rewind_length can only shrink: {length} > committed "
                f"{cur} (use set_length to grow)")
        if length < 0:
            raise ValueError(f"length must be >= 0, got {length}")
        if length == cur:
            return
        self._lens_version += 1
        self.lengths[slot] = length
        blocks = -(-length // self.block_len)
        n_att = len(self._attached.get(slot, []))
        own_needed = max(0, blocks - n_att)
        claimed = self._own_claimed.get(slot, 0)
        new_claimed = claimed
        for j in range(n_att + claimed - 1, n_att + own_needed - 1, -1):
            if slot * self.n_blocks + j in self.cached:
                break
            new_claimed -= 1
        if new_claimed != claimed:
            self.stats["blocks_freed"] += claimed - new_claimed
            self._own_claimed[slot] = new_claimed
        self.block_table[slot] = self._table_for(slot, blocks)

    # ---- prefix sharing ----
    def attach_blocks(self, slot: int, pages: List[int]):
        """Point `slot`'s leading logical blocks at cache-registered pages
        of other rows, one refcount each for the slot's lifetime. Page j
        must sit at block offset j (`page % n_blocks == j`), where the
        write path put it."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        if len(pages) > self.n_blocks:
            raise ValueError(
                f"cannot attach {len(pages)} pages to a "
                f"{self.n_blocks}-block slot")
        for j, p in enumerate(pages):
            if p not in self.cached:
                raise ValueError(
                    f"page {p} is not cache-registered; only cached "
                    "blocks can be shared")
            if p % self.n_blocks != j:
                raise ValueError(
                    f"page {p} lives at block offset {p % self.n_blocks}, "
                    f"cannot back logical block {j}")
        for p in pages:
            self.refcount[p] = self.refcount.get(p, 0) + 1
        self._attached[slot] = list(pages)
        self.set_block_row(
            slot, list(pages) + [slot * self.n_blocks + j
                                 for j in range(len(pages), self.n_blocks)])

    def release_block(self, page: int):
        """Drop one reader's refcount on a shared page."""
        n = self.refcount.get(page, 0)
        if n <= 1:
            self.refcount.pop(page, None)
        else:
            self.refcount[page] = n - 1

    def cow_copy(self, src_page: int, dst_slot: int):
        """Copy-on-write: copy one shared block's KV, the whole block,
        into `dst_slot`'s own page at the same logical offset, in place
        in every layer's slab on its device."""
        if not self.active[dst_slot]:
            raise ValueError(f"slot {dst_slot} is not active")
        src_row = src_page // self.n_blocks
        if src_row == dst_slot:
            return
        c0 = (src_page % self.n_blocks) * self.block_len
        c1 = c0 + self.block_len
        for k, v in self.slabs:
            k[dst_slot, :, c0:c1].copy_(k[src_row, :, c0:c1])
            v[dst_slot, :, c0:c1].copy_(v[src_row, :, c0:c1])
        self.stats["cow_copies"] += 1

    def register_cached(self, page: int):
        """Pin a page for the prefix cache: its row leaves the allocatable
        set and defrag never scrubs it."""
        if not (0 <= page < self.num_slots * self.n_blocks):
            raise ValueError(f"page {page} out of range")
        if page in self.cached:
            raise ValueError(f"page {page} already cache-registered")
        self.cached.add(page)

    def release_cached(self, page: int):
        """Cache eviction: unpin a page; refused while readers hold it. A
        page whose slot already freed settles to the freed side of the
        ledger, and its row becomes scrub-eligible again."""
        if page not in self.cached:
            raise ValueError(f"page {page} is not cache-registered")
        if self.refcount.get(page, 0) > 0:
            raise ValueError(
                f"page {page} has {self.refcount[page]} live reader(s); "
                "evicting it would corrupt active streams")
        self.cached.discard(page)
        if page in self._cache_owned:
            self._cache_owned.discard(page)
            self.stats["blocks_freed"] += 1
        row = page // self.n_blocks
        if not self.active[row]:
            self.dirty[row] = True

    def set_block_row(self, slot: int, blocks: List[int]):
        """Point `slot`'s table row at an explicit page list; entries past
        len(blocks) are zero, masked by the row's length. Bumps the table
        version only when the row changes."""
        if len(blocks) > self.n_blocks:
            raise ValueError(
                f"slot row holds at most {self.n_blocks} pages, got "
                f"{len(blocks)}")
        row = np.zeros((self.n_blocks,), np.int32)
        row[:len(blocks)] = np.asarray(blocks, np.int32)
        if not np.array_equal(self._host_table[slot], row):
            self._host_table[slot] = row
            self._table_version += 1

    # ---- device mirrors (paged attention inputs) ----
    def device_block_table(self) -> torch.Tensor:
        """[num_slots, n_blocks] int32 page ids on the slab device,
        uploaded again only after some row changed."""
        if self._dev_table is None \
                or self._table_uploaded != self._table_version:
            self._dev_table = torch.from_numpy(
                self._host_table.copy()).to(self.device)
            self._table_uploaded = self._table_version
        return self._dev_table

    def device_seq_lens(self) -> torch.Tensor:
        """[num_slots] int32 committed lengths, uploaded only on change."""
        if self._dev_lens is None \
                or self._lens_uploaded != self._lens_version:
            self._dev_lens = torch.from_numpy(
                self.lengths.copy()).to(self.device)
            self._lens_uploaded = self._lens_version
        return self._dev_lens

    # ---- views ----
    def free_slots(self) -> int:
        return int((~self.active).sum())

    def active_slots(self) -> int:
        return int(self.active.sum())

    def used_blocks(self) -> int:
        return sum(len(b) for b in self.block_table.values())

    def blocks_active(self) -> int:
        """Own pages of active slots (attached pages are counted by their
        owner or the cache, never twice)."""
        return sum(n for s, n in self._own_claimed.items()
                   if self.active[s])

    def blocks_cached(self) -> int:
        """Pages whose slot freed while the cache held them."""
        return len(self._cache_owned)

    def cached_blocks(self) -> int:
        """Every page the prefix cache pins, owner active or not."""
        return len(self.cached)

    def dirty_blocks(self) -> int:
        """Scrubbable pages: pages of freed rows the cache does not pin."""
        total = 0
        for r in np.flatnonzero(self.dirty):
            base = int(r) * self.n_blocks
            total += sum(1 for j in range(self.n_blocks)
                         if (base + j) not in self.cached)
        return total

    def fragmentation_ratio(self) -> float:
        """1 - sum(lengths) / (used_blocks * block_len); 0.0 when idle."""
        used = self.used_blocks()
        if used == 0:
            return 0.0
        return 1.0 - float(self.lengths.sum()) / (used * self.block_len)

    def snapshot(self) -> dict:
        return {
            **self.stats,
            "num_slots": self.num_slots,
            "active_slots": self.active_slots(),
            "capacity_tokens": self.capacity,
            "used_blocks": self.used_blocks(),
            "dirty_blocks": self.dirty_blocks(),
            "total_blocks": self.num_slots * self.n_blocks,
            "blocks_active": self.blocks_active(),
            "blocks_cached": self.blocks_cached(),
            "cached_pages": self.cached_blocks(),
        }

    def check_balance(self) -> bool:
        """Slots: `allocs == frees + active`. Blocks: `blocks_allocated ==
        blocks_freed + blocks_active + blocks_cached` — no path leaked a
        slot or a page. Raises AssertionError with the offending ledger."""
        allocs, frees = self.stats["allocs"], self.stats["frees"]
        active = self.active_slots()
        if allocs != frees + active:
            raise AssertionError(
                f"KV pool slot ledger out of balance: allocs={allocs} != "
                f"frees={frees} + active={active} "
                f"(leaked {allocs - frees - active})")
        b_alloc = self.stats["blocks_allocated"]
        b_freed = self.stats["blocks_freed"]
        b_active = self.blocks_active()
        b_cached = self.blocks_cached()
        if b_alloc != b_freed + b_active + b_cached:
            raise AssertionError(
                f"KV pool block ledger out of balance: "
                f"blocks_allocated={b_alloc} != blocks_freed={b_freed} + "
                f"blocks_active={b_active} + blocks_cached={b_cached} "
                f"(leaked {b_alloc - b_freed - b_active - b_cached})")
        return True

    # ---- row and page serialization ----
    def export_rows(self, slots: List[int]) -> dict:
        """The committed KV of active `slots`: per slot its length and per
        layer [Hkv, length, D] K and V, assembled page by page through the
        block table on the slab device (attached pages read from their
        own rows, as the kernel reads them) and copied to the host once a
        layer. CPU tensors in the slab dtype; `import_rows` on a pool of
        the same geometry lands them bit for bit."""
        rows: Dict[int, dict] = {}
        for slot in slots:
            slot = int(slot)
            if not self.active[slot]:
                raise ValueError(f"slot {slot} is not active")
            length = int(self.lengths[slot])
            pages = list(self.block_table.get(slot, []))
            layers = []
            for k, v in self.slabs:
                kparts, vparts = [], []
                for j, p in enumerate(pages):
                    prow = p // self.n_blocks
                    c0 = (p % self.n_blocks) * self.block_len
                    w = min(self.block_len, length - j * self.block_len)
                    kparts.append(k[prow, :, c0:c0 + w])
                    vparts.append(v[prow, :, c0:c0 + w])
                if kparts:
                    layers.append((_to_host(torch.cat(kparts, dim=1)),
                                   _to_host(torch.cat(vparts, dim=1))))
                else:
                    empty = torch.zeros((k.shape[1], 0, k.shape[3]),
                                        dtype=k.dtype)
                    layers.append((empty, empty.clone()))
            rows[slot] = {"length": length, "layers": layers}
        return {"block_len": self.block_len, "capacity": self.capacity,
                "rows": rows}

    def export_page(self, page: int, width: Optional[int] = None
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """ONE page's first `width` columns (default the whole block) per
        layer as owned CPU ([Hkv, width, D] K, V) pairs in the slab dtype:
        the host tier's spill unit, 2 x layers copies of exactly those
        columns."""
        if not (0 <= page < self.num_slots * self.n_blocks):
            raise ValueError(f"page {page} out of range")
        w = self.block_len if width is None else int(width)
        if not (0 < w <= self.block_len):
            raise ValueError(
                f"width must be in 1..{self.block_len}, got {w}")
        prow = page // self.n_blocks
        c0 = (page % self.n_blocks) * self.block_len
        return [(_to_host(k[prow, :, c0:c0 + w]),
                 _to_host(v[prow, :, c0:c0 + w]))
                for k, v in self.slabs]

    def import_page(self, slot: int, block_idx: int, layers):
        """Land one page's KV (`export_page`'s payload, or any [Hkv, w, D]
        pairs) in `slot`'s own page at logical block `block_idx`, in place
        in each layer's slab. Inverse of `export_page`, bit for bit. The
        ledger follows the engine's next `set_length` past the block."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        if not (0 <= block_idx < self.n_blocks):
            raise ValueError(f"block_idx {block_idx} out of range "
                             f"0..{self.n_blocks - 1}")
        if len(layers) != len(self.slabs):
            raise ValueError(
                f"payload has {len(layers)} layers, pool has "
                f"{len(self.slabs)}")
        c0 = block_idx * self.block_len
        for ke, _ in layers:
            if ke.shape[1] > self.block_len:
                raise ValueError(
                    f"page payload holds {ke.shape[1]} tokens, block_len "
                    f"is {self.block_len}")
        for (k, v), (ke, ve) in zip(self.slabs, layers):
            w = ke.shape[1]
            k[slot, :, c0:c0 + w].copy_(torch.as_tensor(ke))
            v[slot, :, c0:c0 + w].copy_(torch.as_tensor(ve))

    def import_rows(self, exported: dict) -> Dict[int, int]:
        """Materialize `export_rows` rows into THIS pool: each allocates a
        fresh slot, commits its length on own identity pages (the
        attachment structure is not kept, the KV bits are) and lands its
        columns in place. Returns {source slot: destination slot}."""
        if int(exported["block_len"]) != self.block_len:
            raise ValueError(
                f"block_len mismatch: exported {exported['block_len']} "
                f"vs pool {self.block_len}")
        mapping: Dict[int, int] = {}
        for src in sorted(exported["rows"]):
            row = exported["rows"][src]
            length = int(row["length"])
            if length > self.capacity:
                raise ValueError(
                    f"row {src} holds {length} tokens but this pool's "
                    f"capacity is {self.capacity}")
            dst = self.allocate(length)
            self.set_length(dst, length)
            if length > 0:
                for (k, v), (ke, ve) in zip(self.slabs, row["layers"]):
                    k[dst, :, :length].copy_(torch.as_tensor(ke))
                    v[dst, :, :length].copy_(torch.as_tensor(ve))
            mapping[int(src)] = dst
        return mapping

    # ---- hygiene ----
    def defrag(self) -> int:
        """Scrub stale KV out of freed rows and return the pages
        reclaimed: each slab is multiplied in place by a keep mask that
        is 0 on freed rows and 1 on every page the cache pins (so cached
        pages stay bit-intact; a scrubbed negative entry reads -0.0, as
        the JAX pool's masked multiply leaves it). Hygiene only: prefill
        overwrites what it reads on reuse."""
        rows = np.flatnonzero(self.dirty)
        if rows.size == 0:
            return 0
        keep = np.ones((self.num_slots, self.slab_len), np.float32)
        reclaimed = 0
        for r in rows:
            keep[r, :] = 0.0
            base = int(r) * self.n_blocks
            for j in range(self.n_blocks):
                if (base + j) in self.cached:
                    keep[r, j * self.block_len:(j + 1) * self.block_len] = 1.0
                else:
                    reclaimed += 1
        if reclaimed == 0:
            return 0
        keep_d = torch.from_numpy(keep).to(self.device)
        for k, v in self.slabs:
            k.mul_(keep_d.to(k.dtype)[:, None, :, None])
            v.mul_(keep_d.to(v.dtype)[:, None, :, None])
        self.dirty[:] = False
        self.stats["defrags"] += 1
        return reclaimed
