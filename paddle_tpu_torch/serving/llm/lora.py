"""Multi-adapter LoRA bank for the unified prefill+decode step
(counterpart of paddle_tpu/serving/llm/lora.py).

Holds K stacked adapter trees on the model's device, per decoder layer and
per target site, ``A [K, r, in]`` / ``B [K, out, r]`` fp32, plus a
per-slot ``adapter_idx`` lane. The unified step gathers each row's bank
entry (`ops/lora.py`), so adapters load, swap and unload without changing
the step's shapes or launches. Row 0 is all zeros and is what
``adapter=None`` slots ride: an exact-zero delta, bit-equal to base.

A row write is copy-on-write. The JAX bank rewrites rows functionally
(``.at[row].set``), so each jitted dispatch sees one consistent bank. The
port launches layer by layer from Python, so a row written in place
while a step is between layers would give that step old rows in some
layers and new rows in others. Here a load, swap or unload replaces each
touched layer/site tensor with a new one under the bank's lock and never
writes a tensor a step may hold; a step takes `device_args()` once, when
its operands are built, and keeps those tensors for every layer, so it
reads either the whole old bank or the whole new one (an attempt the
watchdog abandoned included). The [N] idx and [K] scale tensors are
rebuilt the same way.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ...tuning.lora import adapter_signature, target_sites


class AdapterError(ValueError):
    """Typed refusal: an adapter tree does not fit this bank/base model.

    reason in {"bank_full", "unknown_adapter", "adapter_mismatch",
    "rank_mismatch", "targets_mismatch", "layers_mismatch",
    "adapter_unavailable", "adapter_in_use"}.
    """

    def __init__(self, msg, reason="adapter_mismatch"):
        super().__init__(msg)
        self.reason = reason


class AdapterBank:
    def __init__(self, model, max_adapters: int, rank: int,
                 num_slots: int, default_alpha: Optional[float] = None):
        if max_adapters < 1:
            raise ValueError(f"max_adapters must be >= 1, got {max_adapters}")
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        sites, arch = target_sites(model)
        self.arch = arch
        self.rank = int(rank)
        self.max_adapters = int(max_adapters)
        self.num_rows = self.max_adapters + 1  # row 0 = base pass-through
        self.default_alpha = (2.0 * rank if default_alpha is None
                              else float(default_alpha))
        self.signature = adapter_signature(model, rank)
        self._site_dims = sites[0]            # {site: (in, out)}, homogeneous
        self._num_layers = len(sites)
        self.device = next(model.parameters()).device
        K, dev = self.num_rows, self.device
        self._A: List[Dict[str, torch.Tensor]] = [
            {name: torch.zeros((K, self.rank, i), dtype=torch.float32,
                               device=dev)
             for name, (i, o) in dims.items()} for dims in sites]
        self._B: List[Dict[str, torch.Tensor]] = [
            {name: torch.zeros((K, o, self.rank), dtype=torch.float32,
                               device=dev)
             for name, (i, o) in dims.items()} for dims in sites]
        self._scale = np.zeros(K, np.float32)
        self._slot_rows = np.zeros(int(num_slots), np.int64)
        self._rows: Dict[str, int] = {}
        self._free = list(range(1, K))
        self._dev_layers = None
        self._dev_slot = None
        self.version = 0          # bumped on every row mutation
        self._lock = threading.Lock()

    # -- registry --
    @property
    def adapter_ids(self):
        with self._lock:
            return sorted(self._rows)

    def row_of(self, adapter_id: str) -> Optional[int]:
        with self._lock:
            return self._rows.get(adapter_id)

    def validate_tree(self, tree, rank: Optional[int] = None):
        """Typed refusal when a tree's rank or target-site signature does
        not match the base model this bank was built for."""
        r = self.rank if rank is None else int(rank)
        if r != self.rank:
            raise AdapterError(
                f"adapter rank {r} != bank rank {self.rank}",
                reason="rank_mismatch")
        if not isinstance(tree, dict):
            raise AdapterError(
                f"adapter tree must be a dict, got {type(tree).__name__}")
        want_layers = {str(i) for i in range(self._num_layers)}
        if set(tree) != want_layers:
            raise AdapterError(
                f"adapter covers layers {sorted(tree)} but base model has "
                f"layers {sorted(want_layers)}", reason="layers_mismatch")
        want_sites = set(self._site_dims)
        for li, layer_tree in tree.items():
            if set(layer_tree) != want_sites:
                raise AdapterError(
                    f"layer {li} adapts {sorted(layer_tree)} but the bank "
                    f"targets {sorted(want_sites)}",
                    reason="targets_mismatch")
            for name, entry in layer_tree.items():
                in_f, out_f = self._site_dims[name]
                A, B = np.asarray(entry["A"]), np.asarray(entry["B"])
                if A.shape != (self.rank, in_f) or \
                        B.shape != (out_f, self.rank):
                    raise AdapterError(
                        f"layer {li} site {name!r}: got A{A.shape}/"
                        f"B{B.shape}, base model wants "
                        f"A{(self.rank, in_f)}/B{(out_f, self.rank)}",
                        reason="adapter_mismatch")

    def load(self, adapter_id: str, tree,
             alpha: Optional[float] = None) -> int:
        """Upsert an adapter into a bank row (a hot swap when it exists).
        Validates against the base-model signature first (typed refusal),
        then writes the row copy-on-write: the step's operand shapes are
        untouched. Returns the row index."""
        adapter_id = str(adapter_id)
        if not adapter_id:
            raise AdapterError("adapter_id must be non-empty",
                               reason="unknown_adapter")
        self.validate_tree(tree)
        # stage the row on the device before taking the lock
        staged = [{name: tuple(
            torch.from_numpy(np.array(tree[str(i)][name][k], np.float32)
                             ).to(self.device) for k in ("A", "B"))
            for name in self._site_dims} for i in range(self._num_layers)]
        with self._lock:
            row = self._rows.get(adapter_id)
            if row is None:
                if not self._free:
                    raise AdapterError(
                        f"adapter bank full ({self.max_adapters} rows); "
                        "unload an adapter first", reason="bank_full")
                row = self._free.pop(0)
                self._rows[adapter_id] = row
            self._write_row_locked(row, staged,
                                   self.default_alpha if alpha is None
                                   else float(alpha))
            return row

    def _write_row_locked(self, row, staged, alpha):
        """Replace every layer/site tensor by a copy with `row` written
        (`staged` None writes zeros); tensors handed out before stay as
        they were."""
        for i in range(self._num_layers):
            for name in self._site_dims:
                for bank, k in ((self._A, 0), (self._B, 1)):
                    t = bank[i][name].clone()
                    if staged is None:
                        t[row].zero_()
                    else:
                        t[row].copy_(staged[i][name][k])
                    bank[i][name] = t
        self._scale[row] = float(alpha) / self.rank
        self._dev_layers = None
        self._dev_slot = None
        self.version += 1

    def unload(self, adapter_id: str):
        with self._lock:
            row = self._rows.pop(adapter_id, None)
            if row is None:
                raise AdapterError(f"unknown adapter {adapter_id!r}",
                                   reason="unknown_adapter")
            self._write_row_locked(row, None, 0.0)
            self._free.insert(0, row)

    def snapshot_row(self, adapter_id: str):
        """Host copy of an adapter's current row (None when absent): the
        rollback token a hot swap keeps before overwriting."""
        with self._lock:
            row = self._rows.get(adapter_id)
            if row is None:
                return None
            tree = {}
            for i in range(self._num_layers):
                tree[str(i)] = {
                    name: {"A": self._A[i][name][row].cpu().numpy().copy(),
                           "B": self._B[i][name][row].cpu().numpy().copy()}
                    for name in self._site_dims}
            return {"tree": tree,
                    "alpha": float(self._scale[row]) * self.rank}

    def restore(self, adapter_id: str, snap):
        """Roll a row back to a snapshot_row() token; None = unload."""
        if snap is None:
            self.unload(adapter_id)
            return
        self.load(adapter_id, snap["tree"], alpha=snap["alpha"])

    # -- per-slot lane --
    def bind_slot(self, slot: int, adapter_id: Optional[str]) -> int:
        with self._lock:
            if adapter_id is None or adapter_id == "":
                row = 0
            else:
                row = self._rows.get(adapter_id)
                if row is None:
                    raise AdapterError(f"unknown adapter {adapter_id!r}",
                                       reason="unknown_adapter")
            self._slot_rows[slot] = row
            self._dev_slot = None
            return row

    def clear_slot(self, slot: int):
        with self._lock:
            self._slot_rows[slot] = 0
            self._dev_slot = None

    def slot_row(self, slot: int) -> int:
        return int(self._slot_rows[slot])

    def adapter_of_row(self, row: int) -> Optional[str]:
        if row == 0:
            return None
        with self._lock:
            for aid, r in self._rows.items():
                if r == row:
                    return aid
        return None

    # -- step operands --
    def _layers_locked(self):
        if self._dev_layers is None:
            self._dev_layers = tuple(
                {name: (self._A[i][name], self._B[i][name])
                 for name in self._site_dims}
                for i in range(self._num_layers))
        return self._dev_layers

    def _scale_locked(self):
        return torch.from_numpy(self._scale.copy()).to(self.device)

    def device_args(self):
        """(per_layer_banks, adapter_idx [N] int64, scale [K] fp32): the
        `adapters` operand of `forward_with_cache`. Its structure is fixed
        for the bank's lifetime; a mutation hands out new tensors and
        never changes ones already handed out."""
        with self._lock:
            layers = self._layers_locked()
            if self._dev_slot is None:
                self._dev_slot = (
                    torch.from_numpy(self._slot_rows.copy()).to(self.device),
                    self._scale_locked())
            idx, scale = self._dev_slot
            return layers, idx, scale

    def args_for_rows(self, rows):
        """The adapters operand for an ad-hoc batch (canary probes, blame
        probes): the same banks, an explicit bank row a batch row."""
        with self._lock:
            return (self._layers_locked(),
                    torch.from_numpy(np.asarray(rows, np.int64)).to(
                        self.device),
                    self._scale_locked())

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rank": self.rank,
                "max_adapters": self.max_adapters,
                "loaded": sorted(self._rows),
                "free_rows": len(self._free),
                "version": self.version,
            }
