"""Checkpointing, continuous checkpointing and epoch-range auto-resume
(counterpart of paddle_tpu/checkpoint.py).

Reference: paddle.save/load pickle state (python/paddle/framework/io.py:550,766),
fleet-aware save (fleet_base.py:654-732), and the auto-checkpoint epoch-range
protocol (fluid/incubate/checkpoint/auto_checkpoint.py — snapshots keyed by job
id enabling elastic resume).

The port has no orbax: every manager takes the JAX package's fallback
protocol, the one it takes when orbax is missing (`use_orbax` is
accepted and changes nothing). A step is `step_<n>.pdckpt` (the
`framework_io` format, bf16 packed as fp32 values, pickled with protocol
5, which the JAX package's `load` reads too) plus `step_<n>.manifest.json` (per-leaf shapes and dtypes under
`jax.tree_util.keystr` keys such as `['model']['fc1.weight']` with numpy
dtype names, the CRC32 of the data file, the data-stream cursor), written
tmp → fsync → rename, data first and manifest last. So a step file the
port writes verifies and restores in the JAX `CheckpointManager(
use_orbax=False)`, and the reverse. Restores put every array on the
manager's `device` (the first GPU unless `device="cpu"`).

`AsyncCheckpointManager` snapshots train state off the device into a
small in-memory ring (the step thread blocks only for the device→host
copy) and persists on a bounded background writer thread with the same
protocol, plus `scrub_checkpoints`, the restore-time scrubber that
quarantines manifest-certified-but-corrupt steps instead of restoring
them.

The port's train steps update parameters and optimizer slots IN PLACE
(fused Adam), where the JAX package's arrays are immutable. So a
snapshot is an owned host copy of every tensor, taken with a
synchronous device→host copy that has finished when `snapshot()`
returns (nothing the next step launches can reach it), and a restore
hands back fresh tensors that the caller's `set_state` copies INTO the
live ones (`Layer.set_state_dict`, `Optimizer.set_state_dict`), so the
step keeps updating the storage it holds.
"""
from __future__ import annotations

import copy
import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .utils import fault_injection


def _keystr(path) -> str:
    """`jax.tree_util.keystr` of a key path: `['a'][0]['b']`."""
    return "".join(f"[{k!r}]" for k in path)


def _leaves_with_path(tree, path=()):
    """(path, leaf) pairs in the order `jax.tree_util` flattens: dict keys
    sorted, list and tuple items in order, None no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (`bfloat16`, `float32`)."""
    return str(dtype).replace("torch.", "")


def _leaf_specs(state) -> Dict[str, Dict[str, Any]]:
    """Per-leaf {path: {shape, dtype}} for the integrity manifest, keyed
    and named as the JAX package's manifest is."""
    out = {}
    for path, leaf in _leaves_with_path(state):
        key = _keystr(path)
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            out[key] = {"shape": list(leaf.shape),
                        "dtype": _dtype_name(leaf.dtype)}
        else:
            out[key] = {"shape": [], "dtype": type(leaf).__name__}
    return out


class _CrcWriter:
    """A binary file object's writes with the running CRC32 of what they
    wrote."""

    def __init__(self, f):
        self._f = f
        self.crc = 0

    def write(self, b):
        self.crc = zlib.crc32(b, self.crc)
        return self._f.write(b)


def _write_step_file(state, path: str) -> int:
    """Write `state` to `path` in the `framework_io` format and fsync it;
    returns the CRC32 of the bytes written, counted as they are written
    (the JAX package reads the file back for it: the same value, one
    pass less over the file). CUDA tensors come over in one synchronised
    pass of pinned copies (`_to_host`), not a pageable copy a tensor.
    Pickle protocol 5, which both packages' `load` read: numpy arrays go
    to the file from their own memory, without protocol 4's copy of
    every array into a bytes object."""
    from .framework_io import dump
    state = _to_host(state, own=False)
    with open(path, "wb") as f:
        w = _CrcWriter(f)
        dump(state, w, protocol=5)
        f.flush()
        os.fsync(f.fileno())
    return w.crc & 0xFFFFFFFF


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _to_host(tree, own: bool):
    """`tree` with every CUDA tensor copied into pinned host memory: all
    copies are enqueued (non-blocking) on their device's current stream,
    after the work that wrote the tensors, and the streams are
    synchronised before this returns, so every copy is complete (a copy
    still in flight would be torn by the next step's in-place update).
    Pinned blocks come from torch's caching host allocator, so a
    snapshot's buffers are reused once it is dropped. With `own`, CPU
    tensors and numpy arrays are copied too and other leaves deep-copied
    (a snapshot must own everything); without, they are left as they
    are (a synchronous save packs them before returning)."""
    streams = {}

    def fetch(x):
        if torch.is_tensor(x):
            x = x.detach()
            if x.is_cuda:
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x, non_blocking=True)
                streams.setdefault(x.device,
                                   torch.cuda.current_stream(x.device))
                return buf
            return x.clone() if own else x
        if isinstance(x, np.ndarray):
            return np.array(x) if own else x
        if isinstance(x, dict):
            return {k: fetch(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(fetch(v) for v in x)
        return copy.deepcopy(x) if own else x

    out = fetch(tree)
    for stream in streams.values():
        stream.synchronize()
    return out


def _host_copy(tree):
    """Device→host copy of a state tree: every tensor becomes an OWNED CPU
    tensor of its dtype (CUDA tensors through `_to_host`'s pinned,
    synchronised copies: the train step updates its tensors in place, so
    the snapshot must not be a view nor a copy still in flight), numpy
    arrays are copied, other leaves deep-copied. This is the only
    blocking work `snapshot()` does; bf16 stays bf16 here and is packed
    as fp32 values when the writer saves it."""
    return _to_host(tree, own=True)


def _to_device(tree, device):
    """A host tree as a restore would give it: every tensor and array a
    fresh tensor on `device`."""
    from .framework_io import _array_to_tensor, _is_array
    if torch.is_tensor(tree):
        return tree.to(device, copy=True)
    if _is_array(tree):
        return _array_to_tensor(tree, device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def rng_cursor(rs) -> Dict[str, Any]:
    """JSON-safe capture of a np.random.RandomState — the usual data-stream
    half of an exact-resume cursor. Pair with `restore_rng`; store the dict
    via `CheckpointManager.save(..., cursor=...)` / the trainer's
    `get_cursor` hook so a restored run replays the identical batches."""
    name, keys, pos, has_gauss, cached = rs.get_state()
    return {"rng": name, "keys": [int(k) for k in keys], "pos": int(pos),
            "has_gauss": int(has_gauss), "cached": float(cached)}


def restore_rng(rs, cursor: Dict[str, Any]) -> None:
    """Inverse of `rng_cursor`: rewind a RandomState to the captured point."""
    rs.set_state((cursor["rng"],
                  np.asarray(cursor["keys"], dtype=np.uint32),
                  int(cursor["pos"]), int(cursor["has_gauss"]),
                  float(cursor["cached"])))


class CheckpointManager:
    """Step-indexed checkpoint directory with retention.

    usage:
        mgr = CheckpointManager(dir, max_to_keep=3)     # device="cpu" too
        mgr.save(step, {"model": model.state_dict(), "opt": ...})
        state = mgr.restore(step=None)   # latest, tensors on the device

    Torn-write safe: the pickle is written to a temp name, a JSON manifest
    (per-leaf shapes/dtypes + CRC32 of the data file) is written
    alongside, and both land via atomic os.replace — data first, manifest
    last, so a manifest's existence certifies a complete data file.
    restore()/latest_step() only consider steps whose manifest exists and
    whose checksum matches, so a process killed mid-save (or a corrupted
    file) falls back to the latest *valid* step. `async_save` and
    `use_orbax` are accepted for the JAX signature; without orbax the
    JAX manager saves synchronously on this protocol, and so does this
    one.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False, use_orbax: bool = True,
                 device=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        self.device = device   # where restores put tensors (None: cuda)

    # ---- fallback-path file layout ----
    def _data_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pdckpt")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.manifest.json")

    def save(self, step: int, state: Dict[str, Any], force: bool = False,
             cursor: Optional[Dict[str, Any]] = None):
        """Persist `state` under `step`. `cursor` is an optional JSON-safe
        data-stream position (iterator index, RNG state — see rng_cursor)
        stored in the manifest so a restored run can replay the exact
        batch sequence. `force` is accepted for the JAX signature."""
        plan = fault_injection.global_plan()
        data, manifest = self._data_path(step), self._manifest_path(step)
        tmp_data, tmp_manifest = data + ".tmp", manifest + ".tmp"
        crc = _write_step_file(state, tmp_data)
        plan.maybe_kill(step, fault_injection.KILL_POINT_MID_SAVE)
        spec = {"step": step, "format": "pdckpt.v1",
                "crc32": crc, "time": time.time(),
                "leaves": _leaf_specs(state)}
        if cursor is not None:
            spec["cursor"] = cursor
        with open(tmp_manifest, "w") as f:
            json.dump(spec, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_data, data)
        plan.maybe_kill(step, fault_injection.KILL_POINT_AFTER_DATA)
        os.replace(tmp_manifest, manifest)
        # torn-write fault (ckpt_torn_write@step): corrupt the data file
        # AFTER its manifest landed — certified-but-corrupt, the case only
        # the restore scrubber can catch
        plan.maybe_torn_write(step, data)
        self._gc()

    def read_cursor(self, step: int) -> Optional[Dict[str, Any]]:
        """The cursor stored with `step` (the manifest's "cursor" field),
        or None. A `step_<s>.cursor.json` sidecar (the JAX orbax path's)
        is read too."""
        manifest = self._manifest_path(step)
        if os.path.exists(manifest):
            try:
                with open(manifest) as f:
                    return json.load(f).get("cursor")
            except (OSError, ValueError):
                return None
        side = os.path.join(self.directory, f"step_{step}.cursor.json")
        try:
            with open(side) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def verify(self, step: int) -> bool:
        """True iff the fallback files for `step` are complete and the data
        file matches its manifest checksum. FLAGS_ckpt_integrity_check=False
        skips the CRC pass (huge checkpoints) but still requires the
        manifest, whose presence certifies the save sequence finished."""
        data, manifest = self._data_path(step), self._manifest_path(step)
        if not (os.path.exists(data) and os.path.exists(manifest)):
            return False
        from .flags import get_flags
        if not get_flags("FLAGS_ckpt_integrity_check")[
                "FLAGS_ckpt_integrity_check"]:
            return True
        try:
            with open(manifest) as f:
                spec = json.load(f)
            return _file_crc(data) == spec["crc32"]
        except (OSError, ValueError, KeyError):
            return False

    def restore(self, step: Optional[int] = None,
                template: Optional[Dict[str, Any]] = None):
        """The state saved under `step` (None: the latest valid step, or
        None when there is none), its tensors on the manager's device.
        `template` is accepted for the JAX signature (the orbax path's)."""
        from .framework_io import load as _load
        if step is not None:
            if not self.verify(step):
                raise ValueError(
                    f"checkpoint step {step} in {self.directory} is missing "
                    "or fails integrity verification (torn write?)")
            return _load(self._data_path(step), device=self.device)
        step = self.latest_step()
        if step is None:
            return None
        return _load(self._data_path(step), device=self.device)

    def all_steps(self) -> list:
        """Steps present on disk (valid, manifest-certified only)."""
        steps = []
        for f in os.listdir(self.directory):
            if not (f.startswith("step_") and f.endswith(".pdckpt")):
                continue
            try:
                steps.append(int(f[len("step_"):-len(".pdckpt")]))
            except ValueError:
                continue  # stray file in our namespace: skip, don't crash
        return sorted(s for s in steps if self.verify(s))

    def latest_step(self) -> Optional[int]:
        """Latest *valid* step: checkpoints that are torn or fail their
        checksum are skipped, not returned."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self):
        """Saves are synchronous: nothing to wait for."""

    def _gc(self):
        valid = self.all_steps()
        # retention floor: the newest manifest-certified step is never
        # collected, whatever max_to_keep says — deleting the only
        # restorable state to satisfy a quota is always the wrong trade
        keep = max(self._max_to_keep, 1)
        while len(valid) > keep:
            s = valid.pop(0)
            for p in (self._data_path(s), self._manifest_path(s)):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass  # a concurrent emergency save may have GC'd it

    def close(self):
        """Nothing is held open between saves."""


# ---- restore-time scrubber ----

def _parse_step_file(fname: str):
    """(step, suffix) for step_<n>.pdckpt / step_<n>.manifest.json, else
    None — strays that don't parse are never treated as candidates."""
    if not fname.startswith("step_"):
        return None
    for suffix in (".pdckpt", ".manifest.json"):
        if fname.endswith(suffix):
            try:
                return int(fname[len("step_"):-len(suffix)]), suffix
            except ValueError:
                return None
    return None


def scrub_checkpoints(directory: str) -> Dict[str, List]:
    """Walk a fallback-layout checkpoint directory, CRC-verify every step
    candidate, and QUARANTINE whatever fails: the step's files (data,
    manifest, stale tmps) move into `step_<n>.corrupt/` so latest_step()
    can never land on them and a human can triage the bytes later
    (docs/fault_tolerance.md § Scrubber runbook). Each quarantine drops a
    `ckpt_corrupt` flight event naming the step and the failing file.
    The CRC pass always runs here (unlike verify(), which honors
    FLAGS_ckpt_integrity_check): this is the once-per-restore moment
    where a certified-but-corrupt step would otherwise become live state.
    Returns {"clean": [steps...], "quarantined": [{step, file, reason}]}.
    Run it BEFORE any writer targets the directory — it treats data
    files without a manifest (in-flight saves included) as torn."""
    from .obs.flight_recorder import flight_recorder
    directory = os.path.abspath(directory)
    try:
        names = os.listdir(directory)
    except OSError:
        return {"clean": [], "quarantined": []}
    steps = set()
    for f in names:
        parsed = _parse_step_file(f)
        if parsed is not None:
            steps.add(parsed[0])
    clean: List[int] = []
    quarantined: List[Dict[str, Any]] = []
    for s in sorted(steps):
        data = os.path.join(directory, f"step_{s}.pdckpt")
        manifest = os.path.join(directory, f"step_{s}.manifest.json")
        bad = None  # (failing file, reason)
        if not os.path.exists(manifest):
            bad = (data, "uncertified: no manifest (torn save)")
        elif not os.path.exists(data):
            bad = (data, "manifest without data file")
        else:
            try:
                with open(manifest) as f:
                    expect = json.load(f)["crc32"]
            except (OSError, ValueError, KeyError) as e:
                bad = (manifest, f"manifest unreadable: {type(e).__name__}")
            else:
                if _file_crc(data) != expect:
                    bad = (data, "crc32 mismatch (torn write / bit rot)")
        if bad is None:
            clean.append(s)
            continue
        qdir = os.path.join(directory, f"step_{s}.corrupt")
        os.makedirs(qdir, exist_ok=True)
        for p in (data, manifest, data + ".tmp", manifest + ".tmp"):
            if os.path.exists(p):
                os.replace(p, os.path.join(qdir, os.path.basename(p)))
        rec = {"step": s, "file": os.path.basename(bad[0]),
               "reason": bad[1]}
        quarantined.append(rec)
        flight_recorder().record("ckpt_corrupt", **rec)
    return {"clean": clean, "quarantined": quarantined}


# ---- certified serving weight sets ----

class UncertifiedWeightsError(ValueError):
    """A serving `WeightSet` failed certification: missing/unreadable
    manifest, missing data file, wrong format, or CRC mismatch. Deploys
    refuse uncertified weights outright — a torn or bit-rotted weight
    file must never reach a live fleet. `reason` is machine-readable
    and mirrors the scrubber's quarantine vocabulary."""

    def __init__(self, msg: str, reason: str = "uncertified"):
        super().__init__(msg)
        self.reason = reason


class WeightSet:
    """A versioned, manifest/CRC-certified serving parameter set.

    The deployable unit of the JAX package's rolling deploys: a params tree
    published as `weights_<version>.pdckpt` + `weights_<version>
    .manifest.json` under the same tmp→fsync→rename, data-first/
    manifest-last protocol as `CheckpointManager.save`, so the manifest's
    presence certifies the write sequence finished and its crc32 pins
    the bytes. `certify()` ALWAYS runs the CRC pass (like
    `scrub_checkpoints`, unlike `verify()`): a deploy is the
    once-per-rollout moment where corrupt weights would otherwise reach
    every replica in the fleet. The manifest may carry a `golden` block
    (canary prompts + expected greedy tokens) published alongside the
    weights by whoever trained them."""

    FORMAT = "pdtpu.weights.v1"

    def __init__(self, directory: str, version: str):
        if not version or not all(
                c.isalnum() or c in "._-" for c in str(version)):
            raise ValueError(
                f"weight version {version!r} must be non-empty and "
                "filesystem-safe ([A-Za-z0-9._-])")
        self.directory = os.path.abspath(directory)
        self.version = str(version)

    @property
    def data_path(self) -> str:
        return os.path.join(self.directory,
                            f"weights_{self.version}.pdckpt")

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory,
                            f"weights_{self.version}.manifest.json")

    @classmethod
    def publish(cls, directory: str, version: str, params,
                golden: Optional[Dict[str, Any]] = None,
                extra: Optional[Dict[str, Any]] = None) -> "WeightSet":
        """Write `params` as a certified weight set. Data lands first
        (tmp → fsync → rename), the manifest last — a crash at any point
        leaves either no manifest (uncertified, refused by deploys) or a
        fully certified pair. `extra` merges additional manifest keys
        (subclass metadata — e.g. the adapter signature) and may not
        shadow the protocol keys."""
        ws = cls(directory, version)
        os.makedirs(ws.directory, exist_ok=True)
        tmp_data = ws.data_path + ".tmp"
        tmp_manifest = ws.manifest_path + ".tmp"
        crc = _write_step_file(params, tmp_data)
        spec = {"version": ws.version, "format": cls.FORMAT,
                "crc32": crc, "time": time.time(),
                "leaves": _leaf_specs(params)}
        if extra:
            clash = set(extra) & set(spec) | ({"golden"} & set(extra))
            if clash:
                raise ValueError(
                    f"extra manifest keys {sorted(clash)} shadow the "
                    "weight-set protocol")
            spec.update(extra)
        if golden is not None:
            spec["golden"] = golden
        with open(tmp_manifest, "w") as f:
            json.dump(spec, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_data, ws.data_path)
        os.replace(tmp_manifest, ws.manifest_path)
        return ws

    def certify(self) -> Dict[str, Any]:
        """Full certification pass: manifest present + readable, format
        recognised, version matches, data present, crc32 matches the
        bytes on disk. Returns the manifest dict; raises
        `UncertifiedWeightsError` (typed, with a scrubber-vocabulary
        `reason`) on any failure."""
        if not os.path.exists(self.manifest_path):
            raise UncertifiedWeightsError(
                f"weight set {self.version!r} in {self.directory} has no "
                "manifest (torn or unfinished publish)",
                reason="no_manifest")
        try:
            with open(self.manifest_path) as f:
                spec = json.load(f)
        except (OSError, ValueError) as e:
            raise UncertifiedWeightsError(
                f"weight set {self.version!r} manifest unreadable: "
                f"{type(e).__name__}", reason="manifest_unreadable")
        if spec.get("format") != self.FORMAT:
            raise UncertifiedWeightsError(
                f"weight set {self.version!r} has unknown format "
                f"{spec.get('format')!r} (expected {self.FORMAT!r})",
                reason="bad_format")
        if spec.get("version") != self.version:
            raise UncertifiedWeightsError(
                f"manifest names version {spec.get('version')!r} but the "
                f"deploy asked for {self.version!r}",
                reason="version_mismatch")
        if not os.path.exists(self.data_path):
            raise UncertifiedWeightsError(
                f"weight set {self.version!r} manifest without data file",
                reason="no_data")
        try:
            expect = int(spec["crc32"])
        except (KeyError, TypeError, ValueError):
            raise UncertifiedWeightsError(
                f"weight set {self.version!r} manifest carries no usable "
                "crc32", reason="manifest_unreadable")
        if _file_crc(self.data_path) != expect:
            raise UncertifiedWeightsError(
                f"weight set {self.version!r} crc32 mismatch "
                "(torn write / bit rot)", reason="crc_mismatch")
        return spec

    def load(self, device=None):
        """Certify, then load the params tree (tensors on `device`, the
        first GPU by default). The only sanctioned way weights reach a
        serving engine."""
        from .framework_io import load as _load
        self.certify()
        return _load(self.data_path, device=device)

    @property
    def golden(self) -> Optional[Dict[str, Any]]:
        """The manifest's golden canary block, if published (certifies as
        a side effect — golden data from an uncertified set is useless)."""
        return self.certify().get("golden")


class AdapterWeightSet(WeightSet):
    """A certified **adapter-only** weight set.

    Same protocol as `WeightSet` (tmp→fsync→rename, manifest-last,
    CRC-certified, optional golden block) with its own format string so
    a base-weight deploy can never accidentally consume an adapter tree
    and vice versa, plus a mandatory `adapter` manifest block carrying
    `tuning.lora.adapter_signature` of the base model the adapter was
    trained against. `certify_for(signature)` is the deploy-side gate:
    full CRC certification AND a field-by-field signature comparison,
    with a typed `UncertifiedWeightsError(reason="adapter_mismatch")`
    refusal when the serving fleet's base model disagrees on rank,
    target modules, layer count or projection dims — a rank-16 adapter
    must never be gathered into a rank-8 bank."""

    FORMAT = "pdtpu.adapter.v1"

    @classmethod
    def publish(cls, directory: str, version: str, params,
                signature: Dict[str, Any],
                golden: Optional[Dict[str, Any]] = None,
                ) -> "AdapterWeightSet":
        if not isinstance(signature, dict) or "rank" not in signature:
            raise ValueError(
                "AdapterWeightSet.publish requires the adapter_signature "
                "dict of the base model (got "
                f"{type(signature).__name__})")
        return super().publish(directory, version, params, golden=golden,
                               extra={"adapter": signature})

    def certify_for(self, signature: Dict[str, Any]) -> Dict[str, Any]:
        """Certify bytes AND bind to a base model: raises a typed
        refusal unless the manifest's adapter signature matches
        `signature` exactly. Returns the manifest dict."""
        spec = self.certify()
        published = spec.get("adapter")
        if not isinstance(published, dict):
            raise UncertifiedWeightsError(
                f"adapter set {self.version!r} manifest carries no "
                "adapter signature", reason="adapter_mismatch")
        diff = sorted(
            k for k in set(published) | set(signature)
            if published.get(k) != signature.get(k))
        if diff:
            pub = {k: published.get(k) for k in diff}
            want = {k: signature.get(k) for k in diff}
            raise UncertifiedWeightsError(
                f"adapter set {self.version!r} was trained against a "
                f"different base model: mismatched field(s) {diff} "
                f"(published {pub!r}, serving {want!r})",
                reason="adapter_mismatch")
        return spec


# ---- continuous checkpointing tier ----

class Snapshot:
    """One off-device train-state snapshot: the host-copied state tree,
    the data-stream cursor, and the monotonic instant it was taken
    (persist lag is measured against it)."""
    __slots__ = ("step", "state", "cursor", "taken_at")

    def __init__(self, step: int, state, cursor=None,
                 taken_at: Optional[float] = None):
        self.step = int(step)
        self.state = state
        self.cursor = cursor
        self.taken_at = time.monotonic() if taken_at is None else taken_at


class AsyncCheckpointManager:
    """Continuous checkpointing: snapshot-to-ring on the step thread,
    persist on a bounded background writer.

    `snapshot(step, state, cursor)` blocks only for the device→host fetch
    (one owned copy per leaf), appends the copy to a small in-memory ring,
    and enqueues it for the writer thread, which persists with the SAME
    tmp→fsync→rename manifest/CRC protocol as `CheckpointManager` — the
    on-disk layout and restore path are identical to the sync tier, so
    `restore()`/`latest_step()`/`verify()` simply delegate. Backpressure
    is typed and explicit: past `max_pending` queued snapshots the OLDEST
    pending one is dropped — never the latest, which is exactly the state
    an emergency save or ring rollback needs — and a `ckpt_lag` flight
    event records the drop. Every snapshot/persist drops `ckpt_snapshot`
    / `ckpt_persist` events, so a flight dump reads as the full pipeline
    timeline.

    The ring additionally serves:
    - `emergency_save()` — persist the newest snapshot synchronously
      (SIGTERM / watchdog escalation: NO device round-trip; never raises);
    - `newest_snapshot()` + `ring_state()` — NaN-rollback state without
      touching disk.

    `scrub()` runs the restore-time scrubber (`scrub_checkpoints`) over
    the directory. This tier is fallback-protocol only (use_orbax=False
    underneath): the manifest machinery is what makes torn background
    persists detectable.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 ring_size: int = 2, max_pending: int = 2, ledger=None,
                 device=None):
        self._sync = CheckpointManager(directory, max_to_keep=max_to_keep,
                                       use_orbax=False, device=device)
        self.directory = self._sync.directory
        # obs.goodput.GoodputLedger (or None): background persist seconds
        # are booked via book_async_checkpoint — a non-phase counter, so
        # the writer thread never breaks the phases-tile-wall invariant
        self.ledger = ledger
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._disk_lock = threading.Lock()  # serializes writer vs emergency
        self._ring: deque = deque(maxlen=max(1, int(ring_size)))
        self._pending: deque = deque()
        self._max_pending = max(1, int(max_pending))
        self._in_flight: Optional[Snapshot] = None
        self._stop = False
        self._stats: Dict[str, Any] = {
            "snapshots": 0, "persisted": 0, "dropped": 0,
            "persist_errors": 0, "emergency_saves": 0,
            "corrupt_quarantined": 0,
            "lag_seconds_total": 0.0, "last_lag_seconds": 0.0,
            "blocking_seconds_total": 0.0, "async_seconds_total": 0.0,
        }
        self._thread = threading.Thread(
            target=self._writer_loop, name="pdtpu-ckpt-writer", daemon=True)
        self._thread.start()

    # ---- snapshot pipeline ----
    def snapshot(self, step: int, state: Dict[str, Any],
                 cursor: Optional[Dict[str, Any]] = None) -> Snapshot:
        """Host-copy `state` (the only blocking work), ring it, enqueue it
        for the background writer. Call at a step boundary."""
        from .obs.flight_recorder import flight_recorder
        t0 = time.perf_counter()
        host = _host_copy(state)
        blocking = time.perf_counter() - t0
        snap = Snapshot(step, host, cursor)
        dropped = None
        with self._cv:
            self._stats["snapshots"] += 1
            self._stats["blocking_seconds_total"] += blocking
            self._ring.append(snap)
            self._pending.append(snap)
            # typed backpressure: the writer fell behind, so shed the
            # OLDEST pending snapshot — never the one just taken
            while len(self._pending) > self._max_pending:
                dropped = self._pending.popleft()
                self._stats["dropped"] += 1
            depth = len(self._pending)
            self._cv.notify()
        flight_recorder().record(
            "ckpt_snapshot", step=snap.step,
            blocking_ms=round(blocking * 1e3, 3), queue_depth=depth)
        if dropped is not None:
            flight_recorder().record(
                "ckpt_lag", dropped_step=dropped.step, newest_step=snap.step,
                queue_depth=depth, policy="drop_oldest_pending")
        return snap

    def _writer_loop(self):
        from .obs.flight_recorder import flight_recorder
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait(timeout=0.2)
                if not self._pending and self._stop:
                    return
                snap = self._pending.popleft()
                self._in_flight = snap
            try:
                self._persist(snap)
            except Exception as e:  # the writer must outlive bad disks
                with self._cv:
                    self._stats["persist_errors"] += 1
                flight_recorder().record(
                    "ckpt_persist_error", step=snap.step,
                    error=f"{type(e).__name__}: {e}"[:200])
            finally:
                with self._cv:
                    self._in_flight = None
                    self._cv.notify_all()

    def _persist(self, snap: Snapshot, emergency: bool = False):
        from .obs.flight_recorder import flight_recorder
        plan = fault_injection.global_plan()
        if not emergency:
            # fault hooks live on the BACKGROUND path only: the emergency
            # path must stay unconditionally fast and unkillable-by-plan
            plan.maybe_kill(snap.step, fault_injection.KILL_POINT_PERSIST)
            plan.maybe_ckpt_stall(snap.step)
        t0 = time.perf_counter()
        with self._disk_lock:
            self._sync.save(snap.step, snap.state, cursor=snap.cursor)
        dt = time.perf_counter() - t0
        lag = time.monotonic() - snap.taken_at
        with self._cv:
            self._stats["persisted"] += 1
            key = ("blocking_seconds_total" if emergency
                   else "async_seconds_total")
            self._stats[key] += dt
            self._stats["lag_seconds_total"] += lag
            self._stats["last_lag_seconds"] = lag
        if self.ledger is not None and not emergency:
            self.ledger.book_async_checkpoint(dt)
        flight_recorder().record(
            "ckpt_persist", step=snap.step, ms=round(dt * 1e3, 3),
            lag_ms=round(lag * 1e3, 3), emergency=emergency)

    # ---- ring services ----
    def newest_snapshot(self) -> Optional[Snapshot]:
        with self._cv:
            return self._ring[-1] if self._ring else None

    def ring_state(self, snap: Snapshot):
        """A restore-shaped copy of a ring snapshot: the same tree a disk
        restore of that snapshot would produce (fresh tensors on the
        manager's device), without touching disk."""
        from .core.device import resolve_device
        return _to_device(snap.state, resolve_device(self.device))

    @property
    def device(self):
        return self._sync.device

    def emergency_save(self) -> Optional[int]:
        """Persist the newest ring snapshot synchronously — the signal
        path: no device round-trip, no queue wait, never raises. Returns
        the persisted step, or None (empty ring / disk failure)."""
        from .obs.flight_recorder import flight_recorder
        with self._cv:
            snap = self._ring[-1] if self._ring else None
            if snap is not None and snap in self._pending:
                self._pending.remove(snap)  # don't persist it twice
        if snap is None:
            return None
        try:
            self._persist(snap, emergency=True)
        except Exception as e:
            with self._cv:
                self._stats["persist_errors"] += 1
            flight_recorder().record(
                "ckpt_persist_error", step=snap.step, emergency=True,
                error=f"{type(e).__name__}: {e}"[:200])
            return None
        with self._cv:
            self._stats["emergency_saves"] += 1
        flight_recorder().record("ckpt_emergency", step=snap.step)
        return snap.step

    # ---- scrub + delegation to the sync tier ----
    def scrub(self) -> Dict[str, List]:
        report = scrub_checkpoints(self.directory)
        if report["quarantined"]:
            with self._cv:
                self._stats["corrupt_quarantined"] += len(
                    report["quarantined"])
        return report

    def save(self, step: int, state: Dict[str, Any], force: bool = False,
             cursor: Optional[Dict[str, Any]] = None):
        """Synchronous escape hatch (same protocol as the writer uses)."""
        with self._disk_lock:
            self._sync.save(step, state, force=force, cursor=cursor)

    def restore(self, step: Optional[int] = None,
                template: Optional[Dict[str, Any]] = None):
        return self._sync.restore(step, template)

    def read_cursor(self, step: int) -> Optional[Dict[str, Any]]:
        return self._sync.read_cursor(step)

    def verify(self, step: int) -> bool:
        return self._sync.verify(step)

    def all_steps(self) -> list:
        return self._sync.all_steps()

    def latest_step(self) -> Optional[int]:
        return self._sync.latest_step()

    def wait_until_finished(self):
        """Block until every queued snapshot has been persisted."""
        with self._cv:
            while self._pending or self._in_flight is not None:
                self._cv.wait(timeout=0.1)

    def stats(self) -> Dict[str, Any]:
        """Counter/gauge snapshot for the pdtpu_train_ckpt_* families."""
        with self._cv:
            s = dict(self._stats)
            s["queue_depth"] = len(self._pending) + (
                1 if self._in_flight is not None else 0)
        return s

    def close(self):
        self.wait_until_finished()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
        self._sync.close()


def save_sharded(state: Dict[str, Any], path: str, shard_id: int = 0,
                 num_shards: int = 1, use_orbax: bool = True):
    """One-shot sharded save, on the JAX package's fallback protocol
    (`use_orbax` is accepted and changes nothing).

    `path` is a DIRECTORY of manifest-certified shards
    under the same torn-write protocol as CheckpointManager — each rank
    writes `shard_<i>.pdckpt` + `shard_<i>.manifest.json` (per-shard
    CRC32 plus its (shard_id, num_shards) coordinates) via
    tmp→fsync→rename, data first, manifest last. A complete manifest SET
    certifies a complete shard set: load_sharded refuses anything less,
    because a shard may be the only copy of its slice of optimizer state
    (the ROADMAP's ZeRO-style sharded update)."""
    shard_id, num_shards = int(shard_id), int(num_shards)
    if not (0 <= shard_id < num_shards):
        raise ValueError(
            f"shard_id {shard_id} out of range for num_shards {num_shards}")
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    data = os.path.join(path, f"shard_{shard_id}.pdckpt")
    manifest = os.path.join(path, f"shard_{shard_id}.manifest.json")
    tmp_data, tmp_manifest = data + ".tmp", manifest + ".tmp"
    crc = _write_step_file(state, tmp_data)
    spec = {"shard": shard_id, "num_shards": num_shards,
            "format": "pdckpt.shard.v1", "crc32": crc,
            "time": time.time(), "leaves": _leaf_specs(state)}
    with open(tmp_manifest, "w") as f:
        json.dump(spec, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_data, data)
    os.replace(tmp_manifest, manifest)


def load_sharded(path: str, template: Optional[Dict[str, Any]] = None,
                 shard_id: Optional[int] = None, use_orbax: bool = True,
                 device=None):
    """Restore a sharded save (tensors on `device`). REFUSES (ValueError) any
    shard set that is not fully certified: missing/unreadable manifests,
    mismatched num_shards across manifests, missing shards, or a data
    file failing its manifest CRC — partial restores of partitioned
    optimizer state are silent corruption, not resilience. `shard_id`
    picks the shard to load (required when num_shards > 1); `template`
    and `use_orbax` are accepted for the JAX signature."""
    from .framework_io import load as _load
    path = os.path.abspath(path)
    if os.path.isfile(path):  # pre-certification single-file layout
        return _load(path, device=device)
    if not os.path.isdir(path):
        raise ValueError(f"no sharded checkpoint at {path}")
    specs: Dict[int, Dict[str, Any]] = {}
    for fname in sorted(os.listdir(path)):
        if not (fname.startswith("shard_")
                and fname.endswith(".manifest.json")):
            continue
        try:
            idx = int(fname[len("shard_"):-len(".manifest.json")])
        except ValueError:
            continue
        try:
            with open(os.path.join(path, fname)) as f:
                specs[idx] = json.load(f)
        except (OSError, ValueError) as e:
            raise ValueError(
                f"refusing sharded restore from {path}: manifest {fname} "
                f"unreadable ({type(e).__name__})")
    if not specs:
        raise ValueError(
            f"refusing sharded restore from {path}: no shard manifests "
            "(uncertified or torn save)")
    counts = {int(s.get("num_shards", -1)) for s in specs.values()}
    if len(counts) != 1:
        raise ValueError(
            f"refusing sharded restore from {path}: mismatched num_shards "
            f"across shard manifests ({sorted(counts)})")
    n = counts.pop()
    missing = [i for i in range(n) if i not in specs]
    if missing:
        raise ValueError(
            f"refusing sharded restore from {path}: missing manifests for "
            f"shards {missing} of {n}")
    for i in range(n):
        data = os.path.join(path, f"shard_{i}.pdckpt")
        if not os.path.exists(data):
            raise ValueError(
                f"refusing sharded restore from {path}: shard {i} has a "
                "manifest but no data file")
        if _file_crc(data) != specs[i]["crc32"]:
            raise ValueError(
                f"refusing sharded restore from {path}: shard {i} fails "
                "its manifest CRC (torn write / bit rot)")
    if shard_id is None:
        if n != 1:
            raise ValueError(
                f"{path} holds {n} shards; pass shard_id to pick one")
        shard_id = 0
    if not (0 <= int(shard_id) < n):
        raise ValueError(f"shard_id {shard_id} out of range for {n} shards")
    return _load(os.path.join(path, f"shard_{int(shard_id)}.pdckpt"),
                 device=device)


# ---- auto-checkpoint epoch-range protocol ----

class _EpochRange:
    def __init__(self, max_epoch: int, ckpt_dir: str, save_fn=None,
                 restore_fn=None):
        self.max_epoch = max_epoch
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)
        self._meta = os.path.join(self.dir, "epoch_meta.json")
        self.save_fn = save_fn
        self.restore_fn = restore_fn

    def _load_meta(self):
        if os.path.exists(self._meta):
            with open(self._meta) as f:
                return json.load(f)
        return {"next_epoch": 0}

    def __iter__(self):
        meta = self._load_meta()
        start = meta["next_epoch"]
        if start > 0 and self.restore_fn is not None:
            self.restore_fn(self.dir, start - 1)
        for epoch in range(start, self.max_epoch):
            yield epoch
            if self.save_fn is not None:
                self.save_fn(self.dir, epoch)
            with open(self._meta, "w") as f:
                json.dump({"next_epoch": epoch + 1,
                           "time": time.time()}, f)


def train_epoch_range(max_epoch: int, checkpoint_dir: str = "./auto_ckpt",
                      save_fn=None, restore_fn=None):
    """auto_checkpoint._get_train_epoch_range analog: iterate epochs, persist
    progress, resume where the last run stopped."""
    return _EpochRange(max_epoch, checkpoint_dir, save_fn, restore_fn)
