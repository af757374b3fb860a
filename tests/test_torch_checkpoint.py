"""The port's checkpoint module (paddle_tpu_torch/checkpoint.py) against
the JAX package's (paddle_tpu/checkpoint.py) on the CPU.

- Step files cross both ways: what one package's `CheckpointManager` or
  `AsyncCheckpointManager` writes, the other verifies and restores with
  equal values (bf16 included), and the two manifests carry the same leaf
  keys (`jax.tree_util.keystr` strings), shapes, numpy dtype names and
  cursor. The JAX managers are built with `use_orbax=False`: where
  orbax is installed, the JAX default would take it.
- The protocol cases of tests/test_resilient.py and
  tests/test_async_checkpoint.py (torn write, missing manifest, GC floor,
  the scrubber, backpressure, emergency save, cursors, sharded
  refusals, certified weight sets, the epoch range) run on both packages
  and must give the same observable outcome, which is also stated.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.checkpoint as jck
import paddle_tpu_torch.checkpoint as tck
from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
from paddle_tpu_torch.utils import fault_injection as tfi

SIDES = {
    "jax": dict(ck=jck, fi=jfi, fr=jfr, kw={"use_orbax": False},
                async_kw={}),
    "port": dict(ck=tck, fi=tfi, fr=tfr, kw={"device": "cpu"},
                 async_kw={"device": "cpu"}),
}


def _np(x):
    """A restored leaf as numpy (fp32 for bf16), anything else as is."""
    if torch.is_tensor(x):
        return x.float().numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = getattr(x, "data", x)
    if hasattr(x, "dtype") and hasattr(x, "shape"):
        a = np.asarray(x)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return x


def _plain(tree):
    """A restored tree as nested dicts/lists of numpy and Python values."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return _np(tree)


def _assert_trees_equal(a, b):
    a, b = _plain(a), _plain(b)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


# ---- step files cross between the packages ----

def _states(seed=0):
    """The same train-state tree for both packages: bf16 and fp32
    tensors, an int32 tensor, Python ints and floats, a list of str."""
    rng = np.random.RandomState(seed)
    w = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    e = rng.randn(5, 2).astype(np.float32)
    m = rng.randn(3, 4).astype(np.float32)
    idx = np.arange(6, dtype=np.int32).reshape(2, 3)
    jstate = {"model": {"fc.weight": paddle.to_tensor(w),
                        "fc.bias": paddle.to_tensor(b),
                        "emb": paddle.to_tensor(e).astype("bfloat16")},
              "opt": {"0__moment1": paddle.to_tensor(m),
                      "_step_count": 7,
                      "LR_Scheduler": {"last_epoch": 3, "last_lr": 0.1}},
              "idx": paddle.to_tensor(idx), "step": 12,
              "names": ["a", "b"]}
    tstate = {"model": {"fc.weight": torch.from_numpy(w),
                        "fc.bias": torch.from_numpy(b),
                        "emb": torch.from_numpy(e).bfloat16()},
              "opt": {"0__moment1": torch.from_numpy(m),
                      "_step_count": 7,
                      "LR_Scheduler": {"last_epoch": 3, "last_lr": 0.1}},
              "idx": torch.from_numpy(idx), "step": 12,
              "names": ["a", "b"]}
    return {"jax": jstate, "port": tstate}


def _write(side, tier, directory, step, state, cursor):
    s = SIDES[side]
    if tier == "sync":
        mgr = s["ck"].CheckpointManager(directory, max_to_keep=3,
                                        **s["kw"])
        mgr.save(step, state, cursor=cursor)
    else:
        mgr = s["ck"].AsyncCheckpointManager(directory, max_to_keep=3,
                                             **s["async_kw"])
        mgr.snapshot(step, state, cursor=cursor)
        mgr.close()
    with open(os.path.join(directory, f"step_{step}.manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("tier", ["sync", "async"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_step_files_cross_between_packages(tmp_path, writer, tier):
    reader = "port" if writer == "jax" else "jax"
    states = _states()
    cursor = {"next": 12, "pos": 3}
    d = str(tmp_path / "ckpt")
    spec = _write(writer, tier, d, 12, states[writer], cursor)
    mgr = SIDES[reader]["ck"].CheckpointManager(d, **SIDES[reader]["kw"])
    assert mgr.verify(12) and mgr.latest_step() == 12
    assert mgr.read_cursor(12) == cursor
    got = mgr.restore(12)
    _assert_trees_equal(got, states[reader])
    if reader == "port":
        assert got["model"]["emb"].dtype == torch.bfloat16
        assert got["idx"].dtype == torch.int32
    else:
        assert got["model"]["emb"].dtype == paddle.bfloat16
    # the same state written by the reader's package: the same manifest
    own = _write(reader, tier, str(tmp_path / "own"), 12, states[reader],
                 cursor)
    assert spec["leaves"] == own["leaves"]
    assert spec["leaves"]["['model']['emb']"] == {"shape": [5, 2],
                                                  "dtype": "bfloat16"}
    assert spec["leaves"]["['names'][1]"] == {"shape": [],
                                              "dtype": "str"}
    assert spec["leaves"]["['step']"] == {"shape": [], "dtype": "int"}
    assert {k: spec[k] for k in ("step", "format", "cursor")} == \
        {k: own[k] for k in ("step", "format", "cursor")}


def test_leaf_specs_match_jax_keystr_order():
    """Flattening order (dict keys sorted, lists in order, None no leaf)
    and key strings are jax.tree_util's."""
    import jax
    tree = {"b": [1, None, (2.0, "x")], "a": {"z": 3, "y": 4}}
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    got = [tck._keystr(p) for p, _ in tck._leaves_with_path(tree)]
    assert got == want
    assert list(tck._leaf_specs(tree)) == list(jck._leaf_specs(tree))


# ---- the protocol cases, on both packages ----

def _case_fallback_manifest(s, d):
    mgr = s["ck"].CheckpointManager(d, **s["kw"])
    for step in (1, 2, 3):
        mgr.save(step, {"w": float(step), "names": ["a", "b"]})
    with open(mgr._manifest_path(3)) as f:
        spec = json.load(f)
    return [mgr.latest_step(), mgr.restore()["w"], spec["step"],
            "crc32" in spec, spec["leaves"]]


def _case_torn_data(s, d):
    mgr = s["ck"].CheckpointManager(d, **s["kw"])
    mgr.save(1, {"w": 1.0})
    mgr.save(2, {"w": 2.0})
    with open(mgr._data_path(2), "r+b") as f:
        f.truncate(4)
    try:
        mgr.restore(step=2)
        raised = False
    except ValueError:
        raised = True
    return [mgr.verify(2), mgr.latest_step(), mgr.restore()["w"], raised]


def _case_missing_manifest(s, d):
    mgr = s["ck"].CheckpointManager(d, **s["kw"])
    mgr.save(1, {"w": 1.0})
    mgr.save(2, {"w": 2.0})
    os.remove(mgr._manifest_path(2))
    return [mgr.latest_step(), mgr.all_steps()]


def _case_gc_max_to_keep(s, d):
    mgr = s["ck"].CheckpointManager(d, max_to_keep=2, **s["kw"])
    for step in range(1, 6):
        mgr.save(step, {"w": float(step)})
    return [mgr.all_steps(), os.path.exists(mgr._data_path(1)),
            os.path.exists(mgr._manifest_path(1))]


def _case_gc_floor(s, d):
    mgr = s["ck"].CheckpointManager(d, max_to_keep=0, **s["kw"])
    mgr.save(1, {"w": np.ones(2, np.float32)})
    mgr.save(2, {"w": np.full(2, 2.0, np.float32)})
    return [mgr.all_steps(), _np(mgr.restore(2)["w"]).tolist()]


def _case_scrub_corrupt(s, d):
    sync = s["ck"].CheckpointManager(d, max_to_keep=10, **s["kw"])
    sync.save(1, {"w": np.ones(4, np.float32)})
    sync.save(2, {"w": np.full(4, 2.0, np.float32)})
    with open(sync._data_path(2), "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")
    latest = sync.latest_step()
    report = s["ck"].scrub_checkpoints(d)
    q = os.path.join(d, "step_2.corrupt")
    events = [e for e in s["fr"]().snapshot()["events"]
              if e["kind"] == "ckpt_corrupt" and e.get("step") == 2]
    return [latest, report, sorted(os.listdir(q)),
            os.path.exists(sync._data_path(2)), events[-1]["file"]]


def _case_scrub_torn_and_strays(s, d):
    sync = s["ck"].CheckpointManager(d, max_to_keep=10, **s["kw"])
    sync.save(1, {"w": np.ones(4, np.float32)})
    with open(os.path.join(d, "step_3.pdckpt"), "wb") as f:
        f.write(b"partial")
    for stray in ("step_latest.pdckpt", "notes.txt"):
        with open(os.path.join(d, stray), "w") as f:
            f.write("x")
    report = s["ck"].scrub_checkpoints(d)
    return [report, sorted(os.listdir(d)), sync.all_steps()]


def _case_backpressure(s, d):
    mgr = s["ck"].AsyncCheckpointManager(d, max_to_keep=10, max_pending=1,
                                         ring_size=2, **s["async_kw"])
    gate = threading.Event()
    orig = mgr._sync.save

    def gated_save(step, state, force=False, cursor=None):
        gate.wait(timeout=30)
        orig(step, state, force=force, cursor=cursor)

    mgr._sync.save = gated_save
    mgr.snapshot(1, {"w": np.ones(4, np.float32)})
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with mgr._cv:
            if mgr._in_flight is not None and not mgr._pending:
                break
        time.sleep(0.005)
    for step in (2, 3, 4):
        mgr.snapshot(step, {"w": np.full(4, float(step), np.float32)})
    gate.set()
    mgr.wait_until_finished()
    stats = mgr.stats()
    lag = [e for e in s["fr"]().snapshot()["events"]
           if e["kind"] == "ckpt_lag"][-1]
    mgr.close()
    return [stats["dropped"], stats["persisted"], mgr.all_steps(),
            mgr.newest_snapshot().step, lag["policy"], lag["newest_step"]]


def _case_emergency_save(s, d):
    s["fi"].set_global_plan(s["fi"].FaultPlan.from_spec(
        "ckpt_io_stall@1:0.5"))
    try:
        mgr = s["ck"].AsyncCheckpointManager(d, max_to_keep=10,
                                             **s["async_kw"])
        mgr.snapshot(1, {"w": np.ones(4, np.float32)})
        mgr.snapshot(2, {"w": np.full(4, 2.0, np.float32)})
        saved = mgr.emergency_save()
        latest = mgr.latest_step()     # before the writer woke up
        mgr.wait_until_finished()
        stats = mgr.stats()
        kinds = {e["kind"] for e in s["fr"]().snapshot()["events"]}
        mgr.close()
    finally:
        s["fi"].set_global_plan(None)
    return [saved, latest, stats["emergency_saves"], stats["persisted"],
            sorted(mgr.all_steps()), stats["blocking_seconds_total"] > 0,
            "ckpt_emergency" in kinds]


def _case_emergency_empty(s, d):
    mgr = s["ck"].AsyncCheckpointManager(d, **s["async_kw"])
    out = mgr.emergency_save()
    mgr.close()
    return [out]


def _case_cursor_roundtrip(s, d):
    mgr = s["ck"].AsyncCheckpointManager(d, max_to_keep=10,
                                         **s["async_kw"])
    state = {"w": np.arange(8, dtype=np.float32), "meta": {"k": 3}}
    cursor = {"next": 2, "pos": 7}
    mgr.snapshot(2, state, cursor=cursor)
    state["w"][:] = -1.0           # the ring copy must be owned
    mgr.wait_until_finished()
    disk = mgr.restore(2)
    ring = mgr.ring_state(mgr.newest_snapshot())
    stats = mgr.stats()
    mgr.close()
    return [mgr.all_steps(), mgr.verify(2), mgr.read_cursor(2),
            _np(disk["w"]).tolist(), _np(ring["w"]).tolist(),
            disk["meta"], ring["meta"],
            [stats[k] for k in ("snapshots", "persisted", "dropped",
                                "queue_depth")],
            stats["blocking_seconds_total"] > 0]


def _raises(fn, d):
    """The ValueError `fn` raises, with the directory `d` in its text
    replaced, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e).replace(d, "<dir>")
    return None


def _case_sharded(s, d):
    ck, kw = s["ck"], {"use_orbax": False}
    lkw = dict(kw, **({"device": "cpu"} if ck is tck else {}))
    path = os.path.join(d, "sharded")
    s0 = {"w": np.arange(4, dtype=np.float32)}
    s1 = {"w": np.arange(4, 8, dtype=np.float32)}
    ck.save_sharded(s0, path, shard_id=0, num_shards=2, **kw)
    ck.save_sharded(s1, path, shard_id=1, num_shards=2, **kw)
    out = [_np(ck.load_sharded(path, shard_id=1, **lkw)["w"]).tolist(),
           _raises(lambda: ck.load_sharded(path, **lkw), d)]
    m1 = os.path.join(path, "shard_1.manifest.json")
    os.rename(m1, m1 + ".bak")
    out.append(_raises(lambda: ck.load_sharded(path, shard_id=0, **lkw), d))
    os.rename(m1 + ".bak", m1)
    with open(os.path.join(path, "shard_0.pdckpt"), "r+b") as f:
        f.write(b"\x00\x01\x02\x03")
    out.append(_raises(lambda: ck.load_sharded(path, shard_id=1, **lkw),
                       d))
    empty = os.path.join(d, "empty")
    os.makedirs(empty)
    out.append(_raises(lambda: ck.load_sharded(empty, **lkw), d))
    mixed = os.path.join(d, "mixed")
    ck.save_sharded(s0, mixed, shard_id=0, num_shards=2, **kw)
    ck.save_sharded(s1, mixed, shard_id=1, num_shards=3, **kw)
    out.append(_raises(lambda: ck.load_sharded(mixed, shard_id=0, **lkw),
                       d))
    return out


def _case_rng_cursor(s, d):
    rs = np.random.RandomState(7)
    rs.randn(16)
    cur = s["ck"].rng_cursor(rs)
    expect = rs.randn(8)
    rs.randn(100)
    s["ck"].restore_rng(rs, cur)
    return [json.dumps(cur), np.array_equal(rs.randn(8), expect)]


def _case_epoch_range(s, d):
    seen, saved, restored = [], [], []

    def save_fn(directory, epoch):
        saved.append(epoch)

    def restore_fn(directory, epoch):
        restored.append(epoch)

    for epoch in s["ck"].train_epoch_range(3, d, save_fn, restore_fn):
        seen.append(epoch)
        if epoch == 1:
            break                    # preempted inside epoch 1
    for epoch in s["ck"].train_epoch_range(3, d, save_fn, restore_fn):
        seen.append(epoch)
    return [seen, saved, restored]


def _case_weight_set(s, d):
    ck = s["ck"]
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    ws = ck.WeightSet.publish(d, "v1", params, golden={"prompts": [[1]]})
    spec = ws.certify()
    loaded = ws.load(**({"device": "cpu"} if ck is tck else {}))
    reasons = []
    with open(ws.data_path, "r+b") as f:
        f.write(b"\x00\x00")
    for w in (ws, ck.WeightSet(d, "v2")):
        try:
            w.certify()
        except ck.UncertifiedWeightsError as e:
            reasons.append(e.reason)
    ad = ck.AdapterWeightSet.publish(d, "a1", params, {"rank": 4})
    try:
        ad.certify_for({"rank": 8})
    except ck.UncertifiedWeightsError as e:
        reasons.append(e.reason)
    return [spec["format"], spec["golden"], spec["leaves"],
            _np(loaded["w"]).tolist(), reasons,
            ad.certify_for({"rank": 4})["adapter"]]


CASES = {
    "fallback_manifest": (_case_fallback_manifest, lambda r: r[:4] == [
        3, 3.0, 3, True]),
    "torn_data": (_case_torn_data, lambda r: r == [False, 1, 1.0, True]),
    "missing_manifest": (_case_missing_manifest,
                         lambda r: r == [1, [1]]),
    "gc_max_to_keep": (_case_gc_max_to_keep,
                       lambda r: r == [[4, 5], False, False]),
    "gc_floor": (_case_gc_floor, lambda r: r == [[2], [2.0, 2.0]]),
    "scrub_corrupt": (_case_scrub_corrupt, lambda r: r[0] == 1
                      and r[1]["clean"] == [1]
                      and r[1]["quarantined"][0]["step"] == 2
                      and "crc32 mismatch" in r[1]["quarantined"][0]
                      ["reason"] and r[2] == ["step_2.manifest.json",
                                             "step_2.pdckpt"]
                      and r[3] is False and r[4] == "step_2.pdckpt"),
    "scrub_torn_and_strays": (_case_scrub_torn_and_strays, lambda r:
                              r[0]["clean"] == [1]
                              and "no manifest" in r[0]["quarantined"][0]
                              ["reason"] and "step_latest.pdckpt" in r[1]
                              and "notes.txt" in r[1] and r[2] == [1]),
    "backpressure": (_case_backpressure, lambda r: r == [
        2, 2, [1, 4], 4, "drop_oldest_pending", 4]),
    "emergency_save": (_case_emergency_save, lambda r: r == [
        2, 2, 1, 2, [1, 2], True, True]),
    "emergency_empty": (_case_emergency_empty, lambda r: r == [None]),
    "cursor_roundtrip": (_case_cursor_roundtrip, lambda r: r[:5] == [
        [2], True, {"next": 2, "pos": 7}, list(range(8)), list(range(8))]
        and r[7] == [1, 1, 0, 0] and r[8]),
    "sharded": (_case_sharded, lambda r: r[0] == [4.0, 5.0, 6.0, 7.0]
                and all(r[1:])),
    "rng_cursor": (_case_rng_cursor, lambda r: r[1]),
    "epoch_range": (_case_epoch_range, lambda r: r == [
        [0, 1, 1, 2], [0, 1, 2], [0]]),
    "weight_set": (_case_weight_set, lambda r: r[4] == [
        "crc_mismatch", "no_manifest", "adapter_mismatch"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_protocol_case_matches_jax(tmp_path, case):
    fn, expected = CASES[case]
    out = {}
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        os.makedirs(d)
        out[side] = fn(SIDES[side], d)
    assert out["port"] == out["jax"]
    assert expected(out["port"]), out["port"]
