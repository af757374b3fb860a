"""The port's `io` (datasets, samplers, collation, DataLoader,
ChunkPrefetcher) against the JAX package's, on the CPU.

- Every dataset class gives JAX's samples; `random_split` JAX's lengths
  over a permutation of the indices.
- Index lists equal JAX's for `shuffle=False`, with `drop_last` both
  ways, and for `DistributedBatchSampler` at (rank, replicas) in {(0,
  1), (1, 3)}, shuffled too (both draw numpy RandomState(epoch)).
- The random samplers (the port's own draws, from its global state; the
  orders are not JAX's) give permutations or draws in range, repeated
  under `seed(s)`.
- Collation of tuples, dicts and nests equals JAX's values exactly (the
  port's batches are CPU tensors; int64 where JAX's are int32).
- `num_workers=2` gives exactly the batches of `num_workers=0`, and an
  IterableDataset streams in order.
- `ChunkPrefetcher` equals the JAX one on one source: the chunks, the
  dropped steps, and `close()`.
"""
import os
import time

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU)


def _arrays(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.randint(0, 5, (n,)).astype(np.int64))


def _both(x, y):
    import paddle_tpu as paddle
    from paddle_tpu.io import TensorDataset as JTD
    from paddle_tpu_torch.io import TensorDataset
    return (JTD([paddle.to_tensor(x), paddle.to_tensor(y)]),
            TensorDataset([torch.from_numpy(x), torch.from_numpy(y)]))


def _np(a):
    if torch.is_tensor(a):
        return a.numpy()
    return np.asarray(a.numpy() if hasattr(a, "numpy") else a)


def _same_samples(jds, tds):
    assert len(jds) == len(tds)
    for i in range(len(jds)):
        js, ts = jds[i], tds[i]
        assert len(js) == len(ts)
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(_np(b), _np(a))


def test_dataset_classes_match_jax():
    import paddle_tpu.io as jio
    import paddle_tpu_torch.io as tio
    x, y = _arrays()
    jds, tds = _both(x, y)
    _same_samples(jds, tds)
    _same_samples(jio.Subset(jds, [3, 1, 7]), tio.Subset(tds, [3, 1, 7]))
    x2, y2 = _arrays(4, seed=1)
    jds2, tds2 = _both(x2, y2)
    jc, tc = jio.ConcatDataset([jds, jds2]), tio.ConcatDataset([tds, tds2])
    assert tc.cumulative_sizes == jc.cumulative_sizes == [10, 14]
    _same_samples(jc, tc)
    _same_samples(jio.ComposeDataset([jds, jds]),
                  tio.ComposeDataset([tds, tds]))
    with pytest.raises(ValueError):
        tio.ComposeDataset([tds, tds2])

    class Stream(tio.IterableDataset):
        def __iter__(self):
            yield from range(5)

    assert list(tio.ChainDataset([Stream(), Stream()])) == \
        list(range(5)) * 2
    with pytest.raises(TypeError):
        len(Stream())
    with pytest.raises(TypeError):
        Stream()[0]
    # numpy arrays make a TensorDataset too
    np.testing.assert_array_equal(tio.TensorDataset([x, y])[2][0], x[2])


def test_random_split_lengths_and_repeat():
    import paddle_tpu as paddle
    import paddle_tpu.io as jio
    import paddle_tpu_torch
    import paddle_tpu_torch.io as tio
    x, y = _arrays(12)
    jds, tds = _both(x, y)
    paddle.seed(3)
    jparts = jio.random_split(jds, [5, 4, 3])
    paddle_tpu_torch.seed(3)
    parts = tio.random_split(tds, [5, 4, 3])
    assert [len(p) for p in parts] == [len(p) for p in jparts] == [5, 4, 3]
    idx = sum((list(p.indices) for p in parts), [])
    assert sorted(idx) == list(range(12))
    paddle_tpu_torch.seed(3)
    assert [list(p.indices) for p in tio.random_split(tds, [5, 4, 3])] == \
        [list(p.indices) for p in parts]
    with pytest.raises(ValueError):
        tio.random_split(tds, [5, 5])


@pytest.mark.parametrize("drop_last", [False, True])
def test_sequential_batches_match_jax(drop_last):
    import paddle_tpu.io as jio
    import paddle_tpu_torch.io as tio
    x, y = _arrays(10)
    jds, tds = _both(x, y)
    for bs in (3, 4, 10, 11):
        jb = list(jio.BatchSampler(jds, batch_size=bs, drop_last=drop_last))
        tb = list(tio.BatchSampler(tds, batch_size=bs, drop_last=drop_last))
        assert tb == jb
        assert len(tio.BatchSampler(tds, batch_size=bs,
                                    drop_last=drop_last)) == len(jb)
    assert list(tio.SequenceSampler(tds)) == list(jio.SequenceSampler(jds))


@pytest.mark.parametrize("rank,replicas", [(0, 1), (1, 3)])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_matches_jax(rank, replicas, drop_last):
    import paddle_tpu.io as jio
    import paddle_tpu_torch.io as tio
    x, y = _arrays(11)
    jds, tds = _both(x, y)
    for shuffle in (False, True):
        kw = dict(batch_size=2, num_replicas=replicas, rank=rank,
                  shuffle=shuffle, drop_last=drop_last)
        js, ts = jio.DistributedBatchSampler(jds, **kw), \
            tio.DistributedBatchSampler(tds, **kw)
        for _ in range(2):          # two epochs: the shuffle moves on
            assert list(ts) == list(js)
        assert len(ts) == len(js)
        ts.set_epoch(7)
        js.set_epoch(7)
        assert list(ts) == list(js)


def test_distributed_batch_sampler_reads_rank_from_environment(monkeypatch):
    import paddle_tpu_torch.io as tio
    x, y = _arrays(6)
    ds = tio.TensorDataset([x, y])
    assert list(tio.DistributedBatchSampler(ds, 6)) == [list(range(6))]
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    assert list(tio.DistributedBatchSampler(ds, 6)) == [[1, 3, 5]]


def test_random_samplers_are_draws_that_repeat_under_seed():
    import paddle_tpu_torch
    import paddle_tpu_torch.io as tio
    x, y = _arrays(9)
    ds = tio.TensorDataset([x, y])

    def draws():
        perm = list(tio.RandomSampler(ds))
        part = list(tio.RandomSampler(ds, num_samples=4))
        rep = list(tio.RandomSampler(ds, replacement=True, num_samples=20))
        w = list(tio.WeightedRandomSampler([0, 1, 2, 0, 3], 12))
        wo = list(tio.WeightedRandomSampler([0, 1, 2, 0, 3], 3,
                                            replacement=False))
        shuffled = list(tio.BatchSampler(ds, shuffle=True, batch_size=4))
        return perm, part, rep, w, wo, shuffled

    paddle_tpu_torch.seed(11)
    perm, part, rep, w, wo, shuffled = draws()
    assert sorted(perm) == list(range(9)) and perm != list(range(9))
    assert len(part) == 4 and len(set(part)) == 4
    assert len(rep) == 20 and all(0 <= i < 9 for i in rep)
    assert len(w) == 12 and set(w) <= {1, 2, 4}
    assert sorted(wo) == [1, 2, 4]
    assert sorted(sum(shuffled, [])) == list(range(9))
    paddle_tpu_torch.seed(11)
    assert draws() == (perm, part, rep, w, wo, shuffled)
    # the next epoch draws a new order
    assert draws()[0] != perm
    g = torch.Generator()
    g.manual_seed(0)
    fixed = tio.RandomSampler(ds, generator=g)
    assert sorted(fixed) == list(range(9))


def _collate_cases():
    rng = np.random.RandomState(5)
    a = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(4)]
    labels = [int(v) for v in rng.randint(0, 9, 4)]
    floats = [float(v) for v in rng.standard_normal(4)]
    return {
        "tuple": [(a[i], labels[i]) for i in range(4)],
        "dict": [{"img": a[i], "y": labels[i], "w": floats[i]}
                 for i in range(4)],
        "nested": [([a[i], (labels[i], floats[i])], {"k": a[i] * 2})
                   for i in range(4)],
    }


def _assert_same_tree(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    else:
        assert torch.is_tensor(got) and got.device.type == "cpu"
        w = np.asarray(want.numpy())
        assert got.shape == w.shape
        np.testing.assert_array_equal(got.numpy().astype(w.dtype), w)


@pytest.mark.parametrize("case", ["tuple", "dict", "nested"])
def test_collate_matches_jax(case):
    from paddle_tpu.io import default_collate_fn as jax_collate
    from paddle_tpu_torch.io import default_collate_fn
    batch = _collate_cases()[case]
    _assert_same_tree(default_collate_fn(batch), jax_collate(batch))


def test_loader_batches_match_jax_and_workers_match_none():
    import paddle_tpu.io as jio
    import paddle_tpu_torch.io as tio
    x, y = _arrays(10)
    jds, tds = _both(x, y)
    want = [tuple(_np(t) for t in b)
            for b in jio.DataLoader(jds, batch_size=4)]
    loader = tio.DataLoader(tds, batch_size=4)
    assert len(loader) == 3
    got = [tuple(t.numpy() for t in b) for b in loader]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    # two worker processes, batches in order, the same bits; numpy
    # samples (a dict) through the workers' numpy collation
    dict_ds = [{"x": x[i], "y": int(y[i])} for i in range(10)]
    for ds, cast in ((tds, tuple), (dict_ds, dict)):
        one = list(tio.DataLoader(ds, batch_size=3, drop_last=True))
        two = list(tio.DataLoader(ds, batch_size=3, drop_last=True,
                                  num_workers=2))
        assert len(one) == len(two) == 3
        for a, b in zip(one, two):
            assert isinstance(b, cast)
            for k in (range(2) if cast is tuple else ("x", "y")):
                assert torch.is_tensor(b[k])
                assert torch.equal(a[k], b[k])
    with pytest.raises(ValueError):
        tio.DataLoader(tds, num_workers=-1)


def _worker_ids(samples):
    from paddle_tpu_torch.io import get_worker_info
    return [(get_worker_info().id, os.environ.get("PDTT_TEST_INIT"))
            for _ in samples]


def _mark_worker(worker_id):
    os.environ["PDTT_TEST_INIT"] = f"w{worker_id}"


def test_workers_know_their_id_and_stop_on_error():
    import paddle_tpu_torch.io as tio
    assert tio.get_worker_info() is None
    ids = sum((b for b in tio.DataLoader(list(range(8)), batch_size=2,
                                         num_workers=2,
                                         collate_fn=_worker_ids,
                                         worker_init_fn=_mark_worker)), [])
    assert len(ids) == 8
    assert all(w in (0, 1) and mark == f"w{w}" for w, mark in ids)
    assert "PDTT_TEST_INIT" not in os.environ      # ran in the workers only

    class Bad(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("sample 2")
            return np.float32(i)

    it = iter(tio.DataLoader(Bad(), batch_size=2, num_workers=2))
    assert next(it).tolist() == [0.0, 1.0]
    with pytest.raises(KeyError, match="sample 2"):
        next(it)
    assert it._pool is None


def _blocks(prefix):
    return [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]


@pytest.mark.skipif(not os.path.isdir("/dev/shm"),
                    reason="POSIX shared memory lives in /dev/shm on Linux")
def test_worker_batches_cross_in_shared_memory_and_are_unlinked():
    """Arrays of SHM_MIN_BYTES or more leave the workers in shared memory
    (small ones through the pipe); every block is unlinked once taken,
    and those of batches not taken when the iterator closes."""
    import paddle_tpu_torch.io as tio
    rng = np.random.RandomState(8)
    big = rng.standard_normal((12, 64, 64)).astype(np.float32)  # 16 KB rows
    ds = tio.TensorDataset([big, np.arange(12)])
    assert big[:4].nbytes >= tio.SHM_MIN_BYTES > big[:1].nbytes
    it = iter(tio.DataLoader(ds, batch_size=4, num_workers=2))
    got = [b for b in it]
    for i, (x, n) in enumerate(got):
        np.testing.assert_array_equal(x.numpy(), big[4 * i:4 * i + 4])
        np.testing.assert_array_equal(n.numpy(), np.arange(4 * i, 4 * i + 4))
    assert _blocks(it._prefix) == []
    names = list(tio.DataLoader(ds, batch_size=4, num_workers=2,
                                collate_fn=tio.collate_numpy))
    assert isinstance(names[0][0], np.ndarray)     # custom collate: numpy
    it = iter(tio.DataLoader(ds, batch_size=4, num_workers=2))
    next(it)
    deadline = time.monotonic() + 10
    while len(_blocks(it._prefix)) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)              # the workers fill the window
    assert _blocks(it._prefix)
    it.close()
    assert _blocks(it._prefix) == []


def test_iterable_dataset_streams_in_order():
    import paddle_tpu.io as jio
    import paddle_tpu_torch.io as tio

    def stream(base):
        class S(base):
            def __iter__(self):
                for i in range(7):
                    yield np.full((2,), i, np.float32), i
        return S()

    for drop_last in (False, True):
        want = list(jio.DataLoader(stream(jio.IterableDataset), batch_size=3,
                                   drop_last=drop_last))
        got = list(tio.DataLoader(stream(tio.IterableDataset), batch_size=3,
                                  drop_last=drop_last, num_workers=2))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), _np(w[0]))
            np.testing.assert_array_equal(g[1].numpy(), _np(w[1]))
    with pytest.raises(TypeError):
        len(tio.DataLoader(stream(tio.IterableDataset)))


def test_chunk_prefetcher_matches_jax():
    import warnings

    from paddle_tpu.io import ChunkPrefetcher as JaxPrefetcher
    from paddle_tpu_torch.io import ChunkPrefetcher
    rng = np.random.RandomState(2)
    batches = [(rng.standard_normal((2, 3)).astype(np.float32),
                rng.randint(0, 9, (2,)).astype(np.int32)) for _ in range(7)]
    torch_batches = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with JaxPrefetcher(batches, scan_steps=3,
                           put_fn=lambda s: s) as jp:
            want = list(jp)
        with ChunkPrefetcher(torch_batches, scan_steps=3,
                             put_fn=lambda s: s) as tp:
            got = list(tp)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w) == 2
        for a, b in zip(g, w):
            assert a.shape == (3,) + b.shape[1:]
            np.testing.assert_array_equal(a, b)
    assert tp.dropped_steps == jp.dropped_steps == 1
    assert tp.chunks_produced == jp.chunks_produced == 2
    # close() mid-stream stops the producer; a closed prefetcher is empty
    tp = ChunkPrefetcher(torch_batches, scan_steps=1, put_fn=lambda s: s,
                         depth=1)
    next(iter(tp))
    tp.close()
    assert tp._thread is None and list(tp) == []
    for bad in (dict(scan_steps=0), dict(scan_steps=1, depth=0),
                dict(scan_steps=1, stall_timeout_s=0)):
        with pytest.raises(ValueError):
            ChunkPrefetcher(batches, put_fn=lambda s: s, **bad)


def test_chunk_prefetcher_feeds_scan_train_step():
    """The prefetcher's chunks through the step's device_put_chunk: the
    losses equal the step fed the stacked arrays directly."""
    from paddle_tpu_torch.core.device import NoCUDADeviceError
    from paddle_tpu_torch.io import ChunkPrefetcher
    from paddle_tpu_torch.nn import CrossEntropyLoss, Linear
    from paddle_tpu_torch.nn.layer.layers import init_parameters
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import ScanTrainStep, stack_batches
    rng = np.random.RandomState(4)
    batches = [(rng.standard_normal((4, 6)).astype(np.float32),
                rng.randint(0, 3, (4,)).astype(np.int64)) for _ in range(4)]
    losses = []
    for fed in ("prefetcher", "direct"):
        m = Linear(6, 3, device="cpu")
        init_parameters(m, torch.Generator().manual_seed(1))
        step = ScanTrainStep(m, Adam(learning_rate=0.1,
                                     parameters=m.parameters()),
                             scan_steps=2, loss_fn=CrossEntropyLoss(),
                             device="cpu")
        if fed == "prefetcher":
            with ChunkPrefetcher(batches, 2,
                                 put_fn=step.device_put_chunk) as pf:
                chunks = list(pf)
            assert all(torch.is_tensor(a) for c in chunks for a in c)
        else:
            chunks = [stack_batches(batches[:2]), stack_batches(batches[2:])]
        losses.append(torch.cat([step(*c) for c in chunks]))
    assert torch.equal(losses[0], losses[1])
    if not torch.cuda.is_available():
        with pytest.raises(NoCUDADeviceError):
            ChunkPrefetcher(batches, 2)
