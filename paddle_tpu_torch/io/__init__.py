"""paddle.io: datasets, samplers and the DataLoader (counterpart of
paddle_tpu/io/__init__.py).

The loader collates on the host. Samples (numpy arrays, numbers, CPU
tensors, and tuples, lists and dicts of them) are stacked with numpy and
wrapped with `torch.from_numpy` into CPU tensors, pinned when a card is
present so that the copy to it can be non-blocking. Nothing here moves a
batch to a device: `hapi.Model` moves each batch to its network's device,
and `io.ChunkPrefetcher` stacks batches into chunks for a train step's
`device_put_chunk`.

Shuffles draw from the port's global RNG state (`core/random.py`): each
draw takes a fresh `torch.Generator` seeded from `next_seed()`, so an
order repeats under `paddle_tpu_torch.seed(s)` and ignores numpy's global
state, as the JAX loader's orders do under `paddle.seed`; the orders
themselves differ from JAX's (`jax.random` is not ported for this).
`DistributedBatchSampler` shuffles with numpy's `RandomState(epoch)`, as
JAX does, so its orders equal JAX's.

`num_workers > 0` runs the batches in a pool of worker processes, forked
as the JAX loader's `mp.Pool` is, one pool an epoch. A worker touches
only the dataset and numpy (a fork made after CUDA is initialised must
not touch the card): it collates with numpy and leaves every array of
`SHM_MIN_BYTES` or more in a shared-memory block of its own, sending
only the block's name through the pool's pipe; the main process maps
the block, copies it into a tensor (pinned when a card is present) and
unlinks it (on the H100 machine's host a 37 MB batch pickled through the
pipe cost several times the workers' compute: `PERF.md` §5, from
`tools/profile_torch_loader.py`). Batches come back in
sampler order; each worker seeds Python's `random` and numpy's global
state from one seed of the epoch plus its id, so random transforms
repeat under `seed(s)`. An `IterableDataset` is read in the main
process, as in JAX.
"""
from __future__ import annotations

import bisect
import collections
import itertools
import multiprocessing as mp
import os
import random
import uuid
from multiprocessing import resource_tracker, shared_memory

import numpy as np
import torch

from ..core.random import next_seed


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    # TypeError (not RuntimeError) so list()/length_hint degrade gracefully
    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not indexable")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equal-length tensors or numpy arrays: sample i is the tuple
    of each one's row i."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(
            itertools.accumulate(len(d) for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ComposeDataset(Dataset):
    """The FIELDS of same-length map-style datasets composed into one
    sample tuple (reference: fluid/dataloader/dataset.py:286)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets should not be empty")
        n = len(self.datasets[0])
        if any(len(d) != n for d in self.datasets[1:]):
            raise ValueError("composed datasets must share one length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            sample.extend(item if isinstance(item, (tuple, list))
                          else [item])
        return tuple(sample)


def _generator(generator=None) -> torch.Generator:
    """`generator`, or a CPU generator seeded from the global state."""
    if generator is not None:
        return generator
    gen = torch.Generator()
    gen.manual_seed(next_seed())
    return gen


def _permutation(n, generator=None):
    return torch.randperm(n, generator=_generator(generator)).tolist()


def random_split(dataset, lengths, generator=None):
    """`dataset` split into Subsets of `lengths` (summing to its length)
    over one random permutation."""
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError(f"lengths sum to {total}, the dataset holds "
                         f"{len(dataset)}")
    indices = _permutation(total, generator)
    out, offset = [], 0
    for ln in lengths:
        out.append(Subset(dataset, indices[offset:offset + ln]))
        offset += ln
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation of the indices (its first `num_samples`), or
    `num_samples` draws with replacement; a new order every epoch."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(torch.randint(
                0, n, (self.num_samples,),
                generator=_generator(self.generator)).tolist())
        return iter(_permutation(n, self.generator)[:self.num_samples])

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """`num_samples` indices drawn with probabilities proportional to
    `weights`."""

    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = torch.from_numpy(self.weights / self.weights.sum())
        return iter(torch.multinomial(p, self.num_samples,
                                      replacement=self.replacement,
                                      generator=_generator()).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """The batches of one rank among `num_replicas` (reference:
    fluid/dataloader/batch_sampler.py). Host only: the rank and the
    number of replicas default to PADDLE_TRAINER_ID and
    PADDLE_TRAINERS_NUM (0 and 1 when unset), as the JAX package's
    defaults read them at degree 1. The indices are padded by wrapping
    to a multiple of the replicas, then strided by rank; `shuffle` draws
    a numpy RandomState(epoch) permutation, as JAX does."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else int(os.getenv("PADDLE_TRAINERS_NUM", "1")))
        self.local_rank = (rank if rank is not None
                           else int(os.getenv("PADDLE_TRAINER_ID", "0")))
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
            self.epoch += 1
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - n)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


def collate_numpy(batch):
    """The JAX `default_collate_fn`'s structure in numpy: tensors, arrays
    and numbers stacked along a new first axis, tuples, lists and dicts
    collated field by field, anything else left as the list it is."""
    sample = batch[0]
    if torch.is_tensor(sample):
        return np.stack([s.detach().cpu().numpy() for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.number, np.bool_)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return type(sample)(collate_numpy(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: collate_numpy([d[k] for d in batch]) for k in sample}
    return batch


def to_tensors(obj, pin=False):
    """Every numeric numpy array in `obj` (nested tuples, lists, dicts)
    wrapped as a CPU tensor without a copy, or copied into pinned memory
    with `pin`."""
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind not in "biufc":
            return obj
        t = torch.from_numpy(np.ascontiguousarray(obj))
        return t.pin_memory() if pin else t
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_tensors(v, pin) for v in obj)
    if isinstance(obj, dict):
        return {k: to_tensors(v, pin) for k, v in obj.items()}
    return obj


def default_collate_fn(batch):
    """A list of samples -> one batch of CPU tensors."""
    return to_tensors(collate_numpy(batch))


class WorkerInfo:
    """What `get_worker_info()` returns inside a loader's worker."""

    def __init__(self, id, num_workers, dataset, seed):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_WORKER = None       # this process's WorkerInfo, in a loader's worker only


def get_worker_info():
    """The calling worker's WorkerInfo (id, num_workers, dataset, seed),
    or None in the main process (where the JAX package always returns
    None)."""
    return _WORKER


def _worker_init(dataset, collate, num_workers, counter, seed, init_fn):
    global _WORKER
    with counter.get_lock():
        wid = counter.value
        counter.value += 1
    random.seed(seed + wid)
    np.random.seed((seed + wid) % 2 ** 32)
    _WORKER = WorkerInfo(wid, num_workers, dataset, seed + wid)
    _WORKER.collate = collate
    if init_fn is not None:
        init_fn(wid)


SHM_MIN_BYTES = 1 << 16   # arrays this big leave a worker in shared memory


class _ShmArray:
    """A numeric array a worker left in the shared-memory block `name`."""

    def __init__(self, name, shape, dtype):
        self.name, self.shape, self.dtype = name, shape, dtype


def _to_shm(obj, prefix, names):
    """obj with every numeric array of SHM_MIN_BYTES or more copied into
    a new shared-memory block named `prefix` + a running number (counted
    in `names`), untracked: the main process unlinks it."""
    if (isinstance(obj, np.ndarray) and obj.nbytes >= SHM_MIN_BYTES
            and obj.dtype.kind in "biufc"):
        shm = shared_memory.SharedMemory(name=f"{prefix}_{len(names)}",
                                         create=True, size=obj.nbytes)
        resource_tracker.unregister(shm._name, "shared_memory")
        names.append(shm.name)
        np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)[...] = obj
        ref = _ShmArray(shm.name, obj.shape, obj.dtype.str)
        shm.close()
        return ref
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_shm(v, prefix, names) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_shm(v, prefix, names) for k, v in obj.items()}
    return obj


def _worker_fetch(indices, prefix):
    out = _WORKER.collate([_WORKER.dataset[i] for i in indices])
    return _to_shm(out, prefix, [])


def _unlink(name):
    """Unlink shared-memory block `name`; False where there is none."""
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return False
    shm.close()
    shm.unlink()
    return True


def _from_shm(obj, pin, tensors):
    """A worker's result with each _ShmArray copied out of its block
    (into a tensor, pinned with `pin`, when `tensors`, else into a numpy
    array) and the block unlinked; with `tensors` the other arrays
    wrapped as `to_tensors` wraps them."""
    if isinstance(obj, _ShmArray):
        shm = shared_memory.SharedMemory(name=obj.name)
        try:
            view = np.ndarray(obj.shape, np.dtype(obj.dtype), buffer=shm.buf)
            if not tensors:
                out = view.copy()
            else:
                t = torch.from_numpy(view)
                out = t.pin_memory() if pin else t.clone()
                del t
            del view
        finally:
            shm.close()
            shm.unlink()
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_shm(v, pin, tensors) for v in obj)
    if isinstance(obj, dict):
        return {k: _from_shm(v, pin, tensors) for k, v in obj.items()}
    return to_tensors(obj, pin) if tensors else obj


def _fork_context():
    methods = mp.get_all_start_methods()
    return mp.get_context("fork" if "fork" in methods else "spawn")


class _MultiWorkerIter:
    """The batches of `batches` (index lists) fetched by a fresh pool of
    `loader.num_workers` processes, `prefetch_factor` batches a worker in
    flight, returned in order."""

    def __init__(self, loader, batches):
        self._loader = loader
        self._batches = enumerate(batches)
        self._window = max(1, loader.prefetch_factor) * loader.num_workers
        self._timeout = loader.timeout or None
        self._prefix = f"pdtt_{os.getpid()}_{uuid.uuid4().hex[:12]}"
        ctx = _fork_context()
        collate = (collate_numpy if loader._default_collate
                   else loader.collate_fn)
        resource_tracker.ensure_running()   # one tracker, shared by forks
        self._pool = ctx.Pool(
            loader.num_workers, initializer=_worker_init,
            initargs=(loader.dataset, collate, loader.num_workers,
                      ctx.Value("i", 0), next_seed() % 2 ** 32,
                      loader.worker_init_fn))
        self._pending = collections.deque()
        self._fill()

    def _fill(self):
        while len(self._pending) < self._window:
            nb = next(self._batches, None)
            if nb is None:
                return
            n, b = nb
            prefix = f"{self._prefix}_{n}"
            self._pending.append((prefix, self._pool.apply_async(
                _worker_fetch, (b, prefix))))

    def __iter__(self):
        return self

    def __next__(self):
        if self._pool is None or not self._pending:
            self.close()
            raise StopIteration
        prefix, result = self._pending.popleft()
        self._fill()
        try:
            out = result.get(self._timeout)
        except BaseException:
            self._pending.appendleft((prefix, result))
            self.close()
            raise
        return _from_shm(out, self._loader._pin,
                         self._loader._default_collate)

    def close(self):
        """Stop the workers and unlink the blocks of every batch not
        taken (idempotent)."""
        if self._pool is None:
            return
        self._pool.terminate()
        self._pool.join()
        self._pool = None
        for prefix, _ in self._pending:
            k = 0
            while _unlink(f"{prefix}_{k}"):
                k += 1
        self._pending.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DataLoader:
    """Batches of `dataset` as CPU tensors (pinned when a card is
    present), from its `batch_sampler`, or a BatchSampler over it with
    `batch_size`, `shuffle` and `drop_last`; an IterableDataset is
    batched as it streams. `collate_fn` replaces the numpy collation
    and its result is returned as it is; `worker_init_fn(worker_id)`
    runs in each worker after its seeding. `places`, `return_list`,
    `use_buffer_reader`, `use_shared_memory` and `persistent_workers`
    are accepted and ignored, as the JAX loader ignores them."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 prefetch_factor=2, persistent_workers=False):
        if num_workers < 0:
            raise ValueError(f"num_workers must be >= 0, got {num_workers}")
        self.dataset = dataset
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._default_collate = collate_fn is None
        self.collate_fn = collate_fn or default_collate_fn
        self._pin = torch.cuda.is_available()
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.num_workers > 0:
            return _MultiWorkerIter(self, list(self.batch_sampler))
        return self._iter_single()

    def _collate(self, samples):
        if self._default_collate:
            return to_tensors(collate_numpy(samples), self._pin)
        return self.collate_fn(samples)

    def _iter_single(self):
        for indices in self.batch_sampler:
            yield self._collate([self.dataset[i] for i in indices])

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield self._collate(batch)


from .prefetch import ChunkPrefetcher  # noqa: E402,F401
