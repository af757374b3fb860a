"""Process environment (counterpart of paddle_tpu/distributed/parallel_env.py).

One process a rank. `ParallelEnv` reads the launcher's variables
(`PADDLE_TRAINER_ID`, `PADDLE_TRAINERS_NUM`, `PADDLE_TRAINER_ENDPOINTS`,
`PADDLE_CURRENT_ENDPOINT`, `FLAGS_selected_gpus`), and
`init_parallel_env()` starts `torch.distributed` from them:

- the device is CUDA (this rank's GPU: `FLAGS_selected_gpus`, else the
  rank modulo the GPU count) unless the caller passes `device="cpu"`;
  without a GPU it raises;
- the backend follows from the layout, in `choose_backend`: every rank
  writes its placement (host name and device) into the rendezvous store
  and reads the others', so all take the same backend; `nccl` when every
  rank has a GPU of its own, `gloo` on the CPU or when ranks share a
  card (NCCL refuses two ranks of one communicator on one device);
  nothing falls back from one to the other;
- the rendezvous is `init_method` (or `PADDLE_DIST_INIT_METHOD`):
  `file://<path>` (a FileStore, as the tests and `spawn` use) or
  `tcp://host:port`; without one, the first trainer endpoint. A world of
  one rank needs none: it takes an in-memory store unless `init_method`
  is passed.

The JAX function starts `jax.distributed` (one process a host) and is a
no-op in one process; this one starts a process group at any world size,
so the collectives always have one.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from ..core.device import resolve_device


class ParallelEnv:
    """paddle.distributed.ParallelEnv: the launcher's view of this rank
    (the process group's once it is started)."""

    def __init__(self):
        self._rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self._device_id = int(os.getenv("FLAGS_selected_gpus", "-1"))
        endpoints = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = endpoints.split(",") if endpoints else []
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def rank(self):
        return dist.get_rank() if dist.is_initialized() else self._rank

    @property
    def world_size(self):
        return (dist.get_world_size() if dist.is_initialized()
                else self._world_size)

    @property
    def device_id(self):
        """This rank's GPU: FLAGS_selected_gpus, else the rank modulo the
        number of GPUs (0 without one)."""
        if self._device_id >= 0:
            return self._device_id
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return self._rank % n if n else 0

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    @property
    def current_endpoint(self):
        return self._current_endpoint

    # legacy aliases
    local_rank = rank
    nranks = world_size


_STATE = {"device": None, "backend": None}


def choose_backend(placements) -> str:
    """The one place the backend is chosen, from every rank's placement
    ("host/device", e.g. "node0/cuda:3"): gloo when a rank is on the CPU
    or two ranks share a device, nccl when every rank has a GPU of its
    own (on one host or on several)."""
    if any(not p.split("/", 1)[1].startswith("cuda") for p in placements):
        return "gloo"
    return "nccl" if len(set(placements)) == len(placements) else "gloo"


def _placements(store, rank, world_size, mine):
    """Every rank's placement, in rank order, through the store."""
    keys = [f"pdtt_placement/{r}" for r in range(world_size)]
    store.set(keys[rank], mine)
    store.wait(keys)
    return [store.get(k).decode() for k in keys]


def init_parallel_env(device=None, init_method=None, backend=None):
    """Start the process group of this rank (idempotent) and return the
    ParallelEnv. `device`: None or "cuda" -> this rank's GPU (raises
    without one), "cpu" -> the CPU; `backend` must be what
    `choose_backend` gives for the layout when passed (a one-rank group
    on a GPU may ask for either)."""
    env = ParallelEnv()
    if dist.is_initialized():
        return env
    dev = torch.device(device) if device is not None else None
    if dev is None or (dev.type == "cuda" and dev.index is None):
        dev = resolve_device("cuda")        # raises without a GPU
        dev = torch.device("cuda", env.device_id)
    else:
        dev = resolve_device(dev)
    n, rank = env.world_size, env.rank
    if init_method is None and n > 1:
        init_method = os.getenv("PADDLE_DIST_INIT_METHOD")
        if init_method is None and env.trainer_endpoints:
            init_method = f"tcp://{env.trainer_endpoints[0]}"
        if init_method is None:
            raise ValueError(
                f"{n} ranks need a rendezvous: pass init_method= "
                "(file://... or tcp://...), set PADDLE_DIST_INIT_METHOD, "
                "or PADDLE_TRAINER_ENDPOINTS")
    if init_method is None:
        store, rank, n = dist.HashStore(), 0, 1
    else:
        store, rank, n = next(dist.rendezvous(init_method, rank=rank,
                                              world_size=n))
    chosen = choose_backend(_placements(store, rank, n,
                                        f"{socket.gethostname()}/{dev}"))
    if backend is not None and backend != chosen and not (
            n == 1 and dev.type == "cuda"):
        raise ValueError(f"backend {backend!r} does not fit {n} ranks on "
                         f"{dev} (the layout gives {chosen!r})")
    backend = backend or chosen
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            **kw)
    _STATE.update(device=dev, backend=backend)
    return env


def current_device() -> torch.device:
    """The device `init_parallel_env` gave this rank (raises before)."""
    if _STATE["device"] is None:
        raise RuntimeError("call init_parallel_env (or fleet.init) first")
    return _STATE["device"]


def get_rank(group=None):
    if group is not None:
        return group.get_group_rank(ParallelEnv().rank)
    return ParallelEnv().rank


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    return ParallelEnv().world_size


def is_initialized():
    return dist.is_initialized()
