"""paddle.distributed.spawn (counterpart of paddle_tpu/distributed/spawn.py):
start `nprocs` processes through `torch.multiprocessing` (the "spawn"
start method), each with the launcher's environment of its rank:
`PADDLE_TRAINER_ID`, `PADDLE_TRAINERS_NUM`, the endpoints from
`started_port`, `FLAGS_selected_gpus` (the rank modulo the GPU count, or
`selected_gpus=` for every rank: `"0"` puts them all on one card) and,
with `init_method=` (`file://<path>` or `tcp://host:port`),
`PADDLE_DIST_INIT_METHOD`, which `init_parallel_env` reads. With `join`
it waits for all of them and raises if any failed, naming the rank and
carrying its traceback.
"""
from __future__ import annotations

import os

import torch
import torch.multiprocessing as mp


def _wrapper(rank, func, nprocs, base_port, gpus, init_method, args):
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    endpoints = ",".join(f"127.0.0.1:{base_port + i}" for i in range(nprocs))
    os.environ["PADDLE_TRAINER_ENDPOINTS"] = endpoints
    os.environ["PADDLE_CURRENT_ENDPOINT"] = f"127.0.0.1:{base_port + rank}"
    if gpus is not None:
        os.environ["FLAGS_selected_gpus"] = str(gpus)
    elif torch.cuda.is_available() and torch.cuda.device_count():
        os.environ["FLAGS_selected_gpus"] = str(
            rank % torch.cuda.device_count())
    if init_method is not None:
        os.environ["PADDLE_DIST_INIT_METHOD"] = init_method
    func(*args)


def spawn(func, args=(), nprocs=1, join=True, daemon=False, **options):
    """Run func(*args) in `nprocs` new processes, one a rank. Options:
    `started_port` (35000), `selected_gpus`, `init_method`. Returns the
    processes' context."""
    base_port = int(options.get("started_port", 35000))
    return mp.start_processes(
        _wrapper, args=(func, nprocs, base_port,
                        options.get("selected_gpus"),
                        options.get("init_method"), tuple(args)),
        nprocs=nprocs, join=join, daemon=daemon, start_method="spawn")
