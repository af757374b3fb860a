"""Which collectives ProcessGroupGloo takes on CUDA tensors, by dtype.

Two ranks on one GPU over gloo, each collective on fp32, bf16 and fp16
tensors of `cuda:0`, and a one-rank NCCL group. A collective that gloo
cannot take on a CUDA tensor may abort the process (gloo writes the
device pointer to its socket), so each pair of ranks logs the case it
starts, and a pair that dies marks that case "crash" and the next pair
goes on after it. Prints one JSON object {"torch": ..., "cuda": ...,
"gloo_cuda": {"op/dtype": "ok", the error, or "crash"}, "nccl_one_rank":
"ok" or the error}. Run on the machine with the card:

    python tools/probe_gloo_cuda.py
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _cases(rank, n, dt, dev):
    x = (torch.arange(4, dtype=torch.float32) + rank + 1).to(dt).to(dev)
    half = [x[:2].clone(), x[2:].clone()]
    return {
        "all_reduce_sum": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(x.clone(),
                                                  op=dist.ReduceOp.MAX),
        "all_reduce_min": lambda: dist.all_reduce(x.clone(),
                                                  op=dist.ReduceOp.MIN),
        "all_reduce_prod": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.PRODUCT),
        "all_reduce_avg": lambda: dist.all_reduce(x.clone(),
                                                  op=dist.ReduceOp.AVG),
        "reduce": lambda: dist.reduce(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * n, dtype=dt, device=dev), x),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty(2, dtype=dt, device=dev), half),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, dtype=dt, device=dev), x.clone()),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x.clone()),
        "all_to_all": lambda: dist.all_to_all(
            [torch.empty(2, dtype=dt, device=dev) for _ in range(n)], half),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "scatter": lambda: dist.scatter(
            torch.empty(2, dtype=dt, device=dev),
            half if rank == 0 else None, src=0),
        "send_recv": lambda: (dist.send(x, 1) if rank == 0
                              else dist.recv(torch.empty_like(x), 0)),
    }


def _keys():
    names = list(_cases(0, 2, torch.float32, torch.device("cpu")))
    return [f"{n}/{str(dt)[6:]}" for dt in DTYPES for n in names]


def _rank(rank, n, path, todo, log):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(path, n),
                            rank=rank, world_size=n)
    dev = torch.device("cuda", 0)
    for key in todo:
        name, dts = key.split("/")
        fn = _cases(rank, n, getattr(torch, dts), dev)[name]
        if rank == 0:
            with open(log, "a") as f:
                f.write(json.dumps(["start", key]) + "\n")
        try:
            fn()
            torch.cuda.synchronize()
            res = "ok"
        except Exception as e:      # the probe records every refusal
            res = f"{type(e).__name__}: {str(e)[:120]}"
        if rank == 0:
            with open(log, "a") as f:
                f.write(json.dumps([key, res]) + "\n")
        dist.barrier()
    dist.destroy_process_group()


def _probe(d):
    """{case: result} over every case, one pair of ranks after each
    crash."""
    res, todo, attempt = {}, _keys(), 0
    while todo:
        attempt += 1
        log = os.path.join(d, f"log{attempt}")
        store = os.path.join(d, f"store{attempt}")
        try:
            mp.spawn(_rank, args=(2, store, todo, log), nprocs=2)
        except Exception:           # a crashed pair: find its case below
            pass
        started = None
        with open(log) if os.path.exists(log) else open(os.devnull) as f:
            for line in f:
                a, b = json.loads(line)
                if a == "start":
                    started = b
                else:
                    res[a] = b
        if started is None:         # the pair died before its first case
            res.update({k: "init failed" for k in todo})
        elif started not in res:
            res[started] = "crash"
        todo = [k for k in todo if k not in res]
    return res


def _nccl_one_rank(path):
    dist.init_process_group("nccl", store=dist.FileStore(path, 1), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return "ok" if float(x.sum()) == 4.0 else f"wrong sum {float(x.sum())}"


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    d = tempfile.mkdtemp()
    res = _probe(d)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "gloo_cuda": res,
                      "nccl_one_rank": _nccl_one_rank(
                          os.path.join(d, "nccl_store"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
