"""Rank functions of the multi-rank port tests (one process a rank).

`paddle_tpu_torch.distributed.spawn` starts them in fresh processes, so
this module imports only torch, numpy and the port: no JAX and no test
helper that imports it. Each rank joins a gloo group on the CPU through
a FileStore under the test's tmp directory (no TCP ports), runs one
intra-op thread, and writes what it computed to `<out>/<name><rank>.npz`
(or .pkl) for the parent, which holds it against the JAX package.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

RANK_TIMEOUT_S = 600


def run_ranks(fn, args, nprocs, store_dir):
    """Spawn `nprocs` ranks of fn(*args) over a FileStore in `store_dir`
    and return their process context, started (not joined)."""
    from paddle_tpu_torch.distributed import spawn
    return spawn(fn, args=args, nprocs=nprocs, join=False,
                 init_method=f"file://{store_dir}/store")


def join_ranks(ctx, timeout=RANK_TIMEOUT_S):
    """Wait for every rank; a rank's exception is raised here, and ranks
    still running after `timeout` seconds are killed and reported."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            alive = [i for i, p in enumerate(ctx.processes) if p.is_alive()]
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks {alive} still running after "
                               f"{timeout} s")


def world_inputs(n=4):
    """The per-rank inputs of the collective cases, from seed 0; rank r
    takes index r of each stacked array."""
    rng = np.random.RandomState(0)
    return {
        "x": rng.randn(n, 3, 8).astype(np.float32),
        "pos": (np.abs(rng.randn(n, 3, 8)) + 0.5).astype(np.float32),
        "rs": rng.randn(n, 8, 4).astype(np.float32),
        "a2a": rng.randn(n, n, 2, 4).astype(np.float32),
        "w": rng.randn(n, 3, 8).astype(np.float32),
        "wfull": rng.randn(3, 8 * n).astype(np.float32),
        "logits": rng.randn(n, 3, 5, 6).astype(np.float32),
        "labels": np.where(rng.rand(3, 5) < 0.2, -100,
                           rng.randint(0, 6 * n, (3, 5))).astype(np.int64),
        "ct": rng.randn(3, 5).astype(np.float32),
    }


def _init(device="cpu", strategy=None):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    fleet.init(is_collective=True, strategy=strategy or DistributedStrategy(),
               device=device)
    return fleet


def _dump(out, name, obj):
    from paddle_tpu_torch.distributed import get_rank
    with open(os.path.join(out, f"{name}{get_rank()}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def collective_rank(out):
    """Every collective and tensor-parallel operator of collective.py on
    this rank's inputs; forward outputs and input gradients."""
    _init()
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import get_rank, get_world_size
    r, n = get_rank(), get_world_size()
    inp = world_inputs(n)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    res = {}
    for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX),
                     ("min", C.ReduceOp.MIN), ("avg", C.ReduceOp.AVG)):
        res[f"all_reduce_{name}"] = C.all_reduce(t["x"][r].clone(), op)
    res["all_reduce_prod"] = C.all_reduce(t["pos"][r].clone(),
                                          C.ReduceOp.PROD)
    red = C.reduce(t["x"][r].clone(), 1)
    if r == 1:
        res["reduce"] = red
    lst = []
    res["all_gather"] = C.all_gather(lst, t["x"][r])
    res["all_gather_list"] = torch.stack(lst)
    res["all_gather_concat"] = C.all_gather_concat(t["x"][r], concat_axis=1)
    rs = torch.empty(2, 4)
    res["reduce_scatter"] = C.reduce_scatter(rs, t["rs"][r].clone())
    outs = []
    res["alltoall"] = C.alltoall(list(t["a2a"][r].unbind(0)), outs)
    res["alltoall_list"] = torch.stack(outs)
    res["all_to_all_single"] = C.all_to_all_single(
        t["rs"][r].clone(), split_axis=1, concat_axis=0)
    res["broadcast"] = C.broadcast(t["x"][r].clone(), 2)
    sc = torch.empty(2, 4)
    res["scatter"] = C.scatter(sc, list(t["a2a"][r].unbind(0))
                               if r == 1 else None, src=1)
    if r == 0:
        C.send(t["x"][0].clone(), 3)
    if r == 3:
        res["send_recv"] = C.recv(torch.empty(3, 8), 0)
    sub = C.new_group([1, 3])
    if r in (1, 3):
        res["subgroup_sum"] = C.all_reduce(t["x"][r].clone(), group=sub)
    C.barrier()
    # tensor-parallel operators: forward and input gradient
    x = t["x"][r].clone().requires_grad_()
    y = C._c_identity(x)
    (y * t["w"][r]).sum().backward()
    res["c_identity"], res["c_identity_grad"] = y.detach(), x.grad
    x = t["x"][r].clone().requires_grad_()
    y = C._mp_allreduce(x)
    (y * t["w"][r]).sum().backward()
    res["mp_allreduce"], res["mp_allreduce_grad"] = y.detach(), x.grad
    x = t["x"][r].clone().requires_grad_()
    y = C._c_concat(x)
    (y * t["wfull"]).sum().backward()
    res["c_concat"], res["c_concat_grad"] = y.detach(), x.grad
    xs = torch.from_numpy(inp["wfull"].copy() * 0.5).requires_grad_()
    y = C._c_split(xs)
    (y * t["wfull"][:, r * 8:(r + 1) * 8]).sum().backward()
    res["c_split"], res["c_split_grad"] = y.detach(), xs.grad
    lg = t["logits"][r].clone().requires_grad_()
    loss = C._c_softmax_with_cross_entropy(lg, t["labels"])
    (loss * t["ct"]).sum().backward()
    res["vocab_ce"], res["vocab_ce_grad"] = loss.detach(), lg.grad
    _dump(out, "coll", {k: v.detach().numpy() for k, v in res.items()})
    C.destroy_process_group()


def hybrid_cases():
    """The hybrid-step cases: (name, preset, (dp, sharding, mp), zero
    stage, extra) over 4 ranks."""
    return [
        ("gpt_dp2_mp2_z1", "gpt2-tiny", (2, 1, 2), 1, {}),
        ("gpt_sh2_mp2_z2", "gpt2-tiny", (1, 2, 2), 2, {}),
        ("gpt_sh2_mp2_z3", "gpt2-tiny", (1, 2, 2), 3, {}),
        ("llama_dp2_mp2_z1", "llama2-tiny", (2, 1, 2), 1, {}),
        ("llama_sh2_mp2_z2", "llama2-tiny", (1, 2, 2), 2, {}),
        ("llama_sh2_mp2_z3", "llama2-tiny", (1, 2, 2), 3, {}),
        ("gpt_dp2_mp2_sgd", "gpt2-tiny", (2, 1, 2), 1, {"sgd": True}),
        ("gpt_dp2_mp2_clip", "gpt2-tiny", (2, 1, 2), 1,
         {"sgd": True, "clip": 0.5}),
    ]


def hybrid_batch(vocab, B=8, S=16, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (3, B, S)).astype(np.int64),
            rng.randint(0, vocab, (3, B, S)).astype(np.int64))


def _strategy(dims, zero, scan=1, amp=None):
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    s = DistributedStrategy()
    dp, sh, mp = dims
    s.hybrid_configs = {"dp_degree": dp, "sharding_degree": sh,
                        "mp_degree": mp}
    if zero:
        s.sharding = True
        s.sharding_configs = {"stage": zero}
    if scan > 1:
        s.scan_steps = scan
    if amp is not None:
        s.amp = True
        s.amp_configs = amp
    return s


def _model(preset, weights, hcg, zero=0):
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cls = GPTForCausalLM if preset.startswith("gpt") else LlamaForCausalLM
    m = cls.from_preset(preset, device="cpu")
    bridge.load_jax_state(m, bridge.shard_state(weights, m, hcg))
    m.train()
    return m


def _adamw(m, clip=None, sgd=False):
    """AdamW at lr 1e-3, or SGD at lr 1 (whose steps a clip scales), with
    a global-norm clip when `clip`."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD, AdamW
    kw = dict(parameters=m.parameters(),
              grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    return SGD(learning_rate=1.0, **kw) if sgd else AdamW(
        learning_rate=1e-3, **kw)


def hybrid_rank(out, weights_dir):
    """The hybrid step cases (hybrid_cases), then the fp16 skip and the
    ScanTrainStep cases, over 4 ranks."""
    fleet = _init()
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.parallel import parallelize
    res = {}
    for name, preset, dims, zero, extra in hybrid_cases():
        weights = dict(np.load(os.path.join(weights_dir, f"{preset}.npz")))
        s = _strategy(dims, zero)
        fleet.init(is_collective=True, strategy=s, device="cpu")
        hcg = fleet.get_hybrid_communicate_group()
        m = _model(preset, weights, hcg)
        opt = _adamw(m, extra.get("clip"), extra.get("sgd", False))
        step = parallelize(m, opt, strategy=s)
        ids, labels = hybrid_batch(m.config.vocab_size)
        losses = [float(step(ids[i], labels[i])) for i in range(3)]
        moments = {k: tuple(opt.state[u]["moment1"].shape)
                   for k, u in zip(step._names, step._upd)
                   if "moment1" in opt.state.get(u, {})}
        state = {k: v.numpy() for k, v in step.state_dict().items()}
        if get_rank() != 0:
            state = None
        res[name] = {"losses": losses, "moments": moments, "state": state,
                     "coord": dict(step.mesh.coord)}
    res.update(_fp16_skip(fleet))
    res.update(_scan_vs_steps(fleet, weights_dir))
    res.update(_set_between_steps(fleet, weights_dir))
    _dump(out, "hybrid", res)
    C.destroy_process_group()


def _fp16_skip(fleet):
    """An fp16 step with an inf injected into one mp rank's gradient:
    every rank skips it (parameters unchanged, loss scale halved)."""
    import math
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.parallel import parallelize
    s = _strategy((2, 1, 2), 1, amp={"dtype": "float16",
                                     "use_dynamic_loss_scaling": True,
                                     "init_loss_scaling": 1024.0,
                                     "decr_every_n_nan_or_inf": 1,
                                     "decr_ratio": 0.5})
    fleet.init(is_collective=True, strategy=s, device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    m = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu")
    m.train()
    opt = _adamw(m)
    step = parallelize(m, opt, strategy=s)
    ids, labels = hybrid_batch(m.config.vocab_size)
    step(ids[0], labels[0])
    before = {k: p.detach().clone() for k, p in m.named_parameters()}
    scale0 = step.loss_scale
    w = m.gpt.layers[0].linear1.weight
    hook = None
    if hcg.get_model_parallel_rank() == 1 and \
            hcg.get_data_parallel_rank() == 0:
        hook = w.register_hook(lambda g: g * math.inf)
    step(ids[1], labels[1])
    if hook is not None:
        hook.remove()
    same = all(torch.equal(before[k], p.detach())
               for k, p in m.named_parameters())
    out = {"fp16_skip": {"unchanged": same, "scale0": scale0,
                         "scale1": step.loss_scale}}
    step(ids[2], labels[2])
    out["fp16_skip"]["moved_after"] = not all(
        torch.equal(before[k], p.detach()) for k, p in m.named_parameters())
    return out


def _scan_vs_steps(fleet, weights_dir):
    """ScanTrainStep with K = 2 against two ShardedTrainStep calls, at
    sharding2 x mp2 ZeRO 2."""
    from paddle_tpu_torch.parallel import ScanTrainStep, parallelize
    weights = dict(np.load(os.path.join(weights_dir, "gpt2-tiny.npz")))
    ids, labels = hybrid_batch(512)
    got = {}
    for scan in (1, 2):
        s = _strategy((1, 2, 2), 2, scan=scan)
        fleet.init(is_collective=True, strategy=s, device="cpu")
        m = _model("gpt2-tiny", weights, fleet.get_hybrid_communicate_group())
        step = parallelize(m, _adamw(m), strategy=s)
        if scan == 2:
            assert isinstance(step, ScanTrainStep)
            got[scan] = step(ids[:2], labels[:2]).tolist()
        else:
            got[scan] = [float(step(ids[i], labels[i])) for i in range(2)]
    return {"scan": got}


def _set_between_steps(fleet, weights_dir):
    """Parameters set from outside between steps reach the ZeRO shards:
    at sharding2 x mp2 ZeRO 2 under SGD (no optimizer state), two steps,
    the first weights loaded again, the same two steps; the losses must
    repeat."""
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.parallel import parallelize
    weights = dict(np.load(os.path.join(weights_dir, "gpt2-tiny.npz")))
    ids, labels = hybrid_batch(512)
    s = _strategy((1, 2, 2), 2)
    fleet.init(is_collective=True, strategy=s, device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    m = _model("gpt2-tiny", weights, hcg)
    step = parallelize(m, _adamw(m, sgd=True), strategy=s)
    got = []
    for _ in range(2):
        bridge.load_jax_state(m, bridge.shard_state(weights, m, hcg))
        got.append([float(step(ids[i], labels[i])) for i in range(2)])
    return {"set_between_steps": got}


def eager_cases():
    """The eager optimizers over 4 ranks: (name, (dp, sharding, mp), how
    the optimizer is wrapped: "fleet" through fleet.distributed_optimizer,
    "sharding" in a DygraphShardingOptimizer built directly)."""
    return [("fleet_dp2_sh2", (2, 2, 1), "fleet"),
            ("fleet_mp2_sh2", (1, 2, 2), "fleet"),
            ("sharding_dp2_sh2", (2, 2, 1), "sharding"),
            ("sharding_mp2_sh2", (1, 2, 2), "sharding")]


EAGER_CLIP = 0.5    # below the first step's gradient norm: the clip binds
EAGER_STEPS = 2


def eager_model(generator_seed=0):
    """gpt2-tiny from a seed (one logical model at every mp degree) in
    train mode, with SGD at lr 1 under a global-norm clip of EAGER_CLIP."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD
    m = GPTForCausalLM.from_preset(
        "gpt2-tiny", device="cpu",
        generator=torch.Generator().manual_seed(generator_seed))
    m.train()
    return m, SGD(learning_rate=1.0, parameters=m.parameters(),
                  grad_clip=ClipGradByGlobalNorm(EAGER_CLIP))


def eager_rank(out):
    """The eager path (fleet.distributed_model and the eager optimizers)
    for each of eager_cases: every rank runs its (data, sharding) slice
    of the global batch for EAGER_STEPS steps and keeps its parameters
    gathered whole over model parallelism."""
    fleet = _init()
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.fleet.dygraph_sharding_optimizer \
        import DygraphShardingOptimizer
    from paddle_tpu_torch.parallel.hybrid import _dim_of, _param_spec
    ids, labels = hybrid_batch(512)
    res = {}
    for name, dims, wrap in eager_cases():
        fleet.init(is_collective=True, strategy=_strategy(dims, 0),
                   device="cpu")
        hcg = fleet.get_hybrid_communicate_group()
        m, opt = eager_model()
        model = fleet.distributed_model(m)
        opt = (fleet.distributed_optimizer(opt) if wrap == "fleet"
               else DygraphShardingOptimizer(opt, hcg))
        S = hcg.get_sharding_parallel_world_size()
        n = hcg.get_data_parallel_world_size() * S
        b = hcg.get_data_parallel_rank() * S + \
            hcg.get_sharding_parallel_rank()
        per = ids.shape[1] // n
        rows = slice(b * per, (b + 1) * per)
        for i in range(EAGER_STEPS):
            loss = model(torch.from_numpy(ids[i][rows]),
                         torch.from_numpy(labels[i][rows]))
            loss.backward()
            opt.step()
            opt.clear_grad()
        mesh = hcg.build_mesh()
        state = {}
        for k, p in m.named_parameters():
            t = p.detach().contiguous()
            dim = _dim_of(_param_spec(p, mesh), "model")
            if dim is not None:
                t = C.all_gather_concat(t, hcg.get_model_parallel_group(),
                                        concat_axis=dim)
            state[k] = t.numpy()
        res[name] = {"state": state, "wrapper": type(opt).__name__}
    _dump(out, "eager", res)
    C.destroy_process_group()


def tp_rank(out, weights_dir):
    """GPT and Llama at mp2: the loss and the gradients gathered whole,
    and the vocab-parallel CE layer with an ignored label."""
    fleet = _init(strategy=_strategy((1, 1, 2), 0))
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.meta_parallel import \
        ParallelCrossEntropy
    from paddle_tpu_torch.parallel.hybrid import _dim_of, _param_spec
    hcg = fleet.get_hybrid_communicate_group()
    mesh = hcg.build_mesh()
    res = {}
    for preset in ("gpt2-tiny", "llama2-tiny"):
        weights = dict(np.load(os.path.join(weights_dir, f"{preset}.npz")))
        m = _model(preset, weights, hcg)
        ids, labels = hybrid_batch(m.config.vocab_size, B=2, S=16)
        loss = m(torch.from_numpy(ids[0]), torch.from_numpy(labels[0]))
        loss.backward()
        grads = {}
        for k, p in m.named_parameters():
            g = p.grad
            dim = _dim_of(_param_spec(p, mesh), "model")
            if dim is not None:
                g = C.all_gather_concat(g.contiguous(), hcg
                                        .get_model_parallel_group(),
                                        concat_axis=dim)
            grads[k] = g.numpy()
        res[preset] = {"loss": float(loss), "grads": grads}
    # the strategy's mp_degree 2 runs in this 2-rank hybrid group
    from paddle_tpu_torch.parallel import parallelize
    weights = dict(np.load(os.path.join(weights_dir, "gpt2-tiny.npz")))
    m = _model("gpt2-tiny", weights, hcg)
    step = parallelize(m, _adamw(m), strategy=_strategy((1, 1, 2), 0))
    ids, labels = hybrid_batch(512, B=2, S=16)
    res["mp2_step_losses"] = [float(step(ids[i], labels[i]))
                              for i in range(2)]
    inp = world_inputs(2)
    r = hcg.get_model_parallel_rank()
    lg = torch.from_numpy(np.concatenate(list(inp["logits"][:2]), -1)
                          [..., r * 6:(r + 1) * 6].copy()).requires_grad_()
    labels = inp["labels"] % 12
    labels[inp["labels"] == -100] = -100
    ce = ParallelCrossEntropy(ignore_index=-100)
    loss = ce(lg, torch.from_numpy(labels))
    (loss * torch.from_numpy(inp["ct"])).sum().backward()
    res["ce"] = {"loss": loss.detach().numpy(), "grad": lg.grad.numpy()}
    _dump(out, "tp", res)
    C.destroy_process_group()


def fleet_rank(out):
    """DataParallel's averaged gradients, fleet.metrics and the
    distributed scaler over 2 data-parallel ranks."""
    fleet = _init()
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.distributed.fleet import metrics
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import SGD
    r = get_rank()
    gen = torch.Generator().manual_seed(r)     # ranks start apart:
    m = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                   generator=gen)
    dp = fleet.distributed_model(m)            # the wrap broadcasts rank 0's
    ids, labels = hybrid_batch(512, B=4, S=8)
    half = slice(2 * r, 2 * r + 2)
    loss = dp(torch.from_numpy(ids[0][half]), torch.from_numpy(labels[0][half]))
    dp.scale_loss(loss).backward()
    dp.apply_collective_grads()
    res = {"dp_grads": {k: p.grad.numpy() for k, p in m.named_parameters()},
           "dp_weights": {k: p.detach().numpy()
                          for k, p in m.named_parameters()}}
    rng = np.random.RandomState(7)
    stats = rng.rand(2, 5)
    pos, neg = rng.randint(0, 9, (2, 10)), rng.randint(0, 9, (2, 10))
    res["metrics"] = {
        "sum": metrics.sum(stats[r]), "max": metrics.max(stats[r]),
        "min": metrics.min(stats[r]),
        "acc": metrics.acc(stats[r][0] * 10, 10.0),
        "mae": metrics.mae(stats[r][1], 3.0),
        "mse": metrics.mse(stats[r][2], 3.0),
        "rmse": metrics.rmse(stats[r][2], 3.0),
        "auc": metrics.auc(pos[r], neg[r])}
    opt = fleet.distributed_optimizer(SGD(learning_rate=0.1,
                                          parameters=m.parameters()))
    scaler = fleet.distributed_scaler(GradScaler(init_loss_scaling=8.0))
    m.zero_grad()
    loss = dp(torch.from_numpy(ids[1][half]), torch.from_numpy(labels[1][half]))
    scaler.scale(loss).backward()
    if r == 1:
        next(iter(m.parameters())).grad.fill_(float("nan"))
    before = [p.detach().clone() for p in m.parameters()]
    scaler.step(opt)
    res["scaler_skipped"] = all(torch.equal(a, p.detach())
                                for a, p in zip(before, m.parameters()))
    _dump(out, "fleet", res)
    C.destroy_process_group()
