"""The collective fleet facade (counterpart of
paddle_tpu/distributed/fleet/__init__.py), one process a rank.

`fleet.init(is_collective=True, strategy)` starts the process group
(`init_parallel_env`: CUDA unless `device="cpu"`, raising without a GPU),
builds the hybrid topology from `strategy.hybrid_configs` (data, pipe,
sharding, model; `dp_degree=-1` takes what the other degrees leave of
the world; sep and ep axes inserted before model, as in JAX), makes the
`HybridCommunicateGroup` with its subgroups, and seeds the tensor-parallel
RNG streams (`tensor_init_seed`, default 1024), as the JAX
`_init_hybrid_parallel_env` does (fleet/__init__.py:72-107). Then:
- `distributed_model(model)` wraps by parallel mode: `DataParallel`,
  `TensorParallel` or `ShardingParallel` (pipeline waits for ROADMAP §1
  item 8b);
- `distributed_optimizer(opt)` swaps LARS/LAMB in, as the strategy
  compiler does, and in every mode but pure data parallelism wraps in
  `HybridParallelOptimizer`, whose step averages the gradients over the
  data and sharding groups, as the JAX facade routes it (an eager
  `DygraphShardingOptimizer` is built directly); `strategy.dgc` waits
  for ROADMAP §1 item 8a;
- `distributed_scaler(scaler)` agrees the GradScaler's found_inf over
  every rank (a max all-reduce), so every rank skips the same step;
- `state_dict`, `set_state_dict`, `set_lr`, `get_lr`, `step` and
  `clear_grad` pass through to the distributed optimizer.
`parallelize(model, opt, strategy=s)` (paddle_tpu_torch.parallel) builds
the compiled-path train step over the same hybrid group.

The parameter-server methods (`init_server`, `run_server`, `init_worker`,
`stop_worker`, ...) and the checkpoint routing through its runtime raise:
the PS runtime is ROADMAP §1 item 9.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ...core.random import model_parallel_random_seed
from .. import collective as C
from .. import meta_parallel as mp
from ..data_parallel import DataParallel
from ..parallel_env import (ParallelEnv, get_rank, get_world_size,
                            init_parallel_env)
from ..strategy import DistributedStrategy
from ..topology import (CommunicateTopology, HybridCommunicateGroup,
                        ParallelMode, get_hybrid_communicate_group,
                        set_hybrid_communicate_group)
from . import metrics  # noqa: F401
from . import utils  # noqa: F401

_PS = "the parameter-server runtime waits for ROADMAP §1 item 9"


class PaddleCloudRoleMaker:
    """Cluster discovery from the launcher's variables."""

    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective
        env = ParallelEnv()
        self._rank = env.rank
        self._size = env.world_size
        self._endpoints = env.trainer_endpoints

    def _worker_index(self):
        return self._rank

    def _worker_num(self):
        return self._size

    worker_index = _worker_index
    worker_num = _worker_num

    def is_worker(self):
        return True

    def is_server(self):
        return False


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    pass


class Fleet:
    def __init__(self):
        self._role_maker = None
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._is_initialized = False
        self._user_defined_optimizer = None
        self._distributed_optimizer = None
        self._scaler = None
        self._model = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             device=None, init_method=None):
        """Start this rank's process group and the hybrid group.
        `device`/`init_method` as `init_parallel_env` takes them."""
        if not is_collective:
            raise NotImplementedError(f"fleet.init(is_collective=False): "
                                      f"{_PS}")
        self._strategy = strategy or DistributedStrategy()
        init_parallel_env(device=device, init_method=init_method)
        self._role_maker = role_maker or PaddleCloudRoleMaker(is_collective)
        self._init_hybrid_parallel_env()
        self._is_initialized = True
        return self

    def _init_hybrid_parallel_env(self):
        hc = self._strategy.hybrid_configs
        world = get_world_size()
        mp_deg = max(hc.mp_degree, 1)
        pp = max(hc.pp_degree, 1)
        sharding = max(hc.sharding_degree, 1)
        sep = max(getattr(hc, "sep_degree", 1), 1)
        ep = max(getattr(hc, "ep_degree", 1), 1)
        dp = hc.dp_degree
        if dp in (-1, None):
            dp = max(world // (mp_deg * pp * sharding * sep * ep), 1)
            hc.dp_degree = dp
        names = ["data", "pipe", "sharding", "model"]
        dims = [dp, pp, sharding, mp_deg]
        if sep > 1:
            names.insert(3, "sep")
            dims.insert(3, sep)
        if ep > 1:
            names.insert(3, "ep")
            dims.insert(3, ep)
        topo = CommunicateTopology(names, dims)
        if topo.world_size() != world:
            raise ValueError(f"hybrid_configs {dict(zip(names, dims))} need "
                             f"{topo.world_size()} ranks; the world has "
                             f"{world}")
        self._hcg = HybridCommunicateGroup(topo)
        set_hybrid_communicate_group(self._hcg)
        seed = self._strategy.tensor_parallel_configs.tensor_init_seed
        if seed == -1:
            seed = 1024
        model_parallel_random_seed(seed, self._hcg.get_model_parallel_rank(),
                                   self._hcg.get_data_parallel_rank())

    # ---- accessors ----
    def is_first_worker(self):
        return get_rank() == 0

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def is_worker(self):
        return True

    def worker_endpoints(self, to_string=False):
        eps = ParallelEnv().trainer_endpoints
        return ",".join(eps) if to_string else eps

    def server_num(self):
        return 0

    def is_server(self):
        return False

    def barrier_worker(self):
        C.barrier()

    def get_hybrid_communicate_group(self):
        return self._hcg

    def get_hybrid_parallel_topology(self):
        return None if self._hcg is None else self._hcg.topology()

    def node_num(self):
        eps = {e.split(":")[0] for e in
               getattr(self._role_maker, "_endpoints", None) or [""]}
        return max(len(eps), 1)

    def local_rank(self):
        return int(os.environ.get("PADDLE_RANK_IN_NODE",
                                  os.environ.get("PADDLE_LOCAL_RANK", 0)))

    def local_device_ids(self):
        v = os.environ.get("FLAGS_selected_gpus",
                           os.environ.get("PADDLE_LOCAL_DEVICE_IDS", "0"))
        return [int(x) for x in str(v).split(",") if x != ""]

    def world_device_ids(self):
        v = os.environ.get("PADDLE_WORLD_DEVICE_IDS", "")
        if v:
            return [[int(x) for x in grp.split(",")]
                    for grp in v.split(";")]
        return [self.local_device_ids()]

    # ---- model and optimizer ----
    def distributed_model(self, model):
        if not self._is_initialized:
            raise RuntimeError("call fleet.init first")
        self._model = model
        mode = self._hcg.get_parallel_mode()
        if mode == ParallelMode.DATA_PARALLEL:
            return DataParallel(model, strategy=self._strategy,
                                find_unused_parameters=self._strategy
                                .find_unused_parameters,
                                group=self._hcg.get_data_parallel_group())
        if mode == ParallelMode.TENSOR_PARALLEL:
            return mp.TensorParallel(model, self._hcg,
                                     strategy=self._strategy)
        if mode == ParallelMode.PIPELINE_PARALLEL:
            raise NotImplementedError(
                "pipeline parallelism waits for ROADMAP §1 item 8b")
        return mp.ShardingParallel(model, self._hcg, strategy=self._strategy)

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        s = self._strategy
        if s is not None and getattr(s, "dgc", False):
            raise NotImplementedError(
                "strategy.dgc waits for ROADMAP §1 item 8a")
        if s is not None and (getattr(s, "lars", False)
                              or getattr(s, "lamb", False)):
            from .strategy_compiler import StrategyCompiler
            plan = StrategyCompiler().compile(s, optimizer)
            optimizer = plan.optimizer or optimizer
        self._user_defined_optimizer = optimizer
        wrapped = optimizer
        if self._hcg is not None and \
                self._hcg.get_parallel_mode() != ParallelMode.DATA_PARALLEL:
            from .hybrid_parallel_optimizer import HybridParallelOptimizer
            wrapped = HybridParallelOptimizer(optimizer, self._hcg, s)
        self._distributed_optimizer = wrapped
        return wrapped

    def distributed_scaler(self, scaler):
        """A GradScaler whose found_inf is agreed over every rank."""
        self._scaler = scaler
        return _DistributedScaler(scaler)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        opt = self._opt_for_facade
        loss.backward()
        opt.step()
        return None, [(p, p.grad) for p in opt._parameter_list or []]

    @property
    def _opt_for_facade(self):
        return self._distributed_optimizer or self._user_defined_optimizer

    def state_dict(self):
        return self._opt_for_facade.state_dict()

    def set_state_dict(self, state):
        return self._opt_for_facade.set_state_dict(state)

    def set_lr(self, value):
        return self._opt_for_facade.set_lr(value)

    def get_lr(self):
        return self._opt_for_facade.get_lr()

    def step(self):
        return self._opt_for_facade.step()

    def clear_grad(self):
        return self._opt_for_facade.clear_grad()

    def get_loss_scaling(self):
        if self._scaler is not None:
            return self._scaler.state_dict().get("scale", 1.0)
        return 1.0

    def amp_init(self, place=None, scope=None, test_program=None,
                 use_fp16_test=False):
        return None

    # ---- the parameter-server runtime (ROADMAP §1 item 9) ----
    def _ps(self, *args, **kwargs):
        raise NotImplementedError(_PS)

    init_server = run_server = init_worker = stop_worker = shrink = _ps
    server_index = server_endpoints = save_persistables = _ps
    save_inference_model = save = load_model = _ps


class _DistributedScaler:
    """A GradScaler whose unscale_ agrees found_inf over every rank (a max
    all-reduce of the flag), so every rank skips the same step."""

    def __init__(self, scaler):
        self._scaler = scaler

    def unscale_(self, optimizer):
        self._scaler.unscale_(optimizer)
        if get_world_size() > 1:
            from ..parallel_env import current_device
            flag = torch.tensor([float(self._scaler._found_inf)],
                                device=current_device())
            C.all_reduce(flag, C.ReduceOp.MAX)
            self._scaler._found_inf = bool(flag.item())

    def step(self, optimizer):
        if not self._scaler._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._scaler._found_inf:
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self._scaler.update()

    def __getattr__(self, item):
        return getattr(self._scaler, item)


_fleet_singleton = Fleet()

init = _fleet_singleton.init
is_first_worker = _fleet_singleton.is_first_worker
worker_index = _fleet_singleton.worker_index
worker_num = _fleet_singleton.worker_num
is_worker = _fleet_singleton.is_worker
worker_endpoints = _fleet_singleton.worker_endpoints
server_num = _fleet_singleton.server_num
is_server = _fleet_singleton.is_server
barrier_worker = _fleet_singleton.barrier_worker
distributed_model = _fleet_singleton.distributed_model
distributed_optimizer = _fleet_singleton.distributed_optimizer
distributed_scaler = _fleet_singleton.distributed_scaler
minimize = _fleet_singleton.minimize
init_server = _fleet_singleton.init_server
init_worker = _fleet_singleton.init_worker
run_server = _fleet_singleton.run_server
stop_worker = _fleet_singleton.stop_worker
save_persistables = _fleet_singleton.save_persistables
save_inference_model = _fleet_singleton.save_inference_model
get_hybrid_communicate_group = _fleet_singleton.get_hybrid_communicate_group
get_hybrid_parallel_topology = _fleet_singleton.get_hybrid_parallel_topology
node_num = _fleet_singleton.node_num
local_rank = _fleet_singleton.local_rank
local_device_ids = _fleet_singleton.local_device_ids
world_device_ids = _fleet_singleton.world_device_ids
server_index = _fleet_singleton.server_index
server_endpoints = _fleet_singleton.server_endpoints
save = _fleet_singleton.save
load_model = _fleet_singleton.load_model
shrink = _fleet_singleton.shrink
state_dict = _fleet_singleton.state_dict
set_state_dict = _fleet_singleton.set_state_dict
set_lr = _fleet_singleton.set_lr
get_lr = _fleet_singleton.get_lr
step = _fleet_singleton.step
clear_grad = _fleet_singleton.clear_grad
get_loss_scaling = _fleet_singleton.get_loss_scaling
amp_init = _fleet_singleton.amp_init


def fleet():
    return _fleet_singleton


class Role:
    """fleet.Role: WORKER / SERVER / HETER_WORKER."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
