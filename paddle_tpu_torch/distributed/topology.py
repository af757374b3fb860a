"""Hybrid-parallel topology (counterpart of paddle_tpu/distributed/topology.py).

`CommunicateTopology` is the JAX class verbatim: the ranks laid out on a
cartesian grid of named axes (data, pipe, sharding, model), rank r at
the coordinate of index r in row-major order. `HybridCommunicateGroup`
gives this rank its coordinate and one `collective.Group` per axis. In
the JAX package a group is an axis name of a `jax.sharding.Mesh`; here,
when a process group of the topology's size is running, each group wraps
a torch subgroup: one for every row of `get_comm_list(axis)`, made by
every rank in the same order, as `torch.distributed.new_group` requires.
Without one (or at world size 1) the groups are bookkeeping only, and
collectives over a group of one rank are the identity.

`build_mesh()` returns a `HybridMesh`, the port's record of the layout
(axis names and sizes, this rank's coordinate and the hybrid group),
which the train steps take as `mesh=`.
"""
from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch.distributed as dist

from .collective import Group, _GROUPS


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = collections.namedtuple("Coordinate",
                                                 self._parallel_names)
        self._world = np.arange(int(np.prod(self._dims))).reshape(self._dims)
        ranks = list(itertools.product(*(range(d) for d in self._dims)))
        self._coord2rank = {c: int(self._world[c]) for c in ranks}
        self._rank2coord = {v: k for k, v in self._coord2rank.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(self._world.size)

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank):
        return self.coordinate(*self._rank2coord[rank])

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate on `axis_name` equals index."""
        axis = self._parallel_names.index(axis_name)
        return sorted(int(r) for c, r in self._coord2rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name):
        """The rank groups along `axis_name`, one a coordinate of the
        other axes."""
        axis = self._parallel_names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for other in itertools.product(*(range(d) for d in other_dims)):
            group = []
            for i in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, i)
                group.append(self._coord2rank[tuple(coord)])
            groups.append(group)
        return groups

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = self.get_coord(global_rank)
        tf = coord._replace(**kwargs)._asdict()
        return self.get_rank(**tf)


def _live(topo: CommunicateTopology) -> bool:
    """Whether a process group of the topology's size is running."""
    return (topo.world_size() > 1 and dist.is_initialized()
            and dist.get_world_size() == topo.world_size())


class HybridCommunicateGroup:
    """This rank's coordinate and groups in the hybrid topology."""

    def __init__(self, topology: CommunicateTopology,
                 global_rank: Optional[int] = None):
        from .parallel_env import ParallelEnv
        self._topo = topology
        self.global_rank = (global_rank if global_rank is not None
                            else ParallelEnv().rank)
        self.nranks = topology.world_size()
        names = topology.get_hybrid_group_names()

        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._mp_degree = topology.get_dim("model")

        coord = topology.get_coord(self.global_rank % max(self.nranks, 1))
        self._coord = coord
        self._dp_rank = coord.data
        self._pp_rank = coord.pipe
        self._sharding_rank = coord.sharding
        self._mp_rank = coord.model
        self._ep_degree = topology.get_dim("ep") if "ep" in names else 1
        self._ep_rank = getattr(coord, "ep", 0) if "ep" in names else 0
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1

        # every rank makes every row's subgroup, axis by axis, in the same
        # order; it keeps the row that holds it
        live = _live(topology)
        self._groups: Dict[str, Group] = {}
        for axis in names:
            for row in topology.get_comm_list(axis):
                pg = None
                if live and 1 < len(row) < self.nranks:
                    pg = dist.new_group(row)
                if self.global_rank in row:
                    gid = max(_GROUPS, default=0) + 1
                    g = Group(row.index(self.global_rank), len(row), gid,
                              row, pg, axis)
                    _GROUPS[gid] = g
                    self._groups[axis] = g
        self._dp_group = self._groups["data"]
        self._pp_group = self._groups["pipe"]
        self._sharding_group = self._groups["sharding"]
        self._mp_group = self._groups["model"]
        self._ep_group = self._groups.get("ep")
        self._world_group = Group(self.global_rank, self.nranks, 0,
                                  list(range(self.nranks)), None, "world")

    def get_parallel_mode(self):
        if (self._mp_degree == 1 and self._pp_degree == 1
                and self._sharding_degree == 1):
            return ParallelMode.DATA_PARALLEL
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._mp_degree > 1:
            return ParallelMode.TENSOR_PARALLEL
        return ParallelMode.SHARDING_PARALLEL

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    def get_group(self, axis: str) -> Group:
        """The group of this rank along `axis`."""
        return self._groups[axis]

    def get_world_group(self) -> Group:
        return self._world_group

    # data parallel
    def get_data_parallel_rank(self):
        return self._dp_rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._mp_rank

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    # pipeline parallel
    def get_stage_id(self):
        return self._pp_rank

    def get_pipe_parallel_rank(self):
        return self._pp_rank

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def is_first_stage(self):
        return self._pp_rank == 0

    def is_last_stage(self):
        return self._pp_rank == self._pp_degree - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._sharding_rank

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    # expert parallel
    def get_expert_parallel_rank(self):
        return self._ep_rank

    def get_expert_parallel_world_size(self):
        return self._ep_degree

    def get_expert_parallel_group(self):
        return self._ep_group

    def get_p2p_groups(self):
        prev_stage = (self._pp_rank - 1) % self._pp_degree
        next_stage = (self._pp_rank + 1) % self._pp_degree
        return prev_stage, next_stage

    def build_mesh(self, devices=None) -> "HybridMesh":
        """The port's record of the layout (the JAX method builds a
        jax Mesh); `devices` must be None: one process a rank."""
        if devices is not None:
            raise NotImplementedError(
                "build_mesh(devices=...): the port runs one process a rank "
                "and takes its device from init_parallel_env")
        names = self._topo.get_hybrid_group_names()
        return HybridMesh(tuple(names),
                          dict(zip(names, self._topo._dims)),
                          dict(self._coord._asdict()), self)


@dataclass
class HybridMesh:
    """The hybrid layout as the train steps read it: `axis_names` in
    topology order, `shape` {axis: size}, this rank's `coord` {axis:
    index} and its `hcg`."""
    axis_names: tuple
    shape: Dict[str, int]
    coord: Dict[str, int]
    hcg: HybridCommunicateGroup = field(repr=False)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))


def build_mesh_from_dims(dims: Dict[str, int], devices=None) -> HybridMesh:
    """A HybridMesh for {axis: size} (data, pipe, sharding, model order),
    with its hybrid group, over the running process group."""
    names = list(dims)
    for req in ("data", "pipe", "sharding", "model"):
        if req not in names:
            names.append(req)
    topo = CommunicateTopology(names, [dims.get(n, 1) for n in names])
    return HybridCommunicateGroup(topo).build_mesh(devices)


_GLOBAL_HCG: List[Optional[HybridCommunicateGroup]] = [None]
_GLOBAL_MESH: List[Optional[HybridMesh]] = [None]


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    """Make `hcg` the process's hybrid group (None clears it)."""
    _GLOBAL_HCG[0] = hcg
    _GLOBAL_MESH[0] = None if hcg is None else hcg.build_mesh()


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _GLOBAL_HCG[0]


def get_mesh() -> Optional[HybridMesh]:
    return _GLOBAL_MESH[0]


def set_mesh(mesh: Optional[HybridMesh]):
    _GLOBAL_MESH[0] = mesh
