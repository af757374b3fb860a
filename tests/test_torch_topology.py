"""The port's hybrid topology against the JAX package's, with no spawn.

`CommunicateTopology` rank <-> coordinate and `get_comm_list`, the
`HybridCommunicateGroup` of every rank (degrees, ranks, group members;
the port's groups are bookkeeping without a process group), `fleet.init`
at one rank, the layout functions `_param_spec`, `_zero_spec` and
`_batch_axes` against the JAX ones on a 4-device mesh, and the shard
order: `shard_of` (what `bridge.shard_state` and the train step give
rank r) against the block that the JAX `NamedSharding` puts on mesh
position r."""
import itertools

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DIMS = [(2, 1, 1, 2), (1, 1, 2, 2), (2, 1, 2, 1), (1, 2, 2, 2), (4, 1, 1, 1)]
NAMES = ("data", "pipe", "sharding", "model")


@pytest.fixture(autouse=True)
def no_hybrid_group():
    from paddle_tpu_torch.distributed.topology import \
        set_hybrid_communicate_group
    yield
    set_hybrid_communicate_group(None)


@pytest.mark.parametrize("dims", DIMS)
def test_topology_matches_jax(dims):
    from paddle_tpu.distributed.topology import CommunicateTopology as J
    from paddle_tpu_torch.distributed.topology import CommunicateTopology
    jt, tt = J(NAMES, dims), CommunicateTopology(NAMES, dims)
    assert tt.world_size() == jt.world_size()
    for r in range(jt.world_size()):
        assert tuple(tt.get_coord(r)) == tuple(jt.get_coord(r))
        assert tt.get_rank(**jt.get_coord(r)._asdict()) == r
    for ax in NAMES:
        assert tt.get_comm_list(ax) == jt.get_comm_list(ax)
        assert tt.get_axis_list(ax, 0) == jt.get_axis_list(ax, 0)


@pytest.mark.parametrize("dims", DIMS)
def test_hybrid_group_of_every_rank_matches_jax(dims):
    from paddle_tpu.distributed.topology import (
        CommunicateTopology as JT, HybridCommunicateGroup as JH)
    from paddle_tpu_torch.distributed.topology import (
        CommunicateTopology, HybridCommunicateGroup)
    for r in range(int(np.prod(dims))):
        j = JH(JT(NAMES, dims), global_rank=r)
        t = HybridCommunicateGroup(CommunicateTopology(NAMES, dims),
                                   global_rank=r)
        for what in ("data_parallel", "model_parallel", "sharding_parallel"):
            assert getattr(t, f"get_{what}_rank")() == \
                getattr(j, f"get_{what}_rank")()
            assert getattr(t, f"get_{what}_world_size")() == \
                getattr(j, f"get_{what}_world_size")()
            assert getattr(t, f"get_{what}_group")().ranks == \
                getattr(j, f"get_{what}_group")().ranks
            assert getattr(t, f"get_{what}_group_src_rank")() == \
                getattr(j, f"get_{what}_group_src_rank")()
        assert t.get_parallel_mode() == j.get_parallel_mode()
        assert t.get_stage_id() == j.get_stage_id()
        mesh = t.build_mesh()
        assert mesh.axis_names == NAMES and mesh.size == int(np.prod(dims))
        assert mesh.coord == dict(t.topology().get_coord(r)._asdict())


def test_fleet_init_at_one_rank_gives_degree_one_groups(monkeypatch):
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
              "PADDLE_DIST_INIT_METHOD", "FLAGS_selected_gpus"):
        monkeypatch.delenv(k, raising=False)
    # a launcher's endpoints left in the environment are no rendezvous for
    # a world of one rank: it takes an in-memory store
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "127.0.0.1:1")
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.core import random as rnd
    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": -1, "mp_degree": 1}
    snap = rnd.rng_snapshot()       # fleet.init reseeds the global stream
    try:
        fleet.init(is_collective=True, strategy=s, device="cpu")
        hcg = fleet.get_hybrid_communicate_group()
        assert s.hybrid_configs.dp_degree == 1
        assert hcg.get_data_parallel_world_size() == 1
        assert hcg.get_model_parallel_world_size() == 1
        assert fleet.worker_num() == 1 and fleet.worker_index() == 0
        assert fleet.is_first_worker()
        import torch
        x = torch.ones(3)
        assert torch.equal(C.all_reduce(x, group=hcg
                                        .get_model_parallel_group()), x)
        from paddle_tpu_torch.core.random import get_rng_state_tracker
        states = get_rng_state_tracker().states()
        assert states["global_seed"][0] == 1024
        assert states["local_seed"][0] == 1024 + 1024
        with pytest.raises(NotImplementedError, match="item 9"):
            fleet.init_server()
    finally:
        C.destroy_process_group()
        rnd.rng_restore(snap)


def test_rng_tracker_streams_follow_jax_seeds():
    from paddle_tpu.core.random import (get_rng_state, set_rng_state,
                                        get_rng_state_tracker as jtracker,
                                        model_parallel_random_seed as jmp)
    from paddle_tpu_torch.core import random as R
    snap, jsnap = R.rng_snapshot(), get_rng_state()
    try:
        for mp_rank, dp_rank in ((0, 0), (1, 0), (1, 3)):
            jmp(77, mp_rank, dp_rank)
            R.model_parallel_random_seed(77, mp_rank, dp_rank)
            want = {k: v[0] for k, v in jtracker().states().items()
                    if k in ("global_seed", "local_seed")}
            got = {k: v[0] for k, v in
                   R.get_rng_state_tracker().states().items()}
            assert got == want
        tr = R.get_rng_state_tracker()
        with tr.rng_state("local_seed"):
            a = R.next_seed()
        with tr.rng_state("local_seed"):
            b = R.next_seed()
        assert a != b
        with pytest.raises(ValueError, match="not added"):
            with tr.rng_state("nope"):
                pass
    finally:
        R.rng_restore(snap)
        set_rng_state(jsnap)


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:8]).reshape(2, 1, 2, 2), NAMES)


class _Param:
    def __init__(self, spec):
        self.partition_spec = spec


SHAPES = [(128, 384), (512, 128), (128,), (16, 16), (512, 64), (7, 256),
          (2048,)]
SPECS = [None, ("model", None), (None, "model"), ("model",), (None,)]


def _jspec(spec):
    return None if spec is None else P(*spec)


@pytest.mark.parametrize("min_numel", [1024, 1])
def test_layout_functions_match_jax(jmesh, min_numel):
    from paddle_tpu.parallel import api as J
    from paddle_tpu_torch.distributed.topology import (
        CommunicateTopology, HybridCommunicateGroup)
    from paddle_tpu_torch.parallel import hybrid as H
    mesh = HybridCommunicateGroup(CommunicateTopology(NAMES, (2, 1, 2, 2)),
                                  global_rank=0).build_mesh()
    assert H._batch_axes(mesh) == J._batch_axes(jmesh)
    for shape, spec in itertools.product(SHAPES, SPECS):
        if spec is not None and len(spec) > len(shape):
            continue
        jp = J._param_spec(_Param(_jspec(spec)), jmesh)
        tp = H._param_spec(_Param(spec), mesh)
        assert tuple(jp) == tp[:len(jp)] and all(
            a is None for a in tp[len(jp):])
        jz = J._zero_spec(jp, shape, jmesh, min_numel=min_numel)
        tz = H._zero_spec(tp, shape, mesh, min_numel=min_numel)
        assert tuple(jz) == tz, (shape, spec)


@pytest.mark.parametrize("spec", [("model", None), (None, "model"),
                                  (("model", "sharding"), None),
                                  (None, ("model", "sharding")),
                                  ("sharding", None), (("data", "sharding"),)])
def test_shard_order_matches_jax_named_sharding(jmesh, spec):
    from paddle_tpu_torch.distributed.topology import (
        CommunicateTopology, HybridCommunicateGroup)
    from paddle_tpu_torch.parallel.hybrid import shard_of
    shape = (16,) if len(spec) == 1 else (16, 8)
    full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    arr = jax.device_put(full, NamedSharding(jmesh, P(*spec)))
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    topo = CommunicateTopology(NAMES, (2, 1, 2, 2))
    for r, dev in enumerate(jmesh.devices.reshape(-1)):
        mesh = HybridCommunicateGroup(topo, global_rank=r).build_mesh()
        np.testing.assert_array_equal(shard_of(full, spec, mesh),
                                      by_dev[dev])


def _refusal_case(kind):
    """(model, optimizer, topology dims, plan) of a multi-rank refusal."""
    import torch
    from paddle_tpu_torch.distributed.fleet.strategy_compiler import \
        StrategyCompiler
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.nn import BatchNorm1D
    from paddle_tpu_torch.nn.clip import ClipGradByNorm
    from paddle_tpu_torch.optimizer import AdamW, Lamb
    m = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu")
    opt, dims, plan = AdamW(parameters=m.parameters()), (1, 1, 1, 2), None
    if kind == "lamb":
        opt = Lamb(parameters=m.parameters())
    elif kind == "clip_by_norm":
        opt = AdamW(parameters=m.parameters(), grad_clip=ClipGradByNorm(1.0))
    elif kind == "buffers":
        m = torch.nn.Sequential(torch.nn.Linear(4, 4), BatchNorm1D(4))
        opt, dims = AdamW(parameters=m.parameters()), (2, 1, 1, 1)
    elif kind == "quant":
        s = DistributedStrategy()
        s.quant_allreduce = True
        plan, dims = StrategyCompiler().compile(s, opt), (2, 1, 1, 1)
    elif kind == "pipe":
        dims = (1, 2, 1, 1)
    return m, opt, dims, plan


@pytest.mark.parametrize("kind,match", [
    ("lamb", "item 8g"), ("clip_by_norm", "item 8g"),
    ("buffers", "item 8f"), ("quant", "item 8a"), ("pipe", "item 8b")])
def test_multi_rank_step_refuses_naming_its_sub_item(kind, match):
    """What the multi-rank step cannot run raises before any collective,
    naming its sub-item of ROADMAP §1 item 8 (the layout of rank 0 of a
    2-rank topology, no process group)."""
    from paddle_tpu_torch.distributed.topology import (
        CommunicateTopology, HybridCommunicateGroup)
    from paddle_tpu_torch.parallel import ShardedTrainStep
    m, opt, dims, plan = _refusal_case(kind)
    mesh = HybridCommunicateGroup(CommunicateTopology(NAMES, dims),
                                  global_rank=0).build_mesh()
    with pytest.raises(NotImplementedError, match=match):
        ShardedTrainStep(m, opt, mesh=mesh, device="cpu", plan=plan)


@pytest.mark.parametrize("placements,want", [
    # four ranks sharing one card (spawn(selected_gpus="0"), the one-card
    # layout): NCCL would refuse them
    (["h0/cuda:0"] * 4, "gloo"),
    (["h0/cuda:0", "h0/cuda:1", "h0/cuda:2", "h0/cuda:3"], "nccl"),
    # sixteen ranks over two hosts of eight GPUs each
    ([f"h{n}/cuda:{g}" for n in range(2) for g in range(8)], "nccl"),
    # two hosts, two ranks on one card of the second
    (["h0/cuda:0", "h0/cuda:1", "h1/cuda:0", "h1/cuda:0"], "gloo"),
    (["h0/cpu", "h0/cpu"], "gloo"),
    (["h0/cuda:0", "h1/cpu"], "gloo"),
    (["h0/cuda:0"], "nccl"),
], ids=["shared_card", "gpu_a_rank", "two_hosts", "two_hosts_shared",
        "cpu", "mixed", "one_rank"])
def test_choose_backend_from_the_layout(placements, want):
    from paddle_tpu_torch.distributed.parallel_env import choose_backend
    assert choose_backend(placements) == want


def test_placements_cross_the_store_in_rank_order(tmp_path):
    import torch.distributed as dist
    from paddle_tpu_torch.distributed.parallel_env import _placements
    store = dist.FileStore(str(tmp_path / "store"), 3)
    for r, p in ((2, "h1/cuda:0"), (0, "h0/cuda:0")):
        store.set(f"pdtt_placement/{r}", p)
    assert _placements(store, 1, 3, "h0/cuda:1") == [
        "h0/cuda:0", "h0/cuda:1", "h1/cuda:0"]
