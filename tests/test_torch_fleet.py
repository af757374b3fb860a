"""The fleet facade's eager pieces over two gloo ranks on the CPU, and
the eager sharding optimizer's partition against the JAX package's.

`_torch_ranks.fleet_rank` (one spawn for the module): two data-parallel
ranks start from different weights; `fleet.distributed_model` wraps the
model in `DataParallel`, whose wrap broadcasts rank 0's; each runs half
of a global batch and `apply_collective_grads()` averages. The averaged
gradients must equal the single-process gradient of the global batch.
`fleet.metrics` must equal the numpy reduction over every rank's
values, and `fleet.distributed_scaler` must skip the step on every rank
when one rank's gradient is not finite.

`_torch_ranks.eager_rank` (a second spawn, of four ranks): the eager
optimizers, `fleet.distributed_optimizer` (`HybridParallelOptimizer`,
as the JAX facade routes every mode but pure data parallelism) and a
`DygraphShardingOptimizer` built directly, at dp2 x sharding2 and at
mp2 x sharding2, each rank on its (data, sharding) slice of the global
batch, SGD under a global-norm clip that binds. After the steps every
rank's parameters, gathered whole over model parallelism, must equal
the single-process step's on the global batch."""
import pickle

import numpy as np
import pytest
import torch

import _torch_ranks as R


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    R.join_ranks(R.run_ranks(R.fleet_rank, (str(d),), 2, d))
    out = {}
    for r in range(2):
        with open(d / f"fleet{r}.pkl", "rb") as f:
            out[r] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def eager(tmp_path_factory):
    d = tmp_path_factory.mktemp("eager")
    ctx = R.run_ranks(R.eager_rank, (str(d),), 4, d)
    # the single-process step on the global batch, while the ranks run
    from paddle_tpu_torch.nn.clip import clip_grad_norm_
    m, opt = R.eager_model()
    ids, labels = R.hybrid_batch(512)
    norms = []
    for i in range(R.EAGER_STEPS):
        m(torch.from_numpy(ids[i]), torch.from_numpy(labels[i])).backward()
        norms.append(float(clip_grad_norm_(m.parameters(), float("inf"))))
        opt.step()
        opt.clear_grad()
    want = {k: p.detach().numpy() for k, p in m.named_parameters()}
    R.join_ranks(ctx)
    out = {}
    for r in range(4):
        with open(d / f"eager{r}.pkl", "rb") as f:
            out[r] = pickle.load(f)
    return out, want, norms


@pytest.mark.parametrize("case", [c[0] for c in R.eager_cases()])
def test_eager_optimizer_steps_equal_the_global_batch_step(eager, case):
    got, want, norms = eager
    assert norms[0] > R.EAGER_CLIP
    for r in range(4):
        state = got[r][case]["state"]
        assert set(state) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(state[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {k}")


def test_fleet_routes_every_hybrid_mode_to_the_hybrid_optimizer(eager):
    got, _, _ = eager
    for name, _, wrap in R.eager_cases():
        want = ("HybridParallelOptimizer" if wrap == "fleet"
                else "DygraphShardingOptimizer")
        assert {got[r][name]["wrapper"] for r in range(4)} == {want}, name


@pytest.mark.parametrize("cap_mb", [1e-5, 2e-3, 25])
def test_bucket_grads_match_jax(cap_mb):
    import jax.numpy as jnp
    from paddle_tpu.distributed.data_parallel import _bucket_grads as J
    from paddle_tpu_torch.distributed.data_parallel import _bucket_grads as T

    class P:
        def __init__(self, grad):
            self.grad = self.data = grad
    shapes = [(8, 16), (3,), (64,), (5, 5), (2, 300), (7,)]
    dts = ["float32", "bfloat16", "float32", "float16", "bfloat16",
           "float32"]
    tp = [P(torch.zeros(s, dtype=getattr(torch, d)))
          for s, d in zip(shapes, dts)]
    # the JAX package's gradients are Tensors over a jax array (`.data`)
    jp = [P(P(jnp.zeros(s, dtype=d))) for s, d in zip(shapes, dts)]
    idx = {id(p): i for i, p in enumerate(tp)}
    jdx = {id(p): i for i, p in enumerate(jp)}
    assert [[idx[id(p)] for p in b] for b in T(tp, cap_mb)] == \
        [[jdx[id(p)] for p in b] for b in J(jp, cap_mb)]


def test_data_parallel_grads_equal_the_global_batch_grad(ranks):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    m = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    for k, p in m.named_parameters():
        np.testing.assert_array_equal(ranks[1]["dp_weights"][k],
                                      p.detach().numpy())
    m.train()
    ids, labels = R.hybrid_batch(512, B=4, S=8)
    m(torch.from_numpy(ids[0]), torch.from_numpy(labels[0])).backward()
    for r in range(2):
        for k, p in m.named_parameters():
            np.testing.assert_allclose(ranks[r]["dp_grads"][k],
                                       p.grad.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_metrics_equal_the_numpy_reduction(ranks):
    rng = np.random.RandomState(7)
    stats = rng.rand(2, 5)
    pos, neg = rng.randint(0, 9, (2, 10)), rng.randint(0, 9, (2, 10))
    want = {"sum": stats.sum(0), "max": stats.max(0), "min": stats.min(0),
            "acc": stats[:, 0].sum() * 10 / 20.0,
            "mae": stats[:, 1].sum() / 6.0,
            "mse": stats[:, 2].sum() / 6.0,
            "rmse": np.sqrt(stats[:, 2].sum() / 6.0)}
    from paddle_tpu_torch.distributed.fleet import metrics
    want["auc"] = metrics.auc(pos.sum(0), neg.sum(0))   # one process
    for r in range(2):
        for k, v in want.items():
            np.testing.assert_allclose(ranks[r]["metrics"][k], v,
                                       rtol=1e-12, err_msg=k)


def test_auc_matches_jax_in_one_process():
    from paddle_tpu.distributed.fleet import metrics as J
    from paddle_tpu_torch.distributed.fleet import metrics as T
    rng = np.random.RandomState(3)
    pos, neg = rng.randint(0, 9, 12), rng.randint(0, 9, 12)
    assert T.auc(pos, neg) == pytest.approx(J.auc(pos, neg), rel=1e-12)
    assert T.auc(np.zeros(4), neg[:4]) == 0.5


def test_distributed_scaler_skips_on_every_rank(ranks):
    assert ranks[0]["scaler_skipped"] and ranks[1]["scaler_skipped"]


@pytest.mark.parametrize("world", [2, 3])
def test_sharding_partition_matches_jax(world):
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as joptim
    from paddle_tpu.distributed.fleet.dygraph_sharding_optimizer import \
        DygraphShardingOptimizer as JD
    from paddle_tpu.distributed.topology import (
        CommunicateTopology as JT, HybridCommunicateGroup as JH)
    from paddle_tpu.models.gpt import GPTForCausalLM as JG
    from paddle_tpu_torch.distributed.fleet.dygraph_sharding_optimizer \
        import DygraphShardingOptimizer
    from paddle_tpu_torch.distributed.topology import (
        CommunicateTopology, HybridCommunicateGroup)
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    names = ("data", "pipe", "sharding", "model")
    paddle.seed(0)
    jm = JG.from_preset("gpt2-tiny")
    tm = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu")
    jname = {id(p): k for k, p in jm.named_parameters()}
    tname = {id(p): k for k, p in tm.named_parameters()}
    for r in range(world):
        jh = JH(JT(names, (1, 1, world, 1)), global_rank=r)
        th = HybridCommunicateGroup(CommunicateTopology(
            names, (1, 1, world, 1)), global_rank=r)
        jd = JD(joptim.AdamW(parameters=jm.parameters()), jh)
        td = DygraphShardingOptimizer(AdamW(parameters=tm.parameters()), th)
        for i in range(world):
            assert [tname[id(p)] for p in td._rank2params[i]] == \
                [jname[id(p)] for p in jd._rank2params[i]]
        assert [tname[id(p)] for p in td._inner_opt._parameter_list] == \
            [tname[id(p)] for p in td._rank2params[r]]
