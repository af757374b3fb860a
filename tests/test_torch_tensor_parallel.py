"""Real tensor parallelism: tiny GPT and Llama at mp2 over two gloo ranks
on the CPU, against the JAX model on a 2-device mesh and against the port
at degree 1.

Each rank builds the model under `fleet.init` with mp_degree 2 (its
layers hold their shards), loads the JAX weights through
`bridge.shard_state`, and runs the no-cache forward with labels and the
backward; the gradients of the split leaves are gathered whole
(`_torch_ranks.tp_rank`). The JAX side differentiates the same loss with
its parameters laid out by `_param_spec` on a mesh whose model axis has
2 devices. The vocab-parallel `ParallelCrossEntropy` with ignored labels
is held against the JAX `_c_softmax_with_cross_entropy` under shard_map
and against the port's degree-1 layer."""
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_ranks as R

NAMES = ("data", "pipe", "sharding", "model")
TOL = dict(rtol=2e-5, atol=2e-5)


def _jax_model(preset):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForCausalLM
    from paddle_tpu.models.llama import LlamaForCausalLM
    paddle.seed(0)
    cls = GPTForCausalLM if preset.startswith("gpt") else LlamaForCausalLM
    return cls.from_preset(preset)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    jax_out = {}
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 1, 1, 2), NAMES)
    from paddle_tpu.parallel.api import _param_spec
    models = {p: _jax_model(p) for p in ("gpt2-tiny", "llama2-tiny")}
    for preset, jm in models.items():
        params, bufs = jm.functional_state()
        np.savez(d / f"{preset}.npz",
                 **{k: np.asarray(v) for k, v in params.items()})
    ctx = R.run_ranks(R.tp_rank, (str(d), str(d)), 2, d)
    named_all = {}
    for preset, jm in models.items():
        params, bufs = jm.functional_state()
        named = dict(jm.named_parameters())
        named_all[preset] = {k: np.asarray(v) for k, v in params.items()}
        sharded = {k: jax.device_put(v, NamedSharding(
            mesh, _param_spec(named[k], mesh))) for k, v in params.items()}
        ids, labels = R.hybrid_batch(jm.config.vocab_size, B=2, S=16)

        def loss_fn(p):
            out, _ = jm.functional_call_with_state(
                p, bufs, jnp.asarray(ids[0]), jnp.asarray(labels[0]),
                rng=jax.random.PRNGKey(0))
            return out

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(sharded)
        jax_out[preset] = {"loss": float(loss),
                           "grads": {k: np.asarray(g)
                                     for k, g in grads.items()}}
    R.join_ranks(ctx)
    port = {}
    for r in range(2):
        with open(d / f"tp{r}.pkl", "rb") as f:
            port[r] = pickle.load(f)
    return port, jax_out, named_all


@pytest.mark.parametrize("preset", ["gpt2-tiny", "llama2-tiny"])
def test_mp2_loss_and_grads_match_jax(runs, preset):
    port, jax_out, _ = runs
    want = jax_out[preset]
    for r in range(2):
        got = port[r][preset]
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-5)
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, err_msg=k, **TOL)


@pytest.mark.parametrize("preset", ["gpt2-tiny", "llama2-tiny"])
def test_mp2_matches_the_port_at_degree_one(runs, preset):
    from paddle_tpu_torch.bridge import load_jax_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    port, _, named_all = runs
    cls = GPTForCausalLM if preset.startswith("gpt") else LlamaForCausalLM
    tm = cls.from_preset(preset, device="cpu")
    load_jax_state(tm, named_all[preset])
    tm.train()
    ids, labels = R.hybrid_batch(tm.config.vocab_size, B=2, S=16)
    loss = tm(torch.from_numpy(ids[0]), torch.from_numpy(labels[0]))
    loss.backward()
    for r in range(2):
        got = port[r][preset]
        assert got["loss"] == pytest.approx(loss.item(), rel=2e-5)
        for k, p in tm.named_parameters():
            np.testing.assert_allclose(got["grads"][k], p.grad.numpy(),
                                       err_msg=k, **TOL)


def test_mp_degree_two_strategy_runs_in_a_two_rank_group(runs):
    """parallelize with hybrid_configs.mp_degree 2 in the 2-rank group
    gives the losses of the one-rank step."""
    from paddle_tpu_torch.bridge import load_jax_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainStep
    port, _, named_all = runs
    tm = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu")
    load_jax_state(tm, named_all["gpt2-tiny"])
    tm.train()
    step = ShardedTrainStep(tm, AdamW(learning_rate=1e-3,
                                      parameters=tm.parameters()),
                            device="cpu")
    ids, labels = R.hybrid_batch(512, B=2, S=16)
    want = [float(step(ids[i], labels[i])) for i in range(2)]
    for r in range(2):
        np.testing.assert_allclose(port[r]["mp2_step_losses"], want,
                                   rtol=1e-5)


def test_vocab_parallel_ce_honours_ignore_index(runs):
    from paddle_tpu.distributed import collective as JC
    from paddle_tpu.distributed.collective import axis_context
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu_torch.distributed.meta_parallel import \
        ParallelCrossEntropy
    port, _, _ = runs
    inp = R.world_inputs(2)
    full = np.concatenate(list(inp["logits"][:2]), -1)
    labels = inp["labels"] % 12
    labels[inp["labels"] == -100] = -100
    assert (labels == -100).any()
    ct = inp["ct"]
    # the JAX explicit path: per-rank logits under shard_map
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))

    def body(a):
        with axis_context(("x",)):
            def op(z):
                return JC._c_softmax_with_cross_entropy(
                    Tensor(z), Tensor(jnp.asarray(labels))).data
            y, back = jax.vjp(op, a[0])
            return y[None], back(jnp.asarray(ct))[0][None]

    f = jax.shard_map(body, mesh=mesh, in_specs=(P("x"),),
                      out_specs=(P("x"), P("x")), check_vma=False)
    y, g = f(jnp.asarray(np.stack([full[..., :6], full[..., 6:]])))
    lg = torch.from_numpy(full.copy()).requires_grad_()
    one = ParallelCrossEntropy(ignore_index=-100)(lg, torch.from_numpy(
        labels))
    (one * torch.from_numpy(ct)).sum().backward()
    for r in range(2):
        np.testing.assert_allclose(port[r]["ce"]["loss"], np.asarray(y[r]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(port[r]["ce"]["grad"], np.asarray(g[r]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(port[r]["ce"]["loss"],
                                   one.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(port[r]["ce"]["grad"],
                                   lg.grad.numpy()[..., r * 6:(r + 1) * 6],
                                   rtol=1e-5, atol=1e-6)
    assert np.all(port[0]["ce"]["loss"][labels == -100] == 0)
