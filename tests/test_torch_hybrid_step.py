"""Multi-rank training: the port's hybrid train step against the JAX
`ShardedTrainStep` on the same 4-device mesh.

Four ranks of a gloo group on the CPU (one spawn for the module; the
FileStore under tmp_path) run `fleet.init(strategy)` and
`parallelize(model, AdamW, strategy=s)` for each case of
`_torch_ranks.hybrid_cases`: tiny GPT and Llama at dp2 x mp2 with ZeRO 1
and at sharding2 x mp2 with ZeRO 2 and 3, and a global-norm clip that
binds. The weights are the JAX model's (seed 0), sharded into each rank
by `bridge.shard_state`. While the ranks run, the parent runs the JAX
step on a mesh of 4 of conftest's CPU devices with the same layout. Three
steps' losses and the full `state_dict()` after them must agree within
the JAX test's 2e-4 (tests/test_parallel.py), and each rank's moment
shapes must be the blocks `_zero_spec` gives its mesh position. The same
spawn checks that an fp16 step with an inf injected on one mp rank is
skipped by every rank, that ScanTrainStep with K = 2 gives the losses
of two steps, and that parameters set from outside between steps reach
the ZeRO shards."""
import pickle

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import _torch_ranks as R

N = 4
NAMES = ("data", "pipe", "sharding", "model")
TOL = dict(rtol=2e-4, atol=2e-4)


def _jax_model(preset):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForCausalLM
    from paddle_tpu.models.llama import LlamaForCausalLM
    paddle.seed(0)
    cls = GPTForCausalLM if preset.startswith("gpt") else LlamaForCausalLM
    return cls.from_preset(preset)


def _jax_case(preset, dims, zero, clip, sgd):
    from paddle_tpu import nn, optimizer as optim
    from paddle_tpu.parallel import ShardedTrainStep
    dp, sh, mp = dims
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(dp, 1, sh, mp), NAMES)
    jm = _jax_model(preset)
    kw = dict(parameters=jm.parameters(),
              grad_clip=nn.ClipGradByGlobalNorm(clip) if clip else None)
    opt = optim.SGD(learning_rate=1.0, **kw) if sgd else optim.AdamW(
        learning_rate=1e-3, **kw)
    step = ShardedTrainStep(jm, opt, mesh, zero_stage=zero)
    ids, labels = R.hybrid_batch(jm.config.vocab_size)
    losses = [float(step(ids[i], labels[i]).item()) for i in range(3)]
    state = {k: np.asarray(v.data if hasattr(v, "data") else v)
             for k, v in step.state_dict().items()}
    blocks = {}
    for k, per in step.opt_state_specs.items():
        if "moment1" not in step._opt_state[k]:
            continue
        arr = step._opt_state[k]["moment1"]
        blocks[k] = [tuple(s.data.shape) for s in sorted(
            arr.addressable_shards, key=lambda s: mesh.devices.reshape(-1)
            .tolist().index(s.device))]
    return {"losses": losses, "state": state, "blocks": blocks}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hybrid")
    for preset in ("gpt2-tiny", "llama2-tiny"):
        jm = _jax_model(preset)
        params, _ = jm.functional_state()
        np.savez(d / f"{preset}.npz",
                 **{k: np.asarray(v) for k, v in params.items()})
    ctx = R.run_ranks(R.hybrid_rank, (str(d), str(d)), N, d)
    jax_runs = {name: _jax_case(preset, dims, zero, extra.get("clip"),
                                extra.get("sgd", False))
                for name, preset, dims, zero, extra in R.hybrid_cases()}
    R.join_ranks(ctx)
    port = {}
    for r in range(N):
        with open(d / f"hybrid{r}.pkl", "rb") as f:
            port[r] = pickle.load(f)
    return port, jax_runs


@pytest.mark.parametrize("case", [c[0] for c in R.hybrid_cases()])
def test_losses_and_full_state_match_jax(runs, case):
    port, jax_runs = runs
    want = jax_runs[case]
    for r in range(N):
        np.testing.assert_allclose(port[r][case]["losses"], want["losses"],
                                   **TOL)
    got = port[0][case]["state"]
    assert set(got) == set(want["state"])
    for k, v in want["state"].items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)


@pytest.mark.parametrize("case", [c[0] for c in R.hybrid_cases()])
def test_moment_shards_are_zero_spec_blocks(runs, case):
    port, jax_runs = runs
    blocks = jax_runs[case]["blocks"]
    for r in range(N):
        mine = port[r][case]["moments"]
        assert set(mine) == set(blocks)
        for k, shape in mine.items():
            assert shape == blocks[k][r], (case, r, k)


def test_binding_clip_changes_the_losses(runs):
    """The clip binds: SGD's steps under it differ from the unclipped
    ones, and the clipped losses match JAX's (above), whose norm counts a
    replicated leaf once."""
    port, jax_runs = runs
    clipped = port[0]["gpt_dp2_mp2_clip"]["losses"]
    plain = port[0]["gpt_dp2_mp2_sgd"]["losses"]
    assert clipped[0] == pytest.approx(plain[0], abs=1e-6)
    assert abs(clipped[2] - plain[2]) > 1e-2


@pytest.mark.parametrize("case", ["gpt_dp2_mp2_sgd", "gpt_dp2_mp2_clip"])
def test_sgd_updates_match_jax_closely(runs, case):
    """Under SGD a wrong clip factor or a wrong gradient average scales
    the update, which the 2e-4 state tolerance above can miss on small
    updates: each leaf's change over the three steps must match JAX's to
    1e-3 of its size (a replicated leaf counted twice in the clip's norm
    moved every update by 0.45%)."""
    port, jax_runs = runs
    params, _ = _jax_model("gpt2-tiny").functional_state()
    got, want = port[0][case]["state"], jax_runs[case]["state"]
    for k, w0 in params.items():
        w0 = np.asarray(w0)
        d_jax = want[k] - w0
        err = np.linalg.norm((got[k] - w0) - d_jax)
        assert err <= 1e-3 * np.linalg.norm(d_jax) + 1e-7, (k, err)


def test_fp16_inf_on_one_mp_rank_skips_every_rank(runs):
    port, _ = runs
    for r in range(N):
        got = port[r]["fp16_skip"]
        assert got["unchanged"], r
        assert got["scale1"] == got["scale0"] / 2, r
        assert got["moved_after"], r


def test_scan_step_equals_two_steps(runs):
    port, _ = runs
    for r in range(N):
        np.testing.assert_allclose(port[r]["scan"][2], port[r]["scan"][1],
                                   rtol=1e-6, atol=1e-6)


def test_parameters_set_between_steps_reach_the_shards(runs):
    port, _ = runs
    for r in range(N):
        first, again = port[r]["set_between_steps"]
        assert first[1] != first[0], r
        np.testing.assert_allclose(again, first, rtol=1e-6, atol=1e-6)
