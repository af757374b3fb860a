"""The PyTorch port's training slice against the JAX package, end to end.

`gpt2-tiny`, B=2, S=64, labels with ignored (-100) tokens, AdamW (lr
1e-3, weight decay 0.01) with a global-norm clip of 1.0. The JAX
`ScanTrainStep` (K=3 on a one-CPU mesh, zero_stage=0) and the port's
`ScanTrainStep` on the CPU start from the same weights (bridged as numpy)
and take the same three batches: the per-step losses agree within
atol = rtol = 1e-5 (fp32; sums in another order). The final parameters:
Adam divides each gradient by its own scale, so where a gradient is near
0 the two sides' rounding can flip its sign and move that element's
update by up to 2 x lr a step. Every element is held within 2 x lr x
steps. The key part of each attention qkv bias has an exact gradient of
0 (softmax ignores a shift shared by all of a row's scores), so its
updates are rounding noise on both sides and get that bound alone; of
the other elements at most 1e-4 may be more than 1e-5 apart (4 of
~590,000 were when this was written); a wrong gradient moves most of
them. A one-step
`ShardedTrainStep` case holds the same. The port's step also refuses what
it does not carry: a mesh of several devices, strategy plans, and
running without a GPU unless asked for the CPU.
"""
import numpy as np
import pytest
import torch

import jax

K, B, S = 3, 2, 64


def _batches(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 512, (K, B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=2)
    labels[:, :, -1] = -100
    labels[:, 0, :7] = -100
    return ids, labels


def _models():
    """A fresh JAX gpt2-tiny (seed 0) and the port model with its weights."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu_torch.bridge import load_jax_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    paddle.seed(0)
    jm = JaxGPT.from_preset("gpt2-tiny")
    params, _ = jm.functional_state()
    tm = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu")
    load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()})
    tm.train()
    return jm, tm


def _optimizers(jm, tm):
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    weight_decay=0.01,
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    to = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
               weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    return jo, to


def _mesh():
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _key_bias(name, d, n_heads=4):
    """The key columns of a qkv bias ([head][q | k | v] x head_dim)."""
    if not name.endswith("qkv_proj.bias"):
        return np.zeros(d.shape, bool)
    mask = np.zeros((n_heads, 3, d.size // (3 * n_heads)), bool)
    mask[:, 1] = True
    return mask.reshape(d.shape)


def _assert_params_match(jax_params, tm, steps, lr=1e-3):
    from paddle_tpu_torch.bridge import export_state
    got = export_state(tm)
    assert set(got) == set(jax_params)
    far = total = 0
    for k, v in jax_params.items():
        d = np.abs(got[k] - np.asarray(v))
        assert d.max() <= 2 * lr * steps, (k, float(d.max()))
        rest = d[~_key_bias(k, d)]
        far += int((rest > 1e-5).sum())
        total += rest.size
    assert far <= 1e-4 * total, (far, total)


def test_scan_train_step_matches_jax():
    from paddle_tpu.parallel import ScanTrainStep as JaxScan
    from paddle_tpu_torch.parallel import ScanTrainStep
    jm, tm = _models()
    jo, to = _optimizers(jm, tm)
    ids, labels = _batches(0)
    jstep = JaxScan(jm, jo, _mesh(), scan_steps=K, zero_stage=0,
                    donate=False)
    want = np.asarray(jstep(ids, labels).data)
    step = ScanTrainStep(tm, to, scan_steps=K, device="cpu")
    got = step(ids, labels)
    assert got.shape == (K,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert got[-1] < got[0]
    assert step.dispatch_count == 1 and step._step_count == K
    np.testing.assert_allclose(step._lr_vector(K), jstep._lr_vector(K))
    _assert_params_match(jstep._params, tm, K)


def test_sharded_train_step_one_step_matches_jax():
    from paddle_tpu.parallel import ShardedTrainStep as JaxStep
    from paddle_tpu_torch.parallel import ShardedTrainStep
    jm, tm = _models()
    jo, to = _optimizers(jm, tm)
    ids, labels = _batches(1)
    jstep = JaxStep(jm, jo, _mesh(), zero_stage=0, donate=False)
    want = float(np.asarray(jstep(ids[0], labels[0]).data))
    step = ShardedTrainStep(tm, to, device="cpu")
    got = step(ids[0], labels[0])
    assert got.ndim == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, atol=1e-5, rtol=1e-5)
    _assert_params_match(jstep._params, tm, 1)
    assert all(p.grad is None for p in tm.parameters())


def test_stack_batches_matches_jax():
    from paddle_tpu.parallel import stack_batches as jstack
    from paddle_tpu_torch.parallel import stack_batches
    ids, labels = _batches(2)
    per_step = [(ids[i], torch.from_numpy(labels[i])) for i in range(K)]
    got = stack_batches(per_step)
    want = jstack([(ids[i], labels[i]) for i in range(K)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        stack_batches([])


def test_forward_without_labels_returns_logits_like_jax():
    import paddle_tpu as paddle
    jm, tm = _models()
    ids, _ = _batches(3)
    want = np.asarray(jm(paddle.to_tensor(ids[0])).data)
    got = tm(torch.from_numpy(ids[0]))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)


def test_step_refuses_what_it_does_not_carry(monkeypatch):
    from paddle_tpu_torch.core.device import NoCUDADeviceError
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep, ShardedTrainStep
    tm = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu")
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ShardedTrainStep(tm, opt, mesh=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ShardedTrainStep(tm, opt, device="cpu", plan=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCUDADeviceError):
        ScanTrainStep(tm, opt, scan_steps=2)
    step = ScanTrainStep(tm, opt, mesh=["cpu"], scan_steps=2)
    ids, labels = _batches(4)
    with pytest.raises(ValueError, match="stacked"):
        step(ids, labels)                    # K=3 chunk for a K=2 step


def test_flops_match_jax_and_peak_is_the_h100s():
    from paddle_tpu.obs.flops import train_flops_per_step as jax_flops
    from paddle_tpu_torch.obs.flops import peak_flops, train_flops_per_step
    assert train_flops_per_step(1_418_842_112, 4096) == \
        jax_flops(1_418_842_112, 4096)
    assert peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    for other in ("some other card", "NVIDIA H100 PCIe"):
        with pytest.raises(KeyError):
            peak_flops(other)
