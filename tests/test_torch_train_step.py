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
`ShardedTrainStep` case holds the same, and so does llama2-tiny (with
and without grouped-query attention and recompute), which has no biases. The port's step also refuses what
it does not carry: a mesh of several devices, a plan that is not a
`CompiledStrategy`, and running without a GPU unless asked for the CPU.
"""
import numpy as np
import pytest
import torch


from _torch_port import assert_params_match, one_cpu_mesh, train_batches, \
    train_models

K, B, S = 3, 2, 64


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


def _scan_train_step_matches_jax(jm, tm, one_batch=False):
    """K steps of both ScanTrainSteps over train_batches(0), or over its
    first batch K times with `one_batch`."""
    from paddle_tpu.parallel import ScanTrainStep as JaxScan
    from paddle_tpu_torch.parallel import ScanTrainStep
    jo, to = _optimizers(jm, tm)
    ids, labels = train_batches(0)
    if one_batch:
        ids, labels = (np.repeat(a[:1], K, axis=0) for a in (ids, labels))
    jstep = JaxScan(jm, jo, one_cpu_mesh(), scan_steps=K, zero_stage=0,
                    donate=False)
    want = np.asarray(jstep(ids, labels).data)
    step = ScanTrainStep(tm, to, scan_steps=K, device="cpu")
    got = step(ids, labels)
    assert got.shape == (K,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert got[-1] < got[0]
    assert step.dispatch_count == 1 and step._step_count == K
    np.testing.assert_allclose(step._lr_vector(K), jstep._lr_vector(K))
    assert_params_match(jstep._params, tm, K)


def test_scan_train_step_matches_jax():
    _scan_train_step_matches_jax(*train_models())


@pytest.mark.parametrize("kv_heads,recompute", [(4, False), (2, False),
                                                (4, True), (2, True)])
def test_llama_scan_train_step_matches_jax(kv_heads, recompute):
    """llama2-tiny through both ScanTrainSteps, as given and with
    grouped-query attention, with recompute off and on: the loss through
    ParallelCrossEntropy over the full logits. One batch repeated, as the
    chip's train cells repeat theirs, so the loss must fall in 3 steps
    (over three different random batches it need not)."""
    _scan_train_step_matches_jax(*train_models(
        "llama2-tiny", num_key_value_heads=kv_heads,
        use_recompute=recompute), one_batch=True)


def test_sharded_train_step_one_step_matches_jax():
    from paddle_tpu.parallel import ShardedTrainStep as JaxStep
    from paddle_tpu_torch.parallel import ShardedTrainStep
    jm, tm = train_models()
    jo, to = _optimizers(jm, tm)
    ids, labels = train_batches(1)
    jstep = JaxStep(jm, jo, one_cpu_mesh(), zero_stage=0, donate=False)
    want = float(np.asarray(jstep(ids[0], labels[0]).data))
    step = ShardedTrainStep(tm, to, device="cpu")
    got = step(ids[0], labels[0])
    assert got.ndim == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, atol=1e-5, rtol=1e-5)
    assert_params_match(jstep._params, tm, 1)
    assert all(p.grad is None for p in tm.parameters())


def test_stack_batches_matches_jax():
    from paddle_tpu.parallel import stack_batches as jstack
    from paddle_tpu_torch.parallel import stack_batches
    ids, labels = train_batches(2)
    per_step = [(ids[i], torch.from_numpy(labels[i])) for i in range(K)]
    got = stack_batches(per_step)
    want = jstack([(ids[i], labels[i]) for i in range(K)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        stack_batches([])


def test_forward_without_labels_returns_logits_like_jax():
    import paddle_tpu as paddle
    jm, tm = train_models()
    ids, _ = train_batches(3)
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
    with pytest.raises(NotImplementedError, match="one process a rank"):
        ShardedTrainStep(tm, opt, mesh=["cpu", "cpu"])
    with pytest.raises(TypeError, match="CompiledStrategy"):
        ShardedTrainStep(tm, opt, device="cpu", plan=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCUDADeviceError):
        ScanTrainStep(tm, opt, scan_steps=2)
    step = ScanTrainStep(tm, opt, mesh=["cpu"], scan_steps=2)
    ids, labels = train_batches(4)
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


def _decays(name):
    """The recipe's decay filter: neither a bias nor a LayerNorm
    parameter (`gpt.layers.0.norm1.weight`, `gpt.final_norm.bias`)."""
    return not (name.endswith(".bias") or "norm" in name)


def _half_first_layer(param):
    return 0.5 if ".layers.0." in param.name else 1.0


def _option_optimizers(case, jm, tm):
    """(JAX optimizer, port optimizer, fresh JAX scheduler or None, peak
    lr) for one case of test_scan_train_step_options_match_jax."""
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.regularizer import L1Decay as JL1
    import paddle_tpu_torch.optimizer.lr as tlr
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.regularizer import L1Decay

    def sched(m):
        if case == "schedule":
            return m.LinearWarmup(m.CosineAnnealingDecay(
                1e-3, T_max=4, eta_min=1e-4), warmup_steps=1, start_lr=2e-4,
                end_lr=1e-3)
        return m.LinearWarmup(m.CosineAnnealingDecay(
            1e-3, T_max=9, eta_min=1e-4), warmup_steps=2, start_lr=0.0,
            end_lr=1e-3)

    clip = dict(j=paddle.nn.ClipGradByGlobalNorm(1.0),
                t=ClipGradByGlobalNorm(1.0))
    if case == "l1":
        kw = dict(learning_rate=1e-3)
        return (jopt.Adam(parameters=jm.parameters(), weight_decay=JL1(0.01),
                          grad_clip=clip["j"], **kw),
                topt.Adam(parameters=tm.parameters(),
                          weight_decay=L1Decay(0.01), grad_clip=clip["t"],
                          **kw), None, 1e-3)
    if case == "filter_ratio":
        kw = dict(learning_rate=1e-3, weight_decay=0.1,
                  apply_decay_param_fun=_decays, lr_ratio=_half_first_layer)
        return (jopt.AdamW(parameters=jm.parameters(), grad_clip=clip["j"],
                           **kw),
                topt.AdamW(parameters=tm.parameters(), grad_clip=clip["t"],
                           **kw), None, 1e-3)
    kw = dict(weight_decay=0.01)
    if case == "recipe":
        kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1,
                  moment_dtype="bfloat16", apply_decay_param_fun=_decays)
    return (jopt.AdamW(learning_rate=sched(jopt.lr),
                       parameters=jm.parameters(), grad_clip=clip["j"], **kw),
            topt.AdamW(learning_rate=sched(tlr), parameters=tm.parameters(),
                       grad_clip=clip["t"], **kw), sched(jopt.lr), 1e-3)


@pytest.mark.parametrize("case", ["schedule", "filter_ratio", "l1",
                                  "recipe"])
def test_scan_train_step_options_match_jax(case):
    """LR schedule, decay filter by name with lr_ratio, L1Decay, and the
    whole recipe (bf16 moments, clip, schedule, decay filter, recompute)
    through both ScanTrainSteps: the lr vector each step used, the losses
    and the final weights, to this file's limits."""
    from paddle_tpu.parallel import ScanTrainStep as JaxScan
    from paddle_tpu_torch.parallel import ScanTrainStep
    over = dict(use_recompute=True) if case == "recipe" else {}
    jm, tm = train_models(**over)
    jo, to, jsched, peak = _option_optimizers(case, jm, tm)
    ids, labels = train_batches(5)
    jstep = JaxScan(jm, jo, one_cpu_mesh(), scan_steps=K, zero_stage=0,
                    donate=False)
    want = np.asarray(jstep(ids, labels).data)
    step = ScanTrainStep(tm, to, scan_steps=K, device="cpu")
    got = step(ids, labels)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if jsched is None:
        np.testing.assert_array_equal(step.lr_vector,
                                      np.full(K, 1e-3, np.float32))
    else:
        host = []
        for _ in range(K):
            host.append(jsched())
            jsched.step()
        np.testing.assert_array_equal(step.lr_vector,
                                      np.asarray(host, np.float32))
        assert len(set(host)) == K                 # the schedule moved
        assert to._lr_scheduler.last_epoch == \
            jo._lr_scheduler.last_epoch == K
    assert_params_match(jstep._params, tm, K, lr=peak)
    if case == "recipe":
        slots = to.state[tm.gpt.layers[0].norm1.weight]
        assert slots["moment1"].dtype == torch.bfloat16
