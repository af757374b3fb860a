"""Activation recompute in the port (`distributed/fleet/utils/recompute.py`
and `GPTConfig.use_recompute`).

- With `use_recompute=True` in training mode every decoder layer's block
  runs through `recompute`: once in the forward and once more in the
  backward (counted by wrapping `GPTDecoderLayer._block`). Without the flag,
  or in eval mode, it runs once.
- On the CPU a gpt2-tiny with recompute equals the same model without it
  bit for bit: the loss and every parameter's gradient (the backward
  reruns the same ops on the same inputs).
- Held to the JAX model built with `use_recompute=True`: one ShardedTrainStep
  on each side, loss within atol = rtol = 1e-5 and the weights to the
  limits of tests/test_torch_train_step.py.
- `recompute(fn, *args, **kwargs)` passes keyword arguments through.
"""
import numpy as np
import pytest
import torch

from _torch_port import assert_params_match, one_cpu_mesh, train_batches, \
    train_models


def _loss_and_grads(model, ids, labels):
    model.zero_grad(set_to_none=True)
    loss = model(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}


@pytest.mark.parametrize("use_recompute,training,forwards,total", [
    (True, True, 2, 4),       # 2 layers: forward, then again in backward
    (False, True, 2, 2),
    (True, False, 2, 2),      # eval mode never recomputes
])
def test_decoder_layers_go_through_recompute(monkeypatch, use_recompute,
                                             training, forwards, total):
    from paddle_tpu_torch.models import gpt
    calls = []
    block = gpt.GPTDecoderLayer._block

    def counted(self, x):
        calls.append(torch.is_grad_enabled())
        return block(self, x)

    monkeypatch.setattr(gpt.GPTDecoderLayer, "_block", counted)
    m = gpt.GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                       use_recompute=use_recompute)
    m.train(training)
    ids, labels = train_batches(11)
    loss = m(torch.from_numpy(ids[0]), torch.from_numpy(labels[0]))
    assert len(calls) == forwards
    if use_recompute and training:
        # the checkpointed forward keeps no graph inside the block
        assert calls == [False] * forwards
    loss.backward()
    assert len(calls) == total


def test_recompute_is_bitwise_equal_to_keeping_activations():
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    plain = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu")
    rc = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                    use_recompute=True)
    rc.load_state_dict(plain.state_dict())
    plain.train()
    rc.train()
    ids, labels = train_batches(12)
    loss_p, grads_p = _loss_and_grads(plain, ids[0], labels[0])
    loss_r, grads_r = _loss_and_grads(rc, ids[0], labels[0])
    assert torch.equal(loss_p, loss_r)
    assert grads_p.keys() == grads_r.keys()
    for k in grads_p:
        assert torch.equal(grads_p[k], grads_r[k]), k


def test_recompute_train_step_matches_jax():
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parallel import ShardedTrainStep as JaxStep
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainStep
    jm, tm = train_models(use_recompute=True)
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    to = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
               grad_clip=ClipGradByGlobalNorm(1.0))
    ids, labels = train_batches(13)
    jstep = JaxStep(jm, jo, one_cpu_mesh(), zero_stage=0, donate=False)
    want = float(np.asarray(jstep(ids[0], labels[0]).data))
    got = ShardedTrainStep(tm, to, device="cpu")(ids[0], labels[0])
    np.testing.assert_allclose(float(got), want, atol=1e-5, rtol=1e-5)
    assert_params_match(jstep._params, tm, 1)


def test_recompute_passes_keyword_arguments():
    from paddle_tpu_torch.distributed.fleet.utils import recompute
    x = torch.arange(4.0, requires_grad=True)
    y = recompute(lambda a, scale=1.0: (a * scale).sin(), x, scale=3.0)
    y.sum().backward()
    torch.testing.assert_close(x.grad, 3.0 * torch.cos(3.0 * x.detach()))
