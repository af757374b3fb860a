"""The port's high-level path (`Model`, the callbacks, `save`/`load`)
against the JAX package's, on the CPU.

- `Model.fit` (2 epochs x 4 batches, shuffle=False, eval each epoch),
  then `evaluate` and `predict`, on both packages from the same weights:
  an MLP with Adam, LeNet with SGD and with Adam. Every batch's loss and
  accuracy, every eval's logs, the predictions within 1e-5 (MLP) or
  1e-4 (LeNet, whose logits are sums of up to 400 products in another
  order); the final weights within 6 x lr. The JAX networks are built
  abstractly and take the port's weights (`_torch_port.jax_twin_of`).
- `EarlyStopping` stops at JAX's epoch; `ModelCheckpoint` (and
  `fit(save_dir=)`) write JAX's files; `LRScheduler` steps the optimizer's
  schedule as JAX's, by step and by epoch.
- `save`/`load` round trips, bf16 included; `.pdparams` and `.pdopt`
  cross both ways, with a parameter named by `ParamAttr(name=)` (its
  slots keyed by that name, the others by index), and the next Adam step
  after a cross-load equals the other side's (losses within 1e-6,
  weights within 1e-6).
- `summary` and `Model.parameters` count as the JAX `Model`'s.
"""
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU)

from _torch_port import jax_twin_of

EPOCHS = 2
BATCH = 8
N = 32                    # 4 batches an epoch


def _init(net, seed=0):
    """Draw a port net's weights (its layers are made empty)."""
    from paddle_tpu_torch.nn.layer.layers import init_parameters
    init_parameters(net, torch.Generator().manual_seed(seed))
    return net


def _mlp(nn, **kw):
    return nn.Sequential(nn.Linear(8, 16, **kw), nn.ReLU(),
                         nn.Linear(16, 4, **kw))


def _lenet(paddle_mod, **kw):
    return paddle_mod.vision.models.LeNet(**kw)


def _data(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "mlp":
        x = rng.standard_normal((N, 8)).astype(np.float32)
        y = (x @ rng.standard_normal((8, 4))).argmax(-1).astype(np.int64)
    else:
        x = rng.standard_normal((N, 1, 28, 28)).astype(np.float32)
        y = rng.randint(0, 10, (N,)).astype(np.int64)
    return x, y


def _datasets(x, y):
    import paddle_tpu as paddle
    from paddle_tpu.io import TensorDataset as JTD
    from paddle_tpu_torch.io import TensorDataset
    return (JTD([paddle.to_tensor(x), paddle.to_tensor(y)]),
            TensorDataset([torch.from_numpy(x), torch.from_numpy(y)]))


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.batches, self.evals, self.epochs, self.lrs = [], [], [], []

        def on_epoch_begin(self, epoch, logs=None):
            self.epochs.append(epoch)

        def on_train_batch_end(self, step, logs=None):
            self.batches.append(dict(logs))
            self.lrs.append(self.model._optimizer.get_lr())

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs))

    return Recorder()


def _twins(kind):
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch
    import paddle_tpu_torch.nn as tnn
    if kind == "mlp":
        tm = _init(_mlp(tnn, device="cpu"))
        return jax_twin_of(tm, lambda: _mlp(jnn)), tm
    tm = _lenet(paddle_tpu_torch, device="cpu")
    return jax_twin_of(tm, lambda: _lenet(paddle)), tm


def _optimizer(mod, name, lr, params):
    return getattr(mod, name)(learning_rate=lr, parameters=params)


def _logs_close(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   atol=tol, rtol=tol, err_msg=k)


@pytest.mark.parametrize("kind,opt,lr,tol", [("mlp", "Adam", 1e-2, 1e-5),
                                             ("lenet", "SGD", 1e-2, 1e-4),
                                             ("lenet", "Adam", 1e-3, 1e-4)])
def test_fit_evaluate_predict_match_jax(kind, opt, lr, tol):
    import paddle_tpu as paddle
    import paddle_tpu.hapi.callbacks as jcb
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt
    import paddle_tpu_torch
    import paddle_tpu_torch.hapi.callbacks as tcb
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.optimizer as topt
    from paddle_tpu.io import TensorDataset as JTD
    from paddle_tpu.metric import Accuracy as JAcc
    from paddle_tpu_torch.bridge import export_state
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.metric import Accuracy
    jm, tm = _twins(kind)
    x, y = _data(kind)
    jds, tds = _datasets(x, y)
    runs = {}
    for side, net, pkg, nn, optm, acc, cb in (
            ("jax", jm, paddle, jnn, jopt, JAcc, jcb),
            ("port", tm, paddle_tpu_torch, tnn, topt, Accuracy, tcb)):
        model = pkg.Model(net).prepare(
            _optimizer(optm, opt, lr, net.parameters()),
            nn.CrossEntropyLoss(), acc())
        rec = _recorder(cb.Callback)
        ds = jds if side == "jax" else tds
        model.fit(ds, eval_data=ds, batch_size=BATCH, epochs=EPOCHS,
                  shuffle=False, verbose=0, callbacks=[rec])
        logs = model.evaluate(ds, batch_size=BATCH, verbose=0)
        xs = (JTD([paddle.to_tensor(x)]) if side == "jax"
              else TensorDataset([torch.from_numpy(x)]))
        pred = model.predict(xs, batch_size=BATCH, stack_outputs=True)
        runs[side] = (rec, logs, pred)
    (jrec, jlogs, jpred), (trec, tlogs, tpred) = runs["jax"], runs["port"]
    assert len(trec.batches) == len(jrec.batches) == EPOCHS * N // BATCH
    for g, w in zip(trec.batches, jrec.batches):
        _logs_close(g, w, tol)
    assert len(trec.evals) == len(jrec.evals) == EPOCHS
    for g, w in zip(trec.evals + [tlogs], jrec.evals + [jlogs]):
        _logs_close(g, w, tol)
    assert len(tpred) == len(jpred) == 1 and tpred[0].shape == jpred[0].shape
    np.testing.assert_allclose(tpred[0], jpred[0], atol=tol, rtol=tol)
    got = export_state(tm)
    for k, v in jm.functional_state()[0].items():
        d = np.abs(got[k] - np.asarray(v))
        assert d.max() <= 6 * lr, (k, float(d.max()))
    assert all(p.grad is None for p in tm.parameters())


def test_host_syncs_are_counted_and_batches_reach_the_device():
    import paddle_tpu_torch
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.optimizer import Adam
    tm = _init(_mlp(tnn, device="cpu"))
    model = paddle_tpu_torch.Model(tm).prepare(
        Adam(learning_rate=1e-2, parameters=tm.parameters()),
        tnn.CrossEntropyLoss(), Accuracy(topk=(1, 2)))
    assert model.device == torch.device("cpu")
    x, y = _data("mlp")
    loss, accs = model.train_batch([x[:8]], [y[:8]])      # numpy batches
    assert len(loss) == 1 and len(accs) == 1 and len(accs[0]) == 2
    assert model.host_sync_s["metrics"] > 0 and model.host_sync_s["loss"] > 0
    with pytest.raises(NotImplementedError):
        model.prepare(amp_configs={"level": "O1"})
    with pytest.raises(NotImplementedError):
        model.fit(_datasets(x, y)[1], accumulate_grad_batches=2, verbose=0)


def test_early_stopping_stops_at_jax_epoch():
    import paddle_tpu as paddle
    import paddle_tpu.hapi.callbacks as jcb
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt
    import paddle_tpu_torch
    import paddle_tpu_torch.hapi.callbacks as tcb
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.optimizer as topt
    from paddle_tpu.metric import Accuracy as JAcc
    from paddle_tpu_torch.metric import Accuracy
    x, y = _data("mlp", seed=1)
    jds, tds = _datasets(x, y)
    for lr, kw in ((0.0, dict(monitor="loss", patience=1, mode="min")),
                   (0.05, dict(monitor="acc", patience=0, mode="auto",
                               min_delta=0.2))):
        jm, tm = _twins("mlp")
        epochs = {}
        for side, net, pkg, nn, optm, acc, cb, ds in (
                ("jax", jm, paddle, jnn, jopt, JAcc, jcb, jds),
                ("port", tm, paddle_tpu_torch, tnn, topt, Accuracy, tcb,
                 tds)):
            model = pkg.Model(net).prepare(
                optm.SGD(learning_rate=lr, parameters=net.parameters()),
                nn.CrossEntropyLoss(), acc())
            es, rec = cb.EarlyStopping(**kw), _recorder(cb.Callback)
            model.fit(ds, eval_data=ds, epochs=6, batch_size=16, verbose=0,
                      shuffle=False, callbacks=[es, rec])
            epochs[side] = (rec.epochs, model.stop_training, es.wait,
                            es.best)
        assert epochs["port"][:3] == epochs["jax"][:3]
        assert epochs["port"][1] and len(epochs["port"][0]) < 6
        np.testing.assert_allclose(epochs["port"][3], epochs["jax"][3],
                                   atol=1e-6)


def test_model_checkpoint_writes_jax_files(tmp_path):
    import paddle_tpu as paddle
    import paddle_tpu.hapi.callbacks as jcb
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt
    import paddle_tpu_torch
    import paddle_tpu_torch.hapi.callbacks as tcb
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.optimizer as topt
    x, y = _data("mlp", seed=2)
    jds, tds = _datasets(x, y)
    jm, tm = _twins("mlp")
    files = {}
    for side, net, pkg, nn, optm, cb, ds in (
            ("jax", jm, paddle, jnn, jopt, jcb, jds),
            ("port", tm, paddle_tpu_torch, tnn, topt, tcb, tds)):
        model = pkg.Model(net).prepare(
            optm.Adam(learning_rate=1e-2, parameters=net.parameters()),
            nn.CrossEntropyLoss())
        a, b = tmp_path / side / "cb", tmp_path / side / "arg"
        model.fit(ds, epochs=3, batch_size=16, verbose=0, shuffle=False,
                  callbacks=[cb.ModelCheckpoint(save_freq=2,
                                                save_dir=str(a))])
        model.fit(ds, epochs=2, batch_size=16, verbose=0, shuffle=False,
                  save_dir=str(b))
        files[side] = (sorted(os.listdir(a)), sorted(os.listdir(b)))
    assert files["port"] == files["jax"]
    assert files["port"] == (["1.pdopt", "1.pdparams"],
                             ["0.pdopt", "0.pdparams", "1.pdopt",
                              "1.pdparams"])
    # the last checkpoint holds the weights the fit ended with
    state = paddle_tpu_torch.load(str(tmp_path / "port" / "arg" /
                                      "1.pdparams"), device="cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(state[k], v)


@pytest.mark.parametrize("by", ["step", "epoch"])
def test_lr_scheduler_callback_steps_as_jax(by):
    import paddle_tpu as paddle
    import paddle_tpu.hapi.callbacks as jcb
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt
    import paddle_tpu_torch
    import paddle_tpu_torch.hapi.callbacks as tcb
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.optimizer as topt
    x, y = _data("mlp", seed=3)
    jds, tds = _datasets(x, y)
    jm, tm = _twins("mlp")
    lrs = {}
    for side, net, pkg, nn, optm, cb, ds in (
            ("jax", jm, paddle, jnn, jopt, jcb, jds),
            ("port", tm, paddle_tpu_torch, tnn, topt, tcb, tds)):
        sched = optm.lr.StepDecay(learning_rate=0.1,
                                  step_size=3 if by == "step" else 1,
                                  gamma=0.5)
        model = pkg.Model(net).prepare(
            optm.SGD(learning_rate=sched, parameters=net.parameters()),
            nn.CrossEntropyLoss())
        rec = _recorder(cb.Callback)
        model.fit(ds, epochs=3, batch_size=8, verbose=0, shuffle=False,
                  callbacks=[cb.LRScheduler(by_step=by == "step",
                                            by_epoch=by == "epoch"), rec])
        lrs[side] = rec.lrs
    assert lrs["port"] == lrs["jax"]
    assert len(set(lrs["port"])) > 1


def _named_net(nn, ParamAttr, **kw):
    return nn.Sequential(
        nn.Linear(6, 5, weight_attr=ParamAttr(name="fc_w"), **kw),
        nn.ReLU(), nn.Linear(5, 3, **kw))


def _cross_models():
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt
    import paddle_tpu_torch
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.optimizer as topt
    from paddle_tpu_torch.nn.layer.layers import ParamAttr
    tm = _init(_named_net(tnn, ParamAttr, device="cpu"))
    jm = jax_twin_of(tm, lambda: _named_net(jnn, paddle.ParamAttr))
    jmodel = paddle.Model(jm).prepare(
        jopt.Adam(learning_rate=1e-2, parameters=jm.parameters()),
        jnn.CrossEntropyLoss())
    tmodel = paddle_tpu_torch.Model(tm).prepare(
        topt.Adam(learning_rate=1e-2, parameters=tm.parameters()),
        tnn.CrossEntropyLoss())
    return jmodel, tmodel


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((8, 6)).astype(np.float32),
            rng.randint(0, 3, (8,)).astype(np.int64))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pdparams_and_pdopt_cross_both_ways(tmp_path, writer):
    """One side trains two steps and saves; the other side's fresh model
    loads both files; then each side takes the same next step."""
    import paddle_tpu as paddle
    from paddle_tpu_torch.bridge import export_state
    jmodel, tmodel = _cross_models()
    src, dst = (jmodel, tmodel) if writer == "jax" else (tmodel, jmodel)

    def step(model, seed):
        x, y = _batch(seed)
        if model is jmodel:
            return model.train_batch([paddle.to_tensor(x)],
                                     [paddle.to_tensor(y)])[0]
        return model.train_batch([torch.from_numpy(x)],
                                 [torch.from_numpy(y)])[0]

    step(src, 0)
    step(src, 1)
    path = str(tmp_path / "ck")
    src.save(path)
    dst.load(path)
    sd = paddle_tpu_torch_load(path + ".pdopt")
    assert {k.split("__")[0] for k in sd if "__" in k} == {"fc_w", "1", "2",
                                                           "3"}
    assert sd["_step_count"] == 2
    jw = {k: np.asarray(v) for k, v in
          jmodel.network.functional_state()[0].items()}
    tw = export_state(tmodel.network)
    for k in jw:
        np.testing.assert_array_equal(tw[k], jw[k])
    for p_j, p_t in zip(jmodel._optimizer._parameter_list,
                        tmodel._optimizer._parameter_list):
        js = jmodel._optimizer._state[id(p_j)]
        ts = tmodel._optimizer.state[p_t]
        assert set(js) == set(ts)
        for s in js:
            np.testing.assert_array_equal(ts[s].numpy(), np.asarray(js[s]))
    assert tmodel._optimizer._step_count == \
        jmodel._optimizer._step_count == 2
    lj, lt = step(jmodel, 2), step(tmodel, 2)
    np.testing.assert_allclose(lt, lj, atol=1e-6, rtol=1e-6)
    jw = {k: np.asarray(v) for k, v in
          jmodel.network.functional_state()[0].items()}
    tw = export_state(tmodel.network)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], atol=1e-6, rtol=1e-6)


def paddle_tpu_torch_load(path):
    import paddle_tpu_torch
    return paddle_tpu_torch.load(path, device="cpu")


def test_save_load_round_trips_and_bf16_crosses(tmp_path):
    import paddle_tpu as paddle
    import paddle_tpu_torch
    from paddle_tpu_torch.core.device import NoCUDADeviceError
    rng = np.random.RandomState(5)
    w32 = rng.standard_normal((3, 4)).astype(np.float32)
    obj = {"w": torch.from_numpy(w32).to(torch.bfloat16),
           "i": torch.arange(5, dtype=torch.int32),
           "nest": [torch.ones(2), (3, "x")], "step": 7, "lr": 0.5}
    path = str(tmp_path / "sub" / "obj.pdparams")
    paddle_tpu_torch.save(obj, path)
    back = paddle_tpu_torch.load(path, device="cpu")
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"],
                                                             obj["w"])
    assert torch.equal(back["i"], obj["i"])
    assert torch.equal(back["nest"][0], obj["nest"][0])
    assert back["nest"][1] == (3, "x") and back["step"] == 7
    if not torch.cuda.is_available():
        with pytest.raises(NoCUDADeviceError):
            paddle_tpu_torch.load(path)
    # port -> JAX
    j = paddle.load(path)
    assert str(j["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(j["w"].astype("float32")),
                                  obj["w"].float().numpy())
    np.testing.assert_array_equal(np.asarray(j["i"].numpy()),
                                  np.arange(5))
    # JAX -> port
    jpath = str(tmp_path / "j.pdparams")
    paddle.save({"w": paddle.to_tensor(w32).astype("bfloat16"),
                 "f": paddle.to_tensor(w32)}, jpath)
    t = paddle_tpu_torch.load(jpath, device="cpu")
    assert t["w"].dtype == torch.bfloat16 and t["f"].dtype == torch.float32
    assert torch.equal(t["w"], obj["w"])
    np.testing.assert_array_equal(t["f"].numpy(), w32)


def test_bf16_network_crosses_into_jax(tmp_path):
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch
    import paddle_tpu_torch.nn as tnn
    tm = _init(_mlp(tnn, device="cpu")).to(torch.bfloat16)
    path = str(tmp_path / "bf16")
    paddle_tpu_torch.Model(tm).save(path, training=False)
    assert not os.path.exists(path + ".pdopt")
    jm = paddle.Model(_mlp(jnn).to(dtype="bfloat16"))
    jm.load(path)
    for k, v in jm.network.state_dict().items():
        assert str(v.dtype) == "bfloat16"
        np.testing.assert_array_equal(
            np.asarray(v.astype("float32").numpy()),
            tm.state_dict()[k].float().numpy())


def test_summary_counts_as_jax(capsys):
    """Against the JAX `Model.summary`: the JAX package-level
    `paddle_tpu.summary` raises, because in that module `sum` is the
    package's tensor `sum`, not the builtin (a fault on the reference's
    side); the port's package-level `summary` is the Model's."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch
    import paddle_tpu_torch.nn as tnn
    tm = _init(_mlp(tnn, device="cpu"))
    tm[0].weight.requires_grad_(False)
    jm = jax_twin_of(tm, lambda: _mlp(jnn))
    jm[0].weight.trainable = False
    want = paddle.Model(jm).summary()
    jout = capsys.readouterr().out
    assert paddle_tpu_torch.summary(tm) == want
    assert paddle_tpu_torch.Model(tm).summary() == want
    assert capsys.readouterr().out == jout * 2
    assert want == {"total_params": 212, "trainable_params": 84}
    assert len(list(paddle_tpu_torch.Model(tm).parameters())) == 4
