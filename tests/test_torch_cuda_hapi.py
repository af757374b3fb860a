"""The high-level path on the card (`cuda` marker; skipped without a GPU):
`Model.fit` over an `io.DataLoader` launches the fused-Adam kernel once
a leaf a step and no other port kernel, its batches come from pinned
memory, and `load` puts a checkpoint back on the card. No JAX here: on
the card's machine run it with `python -m pytest --noconftest`.
"""
import numpy as np
import pytest
import torch

from _torch_port import require_cuda


@pytest.mark.cuda
def test_cuda_model_fit_launches_fused_adam_once_a_leaf_a_step(tmp_path):
    require_cuda()
    import paddle_tpu_torch
    from paddle_tpu_torch.callbacks import ModelCheckpoint
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet
    rng = np.random.RandomState(0)
    x = rng.standard_normal((64, 1, 28, 28)).astype(np.float32)
    y = rng.randint(0, 10, (64,)).astype(np.int64)
    ds = TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    xb, yb = next(iter(DataLoader(ds, batch_size=16)))
    assert xb.is_pinned() and yb.is_pinned() and xb.device.type == "cpu"
    net = LeNet()
    assert next(net.parameters()).is_cuda
    model = paddle_tpu_torch.Model(net).prepare(
        Adam(learning_rate=1e-3, parameters=net.parameters()),
        CrossEntropyLoss(), Accuracy())
    _kernels.reset_launch_counts()
    for workers in (0, 2):
        model.fit(ds, batch_size=16, epochs=1, verbose=0,
                  num_workers=workers,
                  callbacks=[ModelCheckpoint(save_dir=str(tmp_path))])
    torch.cuda.synchronize()
    want = {k: 0 for k in _kernels.launch_counts()}
    want["fused_adam"] = 10 * 8          # 10 leaves, 2 x 4 steps
    assert _kernels.launch_counts() == want
    state = paddle_tpu_torch.load(str(tmp_path / "0.pdparams"))
    assert all(t.is_cuda for t in state.values())
    for k, v in net.state_dict().items():
        assert torch.equal(state[k], v)
