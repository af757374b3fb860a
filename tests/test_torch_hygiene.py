"""Rules the PyTorch port keeps, checked without a GPU.

- No file of `paddle_tpu_torch/`, nor `chip_smoke.py` or the
  `tools/profile_torch_*.py` profilers, imports `jax` or `paddle_tpu` (an
  AST scan).
- Entry points default to CUDA and raise without it, the train steps
  too; the CPU is used only when asked for.
- A kernel wrapper handed a CPU tensor takes the plain version and counts
  no launch; the `_cuda` entry points refuse CPU tensors.
- Importing the port builds nothing.
- Tests of the CUDA kernels carry the `cuda` marker and skip here.
- `chip_smoke.py` exits non-zero and prints no result without a GPU,
  also when it stands alone in a directory.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "paddle_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_paddle_tpu():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + sorted(
        (REPO / "tools").glob("profile_torch_*.py"))
    assert REPO / "tools" / "profile_torch_training.py" in files
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert bad == []


def test_entry_points_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch.core.device import (NoCUDADeviceError,
                                              resolve_device)
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
        GPTForCausalLM.from_preset("gpt2-tiny")
    with pytest.raises(NoCUDADeviceError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    m = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu")
    assert m.device == torch.device("cpu")
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep, ShardedTrainStep
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    for cls in (ScanTrainStep, ShardedTrainStep):
        with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
            cls(m, opt)
        assert cls(m, opt, device="cpu").device == torch.device("cpu")


def test_wrappers_take_plain_path_on_cpu_tensors():
    from paddle_tpu_torch.ops import _kernels, launch_counts
    from paddle_tpu_torch.ops.layernorm import (layer_norm_fwd,
                                                layer_norm_fwd_cuda,
                                                layer_norm_fwd_plain)
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_plain, ragged_paged_attention)
    before = launch_counts()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    w, b = torch.ones(16), torch.zeros(16)
    for got, want in zip(layer_norm_fwd(x, w, b, 1e-5),
                         layer_norm_fwd_plain(x, w, b, 1e-5)):
        assert torch.equal(got, want)
    q = torch.from_numpy(rng.standard_normal((1, 2, 3, 8))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 16, 8))
                         .astype(np.float32))
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    lens = torch.tensor([9], dtype=torch.int32)
    qp = torch.tensor([6], dtype=torch.int32)
    out = ragged_paged_attention(q, k, k, table, lens, qp, block_len=8)
    ref = paged_attention_plain(q, k, k, table, lens, qp, 8, 2, 8 ** -0.5)
    assert torch.equal(out, ref)
    # the training slice's wrappers: flash attention forward/backward and
    # the LayerNorm backward, through their autograd entry points
    from paddle_tpu_torch.ops.attention import (
        flash_attention, flash_bwd, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
        flash_bwd_plain, flash_fwd, flash_fwd_cuda, flash_fwd_plain)
    from paddle_tpu_torch.ops.layernorm import (fused_layer_norm,
                                                layer_norm_bwd,
                                                layer_norm_bwd_cuda,
                                                layer_norm_bwd_plain)
    qa = torch.from_numpy(rng.standard_normal((1, 2, 5, 16))
                          .astype(np.float32))
    out, lse = flash_fwd(qa, qa, qa, True, 0.25)
    ref_out, ref_lse = flash_fwd_plain(qa, qa, qa, True, 0.25)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    delta = (out * qa).sum(-1)
    for got, want in zip(flash_bwd(qa, qa, qa, out, lse, qa, True, 0.25),
                         flash_bwd_plain(qa, qa, qa, qa, lse, delta, True,
                                         0.25)):
        assert torch.equal(got, want)
    qg = qa.clone().requires_grad_()
    flash_attention(qg, qg, qg).sum().backward()
    _, mu, rstd = layer_norm_fwd_plain(x, w, b, 1e-5)
    for got, want in zip(layer_norm_bwd(x, w, mu, rstd, x),
                         layer_norm_bwd_plain(x, w, mu, rstd, x)):
        assert torch.equal(got, want)
    xg = x.clone().requires_grad_()
    fused_layer_norm(xg, w, b).sum().backward()
    assert launch_counts() == before
    assert _kernels._LIB is None              # nothing was built
    with pytest.raises(ValueError, match="CUDA tensors"):
        layer_norm_fwd_cuda(x, w, b, 1e-5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        layer_norm_bwd_cuda(x, w, mu, rstd, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_attention_cuda(q, k, k, table, lens, qp, 8, 2, 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_fwd_cuda(qa, qa, qa, True, 1.0)
    for fn in (flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(qa, qa, qa, qa, lse, delta, True, 1.0)


def test_kernel_tests_are_marked_cuda_and_skip_inside():
    """Every test of a CUDA kernel is marked `cuda` and decides inside the
    test (require_cuda) whether there is a card — never at import."""
    found = 0
    for f in sorted((REPO / "tests").glob("test_torch_*.py")):
        tree = ast.parse(f.read_text())
        for node in tree.body:
            if not (isinstance(node, ast.FunctionDef)
                    and node.name.startswith("test_cuda_")):
                continue
            found += 1
            marks = [ast.unparse(d) for d in node.decorator_list]
            assert "pytest.mark.cuda" in marks, (f.name, node.name)
            first = ast.unparse(node.body[0])
            assert first == "require_cuda()", (f.name, node.name)
    assert found >= 2


def test_launch_count_reset():
    from paddle_tpu_torch.ops import _kernels
    saved = _kernels.launch_counts()
    try:
        _kernels.LAUNCHES["paged_attention"] += 3
        _kernels.reset_launch_counts()
        assert set(_kernels.launch_counts().values()) == {0}
    finally:
        _kernels.LAUNCHES.update(saved)


def test_kernel_build_is_keyed_by_sources():
    from paddle_tpu_torch.ops import _kernels
    key = _kernels._source_key(list(_kernels.NVCC_FLAGS))
    assert key == _kernels._source_key(list(_kernels.NVCC_FLAGS))
    assert key != _kernels._source_key(list(_kernels.NVCC_FLAGS) + ["-G"])
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    assert _kernels._build_dir() == REPO / "build" / "paddle_tpu_torch"
    for src in _kernels.SOURCES:
        text = (_kernels.CSRC / src).read_text()
        assert "Replaces: paddle_tpu/ops/" in text
        assert "What bounds it on this card" in text


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       capture_output=True, text=True, timeout=120,
                       env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
