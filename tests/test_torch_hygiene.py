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
    for new in ("vision/__init__.py", "vision/models/resnet.py",
                "hapi/dynamic_flops.py", "tensor/manipulation.py",
                "nn/functional/conv.py", "nn/functional/pooling.py"):
        assert PORT / new in files, new
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
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
        LlamaForCausalLM.from_preset("llama2-tiny")
    from paddle_tpu_torch.vision.models import resnet18
    with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
        resnet18()
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
    # the multi-rank entry points: a CUDA layout raises before any process
    # group starts
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet, init_parallel_env
    with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
        init_parallel_env()
    with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
        fleet.init(is_collective=True)
    with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
        init_parallel_env(device="cuda:0")
    assert not dist.is_initialized()


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
    # the optimizer slice's wrapper: fused Adam, through the optimizer too
    from paddle_tpu_torch.ops.fused_adam import (fused_adam,
                                                 fused_adam_cuda,
                                                 fused_adam_plain)
    one = torch.tensor(0.5)
    adam = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=True)
    pa, pb = x.clone(), x.clone()
    ma, mb = torch.zeros(4, 16), torch.zeros(4, 16)
    fused_adam(pa, x, ma, ma.clone(), one, one, one, 0.01, **adam)
    fused_adam_plain(pb, x, mb, mb.clone(), one, one, one, 0.01, **adam)
    assert torch.equal(pa, pb) and torch.equal(ma, mb)
    from paddle_tpu_torch.optimizer import AdamW
    par = torch.nn.Parameter(x.clone())
    par.grad = x.clone()
    AdamW(learning_rate=0.1, parameters=[par]).step()
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
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_adam_cuda(pa, x, ma, mb, one, one, one, 0.0, **adam)


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
    saved_routes = _kernels.route_counts()
    try:
        _kernels.LAUNCHES["paged_attention"] += 3
        _kernels.ROUTE_LAUNCHES["paged_attention:tensor_cores"] += 3
        _kernels.reset_launch_counts()
        assert set(_kernels.launch_counts().values()) == {0}
        assert set(_kernels.route_counts().values()) == {0}
    finally:
        _kernels.LAUNCHES.update(saved)
        _kernels.ROUTE_LAUNCHES.update(saved_routes)


def test_sass_opcode_count():
    """The tensor-core proof reads cuobjdump's listing function by
    function, opcode with or without modifiers."""
    from paddle_tpu_torch.ops._kernels import count_sass_opcodes
    sass = """
        Function : _Z19flash_fwd_kernel_tc
        /*0100*/          HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;
        /*0110*/          HGMMA.64x128x16.F32.BF16 R88, R8, gdesc[UR8] ;
        /*0120*/                   FMUL R2, R3, R4 ;
        Function : _Z16layernorm_kernel
        /*0100*/                   FADD R2, R3, R4 ;
        Function : _Z8mma_demo
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
    """
    assert count_sass_opcodes(sass, ("HMMA", "HGMMA")) == {
        "_Z19flash_fwd_kernel_tc": {"HMMA": 0, "HGMMA": 2},
        "_Z8mma_demo": {"HMMA": 1, "HGMMA": 0}}


def test_ptxas_report_parse():
    """The spill check reads ptxas's -v report entry function by entry
    function; a non-inlined device function's properties are not
    counted against the kernel before it."""
    from paddle_tpu_torch.ops._kernels import ptxas_kernel_stats
    report = """== paged_attention_tc.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z25paged_attention_kernel_tcILi128ELi1EEv' for 'sm_90a'
ptxas info    : Function properties for _Z25paged_attention_kernel_tcILi128ELi1EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 384 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_Z22flash_bwd_dq_kernel_tcILi64EEv' for 'sm_90a'
ptxas info    : Function properties for _Z22flash_bwd_dq_kernel_tcILi64EEv
    0 bytes stack frame, 48 bytes spill stores, 52 bytes spill loads
ptxas info    : Used 167 registers, used 1 barriers, 528 bytes cmem[0]
"""
    assert ptxas_kernel_stats(report) == {
        "_Z25paged_attention_kernel_tcILi128ELi1EEv": {
            "registers": 168, "spill_stores": 0, "spill_loads": 0},
        "_Z22flash_bwd_dq_kernel_tcILi64EEv": {
            "registers": 167, "spill_stores": 48, "spill_loads": 52}}


def test_tensor_core_kernels_need_their_instructions():
    """chip_smoke's tensor-core proof: every instantiation of a kernel must
    hold one of the instructions TENSOR_CORE_KERNELS names for it (HGMMA
    for the wgmma kernels, HMMA or HGMMA for the mma.sync one)."""
    import chip_smoke
    counts = {"_Z22flash_bwd_dq_kernel_tcILi64E": {"HMMA": 0, "HGMMA": 24},
              "_Z22flash_bwd_dq_kernel_tcILi128E": {"HMMA": 4, "HGMMA": 0},
              "_Z25paged_attention_kernel_tcILi64E": {"HMMA": 60,
                                                      "HGMMA": 0}}
    table = chip_smoke.TENSOR_CORE_KERNELS
    assert set(table) == {"flash_fwd_kernel_tc", "flash_bwd_dq_kernel_tc",
                          "flash_bwd_dkv_kernel_tc",
                          "paged_attention_kernel_tc"}
    got = chip_smoke.tensor_core_instructions
    assert got(counts, "paged_attention_kernel_tc",
               table["paged_attention_kernel_tc"])
    # one instantiation of dq without HGMMA fails the whole kernel
    assert not got(counts, "flash_bwd_dq_kernel_tc",
                   table["flash_bwd_dq_kernel_tc"])
    assert not got(counts, "flash_fwd_kernel_tc", ("HGMMA",))


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


def test_kernel_build_key_covers_every_header(tmp_path, monkeypatch):
    """The library's name hashes every file under csrc/, headers too: an
    edited philox.cuh (which no SOURCES entry names) rebuilds."""
    from paddle_tpu_torch.ops import _kernels
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    assert "philox.cuh" in headers and "flash_attention.cuh" in headers
    flags = list(_kernels.NVCC_FLAGS)
    key = _kernels._source_key(flags)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    assert _kernels._source_key(flags) == key      # the copy hashes alike
    for name in headers:
        path = csrc / name
        text = path.read_text()
        path.write_text(text + "\n// edited\n")
        assert _kernels._source_key(flags) != key, name
        path.write_text(text)
    assert _kernels._source_key(flags) == key


def test_kernel_sources_include_neither_jax_nor_paddle_tpu():
    """The CUDA sources and headers include only CUDA's and their own."""
    from paddle_tpu_torch.ops import _kernels
    files = sorted(_kernels.CSRC.glob("*.cu*"))
    assert {"philox.cuh", "flash_attention.cu"} <= {f.name for f in files}
    for f in files:
        for line in f.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert "jax" not in line and "paddle_tpu" not in line, (
                    f.name, line)


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
