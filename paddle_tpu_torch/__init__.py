"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The package mirrors `paddle_tpu/`'s module paths so each module's
counterpart is easy to find. It imports torch and never jax, and nothing
of `paddle_tpu`. Its entry points (`models.gpt.GPTForCausalLM`,
`models.llama.LlamaForCausalLM`, `vision.models.resnet50` and its
family, `models.generation.generate`,
`serving.llm.LLMEngine`, `parallel.ScanTrainStep` / `ShardedTrainStep`
with `optimizer.AdamW`, `Model` over `io.DataLoader`, `load`) run on CUDA
unless the caller asks for the CPU with `device="cpu"`.

Every TPU kernel on a ported path is a hand-written Hopper kernel under
`csrc/`, built at first use (see `ops/_kernels.py`); each keeps a plain
PyTorch version beside it that the CPU takes.
"""
__version__ = "0.1.0"

from .core.random import seed  # noqa: E402,F401
from .framework_io import load, save  # noqa: E402,F401
from . import callbacks, io, metric, vision  # noqa: E402,F401
from .hapi import Model, summary  # noqa: E402,F401


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail=False):
    """paddle.flops: the MACs of one forward (hapi/dynamic_flops.py)."""
    from .hapi.dynamic_flops import flops as _flops
    return _flops(net, input_size=input_size, inputs=inputs,
                  custom_ops=custom_ops, print_detail=print_detail)
