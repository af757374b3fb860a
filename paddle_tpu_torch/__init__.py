"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The package mirrors `paddle_tpu/`'s module paths so each module's
counterpart is easy to find. It imports torch and never jax, and nothing
of `paddle_tpu`. Its entry points (`models.gpt.GPTForCausalLM`,
`models.llama.LlamaForCausalLM`, `models.generation.generate`,
`serving.llm.LLMEngine`, `parallel.ScanTrainStep` / `ShardedTrainStep`
with `optimizer.AdamW`) run on CUDA unless the caller asks for the CPU
with `device="cpu"`.

Every TPU kernel on a ported path is a hand-written Hopper kernel under
`csrc/`, built at first use (see `ops/_kernels.py`); each keeps a plain
PyTorch version beside it that the CPU takes.
"""
__version__ = "0.1.0"

from .core.random import seed  # noqa: E402,F401
