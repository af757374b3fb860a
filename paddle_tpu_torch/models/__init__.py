from .generation import generate, make_decoder_fns  # noqa: F401
from .gpt import GPT_PRESETS, GPTConfig, GPTForCausalLM  # noqa: F401
from .llama import (LLAMA_PRESETS, LlamaConfig,  # noqa: F401
                    LlamaForCausalLM)
