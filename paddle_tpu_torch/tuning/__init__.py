"""Parameter-efficient fine-tuning (LoRA) for the fine-tune-and-serve loop
(counterpart of paddle_tpu/tuning)."""
from .lora import (LoRAConfig, LoRALinear, adapter_signature,  # noqa: F401
                   adapter_state_dict, default_lora_targets, inject_lora,
                   load_adapter_state, lora_parameters, merge_adapter_delta,
                   target_sites)
