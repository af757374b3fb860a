from .host_kv import HostKVPool  # noqa: F401
from .kv_pool import SlotPagedKVPool, SlotsExhaustedError  # noqa: F401
from .llm_engine import (DispatchFailedError,  # noqa: F401
                         DispatchHungError, GenerationHandle, LLMEngine,
                         LLMEngineConfig, WeightSwapError)
from .lora import AdapterBank, AdapterError  # noqa: F401
from .prefix_cache import AttachPlan, PrefixCache  # noqa: F401
from .sampling import (SamplingParams, SlotSamplingTable,  # noqa: F401
                       TokenDFA, compile_grammar)
