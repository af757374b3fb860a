from .device import resolve_device  # noqa: F401
from .dtype import convert_dtype  # noqa: F401
from .random import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                     model_parallel_random_seed, next_seed, seed)
