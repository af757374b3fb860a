from .device import resolve_device  # noqa: F401
from .dtype import convert_dtype  # noqa: F401
from .random import next_seed, seed  # noqa: F401
