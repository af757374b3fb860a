from . import lr  # noqa: F401
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401
