from . import callbacks  # noqa: F401
from .dynamic_flops import flops  # noqa: F401
from .model import Model, summary  # noqa: F401
