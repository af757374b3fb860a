"""paddle.incubate (counterpart of paddle_tpu/incubate/__init__.py): the
ported part, `flash_attention`."""
from ..ops.attention import flash_attention  # noqa: F401
