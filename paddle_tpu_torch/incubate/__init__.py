"""paddle.incubate (counterpart of paddle_tpu/incubate/__init__.py): the
ported part, `flash_attention` and `MoELayer`."""
from ..nn.layer.moe import MoELayer  # noqa: F401
from ..ops.attention import flash_attention  # noqa: F401
