"""paddle.utils (counterpart of paddle_tpu/utils/): the fault-injection
harness of the resilient runtime."""
from . import fault_injection  # noqa: F401
