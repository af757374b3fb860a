"""paddle.distributed (counterpart of paddle_tpu/distributed/): so far the
one-device strategy compiler (`fleet`, `strategy`), the dataset run loops
(`trainer`) and the resilient training runtime (`resilient`)."""
from .trainer import DeviceWorker, MultiTrainer, train_from_dataset  # noqa: F401
from .resilient import (ResilientConfig, ResilientTrainer,  # noqa: F401
                        UnrecoverableError)
