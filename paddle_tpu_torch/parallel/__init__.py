from .api import (ScanTrainStep, ShardedTrainStep,  # noqa: F401
                  make_compute_loss, stack_batches)
