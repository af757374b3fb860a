from ._kernels import launch_counts, reset_launch_counts  # noqa: F401
from .attention import (flash_attention,  # noqa: F401
                        scaled_dot_product_attention)
