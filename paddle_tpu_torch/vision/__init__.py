"""paddle.vision (counterpart of paddle_tpu/vision/): the ResNet family so
far; LeNet, VGG and MobileNet wait (ROADMAP §1 item 6f)."""
from . import models  # noqa: F401
