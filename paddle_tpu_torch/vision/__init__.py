"""paddle.vision (counterpart of paddle_tpu/vision/): the models (LeNet,
VGG, MobileNet V1/V2, ResNet), the numpy transforms and the datasets."""
from . import datasets, models, transforms  # noqa: F401
