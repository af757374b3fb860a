"""MobileNet V1 and V2 (counterpart of paddle_tpu/vision/models/
mobilenet.py; reference mobilenetv1.py, mobilenetv2.py): the JAX blocks,
widths (`scale`), layer names and order. A depthwise convolution is a
`Conv2D` with `groups` = its channels (`nn/functional/conv.py`, cuDNN on
the card).

`device`, `dtype` and `generator` as `lenet.py` takes them; `pretrained`
is ignored, as in JAX: nothing is fetched.
"""
from __future__ import annotations

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Layer,
                   Linear, ReLU, ReLU6, Sequential)
from ...tensor.manipulation import flatten
from ._build import draw_weights, layer_kw


def _conv_bn(in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
             act="relu6", kw=None):
    layers = [Conv2D(in_ch, out_ch, kernel, stride=stride, padding=padding,
                     groups=groups, bias_attr=False, **kw),
              BatchNorm2D(out_ch, **kw)]
    if act == "relu":
        layers.append(ReLU())
    elif act == "relu6":
        layers.append(ReLU6())
    return Sequential(*layers)


class DepthwiseSeparable(Layer):
    def __init__(self, in_ch, out_ch1, out_ch2, num_groups, stride, scale,
                 device=None, dtype=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        self.dw = _conv_bn(int(in_ch * scale), int(out_ch1 * scale), 3,
                           stride=stride, padding=1,
                           groups=int(num_groups * scale), act="relu", kw=kw)
        self.pw = _conv_bn(int(out_ch1 * scale), int(out_ch2 * scale), 1,
                           act="relu", kw=kw)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = _conv_bn(3, int(32 * scale), 3, stride=2, padding=1,
                              act="relu", kw=kw)
        cfg = [(32, 64, 32, 1), (64, 128, 64, 2), (128, 128, 128, 1),
               (128, 256, 128, 2), (256, 256, 256, 1), (256, 512, 256, 2)] + \
              [(512, 512, 512, 1)] * 5 + [(512, 1024, 512, 2),
                                          (1024, 1024, 1024, 1)]
        self.blocks = Sequential(*[
            DepthwiseSeparable(in_c, in_c, out1, in_c, stride, scale, **kw)
            for in_c, out1, _, stride in cfg])
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(int(1024 * scale), num_classes, **kw)
        draw_weights(self, kw["device"], generator)

    def forward(self, x):
        x = self.conv1(x)
        x = self.blocks(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio, device=None,
                 dtype=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(inp, hidden, 1, kw=kw))
        layers.extend([
            _conv_bn(hidden, hidden, 3, stride=stride, padding=1,
                     groups=hidden, kw=kw),
            Conv2D(hidden, oup, 1, bias_attr=False, **kw),
            BatchNorm2D(oup, **kw),
        ])
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_ch = int(32 * scale)
        features = [_conv_bn(3, in_ch, 3, stride=2, padding=1, kw=kw)]
        for t, c, n, s in cfg:
            out_ch = int(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    in_ch, out_ch, s if i == 0 else 1, t, **kw))
                in_ch = out_ch
        self.last_ch = int(1280 * max(1.0, scale))
        features.append(_conv_bn(in_ch, self.last_ch, 1, kw=kw))
        self.features = Sequential(*features)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2), Linear(self.last_ch, num_classes, **kw))
        draw_weights(self, kw["device"], generator)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
