"""Vision transforms (counterpart of paddle_tpu/vision/transforms.py;
reference: python/paddle/vision/transforms/): host-side preprocessing in
numpy, HWC uint8 or float arrays in, arrays out. The code is the JAX
module's, drawing from Python's `random` as it does, so under the same
`random.seed` and `np.random.seed` the random transforms give the same
images. `Resize` is bilinear with a triangle filter widened when it
downsamples (antialiasing), computed as `jax.image.resize(...,
"bilinear")` computes it: one weight matrix a resized axis, in fp32."""
from __future__ import annotations

import numbers
import random
from typing import List, Sequence

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


def _as_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


class ToTensor(BaseTransform):
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        img = _as_hwc(img).astype(np.float32)
        if img.dtype == np.uint8 or img.max() > 1.5:
            img = img / 255.0
        if self.data_format == "CHW":
            img = np.transpose(img, (2, 0, 1))
        return img


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            return (img - self.mean[:, None, None]) / self.std[:, None, None]
        return (img - self.mean) / self.std


def _resize_weights(in_size, out_size):
    """[in_size, out_size] fp32 weights of one axis: the triangle kernel
    at the output samples' centres, widened by the scale when it shrinks,
    normalised per output, zero for a sample outside the input (jax's
    `compute_weight_mat` with antialias on)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None])
         / kernel_scale)
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        img = _as_hwc(img).astype(np.float32)
        out = img
        for axis, n in ((0, self.size[0]), (1, self.size[1])):
            if out.shape[axis] == n:
                continue        # an identity axis is skipped, as in jax
            w = _resize_weights(out.shape[axis], n)
            out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])),
                              -1, axis)
        return out.astype(np.float32)


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        img = _as_hwc(img)
        if self.padding:
            p = self.padding
            p = (p, p) if isinstance(p, int) else p
            img = np.pad(img, ((p[0], p[0]), (p[1], p[1]), (0, 0)))
        h, w = img.shape[:2]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.ascontiguousarray(_as_hwc(img)[:, ::-1])
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.ascontiguousarray(_as_hwc(img)[::-1])
        return img


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        return np.transpose(_as_hwc(img), self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        factor = 1 + random.uniform(-self.value, self.value)
        return np.clip(_as_hwc(img).astype(np.float32) * factor, 0,
                       255 if np.asarray(img).max() > 1.5 else 1.0)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.ascontiguousarray(_as_hwc(img)[:, ::-1])


def vflip(img):
    return np.ascontiguousarray(_as_hwc(img)[::-1])


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


# ---- color / geometry functional ops (reference: transforms/functional.py,
# functional_cv2.py — numpy reimplementations, no cv2/PIL dependency) ----

def _scale_of(img):
    return 255.0 if np.asarray(img).max() > 1.5 else 1.0


def adjust_brightness(img, brightness_factor):
    hwc = _as_hwc(img).astype(np.float32)
    return np.clip(hwc * brightness_factor, 0, _scale_of(img))


def adjust_contrast(img, contrast_factor):
    hwc = _as_hwc(img).astype(np.float32)
    mean = to_grayscale(hwc).mean()
    return np.clip(mean + contrast_factor * (hwc - mean), 0, _scale_of(img))


def adjust_saturation(img, saturation_factor):
    hwc = _as_hwc(img).astype(np.float32)
    gray = to_grayscale(hwc)
    return np.clip(gray + saturation_factor * (hwc - gray), 0,
                   _scale_of(img))


def adjust_hue(img, hue_factor):
    """Rotate the hue channel by hue_factor (in [-0.5, 0.5] turns)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    hwc = _as_hwc(img).astype(np.float32)
    scale = _scale_of(img)
    x = hwc / scale
    if x.shape[-1] == 1:
        return hwc
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x[..., :3].max(-1)
    minc = x[..., :3].min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0)
    dz = np.maximum(delta, 1e-12)
    h = np.where(maxc == r, (g - b) / dz % 6,
                 np.where(maxc == g, (b - r) / dz + 2, (r - g) / dz + 4))
    h = (h / 6.0 + hue_factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(np.int32) % 6
    conds = [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
             np.stack([p, v, t], -1), np.stack([p, q, v], -1),
             np.stack([t, p, v], -1), np.stack([v, p, q], -1)]
    rgb = np.select([(i == k)[..., None].repeat(3, -1) for k in range(6)],
                    conds)
    out = x.copy()
    out[..., :3] = rgb
    return np.clip(out * scale, 0, scale)


def to_grayscale(img, num_output_channels=1):
    hwc = _as_hwc(img).astype(np.float32)
    if hwc.shape[-1] >= 3:
        gray = (0.299 * hwc[..., 0] + 0.587 * hwc[..., 1]
                + 0.114 * hwc[..., 2])[..., None]
    else:
        gray = hwc[..., :1]
    if num_output_channels == 3:
        gray = np.repeat(gray, 3, axis=-1)
    return gray


def crop(img, top, left, height, width):
    return _as_hwc(img)[top:top + height, left:left + width]


def pad(img, padding, fill=0, padding_mode="constant"):
    if isinstance(padding, int):
        padding = [padding] * 4
    if len(padding) == 2:
        padding = [padding[0], padding[1], padding[0], padding[1]]
    left, top, right, bottom = padding
    hwc = _as_hwc(img)
    cfg = [(top, bottom), (left, right), (0, 0)]
    if padding_mode == "constant":
        return np.pad(hwc, cfg, constant_values=fill)
    return np.pad(hwc, cfg, mode={"reflect": "reflect", "edge": "edge",
                                  "symmetric": "symmetric"}[padding_mode])


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate counter-clockwise by `angle` degrees (nearest-neighbor
    resampling, cv2-free)."""
    hwc = _as_hwc(img)
    H, W = hwc.shape[:2]
    rad = -np.deg2rad(angle)  # inverse map for output->input lookup
    cy, cx = ((H - 1) / 2.0, (W - 1) / 2.0) if center is None else (
        center[1], center[0])
    if expand:
        corners = np.array([[-cx, -cy], [W - 1 - cx, -cy],
                            [-cx, H - 1 - cy], [W - 1 - cx, H - 1 - cy]])
        rot = np.array([[np.cos(rad), -np.sin(rad)],
                        [np.sin(rad), np.cos(rad)]])
        spread = corners @ rot.T
        Wo = int(np.ceil(spread[:, 0].max() - spread[:, 0].min() + 1))
        Ho = int(np.ceil(spread[:, 1].max() - spread[:, 1].min() + 1))
        ocx, ocy = (Wo - 1) / 2.0, (Ho - 1) / 2.0
    else:
        Ho, Wo, ocx, ocy = H, W, cx, cy
    ys, xs = np.meshgrid(np.arange(Ho), np.arange(Wo), indexing="ij")
    xr = (xs - ocx) * np.cos(rad) - (ys - ocy) * np.sin(rad) + cx
    yr = (xs - ocx) * np.sin(rad) + (ys - ocy) * np.cos(rad) + cy
    xi = np.round(xr).astype(np.int64)
    yi = np.round(yr).astype(np.int64)
    inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    out = np.full((Ho, Wo, hwc.shape[2]), fill, hwc.dtype)
    out[inside] = hwc[yi[inside], xi[inside]]
    return out


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class ContrastTransform(BaseTransform):
    def __init__(self, value):
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = value

    def _apply_image(self, img):
        factor = 1 + random.uniform(-self.value, self.value)
        return adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value):
        if value < 0:
            raise ValueError("saturation value must be non-negative")
        self.value = value

    def _apply_image(self, img):
        factor = 1 + random.uniform(-self.value, self.value)
        return adjust_saturation(img, factor)


class HueTransform(BaseTransform):
    def __init__(self, value):
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = value

    def _apply_image(self, img):
        return adjust_hue(img, random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Randomly jitter brightness/contrast/saturation/hue (reference
    transforms.ColorJitter — random order of the four sub-transforms)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def _apply_image(self, img):
        order = list(self.transforms)
        random.shuffle(order)
        for t in order:
            img = t._apply_image(img)
        return img


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return rotate(img, angle, expand=self.expand, center=self.center,
                      fill=self.fill)


class RandomResizedCrop(BaseTransform):
    """Random area/aspect crop then resize (the ImageNet training
    transform)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        hwc = _as_hwc(img)
        H, W = hwc.shape[:2]
        area = H * W
        for _ in range(10):
            target = area * random.uniform(*self.scale)
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            w = int(round(np.sqrt(target * ar)))
            h = int(round(np.sqrt(target / ar)))
            if 0 < w <= W and 0 < h <= H:
                top = random.randint(0, H - h)
                left = random.randint(0, W - w)
                patch = crop(hwc, top, left, h, w)
                return Resize(self.size, self.interpolation)(patch)
        return Resize(self.size, self.interpolation)(
            CenterCrop(min(H, W))(hwc))
