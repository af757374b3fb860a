"""Vision datasets (counterpart of paddle_tpu/vision/datasets.py;
reference: python/paddle/vision/datasets/).

Nothing downloads: a dataset reads local files when `data_file` /
`image_path` names them, and falls back to deterministic synthetic data
of the same shapes (numpy RandomState, the JAX module's seeds, so the
arrays equal JAX's) when none exist. Samples are numpy arrays, as in
JAX; `io.DataLoader` collates them into tensors.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ..io import Dataset


class _SyntheticImages(Dataset):
    def __init__(self, n, shape, num_classes, transform=None, seed=0):
        self.n = n
        self.shape = shape
        self.num_classes = num_classes
        self.transform = transform
        self.rng = np.random.RandomState(seed)
        self.images = self.rng.randint(0, 256, (n,) + shape,
                                       dtype=np.uint8)
        self.labels = self.rng.randint(0, num_classes, (n,),
                                       dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32) / 255.0
            if img.ndim == 3:
                img = np.transpose(img, (2, 0, 1))
            else:
                img = img[None]
        return img, self.labels[idx]

    def __len__(self):
        return self.n


class MNIST(Dataset):
    """MNIST from local idx files, or synthetic fallback (28x28x1)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        self.transform = transform
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(
                    f.read(), np.uint8).reshape(n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                f.read(8)
                self.labels = np.frombuffer(f.read(), np.uint8).astype(
                    np.int64)
        else:
            n = 1024 if mode == "train" else 256
            syn = _SyntheticImages(n, (28, 28), 10, seed=0)
            self.images = syn.images
            self.labels = syn.labels

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = (img.astype(np.float32) / 255.0)[None]
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    """CIFAR-10 from a local python-pickle tarball dir, or synthetic."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.transform = transform
        if data_file and os.path.isdir(data_file):
            batches = ([f"data_batch_{i}" for i in range(1, 6)]
                       if mode == "train" else ["test_batch"])
            xs, ys = [], []
            for b in batches:
                with open(os.path.join(data_file, b), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                xs.append(np.asarray(d[b"data"]).reshape(-1, 3, 32, 32))
                ys.extend(d[b"labels"])
            self.images = np.concatenate(xs).transpose(0, 2, 3, 1)
            self.labels = np.asarray(ys, np.int64)
        else:
            n = 1024 if mode == "train" else 256
            syn = _SyntheticImages(n, (32, 32, 3), 10, seed=1)
            self.images = syn.images
            self.labels = syn.labels

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = np.transpose(img.astype(np.float32) / 255.0, (2, 0, 1))
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.transform = transform
        n = 1024 if mode == "train" else 256
        syn = _SyntheticImages(n, (32, 32, 3), 100, seed=2)
        self.images = syn.images
        self.labels = syn.labels


class ImageFolder(Dataset):
    """Directory-of-images dataset; without PIL, loads .npy files or falls
    back to synthetic."""

    def __init__(self, root=None, loader=None, extensions=(".npy",),
                 transform=None, is_valid_file=None):
        self.transform = transform
        self.samples = []
        if root and os.path.isdir(root):
            for dirpath, _, files in sorted(os.walk(root)):
                for fname in sorted(files):
                    if fname.endswith(extensions):
                        self.samples.append(os.path.join(dirpath, fname))
        if not self.samples:
            self._syn = _SyntheticImages(64, (224, 224, 3), 1000, seed=3)
        else:
            self._syn = None

    def __getitem__(self, idx):
        if self._syn is not None:
            return (self._syn[idx][0],)
        img = np.load(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return (img,)

    def __len__(self):
        return len(self.samples) if self._syn is None else len(self._syn)


class DatasetFolder(ImageFolder):
    pass


class Flowers(Dataset):
    """Flowers-102 (reference vision/datasets/flowers.py). Local layout:
    data_file npz {images: [N, 3, H, W] uint8, labels: [N]}; optional
    setid_file npz {train_ids, valid_ids, test_ids} selecting the split
    (0-based row ids). Without a setid file the split is a deterministic
    80/10/10 partition so train/test never overlap. Synthetic fallback
    emits the SAME contract (uint8 CHW) so a transform written against
    either path behaves identically on the other."""

    _SPLITS = ("train", "valid", "test")

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, backend=None):
        if mode not in self._SPLITS:
            raise ValueError(f"mode must be one of {self._SPLITS}")
        self.transform = transform
        if data_file and os.path.exists(data_file):
            blob = np.load(data_file, allow_pickle=False)
            images = blob["images"]
            labels = blob["labels"].astype(np.int64)
            if setid_file and os.path.exists(setid_file):
                ids = np.load(setid_file)[f"{mode}_ids"].astype(np.int64)
            else:
                n = len(images)
                a, b = int(0.8 * n), int(0.9 * n)
                ids = {"train": np.arange(0, a),
                       "valid": np.arange(a, b),
                       "test": np.arange(b, n)}[mode]
            self._images = images[ids]
            self._labels = labels[ids]
        else:
            n = {"train": 128, "valid": 32, "test": 32}[mode]
            rng = np.random.RandomState(7 + self._SPLITS.index(mode))
            self._images = rng.randint(
                0, 256, (n, 3, 64, 64)).astype(np.uint8)
            self._labels = rng.randint(0, 102, (n,)).astype(np.int64)

    def __getitem__(self, idx):
        img, label = self._images[idx], self._labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self._images)


class VOC2012(Dataset):
    """VOC2012 segmentation (reference vision/datasets/voc2012.py). Local
    layout: data_file npz {images: [N, 3, H, W] uint8, masks: [N, H, W]
    uint8 class ids}; the split is an 80/20 deterministic partition by
    mode. Synthetic fallback emits the same uint8 CHW contract. Returns
    (image, segmentation_mask)."""

    N_CLASSES = 21

    def __init__(self, data_file=None, mode="train", transform=None,
                 backend=None):
        if mode not in ("train", "test"):
            raise ValueError(
                f"mode must be 'train' or 'test' (no valid split in the "
                f"80/20 partition), got {mode!r}")
        self.transform = transform
        if data_file and os.path.exists(data_file):
            blob = np.load(data_file, allow_pickle=False)
            images, masks = blob["images"], blob["masks"]
            n = len(images)
            cut = int(0.8 * n)
            sel = np.arange(0, cut) if mode == "train" \
                else np.arange(cut, n)
            self._images, self._masks = images[sel], masks[sel]
        else:
            n = 64 if mode == "train" else 16
            rng = np.random.RandomState(11 if mode == "train" else 12)
            self._images = rng.randint(
                0, 256, (n, 3, 64, 64)).astype(np.uint8)
            self._masks = rng.randint(
                0, self.N_CLASSES, (n, 64, 64)).astype(np.uint8)

    def __getitem__(self, idx):
        img, mask = self._images[idx], self._masks[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return len(self._images)
