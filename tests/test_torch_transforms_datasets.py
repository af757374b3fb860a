"""The port's `vision.transforms` and `vision.datasets` against the JAX
package's, on the CPU.

- Every transform and functional gives JAX's array on the same image,
  exactly (the same numpy code), the random ones under the same
  `random.seed` and `np.random.seed`. `Resize` (and `resize`,
  `RandomResizedCrop`, which call it) is the port's numpy form of
  `jax.image.resize(..., "bilinear")`: within atol 1e-4 on the 0..255
  scale (measured 6.1e-5, four fp32 ulps at 255: the two sum the
  triangle weights in another order).
- `MNIST` reads the gzip idx files a test writes, `Cifar10` the pickle
  batches; `ImageFolder` the .npy files, `Flowers` and `VOC2012` the npz
  files; without files every dataset falls back to JAX's seeded arrays,
  exactly; through a `DataLoader` with a transform the batches are JAX's.
"""
import gzip
import pickle
import random
import struct

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU)

RESIZE_ATOL = 1e-4


def _img(seed=0, shape=(20, 24, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _pair(name):
    from paddle_tpu.vision import transforms as jt
    from paddle_tpu_torch.vision import transforms as tt
    return getattr(jt, name), getattr(tt, name)


def _run_seeded(fn, img, seed):
    random.seed(seed)
    np.random.seed(seed)
    return np.asarray(fn(img))


CLASSES = [
    ("ToTensor", (), {}), ("ToTensor", (), {"data_format": "HWC"}),
    ("Normalize", ([0.5, 0.4, 0.3], [0.2, 0.3, 0.4]),
     {"data_format": "HWC"}),
    ("CenterCrop", (10,), {}), ("CenterCrop", ((8, 30),), {}),
    ("RandomCrop", (12,), {}), ("RandomCrop", (12,), {"padding": 3}),
    ("RandomHorizontalFlip", (), {}), ("RandomVerticalFlip", (), {}),
    ("Transpose", (), {}), ("BrightnessTransform", (0.4,), {}),
    ("Grayscale", (3,), {}), ("Pad", ((1, 2, 3, 4),), {"fill": 7}),
    ("Pad", (2,), {"padding_mode": "reflect"}),
    ("ContrastTransform", (0.5,), {}), ("SaturationTransform", (0.5,), {}),
    ("HueTransform", (0.3,), {}),
    ("ColorJitter", (0.4, 0.4, 0.4, 0.2), {}),
    ("RandomRotation", (30,), {}),
    ("RandomRotation", ((-10, 40),), {"expand": True, "fill": 3}),
]


@pytest.mark.parametrize("name,args,kw", CLASSES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CLASSES)])
def test_transform_classes_match_jax(name, args, kw):
    jcls, tcls = _pair(name)
    jf, tf = jcls(*args, **kw), tcls(*args, **kw)
    for seed in range(4):
        img = _img(seed)
        want = _run_seeded(jf, img, 100 + seed)
        got = _run_seeded(tf, img, 100 + seed)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


FUNCTIONALS = [
    ("normalize", (0.5, 0.25), {"data_format": "HWC"}),
    ("to_tensor", (), {}), ("hflip", (), {}), ("vflip", (), {}),
    ("center_crop", (9,), {}), ("adjust_brightness", (1.3,), {}),
    ("adjust_contrast", (0.6,), {}), ("adjust_saturation", (1.7,), {}),
    ("adjust_hue", (-0.2,), {}), ("to_grayscale", (), {}),
    ("crop", (2, 3, 10, 11), {}), ("pad", ((2, 5),), {"fill": 1}),
    ("pad", (3,), {"padding_mode": "symmetric"}),
    ("rotate", (33,), {}), ("rotate", (90,), {"expand": True}),
    ("rotate", (-15,), {"center": (4, 6), "fill": 9}),
]


@pytest.mark.parametrize("name,args,kw", FUNCTIONALS,
                         ids=[f"{c[0]}{i}" for i, c in
                              enumerate(FUNCTIONALS)])
def test_functionals_match_jax(name, args, kw):
    jf, tf = _pair(name)
    for img in (_img(1), _img(2).astype(np.float32) / 255.0,
                _img(3, (16, 16))):
        try:
            want = np.asarray(jf(img, *args, **kw))
        except ValueError:       # e.g. an HWC normalize of a 2-D image
            with pytest.raises(ValueError):
                tf(img, *args, **kw)
            continue
        got = np.asarray(tf(img, *args, **kw))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        _pair("adjust_hue")[1](_img(), 0.7)


def test_resize_and_compose_match_jax():
    from paddle_tpu.vision import transforms as jt
    from paddle_tpu_torch.vision import transforms as tt
    cases = [((37, 50, 3), 24), ((20, 30, 3), (48, 31)),
             ((64, 64, 1), 64), ((10, 12, 3), (10, 40)),
             ((9, 13), (5, 7))]
    for i, (shape, size) in enumerate(cases):
        img = _img(i, shape)
        for jf, tf in ((jt.Resize(size), tt.Resize(size)),
                       (lambda a: jt.resize(a, size),
                        lambda a: tt.resize(a, size))):
            want, got = np.asarray(jf(img)), tf(img)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)
    img = _img(7, (40, 48, 3))
    for kw in (dict(), dict(scale=(0.5, 0.9), ratio=(0.8, 1.2))):
        want = _run_seeded(jt.RandomResizedCrop(16, **kw), img, 5)
        got = _run_seeded(tt.RandomResizedCrop(16, **kw), img, 5)
        np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)
    # no crop fits 10 tries at an impossible ratio: the center fallback
    want = _run_seeded(jt.RandomResizedCrop(8, ratio=(50, 60)), img, 1)
    got = _run_seeded(tt.RandomResizedCrop(8, ratio=(50, 60)), img, 1)
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    jc = jt.Compose([jt.RandomHorizontalFlip(), jt.ToTensor(),
                     jt.Normalize(mean, std)])
    tc = tt.Compose([tt.RandomHorizontalFlip(), tt.ToTensor(),
                     tt.Normalize(mean, std)])
    for seed in range(3):
        np.testing.assert_array_equal(_run_seeded(tc, img, seed),
                                      _run_seeded(jc, img, seed))


def _write_mnist(tmp_path, n=12):
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (n,)).astype(np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lab.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return ip, lp, images, labels


def _write_cifar(tmp_path):
    rng = np.random.RandomState(5)
    d = tmp_path / "cifar"
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        blob = {b"data": rng.randint(0, 256, (3, 3072)).astype(np.uint8),
                b"labels": [int(v) for v in rng.randint(0, 10, 3)]}
        with open(d / name, "wb") as f:
            pickle.dump(blob, f)
    return str(d)


def _same_dataset(tds, jds, n=None):
    assert len(tds) == len(jds)
    for i in range(n or len(jds)):
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mnist_and_cifar_read_local_files_as_jax(tmp_path):
    import paddle_tpu.vision.datasets as jd
    import paddle_tpu_torch.vision.datasets as td
    ip, lp, images, labels = _write_mnist(tmp_path)
    for cls in ("MNIST", "FashionMNIST"):
        t = getattr(td, cls)(image_path=ip, label_path=lp)
        _same_dataset(t, getattr(jd, cls)(image_path=ip, label_path=lp))
        np.testing.assert_array_equal(t.images, images)
        assert t[3][0].shape == (1, 28, 28) and t[3][1] == labels[3]
    d = _write_cifar(tmp_path)
    for mode, n in (("train", 15), ("test", 3)):
        t = td.Cifar10(data_file=d, mode=mode)
        assert len(t) == n
        _same_dataset(t, jd.Cifar10(data_file=d, mode=mode))
    tf = _pair("ToTensor")
    _same_dataset(td.Cifar10(data_file=d, transform=tf[1]()),
                  jd.Cifar10(data_file=d, transform=tf[0]()), n=4)


@pytest.mark.parametrize("cls,kw", [
    ("MNIST", {}), ("MNIST", {"mode": "test"}), ("FashionMNIST", {}),
    ("Cifar10", {}), ("Cifar100", {"mode": "test"}),
    ("Flowers", {}), ("Flowers", {"mode": "valid"}),
    ("VOC2012", {}), ("VOC2012", {"mode": "test"}),
    ("ImageFolder", {}), ("DatasetFolder", {})])
def test_synthetic_fallbacks_equal_jax(cls, kw):
    import paddle_tpu.vision.datasets as jd
    import paddle_tpu_torch.vision.datasets as td
    t, j = getattr(td, cls)(**kw), getattr(jd, cls)(**kw)
    for attr in ("images", "labels", "_images", "_labels", "_masks"):
        if hasattr(j, attr):
            np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr))
    _same_dataset(t, j, n=3)


def test_folder_flowers_voc_read_local_files_as_jax(tmp_path):
    import paddle_tpu.vision.datasets as jd
    import paddle_tpu_torch.vision.datasets as td
    rng = np.random.RandomState(6)
    root = tmp_path / "folder"
    for c in ("a", "b"):
        (root / c).mkdir(parents=True)
        for i in range(2):
            np.save(root / c / f"{i}.npy", rng.rand(4, 4, 3))
    (root / "a" / "skip.txt").write_text("x")
    _same_dataset(td.ImageFolder(str(root)), jd.ImageFolder(str(root)))
    assert len(td.ImageFolder(str(root))) == 4
    fl = str(tmp_path / "flowers.npz")
    np.savez(fl, images=rng.randint(0, 256, (10, 3, 4, 4)).astype(np.uint8),
             labels=np.arange(10) % 102)
    ids = str(tmp_path / "ids.npz")
    np.savez(ids, train_ids=np.array([1, 5, 7]), valid_ids=np.array([0]),
             test_ids=np.array([2, 3]))
    for mode in ("train", "valid", "test"):
        _same_dataset(td.Flowers(data_file=fl, mode=mode),
                      jd.Flowers(data_file=fl, mode=mode))
        _same_dataset(td.Flowers(data_file=fl, setid_file=ids, mode=mode),
                      jd.Flowers(data_file=fl, setid_file=ids, mode=mode))
    voc = str(tmp_path / "voc.npz")
    np.savez(voc, images=rng.randint(0, 256, (10, 3, 4, 4)).astype(np.uint8),
             masks=rng.randint(0, 21, (10, 4, 4)).astype(np.uint8))
    for mode in ("train", "test"):
        _same_dataset(td.VOC2012(data_file=voc, mode=mode),
                      jd.VOC2012(data_file=voc, mode=mode))
    with pytest.raises(ValueError):
        td.Flowers(mode="dev")
    with pytest.raises(ValueError):
        td.VOC2012(mode="valid")


def test_loader_over_a_transformed_dataset_matches_jax():
    import paddle_tpu.vision.datasets as jd
    import paddle_tpu_torch.vision.datasets as td
    from paddle_tpu.io import DataLoader as JDL
    from paddle_tpu_torch.io import DataLoader
    jt, tt = _pair("Normalize")
    jds = jd.Cifar10(mode="test", transform=jt(0.5, 0.5, data_format="HWC"))
    tds = td.Cifar10(mode="test", transform=tt(0.5, 0.5, data_format="HWC"))
    want = next(iter(JDL(jds, batch_size=8)))
    got = next(iter(DataLoader(tds, batch_size=8, num_workers=2)))
    assert got[0].dtype == torch.float32 and got[0].shape == (8, 32, 32, 3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0].numpy()))
    # JAX leaves numpy-integer labels as a list; the port stacks them
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray([int(v) for v in want[1]]))
