"""The port's `metric` against the JAX package's, on the CPU: every
metric class and function on the same seeded inputs.

Limits: counts, hits and the classes' host numpy are exact; fp32
results (the op-style AUC, precision/recall, mean IoU, ratios) within
1e-6, the JAX functions' arithmetic done by torch in the same order.
"""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU)

TOL = 1e-6


def _np(a):
    if torch.is_tensor(a):
        return a.numpy()
    return np.asarray(a.data if hasattr(a, "data") else a)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


def _scores(seed, n=64, c=10):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, c)).astype(np.float32),
            rng.randint(0, c, (n, 1)).astype(np.int64))


@pytest.mark.parametrize("topk", [1, (1, 5), (2, 3)])
def test_accuracy_class_matches_jax(topk):
    import paddle_tpu as paddle
    from paddle_tpu.metric import Accuracy as JAcc
    from paddle_tpu_torch.metric import Accuracy
    j, t = JAcc(topk=topk), Accuracy(topk=topk)
    assert t.name() == j.name() == "acc"
    for seed in range(3):
        pred, label = _scores(seed)
        jc = j.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
        tc = t.compute(torch.from_numpy(pred), torch.from_numpy(label))
        np.testing.assert_array_equal(tc.numpy(), _np(jc))
        assert t.update(tc) == j.update(jc)
    assert t.accumulate() == j.accumulate()
    t.reset()
    assert np.all(t.count == 0)


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metric_classes_match_jax(cls):
    import paddle_tpu.metric as jm
    import paddle_tpu_torch.metric as tm
    j = getattr(jm, cls)() if cls != "Auc" else jm.Auc(num_thresholds=255)
    t = getattr(tm, cls)() if cls != "Auc" else tm.Auc(num_thresholds=255)
    rng = np.random.RandomState(1)
    for _ in range(3):
        p = rng.rand(50, 2 if cls == "Auc" else 1).astype(np.float32)
        lab = rng.randint(0, 2, (50, 1)).astype(np.int64)
        j.update(p, lab)
        t.update(torch.from_numpy(p), torch.from_numpy(lab))
    assert t.accumulate() == pytest.approx(j.accumulate(), abs=1e-12)
    assert t.name() == j.name()


def test_accuracy_function_matches_jax():
    import paddle_tpu.metric as jm
    import paddle_tpu_torch.metric as tm
    pred, label = _scores(4)
    for k in (1, 3):
        got = tm.accuracy(torch.from_numpy(pred), torch.from_numpy(label),
                          k=k)
        assert got.dtype == torch.float32 and got.ndim == 0
        _close(got, jm.accuracy(pred, label, k=k))
    _close(tm.accuracy(pred, label[:, 0]), jm.accuracy(pred, label[:, 0]))


def test_auc_function_streams_like_jax():
    import paddle_tpu.metric as jm
    import paddle_tpu_torch.metric as tm
    rng = np.random.RandomState(2)
    js = ts = None
    for i in range(3):
        p = rng.rand(40, 2).astype(np.float32)
        lab = rng.randint(0, 2, (40,)).astype(np.int64)
        if i == 2:
            p = p[:, 1]          # a 1-D score column works too
        jv, jp, jn = jm.auc(p, lab, num_thresholds=63,
                            stat_pos=None if js is None else js[0],
                            stat_neg=None if js is None else js[1])
        tv, tp, tn = tm.auc(torch.from_numpy(p), torch.from_numpy(lab),
                            num_thresholds=63,
                            stat_pos=None if ts is None else ts[0],
                            stat_neg=None if ts is None else ts[1])
        _close(tv, jv)
        np.testing.assert_array_equal(tp.numpy(), _np(jp))
        np.testing.assert_array_equal(tn.numpy(), _np(jn))
        js, ts = (jp, jn), (tp, tn)
    zero = tm.auc(np.full((4,), 0.5, np.float32), np.ones(4, np.int64))[0]
    assert float(zero) == 0.0
    with pytest.raises(ValueError):
        tm.auc(np.zeros(2, np.float32), np.zeros(2), curve="PR")


@pytest.mark.parametrize("weighted", [False, True])
def test_precision_recall_matches_jax(weighted):
    import paddle_tpu.metric as jm
    import paddle_tpu_torch.metric as tm
    rng = np.random.RandomState(3)
    jst = tst = None
    for _ in range(2):
        idx = rng.randint(0, 5, (30, 1)).astype(np.int64)
        lab = rng.randint(0, 5, (30, 1)).astype(np.int64)
        w = rng.rand(30, 1).astype(np.float32) if weighted else None
        jb, ja, jst = jm.precision_recall(idx, lab, 5, weights=w,
                                          states=jst)
        tb, ta, tst = tm.precision_recall(
            torch.from_numpy(idx), torch.from_numpy(lab), 5,
            weights=None if w is None else torch.from_numpy(w),
            states=tst)
        for a, b in ((tb, jb), (ta, ja), (tst, jst)):
            _close(a, b)


def test_mean_iou_matches_jax():
    import paddle_tpu.metric as jm
    import paddle_tpu_torch.metric as tm
    rng = np.random.RandomState(5)
    pred = rng.randint(0, 6, (4, 16, 16)).astype(np.int32)
    lab = rng.randint(0, 6, (4, 16, 16)).astype(np.int32)
    lab[0, 0, :3] = -1           # out of range: wraps from the end, as JAX
    pred[0, 1, :2] = 7           # out of range: dropped, as JAX
    pred[1] = lab[1]             # mostly right in one image
    for nc in (6, 8):            # 8: two classes absent from both
        jout = jm.mean_iou(pred, lab, nc)
        tout = tm.mean_iou(torch.from_numpy(pred), torch.from_numpy(lab),
                           nc)
        _close(tout[0], jout[0])
        for a, b in zip(tout[1:], jout[1:]):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), _np(b))


def test_positive_negative_pair_matches_jax():
    import paddle_tpu.metric as jm
    import paddle_tpu_torch.metric as tm
    rng = np.random.RandomState(6)
    score = np.round(rng.rand(40, 1), 1).astype(np.float32)   # ties too
    lab = rng.randint(0, 3, (40, 1)).astype(np.float32)
    qid = rng.randint(0, 4, (40, 1)).astype(np.int64)
    want = jm.positive_negative_pair(score, lab, qid)
    got = tm.positive_negative_pair(torch.from_numpy(score),
                                    torch.from_numpy(lab),
                                    torch.from_numpy(qid))
    for a, b in zip(got, want):
        assert float(a) == float(_np(b))
    assert float(got[2]) > 0


@pytest.mark.parametrize("scheme", ["IOB", "IOE", "IOBES", "plain"])
def test_chunk_eval_matches_jax(scheme):
    import paddle_tpu.metric as jm
    import paddle_tpu_torch.metric as tm
    n_tag = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    rng = np.random.RandomState(7)
    hi = 3 * n_tag + 1
    inf = rng.randint(0, hi, (40,)).astype(np.int64)
    lab = inf.copy()
    flip = rng.rand(40) < 0.3
    lab[flip] = rng.randint(0, hi, flip.sum())
    lens = np.array([15, 10, 15], np.int64)
    for kw in (dict(), dict(excluded_chunk_types=[1], seq_length=lens)):
        want = jm.chunk_eval(inf, lab, scheme, 3, **kw)
        got = tm.chunk_eval(torch.from_numpy(inf), torch.from_numpy(lab),
                            scheme, 3, **kw)
        for a, b in zip(got, want):
            assert a.dtype == (torch.float32 if _np(b).dtype.kind == "f"
                               else torch.int64)
            _close(a, b)
    with pytest.raises(ValueError):
        tm.chunk_eval(inf, lab, "BIO", 3)


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_matches_jax(ap_version):
    import paddle_tpu.metric as jm
    import paddle_tpu_torch.metric as tm
    rng = np.random.RandomState(8)
    gt = []
    for img in range(3):
        for _ in range(4):
            x0, y0 = rng.rand(2) * 50
            gt.append([img, rng.randint(1, 4), x0, y0, x0 + 10 + rng.rand()
                       * 20, y0 + 10 + rng.rand() * 20, rng.rand() < 0.2])
    gt = np.asarray(gt, np.float32)
    det = []
    for g in gt:
        for _ in range(2):
            jit = rng.standard_normal(4) * 3
            det.append([g[0], g[1] if rng.rand() < 0.8 else 2, rng.rand(),
                        *(g[2:6] + jit)])
    det = np.asarray(det, np.float32)
    for diff in (True, False):
        want = jm.detection_map(det, gt, 4, evaluate_difficult=diff,
                                ap_version=ap_version)
        got = tm.detection_map(torch.from_numpy(det), torch.from_numpy(gt),
                               4, evaluate_difficult=diff,
                               ap_version=ap_version)
        assert float(got) > 0
        _close(got, want)
