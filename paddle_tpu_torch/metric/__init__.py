"""paddle.metric (counterpart of paddle_tpu/metric/__init__.py).

The metric classes (`Accuracy`, `Precision`, `Recall`, `Auc`) keep their
state in numpy on the host, as in JAX: `Accuracy.compute` reads the
predictions to the host (one device sync a call) and ranks them there.
The op-style functions `accuracy`, `auc`, `precision_recall`, `mean_iou`
and `positive_negative_pair` are torch ops on their inputs' device;
`chunk_eval` and `detection_map` are host numpy, as in JAX. Inputs may be
tensors (any device), numpy arrays or lists.
"""
from __future__ import annotations

import numpy as np
import torch

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _host(x):
    """x as a numpy array (a tensor is read to the host)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(x, device=None):
    """x as a tensor (on `device` when it is not one already)."""
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x),
                                                        device=device)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred_np = _host(pred)
        label_np = _host(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        correct = (topk_idx == label_np[..., None])
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _host(correct)
        num = c.shape[0] if c.ndim else 1
        accs = []
        for i, k in enumerate(self.topk):
            num_correct = c[..., :k].sum()
            self.total[i] += num_correct
            self.count[i] += num
            accs.append(num_correct / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _host(preds)
        l = _host(labels)
        p = (p > 0.5).astype(np.int32).reshape(-1)
        l = l.astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _host(preds)
        l = _host(labels)
        p = (p > 0.5).astype(np.int32).reshape(-1)
        l = l.astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__()
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _host(preds)
        l = _host(labels)
        if p.ndim == 2:
            p = p[:, -1]
        l = l.reshape(-1)
        bins = np.round(p * self.num_thresholds).astype(np.int64)
        bins = np.clip(bins, 0, self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds high->low
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the k largest scores, a 0-d
    fp32 tensor."""
    p = _t(input)
    lab = _t(label, p.device)
    if lab.ndim == p.ndim and lab.shape[-1] == 1:
        lab = lab[..., 0]
    idx = torch.topk(p, k, dim=-1).indices
    hit = (idx == lab[..., None].to(idx.dtype)).any(-1)
    return hit.float().mean()


def _trapezoid_auc(sp, sn):
    """The trapezoidal ROC area over histogram stats swept high -> low,
    from the (0, 0) origin; 0 where a class is empty."""
    tp = torch.cumsum(sp.flip(0), 0)
    fp = torch.cumsum(sn.flip(0), 0)
    zero = torch.zeros((1,), dtype=sp.dtype, device=sp.device)
    tp0, fp0 = torch.cat([zero, tp]), torch.cat([zero, fp])
    area = ((fp0[1:] - fp0[:-1]) * (tp0[1:] + tp0[:-1]) * 0.5).sum()
    denom = sp.sum() * sn.sum()
    return torch.where(denom > 0,
                       area / torch.where(denom > 0, denom, 1.0),
                       0.0).float()


def auc(input, label, curve="ROC", num_thresholds=4095,
        stat_pos=None, stat_neg=None):
    """Op-style streaming AUC (operators/metrics/auc_op.cc): predictions
    binned into num_thresholds+1 buckets, merged into the running stats,
    and the trapezoidal AUC over them. Returns (auc, new_stat_pos,
    new_stat_neg); thread the stats through successive calls."""
    if curve != "ROC":
        raise ValueError(f"auc: only curve='ROC' is supported, got {curve}")
    nt = int(num_thresholds)
    p = _t(input)
    if p.ndim == 2:
        p = p[:, -1]      # binary: P(class 1) column (auc_op.cc contract)
    lab = _t(label, p.device).reshape(-1)
    dev = p.device
    bins = torch.clamp(torch.round(p * nt).to(torch.int64), 0, nt)
    pos = (lab > 0).float()
    zeros = torch.zeros((nt + 1,), dtype=torch.float32, device=dev)
    sp = (_t(stat_pos, dev).float() if stat_pos is not None else zeros) \
        + zeros.index_add(0, bins, pos)
    sn = (_t(stat_neg, dev).float() if stat_neg is not None else zeros) \
        + zeros.index_add(0, bins, 1.0 - pos)
    return _trapezoid_auc(sp, sn), sp, sn


def _safe_div(a, b):
    return torch.where(b > 0, a / torch.where(b > 0, b, 1.0), 0.0)


def _metrics6(st):
    """[macro P, R, F1, micro P, R, F1] of per-class [tp, fp, tn, fn]."""
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]
    prec_c = _safe_div(tp, tp + fp)
    rec_c = _safe_div(tp, tp + fn)
    f1_c = _safe_div(2 * prec_c * rec_c, prec_c + rec_c)
    tps, fps, fns = tp.sum(), fp.sum(), fn.sum()
    micro_p = _safe_div(tps, tps + fps)
    micro_r = _safe_div(tps, tps + fns)
    micro_f1 = _safe_div(2 * micro_p * micro_r, micro_p + micro_r)
    return torch.stack([prec_c.mean(), rec_c.mean(), f1_c.mean(), micro_p,
                        micro_r, micro_f1])


def precision_recall(indices, labels, num_classes, weights=None,
                     states=None):
    """Op-style multi-class precision/recall
    (operators/metrics/precision_recall_op.cc): per-class TP/FP/TN/FN of
    the predicted `indices` against `labels`, returning (batch_metrics[6],
    accum_metrics[6], new_states[C, 4]) with the 6 metrics [macro-P,
    macro-R, macro-F1, micro-P, micro-R, micro-F1]; states accumulate
    across calls."""
    C = int(num_classes)
    idx = _t(indices).reshape(-1).long()
    dev = idx.device
    lab = _t(labels, dev).reshape(-1).long()
    w = (torch.ones(idx.shape, dtype=torch.float32, device=dev)
         if weights is None else _t(weights, dev).reshape(-1).float())
    pred_1h = torch.nn.functional.one_hot(idx, C).float() * w[:, None]
    lab_1h = torch.nn.functional.one_hot(lab, C).float() * w[:, None]
    tp = (pred_1h * (idx == lab)[:, None]).sum(0)
    fp = pred_1h.sum(0) - tp
    fn = lab_1h.sum(0) - tp
    tn = w.sum() - tp - fp - fn
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    st = (_t(states, dev).float() if states is not None
          else torch.zeros((C, 4), dtype=torch.float32, device=dev))
    new_st = st + batch
    return _metrics6(batch), _metrics6(new_st), new_st


def _counts(idx, n):
    """How often each of 0..n-1 occurs in idx; a negative index counts
    from the end and one still outside [0, n) is dropped, as a JAX
    `.at[idx].add(..., mode="drop")` treats it."""
    idx = torch.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (idx < n)
    return torch.bincount(idx[keep], minlength=n)[:n]


def mean_iou(input, label, num_classes):
    """mean-IOU for semantic segmentation (operators/mean_iou_op.cc): per
    class TP / (TP + FP + FN), averaged over the classes present in the
    prediction or the label. Returns (mean_iou, out_wrong, out_correct),
    the counts int32."""
    nc = int(num_classes)
    p = _t(input).reshape(-1).long()
    lab = _t(label, p.device).reshape(-1).long()
    correct = _counts(p[p == lab], nc)
    pred_cnt = _counts(p, nc)
    label_cnt = _counts(lab, nc)
    union = pred_cnt + label_cnt - correct
    wrong = pred_cnt + label_cnt - 2 * correct
    present = union > 0
    iou = torch.where(present, correct / union.clamp_min(1).float(), 0.0)
    miou = iou.sum() / present.int().sum().clamp_min(1)
    return miou.float(), wrong.int(), correct.int()


def positive_negative_pair(score, label, query_id):
    """Pair-ranking counts (operators/positive_negative_pair_op.cc):
    within each query, item pairs with different labels count as
    positive when the score order matches the label order, negative when
    it opposes, neutral on a score tie. Returns (positive, negative,
    neutral) fp32 scalars (an O(N^2) mask over the batch)."""
    s = _t(score)
    if s.ndim == 2:
        s = s[:, -1]      # the model score column (op contract)
    dev = s.device
    s = s.reshape(-1)
    lab = _t(label, dev).reshape(-1)
    q = _t(query_id, dev).reshape(-1)
    valid = (q[:, None] == q[None, :]) & (lab[:, None] > lab[None, :])
    sd = s[:, None] - s[None, :]
    return ((valid & (sd > 0)).float().sum(),
            (valid & (sd < 0)).float().sum(),
            (valid & (sd == 0)).float().sum())


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """chunk_eval_op.cc: chunk-level precision/recall/F1 for sequence
    labeling (NER-style). Tags encode (chunk_type, tag) as
    chunk_type * num_tag_types + tag_index with O as the final label id,
    schemes IOB (B,I), IOE (I,E), IOBES (B,I,E,S), and `plain` (label IS
    the chunk type; maximal same-type runs are chunks). Host-side numpy, as in JAX.

    Returns (precision, recall, f1, num_infer_chunks, num_label_chunks,
    num_correct_chunks) as 6 scalar Tensors — the op's output contract."""
    schemes = {"IOB": ["B", "I"], "IOE": ["I", "E"],
               "IOBES": ["B", "I", "E", "S"], "plain": None}
    if chunk_scheme not in schemes:
        raise ValueError(f"chunk_eval: unknown scheme {chunk_scheme!r}")
    tag_types = schemes[chunk_scheme]
    excluded = set(excluded_chunk_types or [])

    x = _host(input).reshape(-1)
    y = _host(label).reshape(-1)
    if seq_length is not None:
        lens = _host(seq_length).reshape(-1)
    else:
        lens = np.asarray([len(x)])

    def chunks_of(tags):
        """Lenient chunk extraction -> set of (start, end, type)."""
        out = set()
        if tag_types is None:  # plain: maximal same-type runs
            start = None
            cur = None
            for i, t in enumerate(list(tags) + [-1]):
                if t != cur:
                    if cur is not None and cur >= 0 and cur not in excluded:
                        out.add((start, i - 1, int(cur)))
                    start, cur = i, t
            return out
        n_tag = len(tag_types)
        o_id = num_chunk_types * n_tag

        def parse(t):
            if t >= o_id or t < 0:
                return None, None
            return int(t) // n_tag, tag_types[int(t) % n_tag]

        start = None
        cur = None
        for i, t in enumerate(list(tags) + [o_id]):
            ctype, tag = parse(t)
            begins = tag in ("B", "S") or (
                ctype is not None and (cur is None or ctype != cur))
            ends_prev = ctype is None or begins
            if cur is not None and ends_prev:
                if cur not in excluded:
                    out.add((start, i - 1, cur))
                start, cur = None, None
            if ctype is not None and (cur is None):
                start, cur = i, ctype
            if tag in ("E", "S") and cur is not None:
                if cur not in excluded:
                    out.add((start, i, cur))
                start, cur = None, None
        return out

    n_inf = n_lab = n_cor = 0
    off = 0
    for L in lens:
        L = int(L)
        inf_chunks = chunks_of(x[off:off + L])
        lab_chunks = chunks_of(y[off:off + L])
        n_inf += len(inf_chunks)
        n_lab += len(lab_chunks)
        n_cor += len(inf_chunks & lab_chunks)
        off += L

    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    mk = lambda v, dt: torch.from_numpy(np.asarray(v, dt))  # noqa: E731
    return (mk(p, np.float32), mk(r, np.float32), mk(f1, np.float32),
            mk(n_inf, np.int64), mk(n_lab, np.int64), mk(n_cor, np.int64))


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  ap_version="integral"):
    """Detection mAP (operators/detection/detection_map_op.cc reduced to
    the dense single-call form): detect_res rows are
    [image_id, class, score, xmin, ymin, xmax, ymax], label rows are
    [image_id, class, xmin, ymax... ] -> [image_id, class, xmin, ymin,
    xmax, ymax, (difficult)]. Host-side numpy, as in JAX. Returns the
    mAP scalar in [0, 1]."""
    det = np.asarray(_host(detect_res), np.float64)
    gt = np.asarray(_host(label), np.float64)
    if det.ndim != 2 or (det.size and det.shape[1] != 7):
        raise ValueError("detect_res rows must be [img, cls, score, x0, "
                         "y0, x1, y1]")
    has_diff = gt.size and gt.shape[1] >= 7
    aps = []
    for c in range(int(class_num)):
        if c == background_label:
            continue
        gt_c = gt[gt[:, 1] == c] if gt.size else gt.reshape(0, 6)
        det_c = det[det[:, 1] == c] if det.size else det.reshape(0, 7)
        difficult = gt_c[:, 6].astype(bool) if has_diff else \
            np.zeros(len(gt_c), bool)
        n_pos = int((~difficult).sum()) if not evaluate_difficult \
            else len(gt_c)
        if n_pos == 0:
            continue
        order = np.argsort(-det_c[:, 2], kind="stable")
        det_c = det_c[order]
        matched = np.zeros(len(gt_c), bool)
        tp = np.zeros(len(det_c))
        fp = np.zeros(len(det_c))
        for i, d in enumerate(det_c):
            cand = np.where(gt_c[:, 0] == d[0])[0]
            best, best_iou = -1, float(overlap_threshold)
            for j in cand:
                g = gt_c[j]
                ix0, iy0 = max(d[3], g[2]), max(d[4], g[3])
                ix1, iy1 = min(d[5], g[4]), min(d[6], g[5])
                inter = max(ix1 - ix0, 0.0) * max(iy1 - iy0, 0.0)
                union = ((d[5] - d[3]) * (d[6] - d[4])
                         + (g[4] - g[2]) * (g[5] - g[3]) - inter)
                iou = inter / union if union > 0 else 0.0
                if iou >= best_iou:
                    best, best_iou = j, iou
            if best >= 0 and not matched[best]:
                if evaluate_difficult or not difficult[best]:
                    tp[i] = 1.0
                matched[best] = True
            else:
                fp[i] = 1.0
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / n_pos
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        if ap_version == "11point":
            ap = float(np.mean([
                precision[recall >= t].max() if (recall >= t).any() else 0.0
                for t in np.arange(0.0, 1.01, 0.1)]))
        else:  # integral
            ap = 0.0
            prev_r = 0.0
            for p_, r_ in zip(precision, recall):
                ap += p_ * (r_ - prev_r)
                prev_r = r_
            ap = float(ap)
        aps.append(ap)
    return torch.tensor(np.float32(np.mean(aps) if aps else 0.0))
