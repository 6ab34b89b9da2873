"""OKS keypoint evaluation (COCO / CrowdPose protocol, self-contained; the
port's copy of ``litepose_tpu/data/eval_oks.py``).

pycocotools/crowdposetools are unavailable in this image; this is a fresh
implementation of the keypoint-AP protocol both use: per-image greedy
matching of score-sorted detections to ground truths by Object Keypoint
Similarity at 10 thresholds (.5:.05:.95), 101-point interpolated
precision envelopes, and the standard summary statistics.  Reference usage:
``lib/dataset/COCODataset.py:295-309`` and
``lib/dataset/CrowdPoseDataset.py:281-296`` (the CrowdPose
variant adds AP(easy/medium/hard) buckets over the image ``crowdIndex``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

COCO_SIGMAS = np.array(
    [.026, .025, .025, .035, .035, .079, .079, .072, .072,
     .062, .062, .107, .107, .087, .087, .089, .089]
)
# crowdposetools protocol: [.79,.79,.72,.72,.62,.62,1.07,1.07,.87,.87,.89,.89,.79,.79]/10
CROWDPOSE_SIGMAS = np.array(
    [.079, .079, .072, .072, .062, .062, .107, .107, .087, .087, .089, .089, .079, .079]
)

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)


def compute_oks(dts: np.ndarray, gts: List[dict], sigmas: np.ndarray) -> np.ndarray:
    """OKS matrix (n_det, n_gt).

    dts: (n_det, K, 3) keypoints (x, y, score).
    gts: list of dicts with 'keypoints' (3K flat), 'area', 'bbox'.
    """
    n_d, n_g = len(dts), len(gts)
    ious = np.zeros((n_d, n_g))
    if n_d == 0 or n_g == 0:
        return ious
    vars_ = (sigmas * 2) ** 2
    k = len(sigmas)
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64).reshape(-1, 3)
        xg, yg, vg = g[:, 0], g[:, 1], g[:, 2]
        k1 = np.count_nonzero(vg > 0)
        bb = gt.get("bbox", [0, 0, 0, 0])
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        area = gt.get("area", bb[2] * bb[3])
        for i, d in enumerate(dts):
            xd, yd = d[:, 0], d[:, 1]
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                # no visible gt joints: measure distance to the padded bbox
                z = np.zeros(k)
                dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
            e = (dx**2 + dy**2) / vars_ / (area + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
    return ious


@dataclasses.dataclass
class ImgEval:
    dt_matches: np.ndarray  # (T, n_det) matched gt id or 0
    dt_ignore: np.ndarray  # (T, n_det)
    gt_ignore: np.ndarray  # (n_gt,)
    dt_scores: np.ndarray  # (n_det,)


def _evaluate_img(
    gts: List[dict],
    dts_kpts: np.ndarray,
    dt_scores: np.ndarray,
    sigmas: np.ndarray,
    max_dets: int,
    area_rng: Optional[Tuple[float, float]] = None,
) -> Optional[ImgEval]:
    if len(gts) == 0 and len(dts_kpts) == 0:
        return None
    gt_ignore_flags = []
    for g in gts:
        ig = bool(g.get("iscrowd", 0)) or g.get("num_keypoints", 0) == 0
        if area_rng is not None:
            a = g.get("area", 0)
            ig = ig or a < area_rng[0] or a > area_rng[1]
        gt_ignore_flags.append(ig)
    # sort gts: non-ignored first (stable) — COCOeval convention
    gt_order = np.argsort([1 if f else 0 for f in gt_ignore_flags], kind="mergesort")
    gts = [gts[i] for i in gt_order]
    gt_ig = np.array([gt_ignore_flags[i] for i in gt_order], bool)

    # sort dets by score desc, keep top max_dets
    d_order = np.argsort(-dt_scores, kind="mergesort")[:max_dets]
    dts_kpts = dts_kpts[d_order]
    dt_scores = dt_scores[d_order]

    ious = compute_oks(dts_kpts, gts, sigmas)
    T = len(IOU_THRS)
    n_d, n_g = len(dts_kpts), len(gts)
    dtm = np.zeros((T, n_d), np.int64)
    dt_ig = np.zeros((T, n_d), bool)
    gtm = np.zeros((T, n_g), np.int64)
    for t, thr in enumerate(IOU_THRS):
        for d in range(n_d):
            best = min(thr, 1 - 1e-10)
            m = -1
            for g in range(n_g):
                if gtm[t, g] > 0 and not gts[g].get("iscrowd", 0):
                    continue  # gt already matched (crowd gts can rematch)
                if m > -1 and not gt_ig[m] and gt_ig[g]:
                    break  # past all non-ignored gts with a real match in hand
                if ious[d, g] < best:
                    continue
                best = ious[d, g]
                m = g
            if m == -1:
                continue
            dt_ig[t, d] = gt_ig[m]
            dtm[t, d] = m + 1
            gtm[t, m] = d + 1
    # COCOeval also ignores UNMATCHED detections whose area falls outside
    # the bucket (dtIg |= dtm==0 & out-of-range); detection area is the
    # keypoint-extent bbox, as pycocotools loadRes computes it.
    if area_rng is not None and n_d:
        xs, ys = dts_kpts[:, :, 0], dts_kpts[:, :, 1]
        dt_areas = (xs.max(axis=1) - xs.min(axis=1)) * (ys.max(axis=1) - ys.min(axis=1))
        out = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
        dt_ig |= (dtm == 0) & out[None, :]
    return ImgEval(dt_matches=dtm, dt_ignore=dt_ig, gt_ignore=gt_ig, dt_scores=dt_scores)


def _accumulate(img_evals: List[Optional[ImgEval]]) -> Dict[str, np.ndarray]:
    """Precision/recall accumulation over a set of per-image results."""
    evs = [e for e in img_evals if e is not None]
    T = len(IOU_THRS)
    R = len(REC_THRS)
    precision = -np.ones((T, R))
    recall = -np.ones((T,))
    if not evs:
        return {"precision": precision, "recall": recall}
    scores = np.concatenate([e.dt_scores for e in evs])
    order = np.argsort(-scores, kind="mergesort")
    dtm = np.concatenate([e.dt_matches for e in evs], axis=1)[:, order]
    dt_ig = np.concatenate([e.dt_ignore for e in evs], axis=1)[:, order]
    n_gt = int(sum((~e.gt_ignore).sum() for e in evs))
    if n_gt == 0:
        return {"precision": precision, "recall": recall}

    tps = (dtm > 0) & ~dt_ig
    fps = (dtm == 0) & ~dt_ig
    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
    for t in range(T):
        tp, fp = tp_sum[t], fp_sum[t]
        rc = tp / n_gt
        pr = tp / np.maximum(tp + fp, np.spacing(1))
        recall[t] = rc[-1] if len(rc) else 0
        # precision envelope (monotone non-increasing from the right)
        pr = pr.tolist()
        for i in range(len(pr) - 1, 0, -1):
            if pr[i] > pr[i - 1]:
                pr[i - 1] = pr[i]
        inds = np.searchsorted(rc, REC_THRS, side="left")
        q = np.zeros(R)
        for ri, pi in enumerate(inds):
            if pi < len(pr):
                q[ri] = pr[pi]
        precision[t] = q
    return {"precision": precision, "recall": recall}


def _ap(acc: Dict[str, np.ndarray], thr: Optional[float] = None) -> float:
    p = acc["precision"]
    if thr is not None:
        t = int(np.where(np.isclose(IOU_THRS, thr))[0][0])
        p = p[t]
    valid = p[p > -1]
    return float(np.mean(valid)) if valid.size else -1.0


def _ar(acc: Dict[str, np.ndarray], thr: Optional[float] = None) -> float:
    r = acc["recall"]
    if thr is not None:
        t = int(np.where(np.isclose(IOU_THRS, thr))[0][0])
        r = r[t : t + 1]
    valid = r[r > -1]
    return float(np.mean(valid)) if valid.size else -1.0


class KeypointEvaluator:
    """OKS AP evaluator.

    Args:
      gt: CocoAnnotations (ground truth).
      style: 'coco' (area buckets) or 'crowdpose' (crowdIndex buckets).
    """

    def __init__(self, gt, style: str = "coco", sigmas: Optional[np.ndarray] = None,
                 max_dets: int = 20):
        self.gt = gt
        self.style = style
        if sigmas is None:
            sigmas = COCO_SIGMAS if style == "coco" else CROWDPOSE_SIGMAS
        self.sigmas = np.asarray(sigmas)
        self.max_dets = max_dets

    def evaluate(self, results: List[dict]) -> Dict[str, float]:
        """results: COCO results format — dicts with image_id, keypoints
        (flat 3K), score."""
        by_img: Dict[int, List[dict]] = {}
        for r in results:
            by_img.setdefault(r["image_id"], []).append(r)

        img_ids = self.gt.image_ids
        k = len(self.sigmas)

        def eval_ids(ids, area_rng=None):
            out = []
            for iid in ids:
                gts = self.gt.annotations_for(iid)
                dts = by_img.get(iid, [])
                kpts = (
                    np.asarray([d["keypoints"] for d in dts], np.float64).reshape(-1, k, 3)
                    if dts else np.zeros((0, k, 3))
                )
                scores = np.asarray([d["score"] for d in dts], np.float64)
                out.append(
                    _evaluate_img(gts, kpts, scores, self.sigmas, self.max_dets, area_rng)
                )
            return out

        stats: Dict[str, float] = {}
        main = _accumulate(eval_ids(img_ids))
        stats["AP"] = _ap(main)
        stats["AP .5"] = _ap(main, 0.5)
        stats["AP .75"] = _ap(main, 0.75)
        stats["AR"] = _ar(main)
        stats["AR .5"] = _ar(main, 0.5)
        stats["AR .75"] = _ar(main, 0.75)

        if self.style == "coco":
            med = _accumulate(eval_ids(img_ids, area_rng=(32**2, 96**2)))
            lrg = _accumulate(eval_ids(img_ids, area_rng=(96**2, 1e5**2)))
            stats["AP (M)"] = _ap(med)
            stats["AP (L)"] = _ap(lrg)
        else:  # crowdpose: AP by image crowdIndex buckets
            # crowdposetools convention (CrowdPoseDataset.py:288-293): the
            # per-image evals are reused; easy/medium/hard re-accumulate over
            # image subsets by crowdIndex — easy ci <= 0.1,
            # medium 0.1 < ci < 0.8, hard ci >= 0.8 (non-overlapping;
            # validated against tests/oracle_cocoeval.oracle_evaluate_crowdpose)
            def ci(iid):
                return self.gt.image_info(iid).get("crowdIndex", 0.0)

            for name, pred in (
                ("AP (E)", lambda c: c <= 0.1),
                ("AP (M)", lambda c: 0.1 < c < 0.8),
                ("AP (H)", lambda c: c >= 0.8),
            ):
                acc = _accumulate(eval_ids([i for i in img_ids if pred(ci(i))]))
                stats[name] = _ap(acc)
        return stats
