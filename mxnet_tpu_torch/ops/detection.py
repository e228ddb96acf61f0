"""The detection ops: box IoU, NMS, box encode/decode, bipartite matching,
ROI Align, and the SSD multibox family (prior, detection, target) with the
rotated ROI align.

Counterpart of ``mxnet_tpu/ops/detection.py``, with its defaults and
conventions: suppressed NMS rows keep their place with score -1;
``roi_align`` defaults to ``aligned=True``; ``multibox_detection`` reads
its anchors in center format ``(cx, cy, w, h)``, where
``multibox_prior`` returns corners (a fault of the reference the port
keeps: convert with the ``_center`` rule before detection).  The JAX
package's static-shape loops become:

- ``box_nms``: a stable sort by score, then the greedy pass over the boxes
  that can matter -- the top ``topk`` valid ones, a bound read once on the
  host -- for every image at once, a box suppressing only lower-ranked
  boxes (a kept higher-ranked box that overlapped it would have
  suppressed it first).  The keep-sets equal the JAX loop over all N
  boxes, whose boxes past ``topk`` start suppressed and suppress nothing.
- ``roi_align``: per image, the bilinear sampling of a bin is separable,
  so the averaged samples of all bins of all RoIs are two matrix products
  (rows, then columns) over the feature map: no per-RoI gather of the
  map, in chunks of RoIs that bound the intermediate's memory.
- ``multibox_target`` and ``rroi_align``: host numpy kernels, as in the
  JAX package and the reference (sequential matching, CPU-only there too).
"""
from __future__ import annotations

import numpy as _np
import torch

from .registry import register

__all__ = []


def _corner(boxes, fmt):
    """-> (xmin, ymin, xmax, ymax) from 'corner' or 'center' format."""
    if fmt == "corner":
        return boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    cx, cy, w, h = (boxes[..., 0], boxes[..., 1], boxes[..., 2],
                    boxes[..., 3])
    return cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2


def _center(boxes):
    """Corner boxes -> center format (cx, cy, w, h)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack([boxes[..., 0] + w / 2, boxes[..., 1] + h / 2, w, h],
                       dim=-1)


@register("box_iou")
def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU: lhs (..., N, 4) x rhs (..., M, 4) -> (..., N, M)."""
    lx1, ly1, lx2, ly2 = _corner(lhs[..., :, None, :], format)
    rx1, ry1, rx2, ry2 = _corner(rhs[..., None, :, :], format)
    ix = torch.clamp(torch.minimum(lx2, rx2) - torch.maximum(lx1, rx1),
                     min=0)
    iy = torch.clamp(torch.minimum(ly2, ry2) - torch.maximum(ly1, ry1),
                     min=0)
    inter = ix * iy
    area_l = torch.clamp(lx2 - lx1, min=0) * torch.clamp(ly2 - ly1, min=0)
    area_r = torch.clamp(rx2 - rx1, min=0) * torch.clamp(ry2 - ry1, min=0)
    union = area_l + area_r - inter
    # the denominator guarded before the division, so that zero-padded
    # boxes give no NaN gradient
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(union > 0, inter / safe, torch.zeros_like(union))


def _greedy_keep(sup, keep):
    """The greedy pass: ``sup`` (B, L, L) bool, box i suppresses box j
    (ranked below it); ``keep`` (B, L) the boxes that start kept.  A kept
    box suppresses, in rank order."""
    for i in range(keep.shape[1]):
        keep = keep & ~(sup[:, i] & keep[:, i:i + 1])
    return keep


@register("box_nms", differentiable=False)
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner"):
    """Non-maximum suppression over rows [id?, score, x1, y1, x2, y2, ...]
    of ``data`` (..., N, K): suppressed rows keep their place with score
    -1."""
    batch_shape = data.shape[:-2]
    N, K = data.shape[-2], data.shape[-1]
    flat = data.reshape((-1, N, K))
    scores = flat[..., score_index]
    boxes = flat[..., coord_start:coord_start + 4]
    valid = scores > valid_thresh
    # stable, as jnp.argsort: equal scores keep their order
    order = torch.argsort(-torch.where(valid, scores,
                                       torch.full_like(scores, -float("inf"))),
                          dim=-1, stable=True)
    # the valid boxes rank first; only the top ``topk`` of them can keep
    bound = int(valid.sum(dim=-1).max()) if N else 0
    L = min(bound, topk) if topk > 0 else bound
    keep = torch.zeros_like(valid)
    if L:
        top = order[:, :L]
        b_s = torch.gather(boxes, 1, top[..., None].expand(-1, -1, 4))
        iou = box_iou(b_s, b_s, format=in_format)
        sup = (iou > overlap_thresh) & torch.ones(
            L, L, dtype=torch.bool, device=data.device).triu(1)
        if not force_suppress and id_index >= 0:
            ids = torch.gather(flat[..., id_index], 1, top)
            sup = sup & (ids[:, :, None] == ids[:, None, :])
        kept = _greedy_keep(sup, torch.gather(valid, 1, top))
        keep = keep.scatter(1, top, kept)
    out = flat.clone()
    out[..., score_index] = torch.where(keep, scores,
                                        torch.full_like(scores, -1.0))
    if in_format != out_format:
        if out_format == "corner":
            conv = torch.stack(_corner(boxes, in_format), dim=-1)
        else:
            conv = _center(boxes)
        out[..., coord_start:coord_start + 4] = conv
    return out.reshape(batch_shape + (N, K))


@register("box_encode")
def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """Matched ground-truth boxes as anchor offsets (the SSD target
    convention): (targets, masks)."""
    ax1, ay1, ax2, ay2 = (anchors[..., 0], anchors[..., 1], anchors[..., 2],
                          anchors[..., 3])
    aw, ah = ax2 - ax1, ay2 - ay1
    acx, acy = ax1 + aw / 2, ay1 + ah / 2
    idx = matches.long().clamp(min=0)[..., None].expand(
        *matches.shape, refs.shape[-1])
    g = torch.gather(refs, -2, idx)
    gx1, gy1, gx2, gy2 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    gw, gh = gx2 - gx1, gy2 - gy1
    gcx, gcy = gx1 + gw / 2, gy1 + gh / 2
    means = torch.as_tensor(means, dtype=anchors.dtype, device=anchors.device)
    stds = torch.as_tensor(stds, dtype=anchors.dtype, device=anchors.device)
    t = torch.stack([(gcx - acx) / aw.clamp(min=1e-12),
                     (gcy - acy) / ah.clamp(min=1e-12),
                     torch.log(gw.clamp(min=1e-12) / aw.clamp(min=1e-12)),
                     torch.log(gh.clamp(min=1e-12) / ah.clamp(min=1e-12))],
                    dim=-1)
    t = (t - means) / stds
    mask = (samples > 0.5)[..., None].expand(t.shape)
    return torch.where(mask, t, torch.zeros_like(t)), mask.to(anchors.dtype)


@register("box_decode")
def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):
    """The inverse of ``box_encode``: offsets -> corner boxes."""
    ax1, ay1, ax2, ay2 = _corner(anchors, format)
    aw, ah = ax2 - ax1, ay2 - ay1
    acx, acy = ax1 + aw / 2, ay1 + ah / 2
    stds = torch.tensor([std0, std1, std2, std3], dtype=data.dtype,
                        device=data.device)
    d = data * stds
    pcx = d[..., 0] * aw + acx
    pcy = d[..., 1] * ah + acy
    dw, dh = d[..., 2], d[..., 3]
    if clip > 0:
        dw = torch.clamp(dw, max=clip)
        dh = torch.clamp(dh, max=clip)
    pw, ph = torch.exp(dw) * aw, torch.exp(dh) * ah
    return torch.stack([pcx - pw / 2, pcy - ph / 2,
                        pcx + pw / 2, pcy + ph / 2], dim=-1)


@register("bipartite_matching", num_outputs=2, differentiable=False)
def bipartite_matching(data, threshold=0.5, is_ascend=False, topk=-1):
    """Greedy bipartite matching on a score matrix (..., N, M): the best
    remaining pair first, ``topk`` rounds (default N).  Returns
    (row_match, col_match), -1 where unmatched."""
    N, M = data.shape[-2], data.shape[-1]
    batch_shape = data.shape[:-2]
    s = data.reshape((-1, N, M))
    s = (-s if is_ascend else s).clone()
    bound = -threshold if is_ascend else threshold
    B = s.shape[0]
    rows = torch.arange(B, device=s.device)
    rm = torch.full((B, N), -1, dtype=torch.int32, device=s.device)
    cm = torch.full((B, M), -1, dtype=torch.int32, device=s.device)
    # a taken row or column drops to -inf (an integer matrix's least value,
    # where JAX's cast of -inf lands)
    ninf = torch.tensor(-float("inf") if s.is_floating_point()
                        else torch.iinfo(s.dtype).min, dtype=s.dtype,
                        device=s.device)
    for _ in range(N if topk <= 0 else min(topk, N)):
        idx = torch.argmax(s.reshape(B, -1), dim=1)
        i, j = idx // M, idx % M
        ok = s[rows, i, j] >= bound
        rm[rows, i] = torch.where(ok, j.to(torch.int32), rm[rows, i])
        cm[rows, j] = torch.where(ok, i.to(torch.int32), cm[rows, j])
        hit_i = ok[:, None] & (torch.arange(N, device=s.device)[None]
                               == i[:, None])
        hit_j = ok[:, None] & (torch.arange(M, device=s.device)[None]
                               == j[:, None])
        s = torch.where(hit_i[:, :, None] | hit_j[:, None, :], ninf, s)
    return rm.reshape(batch_shape + (N,)), cm.reshape(batch_shape + (M,))


def _div(a, n):
    """``a / n`` correctly rounded on every device: CUDA divides by a
    Python scalar through its reciprocal, which can move a bin edge that
    falls on an integer across it."""
    return a / torch.tensor(float(n), dtype=a.dtype, device=a.device)


def _axis_weights(lo, bin_size, n_bins, sr, size):
    """(R, n_bins, size): the bilinear weights of one axis, averaged over a
    bin's ``sr`` samples and zero where a sample falls outside
    [-1, size], as the JAX op (and ``roi_align.cc``) sample: the
    coordinate clamped to 0 before its weights are taken."""
    R = lo.shape[0]
    dev, dt = lo.device, lo.dtype
    grid = (torch.arange(n_bins, device=dev, dtype=dt)[:, None]
            + _div(torch.arange(sr, device=dev, dtype=dt)[None, :] + 0.5,
                   sr)).reshape(-1)
    pos = lo[:, None] + grid[None, :] * bin_size[:, None]   # (R, n_bins*sr)
    inside = ((pos >= -1.0) & (pos <= size)).to(dt)
    pos = torch.clamp(pos, min=0.0)
    p0 = torch.floor(pos)
    frac = pos - p0
    i0 = torch.clamp(p0.long(), 0, size - 1)
    i1 = torch.clamp(i0 + 1, 0, size - 1)
    w = torch.zeros(R, n_bins, size, dtype=dt, device=dev)
    shape = (R, n_bins, sr)
    w.scatter_add_(2, i0.reshape(shape),
                   _div((1 - frac) * inside, sr).reshape(shape))
    w.scatter_add_(2, i1.reshape(shape),
                   _div(frac * inside, sr).reshape(shape))
    return w


_ROI_CHUNK_BYTES = 256 << 20   # bound on one chunk's row-pass result


@register("roi_align")
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=True):
    """ROI Align (Mask R-CNN): ``sample_ratio``^2 bilinear samples a bin,
    averaged.  data (B, C, H, W); rois (R, 5) rows [batch_idx, x1, y1, x2,
    y2] in image coordinates -> (R, C, ph, pw)."""
    B, C, H, W = data.shape
    ph, pw = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (pooled_size, pooled_size))
    if sample_ratio <= 0:
        # the reference's adaptive grid would give each RoI its own
        # number of samples
        raise ValueError(
            "roi_align takes a sample_ratio >= 1 (the reference's adaptive "
            "sample_ratio <= 0 is not supported); sample_ratio=2 is the "
            "common detectron recipe")
    if position_sensitive and C % (ph * pw):
        raise ValueError("position_sensitive=True needs channels divisible "
                         "by ph*pw (got C=%d)" % C)
    sr = int(sample_ratio)
    offset = 0.5 if aligned else 0.0
    rois = rois.to(data.dtype)
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    least = 1e-6 if aligned else 1.0
    rw = torch.clamp(x2 - x1, min=least)
    rh = torch.clamp(y2 - y1, min=least)
    ay = _axis_weights(y1, _div(rh, ph), ph, sr, H)  # (R, ph, H)
    ax = _axis_weights(x1, _div(rw, pw), pw, sr, W)  # (R, pw, W)
    R = rois.shape[0]
    out = data.new_zeros((R, C, ph, pw))
    bidx = rois[:, 0].long()
    chunk = max(1, _ROI_CHUNK_BYTES // max(1, ph * C * W
                                           * data.element_size()))
    for b in torch.unique(bidx).tolist():            # one host read
        members = torch.nonzero(bidx == b).reshape(-1)
        img = data[b].permute(1, 0, 2).reshape(H, C * W)
        for lo in range(0, members.numel(), chunk):
            sel = members[lo:lo + chunk]
            n = sel.numel()
            rows = (ay[sel].reshape(n * ph, H) @ img).reshape(n, ph * C, W)
            pooled = rows @ ax[sel].transpose(1, 2)  # (n, ph*C, pw)
            out[sel] = pooled.reshape(n, ph, C, pw).permute(0, 2, 1, 3)
    if position_sensitive:
        c_out = C // (ph * pw)
        cidx = (torch.arange(c_out, device=data.device)[:, None, None]
                * (ph * pw)
                + torch.arange(ph, device=data.device)[None, :, None] * pw
                + torch.arange(pw, device=data.device)[None, None, :])
        i = torch.arange(ph, device=data.device)[None, :, None]
        j = torch.arange(pw, device=data.device)[None, None, :]
        out = out[:, cidx, i.expand_as(cidx), j.expand_as(cidx)]
    return out


@register("multibox_prior", differentiable=False)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors of a (.., H, W) feature map: (1, H*W*A, 4) corners, the
    anchors of a cell in the reference's order (every size with
    ratios[0], then ratios[1:] with sizes[0]), widths scaled by H/W so
    that boxes stay square in the image."""
    H, W = data.shape[-2], data.shape[-1]
    sizes = _np.asarray(sizes, _np.float32)
    ratios = _np.asarray(ratios, _np.float32)
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    dev = data.device
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    aspect = float(H) / float(W)
    ws, hs = [], []
    for s in sizes:
        ws.append(s * aspect * _np.sqrt(ratios[0]))
        hs.append(s / _np.sqrt(ratios[0]))
    for r in ratios[1:]:
        ws.append(sizes[0] * aspect * _np.sqrt(r))
        hs.append(sizes[0] / _np.sqrt(r))
    ws = torch.from_numpy(_np.asarray(ws) / 2).to(dev)
    hs = torch.from_numpy(_np.asarray(hs) / 2).to(dev)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    cyg, cxg = cyg[..., None], cxg[..., None]
    boxes = torch.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs], dim=-1)
    boxes = boxes.reshape(1, -1, 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


@register("multibox_detection", differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchors, clip=True,
                       threshold=0.01, nms_threshold=0.5, force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD detection head: decode, best class per anchor, NMS.  cls_prob
    (B, CLS, N) with class 0 the background, loc_pred (B, N*4), anchors
    (1, N, 4) in CENTER format -> (B, N, 6) rows [cls_id, score, x1, y1,
    x2, y2], -1 where invalid or suppressed."""
    B, CLS, N = cls_prob.shape
    loc = loc_pred.reshape(B, N, 4)
    acx, acy, aw, ah = (anchors[..., 0], anchors[..., 1], anchors[..., 2],
                        anchors[..., 3])
    v = variances
    pcx = loc[..., 0] * v[0] * aw + acx
    pcy = loc[..., 1] * v[1] * ah + acy
    pw = torch.exp(loc[..., 2] * v[2]) * aw
    ph = torch.exp(loc[..., 3] * v[3]) * ah
    boxes = torch.stack([pcx - pw / 2, pcy - ph / 2,
                         pcx + pw / 2, pcy + ph / 2], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    scores = cls_prob[:, 1:, :]                       # background dropped
    best_score = scores.max(dim=1).values
    best = torch.argmax(scores, dim=1).to(torch.float32)   # the first best
    keep = best_score > threshold
    cls_id = torch.where(keep, best, torch.full_like(best, -1.0))
    score = torch.where(keep, best_score, torch.full_like(best_score, -1.0))
    det = torch.cat([cls_id[..., None], score[..., None], boxes], dim=-1)
    return box_nms(det, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else _np.asarray(t)


@register("multibox_target", differentiable=False, num_outputs=3)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets: greedy bipartite ground-truth <-> anchor
    matching, then IoU-threshold matching, optional hard-negative mining
    by background confidence, and variance-scaled offsets.  A host numpy
    kernel, as in the JAX package and the reference (the matching is a
    sequential argmax with removal): the inputs are read to the host, the
    targets go back to ``anchor``'s device.

    anchor (1, N, 4) corners, label (B, M, 5+) rows [cls, x1, y1, x2, y2,
    ...] padded with -1, cls_pred (B, CLS, N) -> (loc_target (B, N*4),
    loc_mask (B, N*4), cls_target (B, N))."""
    onp = _np
    anc = _host(anchor).reshape(-1, 4)
    lab = _host(label)
    cp = _host(cls_pred)
    B, M, _W = lab.shape
    N = anc.shape[0]
    loc_t = onp.zeros((B, N, 4), onp.float32)
    loc_m = onp.zeros((B, N, 4), onp.float32)
    cls_t = onp.full((B, N), float(ignore_label), onp.float32)

    aw = onp.maximum(anc[:, 2] - anc[:, 0], 1e-12)
    ah = onp.maximum(anc[:, 3] - anc[:, 1], 1e-12)
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2

    def iou(a, b):
        ix = onp.maximum(0, onp.minimum(a[:, None, 2], b[None, :, 2])
                         - onp.maximum(a[:, None, 0], b[None, :, 0]))
        iy = onp.maximum(0, onp.minimum(a[:, None, 3], b[None, :, 3])
                         - onp.maximum(a[:, None, 1], b[None, :, 1]))
        inter = ix * iy
        ua = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None] \
            + ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :] - inter
        return inter / onp.maximum(ua, 1e-12)

    for nb in range(B):
        valid = 0
        while valid < M and lab[nb, valid, 0] != -1.0:
            valid += 1
        if valid == 0:
            continue
        gt = lab[nb, :valid]
        overlaps = iou(anc, gt[:, 1:5])              # (N, valid)
        anchor_flags = onp.full(N, -1, onp.int8)     # -1 ignore, 1 pos, 0 neg
        matches = onp.full(N, -1, onp.int64)
        match_iou = onp.full(N, -1.0, onp.float32)
        # 1. greedy bipartite: every gt takes its best still-free anchor
        gt_free = onp.ones(valid, bool)
        work = overlaps.copy()
        while gt_free.any():
            j, k = onp.unravel_index(onp.argmax(
                onp.where(gt_free[None, :], work, -1.0)), work.shape)
            if work[j, k] <= 1e-6:
                break
            matches[j] = k
            match_iou[j] = work[j, k]
            anchor_flags[j] = 1
            gt_free[k] = False
            work[j, :] = -1.0
        # 2. threshold matching for the rest
        if overlap_threshold > 0:
            free = anchor_flags != 1
            best_gt = onp.argmax(overlaps, axis=1)
            best_iou = overlaps[onp.arange(N), best_gt]
            take = free & (best_iou > overlap_threshold)
            matches[take] = best_gt[take]
            match_iou[free] = best_iou[free]
            anchor_flags[take] = 1
        num_pos = int((anchor_flags == 1).sum())
        # 3. negatives
        if negative_mining_ratio > 0:
            num_neg = min(int(num_pos * negative_mining_ratio),
                          N - num_pos)
            num_neg = max(num_neg, int(minimum_negative_samples))
            cand = onp.where((anchor_flags != 1)
                             & (match_iou < negative_mining_thresh))[0]
            if num_neg > 0 and len(cand):
                logits = cp[nb]                       # (CLS, N)
                mx_ = logits[:, cand].max(axis=0)
                prob_bg = onp.exp(logits[0, cand] - mx_) / onp.exp(
                    logits[:, cand] - mx_).sum(axis=0)
                # hardest negatives: the lowest background confidence
                order = onp.argsort(prob_bg, kind="stable")
                anchor_flags[cand[order[:num_neg]]] = 0
        else:
            anchor_flags[anchor_flags != 1] = 0
        # 4. targets
        pos = onp.where(anchor_flags == 1)[0]
        neg = onp.where(anchor_flags == 0)[0]
        cls_t[nb, neg] = 0.0
        if len(pos):
            g = gt[matches[pos]]
            cls_t[nb, pos] = g[:, 0] + 1.0
            gw = onp.maximum(g[:, 3] - g[:, 1], 1e-12)
            gh = onp.maximum(g[:, 4] - g[:, 2], 1e-12)
            gcx = (g[:, 1] + g[:, 3]) / 2
            gcy = (g[:, 2] + g[:, 4]) / 2
            v = variances
            loc_t[nb, pos, 0] = ((gcx - acx[pos]) / aw[pos]) / v[0]
            loc_t[nb, pos, 1] = ((gcy - acy[pos]) / ah[pos]) / v[1]
            loc_t[nb, pos, 2] = onp.log(gw / aw[pos]) / v[2]
            loc_t[nb, pos, 3] = onp.log(gh / ah[pos]) / v[3]
            loc_m[nb, pos] = 1.0
    dev = anchor.device if isinstance(anchor, torch.Tensor) else None
    return tuple(torch.from_numpy(a).to(dev) for a in (
        loc_t.reshape(B, -1), loc_m.reshape(B, -1), cls_t))


@register("rroi_align", differentiable=False)
def rroi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
               sampling_ratio=-1):
    """Rotated ROI align (CPU-only in the reference too): rois rows
    [batch_idx, cx, cy, w, h, angle_deg]; bilinear samples on the rotated
    grid of each bin, averaged.  A host numpy kernel."""
    onp = _np
    x = _host(data)
    r = _host(rois)
    _B, C, H, W = x.shape
    ph, pw = (pooled_size, pooled_size) if isinstance(pooled_size, int) \
        else tuple(pooled_size)
    R = r.shape[0]
    out = onp.zeros((R, C, ph, pw), onp.float32)
    for i in range(R):
        b = int(r[i, 0])
        cx, cy, w, h = (r[i, 1] * spatial_scale, r[i, 2] * spatial_scale,
                        max(r[i, 3] * spatial_scale, 1.0),
                        max(r[i, 4] * spatial_scale, 1.0))
        theta = onp.deg2rad(r[i, 5])
        cos_t, sin_t = onp.cos(theta), onp.sin(theta)
        sr = sampling_ratio if sampling_ratio > 0 else 2
        for py in range(ph):
            for px in range(pw):
                acc = onp.zeros(C, onp.float32)
                for iy in range(sr):
                    for ix in range(sr):
                        # unit coordinates in the RoI's frame, centered
                        ux = (px + (ix + 0.5) / sr) / pw - 0.5
                        uy = (py + (iy + 0.5) / sr) / ph - 0.5
                        sx = cx + ux * w * cos_t - uy * h * sin_t
                        sy = cy + ux * w * sin_t + uy * h * cos_t
                        if sx < -1.0 or sx > W or sy < -1.0 or sy > H:
                            continue
                        # clamped before the fractions are taken: a border
                        # sample reads the edge pixel
                        sxc = min(max(sx, 0.0), W - 1)
                        syc = min(max(sy, 0.0), H - 1)
                        x0c = int(onp.floor(sxc))
                        y0c = int(onp.floor(syc))
                        x1c = min(x0c + 1, W - 1)
                        y1c = min(y0c + 1, H - 1)
                        fx = sxc - x0c
                        fy = syc - y0c
                        val = ((1 - fx) * (1 - fy) * x[b, :, y0c, x0c]
                               + fx * (1 - fy) * x[b, :, y0c, x1c]
                               + (1 - fx) * fy * x[b, :, y1c, x0c]
                               + fx * fy * x[b, :, y1c, x1c])
                        acc += val
                out[i, :, py, px] = acc / (sr * sr)
    dev = data.device if isinstance(data, torch.Tensor) else None
    return torch.from_numpy(out).to(dev)
