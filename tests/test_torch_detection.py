"""The detection ops against the JAX package on the CPU: every case of the
detection half of the JAX package's ``tests/python/unittest/
test_linalg_detection.py`` through both packages, plus ``box_nms`` at
random with ties, ``topk`` and batches (keep-sets identical),
``MultiBoxTarget`` with hard-negative mining, ``RROIAlign``, ``ROIPooling``
and ``ROIAlign`` with gradients, a small SSD chain (prior -> target ->
detection), and the two traps the port keeps: ``MultiBoxDetection`` reads
center-format anchors, and ``ROIAlign`` defaults to ``aligned=True``."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

TOL = 1e-5
# the registry ops this file holds against the JAX package
OPS = {"box_iou", "box_nms", "box_encode", "box_decode",
       "bipartite_matching", "roi_align", "multibox_prior",
       "multibox_detection", "multibox_target", "rroi_align", "ROIPooling"}


def host(x):
    if isinstance(x, (list, tuple)):
        return [host(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return x.asnumpy()


def same(got, ref, tol=TOL):
    got = got if isinstance(got, (list, tuple)) else [got]
    ref = ref if isinstance(ref, (list, tuple)) else [ref]
    assert len(got) == len(ref)
    for g, r in zip(host(list(got)), host(list(ref))):
        assert g.shape == r.shape and g.dtype == r.dtype, (
            g.shape, r.shape, g.dtype, r.dtype)
        if r.dtype.kind == "f":
            onp.testing.assert_allclose(g, r, rtol=tol, atol=tol)
        else:
            onp.testing.assert_array_equal(g, r)


def both(fn, tol=TOL):
    ref = fn(mj)
    with mt.cpu():
        got = fn(mt)
    same(got, ref, tol)
    return got, ref


def test_box_iou():
    a = onp.array([[0, 0, 2, 2], [1, 1, 3, 3]], onp.float32)
    b = onp.array([[0, 0, 2, 2], [2, 2, 4, 4], [5, 5, 6, 6]], onp.float32)
    for fmt in ("corner", "center"):
        both(lambda mx: mx.nd.contrib.box_iou(mx.nd.array(a),
                                              mx.nd.array(b), format=fmt))


@pytest.mark.parametrize("force", [False, True])
def test_box_nms(force):
    data = onp.array([[0, 0.9, 0, 0, 2, 2], [1, 0.8, 0.1, 0.1, 2.1, 2.1],
                      [1, 0.7, 5, 5, 7, 7]], onp.float32)
    got, _ = both(lambda mx: mx.nd.contrib.box_nms(
        mx.nd.array(data), overlap_thresh=0.5, coord_start=2, score_index=1,
        id_index=0, force_suppress=force))
    assert host(got)[1, 1] == (-1.0 if force else pytest.approx(0.8))


@pytest.mark.parametrize("topk,valid", [(-1, 0.0), (7, 0.0), (5, 0.3),
                                        (100, 0.5)])
def test_box_nms_random_batches_with_ties(topk, valid):
    """Batched NMS over many overlapping boxes, equal scores included (a
    stable sort keeps their order in both): identical keep-sets."""
    rs = onp.random.RandomState(topk + 10)
    B, N = 3, 40
    xy = rs.uniform(0, 5, (B, N, 2))
    wh = rs.uniform(0.5, 3, (B, N, 2))
    score = onp.round(rs.rand(B, N), 1)          # many ties
    ids = rs.randint(0, 3, (B, N))
    data = onp.concatenate([ids[..., None], score[..., None], xy, xy + wh],
                           axis=-1).astype(onp.float32)
    got, ref = both(lambda mx: mx.nd.contrib.box_nms(
        mx.nd.array(data), overlap_thresh=0.4, valid_thresh=valid,
        topk=topk, coord_start=2, score_index=1, id_index=0))
    keep = host(got)[..., 1] >= 0
    onp.testing.assert_array_equal(keep, host(ref)[..., 1] >= 0)
    assert 0 < keep.sum() < B * N


def test_box_nms_format_conversion():
    data = onp.array([[0.9, 1.0, 1.0, 2.0, 2.0]], onp.float32)
    for fin, fout in (("center", "corner"), ("corner", "center")):
        both(lambda mx: mx.nd.contrib.box_nms(
            mx.nd.array(data), coord_start=1, score_index=0, in_format=fin,
            out_format=fout))


def test_box_encode_decode():
    anchors = onp.array([[0, 0, 2, 2], [1, 1, 4, 5]], onp.float32)
    gt = onp.array([[0.2, 0.1, 2.5, 2.2], [0.8, 1.3, 4.5, 5.2]], onp.float32)
    samples = onp.float32([[1.0, 0.0]])
    matches = onp.float32([[1.0, 0.0]])

    def run(mx):
        enc, mask = mx.nd.contrib.box_encode(
            mx.nd.array(samples), mx.nd.array(matches),
            mx.nd.array(anchors[None]), mx.nd.array(gt[None]))
        dec = mx.nd.contrib.box_decode(enc, mx.nd.array(anchors[None]),
                                       clip=0.5)
        dec2 = mx.nd.contrib.box_decode(enc, mx.nd.array(anchors[None]),
                                        format="center")
        return [enc, mask, dec, dec2]

    both(run)


@pytest.mark.parametrize("kw", [{"threshold": 0.05},
                                {"threshold": 0.5, "is_ascend": True},
                                {"threshold": 0.1, "topk": 1}])
def test_bipartite_matching(kw):
    score = onp.random.RandomState(2).rand(2, 4, 3).astype(onp.float32)
    both(lambda mx: mx.nd.contrib.bipartite_matching(mx.nd.array(score),
                                                     **kw))


def test_roi_align_matches_manual():
    data = onp.full((1, 2, 8, 8), 3.0, onp.float32)
    rois = onp.array([[0, 1, 1, 5, 5]], onp.float32)
    got, _ = both(lambda mx: mx.nd.contrib.ROIAlign(
        mx.nd.array(data), mx.nd.array(rois), pooled_size=(2, 2)))
    onp.testing.assert_allclose(host(got), 3.0, rtol=1e-5)


@pytest.mark.parametrize("aligned,sr", [(True, 1), (False, 2), (True, 3)])
def test_roi_align_random_with_gradients(aligned, sr):
    """Boxes inside, across and beyond the map's border, two images, and
    the gradient with respect to the data."""
    rs = onp.random.RandomState(sr)
    data = rs.randn(2, 3, 9, 11).astype(onp.float32)
    rois = onp.array([[0, -3, -2, 6, 5], [1, 2, 3, 40, 30], [0, 4, 4, 4.5, 5],
                      [1, 10, 1, 21, 17], [0, 0, 0, 21, 17]], onp.float32)
    head = rs.randn(5, 3, 3, 2).astype(onp.float32)

    def run(mx):
        x = mx.nd.array(data)
        x.attach_grad()
        with mx.autograd.record():
            out = mx.nd.contrib.ROIAlign(x, mx.nd.array(rois),
                                         pooled_size=(3, 2),
                                         spatial_scale=0.5, sample_ratio=sr,
                                         aligned=aligned)
            loss = (out * mx.nd.array(head)).sum()
        loss.backward()
        return [out, x.grad]

    both(run)


def test_roi_align_position_sensitive():
    ph = pw = 2
    C = 3 * ph * pw
    data = onp.zeros((1, C, 4, 4), onp.float32)
    for k in range(C):
        data[0, k] = k
    rois = onp.array([[0, 0, 0, 4, 4]], onp.float32)
    both(lambda mx: mx.nd.contrib.ROIAlign(
        mx.nd.array(data), mx.nd.array(rois), pooled_size=(ph, pw),
        position_sensitive=True))


def test_roi_align_refuses_an_adaptive_grid():
    data = onp.zeros((1, 1, 4, 4), onp.float32)
    rois = onp.array([[0, 0, 0, 4, 4]], onp.float32)
    for mx in (mj, mt):
        with mt.cpu(), pytest.raises(ValueError):
            mx.nd.contrib.ROIAlign(mx.nd.array(data), mx.nd.array(rois),
                                   sample_ratio=0)


def test_roi_align_defaults_to_aligned():
    """The trap: ``aligned=True`` by default (a half-pixel shift)."""
    ramp = onp.tile(onp.arange(8, dtype=onp.float32), (1, 1, 8, 1))
    rois = onp.array([[0, 1, 1, 5, 5]], onp.float32)

    def run(mx):
        return [mx.nd.contrib.ROIAlign(mx.nd.array(ramp), mx.nd.array(rois),
                                       pooled_size=(1, 1), **kw)
                for kw in ({}, {"aligned": True}, {"aligned": False})]

    got, _ = both(run)
    d, t, f = (float(host(x).ravel()[0]) for x in got)
    assert d == t and abs(d - f) == pytest.approx(0.5, abs=1e-5)


@pytest.mark.parametrize("pooled,scale", [((2, 2), 1.0), ((3, 4), 0.5)])
def test_roi_pooling(pooled, scale):
    rs = onp.random.RandomState(7)
    data = rs.randn(2, 3, 10, 12).astype(onp.float32)
    rois = onp.array([[0, 0, 0, 9, 9], [1, 2.4, 3.6, 11, 7], [0, 5, 5, 5, 5],
                      [1, -4, 2, 30, 18]], onp.float32)

    def run(mx):
        x = mx.nd.array(data)
        x.attach_grad()
        with mx.autograd.record():
            out = mx.nd.ROIPooling(x, mx.nd.array(rois), pooled_size=pooled,
                                   spatial_scale=scale)
            loss = (out * out).sum()
        loss.backward()
        return [out, x.grad]

    both(run)


def test_rroi_align():
    rs = onp.random.RandomState(8)
    data = rs.randn(1, 2, 8, 9).astype(onp.float32)
    rois = onp.array([[0, 4, 4, 5, 3, 30], [0, 2, 6, 4, 4, -45],
                      [0, 8, 1, 6, 2, 90]], onp.float32)
    both(lambda mx: mx.nd._contrib_RROIAlign(
        mx.nd.array(data), mx.nd.array(rois), pooled_size=(2, 3),
        spatial_scale=1.0, sampling_ratio=2))


def test_multibox_prior_and_detection():
    def run(mx):
        feat = mx.nd.zeros((1, 3, 4, 4))
        anchors = mx.nd.contrib.MultiBoxPrior(feat, sizes=(0.5, 0.25),
                                              ratios=(1.0, 2.0))
        cls_prob = mx.nd.array(onp.array([[[0.1], [0.9]]], onp.float32))
        anch = mx.nd.array(onp.array([[[0.5, 0.5, 0.2, 0.2]]], onp.float32))
        det = mx.nd.contrib.MultiBoxDetection(cls_prob, mx.nd.zeros((1, 4)),
                                              anch)
        return [anchors, det]

    got, _ = both(run)
    assert host(got[0]).shape == (1, 48, 4)
    onp.testing.assert_allclose(host(got[1])[0, 0],
                                [0.0, 0.9, 0.4, 0.4, 0.6, 0.6], atol=1e-6)


@pytest.mark.parametrize("shape,kw", [
    ((1, 3, 2, 4), {"sizes": (0.5, 0.25), "ratios": (1.0,)}),
    ((1, 1, 3, 3), {"sizes": (0.3,), "ratios": (1.0, 2.0, 0.5),
                    "clip": True, "steps": (0.2, 0.25),
                    "offsets": (0.25, 0.75)})])
def test_multibox_prior_aspect_and_order(shape, kw):
    both(lambda mx: mx.nd.contrib.MultiBoxPrior(mx.nd.zeros(shape), **kw))


def test_multibox_detection_reads_center_anchors():
    """The trap: the JAX ``MultiBoxDetection`` decodes against anchors in
    center format (cx, cy, w, h), where ``MultiBoxPrior`` gives corners;
    the reference reads corners.  Corner anchors passed as they are give
    other boxes than their center form."""
    cls_prob = onp.array([[[0.1], [0.9]]], onp.float32)
    corner = onp.array([[[0.4, 0.4, 0.6, 0.6]]], onp.float32)

    def run(mx):
        return [mx.nd.contrib.MultiBoxDetection(
            mx.nd.array(cls_prob), mx.nd.zeros((1, 4)), mx.nd.array(a))
            for a in (corner, onp.array([[[0.5, 0.5, 0.2, 0.2]]],
                                        onp.float32))]

    got, _ = both(run)
    as_corner, as_center = host(got)
    onp.testing.assert_allclose(as_center[0, 0, 2:], [0.4, 0.4, 0.6, 0.6],
                                atol=1e-6)
    assert not onp.allclose(as_corner[0, 0, 2:], [0.4, 0.4, 0.6, 0.6])


def test_box_iou_gradient_of_zero_padded_boxes_is_finite():
    boxes = onp.array([[0, 0, 2, 2], [0, 0, 0, 0]], onp.float32)

    def run(mx):
        b = mx.nd.array(boxes)
        b.attach_grad()
        with mx.autograd.record():
            loss = mx.nd.contrib.box_iou(b, b).sum()
        loss.backward()
        return b.grad

    got, _ = both(run)
    assert onp.isfinite(host(got)).all()


def _ssd_inputs(rs, B, n, classes=4, max_gt=3):
    label = -onp.ones((B, max_gt, 5), onp.float32)
    for b in range(B):
        k = rs.randint(1, max_gt + 1)
        xy = rs.uniform(0.0, 0.6, (k, 2))
        label[b, :k, 0] = rs.randint(0, classes - 1, k)
        label[b, :k, 1:3] = xy
        label[b, :k, 3:5] = xy + rs.uniform(0.1, 0.4, (k, 2))
    logits = rs.randn(B, classes, n).astype(onp.float32)
    return label, logits


@pytest.mark.parametrize("kw", [{}, {"negative_mining_ratio": 3.0},
                                {"negative_mining_ratio": 2.0,
                                 "minimum_negative_samples": 5,
                                 "overlap_threshold": 0.3}])
def test_multibox_target(kw):
    rs = onp.random.RandomState(5)

    def run(mx):
        anc = mx.nd.contrib.MultiBoxPrior(mx.nd.zeros((1, 1, 5, 5)),
                                          sizes=(0.3, 0.5),
                                          ratios=(1.0, 2.0))
        return mx.nd.multibox_target(anc, mx.nd.array(label),
                                     mx.nd.array(logits), **kw)

    label, logits = _ssd_inputs(rs, 3, 75)
    got, _ = both(run)
    assert (host(got[2]) > 0).any() and (host(got[2]) == 0).any()


def test_small_ssd_chain():
    """MultiBoxPrior -> MultiBoxTarget (negative mining) ->
    MultiBoxDetection (anchors converted to center format, NMS with a
    top-k) on two small maps."""
    rs = onp.random.RandomState(6)

    def run(mx):
        parts = [mx.nd.contrib.MultiBoxPrior(mx.nd.zeros((1, 1, s, s)),
                                             sizes=sz, ratios=(1.0, 2.0, 0.5))
                 for s, sz in ((6, (0.2, 0.3)), (3, (0.5, 0.6)))]
        anc = mx.nd.concat(*parts, dim=1)
        n = anc.shape[1]
        label, logits = _ssd_inputs(onp.random.RandomState(6), 2, n)
        loc_t, loc_m, cls_t = mx.nd.multibox_target(
            anc, mx.nd.array(label), mx.nd.array(logits),
            negative_mining_ratio=3.0)
        prob = mx.nd.softmax(mx.nd.array(logits), axis=1)
        a = anc.asnumpy()[0]
        center = onp.stack([(a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2,
                            a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]], axis=1)
        det = mx.nd.contrib.MultiBoxDetection(
            prob, mx.nd.array(rs_loc[:, :n * 4]),
            mx.nd.array(center[None]), nms_threshold=0.45, nms_topk=20)
        return [anc, loc_t, loc_m, cls_t, det]

    rs_loc = (rs.randn(2, 4 * 200) * 0.1).astype(onp.float32)
    got, ref = both(run)
    keep = host(got[-1])[..., 1] >= 0
    onp.testing.assert_array_equal(keep, host(ref[-1])[..., 1] >= 0)
    assert 0 < keep.sum() <= 2 * 20
