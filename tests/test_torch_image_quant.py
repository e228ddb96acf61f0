"""The image ops and the quantization ops of the PyTorch port against the
JAX package's, on the CPU, through ``mx.nd`` (``nd.image``'s short names
for the image family).

Deterministic ops compare in shape, dtype and value (within ``RTOL``/
``ATOL``; exactly for integer results).  The random image ops draw from
each package's own generator, whose streams never match, so each runs
with its factor pinned (``min_factor == max_factor``, ``p`` of 0 or 1,
``alpha_std=0``): what is compared is the deterministic part around the
draw.  ``random_resized_crop``'s geometry is checked for shape and range.
Gradients of the differentiable image and sampling ops agree with JAX's.
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

RTOL, ATOL = 1e-5, 1e-5
RS = np.random.RandomState(5)
U8 = RS.randint(0, 256, (6, 8, 3)).astype(np.uint8)
U8B = RS.randint(0, 256, (2, 6, 8, 3)).astype(np.uint8)
F = RS.rand(6, 8, 3).astype(np.float32)
FB = RS.rand(2, 6, 8, 3).astype(np.float32)
CHW = RS.rand(3, 6, 8).astype(np.float32)
NCHW = RS.rand(2, 3, 5, 6).astype(np.float32)
THETA = np.float32([[0.9, 0.1, 0.05, -0.1, 1.1, -0.05],
                    [1.0, 0.0, 0.2, 0.0, 0.8, 0.1]])
WARP = (RS.rand(2, 2, 5, 6).astype(np.float32) - 0.5) * 2

# name: (inputs, attrs, differentiable input positions)
IMAGE = {
    "to_tensor": ([U8], {}),
    "to_tensor_batched": ([U8B], {}),
    "normalize": ([CHW], {"mean": (0.5, 0.4, 0.3), "std": (0.2, 0.3, 0.4)}),
    "normalize_batched": ([NCHW], {"mean": 0.5, "std": 0.25}),
    "resize_up": ([F], {"size": (12, 9)}),
    "resize_down": ([FB], {"size": (4, 3)}),
    "resize_nearest": ([U8], {"size": (5, 4), "interp": 0}),
    "resize_u8": ([U8], {"size": (16, 12)}),
    "crop": ([FB], {"x": 1, "y": 2, "width": 4, "height": 3}),
    "flip_left_right": ([F], {}),
    "flip_top_bottom": ([FB], {}),
    "adjust_lighting": ([F], {"alpha": (0.01, -0.02, 0.03)}),
    # the random ops with their draws pinned
    "random_crop": ([F], {"xrange": (0.5, 0.5), "yrange": (1.0, 1.0),
                          "width": 5, "height": 4}),
    "random_flip_left_right": ([F], {"p": 1.0}),
    "random_flip_top_bottom": ([F], {"p": 0.0}),
    "random_brightness": ([F], {"min_factor": 1.3, "max_factor": 1.3}),
    "random_contrast": ([FB], {"min_factor": 0.6, "max_factor": 0.6}),
    "random_saturation": ([F], {"min_factor": 1.4, "max_factor": 1.4}),
    "random_hue": ([F], {"min_factor": 0.2, "max_factor": 0.2}),
    "random_color_jitter": ([F], {"brightness": 0.0, "contrast": 0.0}),
    "random_lighting": ([F], {"alpha_std": 0.0}),
}
SAMPLING = {
    "BilinearSampler": ([NCHW, np.clip(WARP * 0.7, -1.1, 1.1)], {}),
    "GridGenerator": ([THETA], {"transform_type": "affine",
                                "target_shape": (4, 5)}),
    "GridGenerator_warp": ([WARP], {"transform_type": "warp"}),
    "SpatialTransformer": ([NCHW, THETA], {"target_shape": (4, 5)}),
}


def _op(mx, key):
    name = key.split("_batched")[0]
    for suffix in ("_up", "_down", "_nearest", "_u8", "_warp"):
        if name.endswith(suffix) and name[:-len(suffix)] in (
                "resize", "GridGenerator"):
            name = name[:-len(suffix)]
    if key in SAMPLING:
        return getattr(mx.nd, name)
    return getattr(mx.nd.image, name)


def _outs(x):
    return [o.asnumpy() for o in (x if isinstance(x, tuple) else (x,))]


def _same(got, ref, key, rtol=RTOL, atol=ATOL):
    assert len(got) == len(ref), key
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, (
            key, g.shape, r.shape, g.dtype, r.dtype)
        if r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                       err_msg=key)
        else:
            # uint8 rounding at .5 boundaries may differ by one level
            assert np.abs(g.astype(int) - r.astype(int)).max() <= 1, key


def _run(mx, key, table):
    inputs, attrs = table[key]
    return _op(mx, key)(*[mx.nd.array(x) for x in inputs], **attrs)


@pytest.mark.parametrize("key", sorted(IMAGE) + sorted(SAMPLING))
def test_image_op_matches_jax(key):
    table = IMAGE if key in IMAGE else SAMPLING
    ref = _outs(_run(mj, key, table))
    with mt.cpu():
        got = _outs(_run(mt, key, table))
    # resize's antialiased shrink weights the taps in float32 as JAX does
    # not bit for bit
    _same(got, ref, key, atol=1e-4 if "resize" in key else ATOL)


def test_random_resized_crop_keeps_the_geometry():
    with mt.cpu():
        mt.random.seed(3)
        outs = [mt.nd.image.random_resized_crop(mt.nd.array(FB),
                                                size=(5, 4))
                for _ in range(4)]
    for o in outs:
        assert o.shape == (2, 4, 5, 3) and o.dtype == np.float32
        assert 0.0 <= o.asnumpy().min() and o.asnumpy().max() <= 1.0


def test_random_ops_draw_on_the_port_generator():
    with mt.cpu():
        mt.random.seed(1)
        a = mt.nd.image.random_brightness(mt.nd.array(F), 0.5, 1.5)
        mt.random.seed(1)
        b = mt.nd.image.random_brightness(mt.nd.array(F), 0.5, 1.5)
        c = mt.nd.image.random_brightness(mt.nd.array(F), 0.5, 1.5)
    assert np.array_equal(a.asnumpy(), b.asnumpy())
    assert not np.array_equal(b.asnumpy(), c.asnumpy())


GRAD = ["normalize", "resize_up", "crop", "flip_left_right",
        "adjust_lighting", "BilinearSampler", "GridGenerator",
        "SpatialTransformer"]


def _grads(mx, key):
    table = IMAGE if key in IMAGE else SAMPLING
    inputs, attrs = table[key]
    xs = [mx.nd.array(x) for x in inputs]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        out = _op(mx, key)(*xs, **attrs)
        w = np.random.RandomState(2).rand(*out.shape).astype(np.float32)
        loss = mx.nd.sum(out * mx.nd.array(w))
    loss.backward()
    return [x.grad.asnumpy() for x in xs]


@pytest.mark.parametrize("key", GRAD)
def test_image_gradients_match_jax(key):
    ref = _grads(mj, key)
    with mt.cpu():
        got = _grads(mt, key)
    _same(got, ref, key, rtol=1e-4, atol=1e-4)


# ---- quantization ----------------------------------------------------------

X = (RS.rand(4, 6).astype(np.float32) - 0.5) * 3
WQ = RS.randint(-127, 128, (5, 6)).astype(np.int8)
XQ = RS.randint(-127, 128, (4, 6)).astype(np.int8)
XQC = RS.randint(-127, 128, (2, 3, 6, 6)).astype(np.int8)
WQC = RS.randint(-127, 128, (4, 3, 3, 3)).astype(np.int8)
ACC = RS.randint(-2 ** 20, 2 ** 20, (4, 5)).astype(np.int32)
BIAS = RS.rand(5).astype(np.float32)
BIASC = RS.rand(4).astype(np.float32)

QUANT = {
    "quantize": ([X, np.float32(-1.2), np.float32(1.5)], {}),
    "quantize_v2": ([X], {}),
    "quantize_v2_calib": ([X], {"min_calib_range": -1.0,
                                "max_calib_range": 1.0}),
    "dequantize": ([XQ, np.float32(-2.0), np.float32(2.0)], {}),
    "requantize": ([ACC, np.float32(-50.0), np.float32(50.0)], {}),
    "requantize_calib": ([ACC, np.float32(-50.0), np.float32(50.0)],
                         {"min_calib_range": -0.01,
                          "max_calib_range": 0.01}),
    "quantized_fully_connected": ([XQ, WQ, BIAS, np.float32(40.0),
                                   np.float32(60.0)], {"num_hidden": 5}),
    "quantized_conv": ([XQC, WQC, BIASC, np.float32(40.0),
                        np.float32(60.0)],
                       {"kernel": (3, 3), "stride": (1, 1),
                        "pad": (1, 1), "num_filter": 4}),
    "quantized_conv_nhwc": ([XQC.transpose(0, 2, 3, 1).copy(), WQC, BIASC,
                             np.float32(40.0), np.float32(60.0)],
                            {"kernel": (3, 3), "stride": (2, 2),
                             "num_filter": 4, "layout": "NHWC"}),
}


@pytest.mark.parametrize("key", sorted(QUANT))
def test_quantization_op_matches_jax(key):
    name = key.replace("_calib", "").replace("_nhwc", "")
    inputs, attrs = QUANT[key]

    def run(mx):
        return _outs(getattr(mx.nd, name)(*[mx.nd.array(x) for x in inputs],
                                          **attrs))

    ref = run(mj)
    with mt.cpu():
        got = run(mt)
    _same(got, ref, key)


def test_int8_products_are_exact_at_the_int32_bound():
    """The float64 accumulation equals the integer one for the largest
    products (K = 4096 taps of 127 * -127)."""
    x = np.full((2, 4096), 127, np.int8)
    w = np.full((3, 4096), -127, np.int8)
    with mt.cpu():
        y = mt.nd.quantized_fully_connected(
            mt.nd.array(x), mt.nd.array(w), None, mt.nd.array(np.float32(1)),
            mt.nd.array(np.float32(1)), no_bias=True)
    assert (y.asnumpy() == np.float32(4096 * 127 * -127)).all()
