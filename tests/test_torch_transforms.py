"""``gluon.data.vision.transforms`` of the PyTorch port against the JAX
package, on the CPU, under the same ``np.random.seed``.

Every transform takes the same HWC image (uint8 or float32) as an NDArray
in both packages and must give the same result: float within 5e-3 on the
0-255 scale, uint8 within 1 where a float resize or a float reduction
precedes the cast (``Resize``, ``RandomResizedCrop``, ``CropResize``'s
float route, ``RandomContrast``, ``RandomSaturation``), everything else
exact (``HybridCompose`` is float: the JAX package compiles its group, and
the fused division differs from the eager one in the last bit); and both
must draw as many numbers from numpy's generator.  ``Compose`` is a
``Sequential`` in both (``len``, indexing).
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon.data.vision import transforms as jT
from mxnet_tpu.gluon.nn import Sequential as JSequential
from mxnet_tpu_torch.gluon.data.vision import transforms as tT
from mxnet_tpu_torch.gluon.nn import Sequential as TSequential

FLOAT_TOL = 5e-3


def _img(h, w, seed=0):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = [30 + 150 * (xx / w) ** (k + 1) + 60 * yy / h
             + 10 * rs.rand(h, w) for k in range(3)]
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


CASES = [
    ("Cast", lambda T: T.Cast("float16"), "u8", True),
    ("ToTensor", lambda T: T.ToTensor(), "u8", True),
    ("Normalize", lambda T: T.Compose([T.ToTensor(), T.Normalize(
        (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))]), "u8", True),
    ("Resize", lambda T: T.Resize((17, 13)), "u8", False),
    ("Resize_f32", lambda T: T.Resize(16), "f32", False),
    ("CenterCrop", lambda T: T.CenterCrop((12, 10)), "u8", True),
    ("RandomResizedCrop", lambda T: T.RandomResizedCrop(16), "u8", False),
    ("RandomFlipLeftRight", lambda T: T.RandomFlipLeftRight(), "u8", True),
    ("RandomFlipTopBottom", lambda T: T.RandomFlipTopBottom(), "u8", True),
    ("RandomBrightness", lambda T: T.RandomBrightness(0.4), "u8", True),
    ("RandomContrast", lambda T: T.RandomContrast(0.4), "u8", False),
    ("RandomSaturation", lambda T: T.RandomSaturation(0.4), "u8", False),
    ("RandomLighting", lambda T: T.RandomLighting(0.2), "u8", True),
    ("RandomColorJitter", lambda T: T.RandomColorJitter(0.3, 0.3, 0.3),
     "u8", False),
    ("RandomCrop", lambda T: T.RandomCrop((12, 10)), "u8", True),
    ("RandomCrop_pad", lambda T: T.RandomCrop(24, pad=2, pad_value=7),
     "u8", True),
    ("RandomHue", lambda T: T.RandomHue(0.2), "f32", True),
    ("RandomGray", lambda T: T.RandomGray(0.8), "f32", True),
    ("Rotate", lambda T: T.Rotate(30.0), "u8", True),
    ("Rotate_zoom_out", lambda T: T.Rotate(-20.0, zoom_out=True), "u8",
     True),
    ("RandomRotation", lambda T: T.RandomRotation((-45, 45),
                                                  zoom_in=True), "u8", True),
    ("CropResize", lambda T: T.CropResize(2, 3, 12, 10, size=8), "u8",
     True),
    ("CropResize_f32", lambda T: T.CropResize(2, 3, 12, 10, size=(9, 7)),
     "f32", False),
    ("RandomApply", lambda T: T.RandomApply(T.RandomBrightness(0.3), 0.6),
     "u8", True),
    ("HybridRandomApply", lambda T: T.HybridRandomApply(
        T.Cast("float32"), 0.5), "u8", True),
    ("Compose", lambda T: T.Compose([T.RandomResizedCrop(14),
                                     T.RandomFlipLeftRight(),
                                     T.ToTensor()]), "u8", False),
    ("HybridCompose", lambda T: T.HybridCompose([
        T.Cast("float32"), T.ToTensor(), T.Normalize(0.5, 0.25),
        T.CropResize(0, 0, 3, 2)]), "u8", False),
]


def _close(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    elif got.dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        scale = 255.0 if np.abs(want).max() > 2 else 1.0
        np.testing.assert_allclose(got / scale * 255.0, want / scale * 255.0,
                                   rtol=0, atol=FLOAT_TOL)


@pytest.mark.parametrize("name,make,dtype,exact", CASES,
                         ids=[c[0] for c in CASES])
def test_transform_matches_jax(name, make, dtype, exact):
    arr = _img(20, 22, seed=len(name))
    if dtype == "f32":
        arr = arr.astype(np.float32)
    tj, tt = make(jT), make(tT)
    xj = mj.nd.array(arr, dtype=str(arr.dtype))
    xt = mt.nd.array(arr, ctx=mt.cpu(), dtype=str(arr.dtype))
    for seed in (0, 1, 2, 3):
        np.random.seed(seed)
        a = tj(xj)
        state = np.random.get_state()
        np.random.seed(seed)
        b = tt(xt)
        np.testing.assert_array_equal(np.random.get_state()[1], state[1])
        assert np.random.get_state()[2] == state[2]
        assert isinstance(b, mt.nd.NDArray) and b.context == mt.cpu()
        _close(b.asnumpy(), a.asnumpy(), exact)


def test_compose_is_a_sequential_in_both():
    for T, Seq in ((jT, JSequential), (tT, TSequential)):
        c = T.Compose([T.ToTensor(), T.Normalize(0.5, 0.5), T.Cast()])
        assert isinstance(c, Seq) and len(c) == 3
        assert isinstance(c[1], T.Normalize) and c[-1] is list(c)[-1]
    x = _img(8, 6)
    np.testing.assert_array_equal(
        tT.Compose([tT.ToTensor()])[0](mt.nd.array(x, ctx=mt.cpu(),
                                                   dtype="uint8")).asnumpy(),
        jT.Compose([jT.ToTensor()])[0](mj.nd.array(x,
                                                   dtype="uint8")).asnumpy())


def test_totensor_of_a_batch_matches_jax():
    batch = np.stack([_img(6, 5, seed=s) for s in range(3)])
    got = tT.ToTensor()(mt.nd.array(batch, ctx=mt.cpu(), dtype="uint8"))
    want = jT.ToTensor()(mj.nd.array(batch, dtype="uint8"))
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
