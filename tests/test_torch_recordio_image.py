"""``recordio``, ``image`` and the host library of the PyTorch port
against the JAX package, on the CPU.

- RecordIO: a pack written by one package reads in the other byte for
  byte, and both write the same bytes (``.rec`` and ``.idx``).  JPEG
  payloads come from the same libjpeg code through each package's own
  build of ``src/native`` (the port's under ``build/torch_ext/``), so they
  are byte-identical too.
- ``image``: the helpers and every ``*Aug`` under the same
  ``np.random.seed``: float results within 5e-3 on the 0-255 scale, uint8
  within 1 where a float resize precedes the cast, everything else exact.
- The ``raw`` build of the host library (a host without ``<jpeglib.h>``)
  resizes and loads raw npy packs exactly as the JPEG build does, and
  refuses JPEG.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu import image as jimage
from mxnet_tpu import native as jnative
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import MXNetError, native
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import recordio as trec

FLOAT_TOL = 5e-3


def _img(h, w, seed=0, c=3):
    """A smooth uint8 image (gradients and a blob), not noise."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = []
    for k in range(c):
        cy, cx = rs.uniform(0, h), rs.uniform(0, w)
        blob = 120 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                            / (2 * (0.2 * max(h, w)) ** 2))
        chans.append(40 + 80 * xx / w + 40 * yy / h + blob)
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def _pack(mod, dirname, tag, fmt=".jpg"):
    idx = os.path.join(dirname, tag + ".idx")
    rec = os.path.join(dirname, tag + ".rec")
    w = mod.MXIndexedRecordIO(idx, rec, "w")
    for i in range(6):
        label = float(i % 3) if i % 2 else [float(i), 0.5, -1.0]
        img = _img(20 + i, 24, seed=i)
        w.write_idx(i, mod.pack_img(mod.IRHeader(0, label, i, 7), img,
                                    quality=90, img_fmt=fmt))
    w.write_idx(6, mod.pack(mod.IRHeader(0, 2.0, 6, 0), b"raw payload"))
    w.close()
    return idx, rec


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", [".jpg", ".npy"])
def test_both_packages_write_the_same_pack(tmp_path, fmt):
    j = _pack(jrec, str(tmp_path), "j", fmt)
    t = _pack(trec, str(tmp_path), "t", fmt)
    assert _bytes(j[1]) == _bytes(t[1])
    assert _bytes(j[0]) == _bytes(t[0])


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["jax_to_port", "port_to_jax"])
def test_a_pack_reads_across_packages(tmp_path, writer, reader):
    idx, rec = _pack(writer, str(tmp_path), "p")
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    w = writer.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == w.keys == list(range(7))
    for k in reversed(r.keys):
        raw_r, raw_w = r.read_idx(k), w.read_idx(k)
        assert raw_r == raw_w
        hr, pr = reader.unpack(raw_r)
        hw, pw = writer.unpack(raw_w)
        assert (hr.flag, hr.id, hr.id2) == (hw.flag, hw.id, hw.id2)
        np.testing.assert_array_equal(hr.label, hw.label)
        assert pr == pw
        if k < 6:
            (_, ir), (_, iw) = reader.unpack_img(raw_r), writer.unpack_img(
                raw_w)
            np.testing.assert_array_equal(ir, iw)
    seq = reader.MXRecordIO(rec, "r")
    n = 0
    while seq.read() is not None:
        n += 1
    assert n == 7


def test_jpeg_codec_matches_the_jax_build():
    assert native.route() == "jpeg"
    assert native.LIBRARY.parent.name == "torch_ext"
    img = _img(33, 41, seed=3)
    buf = native.encode_jpeg(img, quality=95)
    assert buf == jnative.encode_jpeg(img, quality=95)
    np.testing.assert_array_equal(native.decode_jpeg(buf),
                                  jnative.decode_jpeg(buf))
    np.testing.assert_array_equal(native.resize_bilinear(img, 17, 29),
                                  jnative.resize_bilinear(img, 17, 29))
    for flag in (0, 1):
        got = timage.imdecode(buf, flag=flag)
        assert got.context == mt.cpu()
        np.testing.assert_array_equal(got.asnumpy(),
                                      jimage.imdecode(buf, flag).asnumpy())


def _pair(arr):
    return mj.nd.array(arr, dtype=str(arr.dtype)), \
        mt.nd.array(arr, ctx=mt.cpu(), dtype=str(arr.dtype))


def _close(got, want, exact=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    elif got.dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)


def _same_draws(fn_j, fn_t, seed):
    np.random.seed(seed)
    a = fn_j()
    state = np.random.get_state()
    np.random.seed(seed)
    b = fn_t()
    assert np.random.get_state()[2] == state[2]   # same number of draws
    np.testing.assert_array_equal(np.random.get_state()[1], state[1])
    return a, b


HELPERS = [
    ("imresize_u8", lambda m, x: m.imresize(x, 17, 13), True),
    ("imresize_f32", lambda m, x: m.imresize(x.astype("float32"), 17, 13),
     False),
    ("imresize_f32_up", lambda m, x: m.imresize(x.astype("float32"), 40,
                                                50), False),
    ("resize_short", lambda m, x: m.resize_short(x, 16), True),
    ("center_crop", lambda m, x: m.center_crop(x, (10, 12))[0], True),
    ("random_crop", lambda m, x: m.random_crop(x, (10, 12))[0], True),
    ("fixed_crop", lambda m, x: m.fixed_crop(x, 2, 3, 10, 12, (8, 8)), True),
    ("random_size_crop", lambda m, x: m.random_size_crop(
        x, (16, 16), (0.3, 1.0), (0.75, 1.33))[0], True),
    ("color_normalize", lambda m, x: m.color_normalize(
        x, [120.0, 110.0, 100.0], [50.0, 60.0, 70.0]), True),
    ("copyMakeBorder", lambda m, x: m.copyMakeBorder(x, 1, 2, 3, 4, 0, 9),
     True),
    ("copyMakeBorder_edge", lambda m, x: m.copyMakeBorder(x, 2, 1, 0, 3, 1),
     True),
]


@pytest.mark.parametrize("name,fn,exact", HELPERS,
                         ids=[h[0] for h in HELPERS])
def test_image_helpers_match_jax(name, fn, exact):
    xj, xt = _pair(_img(30, 26, seed=5))
    a, b = _same_draws(lambda: fn(jimage, xj), lambda: fn(timage, xt), 11)
    assert b.context == mt.cpu()
    _close(b.asnumpy(), a.asnumpy(), exact)
    assert timage.scale_down((30, 20), (40, 10)) \
        == jimage.scale_down((30, 20), (40, 10))


EIG = (np.array([55.46, 4.794, 1.148]),
       np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                 [-0.5836, -0.6948, 0.4203]]))
AUGS = [
    ("ResizeAug", lambda m: m.ResizeAug(18), "u8"),
    ("ForceResizeAug", lambda m: m.ForceResizeAug((15, 19)), "u8"),
    ("RandomCropAug", lambda m: m.RandomCropAug((12, 14)), "u8"),
    ("RandomSizedCropAug", lambda m: m.RandomSizedCropAug(
        (16, 16), (0.08, 1.0), (0.75, 1.33)), "u8"),
    ("CenterCropAug", lambda m: m.CenterCropAug(12), "u8"),
    ("BrightnessJitterAug", lambda m: m.BrightnessJitterAug(0.4), "u8"),
    ("ContrastJitterAug", lambda m: m.ContrastJitterAug(0.4), "u8"),
    ("SaturationJitterAug", lambda m: m.SaturationJitterAug(0.4), "u8"),
    ("HueJitterAug", lambda m: m.HueJitterAug(0.3), "u8"),
    ("ColorJitterAug", lambda m: m.ColorJitterAug(0.3, 0.3, 0.3), "f32"),
    ("LightingAug", lambda m: m.LightingAug(0.1, *EIG), "u8"),
    ("ColorNormalizeAug", lambda m: m.ColorNormalizeAug(
        np.array([123.68, 116.28, 103.53]), np.array([58.4, 57.1, 57.4])),
     "f32"),
    ("RandomGrayAug", lambda m: m.RandomGrayAug(0.9), "u8"),
    ("HorizontalFlipAug", lambda m: m.HorizontalFlipAug(0.9), "u8"),
    ("CastAug", lambda m: m.CastAug("float32"), "u8"),
    ("SequentialAug", lambda m: m.SequentialAug(
        [m.CenterCropAug(14), m.HorizontalFlipAug(0.9)]), "u8"),
    ("RandomOrderAug", lambda m: m.RandomOrderAug(
        [m.BrightnessJitterAug(0.2), m.ContrastJitterAug(0.2)]), "f32"),
    ("HSVJitterAug", lambda m: m.HSVJitterAug(0.1, 0.2, 0.2), "f32"),
    ("RandomRotateAug", lambda m: m.RandomRotateAug((-30, 30)), "f32"),
]


@pytest.mark.parametrize("name,make,dtype", AUGS, ids=[a[0] for a in AUGS])
def test_augmenters_match_jax(name, make, dtype):
    arr = _img(22, 20, seed=7)
    if dtype == "f32":
        arr = arr.astype(np.float32)
    xj, xt = _pair(arr)
    augj, augt = make(jimage), make(timage)
    assert augt.dumps() == augj.dumps()
    for seed in (1, 2, 3):
        a, b = _same_draws(lambda: augj(xj), lambda: augt(xt), seed)
        assert b.context == mt.cpu()
        _close(b.asnumpy(), a.asnumpy(), exact=name in (
            "RandomCropAug", "CenterCropAug", "HorizontalFlipAug",
            "CastAug", "SequentialAug", "ContrastJitterAug",
            "SaturationJitterAug", "HueJitterAug", "RandomGrayAug",
            "ResizeAug", "ForceResizeAug", "RandomSizedCropAug"))


def test_create_augmenter_matches_jax():
    kw = dict(resize=20, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.2, contrast=0.2, saturation=0.2,
              hue=0.1, pca_noise=0.05, rand_gray=0.2)
    augj = jimage.CreateAugmenter((3, 16, 16), **kw)
    augt = timage.CreateAugmenter((3, 16, 16), **kw)
    assert [type(a).__name__ for a in augt] \
        == [type(a).__name__ for a in augj]
    xj, xt = _pair(_img(24, 28, seed=9))

    def run(augs, x):
        for a in augs:
            x = a(x)
        return x

    for seed in (4, 5):
        a, b = _same_draws(lambda: run(augj, xj), lambda: run(augt, xt),
                           seed)
        _close(b.asnumpy(), a.asnumpy())


@pytest.mark.parametrize("zoom", ["none", "in", "out"])
def test_imrotate_matches_jax(zoom):
    arr = _img(14, 18, seed=2).astype(np.float32).transpose(2, 0, 1)
    kw = {"zoom_in": zoom == "in", "zoom_out": zoom == "out"}
    xj, xt = _pair(np.stack([arr, arr[:, ::-1].copy()]))
    _close(timage.imrotate(xt, 25.0 if zoom == "none" else [25.0, -40.0],
                           **kw).asnumpy() if zoom != "none" else
           timage.imrotate(xt[0], 25.0, **kw).asnumpy(),
           jimage.imrotate(xj, mj.nd.array([25.0, -40.0]), **kw).asnumpy()
           if zoom != "none" else
           jimage.imrotate(xj[0], 25.0, **kw).asnumpy())


def test_image_iter_over_a_pack(tmp_path):
    idx, rec = _pack(trec, str(tmp_path), "it", ".npy")
    del idx
    lst = [(i, _img(20 + i, 24, seed=i)) for i in range(6)]
    w = trec.MXIndexedRecordIO(str(tmp_path / "ii.idx"),
                               str(tmp_path / "ii.rec"), "w")
    for i, img in lst:
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i), i, 0), img))
    w.close()
    kw = dict(batch_size=3, data_shape=(3, 16, 16),
              path_imgrec=str(tmp_path / "ii.rec"), preprocess_threads=1)
    with mt.cpu():
        got = [b.data[0].asnumpy() for b in timage.ImageIter(**kw)]
    # copied as they arrive: the JAX batches can alias the loader's buffer
    want = [np.array(b.data[0].asnumpy()) for b in jimage.ImageIter(**kw)]
    assert len(got) == len(want) == 2
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


@pytest.fixture(scope="module")
def raw_library(tmp_path_factory):
    path = tmp_path_factory.mktemp("raw") / "libraw.so"
    import ctypes

    lib = ctypes.CDLL(str(native.build(path=path, jpeg=False, force=True)))
    native._declare(lib)
    return lib


def test_raw_build_resizes_and_loads_as_the_jpeg_build(raw_library,
                                                        monkeypatch,
                                                        tmp_path):
    assert not hasattr(raw_library, "MXTEncodeJPEG")
    img = _img(31, 27, seed=4)
    want_resize = native.resize_bilinear(img, 20, 17)
    _, rec = _pack(trec, str(tmp_path), "n", ".npy")
    kw = dict(batch_size=4, data_shape=(3, 16, 16), label_width=3,
              num_workers=1, rand_crop=True, rand_mirror=True, seed=5,
              mean=(10.0, 20.0, 30.0), scale=0.5)
    jpeg_loader = native.ImageRecordLoader(rec, **kw)
    want = [(d.copy(), l.copy(), n) for d, l, n in iter(
        jpeg_loader.next, None)]
    monkeypatch.setattr(native, "_LIB", raw_library)
    assert native.route() == "raw"
    np.testing.assert_array_equal(native.resize_bilinear(img, 20, 17),
                                  want_resize)
    raw_loader = native.ImageRecordLoader(rec, **kw)
    got = [(d.copy(), l.copy(), n) for d, l, n in iter(raw_loader.next,
                                                       None)]
    assert [n for *_, n in got] == [n for *_, n in want] == [4, 3]
    for (gd, gl, _), (wd, wl, _) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    _, jrec_path = _pack(jrec, str(tmp_path), "jp", ".jpg")
    with pytest.raises(MXNetError, match="without libjpeg"):
        native.ImageRecordLoader(jrec_path, **kw)
    with pytest.raises(MXNetError, match="without libjpeg"):
        trec.pack_img(trec.IRHeader(0, 1.0, 0, 0), img)
    with pytest.raises(MXNetError, match="without libjpeg"):
        native.decode_jpeg(b"\xff\xd8")


def test_a_build_that_fails_raises_with_the_compiler_message(tmp_path,
                                                             monkeypatch):
    bad = tmp_path / "src"
    bad.mkdir()
    (bad / "broken.cc").write_text("int f( {\n")
    monkeypatch.setattr(native, "SRC_DIR", bad)
    with pytest.raises(MXNetError, match="did not build.*broken.cc"):
        native.build(path=tmp_path / "x.so", jpeg=True, force=True)


def test_loader_refuses_an_output_it_cannot_fill(tmp_path):
    _, rec = _pack(trec, str(tmp_path), "o", ".npy")
    loader = native.ImageRecordLoader(rec, batch_size=2,
                                      data_shape=(3, 8, 8))
    for data, label in ((np.empty((2, 3, 8, 7), np.float32), None),
                        (np.empty((2, 3, 8, 8), np.float64), None),
                        (None, np.empty((2, 2), np.float32)),
                        (np.empty((2, 3, 8, 16), np.float32)[..., ::2],
                         None)):
        with pytest.raises(MXNetError, match="C-contiguous float32"):
            loader.next(data, label)
    out = np.empty((2, 3, 8, 8), np.float32)
    got = loader.next(out, None)
    assert got[0] is out and got[2] == 2


def test_native_record_io_frames_as_recordio(tmp_path):
    """The host library's writer and reader use ``recordio``'s framing:
    each reads what the other (and the JAX package) writes."""
    bufs = [b"a", b"abc", b"abcd", b"x" * 70001]
    w = native.RecordWriter(tmp_path / "n.rec")
    offsets = []
    for b in bufs:
        offsets.append(w.tell())
        w.write(b)
    w.close()
    r = jrec.MXRecordIO(str(tmp_path / "n.rec"), "r")
    assert [r.read() for _ in bufs] == bufs and r.read() is None
    p = trec.MXRecordIO(str(tmp_path / "p.rec"), "w")
    for b in bufs:
        p.write(b)
    p.close()
    assert _bytes(tmp_path / "p.rec") == _bytes(tmp_path / "n.rec")
    nr = native.RecordReader(tmp_path / "p.rec")
    assert [nr.read() for _ in bufs] == bufs and nr.read() is None
    assert nr.read_at(offsets[3]) == bufs[3]
    nr.seek(offsets[2])
    assert nr.read() == bufs[2]
    nr.close()
