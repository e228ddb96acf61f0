"""The port's ``gluon.loss``, ``gluon.metric``, ``gluon.utils`` and the rest
of ``initializer`` against the JAX package's, on the CPU.

- Every ported loss, with and without ``sample_weight`` where it takes
  one, on the same numpy inputs: within 1e-5 x max(1, max|ref|).
- Every metric, fed the same numpy labels and predictions (the port's as
  tensors): the same ``get()`` to 1e-6 relative.
- ``split_data`` / ``split_and_load`` (slices, the uneven last slice, the
  raise) and ``clip_global_norm`` (the norm it returns and the arrays it
  scales) to 1e-6.
- Deterministic initializers exactly: ``Bilinear``, ``LSTMBias``,
  ``Constant`` and ``Mixed``'s routing by name; random ones by shape and,
  on a 256x256 array, their variance within 5 % of the JAX package's
  (``Orthogonal``: rows orthonormal times the scale).
"""
import hashlib
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import initializer as jinit
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import metric as jmetric
from mxnet_tpu.gluon import utils as jutils
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, initializer as tinit
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import metric as tmetric
from mxnet_tpu_torch.gluon import utils as tutils

RS = np.random.RandomState(0)
PRED = RS.randn(6, 5).astype(np.float32)
LABEL = RS.randn(6, 5).astype(np.float32)
SIGNED = np.sign(RS.randn(6, 5)).astype(np.float32)
PROB = RS.rand(6, 5).astype(np.float32) * 0.9 + 0.05
BINARY = (RS.rand(6, 5) > 0.5).astype(np.float32)
CLASSES = RS.randint(0, 5, 6).astype(np.float32)
DIST = np.abs(RS.randn(6, 5)).astype(np.float32)
DIST /= DIST.sum(-1, keepdims=True)
COUNT = RS.poisson(2.0, (6, 5)).astype(np.float32)
PAIR_LABEL = np.array([1, -1, 1, 1, -1, -1], np.float32)
SW = RS.rand(6, 1).astype(np.float32)

# name: (class name, ctor kwargs, inputs, takes sample_weight)
LOSSES = {
    "l2": ("L2Loss", {}, (PRED, LABEL), True),
    "l1": ("L1Loss", {}, (PRED, LABEL), True),
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {}, (PRED, BINARY),
                    True),
    "sigmoid_bce_from_sigmoid": ("SigmoidBCELoss", {"from_sigmoid": True},
                                 (PROB, BINARY), True),
    "softmax_ce": ("SoftmaxCrossEntropyLoss", {}, (PRED, CLASSES), False),
    "softmax_ce_dense": ("SoftmaxCELoss", {"sparse_label": False},
                         (PRED, DIST), False),
    "softmax_ce_weight": ("SoftmaxCrossEntropyLoss", {"weight": 0.5},
                          (PRED, CLASSES), False),
    "kl_div": ("KLDivLoss", {"from_logits": False}, (PRED, DIST), True),
    "huber": ("HuberLoss", {"rho": 0.7}, (PRED, LABEL), True),
    "hinge": ("HingeLoss", {}, (PRED, SIGNED), True),
    "squared_hinge": ("SquaredHingeLoss", {"margin": 0.5}, (PRED, SIGNED),
                      True),
    "logistic": ("LogisticLoss", {}, (PRED, SIGNED), True),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                        (PRED, BINARY), True),
    "triplet": ("TripletLoss", {"margin": 0.3}, (PRED, LABEL, PROB), False),
    "triplet_sw": ("TripletLoss", {"margin": 0.3},
                   (PRED, LABEL, PROB, SW[:, 0]), False),
    "poisson_nll": ("PoissonNLLLoss", {}, (PRED, COUNT), False),
    "poisson_nll_full": ("PoissonNLLLoss", {"from_logits": False,
                                            "compute_full": True},
                         (PROB * 3, COUNT), False),
    "cosine_embedding": ("CosineEmbeddingLoss", {"margin": 0.1},
                         (PRED, LABEL, PAIR_LABEL), False),
    "cosine_embedding_sw": ("CosineEmbeddingLoss", {"margin": 0.1},
                            (PRED, LABEL, PAIR_LABEL, SW[:, 0]), False),
    "sdml": ("SDMLLoss", {}, (PRED, LABEL), False),
}


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=tol * max(1.0, float(np.abs(want).max())))


CASES = [(c, False) for c in sorted(LOSSES)] + [
    (c, True) for c in sorted(LOSSES) if LOSSES[c][3]]


@pytest.mark.parametrize("case,weighted", CASES,
                         ids=["%s-%s" % (c, "sw" if w else "plain")
                              for c, w in CASES])
def test_loss_matches_jax(case, weighted):
    cls, kw, inputs, _ = LOSSES[case]
    args = inputs + ((SW,) if weighted else ())
    want = getattr(jloss, cls)(**kw)(
        *[jmx.nd.array(a) for a in args]).asnumpy()
    got = getattr(tloss, cls)(**kw)(*[torch.from_numpy(a) for a in args])
    assert tuple(got.shape) == want.shape
    _close(got.numpy(), want)


def test_ctc_loss_is_not_ported():
    """The name stays from when ``CTCLoss`` was missing; the loss is
    ported now, and on a small NTC case it gives the JAX loss's numbers
    (``test_torch_ctc.py`` holds the rest)."""
    pred = RS.randn(2, 6, 5).astype(np.float32)
    label = np.array([[1, 2, -1], [3, 3, 4]], np.float32)
    want = jloss.CTCLoss()(jmx.nd.array(pred),
                           jmx.nd.array(label)).asnumpy()
    got = tloss.CTCLoss()(torch.from_numpy(pred), torch.from_numpy(label))
    _close(got.numpy(), want)


# metric name: (ctor kwargs, labels, preds)
METRICS = {
    "Accuracy": ({}, CLASSES, PRED),
    "TopKAccuracy": ({"top_k": 2}, CLASSES, PRED),
    "BinaryAccuracy": ({"threshold": 0.4}, BINARY, PROB),
    "F1": ({}, BINARY[:, 0], PRED[:, :2]),
    "Fbeta": ({"beta": 2}, BINARY[:, 0], PRED[:, :2]),
    "MCC": ({}, BINARY[:, 1], PROB[:, 1]),
    "MAE": ({}, LABEL, PRED),
    "MSE": ({}, LABEL, PRED),
    "RMSE": ({}, LABEL, PRED),
    "CrossEntropy": ({}, CLASSES, DIST),
    "Perplexity": ({"ignore_label": 2}, CLASSES, DIST),
    "NegativeLogLikelihood": ({}, CLASSES, DIST),
    "PearsonCorrelation": ({}, LABEL, PRED),
    "PCC": ({}, CLASSES, PRED),
    "Loss": ({}, None, PROB),
    "MeanPairwiseDistance": ({"p": 3}, LABEL, PRED),
    "MeanCosineSimilarity": ({}, LABEL, PRED),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name):
    kw, labels, preds = METRICS[name]
    jm, tm = getattr(jmetric, name)(**kw), getattr(tmetric, name)(**kw)
    for half in (slice(0, 3), slice(3, 6)):
        lab = None if labels is None else labels[half]
        jm.update(None if lab is None else [jmx.nd.array(lab)],
                  [jmx.nd.array(preds[half])])
        tm.update(None if lab is None else [torch.from_numpy(lab)],
                  [torch.from_numpy(preds[half])])
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    tm.reset()
    assert tm.num_inst == 0


def test_metric_registry_and_composite():
    comp = tmetric.create(["accuracy", "topkaccuracy"])
    assert isinstance(comp, tmetric.CompositeEvalMetric)
    comp.update([torch.from_numpy(CLASSES)], [torch.from_numpy(PRED)])
    jcomp = jmetric.create(["accuracy", "topkaccuracy"])
    jcomp.update([jmx.nd.array(CLASSES)], [jmx.nd.array(PRED)])
    assert comp.get() == jcomp.get()
    custom = tmetric.np(lambda l, p: float(np.abs(l - p).sum()))
    custom.update([LABEL], [PRED])
    assert custom.get()[1] == pytest.approx(float(np.abs(LABEL - PRED).sum()))
    with pytest.raises(MXNetError):
        tmetric.create("no_such_metric")
    bf16 = tmetric.MAE()
    bf16.update([torch.from_numpy(LABEL)],
                [torch.from_numpy(PRED).to(torch.bfloat16)])
    assert np.isfinite(bf16.get()[1])


@pytest.mark.parametrize("num,even", [(2, True), (4, False)],
                         ids=["even", "uneven"])
def test_split_and_load_matches_jax(num, even):
    data = RS.randn(6, 3).astype(np.float32)
    want = [s.asnumpy() for s in jutils.split_data(
        jmx.nd.array(data), num, even_split=even)]
    got = tutils.split_data(torch.from_numpy(data), num, even_split=even)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    loaded = tutils.split_and_load(data, [mx.cpu()] * num, even_split=even)
    assert [tuple(t.shape) for t in loaded] == [w.shape for w in want]
    assert all(t.device.type == "cpu" for t in loaded)
    whole = tutils.split_and_load(data, [mx.cpu()])
    np.testing.assert_array_equal(whole[0].numpy(), data)


def test_split_data_refuses_an_uneven_even_split():
    with pytest.raises(MXNetError, match="evenly"):
        tutils.split_data(torch.zeros(5, 2), 2)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "keeps"])
def test_clip_global_norm_matches_jax(max_norm):
    arrays = [RS.randn(4, 3).astype(np.float32),
              RS.randn(5).astype(np.float32)]
    jarr = [jmx.nd.array(a) for a in arrays]
    tarr = [torch.from_numpy(a.copy()) for a in arrays]
    jn = jutils.clip_global_norm(jarr, max_norm)
    tn = tutils.clip_global_norm(tarr, max_norm)
    assert tn == pytest.approx(jn, rel=1e-6)
    for t, j in zip(tarr, jarr):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=1e-6)
    with pytest.warns(UserWarning, match="nan or inf"):
        tutils.clip_global_norm([torch.tensor([float("inf")])], 1.0)


def test_check_sha1(tmp_path):
    path = tmp_path / "blob"
    path.write_bytes(b"mxnet" * 1000)
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert tutils.check_sha1(str(path), digest)
    assert jutils.check_sha1(str(path), digest)
    assert not tutils.check_sha1(str(path), "0" * 40)


def _jax_fill(init, name, shape):
    arr = jmx.nd.zeros(shape)
    init(jinit.InitDesc(name), arr)
    return arr.asnumpy()


def _port_fill(init, name, shape):
    arr = torch.zeros(shape)
    init(tinit.InitDesc(name), arr)
    return arr.numpy()


@pytest.mark.parametrize("case", ["bilinear", "lstm_bias", "constant",
                                  "bias_rule", "running_var_rule"])
def test_deterministic_initializers_match_exactly(case):
    name, shape, make = {
        "bilinear": ("weight", (2, 3, 4, 5), lambda m: m.Bilinear()),
        "lstm_bias": ("weight", (16,), lambda m: m.LSTMBias(2.5)),
        "constant": ("weight", (3, 4), lambda m: m.Constant(0.25)),
        "bias_rule": ("bias", (3, 4), lambda m: m.Uniform()),
        "running_var_rule": ("running_var", (7,), lambda m: m.Xavier()),
    }[case]
    np.testing.assert_array_equal(_port_fill(make(tinit), name, shape),
                                  _jax_fill(make(jinit), name, shape))


def test_mixed_routes_by_name_as_jax():
    def make(m):
        return m.Mixed([".*bias", "conv.*weight", ".*"],
                       [m.Constant(3.0), m.One(), m.Constant(-1.0)])

    for name in ("fc_bias", "conv1_weight", "dense_weight", "gamma"):
        np.testing.assert_array_equal(
            _port_fill(make(tinit), name, (2, 3)),
            _jax_fill(make(jinit), name, (2, 3)), err_msg=name)
    with pytest.raises(MXNetError, match="no initializer pattern"):
        tinit.Mixed(["x"], [tinit.One()])("weight", torch.zeros(2))


@pytest.mark.parametrize("case", ["uniform", "normal", "xavier_avg",
                                  "xavier_gaussian_in", "msra", "orthogonal"])
def test_random_initializers_match_jax_in_shape_and_variance(case):
    make = {
        "uniform": lambda m: m.Uniform(0.2),
        "normal": lambda m: m.Normal(0.3),
        "xavier_avg": lambda m: m.Xavier(),
        "xavier_gaussian_in": lambda m: m.Xavier("gaussian", "in", 2),
        "msra": lambda m: m.MSRAPrelu(),
        "orthogonal": lambda m: m.Orthogonal(),
    }[case]
    shape = (256, 64, 2, 2)
    mx.random.seed(1)
    got = _port_fill(make(tinit), "weight", shape)
    want = _jax_fill(make(jinit), "weight", shape)
    assert got.shape == want.shape
    assert abs(got.mean()) < 0.05 * math.sqrt(want.var()) * 10
    np.testing.assert_allclose(got.var(), want.var(), rtol=0.05)
    if case == "orthogonal":
        flat = got.reshape(shape[0], -1) / 1.414
        np.testing.assert_allclose(flat @ flat.T, np.eye(shape[0]),
                                   atol=1e-4)
    assert tinit.create("msra").__class__ is tinit.MSRAPrelu
