"""A 2-layer, 64-unit BERT pretraining step captured by the port's
``mx.step`` (on the CPU: the step function run eagerly) against the JAX
package's stitched steps (``autograd.record``, ``backward``,
``Trainer.step``), on the same numpy weights and batch.

Dropout 0 and T=32, so both sides take the dense attention path; SGD
with momentum for 3 steps.  The losses agree within 1e-5 relative and
the weights within 1e-5 x max(1, max|w|): the same float32 math in
another summation order.  The JAX block is hybridized (one traced
program) behind a wrapper whose call takes no ``None`` argument
(``ROADMAP.md`` Queue 3 item 3).
"""
import numpy as np
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

TOL = 1e-5


def _close(got, want, what, tol=TOL):
    got = got.detach().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, "%s: %g" % (what, err)


CFG = dict(vocab_size=60, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=32)


def _bert_batch():
    rs = np.random.RandomState(3)
    B, T, M = 2, 32, 6
    return ((rs.randint(0, 60, (B, T)).astype(np.int32),
             (np.arange(T)[None] >= 16).repeat(B, 0).astype(np.int32),
             np.stack([rs.choice(T, M, replace=False) for _ in range(B)])
             .astype(np.int32)),
            (rs.randint(0, 60, (B, M)).astype(np.int32),
             np.ones((B, M), np.float32),
             rs.randint(0, 2, (B,)).astype(np.int32)))


class _Pretrain(gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.model = tbert.BERTForPretraining(dropout=0.0, **CFG)

    def forward(self, ids, types, pos):
        return self.model(ids, types, None, pos)


class _JaxPretrain(jgluon.HybridBlock):
    """The same wrapper on the JAX side: hybridized, its one traced
    program takes no ``None`` argument."""

    def __init__(self):
        super().__init__()
        self.model = jbert.BERTForPretraining(dropout=0.0, **CFG)

    def forward(self, ids, types, pos):
        return self.model(ids, types, None, pos)


def test_bert_captured_matches_jax_stitched():
    jnet = _JaxPretrain()
    jnet.initialize()
    rs = np.random.RandomState(0)
    init = {}
    for k, p in jnet.collect_params().items():
        v = rs.randn(*p.shape).astype(np.float32) * 0.1
        init[k] = v + 1.0 if k.endswith("gamma") else v
        p.set_data(jmx.nd.array(init[k]))
    jnet.hybridize()
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    (ids, types, pos), (lab, w, nsp) = _bert_batch()
    a = [jmx.nd.array(v, dtype=str(v.dtype))
         for v in (ids, types, pos, lab, w, nsp)]
    jl = []
    for _ in range(3):
        with jautograd.record():
            mlm, nspo = jnet(a[0], a[1], a[2])
            loss = jbert.pretraining_loss(mlm, nspo, a[3], a[4], a[5])
        loss.backward()
        jtr.step(1)
        jl.append(float(loss.asnumpy()))

    net = _Pretrain()
    net.initialize(ctx=mx.cpu())
    mx.convert.load_jax_params(net, init)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(opt))

    def loss_fn(out, lab, w, nsp):
        return tbert.pretraining_loss(out[0], out[1], lab, w, nsp)

    prog = trainer.capture(net, loss_fn)
    x = tuple(torch.from_numpy(v) for v in (ids, types, pos))
    y = tuple(torch.from_numpy(v) for v in (lab, w, nsp))
    tl = [prog(x, y, batch_size=1).item() for _ in range(3)]
    assert prog.report()["paths"] == {"captured": 3, "stitched": 0}
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=0)
    jp = jnet.collect_params()
    for k, p in net.collect_params().items():
        _close(p, jp[k].data().asnumpy(), k)
