"""The port's BERT (``mxnet_tpu_torch.gluon.model_zoo.bert``) against the
JAX package's, on the CPU, with weights carried by
``convert.load_jax_params``.

A 2-layer BERT (units 64, 4 heads, hidden 128, vocab 100).  At T=256 both
sides take the flash path (JAX reaches the Pallas kernel in interpret
mode, the port the kernel's plain version); at T=64 both take the dense
path.  ``seq`` and ``pooled`` agree within atol 1e-4 (fp32 on both sides;
summation order differs).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu_torch import MXNetError, convert
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.ops import flash_attention as fa

CFG = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=256)
ATOL = 1e-4


def _jax_bert(seed=0):
    net = jbert.BERTModel(**CFG)
    net.initialize()
    rs = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        val = rs.randn(*p.shape).astype(np.float32) * 0.1
        if name.endswith(".gamma"):
            val += 1.0
        p.set_data(jmx.nd.array(val))
    return net


def _jax_params(net):
    return {k: v.data().asnumpy() for k, v in net.collect_params().items()}


@pytest.fixture(scope="module")
def nets():
    jnet = _jax_bert()
    tnet = tbert.BERTModel(**CFG)
    convert.load_jax_params(tnet, _jax_params(jnet))
    return jnet, tnet


def _count_calls(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("T,flash", [(256, True), (64, False)])
def test_bert_matches_jax(nets, monkeypatch, T, flash):
    jnet, tnet = nets
    rs = np.random.RandomState(T)
    ids = rs.randint(0, CFG["vocab_size"], (2, T)).astype(np.int32)
    types = (np.arange(T)[None, :] >= rs.randint(1, T, (2, 1))) \
        .astype(np.int32)
    jax_calls = _count_calls(monkeypatch, pa, "flash_attention")
    port_calls = _count_calls(monkeypatch, fa, "flash_attention")

    want_seq, want_pooled = jnet(jmx.nd.array(ids, dtype="int32"),
                                 jmx.nd.array(types, dtype="int32"))
    with torch.inference_mode():
        seq, pooled = tnet(torch.from_numpy(ids), torch.from_numpy(types))

    n = CFG["num_layers"] if flash else 0
    assert len(jax_calls) == n and len(port_calls) == n
    np.testing.assert_allclose(seq.numpy(), want_seq.asnumpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), want_pooled.asnumpy(),
                               rtol=0, atol=ATOL)


def test_param_names_match_jax(nets):
    jnet, tnet = nets
    assert list(tnet.collect_params()) == list(jnet.collect_params())


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_jax_params_is_strict(nets, fault):
    jnet, _ = nets
    params = _jax_params(jnet)
    name = "encoder.layers.1.ffn.ffn_1.weight"
    if fault == "missing":
        del params[name]
    elif fault == "extra":
        params["encoder.layers.2.ffn.ffn_1.weight"] = params[name]
    else:
        params[name] = params[name].T
    tnet = tbert.BERTModel(**CFG)
    before = {k: v.clone() for k, v in tnet.collect_params().items()}
    with pytest.raises(MXNetError, match=name.replace(".1.", ".[12].")):
        convert.load_jax_params(tnet, params)
    for k, v in tnet.collect_params().items():   # nothing was written
        assert torch.equal(v, before[k])
