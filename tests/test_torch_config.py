"""``mx.config`` and ``mx.get_env``: the registry of the ``MXNET_*``
variables the port reads, held to the port's sources both ways (every
``get_env("MXNET_...")`` read in ``mxnet_tpu_torch/`` is registered with
the type and default it is read with, and every registered variable is
read somewhere), with ``describe``, ``current`` and ``check_unknown``
against the JAX package's."""
import re
from pathlib import Path

import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

PKG = Path(__file__).resolve().parents[1] / "mxnet_tpu_torch"
_READ = re.compile(r"get_env\(\s*[\"'](MXNET_[A-Z0-9_]+)[\"']\s*,\s*"
                   r"(\w+)\s*,\s*([^)\n]+?)\s*\)", re.S)
_ENVIRON = re.compile(r"os\.environ(?:\.get)?[\[(]\s*[\"'](MXNET_\w+)")


def _reads():
    """{name: [(type name, default source)]} of every read in the
    port's sources."""
    out = {}
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        for name, typ, default in _READ.findall(text):
            out.setdefault(name, []).append((typ, default.strip()))
        for name in _ENVIRON.findall(text):
            out.setdefault(name, []).append(("environ", None))
    return out


def test_every_read_is_registered_with_its_type_and_default():
    reads = _reads()
    assert reads, "no get_env read found"
    for name, uses in reads.items():
        assert name in mt.config.ENV_VARS, name
        typ, default, doc = mt.config.ENV_VARS[name]
        for t, d in uses:
            assert t != "environ", "%s read around get_env" % name
            assert t == typ.__name__, (name, t, typ)
            assert eval(d, {}) == default, (name, d, default)  # noqa: S307
        assert doc and "jax" not in doc.lower() and "xla" not in doc.lower()


def test_every_registered_variable_is_read():
    assert sorted(set(mt.config.ENV_VARS) - set(_reads())) == []


def test_describe_current_and_check_unknown(monkeypatch):
    for mx in (mj, mt):
        table = mx.config.describe().splitlines()
        assert table[0].split()[:2] == ["Variable", "Type"]
        assert len(table) == len(mx.config.ENV_VARS) + 1
    monkeypatch.setenv("MXNET_MULTI_TENSOR", "0")
    monkeypatch.setenv("MXNET_TRACE_RING_EVENTS", "64")
    monkeypatch.setenv("MXNET_NOT_A_KNOB", "1")
    cur = mt.config.current()
    assert cur["MXNET_MULTI_TENSOR"] is False
    assert cur["MXNET_TRACE_RING_EVENTS"] == 64
    assert cur["MXNET_SERVE_DECODE_PAGE_SIZE"] == 16
    with pytest.warns(UserWarning, match="MXNET_NOT_A_KNOB"):
        unknown = mt.config.check_unknown()
    assert "MXNET_NOT_A_KNOB" in unknown
    assert "MXNET_MULTI_TENSOR" not in unknown
    assert mt.config.check_unknown(warn=False) == unknown
    # the names both packages read mean the same in both
    shared = set(mt.config.ENV_VARS) & set(mj.config.ENV_VARS)
    assert {"MXNET_MULTI_TENSOR", "MXNET_TRACE_RING_EVENTS"} <= shared
    for name in shared:
        assert mt.config.ENV_VARS[name][0] is mj.config.ENV_VARS[name][0]


def test_get_env_at_the_root_reads_as_the_jax_one(monkeypatch):
    monkeypatch.setenv("MXNET_X_TEST", "off")
    for mx in (mj, mt):
        assert mx.get_env("MXNET_X_TEST", bool, True) is False
        assert mx.get_env("MXNET_X_ABSENT", int, 3) == 3
    monkeypatch.setenv("MXNET_X_TEST", "12")
    assert mt.get_env("MXNET_X_TEST", int) == mj.get_env("MXNET_X_TEST",
                                                         int) == 12
