"""``mx.autotune`` of the port against the JAX package's, on the CPU.

- ``key_hash`` of a key is the JAX package's, so one key names one record.
- The table ``CostModel`` predicts the JAX package's numbers on the same
  audit records (within 1e-12 relative).
- The store cases of ``tests/python/unittest/test_autotune.py``, on the
  port's own sites: a commit reads back, a torn or corrupt record is
  quarantined and counted, a store failure is a counted fallback to the
  default, off mode returns the default without touching the disk.
- The bitwise guard rejects a candidate that differs in the last bit and
  one that is nonfinite, and keeps one with the default's bits.
- The ``flash_attention`` site's candidates are the forward tiles
  ``csrc/flash_fwd.cu`` compiles, the hand-set one first, for BERT's and
  the GPT LM's keys; a stored winner reaches the launch as its row count,
  and one that was not compiled is counted and gives the default.
- ``batch_norm(..., stat_dtype="bfloat16")`` against the JAX package's
  within the bf16 gate 2e-2; the float32 default is the parent's bits.
"""
import json
import os
import threading
import zlib

import numpy as np
import pytest
import torch

from mxnet_tpu import autotune as jautotune
from mxnet_tpu.autotune.model import CostModel as JCostModel
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import MXNetError, autotune, telemetry
from mxnet_tpu_torch.autotune import measure as measure_mod
from mxnet_tpu_torch.autotune import space, store as store_mod
from mxnet_tpu_torch.autotune.model import CostModel
from mxnet_tpu_torch.autotune.store import COMMITTED, RECORD, TuningStore
from mxnet_tpu_torch.ops import _ext
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import nn as ops_nn

BERT_F32 = (8, 12, 512, 512, 64, "float32", False)
BERT_BF16 = (16, 12, 512, 512, 64, "bfloat16", False)
GPT_CAUSAL = (8, 8, 1024, 1024, 32, "bfloat16", True)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """Autotune off (each case opts in), telemetry zeroed, and no thread
    left behind."""
    monkeypatch.delenv("MXNET_AUTOTUNE", raising=False)
    monkeypatch.delenv("MXNET_AUTOTUNE_DIR", raising=False)
    threads = set(threading.enumerate())
    telemetry.enable()
    telemetry.reset()
    autotune.disable()
    yield
    autotune.disable()
    telemetry.reset()
    # no thread of the test is left (one of an earlier test may end)
    assert set(threading.enumerate()) <= threads


def _store(tmp_path):
    return TuningStore(root=str(tmp_path / "store"))


def _rec_dir(st, site, key):
    return st._record_dir(site, autotune.key_hash(list(key)))


@pytest.mark.parametrize("key", [
    list(BERT_F32), list(GPT_CAUSAL), [4, 1024, 1], [8],
    [(1, 2), {"depth": 2}], ["Net", "float32", ["b8:64", "b8:512"]]])
def test_key_hash_is_the_jax_packages(key):
    assert autotune.key_hash(key) == jautotune.key_hash(key)


class _Records:
    """A store stand-in: the same audit records for both packages."""

    def __init__(self, recs):
        self._recs = recs

    def records(self):
        return [(site, "k%d" % i, rec) for i, (site, rec) in
                enumerate(self._recs)]


def test_cost_model_predicts_as_the_jax_package():
    rs = np.random.RandomState(0)
    recs = []
    for b, t in [(8, 512), (16, 512), (4, 256), (8, 1024)]:
        key = [b, 12, t, t, 64, "float32", False]
        recs.append(("blockwise_attention", {
            "key": key, "config": 256, "ms": float(rs.rand()),
            "default_config": 256, "default_ms": float(rs.rand()),
            "candidates": [{"config": c, "ms": float(rs.rand()),
                            "status": "ok"} for c in (128, 512)]}))
    port, jax_model = CostModel(_Records(recs)), JCostModel(_Records(recs))
    jsite = jautotune.get_site("blockwise_attention")
    tsite = autotune.get_site("blockwise_attention")
    assert port.records_for("blockwise_attention") == \
        jax_model.records_for("blockwise_attention") == 4
    for key in [(2, 12, 512, 512, 64, "float32", False),
                (8, 12, 384, 384, 64, "float32", False),
                (32, 12, 2048, 2048, 64, "float32", False)]:
        for cfg in (128, 256, 512, 1024):
            want = jax_model.predict(jsite, key, cfg)
            got = port.predict(tsite, key, cfg)
            if want is None:
                assert got is None
            else:
                assert got == pytest.approx(want, rel=1e-12, abs=0)
        cands = [128, 256, 512]
        assert port.prune(tsite, key, cands, keep=2) == \
            jax_model.prune(jsite, key, cands, keep=2)


# ---- the store ---------------------------------------------------------------

def test_store_roundtrip(tmp_path):
    st = _store(tmp_path)
    key = list(BERT_F32)
    assert st.get("flash_attention", key) is None
    d = st.put("flash_attention", key, {"config": [64, 64], "ms": 1.0})
    assert d is not None and os.path.isfile(os.path.join(d, COMMITTED))
    rec = st.get("flash_attention", key)
    assert rec["config"] == [64, 64] and rec["site"] == "flash_attention"
    assert [(s, k) for s, k, _ in st.records()] == \
        [("flash_attention", autotune.key_hash(key))]
    assert telemetry.value("autotune_store_commits_total") == 1


def test_store_torn_commit_recovery(tmp_path):
    st = _store(tmp_path)
    key = [1, 2, 3]
    d = _rec_dir(st, "blockwise_attention", key)
    os.makedirs(d)
    with open(os.path.join(d, RECORD), "w") as f:
        f.write('{"config": 99}')             # no COMMITTED marker: torn
    assert st.get_status("blockwise_attention", key) == (None, "corrupt")
    assert len(st.quarantined()) == 1
    assert telemetry.value("autotune_store_quarantine_total") == 1
    assert st.put("blockwise_attention", key, {"config": 7}) is not None
    assert st.get("blockwise_attention", key)["config"] == 7


@pytest.mark.parametrize("damage", ["bytes", "json"])
def test_store_corrupt_record_quarantined(tmp_path, damage):
    st = _store(tmp_path)
    key = [9]
    st.put("blockwise_attention", key, {"config": 128})
    d = _rec_dir(st, "blockwise_attention", key)
    if damage == "bytes":                      # the CRC no longer matches
        with open(os.path.join(d, RECORD), "r+b") as f:
            f.seek(2)
            f.write(b"\xde\xad")
    else:                                      # CRC right, JSON broken
        raw = b"not json at all"
        with open(os.path.join(d, RECORD), "wb") as f:
            f.write(raw)
        with open(os.path.join(d, COMMITTED), "w") as f:
            json.dump({"crc32": zlib.crc32(raw) & 0xFFFFFFFF,
                       "nbytes": len(raw)}, f)
    assert st.get_status("blockwise_attention", key) == (None, "corrupt")
    assert ".corrupt" in st.quarantined()[0]
    assert st.get("blockwise_attention", key) is None


def test_store_concurrent_writers_last_wins(tmp_path):
    st = _store(tmp_path)
    st.env_fingerprint()
    key = [10, 20]
    errs = []

    def write(i):
        try:
            for _ in range(5):
                assert st.put("blockwise_attention", key,
                              {"config": 128 * (i + 1)}) is not None
        except Exception as exc:  # noqa: BLE001 - reported below
            errs.append(exc)

    threads = [threading.Thread(target=write, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errs
    assert st.get("blockwise_attention", key)["config"] in (128, 256, 384,
                                                            512)
    assert len(st.records()) == 1


def test_store_fingerprint_names_the_kernel_sources(tmp_path, monkeypatch):
    """A record is a clean miss under another fingerprint, and a rebuilt
    kernel library (another source) is another fingerprint."""
    root = str(tmp_path / "store")
    st = TuningStore(root=root)
    st.put("blockwise_attention", [5], {"config": 512})
    assert st.get("blockwise_attention", [5])["config"] == 512
    assert TuningStore(root=root, env_fingerprint="f" * 64).get_status(
        "blockwise_attention", [5]) == (None, "miss")
    src = tmp_path / "extra.cu"
    src.write_text("// another kernel")
    monkeypatch.setattr(_ext, "SOURCES", list(_ext.SOURCES) + [src])
    assert store_mod.env_fingerprint() != st.env_fingerprint()


def test_store_failure_is_a_counted_fallback(tmp_path, monkeypatch):
    autotune.enable("on", root=str(tmp_path / "store"))

    def broken():
        raise OSError("no fingerprint")

    monkeypatch.setattr(store_mod, "env_fingerprint", broken)
    assert autotune.lookup_info("blockwise_attention", (1,), 256) == \
        (256, "default")
    assert telemetry.value("autotune_fallback_total",
                           {"reason": "store_error"}) == 1
    # a store that cannot be made at all: counted once, default for good
    autotune.enable("on")
    monkeypatch.setattr(autotune, "TuningStore", broken)
    assert autotune.lookup("blockwise_attention", (2,), 256) == 256
    assert telemetry.value("autotune_fallback_total",
                           {"reason": "store_unavailable"}) == 1


def test_lookup_off_is_default_and_touches_no_disk(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path / "never"))
    autotune.enable("off")
    assert autotune.mode() == "off" and not autotune.is_enabled()
    assert autotune.lookup_info("flash_attention", BERT_F32, [128, 64]) \
        == ([128, 64], "default")
    assert not (tmp_path / "never").exists()
    assert telemetry.value("autotune_lookup_total") == 0


def test_lookup_tuned_invalid_and_corrupt(tmp_path):
    autotune.enable("on", root=str(tmp_path / "store"))
    st = autotune.get_store()
    st.put("blockwise_attention", list(BERT_F32), {"config": 128})
    assert autotune.lookup("blockwise_attention", BERT_F32, 256) == 128
    assert telemetry.value("autotune_lookup_total",
                           {"site": "blockwise_attention",
                            "result": "tuned"}) == 1
    st.put("flash_attention", list(BERT_F32), {"config": [512, 512]})
    assert autotune.lookup("flash_attention", BERT_F32, [128, 64]) == \
        [128, 64]                      # not compiled: the site refuses it
    assert telemetry.value("autotune_fallback_total",
                           {"reason": "invalid_config"}) == 1
    key = [1, 1, 64, 64, 8, "float32", True]
    st.put("blockwise_attention", key, {"config": 512})
    with open(os.path.join(_rec_dir(st, "blockwise_attention", key),
                           RECORD), "r+b") as f:
        f.write(b"\x00\x00")
    assert autotune.lookup("blockwise_attention", tuple(key), 256) == 256
    assert telemetry.value("autotune_fallback_total",
                           {"reason": "store_corrupt"}) == 1


# ---- the measured search and its guard ----------------------------------------

class _GuardSite(space.TuningSite):
    name = "_guard_probe"

    def default_config(self, key):
        return "default"

    def candidates(self, key):
        return ["default", "same", "last_bit", "nan"]

    def make_bench(self, key, config):
        x = torch.linspace(-1, 1, 64, dtype=torch.float32)
        if config == "last_bit":
            bits = x.view(torch.int32).clone()
            bits[17] += 1
            x = bits.view(torch.float32)
        elif config == "nan":
            x = x.clone()
            x[3] = float("nan")
        return lambda: [x.clone()]


def test_guard_rejects_last_bit_and_nonfinite(tmp_path):
    site = _GuardSite()
    res = measure_mod.tune(site, (1,), store=_store(tmp_path), commit=False,
                           repeats=1, warmup=0)
    status = {c["config"]: c["status"] for c in res.candidates}
    assert status == {"same": "ok", "last_bit": "rejected_numerics",
                      "nan": "rejected_nonfinite"}
    assert res.winner in ("default", "same")
    assert telemetry.value("autotune_reject_total",
                           {"site": "_guard_probe",
                            "reason": "numerics"}) == 1


class _ClockSite(space.TuningSite):
    """Two configs whose host and device times rank opposite ways: "busy"
    holds the host for 30 ms a run while its device work takes 0.1 ms,
    "default" returns at once with 0.5 ms of device work.  ``device``
    False makes it a CPU bench (no device time)."""

    name = "_clock_probe"

    def __init__(self, device):
        self.device = device

    def default_config(self, key):
        return "default"

    def candidates(self, key):
        return ["default", "busy"]

    def make_bench(self, key, config):
        import time as _t

        def run():
            if config == "busy":
                _t.sleep(0.03)
            if self.device:
                run.device_ms = 0.1 if config == "busy" else 0.5
            return [torch.ones(4)]

        run.device_ms = None
        return run


@pytest.mark.parametrize("device", [True, False])
def test_tune_ranks_a_card_bench_by_device_time(tmp_path, monkeypatch,
                                                device):
    """A bench that carries its device time (CUDA events on the card) is
    ranked by it, where the host clock would rank the other way; a CPU
    bench keeps the host clock.  The record and each candidate say which
    clock they hold, and the cost model reads one clock's rows."""
    st = _store(tmp_path)
    res = measure_mod.tune(_ClockSite(device), (1,), store=st, repeats=3,
                           warmup=0)
    clock = "cuda_events" if device else "host"
    assert res.clock == clock and res.record()["clock"] == clock
    assert [c["clock"] for c in res.candidates] == [clock]
    if device:
        assert res.winner == "busy"
        assert (res.winner_ms, res.default_ms) == pytest.approx((0.1, 0.5))
    else:
        assert res.winner == "default" and res.candidates[0]["ms"] > 25.0
    audit = {}
    measure_mod.measure_candidate(_ClockSite(device), (1,), "busy",
                                  repeats=1, warmup=0, audit=audit)
    assert audit == {"clock": clock}
    site = _ClockSite(device)
    site.features = lambda key: [1.0]
    real = space.get_site
    monkeypatch.setattr(space, "get_site", lambda name: site
                        if name == site.name else real(name))

    assert CostModel(st, clock=clock).predict(site, (1,), "busy") \
        is not None
    other = "host" if device else "cuda_events"
    assert CostModel(st, clock=other).predict(site, (1,), "busy") is None


def test_tune_commits_and_lookup_serves_the_winner(tmp_path):

    """A CPU tune of the flash site: both row counts run the plain
    version, so both pass the guard; the winner is committed and read
    back with provenance 'tuned'."""
    autotune.enable("search", root=str(tmp_path / "store"))
    key = (1, 1, 256, 256, 16, "float32", False)
    res = autotune.tune("flash_attention", key, repeats=2, warmup=0,
                        budget_ms=600000.0)
    assert res.committed and res.default_config == [128, 64]
    assert [c["status"] for c in res.candidates] == ["ok"]
    autotune.enable("on", root=str(tmp_path / "store"))
    value, prov = autotune.lookup_info("flash_attention", key, [128, 64])
    assert prov == "tuned" and value == res.winner
    rows = autotune.winners()
    assert [r["site"] for r in rows] == ["flash_attention"]
    with pytest.raises(MXNetError, match="structural"):
        autotune.tune("decode_bucket", (8,))


# ---- the flash site and the launch ------------------------------------------

@pytest.mark.parametrize("key,want", [
    (BERT_F32, [[128, 64], [64, 64]]),
    (BERT_BF16, [[64, 64], [128, 64]]),
    (GPT_CAUSAL, [[64, 64], [128, 64]]),
    ((1, 2, 130, 70, 256, "float32", False), [[64, 32]]),
    ((1, 2, 130, 70, 256, "float16", False), [[64, 64], [128, 64]])])
def test_flash_site_candidates_are_the_compiled_tiles(key, want):
    site = autotune.get_site("flash_attention")
    assert site.candidates(key) == want
    assert site.default_config(key) == want[0]
    assert [list(t) for t in fa.compiled_tiles(key[5], key[4])] == want
    # dropout runs the default tile alone
    assert fa.compiled_tiles(key[5], key[4], dropout=True) == \
        [tuple(want[0])]
    assert all(site.validate(key, c) for c in want)
    assert not site.validate(key, [512, 512])


@pytest.fixture
def fake_card(monkeypatch):
    """The kernel library stood in for by the plain versions on host
    memory (``test_torch_package._HostKernels``), CUDA checks lifted."""
    from test_torch_package import _HostKernels

    lib = _HostKernels()
    monkeypatch.setattr(_ext, "load", lambda: lib)
    monkeypatch.setattr(fa, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(fa, "_check_device", lambda name, ts: None)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    return lib


def test_stored_winner_reaches_the_launch(tmp_path, fake_card):
    q = torch.randn(1, 2, 256, 64)
    key = (1, 2, 256, 256, 64, "float32", False)
    fa.flash_attention(q, q, q)
    autotune.enable("on", root=str(tmp_path / "store"))
    autotune.get_store().put("flash_attention", list(key),
                             {"config": [64, 64]})
    fa.flash_attention(q, q, q)
    fa.flash_attention(q, q, q, dropout_p=0.1, seed=3)  # dropout pins it
    assert fake_card.rows == [128, 64, 128]
    key2 = (1, 2, 128, 128, 64, "float32", False)
    autotune.get_store().put("flash_attention", list(key2),
                             {"config": [256, 64]})
    q2 = torch.randn(1, 2, 128, 64)
    fa.flash_attention(q2, q2, q2)
    assert fake_card.rows[-1] == 128
    assert telemetry.value("autotune_fallback_total",
                           {"reason": "invalid_config"}) == 1


# ---- BatchNorm statistics ------------------------------------------------------

@pytest.mark.parametrize("axis", [1, 3])
def test_batch_norm_bf16_statistics_match_the_jax_package(axis):
    rs = np.random.RandomState(axis)
    x = (rs.randn(4, 6, 5, 7) * 3 + 1).astype(np.float32)
    C = x.shape[axis]
    g, b = rs.rand(C).astype(np.float32) + 0.5, rs.randn(C).astype(np.float32)
    mm, mv = rs.randn(C).astype(np.float32), rs.rand(C).astype(np.float32)
    args = (x, g, b, mm, mv)
    want = jnn.batch_norm.fn(*args, training=True, axis=axis,
                             stat_dtype="bfloat16")
    got = ops_nn.batch_norm(*map(torch.from_numpy, args), training=True,
                            axis=axis, stat_dtype="bfloat16")
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-2 * max(1.0, np.abs(w).max()))
    # float32 statistics: the parent's native_batch_norm route, bit for bit
    plain = ops_nn.batch_norm(*map(torch.from_numpy, args), training=True,
                              axis=axis)
    f32 = ops_nn.batch_norm(*map(torch.from_numpy, args), training=True,
                            axis=axis, stat_dtype="float32")
    for a, c in zip(plain, f32):
        assert torch.equal(a, c)
