"""The port's optimizers (``mxnet_tpu_torch.optimizer``) against the JAX
package's, per parameter, on the CPU.

Every optimizer the JAX package registers runs 5 steps of
``update_multi_precision`` on the same numpy weights and gradients on
both sides, with ``rescale_grad``, weight decay and (where the rule has
them) clipping, and the weights and states must agree within
1e-6 x max(1, max|w|).  Both sides do the same float32 operations; the
per-step Python values (lr, wd, bias corrections) round once to float32
on both.  Also: ``multi_precision`` on bfloat16 weights (the float32
masters agree, the weights are the masters cast), an ``lr_scheduler``,
``Updater``, SGLD's noise (zeroed on both sides for the comparison, its
spread checked alone), and the per-parameter and one-element-list paths
being the same rule.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.optimizer import lr_scheduler as tsched
from mxnet_tpu_torch.optimizer import optimizer as topt_mod

SHAPES = [(6, 4), (5,)]
STEPS = 5
TOL = 1e-6
COMMON = dict(rescale_grad=0.5, wd=0.01)
CASES = {
    "sgd": dict(learning_rate=0.1, momentum=0.9, clip_gradient=0.8),
    "nag": dict(learning_rate=0.1, momentum=0.9),
    "adam": dict(learning_rate=0.01),
    "adamw": dict(learning_rate=0.01, clip_gradient=0.5),
    "adamax": dict(learning_rate=0.02),
    "nadam": dict(learning_rate=0.01),
    "lamb": dict(learning_rate=0.01, lower_bound=0.1, upper_bound=5.0),
    "lans": dict(learning_rate=0.01),
    "lars": dict(learning_rate=0.1, momentum=0.9),
    "ftrl": dict(learning_rate=0.1),
    "ftml": dict(learning_rate=0.01),
    "adagrad": dict(learning_rate=0.05),
    "adadelta": dict(learning_rate=1.0),
    "rmsprop": dict(learning_rate=0.01),
    "rmsprop_centered": dict(learning_rate=0.01, centered=True,
                             clip_weights=2.0),
    "sgld": dict(learning_rate=0.01),
    "signum": dict(learning_rate=0.01),
    "signum_nomom": dict(learning_rate=0.01, momentum=0.0, wd_lh=0.1),
    "dcasgd": dict(learning_rate=0.1, momentum=0.9),
    "lbsgd": dict(learning_rate=0.1, momentum=0.9, warmup_epochs=1,
                  updates_per_epoch=4),
    "test": dict(learning_rate=0.1),
}


def _name(case):
    return case.split("_")[0]


def _data(seed=0):
    rs = np.random.RandomState(seed)
    ws = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rs.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(STEPS)]
    return ws, gs


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, tuple):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _jax_run(name, kw, ws, gs, dtype="float32"):
    opt = jopt.create(name, **dict(COMMON, **kw))
    weights = [jmx.nd.array(w).astype(dtype) for w in ws]
    states = [opt.create_state_multi_precision(i, w)
              for i, w in enumerate(weights)]
    for step in gs:
        for i, (w, g) in enumerate(zip(weights, step)):
            opt.update_multi_precision(i, w, jmx.nd.array(g).astype(dtype),
                                       states[i])
    return ([w.astype("float32").asnumpy() for w in weights],
            [[np.asarray(leaf.asnumpy(), np.float32)
              for leaf in _leaves(s)] for s in states], opt)


def _port_run(name, kw, ws, gs, dtype=torch.float32):
    opt = topt.create(name, **dict(COMMON, **kw))
    weights = [torch.from_numpy(w).to(dtype) for w in ws]
    states = [opt.create_state_multi_precision(i, w)
              for i, w in enumerate(weights)]
    for step in gs:
        for i, (w, g) in enumerate(zip(weights, step)):
            opt.update_multi_precision(i, w, torch.from_numpy(g).to(dtype),
                                       states[i])
    return ([w.float().numpy() for w in weights],
            [[leaf.numpy() for leaf in _leaves(s)] for s in states], opt)


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, "%s: %g > %g" % (what, err, TOL * scale)


def _zero_sgld_noise(monkeypatch):
    import jax
    import jax.numpy as jnp

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.zeros(shape))
    monkeypatch.setattr(topt_mod, "_sgld_noise",
                        lambda w: [torch.zeros_like(x) for x in w])


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax(case, monkeypatch):
    name = _name(case)
    if name == "sgld":
        _zero_sgld_noise(monkeypatch)
    ws, gs = _data()
    jw, js, jo = _jax_run(name, CASES[case], ws, gs)
    tw, ts, to = _port_run(name, CASES[case], ws, gs)
    for i, (a, b) in enumerate(zip(tw, jw)):
        _close(a, b, "%s weight %d" % (case, i))
    for i, (sa, sb) in enumerate(zip(ts, js)):
        assert len(sa) == len(sb)
        for a, b in zip(sa, sb):
            _close(a, b, "%s state %d" % (case, i))
    assert to.num_update == jo.num_update
    assert to._index_update_count == jo._index_update_count


@pytest.mark.parametrize("name", ["sgd", "adam", "lamb"])
def test_multi_precision_bf16_masters(name):
    kw = dict(CASES[name], multi_precision=True)
    ws, gs = _data(1)
    jw, js, _ = _jax_run(name, kw, ws, gs, "bfloat16")
    tw, ts, to = _port_run(name, kw, ws, gs, torch.bfloat16)
    for i, (sa, sb) in enumerate(zip(ts, js)):
        _close(sa[0], sb[0], "%s master %d" % (name, i))   # f32 masters
        for a, b in zip(sa[1:], sb[1:]):
            _close(a, b, "%s state %d" % (name, i))
    for w, st in zip(tw, ts):
        # each bf16 weight is its master rounded
        want = torch.from_numpy(st[0]).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(w, want)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_lr_scheduler_matches_jax(name):
    from mxnet_tpu.optimizer import lr_scheduler as jsched

    ws, gs = _data(2)
    kw = dict(CASES[name])
    jw, _, jo = _jax_run(name, dict(kw, lr_scheduler=jsched.FactorScheduler(
        step=1, factor=0.7)), ws, gs)
    tw, _, to = _port_run(name, dict(kw, lr_scheduler=tsched.FactorScheduler(
        step=1, factor=0.7)), ws, gs)
    for a, b in zip(tw, jw):
        _close(a, b, name)
    assert to.learning_rate == pytest.approx(jo.learning_rate, rel=1e-12)
    with pytest.raises(mx.MXNetError, match="lr_scheduler"):
        to.set_learning_rate(0.5)


def test_updater_matches_jax():
    ws, gs = _data(3)
    jo = jopt.create("adam", learning_rate=0.01)
    to = topt.create("adam", learning_rate=0.01)
    ju, tu = jopt.get_updater(jo), topt.get_updater(to)
    jw = [jmx.nd.array(w) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    for step in gs:
        for i, g in enumerate(step):
            ju(i, jmx.nd.array(g), jw[i])
            tu(i, torch.from_numpy(g), tw[i])
    for a, b in zip(tw, jw):
        _close(a.numpy(), b.asnumpy(), "updater")
    restored = topt.get_updater(topt.create("adam", learning_rate=0.01))
    restored.set_states(tu.get_states())
    for i in tu.states:
        for a, b in zip(_leaves(tu.states[i]), _leaves(restored.states[i])):
            assert torch.equal(a, b)


def test_sgld_noise_has_the_langevin_spread():
    mx.random.seed(5)
    opt = topt.create("sgld", learning_rate=0.01)
    w = torch.zeros(200, 100)
    opt.update(0, w, torch.zeros_like(w), None)
    assert float(w.std()) == pytest.approx(0.1, rel=0.05)   # sqrt(lr)
    assert abs(float(w.mean())) < 0.01


def test_per_parameter_update_is_the_list_rule():
    """``update`` on one weight is the rule on a one-element list: the
    same numbers as the rule run over both weights at once."""
    from mxnet_tpu_torch.optimizer.multi_tensor import Slots

    ws, gs = _data(4)
    one = topt.create("adam", learning_rate=0.01, wd=0.01)
    both = topt.create("adam", learning_rate=0.01, wd=0.01)
    a = [torch.from_numpy(w.copy()) for w in ws]
    b = [torch.from_numpy(w.copy()) for w in ws]
    sa = [one.create_state(i, w) for i, w in enumerate(a)]
    sb = [both.create_state(i, w) for i, w in enumerate(b)]
    for step in gs:
        g = [torch.from_numpy(x) for x in step]
        for i in range(2):
            one.update(i, a[i], g[i], sa[i])
        for i in range(2):
            both._update_count(i)
        slots = Slots(both._scalars(0), torch.device("cpu"))
        both._apply(b, g, sb, slots.values)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_create_rejects_unknown_names():
    with pytest.raises(mx.MXNetError, match="unknown optimizer"):
        topt.create("nosuch")
    from mxnet_tpu.optimizer import optimizer as jopt_mod

    assert set(topt_mod._OPT_REGISTRY) == set(jopt_mod._OPT_REGISTRY)
