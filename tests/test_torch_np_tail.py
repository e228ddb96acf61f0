"""Names of ``jax.numpy`` beyond ``test_numpy_op.py``'s table (``EXTRA``)
and the keyword arguments of the port's own ``mx.np`` functions
(``KEYWORDS``) through both ``mx.np``s, the calls both refuse
(``RAISES``), and every registered op of the port's
``ops/np_tail.py`` (the ``_npi_`` long tail, ``NP_TAIL``) through both
``mx.nd``s, on the CPU: the same inputs, results equal in count, shape
and dtype, exactly for integer and boolean results and within
``test_torch_numpy.py``'s ``RTOL``/``ATOL`` for floating ones.
"""
import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from np_cases import EXTRA, KEYWORDS, NP_TAIL, RAISES
from test_torch_numpy import assert_same, run_case, to_nd


@pytest.mark.parametrize("name,args,kwargs", EXTRA,
                         ids=["%s_%d" % (c[0], i) for i, c in
                              enumerate(EXTRA)])
def test_np_extra_name_matches_jax(name, args, kwargs):
    if not hasattr(mj.np, name):
        pytest.fail("jax.numpy has no %s here" % name)
    got, ref = run_case(name, args, kwargs)
    if name in ("unique_counts",):
        got, ref = tuple(got), tuple(ref)
    assert_same(got, ref, name)


@pytest.mark.parametrize("name,args,kwargs", KEYWORDS,
                         ids=["%s_%d" % (c[0], i) for i, c in
                              enumerate(KEYWORDS)])
def test_np_keyword_matches_jax(name, args, kwargs):
    got, ref = run_case(name, args, kwargs)
    assert_same(got, ref, name)


@pytest.mark.parametrize("name,args,kwargs,error", RAISES,
                         ids=["%s_%d" % (c[0], i) for i, c in
                              enumerate(RAISES)])
def test_np_call_raises_as_jax_does(name, args, kwargs, error):
    with pytest.raises(error):
        getattr(mj.np, name)(*to_nd(mj, args), **{
            k: to_nd(mj, v) for k, v in kwargs.items()})
    with mt.cpu(), pytest.raises(error):
        getattr(mt.np, name)(*to_nd(mt, args), **{
            k: to_nd(mt, v) for k, v in kwargs.items()})


@pytest.mark.parametrize("name", ["intersect1d", "setdiff1d", "union1d",
                                  "setxor1d"])
def test_np_set_ops_refuse_a_static_size(name):
    """``size=`` pads ``jax.numpy``'s set results to a static length; the
    port's eager results have their own, so it refuses the argument."""
    with mt.cpu():
        a = mt.np.array(onp.int32([1, 2, 3]))
        with pytest.raises(NotImplementedError):
            getattr(mt.np, name)(a, a, size=4)


def _tail(mx, name):
    inputs, attrs = NP_TAIL[name]
    args = [mx.nd.array(x) if isinstance(x, onp.ndarray) else x
            for x in inputs]
    return getattr(mx.nd, name)(*args, **attrs)


def test_every_np_tail_op_has_a_case():
    from mxnet_tpu_torch.ops import registry

    # an alias (``ops/parity.py``'s reference names) is the op under
    # another name, which its own case covers
    own = {n for n in registry.list_ops()
           if registry.get_op(n).fn.__module__.endswith(".np_tail")
           and registry.get_op(n).name == n}
    assert own == set(NP_TAIL)


@pytest.mark.parametrize("name", sorted(NP_TAIL))
def test_np_tail_op_matches_jax(name):
    ref = _tail(mj, name)
    with mt.cpu():
        got = _tail(mt, name)
    assert_same(got, ref, name)
