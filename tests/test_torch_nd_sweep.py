"""The sweep of ``mx.nd`` against the JAX package, on the CPU: every op of
the JAX registry that the port's ``mx.nd`` exports, on a float32 and an
int32 array, as ``test_torch_np_sweep.py`` sweeps ``mx.np`` (the rules,
the inputs and ``ND_SKIP`` are there)."""
import pytest

from test_torch_np_sweep import NAMES, _sweep


@pytest.mark.parametrize("name", NAMES["nd"])
def test_nd_op_matches_jax(name):
    _sweep("nd", name)
