"""The ops of the PyTorch port's ``ops/nn.py``, ``ops/tensor_tail.py`` and
``ops/legacy.py`` (and their aliases) against the JAX ops of the same
names, on the CPU: the cases, inputs and tolerances of
``test_torch_nd_ops.py``'s table, run by its ``check_op``.
"""
import pytest

from mxnet_tpu_torch.ops import registry as treg
from test_torch_nd_ops import CORE, SPECS, check_op

REST = sorted(set(SPECS) - set(CORE))


def test_the_two_files_share_out_every_case():
    assert REST and not set(REST) & set(CORE)
    assert {treg.get_op(n).fn.__module__.rsplit(".", 1)[-1]
            for n in REST} == {"nn", "tensor_tail", "legacy"}


@pytest.mark.parametrize("name", REST)
def test_op_matches_jax(name):
    check_op(name)
