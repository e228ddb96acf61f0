"""The port's ResNet v2 nets (``BasicBlockV2`` and ``BottleneckV2``)
against the JAX package's, on the CPU: the checks of
``test_torch_resnet.py`` (names and shapes, eval-mode outputs, train-mode
outputs, gradients and running statistics within 1e-4 x max(1, max|ref|))
on the v2 variants, in a file of their own to keep each file's JAX
compiles short.
"""
import pytest

from test_torch_resnet import (check_eval_outputs, check_names_and_shapes,
                               check_train_outputs_grads_and_running_stats,
                               make_pair)


@pytest.fixture(scope="module", params=["v2_basic", "v2_bottleneck"])
def pair(request):
    return make_pair(request.param)


def test_names_and_shapes_match(pair):
    check_names_and_shapes(pair)


def test_eval_outputs_match(pair):
    check_eval_outputs(pair)


def test_train_outputs_grads_and_running_stats_match(pair):
    check_train_outputs_grads_and_running_stats(pair)
