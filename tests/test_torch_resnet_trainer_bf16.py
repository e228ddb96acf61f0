"""The port's ``parallel.FusedTrainer(dtype='bfloat16')`` on a small
ResNet against the JAX package's, on the CPU: the bf16 run of
``test_torch_resnet_trainer.py`` (three SGD-momentum steps at lr 0.05 on
one 32x3x64x64 batch), in a file of its own to keep each file's JAX
compiles short.  The losses fall, the masters and the running statistics
stay float32 and move, and the first loss (the bf16 forward at the shared
weights) agrees within 2e-2 relative; why the later ones are not held to
it is in that file's docstring.
"""
import pytest

from test_torch_resnet_trainer import (check_losses,
                                       check_weights_and_running_stats,
                                       make_runs, make_weights)


@pytest.fixture(scope="module")
def weights():
    return make_weights()


@pytest.fixture(scope="module")
def runs(weights):
    return make_runs("bf16", weights)


def test_losses_match(runs):
    check_losses(runs)


def test_weights_and_running_stats_match(runs, weights):
    check_weights_and_running_stats(runs, weights)
