"""Random number generation: ``seed``, per-device generators, dropout seeds
and the initializers' draws.

Counterpart of ``mxnet_tpu/random.py``.  The JAX package splits one
threefry key; here each device has one explicit ``torch.Generator``, all
seeded by ``seed(n)``.  ``take_key()`` returns a fresh 64-bit seed for the
flash kernels' dropout mask, where the JAX package draws a threefry key
(``gluon/nn/transformer.py:80``).  The streams never match JAX's: tests
hand both packages the same numpy data instead of comparing draws.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "take_key", "uniform", "normal"]

_LOCK = threading.Lock()
_SEED = [0]
_GENERATORS = {}   # torch.device -> torch.Generator


def _device(device):
    d = torch.device(device if device is not None else "cpu")
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def seed(seed_state, ctx="all"):
    """Seed every device's generator with ``seed_state``."""
    with _LOCK:
        _SEED[0] = int(seed_state)
        for gen in _GENERATORS.values():
            gen.manual_seed(_SEED[0])


def generator(device=None):
    """The generator of ``device`` (default the CPU), made at first use and
    seeded with the last ``seed()``."""
    d = _device(device)
    with _LOCK:
        gen = _GENERATORS.get(d)
        if gen is None:
            gen = torch.Generator(device=d)
            gen.manual_seed(_SEED[0])
            _GENERATORS[d] = gen
        return gen


def take_key():
    """A fresh 64-bit seed (a Python int), drawn on the host so that no
    device waits for it."""
    bits = torch.randint(-2 ** 63, 2 ** 63 - 1, (), dtype=torch.int64,
                         generator=generator("cpu"))
    return int(bits) & 0xFFFFFFFFFFFFFFFF


def uniform(low=0.0, high=1.0, shape=(), dtype=torch.float32, ctx=None,
            out=None):
    """Uniform draws on [low, high) from the generator of the device:
    a new tensor, or ``out`` filled in place."""
    if out is None:
        out = torch.empty(tuple(shape), dtype=dtype, device=_device(ctx))
    return out.uniform_(low, high, generator=generator(out.device))


def normal(loc=0.0, scale=1.0, shape=(), dtype=torch.float32, ctx=None,
           out=None):
    """Normal draws from the generator of the device: a new tensor, or
    ``out`` filled in place."""
    if out is None:
        out = torch.empty(tuple(shape), dtype=dtype, device=_device(ctx))
    return out.normal_(loc, scale, generator=generator(out.device))
