"""Random number generation: ``seed``, per-device generators, dropout seeds
and the initializers' draws.

Counterpart of ``mxnet_tpu/random.py``.  The JAX package splits one
threefry key; here each device has one explicit ``torch.Generator``, all
seeded by ``seed(n)``.  ``draw_seed(device)`` returns a fresh 64-bit seed
for the flash kernels' dropout mask as a 0-dim int64 tensor drawn on the
device, where the JAX package draws a threefry key
(``gluon/nn/transformer.py:80``): the kernels read it from device memory,
so a step captured into a CUDA graph draws a new one on every replay (the
capture registers the device's generator with the graph).  ``take_key()``
draws one as a Python int on the host.  The streams never match JAX's:
tests hand both packages the same numpy data instead of comparing draws.

``replayable(log)`` scopes a region whose draws from these generators are
recorded the first time it runs and handed back in order when it runs
again: an activation-recompute (``torch.utils.checkpoint``) of a region
that drew dropout masks or seeds sees the draws of its first run.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "generator", "take_key", "draw_seed", "draw",
           "replayable", "uniform", "normal"]

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


_REPLAY = threading.local()   # .log: the active draw log or None


@contextlib.contextmanager
def replayable(log):
    """Record (the first time) or replay (every later time) the draws of
    ``draw`` inside the scope.  ``log`` is a dict this scope owns:
    ``{"draws": [...], "replay": bool}``; the caller sets ``replay``
    once the recording run is over."""
    prev = getattr(_REPLAY, "log", None)
    _REPLAY.log = log
    log["pos"] = 0
    try:
        yield
    finally:
        _REPLAY.log = prev


def draw(fn):
    """``fn()`` -- one draw from the port's generators -- recorded or
    replayed inside a ``replayable`` scope."""
    log = getattr(_REPLAY, "log", None)
    if log is None:
        return fn()
    if log.get("replay"):
        out = log["draws"][log["pos"]]
        log["pos"] += 1
        return out
    out = fn()
    log["draws"].append(out)
    return out


def draw_seed(device=None):
    """A fresh 64-bit dropout seed: a 0-dim int64 tensor drawn on
    ``device`` (default the CPU) from its generator; nothing is read
    back to the host."""
    d = _device(device)
    return draw(lambda: torch.randint(-2 ** 63, 2 ** 63 - 1, (),
                                      dtype=torch.int64, device=d,
                                      generator=generator(d)))


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
