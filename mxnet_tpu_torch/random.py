"""``mx.random`` (also ``mx.nd.random``): the samplers, ``seed``, per-device
generators, dropout seeds and the initializers' draws.

Counterpart of ``mxnet_tpu/random.py``.  As there, ``mx.random`` and
``mx.nd.random`` are one module, whose eighteen samplers (``uniform``,
``normal``, ``randn``, ``randint``, ``gamma``, ``exponential``,
``poisson``, ``multinomial``, ``bernoulli``, ``shuffle``, ``laplace``,
``pareto``, ``weibull``, ``rayleigh``, ``gumbel``, ``logistic``,
``choice``, ``categorical``; plus ``negative_binomial`` and
``generalized_negative_binomial``) return NDArrays drawn on ``ctx``
(default the current context: the card, or the CPU inside ``with
mx.cpu():``) and write into ``out`` when it is given.  A sampler with an
NDArray parameter draws one sample of each element's distribution
through the registry's ``sample_*`` op, as the JAX package's ``nd``
samplers do.

The JAX package splits one threefry key; here each device has one explicit
``torch.Generator``, all seeded by ``seed(n)``. The port's own code draws
through ``generator``, ``draw_seed``, ``take_key``, ``draw``,
``replayable`` and the tensor fills ``uniform_tensor``/``normal_tensor``
(the initializers, dropout, the recurrent layers, the sampling ops, the
whole-step capture, SGLD's noise). ``draw_seed(device)`` returns a fresh
64-bit seed for the flash kernels' dropout mask as a 0-dim int64 tensor
drawn on the device, where the JAX package draws a threefry key
(``gluon/nn/transformer.py:80``): the kernels read it from device memory,
so a step captured into a CUDA graph draws a new one on every replay (the
capture registers the device's generator with the graph). ``take_key()``
draws one as a Python int on the host. The streams never match JAX's: tests
hand both packages the same numpy data instead of comparing draws.

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
           "replayable", "uniform_tensor", "normal_tensor", "uniform",
           "normal", "randn", "randint", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "bernoulli", "shuffle", "laplace", "pareto",
           "weibull", "rayleigh", "gumbel", "logistic", "choice",
           "categorical"]

_LOCK = threading.Lock()
_SEED = [0]
_GENERATORS = {}   # torch.device -> torch.Generator


def _device(device):
    """A ``torch.device``, device string or ``Context`` (default the
    CPU) -> the indexed ``torch.device``."""
    if device is not None and hasattr(device, "torch_device"):
        return device.torch_device
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


def uniform_tensor(low=0.0, high=1.0, shape=(), dtype=torch.float32,
                   ctx=None, out=None):
    """Uniform draws on [low, high) from the generator of the device
    (``ctx``: a ``torch.device`` or ``Context``, default the CPU): a new
    tensor, or ``out`` filled in place."""
    if out is None:
        out = torch.empty(tuple(shape), dtype=dtype, device=_device(ctx))
    return out.uniform_(low, high, generator=generator(out.device))


def normal_tensor(loc=0.0, scale=1.0, shape=(), dtype=torch.float32,
                  ctx=None, out=None):
    """Normal draws from the generator of the device: a new tensor, or
    ``out`` filled in place."""
    if out is None:
        out = torch.empty(tuple(shape), dtype=dtype, device=_device(ctx))
    return out.normal_(loc, scale, generator=generator(out.device))


# ---- the samplers: NDArrays on ``ctx`` ------------------------------------


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _ndarray():
    from .ndarray.ndarray import NDArray

    return NDArray


def _get_op(name):
    from .ops.registry import get_op

    return get_op(name)


def _wrap(data, out):
    """``data`` as an NDArray, or written into ``out``."""
    if out is not None:
        out._data = data
        return out
    return _ndarray()(data)


def _data(x):
    return x._data if isinstance(x, _ndarray()) else x


def _draw(name, params, shape, dtype, ctx, out):
    """The ``sample_*`` op when a parameter is an NDArray (a scalar one
    filled to its shape), else the ``random_*`` op on ``ctx`` (default
    ``out``'s context, else the current one)."""
    NDArray = _ndarray()
    if ctx is None and out is not None:
        ctx = out.context
    like = next((p for p in params.values() if isinstance(p, NDArray)),
                None)
    if like is not None:
        args = [p if isinstance(p, NDArray)
                else NDArray(torch.full_like(like._data, float(p)))
                for p in params.values()]
        res = _get_op("sample_" + name)(*args, shape=shape, dtype=dtype)
    else:
        res = _get_op("random_" + name)(**params, shape=_shape(shape),
                                        dtype=dtype, ctx=ctx)
    if out is not None:
        out._data = res._data
        return out
    return res


def _unit(shape, dtype, ctx, out=None):
    """Uniform [0, 1) draws of ``shape`` on ``ctx`` (default ``out``'s
    context, else the current one), as a tensor."""
    from .base import _as_torch_dtype
    from .context import device_of

    dev = device_of(ctx if ctx is not None or out is None else out.context)
    return torch.rand(_shape(shape), dtype=_as_torch_dtype(dtype),
                      device=dev, generator=generator(dev))


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kw):
    return _draw("uniform", {"low": low, "high": high}, shape, dtype, ctx,
                 out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kw):
    if isinstance(loc, _ndarray()) or isinstance(scale, _ndarray()):
        return _draw("normal", {"mu": loc, "sigma": scale}, shape, dtype,
                     ctx, out)
    return _draw("normal", {"loc": loc, "scale": scale}, shape, dtype, ctx,
                 out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape, dtype=dtype, ctx=ctx)


def randint(low, high=None, shape=(1,), dtype="int32", ctx=None, out=None):
    if high is None:
        low, high = 0, low
    return _draw("randint", {"low": low, "high": high}, shape, dtype, ctx,
                 out)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None):
    return _draw("gamma", {"alpha": alpha, "beta": beta}, shape, dtype, ctx,
                 out)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _draw("exponential", {"lam": 1.0 / scale}, shape, dtype, ctx, out)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _draw("poisson", {"lam": lam}, shape, dtype, ctx, out)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None):
    return _draw("negative_binomial", {"k": k, "p": p}, shape, dtype, ctx,
                 out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None):
    return _draw("generalized_negative_binomial", {"mu": mu, "alpha": alpha},
                 shape, dtype, ctx, out)


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    """Category indices drawn from (batched) probability rows."""
    return _get_op("sample_multinomial")(data, shape=shape, get_prob=get_prob,
                                         dtype=dtype)


def bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None, out=None):
    from .base import _as_torch_dtype

    u = _unit(shape, "float32", ctx, out)
    return _wrap((u < prob).to(_as_torch_dtype(dtype)), out)


def shuffle(data, **kw):
    """A random permutation along axis 0."""
    return _get_op("shuffle")(data)


def laplace(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
            out=None):
    u = _unit(shape, dtype, ctx, out) - 0.5
    # inverse CDF on (-1/2, 1/2): loc - scale * sign(u) * log(1 - 2|u|)
    x = -torch.sign(u) * torch.log1p(-2.0 * u.abs())
    return _wrap(x * scale + loc, out)


def pareto(a=1.0, shape=None, dtype="float32", ctx=None, out=None):
    """Lomax-style pareto (np.random.pareto: (1-U)^{-1/a} - 1)."""
    u = _unit(shape, dtype, ctx, out)
    return _wrap(torch.expm1(-torch.log1p(-u) / a), out)


def weibull(a=1.0, shape=None, dtype="float32", ctx=None, out=None):
    u = _unit(shape, dtype, ctx, out)
    return _wrap(torch.pow(-torch.log1p(-u), 1.0 / a), out)


def rayleigh(scale=1.0, shape=None, dtype="float32", ctx=None, out=None):
    u = _unit(shape, dtype, ctx, out)
    return _wrap(scale * torch.sqrt(-2.0 * torch.log1p(-u)), out)


def gumbel(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None):
    u = _unit(shape, dtype, ctx, out)
    tiny = torch.finfo(u.dtype).tiny
    return _wrap(-torch.log(-torch.log(u.clamp_min(tiny))) * scale + loc,
                 out)


def logistic(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
             out=None):
    u = _unit(shape, dtype, ctx, out)
    tiny = torch.finfo(u.dtype).tiny
    return _wrap(torch.logit(u.clamp_min(tiny)) * scale + loc, out)


def choice(a, size=None, replace=True, p=None, ctx=None, out=None):
    """np.random.choice: draws from ``a`` (an int n means ``arange(n)``),
    with probabilities ``p``, with or without replacement."""
    from .context import device_of

    arr = _data(a)
    if isinstance(arr, int):
        arr = torch.arange(arr, dtype=torch.int32, device=device_of(ctx))
    n = arr.shape[0]
    shape = _shape(size)
    count = 1
    for s in shape:
        count *= s
    probs = (torch.ones(n, device=arr.device) if p is None
             else torch.as_tensor(_data(p), dtype=torch.float32,
                                  device=arr.device))
    idx = torch.multinomial(probs, count, replacement=replace,
                            generator=generator(arr.device))
    return _wrap(arr[idx].reshape(shape), out)


def categorical(logits, shape=None, ctx=None, out=None):
    """npx.random.categorical: indices drawn from each row of
    ``logits`` (the last axis), ``shape`` draws a row when given."""
    lg = _data(logits).to(torch.float32)
    rows = lg.reshape(-1, lg.shape[-1])
    probs = torch.softmax(rows, dim=-1)
    extra = _shape(shape) if shape is not None else ()
    count = 1
    for s in extra:
        count *= s
    idx = torch.multinomial(probs, count, replacement=True,
                            generator=generator(lg.device))
    if shape is None:
        res = idx.reshape(lg.shape[:-1])
    else:
        res = idx.reshape(tuple(lg.shape[:-1]) + extra)
    return _wrap(res.to(torch.int32), out)
