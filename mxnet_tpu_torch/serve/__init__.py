"""mx.serve of the port: dynamic-batching and autoregressive serving.

``Server(block).submit(x)`` pads each request to its shape bucket,
coalesces concurrent requests into micro-batches and runs them through
``ModelRunner`` on the card (``ctx=mx.cpu()`` for the CPU).
``Server(decode=decoder).submit_decode(prompt)`` generates tokens through
the decode plane: a paged KV cache (``kvcache.PagePool``), Orca-style
continuous batching (``DecodeScheduler`` over a ``DecodeRunner``), the
radix prefix cache (``cache.PrefixCache``, opt-in through
``DecodeConfig(prefix_cache=True)``) and speculative decoding
(``spec.SpecPlane``, through ``DecodeRunner(draft=...)``).
``Server.start_http()`` serves both planes over HTTP.
"""
from .batching import (BatchQueue, BucketQuarantined, NoBucketError,  # noqa: F401
                       Request, RequestTimeout, Scheduler, ServeError,
                       ServerClosed, ServerOverloaded, fail_request)
from .breaker import BreakerBoard, CircuitBreaker  # noqa: F401
from .cache import PrefixCache, prefix_digest  # noqa: F401
from .decode import (DecodeConfig, DecodeError, DecodeRequest,  # noqa: F401
                     DecodeRunner, DecodeScheduler, TinyDecoder)
from .kvcache import PageConfig, PagePool, PagePoolExhausted  # noqa: F401
from .runner import DEFAULT_BATCH_SIZES, ModelRunner  # noqa: F401
from .server import ServeConfig, Server  # noqa: F401
from .spec import SpecPlane  # noqa: F401
