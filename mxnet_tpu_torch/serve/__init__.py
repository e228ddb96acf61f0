"""mx.serve of the port: dynamic-batching inference serving.

``Server(block).submit(x)`` pads each request to its shape bucket,
coalesces concurrent requests into micro-batches and runs them through
``ModelRunner`` on the card (``ctx=mx.cpu()`` for the CPU).
"""
from .batching import (BatchQueue, BucketQuarantined, NoBucketError,  # noqa: F401
                       Request, RequestTimeout, Scheduler, ServeError,
                       ServerClosed, ServerOverloaded)
from .breaker import BreakerBoard, CircuitBreaker  # noqa: F401
from .runner import DEFAULT_BATCH_SIZES, ModelRunner  # noqa: F401
from .server import ServeConfig, Server  # noqa: F401
