"""mx.step: whole-step capture.

``capture(net, loss_fn, trainer=trainer)`` returns a ``StepProgram``: one
call is one training step (forward, loss, backward, the bucket plan, the
grouped optimizer apply and the monitor stats), a CUDA graph on the card
and the same step run eagerly on the CPU, with the stitched imperative
path as the fallback (``MXNET_STEP_CAPTURE=0``; every degradation is
counted).  See ``capture.py``.
"""
from __future__ import annotations

from .capture import (CaptureError, StepProgram, capture, is_enabled,
                      remat_mode)

__all__ = ["CaptureError", "StepProgram", "capture", "is_enabled",
           "remat_mode"]
