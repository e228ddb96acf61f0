"""mxnet_tpu_torch: the PyTorch + CUDA port of mxnet_tpu, for NVIDIA Hopper.

This package sits beside ``mxnet_tpu/`` (the JAX reference) and ports it
slice by slice.  Its imperative front door is ``mx.nd``: ``NDArray``
over one tensor, the op registry and its ops, and NDArray autograd.  It
serves BERT-base through ``serve.Server`` and trains it
through ``autograd.record()``, ``backward()`` and ``gluon.Trainer`` (whose
grouped apply and whole step ``trainer.capture`` turns into one CUDA
graph, ``mx.step``), or in bf16 through ``parallel.FusedTrainer``; every
attention call on those paths runs hand-written CUDA flash-attention
kernels (``csrc/flash_fwd.cu``, and ``csrc/flash_bwd.cu`` for the
gradients).  Its input pipeline (``gluon.data``, ``io``, ``recordio``,
``image``, the streaming ``mx.data``) decodes and augments on the host and
stages whole batches onto the card.

Ground rules:

- **The JAX package stays as it is.**  It is the reference the port's tests
  compare against.
- **No imports from the JAX side.**  This package imports ``torch`` and
  never ``jax``, and nothing of ``mxnet_tpu`` (not even a JAX-free module):
  it keeps its own copy of what it needs.  Weights cross by parameter name
  through numpy (``convert.load_jax_params``).
- **Same names, PyTorch idiom.**  Module and class names match the JAX
  package.  Blocks are ``nn.Module``s, ops are plain functions on tensors,
  devices are explicit.
- **The card is the default, and nothing falls back.**  Entry points run
  on ``cuda:0`` unless the caller passes ``ctx=mx.cpu()``; without a card
  they raise.  A CUDA tensor handed to a kernel wrapper launches the kernel
  or raises; only a CPU tensor takes the kernel's plain PyTorch version.
"""
__version__ = "2.0.0-torch0"

from . import (autograd, autotune, base, callback, checkpoint,  # noqa: F401
               context, contrib, convert, error, gluon, initializer, kvstore,
               monitor, ndarray, ops, optimizer, parallel, profiler, random,
               resilience, serve, step, telemetry, trace)
from . import data, image, io, native, recordio  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import numpy, numpy_extension, operator, util  # noqa: F401
from . import numpy as np  # noqa: F401
from . import numpy_extension as npx  # noqa: F401
from .util import is_np_array, reset_np, set_np, use_np  # noqa: F401
from .ndarray import NDArray, waitall  # noqa: F401
from .optimizer import lr_scheduler  # noqa: F401  (mx.lr_scheduler)
from . import config, metric  # noqa: F401  (mx.config, mx.metric)
from . import dist  # noqa: F401  (collective deadlines)
from . import obs  # noqa: F401  (SLOs, step attribution, publishing)
from . import elastic  # noqa: F401  (failure detection + auto-resume)

from .base import MXNetError, get_env  # noqa: F401
from .context import (Context, cpu, cpu_pinned,  # noqa: F401
                      current_context, gpu, num_gpus)

if get_env("MXNET_PROFILER_AUTOSTART", bool, False):
    profiler.set_state("run")  # reference env_var.md MXNET_PROFILER_AUTOSTART
