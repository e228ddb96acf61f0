"""Key-value stores: only the gradient bucket planner is ported
(``collective``).  The stores (local, device, NCCL through
``torch.distributed``) wait for the multi-card slice."""
from . import collective  # noqa: F401
