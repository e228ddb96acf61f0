"""``pretrained=True`` for the vision families: no weights are stored or
downloaded (local weight files wait for persistence, ``ROADMAP.md``
Queue 1 item 3), so it raises; weights cross from the JAX package through
``convert.load_jax_params``."""
from ....base import MXNetError


def check_pretrained(pretrained, name):
    if pretrained:
        raise MXNetError(
            "%s(pretrained=True): pretrained weights are not available "
            "(local weight files wait for persistence, ROADMAP.md Queue 1 "
            "item 3); load them with convert.load_jax_params" % name)
