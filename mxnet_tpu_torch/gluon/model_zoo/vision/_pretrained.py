"""``pretrained=True`` for the vision families: no weights are stored or
downloaded, so it raises.  Weights a user holds load with
``net.load_parameters(<file>)`` (either package's files) or cross from
the JAX package through ``convert.load_jax_params``; a local weight store
(``model_store.py``) waits in ``ROADMAP.md`` Queue 1 item 10."""
from ....base import MXNetError


def check_pretrained(pretrained, name):
    if pretrained:
        raise MXNetError(
            "%s(pretrained=True): no pretrained weights ship with the port; "
            "load a weight file with net.load_parameters(<file>) (either "
            "package's files; model_store.py waits in ROADMAP.md Queue 1 "
            "item 10)" % name)
