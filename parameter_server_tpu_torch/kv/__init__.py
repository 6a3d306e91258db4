"""The key->value model store: dense state tables over the hashed key
space, ``pull`` (row gather) and ``push`` (server-side updater applied to
the touched rows)."""

from parameter_server_tpu_torch.kv.store import KVStore  # noqa: F401
from parameter_server_tpu_torch.kv.updaters import (  # noqa: F401
    Adagrad,
    Ftrl,
    Sgd,
    make_updater,
)
