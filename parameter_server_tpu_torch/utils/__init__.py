"""Host-side utilities."""

from parameter_server_tpu_torch.utils.hashing import hash_keys, splitmix64  # noqa: F401
