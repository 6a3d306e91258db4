"""Data ingestion: text -> (label, keys, values) rows -> hashed global ids
-> unique + inverse (the localizer) -> padded static-shape CSR minibatch."""

from parameter_server_tpu_torch.data.batch import BatchBuilder, CSRBatch  # noqa: F401
from parameter_server_tpu_torch.data.libsvm import iter_libsvm  # noqa: F401
from parameter_server_tpu_torch.data.reader import MinibatchReader  # noqa: F401
