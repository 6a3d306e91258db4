"""parameter_server_tpu_torch — the parameter server on PyTorch and CUDA.

A port of ``parameter_server_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. It imports neither JAX nor anything of the JAX package: modules the
two share are copied here, trimmed to what the port uses. Each module keeps
the relative path and the public names of its JAX counterpart, so a reader
can find the pair; the JAX package is the reference the port's tests hold
it against.

Package layout (only what is ported so far):
    utils/      config, hashing, checkpoints, progress table
    filters/    the count-min frequency filter of the training ingest
    data/       parsers, localizer, minibatch reader, synthetic data
    kv/         the KV store: pull/push/updaters
    ops/        CSR segment sums and the hand-written CUDA kernels (csrc/)
    models/     linear_method (sparse logistic regression, async FTRL)
    cli.py      the ``train`` / ``evaluate`` commands

Entry points (``KVStore``, ``LinearMethod``, ``cli --device``) run on
``cuda`` unless the caller asks for ``cpu``; asking for the card where
there is none raises.
"""

__version__ = "0.1.0"
