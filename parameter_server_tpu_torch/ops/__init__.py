"""Device compute: CSR segment sums and the hand-written CUDA kernels (FTRL
push and delta, AdaGrad push, the stochastic quantizer)."""

from parameter_server_tpu_torch.ops.sparse import (  # noqa: F401
    csr_grad,
    csr_logits,
    logistic_loss,
)
