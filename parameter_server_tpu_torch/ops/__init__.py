"""Device compute: CSR segment sums and the hand-written FTRL kernels."""

from parameter_server_tpu_torch.ops.sparse import (  # noqa: F401
    csr_grad,
    csr_logits,
    logistic_loss,
)
