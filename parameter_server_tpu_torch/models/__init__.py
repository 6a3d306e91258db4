"""Applications. linear_method and matrix_fac (single-device) are ported
so far."""
