"""Applications. Only linear_method is ported so far."""
