"""Host-side execution control. Only the SSP dispatch window is ported so
far; the SPMD tier, the backends and the wire tier are not."""
