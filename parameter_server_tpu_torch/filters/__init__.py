"""Ingest filters. Only the frequency filter of the training ingest is
ported so far; the wire codecs are not imported here."""

from parameter_server_tpu_torch.filters.frequency import CountMinSketch  # noqa: F401
