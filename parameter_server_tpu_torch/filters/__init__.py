"""Filters (reference analog: src/filter/).

Ported so far:

- ``CountMinSketch`` (``frequency.py``): the frequency filter of the
  training ingest.
- ``FixedPointCodec`` (``fixed_point.py``): the reference's fixing_float
  filter, per-array min/max int8/int16 payloads with stochastic rounding;
  its encode is the hand-written CUDA quantizer on the card.
- ``SegmentQuantizer`` and the device twins ``quantize_segments`` /
  ``dequantize_segments`` / ``dequantize_flat`` (``quant.py``): the wire
  codec with one symmetric scale per segment.
- ``ClientKeyCache`` (``keycache.py``): the serving plane's client-side
  versioned key-value cache, host numpy rows with exact push
  invalidation.
"""

from parameter_server_tpu_torch.filters.fixed_point import FixedPointCodec  # noqa: F401
from parameter_server_tpu_torch.filters.frequency import CountMinSketch  # noqa: F401
from parameter_server_tpu_torch.filters.keycache import ClientKeyCache  # noqa: F401
from parameter_server_tpu_torch.filters.quant import SegmentQuantizer  # noqa: F401
