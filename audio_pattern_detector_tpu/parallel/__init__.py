"""Multi-chip scale-out: device meshes, sequence parallelism, bank sharding.

The reference is a single-threaded streaming pipeline (reference:
audio_pattern_detector.py:295-331); its only sequence-scaling mechanism is
overlap-save chunking with a per-clip lookback window (SURVEY.md §2.3).
This package distributes exactly that algebra over a ``jax.sharding.Mesh``:

* ``sequence`` — a long stream is sharded along time; each device prepends
  a halo of ``sliding_window`` seconds received from its left neighbour
  (``ppermute``), making every device's section identical to the
  serial engine's chunk section. A ``stream`` mesh axis adds data
  parallelism over independent streams.
* ``bankshard`` — the clip bank (the "model" dimension) is sharded across
  devices when it outgrows one device's memory.
"""

from audio_pattern_detector_tpu.parallel.bankshard import BankShardedBank
from audio_pattern_detector_tpu.parallel.mesh import make_mesh
from audio_pattern_detector_tpu.parallel.sequence import (
    ShardedDetector,
    detections_from_sharded,
)

__all__ = [
    "BankShardedBank",
    "make_mesh",
    "ShardedDetector",
    "detections_from_sharded",
]
