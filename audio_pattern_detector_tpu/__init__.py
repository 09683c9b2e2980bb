"""audio_pattern_detector_tpu — accelerator-native streaming audio pattern detection.

A from-scratch JAX/XLA framework with the capabilities of the reference
``audio_pattern_detector`` project (streaming two-step audio pattern
detection: FFT cross-correlation candidate search + per-strategy
verification), re-architected for an accelerator:

* Step-1 correlation runs as one bank-batched ``rfft·conj·irfft`` launch per
  chunk instead of a per-clip Python loop.
* Step-2 verification (partitioned-MSE + multi-window Pearson, short-clip
  variant, marker-tone narrowband spectral check) runs as fixed-shape,
  masked, vmapped tensor programs.
* The sequential BS.1770 K-weighting IIR is replaced by an FFT convolution
  with a truncated impulse response (host-derived in f64), turning the one
  true scan in the system into a parallel op.
* Long streams scale across a ``jax.sharding.Mesh`` with halo exchange
  (the overlap-save algebra of the reference, distributed).

Public API mirrors the reference's library surface
(reference: audio_pattern_detector/__init__.py).
"""

from audio_pattern_detector_tpu.utils.clip import AudioClip, AudioStream
from audio_pattern_detector_tpu.models.detector import (
    DEFAULT_SECONDS_PER_CHUNK,
    MARKER_TONE_STRATEGY,
    SHORT_CLIP_DURATION_THRESHOLD,
    AudioPatternDetector,
    PatternDetectedCallback,
    StreamCheckpoint,
)
from audio_pattern_detector_tpu.models.multistream import MultiStreamSession

__version__ = "0.1.0"


def __getattr__(name: str):
    # Lazy: the serving layer pulls in the whole orchestration module
    # (match.py); library users who never serve shouldn't pay for it.
    if name == "PatternServer":
        from audio_pattern_detector_tpu.serve import PatternServer

        return PatternServer
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )


__all__ = [
    "AudioClip",
    "AudioStream",
    "AudioPatternDetector",
    "MultiStreamSession",
    "PatternServer",
    "PatternDetectedCallback",
    "StreamCheckpoint",
    "DEFAULT_SECONDS_PER_CHUNK",
    "SHORT_CLIP_DURATION_THRESHOLD",
    "MARKER_TONE_STRATEGY",
    "__version__",
]
