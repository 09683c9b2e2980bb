"""Lossless 16-bit PCM payload packing for the host→device boundary.

Audio that came from 16-bit PCM (the dominant real source: WAV/stdin
wrappers decode int16, reference match.py:253-265) is exactly
representable as int16/32768, so the section can cross the host→device
boundary as int16 sample pairs bit-packed into half as many f32 lanes and
be unpacked in-graph — halving transfer bytes with bit-exact results.

The pack is attempted per chunk and abandoned (returning None) whenever
any sample is not exactly int16/32768 — e.g. ffmpeg float sources, 24/32
bit WAVs, resampled streams — so enabling it never changes results.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from numpy.typing import NDArray

PCM_SCALE = 32768.0

# Result of the one-per-process device round-trip probe (None = not yet run).
_ROUNDTRIP_OK: bool | None = None


def packed_upload_supported() -> bool:
    """True iff packed uploads round-trip bit-exactly on this runtime.

    Packed int16 pairs whose odd-index sample is near full scale (hi int16
    in 0x7F80-0x7FFF / 0xFF80-0xFFFF) produce f32 lanes whose bit pattern
    is a NaN; a transfer layer that canonicalises NaN payloads would
    silently corrupt those samples. Rather than trusting the backend, this
    sends a sentinel section containing every hazardous pattern class
    through the real device unpack once per process and compares
    bit-for-bit; callers (PatternBank) auto-disable packing on mismatch.
    """
    global _ROUNDTRIP_OK
    if _ROUNDTRIP_OK is None:
        # Pairs (even, odd) covering: +NaN / -NaN payloads (quiet + the
        # 0x7F80/0xFF80 infinity edge), full-scale extremes, subnormal-range
        # patterns, and ordinary values.
        pairs = np.array(
            [
                [1, 0x7FC0],  # hi 0x7FC0: quiet-NaN bit pattern
                [-1, 0x7F80],  # hi 0x7F80: +inf bit pattern
                [0x7FFF, 0x7FFF],  # +full scale (signalling-NaN range)
                [-0x8000, -0x8000],  # -full scale
                [0x1234, -0x0040],  # hi 0xFFC0: negative quiet NaN
                [0, -0x0080],  # hi 0xFF80: -inf bit pattern
                [1234, 42],  # ordinary values
                [0x0001, 0x0000],  # subnormal f32 pattern
            ],
            dtype=np.int16,
        )
        flat = pairs.reshape(-1).astype(np.float32) / np.float32(PCM_SCALE)
        packed = try_pack_pcm16(flat)
        if packed is None:  # pragma: no cover - sentinel is PCM-exact
            _ROUNDTRIP_OK = False
        else:
            # A failing device call raises: only a bit mismatch turns
            # packing off.
            out = np.asarray(jax.jit(unpack_pcm16)(jnp.asarray(packed)))
            _ROUNDTRIP_OK = bool(
                out.shape == flat.shape
                and np.array_equal(out.view(np.uint32), flat.view(np.uint32))
            )
    return _ROUNDTRIP_OK


def try_pack_pcm16(section: NDArray[np.float32]) -> NDArray[np.float32] | None:
    """(S,) f32 → (S/2,) f32 carrying int16 pairs, or None if lossy.

    S must be even (section lengths are sample-rate multiples). The check
    is exact up to zero sign: a packed upload followed by
    :func:`unpack_pcm16` reproduces every input VALUE, with ``-0.0``
    canonicalised to ``+0.0`` (int16 0 unpacks positive). That is the
    one representable bit difference, and it is invisible downstream:
    -0.0 == +0.0 in every comparison, and both the correlation pipeline
    (``abs`` before any consumer) and loudness (squares) erase zero
    signs before anything sign-sensitive — quantised host audio (e.g.
    ``np.round`` of small negatives) routinely carries -0.0, so
    refusing it would silently disable packing on real PCM-grid
    streams. Pinned by test_packing.py::test_negative_zero_canonicalises.
    """
    if len(section) % 2:
        return None
    from audio_pattern_detector_tpu import native

    out = np.empty(len(section), dtype=np.int16)
    ok = native.pack_pcm16_into(section, out)
    if ok is not None:
        # Single-pass C++ quantise+check (same semantics, ~8x faster on
        # production sections; pinned by test_packing.py's fuzz rung).
        return out.view(np.float32) if ok else None
    q = np.round(section * PCM_SCALE)
    if not (
        (q >= -32768).all()
        and (q <= 32767).all()
        and (q == section * PCM_SCALE).all()
    ):
        return None
    return q.astype(np.int16).view(np.float32)


def unpack_pcm16(packed: jnp.ndarray) -> jnp.ndarray:
    """Device-side inverse: (S/2,) f32 bit patterns → (S,) f32 samples."""
    u = jax.lax.bitcast_convert_type(packed, jnp.uint32)
    lo = (u & jnp.uint32(0xFFFF)).astype(jnp.uint16).astype(jnp.int16)
    hi = (u >> jnp.uint32(16)).astype(jnp.uint16).astype(jnp.int16)
    pairs = jnp.stack(
        [lo.astype(jnp.float32), hi.astype(jnp.float32)], axis=1
    )
    return pairs.reshape(-1) * jnp.float32(1.0 / PCM_SCALE)
