"""Device BS.1770 loudness + normalisation (JAX, fixed shapes).

Device re-architecture of the reference's sequential loudness path
(reference: native-helper/src/lib.rs:84-214): the K-weighting biquad cascade
— the one true sequential scan in the system — is replaced by an FFT
convolution against a truncated impulse response (derived on host in f64 by
``hostref.k_weighting_fir``; the 38 Hz pole decays below 1e-12 within a few
thousand samples, so the truncation error is under float32 resolution).
Gating blocks are computed as static gather windows so the whole op is one
fused, shape-static XLA program that handles any valid length ``n <= S`` via
masking (full chunks, the first lookback-free chunk, and the final short
chunk all share one executable).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from audio_pattern_detector_tpu.ops import hostref
from audio_pattern_detector_tpu.ops._pytree import as_i32, host_const, int_const, static_field
from audio_pattern_detector_tpu.ops.slicing import slice_shared_windows

LUFS_OFFSET = -0.691
ABSOLUTE_GATE_LUFS = -70.0
DEFAULT_TARGET_LUFS = -16.0
_FIR_TAPS = 4096

# Same FFT-size rule as the correlation geometry (single-sourced there).
from audio_pattern_detector_tpu.ops.correlate import next_pow2 as _next_pow2  # noqa: E402,E501


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class LoudnessConsts:
    """Host-precomputed constants for a (section_len, sample_rate) pair."""

    # FIR spectrum as stacked (real, imag) f32; _fir_spec() forms
    # complex64 in-graph.
    fir_rfft_ri: jnp.ndarray  # (2, fft_len//2 + 1) f32
    block_lo: jnp.ndarray  # (max_blocks,) int32 — static block starts
    block_end: jnp.ndarray  # (max_blocks,) int32 — static block ends (pre-clamp)
    # (max_blocks,) int32 — block_thr[j] is the smallest n with
    # hostref.num_gating_blocks(n) >= j+1, precomputed with the SAME f64
    # expression the host/reference uses. The in-graph block count is
    # sum(n_valid >= block_thr): bitwise the host's f64 rounding, which an
    # integer-exact rational formula is NOT (the f64 value of
    # (n/sr - 0.4)/0.1 rounds differently from the exact rational at every
    # exact-half grid point, in a direction that varies with n).
    block_thr: jnp.ndarray
    section_len: int = static_field()
    sample_rate: int = static_field()
    fft_len: int = static_field()
    window_width: int = static_field()  # >= max block width
    short_threshold: int = static_field()  # single-block path below
    num_segments: int = static_field(default=1)  # overlap-save conv segments


def build_loudness_consts(
    section_len: int, sample_rate: int, overlap_save: bool = True
) -> LoudnessConsts:
    """Precompute FIR spectrum and gating-block geometry for a section size."""
    rate = float(sample_rate)
    t_g = 0.4
    fir = hostref.k_weighting_fir(rate, _FIR_TAPS)
    whole = _next_pow2(section_len + _FIR_TAPS - 1)
    if overlap_save:
        fft_len = _next_pow2(4 * _FIR_TAPS)
        if fft_len >= whole:
            fft_len, num_segments = whole, 1
        else:
            step = fft_len - _FIR_TAPS + 1
            num_segments = -(-section_len // step)
    else:
        fft_len, num_segments = whole, 1
    spec = np.fft.rfft(fir, fft_len).astype(np.complex64)
    fir_rfft_ri = host_const(np.stack([spec.real, spec.imag]), np.float32)

    max_blocks = max(hostref.num_gating_blocks(section_len, rate, t_g), 1)
    window_samples = t_g * rate
    hop_samples = window_samples * 0.25
    j = np.arange(max_blocks, dtype=np.float64)
    lo = (j * hop_samples).astype(np.int64)
    end = (j * hop_samples + window_samples).astype(np.int64)
    width = int((end - lo).max())

    # Inverse of the host's f64 block count as a threshold table:
    # block_thr[k] = smallest n with num_gating_blocks(n) >= k+1. The f64
    # count is monotone in n, so each boundary is found by a short forward
    # scan from its rational seed (the f64 rounding can shift it by a few
    # samples either way).
    block_thr = np.empty(max_blocks, dtype=np.int64)
    for k in range(max_blocks):
        n = max(int((0.1 * (k - 0.5) + t_g) * rate) - 8, 0)
        while hostref.num_gating_blocks(n, rate, t_g) < k + 1:
            n += 1
        block_thr[k] = n

    return LoudnessConsts(
        section_len=section_len,
        sample_rate=sample_rate,
        fft_len=fft_len,
        num_segments=num_segments,
        fir_rfft_ri=fir_rfft_ri,
        block_lo=int_const(lo),
        block_end=int_const(end),
        block_thr=int_const(block_thr),
        window_width=width,
        short_threshold=int(math.ceil(0.5 * sample_rate)),
    )


def _fir_spec(consts: LoudnessConsts) -> jnp.ndarray:
    """complex64 FIR spectrum formed in-graph from the f32 (re, im) leaf."""
    return jax.lax.complex(consts.fir_rfft_ri[0], consts.fir_rfft_ri[1])


def _k_weighted_conv(section: jnp.ndarray, consts: LoudnessConsts) -> jnp.ndarray:
    """K-weighting FIR convolution, whole-signal or overlap-save."""
    S = consts.section_len
    N = consts.fft_len
    if consts.num_segments == 1:
        spec = jnp.fft.rfft(section, n=N)
        return jnp.fft.irfft(spec * _fir_spec(consts), n=N)[:S]
    # Overlap-save convolution: discard the first taps-1 wrapped outputs of
    # each segment; segment j (padded coords, left pad taps-1) yields
    # y[j·step : (j+1)·step).
    taps = _FIR_TAPS
    step = N - taps + 1
    ns = consts.num_segments
    padded = jnp.pad(section, (taps - 1, ns * step + N - (S + taps - 1)))
    starts = jnp.arange(ns, dtype=jnp.int32) * step
    segments = slice_shared_windows(padded, starts, N)  # (ns, N) slice-gather
    z = jnp.fft.irfft(jnp.fft.rfft(segments, axis=1) * _fir_spec(consts), n=N, axis=1)
    return z[:, taps - 1 :].reshape(ns * step)[:S]


def integrated_loudness_device(
    section: jnp.ndarray, n_valid: jnp.ndarray, consts: LoudnessConsts
) -> jnp.ndarray:
    """Gated integrated loudness (LUFS, f32; -inf for silence) of
    ``section[:n_valid]``; samples at and beyond ``n_valid`` must be zero."""
    n_valid = jnp.asarray(n_valid).astype(jnp.int32)
    S = consts.section_len
    idx = jnp.arange(S, dtype=jnp.int32)

    # K-weighting as FFT convolution; mask the filter ringing that bleeds
    # past the true signal end.
    filtered = _k_weighted_conv(section, consts)
    sq = jnp.where(idx < n_valid, filtered * filtered, 0.0).astype(jnp.float32)

    total = jnp.sum(sq)
    n_f = n_valid.astype(jnp.float32)

    # Short path (< 0.5 s): reference passes block_size = section seconds,
    # yielding exactly one gating block = the whole signal
    # (reference: audio_pattern_detector.py:416-418, lib.rs:148-178).
    ms_short = total / jnp.maximum(n_f, 1.0)
    lufs_short = jnp.where(
        ms_short > 0.0, LUFS_OFFSET + 10.0 * jnp.log10(ms_short), -jnp.inf
    )
    lufs_short = jnp.where(lufs_short >= ABSOLUTE_GATE_LUFS, lufs_short, -jnp.inf)

    # Gated path: static block windows, masked to the dynamic signal length.
    B = consts.block_lo.shape[0]
    W = consts.window_width
    # Block count via the precomputed f64-exact threshold table: bitwise
    # the host/reference rounding for every n (see LoudnessConsts.block_thr).
    num_blocks = jnp.sum((n_valid >= as_i32(consts.block_thr)).astype(jnp.int32))
    block_lo = as_i32(consts.block_lo)
    block_end = as_i32(consts.block_end)
    hi = jnp.minimum(block_end, n_valid)  # (B,)
    # Contiguous block windows via slice-gather (see ops/slicing.py).
    sqp = jnp.pad(sq, (0, W))
    starts = jnp.minimum(block_lo, S - 1)
    gathered = slice_shared_windows(sqp, starts, W)  # (B, W)
    win_idx = starts[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    in_window = win_idx < hi[:, None]
    block_sum = jnp.sum(jnp.where(in_window, gathered, 0.0), axis=1)  # (B,)
    count = (hi - block_lo).astype(jnp.float32)
    block_valid = (
        (jnp.arange(B, dtype=jnp.int32) < num_blocks)
        & (block_lo < hi)
        & (block_sum > 0.0)
    )
    ms = block_sum / jnp.maximum(count, 1.0)
    loud = LUFS_OFFSET + 10.0 * jnp.log10(jnp.maximum(ms, 1e-38))

    abs_mask = block_valid & (loud >= ABSOLUTE_GATE_LUFS)
    abs_count = jnp.sum(abs_mask)
    z_avg = jnp.sum(jnp.where(abs_mask, ms, 0.0)) / jnp.maximum(abs_count, 1)
    gamma_r = LUFS_OFFSET + 10.0 * jnp.log10(jnp.maximum(z_avg, 1e-38)) - 10.0

    rel_mask = abs_mask & (loud > gamma_r)
    rel_count = jnp.sum(rel_mask)
    z_final = jnp.sum(jnp.where(rel_mask, ms, 0.0)) / jnp.maximum(rel_count, 1)
    lufs_gated = LUFS_OFFSET + 10.0 * jnp.log10(jnp.maximum(z_final, 1e-38))
    lufs_gated = jnp.where((abs_count > 0) & (rel_count > 0), lufs_gated, -jnp.inf)

    return jnp.where(n_valid < consts.short_threshold, lufs_short, lufs_gated)


def loudness_normalize_device(
    section: jnp.ndarray, lufs: jnp.ndarray, target_lufs: float = DEFAULT_TARGET_LUFS
) -> jnp.ndarray:
    """Gain to target LUFS, hard clip to [-1, 1], NaN scrubbed to zero.

    Matches the reference composition of loudness_normalize + nan_to_num
    (reference: lib.rs:220-227 then audio_pattern_detector.py:489-490):
    -inf input loudness yields infinite gain, so non-zero samples saturate to
    ±1 and zero samples (0·inf = NaN) scrub to 0.
    """
    gain = jnp.power(jnp.float32(10.0), (target_lufs - lufs) / 20.0)
    y = jnp.clip(section * gain, -1.0, 1.0)
    return jnp.where(jnp.isnan(y), 0.0, y)
