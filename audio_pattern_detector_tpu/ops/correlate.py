"""Device Step-1 kernel: bank-batched FFT cross-correlation.

Device replacement for the reference's per-clip Python loop around the
native ``fft_correlate_1d`` call (reference: audio_pattern_detector.py:306-313,
487-494): the section is transformed once (`rfft`), multiplied against the
precomputed conjugate bank spectra, and inverse-transformed for the whole
bank in one launch. Output is laid out in the 'full' correlation ordering
(index k = lag + m - 1) so downstream peak indices match the reference
bit-for-bit in index space.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu.ops._pytree import host_const, static_field
from audio_pattern_detector_tpu.ops.slicing import slice_shared_windows


def next_pow2(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CorrelationBankConsts:
    """Precomputed spectra for one clip group (uniform clip length m).

    Two execution modes share this structure:

    * ``fft_len == full FFT size``: one rfft of the whole section,
      bank-multiplied, one big irfft per clip.
    * overlap-save (``num_segments > 1``): the section splits into
      overlapping segments of ``fft_len`` with hop ``fft_len - m + 1``;
      segment spectra are shared across the bank and each clip does small
      batched irffts. Fewer FLOPs (no double-length padding) than one
      mega-FFT.
    """

    # conj bank spectra as stacked (real, imag) f32; _bank_spec() forms
    # complex64 in-graph.
    bank_rfft_conj_ri: jnp.ndarray  # (2, G, fft_len//2 + 1) f32
    self_corr_max: jnp.ndarray  # (G,) f32 — abs max of each clip's
    # self-correlation (reference: audio_pattern_detector.py:373-383)
    clip_len: int = static_field()  # m
    section_len: int = static_field()  # S (padded host section length)
    fft_len: int = static_field()  # segment/whole FFT size
    full_len: int = static_field()  # L = S + m - 1
    num_segments: int = static_field(default=1)  # 1 = single-FFT mode
    # Shared-geometry fields: when several groups of one class share one
    # segment decomposition (one section FFT for the whole class), the
    # geometry is sized for the class's largest clip (m_max) and each
    # group's 'full'-ordered output starts m_max - m into the flat lag
    # stream. Defaults reproduce the per-group geometry.
    step: int = static_field(default=0)  # 0 → fft_len - clip_len + 1
    pad_left: int = static_field(default=-1)  # -1 → clip_len - 1
    out_offset: int = static_field(default=0)  # m_max - m


def _overlap_save_geometry(section_len: int, m: int) -> tuple[int, int, int]:
    """(fft_len, step, num_segments) for overlap-save correlation."""
    fft_len = next_pow2(max(4 * m, 8192))
    whole = next_pow2(section_len + m - 1)
    if fft_len >= whole:
        return whole, 0, 1
    step = fft_len - m + 1
    full_len = section_len + m - 1
    num_segments = -(-full_len // step)
    return fft_len, step, num_segments


def class_overlap_save_geometry(
    section_len: int, clip_lens: list[int]
) -> "tuple[int, int, int, int] | None":
    """Shared (fft_len, step, num_segments, m_max) for one class's groups.

    Sized for the largest clip, so every group's circular segments are
    wrap-free over the shared ``step = fft_len - m_max + 1`` lag window and
    the section's segment FFT is computed ONCE per chunk for the whole
    class. Returns None when the section is small enough that the single-
    FFT mode applies (groups then keep their per-group geometry)."""
    m_max = max(clip_lens)
    fft_len, step, num_segments = _overlap_save_geometry(section_len, m_max)
    if num_segments <= 1:
        return None
    return fft_len, step, num_segments, m_max


def build_correlation_bank(
    clips: NDArray[np.float32],  # (G, m) loudness-normalised clips
    self_corr_max: NDArray[np.floating],
    section_len: int,
    overlap_save: bool = True,
    shared_geometry: "tuple[int, int, int, int] | None" = None,
) -> CorrelationBankConsts:
    g, m = clips.shape
    step = 0
    pad_left = -1
    out_offset = 0
    if shared_geometry is not None and overlap_save:
        fft_len, step, num_segments, m_max = shared_geometry
        assert m <= m_max, (m, m_max)
        pad_left = m_max - 1
        out_offset = m_max - m
    elif overlap_save:
        fft_len, _, num_segments = _overlap_save_geometry(section_len, m)
    else:
        fft_len, num_segments = next_pow2(section_len + m - 1), 1
    bank = np.fft.rfft(clips.astype(np.float64), n=fft_len, axis=1).conj()
    return CorrelationBankConsts(
        clip_len=m,
        section_len=section_len,
        fft_len=fft_len,
        full_len=section_len + m - 1,
        num_segments=num_segments,
        step=step,
        pad_left=pad_left,
        out_offset=out_offset,
        bank_rfft_conj_ri=host_const(
            np.stack([bank.real, bank.imag]).astype(np.float32), np.float32
        ),
        self_corr_max=host_const(self_corr_max, np.float32),
    )


def _bank_spec(consts: "CorrelationBankConsts") -> jnp.ndarray:
    """complex64 conj bank spectra formed in-graph from the f32 leaf."""
    return jax.lax.complex(
        consts.bank_rfft_conj_ri[0], consts.bank_rfft_conj_ri[1]
    )


def section_segment_spectra(
    section: jnp.ndarray, consts: CorrelationBankConsts
) -> jnp.ndarray:
    """rfft of the section's overlap-save segments — (ns, N//2+1) c64.

    With a class-shared geometry this is computed ONCE per chunk and reused
    by every group's :func:`bank_correlate`."""
    N = consts.fft_len
    step = consts.step or (N - consts.clip_len + 1)
    pad_left = consts.pad_left if consts.pad_left >= 0 else consts.clip_len - 1
    ns = consts.num_segments
    padded = jnp.pad(section, (pad_left, ns * step + N - (len(section) + pad_left)))
    starts = jnp.arange(ns, dtype=jnp.int32) * step
    segments = slice_shared_windows(padded, starts, N)  # (ns, N) slice-gather
    return jnp.fft.rfft(segments, axis=1)


def _correlate_raw(
    section: jnp.ndarray,
    consts: CorrelationBankConsts,
    seg_spec: "jnp.ndarray | None" = None,
) -> jnp.ndarray:
    """|full cross-correlation| (G, L), unnormalised."""
    m = consts.clip_len
    N = consts.fft_len
    L = consts.full_len

    if consts.num_segments == 1:
        spec = jnp.fft.rfft(section, n=N)  # (N//2+1,) c64
        # Lag-domain circular correlation z[l] = sum_i section[i+l]·clip[i];
        # rolling by (m-1) lays it out in 'full' ordering (k = lag + m - 1).
        z = jnp.fft.irfft(spec[None, :] * _bank_spec(consts), n=N, axis=1)
        return jnp.abs(jnp.roll(z, m - 1, axis=1)[:, :L])

    # Overlap-save: segment j starts at padded offset j·step; its circular
    # correlation with the clip is wrap-free for the first N - m + 1 lags
    # (the shared-geometry step = N - m_max + 1 is within that for every
    # group). Padded lag l maps to 'full' index k = l - out_offset, where
    # out_offset = pad_left - (m - 1) (0 for per-group geometry).
    step = consts.step or (N - m + 1)
    ns = consts.num_segments
    if seg_spec is None:
        seg_spec = section_segment_spectra(section, consts)
    y = jnp.fft.irfft(
        seg_spec[None, :, :] * _bank_spec(consts)[:, None, :], n=N, axis=2
    )  # (G, ns, N)
    flat = y[:, :, :step].reshape(y.shape[0], ns * step)
    off = consts.out_offset
    return jnp.abs(flat[:, off : off + L])


def _finalize_correlation(
    corr: jnp.ndarray,  # (G, L) |full correlation|, unnormalised
    n_valid: jnp.ndarray,
    consts: CorrelationBankConsts,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mask past valid_len and normalise by max(self_max, observed max)
    (reference: audio_pattern_detector.py:487-494)."""
    m = consts.clip_len
    L = consts.full_len
    valid_len = jnp.asarray(n_valid).astype(jnp.int32) + (m - 1)
    in_range = jnp.arange(L, dtype=jnp.int32)[None, :] < valid_len
    corr = jnp.where(in_range, corr, 0.0)

    observed_max = jnp.max(corr, axis=1)  # (G,)
    denom = jnp.maximum(consts.self_corr_max, observed_max)
    corr = corr / jnp.maximum(denom, 1e-38)[:, None]
    return corr, valid_len


def bank_correlate(
    section: jnp.ndarray,  # (S,) f32 — normalised, NaN-scrubbed, zero-padded
    n_valid: jnp.ndarray,  # int32 — true sample count
    consts: CorrelationBankConsts,
    seg_spec: "jnp.ndarray | None" = None,  # precomputed section spectra
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """abs full cross-correlation of the section against the whole bank.

    Returns (corr, valid_len):
      corr:      (G, L) f32, |correlate(section, clip_g, 'full')| normalised
                 by max(self_corr_max_g, observed_max_g)
                 (reference: audio_pattern_detector.py:487-494), zeroed at
                 positions >= valid_len.
      valid_len: int32 — n_valid + m - 1, the true 'full' length.
    """
    corr = _correlate_raw(section, consts, seg_spec)
    return _finalize_correlation(corr, n_valid, consts)


def _multi_group_abs(
    consts_list: "list[CorrelationBankConsts] | tuple",
    seg_spec: jnp.ndarray,
):
    """Shared core of the merged-irfft variants: ONE batched inverse
    transform for every group of a shared-geometry class, yielding each
    group's raw |corr| slab. Requires identical class geometry
    (fft_len/step/num_segments), which ``PatternBank`` guarantees via
    ``class_overlap_save_geometry``."""
    first = consts_list[0]
    N, ns, step = first.fft_len, first.num_segments, first.step
    assert step > 0 and ns > 1
    for c in consts_list:
        assert (c.fft_len, c.step, c.num_segments) == (N, step, ns)

    cat = jnp.concatenate(
        [_bank_spec(c) for c in consts_list], axis=0
    )  # (sum G, N//2+1)
    y = jnp.fft.irfft(
        seg_spec[None, :, :] * cat[:, None, :], n=N, axis=2
    )  # (sum G, ns, N)
    flat = y[:, :, :step].reshape(y.shape[0], ns * step)

    g0 = 0
    for c in consts_list:
        g = c.bank_rfft_conj_ri.shape[1]
        off = c.out_offset
        yield c, jnp.abs(flat[g0 : g0 + g, off : off + c.full_len])
        g0 += g


def bank_correlate_multi(
    n_valid: jnp.ndarray,
    consts_list: "list[CorrelationBankConsts] | tuple",
    seg_spec: jnp.ndarray,  # (ns, N//2+1) shared section segment spectra
) -> list[tuple[jnp.ndarray, jnp.ndarray]]:
    """Every group of one shared-geometry class through ONE batched irfft
    (``APD_MERGED_IRFFT``): one inverse transform op per class instead of
    one per group. Results equal the per-group ``bank_correlate``."""
    return [
        _finalize_correlation(corr, n_valid, c)
        for c, corr in _multi_group_abs(consts_list, seg_spec)
    ]
