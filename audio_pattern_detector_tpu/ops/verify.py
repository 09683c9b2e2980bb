"""Device Step-2 verifiers: masked, bank-batched candidate verification.

The reference verifies each candidate peak in branchy per-candidate Python
(reference: audio_pattern_detector.py:589-903, detection_utils.py:41-125).
Here each clip group's candidates are verified as one fixed-shape tensor
program vmapped over (bank, candidate): dead candidate lanes are masked,
never branched on.

* Normal path: zero-padded correlation slice around the peak, renormalised;
  10-partition MSE against the clip's self-correlation (min of whole/middle
  means, whole-only for short clips); max-preserving downsample of the
  centre window (partitions 4–6, or 0–10 for short clips) and Pearson r
  against the cached downsampled clip window; accept iff
  similarity <= 0.02 and r >= 0.90
  (reference: audio_pattern_detector.py:752-903).
* Marker-tone path: matched segment + both flanks as one contiguous 3m
  slice; whole-window Hann rfft band purity per segment; 25 ms / 50%-hop
  framed STFT over the matched segment with per-frame frequency lock and
  purity; six per-clip thresholds
  (reference: audio_pattern_detector.py:642-750, detection_utils.py:41-125).

All per-clip static structure (partition bounds, window-max segment
geometry, Hann windows, band masks, thresholds) is precomputed on host in
f64 and baked in as constants.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu.ops import hostref
from audio_pattern_detector_tpu.ops._pytree import (
    as_mask,
    host_const,
    mask_const,
    static_field,
)
from audio_pattern_detector_tpu.ops.slicing import (
    slice_rows_windows,
    slice_shared_windows,
)
from audio_pattern_detector_tpu.ops.tone import frame_grid

SIMILARITY_HARD_LIMIT = 0.02
PEARSON_R_THRESHOLD = 0.90
_PAD = 8  # slack covering the ±5 candidate bound overshoot

# Default marker-tone thresholds (reference: audio_pattern_detector.py:698-705).
_MARKER_DEFAULTS = {
    "minimum_band_purity": 0.95,
    "minimum_active_frame_ratio": 0.80,
    "minimum_longest_active_run": 9,
    "minimum_active_frame_mean_purity": 0.92,
    "maximum_min_flank_purity": 0.25,
    "maximum_max_flank_purity": 0.65,
}


def _pearson_batched(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Pearson r along the last axis; 0 where either side has no variance."""
    dx = x - jnp.mean(x, axis=-1, keepdims=True)
    dy = y - jnp.mean(y, axis=-1, keepdims=True)
    cov = jnp.sum(dx * dy, axis=-1)
    denom = jnp.sqrt(jnp.sum(dx * dx, axis=-1) * jnp.sum(dy * dy, axis=-1))
    return jnp.where(denom > 0.0, cov / jnp.maximum(denom, 1e-38), 0.0)


def _window_max_geometry(
    source_len: int, target_len: int
) -> tuple[NDArray[np.int64], NDArray[np.int64], int]:
    """(starts, ends, max_width) of the window-max resample bins."""
    starts, ends = hostref.resample_preserve_maxima_bounds(source_len, target_len)
    return starts, ends, int((ends - starts).max())


# ── Normal (MSE + Pearson) verifier ──────────────────────────────────


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NormalVerifyConsts:
    """Static structure for the normal/short-clip verifier of one group."""

    corr_clip_partitions: jnp.ndarray  # (G, 10, ps) f32
    ds_clip: jnp.ndarray  # (G, ds_n) f32 — exact host-downsampled clip window
    clip_len: int = static_field()  # m
    corr_len: int = static_field()  # Lc = 2m - 1
    is_short: bool = static_field()
    partition_size: int = static_field()  # Lc // 10
    win_lo: int = static_field()  # centre-window bounds (python round)
    win_hi: int = static_field()
    ds_n: int = static_field()  # downsample target (101 normal / 505 short)
    # Window-max resample as a sparse table: per-bin static indices into the
    # level-K shifted-max array (bin max = max(f[a], f[b]) with f[i] =
    # max over [i, i+2^K)); widths w..w+1 guarantee 2^K <= min_w and
    # max_w <= 2^(K+1) so two lookups cover each bin exactly.
    seg_a: tuple = static_field(default=())
    seg_b: tuple = static_field(default=())
    k_level: int = static_field(default=0)


def build_normal_verify_consts(
    correlation_clips: NDArray[np.float32],  # (G, 2m-1) normalised self-corr
    clip_len: int,
    sample_rate: int,
) -> NormalVerifyConsts:
    g, lc = correlation_clips.shape
    assert lc == 2 * clip_len - 1
    is_short = clip_len / sample_rate < 0.5
    ps = lc // 10

    # Centre Pearson window: partitions 4-6 (40-60%), or 0-10 for short clips
    # (reference: audio_pattern_detector.py:808-819); 'round' is Python's
    # banker's rounding, reproduced here on host.
    ds_base = 101
    if is_short:
        wl, wr, ds_n = 0, 10, round(ds_base * 10 / 2)
    else:
        wl, wr, ds_n = 4, 6, ds_base
    lo = round(lc * wl / 10)
    hi = round(lc * wr / 10)

    ds_clip = np.stack(
        [hostref.resample_preserve_maxima(cc[lo:hi], ds_n) for cc in correlation_clips]
    )
    starts, ends, _ = _window_max_geometry(hi - lo, ds_n)
    k_level = int(np.floor(np.log2(max(int((ends - starts).min()), 1))))
    seg_a = tuple(int(v) for v in starts)
    seg_b = tuple(int(v) for v in (ends - (1 << k_level)))

    return NormalVerifyConsts(
        clip_len=clip_len,
        corr_len=lc,
        is_short=is_short,
        partition_size=ps,
        corr_clip_partitions=host_const(
            correlation_clips[:, : 10 * ps].reshape(g, 10, ps), np.float32
        ),
        win_lo=lo,
        win_hi=hi,
        ds_n=ds_n,
        ds_clip=host_const(ds_clip, np.float32),
        seg_a=seg_a,
        seg_b=seg_b,
        k_level=k_level,
    )


def verify_normal(
    corr: jnp.ndarray,  # (G, L) normalised correlation, zeros >= valid_len
    pos: jnp.ndarray,  # (G, K) candidate 'full' indices
    alive: jnp.ndarray,  # (G, K) bool
    consts: NormalVerifyConsts,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (accept, similarity, pearson_r), each (G, K)."""
    g, l = corr.shape
    k = pos.shape[1]
    m = consts.clip_len
    lc = consts.corr_len
    ps = consts.partition_size

    corrp = jnp.pad(corr, ((0, 0), (_PAD + m - 1, _PAD + m)))
    start = jnp.clip(pos - (m - 1) + (_PAD + m - 1), 0, corrp.shape[1] - lc)
    slices = slice_rows_windows(corrp, start, lc)  # (G, K, lc)

    smax = jnp.max(slices, axis=-1, keepdims=True)
    slices = slices / jnp.maximum(smax, 1e-38)

    diffs = slices[:, :, : 10 * ps].reshape(g, k, 10, ps) - consts.corr_clip_partitions[:, None]
    mse = jnp.mean(diffs * diffs, axis=-1)  # (G, K, 10)
    sim_whole = jnp.mean(mse, axis=-1)
    sim_mid = jnp.mean(mse[:, :, 4:6], axis=-1)
    sim = sim_whole if consts.is_short else jnp.minimum(sim_whole, sim_mid)

    window = slices[:, :, consts.win_lo : consts.win_hi]  # (G, K, hi-lo)
    # Sparse-table window max: one reduce_window builds f[i] = max over
    # [i, i + 2^K), then two static-index lookups cover each resample bin
    # exactly (bin max = max(f[a], f[b])) — no element gather, and one op
    # where K rounds of shifted max would take K (bitwise-identical).
    # seg_a/seg_b always index the VALID region (every bin
    # width >= 2^K), so the -inf tail pad is shape-only.
    win = 1 << consts.k_level
    f = jax.lax.reduce_window(
        window, -jnp.inf, jax.lax.max, (1, 1, win), (1, 1, 1), "VALID"
    )
    f = jnp.pad(f, ((0, 0), (0, 0), (0, win - 1)), constant_values=-jnp.inf)
    seg_a = np.asarray(consts.seg_a, dtype=np.int32)
    seg_b = np.asarray(consts.seg_b, dtype=np.int32)
    ds_slice = jnp.maximum(f[..., seg_a], f[..., seg_b])  # (G, K, ds_n)
    r = _pearson_batched(ds_slice, consts.ds_clip[:, None, :])

    accept = alive & (sim <= SIMILARITY_HARD_LIMIT) & (r >= PEARSON_R_THRESHOLD)
    return accept, sim, r


# ── Marker-tone verifier ─────────────────────────────────────────────


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MarkerVerifyConsts:
    """Static structure for the marker-tone verifier of one group."""

    hann_whole: jnp.ndarray  # (m,) f32
    freqs_whole: jnp.ndarray  # (m//2 + 1,) f32
    band_whole: jnp.ndarray  # (G, m//2 + 1) bool
    dom_freq: jnp.ndarray  # (G,) f32
    lock_hz: jnp.ndarray  # (G,) f32
    hann_frame: jnp.ndarray  # (wl,) f32
    freqs_frame: jnp.ndarray  # (wl//2 + 1,) f32
    band_frame: jnp.ndarray  # (G, wl//2 + 1) bool
    thresholds: jnp.ndarray  # (G, 6) f32 ordered as _MARKER_DEFAULTS keys
    clip_len: int = static_field()  # m
    sample_rate: int = static_field()
    frame_len: int = static_field()
    frame_count: int = static_field()
    frame_starts: tuple = static_field(default=())  # (F,) static sample offsets


def build_marker_verify_consts(
    clip_len: int,
    sample_rate: int,
    dominant_frequencies: NDArray[np.float64],  # (G,)
    verification_params: "list[dict[str, float | int]]",  # per clip overrides
) -> MarkerVerifyConsts:
    m = clip_len
    g = len(dominant_frequencies)
    dom = np.asarray(dominant_frequencies, dtype=np.float64)
    band_hz = np.maximum(40.0, dom * 0.08)
    lock_hz = np.maximum(20.0, dom * 0.04)

    freqs_whole = np.fft.rfftfreq(m, d=1.0 / sample_rate)
    band_whole = np.abs(freqs_whole[None, :] - dom[:, None]) <= band_hz[:, None]

    wl, hop, f_count = frame_grid(m, sample_rate)
    freqs_frame = np.fft.rfftfreq(wl, d=1.0 / sample_rate)
    band_frame = np.abs(freqs_frame[None, :] - dom[:, None]) <= band_hz[:, None]
    starts = np.arange(f_count, dtype=np.int64) * hop

    thresholds = np.empty((g, 6), dtype=np.float64)
    for i, params in enumerate(verification_params):
        v = params if isinstance(params, dict) else {}
        for j, key in enumerate(_MARKER_DEFAULTS):
            thresholds[i, j] = float(v.get(key, _MARKER_DEFAULTS[key]))

    return MarkerVerifyConsts(
        clip_len=m,
        sample_rate=sample_rate,
        hann_whole=host_const(np.hanning(m), np.float32),
        freqs_whole=host_const(freqs_whole, np.float32),
        band_whole=mask_const(band_whole),
        dom_freq=host_const(dom, np.float32),
        lock_hz=host_const(lock_hz, np.float32),
        frame_len=wl,
        frame_count=f_count,
        frame_starts=tuple(int(v) for v in starts),
        hann_frame=host_const(np.hanning(wl), np.float32),
        freqs_frame=host_const(freqs_frame, np.float32),
        band_frame=mask_const(band_frame),
        thresholds=host_const(thresholds, np.float32),
    )


def marker_windows(
    section: jnp.ndarray,  # (S,) normalised, NaN-scrubbed section
    pos: jnp.ndarray,  # (G, K) candidate 'full' indices
    consts: MarkerVerifyConsts,
) -> tuple[jnp.ndarray, jnp.ndarray | None]:
    """The Hann-windowed slices the marker verifier transforms.

    Returns ``(whole, frames)``: ``whole`` (G, K, 3, m) is the
    [left flank | match | right flank] slice, each segment multiplied by
    the whole-window Hann; ``frames`` (G, K, F, wl) is the matched
    segment's 25 ms frames times the frame Hann, or None when the clip is
    shorter than one frame.
    """
    g, k = pos.shape
    m = consts.clip_len
    # match_start = peak - m + 1 in section coordinates equals the lag
    # (reference: audio_pattern_detector.py:650-653); left flank + match +
    # right flank form one contiguous [lag - m, lag + 2m) slice.
    lag = pos - (m - 1)
    secp = jnp.pad(section, (m + _PAD, m + _PAD))
    start = jnp.clip(lag + _PAD, 0, secp.shape[0] - 3 * m)
    seg3 = slice_shared_windows(secp, start, 3 * m).reshape(
        g, k, 3, m
    )  # [left|match|right]
    if consts.frame_count == 0:
        return seg3 * consts.hann_whole, None
    seg_match = seg3[:, :, 1, :]  # (G, K, m)
    wl = consts.frame_len
    frames = jnp.stack(
        [seg_match[:, :, s0 : s0 + wl] for s0 in consts.frame_starts],
        axis=2,
    ) * consts.hann_frame  # (G, K, F, wl) — static slices, no gather
    return seg3 * consts.hann_whole, frames


def marker_spectra(
    section: jnp.ndarray,
    pos: jnp.ndarray,
    consts: MarkerVerifyConsts,
) -> tuple[jnp.ndarray, jnp.ndarray | None]:
    """|rfft| of :func:`marker_windows`' slices: (G, K, 3, m//2+1) and
    (G, K, F, wl//2+1) (or None). The verifier's only spectra."""
    whole, frames = marker_windows(section, pos, consts)
    spec = jnp.abs(jnp.fft.rfft(whole, axis=-1))
    if frames is None:
        return spec, None
    return spec, jnp.abs(jnp.fft.rfft(frames, axis=-1))


def verify_marker(
    section: jnp.ndarray,  # (S,) normalised, NaN-scrubbed section
    pos: jnp.ndarray,  # (G, K) candidate 'full' indices
    alive: jnp.ndarray,  # (G, K) bool
    consts: MarkerVerifyConsts,
) -> jnp.ndarray:
    """Returns accept mask (G, K)."""
    g, k = pos.shape
    spec, fspec = marker_spectra(section, pos, consts)

    # Whole-window spectra for all three segments. The purity ratios only
    # need the POWER spectrum; argmax runs on the magnitude, not its
    # square: squaring can collapse near-tied f32 magnitudes and shift the
    # tie-break index.
    power = spec * spec
    match_arg = jnp.argmax(spec[:, :, 1, :], axis=-1)
    energy = jnp.sum(power, axis=-1)  # (G, K, 3)
    band_energy = jnp.sum(
        jnp.where(as_mask(consts.band_whole)[:, None, None, :], power, 0.0), axis=-1
    )
    purity = jnp.where(energy > 0.0, band_energy / jnp.maximum(energy, 1e-38), 0.0)
    purity_left, purity_match, purity_right = (
        purity[:, :, 0],
        purity[:, :, 1],
        purity[:, :, 2],
    )

    detected = consts.freqs_whole[match_arg]  # (G, K)
    dom = consts.dom_freq[:, None]
    freq_ok = jnp.abs(detected - dom) <= 0.05 * jnp.maximum(jnp.abs(detected), dom)

    # Framed 25 ms STFT over the matched segment only (flank metrics use the
    # whole-window purity alone; reference: audio_pattern_detector.py:686-693).
    if fspec is not None:
        fpow = fspec * fspec
        ffreq_arg = jnp.argmax(fspec, axis=-1)
        fenergy = jnp.sum(fpow, axis=-1)  # (G, K, F)
        nonzero = fenergy > 0.0
        fband = jnp.sum(
            jnp.where(as_mask(consts.band_frame)[:, None, None, :], fpow, 0.0), axis=-1
        )
        fpur = jnp.where(nonzero, fband / jnp.maximum(fenergy, 1e-38), 0.0)
        ffreq = consts.freqs_frame[ffreq_arg]
        locked = jnp.abs(ffreq - dom[..., None]) <= consts.lock_hz[:, None, None]
        active = nonzero & locked & (fpur >= 0.55)

        frame_count = jnp.sum(nonzero, axis=-1)  # (G, K)
        active_count = jnp.sum(active, axis=-1)
        # Longest consecutive active run: distance to the last inactive frame.
        fpos = jnp.arange(consts.frame_count, dtype=jnp.int32)
        last_inactive = jax.lax.cummax(jnp.where(~active, fpos, -1), axis=2)
        run_len = fpos - last_inactive
        longest_run = jnp.max(jnp.where(active, run_len, 0), axis=-1)
        mean_purity = jnp.where(
            active_count > 0,
            jnp.sum(jnp.where(active, fpur, 0.0), axis=-1)
            / jnp.maximum(active_count, 1),
            0.0,
        )
        ratio = jnp.where(
            frame_count > 0, active_count / jnp.maximum(frame_count, 1), 0.0
        )
    else:
        ratio = jnp.zeros((g, k), dtype=jnp.float32)
        longest_run = jnp.zeros((g, k), dtype=jnp.int32)
        mean_purity = jnp.zeros((g, k), dtype=jnp.float32)

    t = consts.thresholds[:, None, :]  # (G, 1, 6)
    min_flank = jnp.minimum(purity_left, purity_right)
    max_flank = jnp.maximum(purity_left, purity_right)
    embedded = (
        (purity_match >= t[..., 0])
        & (ratio >= t[..., 1])
        & (longest_run >= t[..., 2])
        & (mean_purity >= t[..., 3])
        & (min_flank <= t[..., 4])
        & (max_flank <= t[..., 5])
    )
    return alive & freq_ok & embedded
