"""Marker-tone verification semantics, host and device.

Mirrors the reference's direct verifier tests
(reference: tests/test_marker_tone_verification.py): clean embedded sines
accept; harmonic stacks, swept tones, and tone-adjacent (dirty-flank)
candidates reject. Also differentially checks the device verifier against
the host tone analyser.
"""

import io

import numpy as np
import pytest

from audio_pattern_detector_tpu.models.detector import (
    MARKER_TONE_STRATEGY,
    AudioPatternDetector,
)
from audio_pattern_detector_tpu.models.hostpath import _verify_marker_host
from audio_pattern_detector_tpu.ops.tone import analyze_pure_tone_candidate
from audio_pattern_detector_tpu.utils.clip import AudioClip, AudioStream

SR = 8000
FREQ = 1040.0
CLIP_SECONDS = 0.25
M = int(CLIP_SECONDS * SR)


def make_marker_clip(name="beep"):
    t = np.arange(M) / SR
    tone = np.sin(2 * np.pi * FREQ * t).astype(np.float32)
    return AudioClip(
        name=name,
        audio=tone,
        sample_rate=SR,
        strategy=MARKER_TONE_STRATEGY,
        strategy_params={"dominant_frequency_hz": FREQ},
    )


def section_with(candidate: np.ndarray, at: int, total: int, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    section = (noise * rng.standard_normal(total)).astype(np.float32)
    section[at : at + len(candidate)] += candidate
    return section


def peak_for(at: int) -> int:
    # 'full' correlation index of a match starting at sample `at`.
    return at + M - 1


class TestToneAnalyzer:
    def test_clean_sine_metrics(self):
        t = np.arange(M) / SR
        tone = np.sin(2 * np.pi * FREQ * t).astype(np.float32)
        m = analyze_pure_tone_candidate(tone, SR, FREQ)
        assert m.overall_band_purity > 0.95
        assert m.active_frame_ratio == 1.0
        assert m.longest_active_run >= 9
        assert abs(m.detected_frequency - FREQ) / FREQ < 0.05

    def test_silence_metrics(self):
        m = analyze_pure_tone_candidate(np.zeros(M, np.float32), SR, FREQ)
        assert m.overall_band_purity == 0.0
        assert m.active_frame_ratio == 0.0
        assert m.longest_active_run == 0

    def test_harmonic_stack_impure(self):
        t = np.arange(M) / SR
        stack = (
            np.sin(2 * np.pi * FREQ * t)
            + 0.8 * np.sin(2 * np.pi * 2 * FREQ * t)
            + 0.6 * np.sin(2 * np.pi * 3 * FREQ * t)
        ).astype(np.float32)
        m = analyze_pure_tone_candidate(stack, SR, FREQ)
        assert m.overall_band_purity < 0.95

    def test_swept_tone_loses_lock(self):
        t = np.arange(M) / SR
        swept = np.sin(2 * np.pi * (FREQ + 600 * t / CLIP_SECONDS) * t).astype(np.float32)
        m = analyze_pure_tone_candidate(swept, SR, FREQ)
        assert m.active_frame_ratio < 0.80

    def test_empty_input(self):
        m = analyze_pure_tone_candidate(np.zeros(0, np.float32), SR, FREQ)
        assert m.detected_frequency == 0.0


class TestHostMarkerVerifier:
    def _verify(self, section, at, thresholds=None):
        return _verify_marker_host(
            section, peak_for(at), M, FREQ, SR, thresholds or {}
        )

    def test_clean_isolated_tone_accepts(self):
        t = np.arange(M) / SR
        tone = 0.8 * np.sin(2 * np.pi * FREQ * t).astype(np.float32)
        section = section_with(tone, 3 * M, 10 * M)
        assert self._verify(section, 3 * M) is True

    def test_wrong_frequency_rejects(self):
        t = np.arange(M) / SR
        tone = 0.8 * np.sin(2 * np.pi * (FREQ * 1.2) * t).astype(np.float32)
        section = section_with(tone, 3 * M, 10 * M)
        assert self._verify(section, 3 * M) is False

    def test_dirty_flanks_reject(self):
        # Same-frequency energy extends well into both flanks.
        t = np.arange(3 * M) / SR
        long_tone = 0.8 * np.sin(2 * np.pi * FREQ * t).astype(np.float32)
        section = section_with(long_tone, 2 * M, 10 * M)
        assert self._verify(section, 3 * M) is False

    def test_harmonic_stack_rejects(self):
        t = np.arange(M) / SR
        stack = (
            0.4 * np.sin(2 * np.pi * FREQ * t)
            + 0.4 * np.sin(2 * np.pi * 2.3 * FREQ * t)
        ).astype(np.float32)
        section = section_with(stack, 3 * M, 10 * M)
        assert self._verify(section, 3 * M) is False

    def test_threshold_overrides_respected(self):
        t = np.arange(M) / SR
        tone = 0.8 * np.sin(2 * np.pi * FREQ * t).astype(np.float32)
        section = section_with(tone, 3 * M, 10 * M)
        # Impossible threshold forces rejection of a clean tone.
        assert self._verify(section, 3 * M, {"minimum_band_purity": 1.01}) is False


class TestEndToEndMarker:
    def test_embedded_beeps_detected(self):
        clip = make_marker_clip()
        rng = np.random.default_rng(3)
        audio = (0.02 * rng.standard_normal(30 * SR)).astype(np.float32)
        for off in [5.0, 12.5, 22.25]:
            o = int(off * SR)
            audio[o : o + M] += 0.7 * clip.audio
        det = AudioPatternDetector(audio_clips=[clip], seconds_per_chunk=15)
        stream = AudioStream(
            name="synth", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=SR
        )
        peaks, _ = det.find_clip_in_audio(stream)
        got = sorted(peaks["beep"])
        assert len(got) == 3
        for g, e in zip(got, [5.0, 12.5, 22.25]):
            assert abs(g - e) < 0.01

    def test_long_marker_clip_caps_gemm_spectra(self):
        """A marker clip of 8000 samples (1 s) verifies through the same
        FFT spectra as the 0.25 s beeps and is found exactly once."""
        seconds = 1.0
        m = int(seconds * SR)
        t = np.arange(m) / SR
        clip = AudioClip(
            name="long_beep",
            audio=np.sin(2 * np.pi * FREQ * t).astype(np.float32),
            sample_rate=SR,
            strategy=MARKER_TONE_STRATEGY,
            strategy_params={"dominant_frequency_hz": FREQ},
        )
        rng = np.random.default_rng(6)
        audio = (0.02 * rng.standard_normal(12 * SR)).astype(np.float32)
        audio[4 * SR : 4 * SR + m] += 0.7 * clip.audio
        det = AudioPatternDetector(audio_clips=[clip], seconds_per_chunk=6)
        stream = AudioStream(
            name="synth", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=SR
        )
        peaks, _ = det.find_clip_in_audio(stream)
        got = sorted(set(peaks["long_beep"]))
        assert len(got) == 1 and abs(got[0] - 4.0) < 0.01

    def test_long_tone_not_detected_as_marker(self):
        # A sustained tone at the marker frequency correlates but fails the
        # flank checks.
        clip = make_marker_clip()
        rng = np.random.default_rng(4)
        audio = (0.02 * rng.standard_normal(30 * SR)).astype(np.float32)
        t = np.arange(5 * SR) / SR
        audio[10 * SR : 15 * SR] += 0.7 * np.sin(2 * np.pi * FREQ * t).astype(np.float32)
        det = AudioPatternDetector(audio_clips=[clip], seconds_per_chunk=15)
        stream = AudioStream(
            name="synth", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=SR
        )
        peaks, _ = det.find_clip_in_audio(stream)
        assert peaks["beep"] == []
