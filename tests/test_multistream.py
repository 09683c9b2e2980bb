"""Multi-stream serving session: N independent live streams per launch.

Per-stream results must be identical to running each stream through the
serial engine (same lookback, timestamp algebra, and flagged-row
resolution — just batched into one device program per feed round).
"""

from __future__ import annotations

import io
import os

import numpy as np
import pytest

from tests.conftest import SAMPLE_AUDIOS
from audio_pattern_detector_tpu import (
    AudioClip,
    AudioPatternDetector,
    AudioStream,
)
from audio_pattern_detector_tpu.models.multistream import MultiStreamSession
from audio_pattern_detector_tpu.utils.audio_io import load_wave_file

# Full-lane suite: excluded from the default fast lane (pyproject addopts -m 'not slow');
# run with `pytest -m ""` or `-m slow`.
pytestmark = pytest.mark.slow

SR = 8000
CHUNK_S = 2


def corpus(rel):
    return os.path.join(SAMPLE_AUDIOS, rel)


@pytest.fixture(scope="module")
def clips():
    return [
        AudioClip.from_audio_file(
            corpus("clips/rthk_beep.apd.toml"), sample_rate=SR
        ),
        AudioClip.from_audio_file(
            corpus("clips/cbs_news.wav"), sample_rate=SR
        ),
    ]


@pytest.fixture(scope="module")
def stream_audios():
    rng = np.random.default_rng(11)
    return [
        load_wave_file(corpus("rthk_section_with_beep.wav"), SR),
        load_wave_file(corpus("cbs_news_audio_section.wav"), SR),
        (0.05 * rng.standard_normal(9 * SR)).astype(np.float32),
    ]


def _serial_results(clips, audio):
    det = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
    peaks, total = det.find_clip_in_audio(
        AudioStream("s", io.BytesIO(audio.astype(np.float32).tobytes()), SR)
    )
    return peaks, total


def _chunked(audio):
    n = CHUNK_S * SR
    return [audio[o : o + n] for o in range(0, len(audio), n)]


class TestMultiStreamSession:
    def test_streams_match_serial_engine(self, clips, stream_audios):
        """Three concurrent streams of different lengths — each stream's
        accumulated detections equal its serial single-stream run, and
        shorter streams go quiet (None) while others continue."""
        det = AudioPatternDetector(
            audio_clips=clips, seconds_per_chunk=CHUNK_S
        )
        session = MultiStreamSession(det, n_streams=3)

        per_stream_chunks = [_chunked(a) for a in stream_audios]
        rounds = max(len(c) for c in per_stream_chunks)
        accumulated: list[dict[str, list[float]]] = [
            {c.name: [] for c in clips} for _ in range(3)
        ]
        for r in range(rounds):
            feed = [
                chunks[r] if r < len(chunks) else None
                for chunks in per_stream_chunks
            ]
            results = session.feed(feed)
            for i, res in enumerate(results):
                for name, times in res.items():
                    accumulated[i][name].extend(times)

        for i, audio in enumerate(stream_audios):
            serial_peaks, serial_total = _serial_results(clips, audio)
            assert accumulated[i] == serial_peaks, f"stream {i}"
            assert session.total_time(i) == pytest.approx(serial_total)

    def test_int16_fast_path_bit_identical(self, clips, stream_audios):
        """Raw int16 chunks (the serving fast path: bit-packed upload
        with no host f32 decode) produce bit-identical detections to the
        same audio fed as f32 — including a MIXED round (one int16
        stream + one f32 stream forces the float-program fallback)."""
        audio = stream_audios[0]
        q = np.round(audio * 32768.0)
        assert (q == audio * 32768.0).all(), "corpus audio is PCM16-exact"
        audio_i16 = q.astype(np.int16)

        noise = stream_audios[2]  # rng noise: NOT PCM16-exact (stays f32)
        noise_i16 = np.clip(
            np.round(noise * 32768.0), -32768, 32767
        ).astype(np.int16)
        noise_q = noise_i16.astype(np.float32) * np.float32(1.0 / 32768.0)

        det = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        ref = MultiStreamSession(det, n_streams=2)
        fast = MultiStreamSession(det, n_streams=2)  # all rows int16
        mixed = MultiStreamSession(det, n_streams=2)  # int16 + f32 rows

        ref_rounds = [_chunked(audio), _chunked(noise_q)]
        fast_rounds = [_chunked(audio_i16), _chunked(noise_i16)]
        mixed_rounds = [_chunked(audio_i16), _chunked(noise)]
        rounds = max(len(c) for c in ref_rounds)
        for r in range(rounds):

            def feed_of(per_stream):
                return [c[r] if r < len(c) else None for c in per_stream]

            expect = ref.feed(feed_of(ref_rounds))
            assert fast.feed(feed_of(fast_rounds)) == expect, f"round {r}"
            mixed_res = mixed.feed(feed_of(mixed_rounds))
            assert mixed_res[0] == expect[0], f"round {r} (mixed)"
        assert fast.total_time(0) == ref.total_time(0)

    def test_scan_and_vmap_modes_identical(self, clips, stream_audios):
        """batch_mode='scan' (the single-device default) and 'vmap'
        produce identical per-stream
        results round by round: the scan body carries no state across
        rows, so the mode is purely an execution schedule."""
        det_s = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        det_v = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        sess_s = MultiStreamSession(det_s, n_streams=3)  # default: scan
        sess_v = MultiStreamSession(det_v, n_streams=3, batch_mode="vmap")
        assert sess_s._batch_mode == "scan"

        per_stream_chunks = [_chunked(a) for a in stream_audios]
        rounds = max(len(c) for c in per_stream_chunks)
        for r in range(rounds):
            feed = [
                chunks[r] if r < len(chunks) else None
                for chunks in per_stream_chunks
            ]
            assert sess_s.feed(feed) == sess_v.feed(list(feed))

    def test_tiled_rounds_identical(self, clips, stream_audios):
        """tile=2 over 5 slots (3 launches/round, padded final tile)
        equals the untiled full-width round, including idle (None)
        slots, checkpoints, and total_time — the serving-capacity
        mechanism must be invisible to results."""
        det_t = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        det_u = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        sess_t = MultiStreamSession(det_t, n_streams=5, tile=2)
        sess_u = MultiStreamSession(det_u, n_streams=5)

        src = [
            stream_audios[0],
            stream_audios[1],
            stream_audios[2],
            stream_audios[0],
            stream_audios[1],
        ]
        per_stream_chunks = [_chunked(a) for a in src]
        rounds = max(len(c) for c in per_stream_chunks)
        for r in range(rounds):
            feed = [
                chunks[r] if r < len(chunks) and (r + i) % 7 != 3 else None
                for i, chunks in enumerate(per_stream_chunks)
            ]
            assert sess_t.feed(list(feed)) == sess_u.feed(list(feed)), f"round {r}"
        for i in range(5):
            assert sess_t.total_time(i) == sess_u.total_time(i)
            assert sess_t.checkpoint(i).to_bytes() == sess_u.checkpoint(i).to_bytes()

    def test_tiled_rounds_compact_to_active_rows(self, clips):
        """A tiled round dispatches ONLY its active rows, decomposed
        into width-ladder tiles (largest-fit over the tile's powers of
        two) with no idle-row padding: device time and upload bytes
        must scale with occupancy, not slot count (round 5 —
        the serve64/128 collapse was full-width padded rounds at ~3-row
        occupancy, scripts/dev/serve_probe.py)."""
        det = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        sess = MultiStreamSession(det, n_streams=16, tile=8)
        assert sess._tile_widths == [8, 4, 2, 1]
        rng = np.random.default_rng(5)

        # Scattered slot assignment order (a fixed permutation) so the
        # active set is non-contiguous — proves the gather order is slot
        # order, not contiguity.
        perm = [1, 14, 3, 8, 0, 11, 6, 13, 2, 9, 4, 15, 7, 10, 5, 12]

        def round_widths(n_active):
            chunks = [None] * 16
            for i in perm[:n_active]:
                chunks[i] = (
                    0.05 * rng.standard_normal(CHUNK_S * SR)
                ).astype(np.float32)
            handle = sess.dispatch(chunks)
            dispatched, _meta, active = handle
            assert len(active) == n_active
            widths = [d[0][3] for d in dispatched]  # b per tile launch
            sess.collect(handle)
            return widths

        assert round_widths(0) == []
        assert round_widths(1) == [1]
        assert round_widths(3) == [2, 1]
        assert round_widths(7) == [4, 2, 1]
        assert round_widths(8) == [8]
        assert round_widths(13) == [8, 4, 1]
        assert round_widths(16) == [8, 8]

    def test_tile_validation(self, clips):
        det = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        with pytest.raises(ValueError, match="tile"):
            MultiStreamSession(det, n_streams=2, tile=0)

    def test_scan_mode_rejects_mesh(self, clips):
        import jax
        from jax.sharding import Mesh

        det = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("stream",))
        with pytest.raises(ValueError, match="scan"):
            MultiStreamSession(det, n_streams=2, mesh=mesh, batch_mode="scan")

    def test_mesh_sharded_streams_match_serial_engine(
        self, clips, stream_audios
    ):
        """Stream slots partitioned across a 4-device "stream" mesh (data
        parallelism: each round's batch rows land on their owning device,
        no collectives) must produce the exact serial per-stream results —
        the multi-chip serving path (serve --mesh-stream)."""
        from audio_pattern_detector_tpu.parallel.mesh import make_mesh

        det = AudioPatternDetector(
            audio_clips=clips, seconds_per_chunk=CHUNK_S
        )
        session = MultiStreamSession(
            det, n_streams=4, mesh=make_mesh({"stream": 4})
        )

        per_stream_chunks = [_chunked(a) for a in stream_audios] + [
            _chunked(stream_audios[0])  # slot 3 replays stream 0
        ]
        rounds = max(len(c) for c in per_stream_chunks)
        accumulated: list[dict[str, list[float]]] = [
            {c.name: [] for c in clips} for _ in range(4)
        ]
        for r in range(rounds):
            feed = [
                chunks[r] if r < len(chunks) else None
                for chunks in per_stream_chunks
            ]
            results = session.feed(feed)
            for i, res in enumerate(results):
                for name, times in res.items():
                    accumulated[i][name].extend(times)

        for i, audio in enumerate(
            stream_audios + [stream_audios[0]]
        ):
            serial_peaks, serial_total = _serial_results(clips, audio)
            assert accumulated[i] == serial_peaks, f"stream {i}"
            assert session.total_time(i) == pytest.approx(serial_total)

    def test_mesh_validation(self, clips):
        from audio_pattern_detector_tpu.parallel.mesh import make_mesh

        det = AudioPatternDetector(
            audio_clips=clips, seconds_per_chunk=CHUNK_S
        )
        with pytest.raises(ValueError, match="divisible"):
            MultiStreamSession(det, n_streams=3, mesh=make_mesh({"stream": 2}))
        with pytest.raises(ValueError, match="stream"):
            MultiStreamSession(det, n_streams=4, mesh=make_mesh({"time": 2}))

    def test_pipelined_rounds_equal_synchronous(self, clips, stream_audios):
        """dispatch/collect with 3 rounds in flight produces the same
        per-stream results as synchronous feed (state advances at
        dispatch time, so in-flight rounds never stall each other)."""
        per_stream_chunks = [_chunked(a) for a in stream_audios]
        rounds = max(len(c) for c in per_stream_chunks)

        def run(pipelined: bool):
            det = AudioPatternDetector(
                audio_clips=clips, seconds_per_chunk=CHUNK_S
            )
            sess = MultiStreamSession(det, n_streams=3)
            acc: list[list] = [[], [], []]

            def take(results):
                for i, res in enumerate(results):
                    acc[i].extend(
                        t for ts in sorted(res.items()) for t in ts[1]
                    )

            pend: list = []
            for r in range(rounds):
                feed = [
                    c[r] if r < len(c) else None for c in per_stream_chunks
                ]
                if pipelined:
                    pend.append(sess.dispatch(feed))
                    if len(pend) > 3:
                        take(sess.collect(pend.pop(0)))
                else:
                    take(sess.feed(feed))
            while pend:
                take(sess.collect(pend.pop(0)))
            return acc

        assert run(pipelined=True) == run(pipelined=False)

    def test_ended_stream_returns_empty_and_keeps_state(self, clips):
        det = AudioPatternDetector(
            audio_clips=clips, seconds_per_chunk=CHUNK_S
        )
        session = MultiStreamSession(det, n_streams=2)
        rng = np.random.default_rng(0)
        chunk = (0.01 * rng.standard_normal(CHUNK_S * SR)).astype(np.float32)

        session.feed([chunk, chunk])
        before = session.checkpoint(1)
        out = session.feed([chunk, None])
        assert out[1] == {}
        after = session.checkpoint(1)
        assert after.chunk_index == before.chunk_index
        assert session.total_time(1) == pytest.approx(CHUNK_S)

    def test_zero_length_chunk_is_idle_round(self, clips, stream_audios):
        """A zero-length chunk must behave exactly like None: no index
        advance, no tail replacement — otherwise every later timestamp
        for the stream shifts by a chunk minus the sliding window."""
        audio = stream_audios[0]  # rthk: detections in rounds 0-1
        det = AudioPatternDetector(
            audio_clips=clips, seconds_per_chunk=CHUNK_S
        )
        session = MultiStreamSession(det, n_streams=1)
        chunks = _chunked(audio)
        accumulated = {c.name: [] for c in clips}
        for r, chunk in enumerate(chunks):
            res = session.feed([chunk])[0]
            for name, times in res.items():
                accumulated[name].extend(times)
            if r == 0:  # idle round mid-stream: empty array, not None
                idle = session.feed([np.zeros(0, dtype=np.float32)])[0]
                assert idle == {}
        serial_peaks, serial_total = _serial_results(clips, audio)
        assert accumulated == serial_peaks
        assert session.total_time(0) == pytest.approx(serial_total)

    def test_validation(self, clips):
        det = AudioPatternDetector(
            audio_clips=clips, seconds_per_chunk=CHUNK_S
        )
        with pytest.raises(ValueError, match="n_streams"):
            MultiStreamSession(det, 0)
        session = MultiStreamSession(det, n_streams=2)
        with pytest.raises(ValueError, match="expected 2 chunks"):
            session.feed([None])
        too_long = np.zeros(CHUNK_S * SR + 1, dtype=np.float32)
        with pytest.raises(ValueError, match="at most"):
            session.feed([too_long, None])

    def test_checkpoint_resumes_serial_equivalent(self, clips, stream_audios):
        """A stream's checkpoint mid-session resumes in a fresh serial
        engine to the same remaining detections (StreamCheckpoint
        contract)."""
        audio = stream_audios[1]  # cbs: detection at 25.9 s, past round 2
        det = AudioPatternDetector(
            audio_clips=clips, seconds_per_chunk=CHUNK_S
        )
        session = MultiStreamSession(det, n_streams=1)
        chunks = _chunked(audio)
        cut = 4
        head_times: list[float] = []
        for r in range(cut):
            res = session.feed([chunks[r]])[0]
            head_times.extend(t for ts in res.values() for t in ts)
        ck = session.checkpoint(0)

        rest = np.concatenate(chunks[cut:])
        det2 = AudioPatternDetector(
            audio_clips=clips, seconds_per_chunk=CHUNK_S
        )
        peaks, _ = det2.find_clip_in_audio(
            AudioStream("r", io.BytesIO(rest.tobytes()), SR),
            checkpoint=ck,
        )
        resumed = sorted(
            t for ts in peaks.values() for t in ts
        ) + sorted(head_times)
        serial_peaks, _ = _serial_results(clips, audio)
        assert sorted(resumed) == sorted(
            t for ts in serial_peaks.values() for t in ts
        )

    def test_int16_checkpoint_serializes_as_f32(self, clips, stream_audios):
        """The int16 serving fast path keeps lookback tails raw
        in-session; checkpoint() must hand out the bitwise-pinned f32
        decode so StreamCheckpoint.to_bytes round-trips correctly (a raw
        astype would serialize PCM integers as if they were samples,
        ~32768x amplified)."""
        from audio_pattern_detector_tpu.models.detector import StreamCheckpoint

        audio = stream_audios[1]
        q = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
        dq = (q.astype(np.float32) * np.float32(1.0 / 32768.0)).astype(
            np.float32
        )
        det_i = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        det_f = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        sess_i = MultiStreamSession(det_i, n_streams=1)
        sess_f = MultiStreamSession(det_f, n_streams=1)
        cut = 4
        for r in range(cut):
            res_i = sess_i.feed([_chunked(q)[r]])[0]
            res_f = sess_f.feed([_chunked(dq)[r]])[0]
            assert res_i == res_f
        ck_i, ck_f = sess_i.checkpoint(0), sess_f.checkpoint(0)
        assert ck_i.previous_tail is not None
        assert ck_i.previous_tail.dtype == np.float32
        assert ck_i.to_bytes() == ck_f.to_bytes()

        # The serialized checkpoint resumes a fresh serial engine to the
        # same remaining detections as the f32-fed stream.
        ck = StreamCheckpoint.from_bytes(ck_i.to_bytes())
        rest = np.concatenate(_chunked(dq)[cut:])
        det2 = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        peaks, _ = det2.find_clip_in_audio(
            AudioStream("r", io.BytesIO(rest.tobytes()), SR),
            checkpoint=ck,
        )
        det3 = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
        peaks_f, _ = det3.find_clip_in_audio(
            AudioStream("r", io.BytesIO(rest.tobytes()), SR),
            checkpoint=ck_f,
        )
        assert peaks == peaks_f
