"""TCP serving layer: N concurrent client streams, one batched device program.

Per-client JSONL events must match piping the same bytes through
``match --stdin``: same header validation, decode, chunk/lookback
algebra, dedup, and event fields — just multiplexed onto shared
stream slots (serve.py on top of MultiStreamSession).
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from tests.conftest import SAMPLE_AUDIOS
from audio_pattern_detector_tpu import (
    AudioClip,
    AudioPatternDetector,
    AudioStream,
)
from audio_pattern_detector_tpu.serve import PatternServer
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
def server(clips):
    srv = PatternServer(
        clips,
        host="127.0.0.1",
        port=0,
        max_streams=2,
        seconds_per_chunk=CHUNK_S,
        pipeline_depth=2,
    )
    srv.warmup()
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive()


def wav_payload(audio: np.ndarray, kind: str = "f32") -> bytes:
    """A streamable WAV in the ``match --stdin`` wire format."""
    if kind == "f32":
        fmt_tag, bits = 3, 32
        data = audio.astype(np.float32).tobytes()
    else:
        fmt_tag, bits = 1, 16
        data = (
            np.clip(np.round(audio * 32768.0), -32768, 32767)
            .astype(np.int16)
            .tobytes()
        )
    block = bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, 1, SR, SR * block, block, bits)
    return (
        b"RIFF"
        + struct.pack("<I", 36 + len(data))
        + b"WAVE"
        + b"fmt "
        + struct.pack("<I", 16)
        + fmt
        + b"data"
        + struct.pack("<I", len(data))
        + data
    )


def run_client(port: int, payload: bytes) -> list[dict]:
    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        sock.sendall(payload)
        sock.shutdown(socket.SHUT_WR)
    except OSError:
        pass  # server already closed (e.g. rejected/error) — read on
    sock.settimeout(120)
    buf = b""
    while True:
        try:
            data = sock.recv(1 << 16)
        except ConnectionResetError:
            break
        if not data:
            break
        buf += data
    sock.close()
    return [json.loads(line) for line in buf.decode().splitlines()]


def serial_events_ms(clips, audio: np.ndarray) -> dict[str, list[int]]:
    """Expected per-clip emitted timestamps: serial engine + the CLI's
    equal-ms dedup (match.py:_make_jsonl_callback semantics)."""
    det = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=CHUNK_S)
    peaks, _ = det.find_clip_in_audio(
        AudioStream("s", io.BytesIO(audio.astype(np.float32).tobytes()), SR)
    )
    out: dict[str, list[int]] = {}
    last: dict[str, int] = {}
    for name, times in peaks.items():
        for t in times:
            ms = round(t * 1000)
            if last.get(name) == ms:
                continue
            last[name] = ms
            out.setdefault(name, []).append(ms)
    return out


def events_by_clip(events: list[dict]) -> dict[str, list[int]]:
    out: dict[str, list[int]] = {}
    for ev in events:
        if ev["type"] == "pattern_detected":
            out.setdefault(ev["clip_name"], []).append(ev["timestamp_ms"])
    return out


class TestPatternServer:
    def test_single_stream_matches_serial(self, server, clips):
        audio = load_wave_file(corpus("rthk_section_with_beep.wav"), SR)
        port = server.address[1]
        events = run_client(port, wav_payload(audio))

        assert events[0]["type"] == "start"
        assert events[0]["source"].startswith("tcp:")
        assert events[-1]["type"] == "end"
        assert events[-1]["total_time_ms"] == round(len(audio) / SR * 1000)
        assert "total_time_formatted" in events[-1]

        got = events_by_clip(events)
        assert got == serial_events_ms(clips, audio)
        assert sum(len(v) for v in got.values()) > 0

    def test_int16_stream_matches_serial_on_quantised(self, server, clips):
        audio = load_wave_file(corpus("cbs_news_audio_section.wav"), SR)
        payload = wav_payload(audio, kind="i16")
        quantised = (
            np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
        ).astype(np.float32) / np.float32(32768.0)
        events = run_client(server.address[1], payload)
        got = events_by_clip(events)
        assert got == serial_events_ms(clips, quantised)
        assert sum(len(v) for v in got.values()) > 0

    def test_concurrent_streams_are_independent(self, server, clips):
        audios = [
            load_wave_file(corpus("rthk_section_with_beep.wav"), SR),
            load_wave_file(corpus("cbs_news_audio_section.wav"), SR),
        ]
        port = server.address[1]
        results: list[list[dict] | None] = [None, None]

        def client(i: int) -> None:
            results[i] = run_client(port, wav_payload(audios[i]))

        threads = [
            threading.Thread(target=client, args=(i,)) for i in range(2)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive()

        for i, audio in enumerate(audios):
            events = results[i]
            assert events is not None
            assert events[-1]["type"] == "end"
            assert events[-1]["total_time_ms"] == round(
                len(audio) / SR * 1000
            )
            assert events_by_clip(events) == serial_events_ms(clips, audio)

    def test_server_full_then_slot_recycled(self, server, clips):
        port = server.address[1]
        header_only = wav_payload(np.zeros(0, dtype=np.float32))

        holders = []
        for _ in range(2):
            s = socket.create_connection(("127.0.0.1", port), timeout=30)
            s.sendall(header_only)  # occupy the slot, keep it open
            holders.append(s)
        try:
            # Wait until both slots are actually taken (start events).
            for s in holders:
                s.settimeout(30)
                assert b'"start"' in s.recv(1 << 16)

            # The rejected client sends nothing — the refusal arrives on
            # connect, and an unread inbound payload would risk an RST
            # discarding the error line.
            rejected = run_client(port, b"")
            assert rejected == [
                {
                    "type": "error",
                    "error": "server full: 2 streams already connected",
                }
            ]
        finally:
            for s in holders:
                s.close()

        # Slots recycle: the next client gets a fresh stream (timestamps
        # start at zero — index/lookback were reset with the slot). The
        # server notices the closed holders on its next loop pass, which
        # can lag under CPU-loaded suite runs — retry past interim
        # "server full" refusals instead of racing the event loop.
        audio = load_wave_file(corpus("rthk_section_with_beep.wav"), SR)
        deadline = time.monotonic() + 30.0
        while True:
            events = run_client(port, wav_payload(audio))
            if events and events[0].get("type") == "start":
                break
            assert time.monotonic() < deadline, events
            time.sleep(0.2)
        assert events[-1]["type"] == "end"
        assert events_by_clip(events) == serial_events_ms(clips, audio)

    def test_prebuilt_detector_constructor(self, clips):
        det = AudioPatternDetector(
            audio_clips=clips, seconds_per_chunk=CHUNK_S
        )
        srv = PatternServer(detector=det, max_streams=1)
        try:
            assert srv.detector is det
            assert srv.chunk_samples == CHUNK_S * SR
        finally:
            srv._teardown()
        with pytest.raises(ValueError, match="exactly one"):
            PatternServer(clips, detector=det)
        with pytest.raises(ValueError, match="exactly one"):
            PatternServer()
        with pytest.raises(ValueError, match="carries its own config"):
            PatternServer(detector=det, seconds_per_chunk=4)

    def test_bad_header_gets_error_event(self, server):
        port = server.address[1]
        events = run_client(port, b"definitely not a wav stream")
        assert events[0]["type"] == "start"
        assert events[-1]["type"] == "error"
        assert "Not a WAV file" in events[-1]["error"]

    @pytest.mark.parametrize(
        "zombie_bytes",
        [
            pytest.param(b"RIFF", id="headerless"),
            # Complete header, then silence: header_done alone must not
            # keep a stalled client counting as a dispatch straggler.
            pytest.param(wav_payload(np.zeros(0, dtype=np.float32)), id="stalled-after-header"),
        ],
    )
    def test_silent_connection_does_not_stall_rounds(self, clips, zombie_bytes):
        """A connection that stops delivering bytes (port scan, health
        check, stalled client) can never complete a chunk, so the
        dispatch hold-back must stop counting it as a straggler after
        the rx horizon — otherwise every round for real clients waits
        the full defer window."""
        srv = PatternServer(
            clips,
            max_streams=2,
            seconds_per_chunk=CHUNK_S,
            dispatch_defer_ms=5000.0,
        )
        srv.warmup()
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        zombie = None
        try:
            port = srv.address[1]
            zombie = socket.create_connection(("127.0.0.1", port), timeout=30)
            zombie.sendall(zombie_bytes)  # then silence
            time.sleep(0.4)  # exceed the straggler rx horizon
            audio = np.zeros(2 * CHUNK_S * SR, dtype=np.float32)
            t0 = time.monotonic()
            events = run_client(port, wav_payload(audio))
            elapsed = time.monotonic() - t0
            assert events[-1]["type"] == "end"
            assert events[-1]["total_time_ms"] == round(len(audio) / SR * 1000)
            # Without the rx-horizon guard, each of this client's >= 2
            # rounds waits the full 5 s defer window on the silent
            # straggler (>= 10 s total). Warmed program: well under 5 s.
            assert elapsed < 5.0, f"rounds stalled behind silent conn: {elapsed:.1f}s"
        finally:
            if zombie is not None:
                zombie.close()
            srv.shutdown()
            thread.join(timeout=30)

    def test_idle_connection_reaped(self, clips):
        srv = PatternServer(
            clips,
            max_streams=1,
            seconds_per_chunk=CHUNK_S,
            idle_timeout=0.5,
        )
        srv.warmup()
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            port = srv.address[1]
            sock = socket.create_connection(("127.0.0.1", port), timeout=30)
            sock.sendall(wav_payload(np.zeros(0, dtype=np.float32)))
            # No further data and no half-close: the slot must be
            # reclaimed by the idle timeout, with a parseable reason.
            sock.settimeout(30)
            buf = b""
            while True:
                data = sock.recv(1 << 16)
                if not data:
                    break
                buf += data
            sock.close()
            events = [json.loads(l) for l in buf.decode().splitlines()]
            assert events[-1]["type"] == "error"
            assert "idle timeout" in events[-1]["error"]

            # The reclaimed slot serves the next client normally.
            audio = np.zeros(CHUNK_S * SR, dtype=np.float32)
            events = run_client(port, wav_payload(audio))
            assert events[-1]["type"] == "end"
        finally:
            srv.shutdown()
            thread.join(timeout=30)

    def test_mesh_sharded_serving_matches_serial(self, clips):
        """serve --mesh-stream semantics: stream slots partitioned across
        a 2-device mesh serve concurrent clients with events identical to
        the single-device path (data parallelism over rounds' batch rows)."""
        from audio_pattern_detector_tpu.parallel.mesh import make_mesh

        srv = PatternServer(
            clips,
            max_streams=2,
            seconds_per_chunk=CHUNK_S,
            mesh=make_mesh({"stream": 2}),
        )
        srv.warmup()
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            port = srv.address[1]
            audio = load_wave_file(corpus("rthk_section_with_beep.wav"), SR)
            payload = wav_payload(audio)
            results: list = [None, None]

            def client(i):
                results[i] = run_client(port, payload)

            threads = [
                threading.Thread(target=client, args=(i,)) for i in range(2)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            expected = serial_events_ms(clips, audio)
            for events in results:
                assert events[-1]["type"] == "end"
                assert events_by_clip(events) == expected
        finally:
            srv.shutdown()
            thread.join(timeout=30)
            assert not thread.is_alive()

    def test_ended_undrained_events_release_slot(self, clips):
        """A half-closed client that never reads its remaining events must
        not hold a stream slot forever: the idle reaper exempts eof'd
        connections and the byte cap only fires on new emits, so the
        post-``end`` drain window is the bound (white-box: stale clock)."""
        from audio_pattern_detector_tpu.serve import _END_DRAIN_TIMEOUT, _Conn

        srv = PatternServer(
            clips, max_streams=1, seconds_per_chunk=CHUNK_S
        )
        try:
            a, b = socket.socketpair()
            a.setblocking(False)
            slot = srv._free_slots.pop()
            conn = _Conn(a, ("local", 0), slot)
            conn.registered = False  # never entered the selector
            conn.header_done = True
            conn.eof = True
            conn.ended = True
            conn.outbound += b'{"type":"end"}\n' * 4
            srv._conns[a] = conn

            srv._finish_streams()
            assert not conn.dead  # drain window still open

            conn.last_activity -= _END_DRAIN_TIMEOUT + 1
            srv._finish_streams()
            assert conn.dead
            assert srv._free_slots == [slot]
            assert a not in srv._conns
            b.close()
        finally:
            srv._teardown()

    def test_slow_consumer_dropped(self, clips):
        # A tiny outbound cap stands in for megabytes of backlog: the
        # client never reads, so the second event overflows the cap.
        srv = PatternServer(
            clips,
            max_streams=1,
            seconds_per_chunk=CHUNK_S,
            max_outbound=1,
        )
        srv.warmup()
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            port = srv.address[1]
            sock = socket.create_connection(("127.0.0.1", port), timeout=30)
            # Fill the server->client direction so nothing drains: events
            # queue server-side. The start event alone exceeds the cap.
            audio = load_wave_file(corpus("rthk_section_with_beep.wav"), SR)
            sock.sendall(wav_payload(audio))
            sock.shutdown(socket.SHUT_WR)
            deadline = 30.0
            import time as _time

            t0 = _time.monotonic()
            while srv._conns and _time.monotonic() - t0 < deadline:
                _time.sleep(0.05)
            assert not srv._conns  # dropped, slot reclaimed
            assert srv._free_slots == [0]
            sock.close()
        finally:
            srv.shutdown()
            thread.join(timeout=30)

    def test_inbound_backpressure_bounds_memory(self, clips):
        # A client uploading a whole file at line rate must not buffer it
        # all in server memory: reads pause at the inbound cap and the
        # TCP window becomes the backpressure channel (like the
        # reference's stdin pipe).
        from audio_pattern_detector_tpu.serve import _INBOUND_CAP_CHUNKS

        srv = PatternServer(
            clips, max_streams=1, seconds_per_chunk=CHUNK_S
        )
        srv.warmup()
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            port = srv.address[1]
            n_chunks = 40
            audio = np.zeros(n_chunks * CHUNK_S * SR, dtype=np.float32)
            payload = wav_payload(audio)
            cap = _INBOUND_CAP_CHUNKS * CHUNK_S * SR * 4
            high_water = 0
            done = threading.Event()

            def sample():
                nonlocal high_water
                while not done.is_set():
                    for conn in list(srv._conns.values()):
                        high_water = max(high_water, len(conn.buf))
                    done.wait(0.002)

            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            events = run_client(port, payload)
            done.set()
            sampler.join(timeout=10)
            assert events[-1]["type"] == "end"
            assert events[-1]["total_time_ms"] == n_chunks * CHUNK_S * 1000
            # One recv() of slack past the cap is the enforcement grain.
            assert 0 < high_water <= cap + (1 << 16), (
                f"inbound buffer reached {high_water} bytes (cap {cap})"
            )
        finally:
            srv.shutdown()
            thread.join(timeout=30)

    def test_stats_line_emitted(self, clips, capfd):
        """--stats-interval prints one parseable JSON ops line per window
        to stderr (stdout stays reserved for client JSONL events)."""
        srv = PatternServer(
            clips,
            max_streams=1,
            seconds_per_chunk=CHUNK_S,
            stats_interval=10.0,
        )
        srv.warmup()
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            port = srv.address[1]
            audio = load_wave_file(corpus("rthk_section_with_beep.wav"), SR)
            events = run_client(port, wav_payload(audio))
            assert events[-1]["type"] == "end"
            # Force the window closed instead of waiting 10 s.
            srv._stat_window_start -= 11.0
            deadline = time.monotonic() + 10.0
            stats = None
            while stats is None and time.monotonic() < deadline:
                time.sleep(0.05)
                for line in capfd.readouterr().err.splitlines():
                    if line.startswith("{"):
                        parsed = json.loads(line)
                        if parsed.get("type") == "stats":
                            stats = parsed
            assert stats is not None
            assert stats["rounds"] >= 1
            assert stats["audio_seconds"] > 0
            assert stats["detections"] >= 2  # the two rthk beeps
        finally:
            srv.shutdown()
            thread.join(timeout=30)

    def test_serve_64_streams_tiled(self, clips):
        """Serving capacity rung (VERDICT r3 #3): 64 concurrent client
        streams through one server. max_streams=64 auto-tiles rounds
        into 16-row launches of one compiled program; every client must
        receive its full, correct event stream."""
        rng = np.random.default_rng(5)
        noise = (0.05 * rng.standard_normal(2 * CHUNK_S * SR)).astype(np.float32)
        beep_audio = load_wave_file(corpus("rthk_section_with_beep.wav"), SR)

        srv = PatternServer(
            clips,
            host="127.0.0.1",
            port=0,
            max_streams=64,
            seconds_per_chunk=CHUNK_S,
            pipeline_depth=2,
        )
        assert srv.session._tile == 16
        srv.warmup()
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            port = srv.address[1]
            payloads = [
                wav_payload(beep_audio if i % 2 == 0 else noise, "i16")
                for i in range(64)
            ]
            results: list = [None] * 64
            quantised = {
                i: (
                    np.round(
                        (beep_audio if i % 2 == 0 else noise) * 32768.0
                    ).clip(-32768, 32767)
                    / np.float32(32768.0)
                ).astype(np.float32)
                for i in range(2)
            }
            expected_q = [
                serial_events_ms(clips, quantised[0]),
                serial_events_ms(clips, quantised[1]),
            ]

            def client(i):
                results[i] = run_client(port, payloads[i])

            threads = [
                threading.Thread(target=client, args=(i,)) for i in range(64)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
                assert not t.is_alive()
            for i, events in enumerate(results):
                assert events is not None, f"client {i} got nothing"
                assert events[-1]["type"] == "end", events[-1]
                got = events_by_clip(events)
                assert got == expected_q[i % 2], f"client {i}: {got}"
        finally:
            srv.shutdown()
            thread.join(timeout=30)
            assert not thread.is_alive()

    def test_serve_32_streams_paced_realtime(self, clips):
        """Paced live serving (VERDICT r4 #2): 32 clients stream at 1×
        realtime — sleep-paced writes at capture cadence, the actual
        "live stations" product claim — with real detections. Every
        client must hold cadence (wall ≈ audio duration, not longer by
        more than a round latency) and receive each chunk's events
        promptly after that chunk finished uploading."""
        beep_audio = load_wave_file(corpus("rthk_section_with_beep.wav"), SR)
        audio = np.concatenate([beep_audio[: 2 * CHUNK_S * SR]])
        n_chunks = 2
        stream_s = n_chunks * CHUNK_S
        quantised = (
            np.round(audio * 32768.0).clip(-32768, 32767)
            / np.float32(32768.0)
        ).astype(np.float32)
        expected = serial_events_ms(clips, quantised)
        assert expected, "paced test audio must carry detections"

        # Chunk-edge ambiguity margin: longest clip in this bank rounds
        # to <= 1 s of lookback at these fixtures' sliding windows.
        _CLIP_MARGIN_MS = 1000
        payload = wav_payload(audio, "i16")
        hdr, body = payload[:44], payload[44:]
        chunk_bytes = CHUNK_S * SR * 2
        block_bytes = SR // 2 * 2  # 0.25 s of audio per paced write

        srv = PatternServer(
            clips,
            host="127.0.0.1",
            port=0,
            max_streams=32,
            seconds_per_chunk=CHUNK_S,
            pipeline_depth=2,
        )
        srv.warmup()
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        width = 32
        results: list = [None] * width
        latencies: list = [None] * width
        walls: list = [None] * width
        try:
            port = srv.address[1]

            def client(i):
                time.sleep((i % 8) * 0.03)  # desynchronised phases
                sock = socket.create_connection(("127.0.0.1", port), timeout=60)
                chunk_done: dict[int, float] = {}
                events: list = []
                my_lat: list = []
                done = threading.Event()

                def receiver():
                    sock.settimeout(120)
                    buf = b""
                    while True:
                        try:
                            d = sock.recv(1 << 16)
                        except OSError:
                            break
                        if not d:
                            break
                        buf += d
                        while b"\n" in buf:
                            line, buf = buf.split(b"\n", 1)
                            ev = json.loads(line)
                            events.append(ev)
                            if ev["type"] == "pattern_detected":
                                t = time.perf_counter()
                                k, r = divmod(
                                    ev["timestamp_ms"], CHUNK_S * 1000
                                )
                                # Exclude boundary-ambiguous events: a
                                # clip straddling the chunk edge is
                                # detected by the NEXT chunk (lookback),
                                # so chunk-k attribution would inflate
                                # its latency by ~a chunk (bench.py
                                # applies the same rule).
                                near_edge = (
                                    CHUNK_S * 1000 - r
                                    <= _CLIP_MARGIN_MS
                                )
                                if not near_edge and k in chunk_done:
                                    my_lat.append(t - chunk_done[k])
                            elif ev["type"] == "end":
                                done.set()

                rx = threading.Thread(target=receiver, daemon=True)
                rx.start()
                t0 = time.perf_counter()
                sock.sendall(hdr)
                sent = 0
                while sent < len(body):
                    sock.sendall(body[sent : sent + block_bytes])
                    sent += min(block_bytes, len(body) - sent)
                    if sent % chunk_bytes == 0 or sent == len(body):
                        chunk_done[(sent - 1) // chunk_bytes] = (
                            time.perf_counter()
                        )
                    target = t0 + (sent / 2) / SR
                    delay = target - time.perf_counter()
                    if delay > 0 and sent < len(body):
                        time.sleep(delay)
                sock.shutdown(socket.SHUT_WR)
                done.wait(timeout=120)
                rx.join(timeout=30)
                sock.close()
                walls[i] = time.perf_counter() - t0
                results[i] = events
                latencies[i] = my_lat

            threads = [
                threading.Thread(target=client, args=(i,))
                for i in range(width)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                assert not t.is_alive()
        finally:
            srv.shutdown()
            thread.join(timeout=30)
            assert not thread.is_alive()

        all_lat: list = []
        for i in range(width):
            events = results[i]
            assert events is not None and events[-1]["type"] == "end", (
                f"client {i}: {events and events[-1]}"
            )
            assert events[-1]["total_time_ms"] == stream_s * 1000
            assert events_by_clip(events) == expected, f"client {i}"
            # Cadence held: the 1×-paced stream finished within a few
            # chunk periods of the audio duration (generous CPU-CI
            # bound — a loaded single-core xdist worker adds scheduler
            # latency; on the device the tail is one round latency, ≪
            # a chunk, and the failure mode this guards against
            # was minutes of slip).
            assert walls[i] < stream_s + 4 * CHUNK_S, (
                f"client {i} slipped: {walls[i]:.2f}s for {stream_s}s"
            )
            all_lat.extend(latencies[i])
        # Per-event latency: events landed after their chunk completed
        # (causality) and within a chunk period of it.
        assert all_lat, "no event latencies measured"
        assert min(all_lat) > 0
        assert max(all_lat) < 4 * CHUNK_S, sorted(all_lat)[-5:]

    def test_wrong_sample_rate_rejected(self, server):
        port = server.address[1]
        bad = bytearray(wav_payload(np.zeros(16, dtype=np.float32)))
        # Patch the fmt chunk's sample-rate field to 44100.
        offset = bad.index(b"fmt ") + 8 + 4
        bad[offset : offset + 4] = struct.pack("<I", 44100)
        events = run_client(port, bytes(bad))
        assert events[-1]["type"] == "error"
        assert "Expected 8000 Hz, got 44100" in events[-1]["error"]
