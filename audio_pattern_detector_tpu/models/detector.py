"""Streaming audio pattern detector (the public engine API).

API parity with the reference engine
(reference: audio_pattern_detector/audio_pattern_detector.py): construct
with a list of ``AudioClip``s, then ``find_clip_in_audio(AudioStream,
on_pattern_detected=cb, accumulate_results=bool) -> (peaks | None,
total_time)``.

Device internals: clips compile into shape-static groups (one jitted
device program per sliding-window class, bank-batched over clips — see
``models.bank``); the host loop streams chunks, assembles overlap-save
sections, dispatches the device program, and converts integer peak
positions back to timestamps in Python f64 so the timestamp algebra is
bit-identical to the reference (audio_pattern_detector.py:406-452).
"""

from __future__ import annotations

import math
import sys
from collections import defaultdict
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any, TypedDict

import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu.ops import hostref
from audio_pattern_detector_tpu.ops.tone import get_pure_tone_frequency
from audio_pattern_detector_tpu.utils.audio_io import DEFAULT_TARGET_SAMPLE_RATE
from audio_pattern_detector_tpu.utils.clip import AudioClip, AudioStream

import logging

logger = logging.getLogger(__name__)

# Default seconds per chunk for sliding-window processing
# (reference: audio_pattern_detector.py:33).
DEFAULT_SECONDS_PER_CHUNK = 60

# Clips shorter than this use the whole-window (0-100%) verification variant
# (reference: audio_pattern_detector.py:36).
SHORT_CLIP_DURATION_THRESHOLD = 0.5  # seconds

MARKER_TONE_STRATEGY = "marker_tone"

PatternDetectedCallback = Callable[[str, float], None]


def _dispatched_ready(dispatched: list) -> bool:
    """Non-blocking: every payload of a dispatched round completed, so
    collecting it will not stall the pipeline loop.

    Accepts both dispatch record shapes — ``dispatch_chunk``'s
    ``(sw, flat, raws)`` and ``dispatch_chunks_batch``'s
    ``(sw, flat, raws, b, pool_rec)`` — the payload whose transfer
    readiness gates collection is ``rec[1]`` in both."""
    for rec in dispatched:
        ready = getattr(rec[1], "is_ready", None)
        if ready is None or not ready():
            return False
    return True


@dataclass
class StreamCheckpoint:
    """Resume point for an interrupted stream: O(1) state.

    The engine's state between chunks is exactly (next chunk index, the
    lookback tail of the previous chunk, accumulated stream time) — the
    overlap-save algebra needs nothing else (SURVEY.md §5: checkpoint /
    resume). The caller owns stream positioning: resume by handing the
    detector a stream positioned at ``chunk_index * seconds_per_chunk``.
    """

    chunk_index: int
    previous_tail: "NDArray[np.float32] | None"
    total_time: float

    def to_bytes(self) -> bytes:
        """Serialise (portable little-endian layout)."""
        import struct

        tail = (
            self.previous_tail.astype("<f4").tobytes()
            if self.previous_tail is not None
            else b""
        )
        head = struct.pack("<qdq", self.chunk_index, self.total_time, len(tail))
        return head + tail

    @staticmethod
    def from_bytes(raw: bytes) -> "StreamCheckpoint":
        import struct

        if len(raw) < 24:
            raise ValueError(
                f"checkpoint truncated: {len(raw)} bytes < 24-byte header"
            )
        chunk_index, total_time, tail_len = struct.unpack("<qdq", raw[:24])
        if tail_len < 0 or tail_len % 4 != 0:
            raise ValueError(f"checkpoint corrupt: tail length {tail_len}")
        if len(raw) < 24 + tail_len:
            raise ValueError(
                f"checkpoint truncated: need {24 + tail_len} bytes, got {len(raw)}"
            )
        tail = (
            np.frombuffer(raw[24 : 24 + tail_len], dtype="<f4").copy()
            if tail_len
            else None
        )
        return StreamCheckpoint(chunk_index, tail, total_time)


class ClipConfig(TypedDict):
    duration_seconds: float
    sliding_window_seconds: int


class DetectorConfig(TypedDict):
    default_seconds_per_chunk: int
    min_chunk_size_seconds: int
    sample_rate: int
    clips: dict[str, ClipConfig]


class AudioPatternDetector:
    """Two-step streaming pattern detector (FFT correlation + verification)."""

    def __init__(
        self,
        audio_clips: list[AudioClip],
        debug_mode: bool = False,
        seconds_per_chunk: int | None = DEFAULT_SECONDS_PER_CHUNK,
        target_sample_rate: int | None = None,
        debug_dir: str = "./tmp",
        height_min: float | None = None,
    ) -> None:
        self.audio_clips = audio_clips
        self.debug_mode = debug_mode
        self.debug_dir = debug_dir
        self.height_min = height_min
        self.normalize = True
        self.target_sample_rate = (
            target_sample_rate if target_sample_rate is not None else DEFAULT_TARGET_SAMPLE_RATE
        )
        self._similarity_debug: defaultdict[str, list[tuple[int, float]]] = defaultdict(list)

        # ── Validation (reference: audio_pattern_detector.py:105-137) ──
        clips_already: set[str] = set()
        max_clip_length = 0
        for audio_clip in self.audio_clips:
            if audio_clip.name in clips_already:
                raise ValueError(f"clip {audio_clip.name} needs to be unique")
            if audio_clip.sample_rate != self.target_sample_rate:
                raise ValueError(
                    f"clip {audio_clip.name} needs to be {self.target_sample_rate} sample rate"
                )
            clips_already.add(audio_clip.name)
            max_clip_length = max(max_clip_length, len(audio_clip.audio))

        if seconds_per_chunk is None or seconds_per_chunk < 1:
            seconds_per_chunk = math.ceil(max_clip_length / self.target_sample_rate) * 2
            logger.warning(
                f"seconds_per_chunk is not set or less than 1, setting it to longest clip * 2 "
                f"seconds, which is {seconds_per_chunk} seconds"
            )

        max_min_chunk_size = 0
        for audio_clip in self.audio_clips:
            clip_seconds = len(audio_clip.audio) / self.target_sample_rate
            sliding_window = math.ceil(clip_seconds)
            min_chunk_size = sliding_window * 2
            max_min_chunk_size = max(max_min_chunk_size, min_chunk_size)
            if seconds_per_chunk < min_chunk_size:
                raise ValueError(
                    f"seconds_per_chunk {seconds_per_chunk} is too small for clip "
                    f"'{audio_clip.name}' (duration: {clip_seconds:.2f}s, "
                    f"sliding_window: {sliding_window}s, "
                    f"minimum chunk size: {min_chunk_size}s)"
                )
        self._min_chunk_size = max_min_chunk_size
        self.seconds_per_chunk = seconds_per_chunk

        # Device payloads cross the host↔device boundary as float32
        # (models/bank.py packed payload, ops/_pytree.py int_const), which
        # is exact only below 2**24. Peak positions and length constants live in
        # correlation space: section (chunk + lookback) plus one clip
        # length. Reject configs whose positions could round, with the
        # user-facing knobs in the message.
        max_sw_seconds = math.ceil(max_clip_length / self.target_sample_rate)
        max_coord = (
            (seconds_per_chunk + max_sw_seconds) * self.target_sample_rate
            + max_clip_length
        )
        if max_coord >= 2**24:
            raise ValueError(
                f"seconds_per_chunk {seconds_per_chunk} at sample rate "
                f"{self.target_sample_rate} needs sample positions up to "
                f"{max_coord}, past float32 exactness (2**24 = {2**24}); "
                f"use a chunk size below "
                f"{2**24 // self.target_sample_rate - 2 * max_sw_seconds} "
                f"seconds"
            )

        if seconds_per_chunk != 60:
            logger.warning(
                f"seconds_per_chunk {seconds_per_chunk} is not 60 seconds, turning off debug "
                f"mode because it was made for 60 seconds only"
            )
            self.debug_mode = False

        # ── Per-clip preprocessing (host, f64-exact) ──
        # (reference: audio_pattern_detector.py:155-221)
        self._clip_datas: dict[str, dict[str, Any]] = {}
        self._clip_strategies: dict[str, str | None] = {}
        self._clip_strategy_params: dict[str, dict[str, Any]] = {}
        self._tone_frequencies: dict[str, float] = {}

        for audio_clip in self.audio_clips:
            clip = audio_clip.audio
            clip_name = audio_clip.name
            clip_seconds = len(clip) / self.target_sample_rate
            sliding_window = math.ceil(clip_seconds)
            if sliding_window != clip_seconds:
                print(
                    f"adjusted sliding_window from {clip_seconds} to {sliding_window} "
                    f"for {clip_name}",
                    file=sys.stderr,
                )

            if self.normalize:
                block = clip_seconds if clip_seconds < 0.5 else 0.4
                loudness = hostref.integrated_loudness(
                    clip, self.target_sample_rate, block_size=block
                )
                clip = hostref.loudness_normalize(clip, loudness, -16.0)

            correlation_clip = np.abs(hostref.fft_correlate_1d(clip, clip, mode="full"))
            absolute_max = np.max(correlation_clip)
            correlation_clip = correlation_clip / absolute_max

            if self.debug_mode:
                print(f"clip_length {clip_name}", len(clip), file=sys.stderr)
                print(
                    f"clip_length {clip_name} seconds",
                    len(clip) / self.target_sample_rate,
                    file=sys.stderr,
                )
                print("correlation_clip_length", len(correlation_clip), file=sys.stderr)
                self._debug_sink().dump_clip_correlation(clip_name, correlation_clip)

            self._clip_datas[clip_name] = {
                "clip": clip,
                "clip_name": clip_name,
                "sliding_window": sliding_window,
                "correlation_clip": correlation_clip,
                "correlation_clip_absolute_max": absolute_max,
            }
            self._clip_strategies[clip_name] = audio_clip.strategy
            self._clip_strategy_params[clip_name] = dict(audio_clip.strategy_params)

            if audio_clip.strategy == MARKER_TONE_STRATEGY:
                freq = audio_clip.strategy_params.get("dominant_frequency_hz")
                if freq is None:
                    freq = get_pure_tone_frequency(clip, self.target_sample_rate)
                if freq is not None:
                    self._tone_frequencies[clip_name] = float(freq)

        self._chunk_size = int(self.seconds_per_chunk * self.target_sample_rate) * 4

        # Device pattern bank compiled lazily on first stream (chunk size known).
        self._bank = None

    def _debug_sink(self):
        if getattr(self, "_debug_sink_obj", None) is None:
            from audio_pattern_detector_tpu.models.debug import DebugSink

            self._debug_sink_obj = DebugSink(self.debug_dir, self.target_sample_rate)
        return self._debug_sink_obj

    # ── Introspection (reference: audio_pattern_detector.py:226-246) ──

    def get_config(self) -> DetectorConfig:
        clips_config: dict[str, ClipConfig] = {}
        for clip_name, clip_data in self._clip_datas.items():
            clip_duration = len(clip_data["clip"]) / self.target_sample_rate
            clips_config[clip_name] = {
                "duration_seconds": round(clip_duration, 6),
                "sliding_window_seconds": clip_data["sliding_window"],
            }
        return {
            "default_seconds_per_chunk": DEFAULT_SECONDS_PER_CHUNK,
            "min_chunk_size_seconds": self._min_chunk_size,
            "sample_rate": self.target_sample_rate,
            "clips": clips_config,
        }

    # ── Streaming detection ──

    def _ensure_bank(self):
        if self._bank is None:
            from audio_pattern_detector_tpu.models.bank import PatternBank

            self._bank = PatternBank(
                clip_datas=self._clip_datas,
                tone_frequencies=self._tone_frequencies,
                strategy_params=self._clip_strategy_params,
                sample_rate=self.target_sample_rate,
                chunk_samples=int(self.seconds_per_chunk * self.target_sample_rate),
                height_min=self.height_min if self.height_min is not None else 0.25,
            )
        return self._bank

    def find_clip_in_audio(
        self,
        audio_stream: AudioStream,
        on_pattern_detected: PatternDetectedCallback | None = None,
        accumulate_results: bool = True,
        checkpoint: "StreamCheckpoint | None" = None,
        on_checkpoint: "Callable[[StreamCheckpoint], None] | None" = None,
        pipeline_depth: int = 1,
        stream_batch: int = 1,
        stream_batch_mode: str = "scan",
    ) -> tuple[dict[str, list[float]] | None, float]:
        """Find clip occurrences in the audio stream.

        Returns (peak_times dict or None when accumulate_results=False,
        total stream time in seconds). Callbacks fire in timestamp order
        within each chunk (reference: audio_pattern_detector.py:248-331).

        The host loop is double-buffered: while the device crunches chunk
        i, the host reads/decodes chunk i+1 and emits chunk i-1's results,
        so I/O, compute, and output overlap (where the reference pipelines
        only ffmpeg's decode against Python).

        ``pipeline_depth`` is the maximum number of chunks kept in flight
        on the device (default 1). Deeper pipelines hide per-launch
        round-trip latency on remote runtimes; results are identical.
        Completed results are collected EAGERLY in order (a non-blocking
        readiness check each iteration), so a deeper pipeline does not
        defer emission — each chunk's events fire within one loop
        iteration of its device program finishing; the depth only bounds
        in-flight memory and how far the host reads ahead of the stream.

        ``checkpoint``/``on_checkpoint`` give O(1) resume for unbounded
        streams: pass a previously observed StreamCheckpoint together with
        a stream positioned at its chunk boundary.

        ``stream_batch`` (default 1) runs that many consecutive chunks
        through ONE device launch (the sequential in-launch scan), paying
        the per-launch round trip once per batch instead of once per chunk
        — the live-stream analogue of ``--offline-batch``. Results and
        callback order are identical; each chunk's emission is deferred to
        its batch boundary (≤ stream_batch · seconds_per_chunk latency).
        A short final batch is zero-padded on device and the padding's
        results discarded, so no extra program is compiled at stream end.
        ``pipeline_depth`` composes: it caps how many dispatched BATCHES
        stay in flight (the CLI default is 3).
        ``stream_batch_mode`` picks the batched program: "scan" (default,
        sequential in-launch, one-chunk memory) or "vmap" (chunks in
        parallel, B× intermediate memory — higher throughput when the
        chip has headroom). Identical results.
        """
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if stream_batch < 1:
            raise ValueError(f"stream_batch must be >= 1, got {stream_batch}")
        if stream_batch_mode not in ("scan", "vmap"):
            raise ValueError(
                f"stream_batch_mode must be 'scan' or 'vmap', got {stream_batch_mode!r}"
            )
        if audio_stream.sample_rate != self.target_sample_rate:
            raise ValueError(
                f"full_streaming_audio_clip {audio_stream.name} needs to be "
                f"{self.target_sample_rate} sample rate"
            )

        bank = self._ensure_bank()
        sr = self.target_sample_rate

        previous_chunk: NDArray[np.float32] | None = None
        total_time = 0.0
        i = 0
        if checkpoint is not None:
            if checkpoint.chunk_index < 0:
                raise ValueError(
                    f"checkpoint chunk_index must be >= 0, got "
                    f"{checkpoint.chunk_index}"
                )
            if checkpoint.chunk_index > 0 and checkpoint.previous_tail is None:
                # Every non-head checkpoint carries a lookback tail (emitted
                # ones always do); resuming without it would silently drop
                # the overlap-save subtract and shift every timestamp by
                # sliding_window seconds.
                raise ValueError(
                    "checkpoint at chunk_index > 0 must carry the previous "
                    "chunk's lookback tail"
                )
            # A tail SHORTER than max_sliding_window*sr is legitimate: it
            # means the checkpointed chunk itself was that short (a stream
            # segment's final chunk), and the per-class lookback
            # tail[-sw*sr:] then equals the serial run's short-chunk
            # lookback exactly (tests/test_checkpoint.py pins this).
            previous_chunk = checkpoint.previous_tail
            total_time = checkpoint.total_time
            i = checkpoint.chunk_index

        if accumulate_results:
            all_peak_times: dict[str, list[float]] | None = {
                audio_clip.name: [] for audio_clip in self.audio_clips
            }
        else:
            all_peak_times = None

        stdout = audio_stream.audio_stream
        self._similarity_debug = defaultdict(list)
        max_sw = max(
            (cd["sliding_window"] for cd in self._clip_datas.values()), default=1
        )

        # int16 passthrough: a stream of raw 16-bit PCM bytes skips the
        # host f32 decode AND the packed upload's re-quantise — the device
        # unpack IS the (bitwise-pinned) decode. Chunk arrays then carry
        # int16 through dispatch; only checkpoint tails (whose to_bytes
        # contract is f32 samples) decode on the host.
        sample_dtype = (
            audio_stream.resolved_dtype()
            if hasattr(audio_stream, "resolved_dtype")
            else np.dtype(np.float32)
        )
        read_bytes = (self._chunk_size // 4) * sample_dtype.itemsize

        def _tail_f32(tail: "NDArray[Any]") -> "NDArray[np.float32]":
            # Returns an OWNED f32 array either way (decode already
            # allocates; f32 views copy once) — no caller-side .copy().
            from audio_pattern_detector_tpu.models.bank import _pcm16_to_f32

            return (
                _pcm16_to_f32(tail)
                if tail.dtype == np.int16
                else tail.copy()
            )

        from audio_pattern_detector_tpu.utils.profiling import RunStats, Stopwatch

        stats = RunStats()
        watch = Stopwatch(stats)
        self.last_run_stats = stats

        def emit(index: int, had_prev: bool, clip_peaks: dict[str, list[int]]) -> None:
            # Timestamp conversion lives in ONE place (peaks_to_times, the
            # reference algebra); emit only adds callback ordering and
            # accumulation on top.
            chunk_matches: list[tuple[float, str]] = []
            for name, peak_times in self.peaks_to_times(
                clip_peaks, index, had_prev
            ).items():
                if on_pattern_detected and peak_times:
                    for timestamp in peak_times:
                        chunk_matches.append((timestamp, name))
                if all_peak_times is not None:
                    all_peak_times[name].extend(peak_times)

            if on_pattern_detected and chunk_matches:
                chunk_matches.sort(key=lambda x: x[0])
                for timestamp, clip_name in chunk_matches:
                    on_pattern_detected(clip_name, timestamp)
            stats.detections += sum(len(v) for v in clip_peaks.values())

        # Each pending entry: (index, had_prev, dispatched_handles, tail,
        # cum_time). Up to ``pipeline_depth`` chunks stay in flight.
        from collections import deque

        pending: "deque[tuple[int, bool, Any, NDArray[np.float32] | None, float]]" = deque()

        def drain_one() -> None:
            p_i, p_prev, p_disp, p_tail, p_time = pending.popleft()
            with watch.segment("collect"):
                emit(p_i, p_prev, bank.collect_chunk(p_disp))
            if on_checkpoint is not None:
                on_checkpoint(StreamCheckpoint(p_i + 1, p_tail, p_time))

        def oldest_ready() -> bool:
            # Non-blocking: the oldest in-flight chunk's payloads have all
            # completed, so draining it emits without stalling the loop.
            return _dispatched_ready(pending[0][2])

        # stream_batch mode: (chunk, had_prev, cum_time) buffered per batch;
        # up to ``pipeline_depth`` dispatched batches in flight with eager
        # in-order draining (non-blocking is_ready), like the offline scan
        # path — ready results emit as soon as the device finishes them, so
        # a deeper cap never delays emission beyond the batching itself.
        batch_buf: "list[tuple[NDArray[np.float32], bool, float]]" = []
        in_flight: "list[tuple[Any, int, list]]" = []
        chunk_samples = self._chunk_size // 4

        def drain_batch() -> None:
            dispatched, base_i, meta = in_flight.pop(0)
            with watch.segment("collect"):
                results = bank.collect_chunks_batch(dispatched)
            for k, (chunk_k, had_prev_k, time_k) in enumerate(meta):
                emit(base_i + k, had_prev_k, results[k])
                if on_checkpoint is not None:
                    on_checkpoint(
                        StreamCheckpoint(
                            base_i + k + 1,
                            _tail_f32(chunk_k[int(-max_sw * sr):]),
                            time_k,
                        )
                    )

        def flush_batch() -> None:
            if not batch_buf:
                return
            nonlocal previous_chunk
            chunks = [c for c, _, _ in batch_buf]
            n_real = len(chunks)
            # Zero-pad a short final batch so every flush reuses the ONE
            # compiled scan program; padding results are discarded. Pad in
            # the stream's dtype: an f32 padding row in an otherwise-int16
            # batch would force the dispatch off the int16 bit-pack path
            # on installs without the native packer (results identical,
            # but every real row would pay the host f32 decode).
            chunks += [
                np.zeros(chunk_samples, dtype=chunks[-1].dtype)
                for _ in range(stream_batch - n_real)
            ]
            with watch.segment("dispatch"):
                dispatched = bank.dispatch_chunks_batch(
                    chunks,
                    previous_chunk if batch_buf[0][1] else None,
                    mode=stream_batch_mode,
                )
            in_flight.append((dispatched, i - n_real, list(batch_buf)))
            previous_chunk = batch_buf[-1][0]
            batch_buf.clear()
            while len(in_flight) > 1 and _dispatched_ready(in_flight[0][0]):
                drain_batch()
            if len(in_flight) > pipeline_depth:
                drain_batch()

        while True:
            with watch.segment("read"):
                in_bytes = stdout.read(read_bytes)
            if not in_bytes:
                break
            chunk = np.frombuffer(in_bytes, dtype=sample_dtype)
            total_time += len(chunk) / sr
            stats.chunks += 1
            stats.audio_seconds += len(chunk) / sr

            if self.debug_mode:
                # Debug runs the exact host path serially (full artifacts,
                # f32 — decode passthrough chunks with the pinned cast).
                if chunk.dtype == np.int16:
                    from audio_pattern_detector_tpu.models.bank import (
                        _pcm16_to_f32,
                    )

                    chunk = _pcm16_to_f32(chunk)
                emit(i, previous_chunk is not None, self._process_chunk_debug(chunk, previous_chunk, i))
                previous_chunk = chunk
            elif stream_batch > 1:
                had_prev = previous_chunk is not None or bool(batch_buf)
                batch_buf.append((chunk, had_prev, total_time))
                i += 1
                if len(batch_buf) == stream_batch:
                    flush_batch()
                continue
            else:
                with watch.segment("dispatch"):
                    dispatched = bank.dispatch_chunk(chunk, previous_chunk)
                pending.append(
                    (
                        i,
                        previous_chunk is not None,
                        dispatched,
                        # Tails exist solely for checkpoint emission; the
                        # StreamCheckpoint contract is f32 samples.
                        (
                            _tail_f32(chunk[int(-max_sw * sr):])
                            if on_checkpoint is not None
                            else None
                        ),
                        total_time,
                    )
                )
                # Eager in-order drain: collect every chunk whose result is
                # already on its way (non-blocking check), then enforce the
                # in-flight cap with a blocking drain. Emission therefore
                # happens within one loop iteration of a result being ready
                # — deeper pipelines no longer defer it.
                while len(pending) > 1 and oldest_ready():
                    drain_one()
                if len(pending) > pipeline_depth:
                    drain_one()
                previous_chunk = chunk

            i += 1

        flush_batch()
        while in_flight:
            drain_batch()
        while pending:
            drain_one()
        watch.finish()

        if self.debug_mode:
            self._debug_sink().dump_similarity_scatter(
                [c.name for c in self.audio_clips], audio_stream.name
            )

        return all_peak_times, total_time

    def find_clip_in_array(
        self,
        audio: NDArray[np.float32],
        batch_size: int = 4,
        batch_mode: str = "scan",
    ) -> tuple[dict[str, list[float]], float]:
        """Offline scan of an in-memory array via batched device launches.

        Produces results identical to streaming the same samples through
        ``find_clip_in_audio`` (same chunking, lookback, and timestamp
        algebra), but processes ``batch_size`` chunks per launch — the
        throughput-oriented path for file scanning. ``batch_mode="scan"``
        (default) iterates the chunks inside one launch (1× memory,
        launches amortised); ``"vmap"`` computes them in parallel
        (B× memory). Identical results.
        """
        bank = self._ensure_bank()
        sr = self.target_sample_rate
        chunk_samples = int(self.seconds_per_chunk * sr)
        if np.asarray(audio).dtype == np.int16:
            # int16 passthrough (raw 16-bit PCM sources): rows bit-pack
            # into upload lanes without a host f32 decode — bit-identical
            # (the device unpack IS the pinned decode).
            audio = np.ascontiguousarray(audio)
        else:
            audio = np.ascontiguousarray(audio, dtype=np.float32)

        chunks = [
            audio[o : o + chunk_samples]
            for o in range(0, len(audio), chunk_samples)
        ]
        all_peak_times: dict[str, list[float]] = {
            c.name: [] for c in self.audio_clips
        }
        # Pipelined like the streaming loop: up to 3 batches in flight,
        # with eager in-order draining of ready batches (non-blocking
        # ``is_ready``) so collects ride the gaps between device steps
        # instead of serializing against them (docs/scaling.md rule 9).
        # Lookback for batch i+1 comes from host-known chunks, so
        # dispatch never waits on results.
        prev_tail: NDArray[np.float32] | None = None
        pending: list[tuple[Any, int]] = []
        base_index = 0

        def drain_one() -> None:
            nonlocal base_index
            dispatched, n_real = pending.pop(0)
            # Padding rows are discarded before folding, so they never
            # contribute timestamps and base_index advances by real chunks.
            results = bank.collect_chunks_batch(dispatched)[:n_real]
            base_index = self._fold_batch_results(
                results, base_index, all_peak_times, sr
            )

        batches = [
            chunks[s : s + batch_size]
            for s in range(0, len(chunks), batch_size)
        ]
        in_flight_cap = 3
        for batch in batches:
            # Zero-pad a short final batch to ``batch_size`` so every
            # dispatch reuses the ONE compiled B-row program — a leftover
            # batch of a different size would compile (and cache) a whole
            # second executable, like flush_batch in find_clip_in_audio.
            n_real = len(batch)
            # Padding rows take the stream's dtype so an all-int16 batch
            # stays on the bit-pack path even without the native packer
            # (see flush_batch in find_clip_in_audio).
            padded = batch + [
                np.zeros(chunk_samples, dtype=batch[-1].dtype)
                for _ in range(batch_size - n_real)
            ]
            pending.append(
                (bank.dispatch_chunks_batch(padded, prev_tail, batch_mode), n_real)
            )
            prev_tail = batch[-1]
            while len(pending) > 1 and _dispatched_ready(pending[0][0]):
                drain_one()
            if len(pending) > in_flight_cap:
                drain_one()
        while pending:
            drain_one()

        total_time = len(audio) / sr
        return all_peak_times, total_time

    def peaks_to_times(
        self,
        clip_peaks: dict[str, list[int]],
        index: int,
        had_prev: bool,
    ) -> dict[str, list[float]]:
        """One chunk's device peak positions → stream timestamps.

        The reference algebra: t = pos/sr − subtract + index·chunk_s −
        clip_seconds, clamped ≥ 0, subtract = sliding_window for chunks
        with lookback (reference: audio_pattern_detector.py:440-452)."""
        sr = self.target_sample_rate
        out: dict[str, list[float]] = {}
        for audio_clip in self.audio_clips:
            name = audio_clip.name
            sliding_window = self._clip_datas[name]["sliding_window"]
            clip_seconds = len(self._clip_datas[name]["clip"]) / sr
            subtract = sliding_window if had_prev else 0
            times = []
            for pos in clip_peaks.get(name, []):
                t = pos / sr - subtract + index * self.seconds_per_chunk
                t -= clip_seconds
                times.append(t if t >= 0 else 0)
            out[name] = times
        return out

    def _fold_batch_results(
        self,
        results: list[dict[str, list[int]]],
        base_index: int,
        all_peak_times: dict[str, list[float]],
        sr: int,
    ) -> int:
        """Convert one batch's device peak positions to stream timestamps."""
        for bi, clip_peaks in enumerate(results):
            index = base_index + bi
            converted = self.peaks_to_times(clip_peaks, index, index > 0)
            for name, times in converted.items():
                all_peak_times[name].extend(times)
        return base_index + len(results)

    def _process_chunk_debug(
        self,
        chunk: NDArray[np.float32],
        previous_chunk: NDArray[np.float32] | None,
        index: int,
    ) -> dict[str, list[int]]:
        """Exact host path with full debug artifacts (one clip at a time,
        like the reference's per-clip loop)."""
        from audio_pattern_detector_tpu.models import hostpath
        from audio_pattern_detector_tpu.utils.timefmt import seconds_to_time

        sr = self.target_sample_rate
        sink = self._debug_sink()
        section_ts = seconds_to_time(
            seconds=index * self.seconds_per_chunk, include_decimals=False
        )
        results: dict[str, list[int]] = {}
        for audio_clip in self.audio_clips:
            name = audio_clip.name
            cd = self._clip_datas[name]
            sw = cd["sliding_window"]
            if previous_chunk is not None:
                section = np.concatenate((previous_chunk[int(-sw * sr):], chunk))
            else:
                section = chunk
            verification = self._clip_strategy_params.get(name, {}).get("verification", {})
            results[name] = hostpath.process_section_host(
                audio_section=section,
                clip=cd["clip"],
                correlation_clip=cd["correlation_clip"],
                correlation_clip_absolute_max=float(cd["correlation_clip_absolute_max"]),
                sr=sr,
                height_min=self.height_min if self.height_min is not None else 0.25,
                is_short_clip=len(cd["clip"]) / sr < SHORT_CLIP_DURATION_THRESHOLD,
                tone_frequency=self._tone_frequencies.get(name),
                verification_params=verification,
                debug=sink,
                clip_name=name,
                index=index,
                section_ts=section_ts,
            )
        return results
