"""Match orchestration: pattern resolution, stream wrappers, JSONL output.

Behavioural parity with the reference orchestration layer
(reference: audio_pattern_detector/match.py): resolves pattern files
(including folder globs of ``*.wav`` + ``*.apd.toml``), builds an
``AudioStream`` from a WAV file / ffmpeg decode / stdin, drives the
detector, and emits streaming JSONL events (``start`` / ``pattern_detected``
/ ``end``) with per-clip equal-millisecond dedup. stdout carries only
machine-readable JSONL; all human diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import wave
from collections.abc import Callable
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu.models.detector import (
    AudioPatternDetector,
    PatternDetectedCallback,
    StreamCheckpoint,
)
from audio_pattern_detector_tpu.utils.audio_io import (
    DEFAULT_TARGET_SAMPLE_RATE,
    ffmpeg_get_float32_pcm,
    resample_audio,
)
from audio_pattern_detector_tpu.utils.clip import AudioClip, AudioStream
from audio_pattern_detector_tpu.utils.timefmt import seconds_to_time


@dataclass
class EngineOptions:
    """Everything the engine run needs beyond the input source.

    One object threads through the CLI handlers, the library entry point,
    and the stream-specific runners, replacing a dozen parallel kwargs.
    Defaults mirror the CLI defaults."""

    seconds_per_chunk: int | None = 60
    chunk_auto_perf: bool = False
    target_sample_rate: int = DEFAULT_TARGET_SAMPLE_RATE
    debug_mode: bool = False
    debug_dir: str = "./tmp"
    height_min: float | None = None
    profile: bool = False
    trace_dir: str | None = None
    offline_batch: int | None = None
    offline_batch_mode: str = "scan"
    # None = auto: 3 chunks in flight. Results are collected eagerly in
    # order (emission is NOT deferred by depth), so the deep default is
    # latency-free and hides the per-launch round trip + host decode.
    pipeline_depth: int | None = None
    stream_batch: int = 1
    stream_batch_mode: str = "scan"
    # Device-mesh sharding (parallel/sequence.py): split the scan across
    # mesh_time devices along time (halo-exchange sequence parallelism)
    # and optionally mesh_bank devices across the pattern bank. Identical
    # detections; events emitted per mesh_time-chunk slab.
    mesh_time: int | None = None
    mesh_bank: int = 1
    # Data parallelism over FILES (match_pattern_many_parallel): scan N
    # audio files concurrently, one batched device round per chunk
    # cadence, rows partitioned across a "stream" mesh axis of this size
    # (1 = single-device batching). Multi-file mode only.
    mesh_stream: int = 1
    # Persist a StreamCheckpoint to this path after every chunk (atomic
    # replace) and resume from it when it already exists; removed on a
    # clean end of stream. Streaming loop only.
    checkpoint_file: str | None = None

    def validate(self, from_stdin: bool) -> None:
        """Reject option combinations the engine cannot honour.

        Shared by every entry surface (file, --stdin, --multiplexed-stdin)
        so the same flags fail the same way everywhere. ``from_stdin``
        covers both plain and multiplexed stdin: live streams have no
        whole-file batch path."""
        if self.offline_batch is not None and (from_stdin or self.offline_batch < 1):
            raise ValueError(
                "offline_batch requires file mode and a positive batch size"
            )
        if self.offline_batch_mode not in ("vmap", "scan"):
            raise ValueError(
                "offline_batch_mode must be 'vmap' or 'scan', "
                f"got {self.offline_batch_mode!r}"
            )
        if self.pipeline_depth is not None and self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}"
            )
        if self.stream_batch < 1:
            raise ValueError(
                f"stream_batch must be >= 1, got {self.stream_batch}"
            )
        if self.mesh_bank < 1:
            raise ValueError(f"mesh_bank must be >= 1, got {self.mesh_bank}")
        if self.mesh_time is not None:
            if self.mesh_time < 1:
                raise ValueError("mesh axis sizes must be positive")
            incompatible = [
                name
                for name, active in (
                    ("debug", self.debug_mode),
                    ("offline_batch", self.offline_batch is not None),
                    ("stream_batch", self.stream_batch > 1),
                    ("pipeline_depth", self.pipeline_depth is not None),
                )
                if active
            ]
            if incompatible:
                raise ValueError(
                    "mesh sharding is incompatible with: " + ", ".join(incompatible)
                )
        elif self.mesh_bank > 1:
            raise ValueError("mesh_bank requires mesh_time")
        if self.mesh_stream != 1:
            if self.mesh_stream < 1:
                raise ValueError(
                    f"mesh_stream must be >= 1, got {self.mesh_stream}"
                )
            incompatible = [
                name
                for name, active in (
                    ("stdin", from_stdin),
                    ("debug", self.debug_mode),
                    ("profile", self.profile),
                    ("trace_dir", self.trace_dir is not None),
                    ("offline_batch", self.offline_batch is not None),
                    ("stream_batch", self.stream_batch > 1),
                    ("mesh_time", self.mesh_time is not None),
                    ("checkpoint_file", self.checkpoint_file is not None),
                )
                if active
            ]
            if incompatible:
                raise ValueError(
                    "mesh_stream is incompatible with: "
                    + ", ".join(incompatible)
                )
        if self.checkpoint_file is not None:
            incompatible = [
                name
                for name, active in (
                    ("debug", self.debug_mode),
                    ("offline_batch", self.offline_batch is not None),
                    ("mesh_time", self.mesh_time is not None),
                )
                if active
            ]
            if incompatible:
                raise ValueError(
                    "checkpoint_file is incompatible with: "
                    + ", ".join(incompatible)
                )

    def build_detector(self, clips: list[AudioClip]) -> AudioPatternDetector:
        return AudioPatternDetector(
            audio_clips=clips,
            debug_mode=self.debug_mode,
            seconds_per_chunk=self.seconds_per_chunk,
            target_sample_rate=self.target_sample_rate,
            debug_dir=self.debug_dir,
            height_min=self.height_min,
        )


def _emit_jsonl(event_type: str, **kwargs: Any) -> None:
    """Emit a JSONL event to stdout, flushing immediately."""
    event = {"type": event_type, **kwargs}
    print(json.dumps(event, ensure_ascii=False), flush=True)


def _read_uint32(stream: Any) -> int:
    data = stream.read(4)
    if len(data) < 4:
        raise ValueError(f"Unexpected EOF reading uint32 (got {len(data)} bytes)")
    return int.from_bytes(data, byteorder="little", signed=False)


def _read_patterns_from_multiplexed_stdin(target_sample_rate: int) -> list[AudioClip]:
    """Read pattern clips from the multiplexed stdin protocol.

    Wire format (uint32 little-endian lengths):
        [n_patterns] then per pattern [name_len][name utf8][data_len][wav bytes],
    followed by the WAV audio stream until EOF. Limits: <=100 patterns,
    names <=1024 B, patterns <=100 MB (reference: match.py:38-95).
    """
    stdin = sys.stdin.buffer
    num_patterns = _read_uint32(stdin)
    if num_patterns == 0:
        raise ValueError("No patterns provided in multiplexed stdin")
    if num_patterns > 100:
        raise ValueError(f"Too many patterns ({num_patterns}), max is 100")

    print(f"Reading {num_patterns} pattern(s) from multiplexed stdin...", file=sys.stderr)

    pattern_clips: list[AudioClip] = []
    for i in range(num_patterns):
        name_length = _read_uint32(stdin)
        if name_length == 0 or name_length > 1024:
            raise ValueError(f"Invalid pattern name length: {name_length}")
        name_bytes = stdin.read(name_length)
        if len(name_bytes) < name_length:
            raise ValueError(f"Unexpected EOF reading pattern name {i + 1}")
        name = name_bytes.decode("utf-8")

        data_length = _read_uint32(stdin)
        if data_length == 0:
            raise ValueError(f"Pattern '{name}' has zero-length data")
        if data_length > 100 * 1024 * 1024:
            raise ValueError(f"Pattern '{name}' data too large: {data_length} bytes")
        wav_data = stdin.read(data_length)
        if len(wav_data) < data_length:
            raise ValueError(f"Unexpected EOF reading pattern '{name}' data")

        clip = AudioClip.from_wav_bytes(wav_data, name, sample_rate=target_sample_rate)
        pattern_clips.append(clip)
        print(
            f"  Loaded pattern '{name}' ({clip.clip_length_seconds():.2f}s)",
            file=sys.stderr,
        )
    return pattern_clips


def _seek_riff_chunk(stream: Any, want: bytes, missing_msg: str) -> int:
    """Advance ``stream`` to the payload of RIFF chunk ``want``, skipping
    others; returns the found chunk's declared size.

    Skipped odd-sized chunks consume their RIFF pad byte (chunks are
    word-aligned; e.g. a 3-byte LIST payload is followed by one pad
    byte) — without this the walk desyncs and rejects spec-conformant
    WAVs. The reference parser lacks the pad skip (reference:
    match.py:268-283); this accepts a superset of its inputs with the
    same error strings (docs/reference-parity.md)."""
    import struct

    while True:
        chunk_id = stream.read(4)
        if len(chunk_id) < 4:
            raise ValueError(missing_msg)
        size_bytes = stream.read(4)
        if len(size_bytes) < 4:
            raise ValueError("WAV file truncated")
        size = struct.unpack("<I", size_bytes)[0]
        if chunk_id == want:
            return size
        if len(stream.read(size)) != size:
            raise ValueError("WAV file truncated while skipping chunk")
        if size % 2:
            # Missing pad at EOF surfaces as missing_msg next iteration.
            stream.read(1)


def _validate_wav_header(stream: Any, target_sample_rate: int) -> tuple[int, int]:
    """Walk RIFF chunks and validate a streamable WAV header.

    Accepts mono 16/32-bit PCM or 32-bit IEEE float at exactly the target
    rate (stdin audio must be pre-resampled; reference: match.py:215-283).
    Leaves the stream positioned at the data payload and returns
    (audio_format, bits_per_sample).
    """
    import struct

    riff = stream.read(4)
    if riff != b"RIFF":
        raise ValueError(f"Not a WAV file: expected RIFF, got {riff!r}")
    stream.read(4)  # file size (ignored)
    wave_sig = stream.read(4)
    if wave_sig != b"WAVE":
        raise ValueError(f"Not a WAV file: expected WAVE, got {wave_sig!r}")

    fmt_size = _seek_riff_chunk(stream, b"fmt ", "WAV file missing fmt chunk")
    fmt_data = stream.read(fmt_size)
    if len(fmt_data) < 16:
        raise ValueError("WAV fmt chunk too short")
    if fmt_size % 2 and len(fmt_data) == fmt_size:
        stream.read(1)  # RIFF pad byte after an odd-sized fmt payload
    audio_format, channels, sample_rate, _, _, bits_per_sample = struct.unpack(
        "<HHIIHH", fmt_data[:16]
    )

    if audio_format == 1:  # integer PCM
        if bits_per_sample not in (16, 32):
            raise ValueError(f"Expected 16-bit or 32-bit PCM, got {bits_per_sample}")
    elif audio_format == 3:  # IEEE float
        if bits_per_sample != 32:
            raise ValueError(f"Expected 32-bit float, got {bits_per_sample}")
    else:
        raise ValueError(f"Expected PCM (1) or IEEE float (3) format, got {audio_format}")
    if channels != 1:
        raise ValueError(f"Expected mono (1 channel), got {channels}")
    if sample_rate != target_sample_rate:
        raise ValueError(f"Expected {target_sample_rate} Hz, got {sample_rate}")

    _seek_riff_chunk(stream, b"data", "WAV file missing data chunk")
    return audio_format, bits_per_sample


# Sample decode table: numpy dtype + scale to float32 in [-1, 1), keyed by
# (wav_audio_format, bits_per_sample). Shared by both stream wrappers.
_SAMPLE_CODECS: dict[tuple[int, int], tuple[np.dtype, float]] = {
    (1, 16): (np.dtype(np.int16), 1.0 / 32768.0),
    (1, 32): (np.dtype(np.int32), 1.0 / 2147483648.0),
    (3, 32): (np.dtype(np.float32), 1.0),
}


def _decode_samples(
    data: bytes, dtype: np.dtype, scale: float
) -> NDArray[np.float32]:
    raw = np.frombuffer(data, dtype=dtype)
    if scale == 1.0 and dtype == np.float32:
        return raw  # already float32 — zero-copy
    if dtype == np.int16 or dtype == np.int32:
        # C fast path when the native library is built, numpy otherwise —
        # BITWISE identical either way (cast to f32, then scale in f32;
        # pinned by tests/test_native.py), so stdin/serve streams decode
        # the same bits regardless of the runtime.
        from audio_pattern_detector_tpu import native

        decode = (
            native.pcm16_to_f32_mono
            if dtype == np.int16
            else native.pcm32_to_f32_mono
        )
        return decode(raw)
    return (raw.astype(np.float32) * np.float32(scale)).astype(np.float32)


class _WavStdinStreamWrapper:
    """Stream PCM from a WAV on stdin (header-validated).

    16-bit sources stream their raw int16 bytes (``output_dtype`` int16 —
    the engine's passthrough fast path: no host f32 decode, no packed-
    upload re-quantise, bit-identical results); other codecs decode to
    float32 as before."""

    def __init__(self, target_sample_rate: int) -> None:
        audio_format, bits = _validate_wav_header(
            sys.stdin.buffer, target_sample_rate
        )
        self._dtype, self._scale = _SAMPLE_CODECS[(audio_format, bits)]
        self.output_dtype = (
            np.int16 if self._dtype == np.int16 else np.float32
        )
        fmt_name = "float32" if audio_format == 3 else f"int{bits}"
        print(f"WAV stdin: {target_sample_rate}Hz, mono, {fmt_name}", file=sys.stderr)

    def read(self, size: int, /) -> bytes:
        # ``size`` is in bytes of the OUTPUT dtype (int16 passthrough: 2
        # bytes/sample; decoded float32: 4).
        out_itemsize = 2 if self.output_dtype == np.int16 else 4
        target_samples = size // out_itemsize
        data = sys.stdin.buffer.read(target_samples * self._dtype.itemsize)
        if not data:
            return b""
        partial = len(data) % self._dtype.itemsize
        if partial:
            # Stream truncated mid-sample (writer died): drop the partial
            # trailing bytes and finish cleanly rather than crash decode.
            print(
                f"Warning: WAV stdin stream truncated mid-sample "
                f"({partial} trailing byte(s) dropped)",
                file=sys.stderr,
            )
            data = data[: len(data) - partial]
            if not data:
                return b""
        if self.output_dtype == np.int16:
            return data
        return _decode_samples(data, self._dtype, self._scale).tobytes()


class _WavFileStreamWrapper:
    """Stream PCM from a WAV file, resampling incrementally.

    The dominant case — 16-bit mono at the target rate — streams raw
    int16 bytes (``output_dtype`` int16, the engine's passthrough fast
    path: no host f32 decode, no packed-upload re-quantise, bit-identical
    results). Anything needing mixdown, widening, or resample decodes to
    float32 as before."""

    def __init__(self, file_path: str, target_sample_rate: int) -> None:
        self.target_sample_rate = target_sample_rate
        self._validated = False
        self._file_path = file_path
        try:
            self._wav: wave.Wave_read = wave.open(file_path, "rb")
        except (wave.Error, FileNotFoundError, OSError) as e:
            raise ValueError(f"Failed to read WAV file {file_path}: {e}")
        self.input_sample_rate = self._wav.getframerate()
        self._channels = self._wav.getnchannels()
        self._sampwidth = self._wav.getsampwidth()
        self.needs_resample = self.input_sample_rate != target_sample_rate
        self.output_dtype = (
            np.int16
            if (
                self._sampwidth == 2
                and self._channels == 1
                and not self.needs_resample
            )
            else np.float32
        )
        self._bytes_per_sample = 2 if self.output_dtype == np.int16 else 4
        if self._channels != 1:
            print(
                f"Warning: WAV has {self._channels} channels, will be mixed to mono",
                file=sys.stderr,
            )

    def _validate_first_chunk(self, audio: NDArray[Any]) -> None:
        """Warn (stderr) about NaN/Inf/over-range/all-zero first chunks.

        int16 passthrough chunks can only ever trip the all-zeros check
        (decoded int16 is never NaN/Inf and never exceeds ±1), so the
        float-only checks are skipped — identical warnings either way."""
        if self._validated or len(audio) == 0:
            return
        self._validated = True
        warnings: list[str] = []
        if audio.dtype != np.int16:
            if np.any(np.isnan(audio)):
                warnings.append("Audio contains NaN values - data may be corrupt")
            if np.any(np.isinf(audio)):
                warnings.append("Audio contains Inf values - data may be corrupt")
            max_abs = np.max(np.abs(audio))
            if max_abs > 1.5:
                warnings.append(f"Audio values exceed expected range (max: {max_abs:.2f})")
        if np.all(audio == 0):
            warnings.append("First chunk is all zeros - verify input is correct")
        for warning in warnings:
            print(f"Warning: {warning}", file=sys.stderr)

    def read(self, size: int, /) -> bytes:
        # ``size`` is in bytes of the OUTPUT dtype (int16 passthrough: 2
        # bytes/sample; decoded float32: 4).
        target_samples = size // self._bytes_per_sample
        if self.needs_resample:
            input_samples = int(
                target_samples * self.input_sample_rate / self.target_sample_rate
            )
        else:
            input_samples = target_samples

        raw_data = self._wav.readframes(input_samples)
        if not raw_data:
            return b""

        if self.output_dtype == np.int16:
            if not self._validated:
                self._validate_first_chunk(
                    np.frombuffer(raw_data, dtype=np.int16)
                )
            return raw_data

        if self._sampwidth == 2:
            audio = _decode_samples(raw_data, *(_SAMPLE_CODECS[(1, 16)]))
        elif self._sampwidth == 4:
            audio = _decode_samples(raw_data, *(_SAMPLE_CODECS[(1, 32)]))
        elif self._sampwidth == 1:
            # stdlib wave yields unsigned 8-bit; centre then scale.
            audio = (
                np.frombuffer(raw_data, dtype=np.uint8).astype(np.float32) - 128.0
            ) / 128.0
        else:
            raise ValueError(f"Unsupported WAV sample width: {self._sampwidth} bytes")

        if self._channels > 1:
            audio = audio.reshape(-1, self._channels).mean(axis=1).astype(np.float32)

        if not self._validated:
            self._validate_first_chunk(audio)

        if self.needs_resample:
            audio = resample_audio(audio, self.input_sample_rate, self.target_sample_rate)
        return audio.tobytes()

    def close(self) -> None:
        self._wav.close()




def _scan(
    detector: AudioPatternDetector,
    stream: AudioStream,
    opts: EngineOptions,
    on_pattern_detected: PatternDetectedCallback | None,
    accumulate_results: bool,
) -> tuple[dict[str, list[float]] | None, float]:
    """Run one stream through the detector under ``opts``.

    Two execution shapes: the streaming loop (live emission, optional
    pipelining / stream batching), or — when ``opts.offline_batch`` is set
    — the whole-stream batched scan via ``find_clip_in_array`` (identical
    chunking/lookback/timestamp algebra, ``offline_batch`` chunks per
    device launch, events fired post-scan in timestamp order)."""
    from audio_pattern_detector_tpu.utils.profiling import device_trace

    if opts.mesh_time:
        with device_trace(opts.trace_dir):
            return _scan_sharded(
                detector, stream, opts, on_pattern_detected, accumulate_results
            )
    # The engine's per-chunk read size in bytes of the STREAM's dtype
    # (int16 passthrough sources stream 2 bytes/sample, f32 sources 4).
    chunk_bytes = (detector._chunk_size // 4) * stream.resolved_dtype().itemsize
    with device_trace(opts.trace_dir):
        if opts.offline_batch is None:
            resume: StreamCheckpoint | None = None
            on_checkpoint = None
            if opts.checkpoint_file:
                resume = _load_checkpoint_file(opts.checkpoint_file)
                if resume is not None:
                    _skip_stream_samples(
                        stream,
                        round(resume.total_time * detector.target_sample_rate),
                        chunk_bytes,
                    )
                on_checkpoint = _checkpoint_writer(opts.checkpoint_file)
            result = detector.find_clip_in_audio(
                stream,
                on_pattern_detected=on_pattern_detected,
                accumulate_results=accumulate_results,
                checkpoint=resume,
                on_checkpoint=on_checkpoint,
                # Default in-flight cap 3: results are collected eagerly
                # (emission is not deferred by depth — see
                # find_clip_in_audio), so the deeper default is
                # latency-free and hides the per-launch round trip.
                pipeline_depth=(
                    3 if opts.pipeline_depth is None else opts.pipeline_depth
                ),
                stream_batch=opts.stream_batch,
                stream_batch_mode=opts.stream_batch_mode,
            )
            if opts.checkpoint_file:
                # The stream completed: a leftover checkpoint would make
                # the next run of the same command skip everything.
                try:
                    os.remove(opts.checkpoint_file)
                except FileNotFoundError:
                    pass
        else:
            audio = _drain_stream(stream, chunk_bytes)
            peak_times, total_time = detector.find_clip_in_array(
                audio,
                batch_size=opts.offline_batch,
                batch_mode=opts.offline_batch_mode,
            )
            if on_pattern_detected is not None:
                for t, name in sorted(
                    (t, name) for name, ts in peak_times.items() for t in ts
                ):
                    on_pattern_detected(name, t)
            result = (peak_times if accumulate_results else None), total_time

    if opts.profile:
        stats = getattr(detector, "last_run_stats", None)
        if stats is not None:
            print(f"profile: {json.dumps(stats.as_dict())}", file=sys.stderr)
    return result


def _load_checkpoint_file(path: str) -> StreamCheckpoint | None:
    """Resume state from a previous interrupted run, or None when absent.

    Corrupt/truncated files raise the StreamCheckpoint parse errors —
    silently restarting from zero would double-emit every event the
    interrupted run already published.
    """
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return None
    with open(path, "rb") as f:
        ck = StreamCheckpoint.from_bytes(f.read())
    print(
        f"Resuming from checkpoint {path}: chunk {ck.chunk_index}, "
        f"{ck.total_time:.1f}s already processed",
        file=sys.stderr,
    )
    return ck


def _skip_stream_samples(
    stream: AudioStream, n_samples: int, chunk_bytes: int
) -> None:
    """Advance a float32 stream past already-processed audio on resume.

    The engine contract wants the stream positioned at the checkpoint's
    chunk boundary (models/detector.py find_clip_in_audio); for the CLI
    that means re-feeding the same source and discarding what the
    interrupted run consumed (total_time · sr samples — exact, since
    total_time accumulates len(chunk)/sr per chunk).

    Reads MUST request ``chunk_bytes`` — the engine's per-chunk read
    size — not an arbitrary block size: a resampling source
    (_WavFileStreamWrapper on a non-target-rate file) consumes
    ``int(target_samples · in_rate / out_rate)`` input frames per read,
    so the input-file position after N skip reads depends on the request
    partitioning (each non-whole-second request truncates a fractional
    input frame). Replaying the interrupted run's exact request sequence
    makes the resume position exact by construction; arbitrary blocks
    (e.g. 4 MiB = 131.072 s) would drift the position on long resumes
    and silently shift post-resume waveforms and detections.
    """
    bps = stream.resolved_dtype().itemsize
    target = n_samples * bps
    skipped = 0
    while skipped < target:
        data = stream.audio_stream.read(chunk_bytes)
        if not data:
            raise ValueError(
                f"stream ended {(target - skipped) // bps} samples before "
                "the checkpoint position — is this the same source the "
                "checkpoint came from?"
            )
        skipped += len(data)
    if skipped > target:
        raise ValueError(
            "stream read past the checkpoint position (chunk reads "
            f"overshot by {(skipped - target) // bps} samples) — was the "
            "interrupted run using a different --chunk-seconds?"
        )


def _checkpoint_writer(path: str) -> "Callable[[StreamCheckpoint], None]":
    """Per-chunk atomic checkpoint persistence (write tmp + rename, so a
    crash mid-write never leaves a torn file to resume from)."""
    tmp = path + ".tmp"

    def write(ck: StreamCheckpoint) -> None:
        with open(tmp, "wb") as f:
            f.write(ck.to_bytes())
        os.replace(tmp, path)

    return write


def _drain_stream(stream: AudioStream, chunk_bytes: int) -> NDArray[Any]:
    """Read an AudioStream to exhaustion (offline scan input) — float32,
    or raw int16 for passthrough sources (find_clip_in_array feeds int16
    straight to the bit-pack upload).

    Reads MUST request ``chunk_bytes`` — the engine's per-chunk read
    size — not an arbitrary block size: a resampling source
    (_WavFileStreamWrapper on a non-target-rate file) FFT-resamples each
    read request independently, so the decoded waveform depends on the
    request partitioning (see _skip_stream_samples). Chunk-sized requests
    make the offline scan read the exact waveform the streaming loop
    reads, preserving the streaming-identical results contract."""
    bufs = []
    while True:
        b = stream.audio_stream.read(chunk_bytes)
        if not b:
            break
        bufs.append(b)
    # int16 passthrough sources drain to an int16 array, which
    # find_clip_in_array feeds straight to the bit-pack upload.
    return np.frombuffer(b"".join(bufs), dtype=stream.resolved_dtype())


def _read_full(raw_stream: Any, n_bytes: int) -> bytes:
    """Read exactly ``n_bytes`` unless the stream ends first (pipes may
    return short reads mid-stream; the sharded session needs full slabs
    except the final one)."""
    bufs: list[bytes] = []
    got = 0
    while got < n_bytes:
        b = raw_stream.read(n_bytes - got)
        if not b:
            break
        bufs.append(b)
        got += len(b)
    return b"".join(bufs)


def _scan_sharded(
    detector: AudioPatternDetector,
    stream: AudioStream,
    opts: EngineOptions,
    on_pattern_detected: PatternDetectedCallback | None,
    accumulate_results: bool,
) -> tuple[dict[str, list[float]] | None, float]:
    """Run one stream through a device-mesh ShardedDetector.

    The mesh is (bank?, time): ``opts.mesh_time`` chunks process
    concurrently on that many devices with halo-exchanged lookback
    (parallel/sequence.py), and ``opts.mesh_bank`` > 1 additionally
    shards the pattern bank. Detections are serial-engine-identical
    (pinned by tests/test_parallel_corpus.py); events are emitted per
    slab — up to mesh_time × chunk_seconds of added latency versus the
    serial per-chunk loop."""
    from audio_pattern_detector_tpu.parallel.mesh import make_mesh
    from audio_pattern_detector_tpu.parallel.sequence import ShardedDetector

    # The ShardedDetector (mesh layout + its compiled sharded programs) is
    # memoized on the serial detector so multi-file runs pay the sharded
    # trace/compile once; per-file stream state lives in the session.
    key = (opts.mesh_bank, int(opts.mesh_time or 1))
    cached = getattr(detector, "_sharded_scan_cache", None)
    if cached is not None and cached[0] == key:
        sd = cached[1]
    else:
        axes: dict[str, int] = {}
        if opts.mesh_bank > 1:
            axes["bank"] = opts.mesh_bank
        axes["time"] = key[1]
        mesh = make_mesh(axes)
        sd = ShardedDetector(
            detector.audio_clips,
            mesh,
            chunk_seconds=detector.seconds_per_chunk,
            target_sample_rate=opts.target_sample_rate,
            height_min=opts.height_min,
            detector=detector,
        )
        detector._sharded_scan_cache = (key, sd)
    sess = sd.session()
    # The sharded session consumes f32 slabs; an int16 passthrough source
    # decodes at the slab boundary with the pinned cast (the sharded path
    # keeps today's f32 feed — passthrough's pack savings only apply to
    # the serial/batch dispatch paths).
    stream_dtype = stream.resolved_dtype()
    slab_bytes = sd.slab_samples * stream_dtype.itemsize
    chunk_bytes = sd.chunk_samples * stream_dtype.itemsize
    accumulated: dict[str, list[float]] | None = (
        {name: [] for cls in sd.bank.classes.values() for g in cls["groups"] for name in g.names}
        if accumulate_results
        else None
    )
    total_samples = 0
    while True:
        # Build the slab from chunk-sized read requests — the exact
        # request partition the serial streaming loop issues — so a
        # resampling source decodes the identical waveform (see
        # _drain_stream / _skip_stream_samples: per-request FFT resample
        # makes the waveform depend on the read partitioning).
        parts: list[bytes] = []
        for _ in range(sd.time_size):
            b = _read_full(stream.audio_stream, chunk_bytes)
            if b:
                parts.append(b)
            if len(b) < chunk_bytes:
                break
        if not parts:
            break
        buf = b"".join(parts)
        slab = np.frombuffer(buf, dtype=stream_dtype)
        if slab.dtype == np.int16:
            from audio_pattern_detector_tpu.models.bank import _pcm16_to_f32

            slab = _pcm16_to_f32(slab)
        part = sess.feed(slab)
        total_samples += len(slab)
        events = sorted(
            (t, name) for name, per_stream in part.items() for t in per_stream[0]
        )
        for t, name in events:
            if accumulated is not None:
                accumulated[name].append(t)
            if on_pattern_detected is not None:
                on_pattern_detected(name, t)
        if len(buf) < slab_bytes:
            break
    return accumulated, total_samples / sd.sample_rate


# Big-chunk cap: the correlation stage is linear in chunk seconds, so
# past some size a bigger chunk amortises no more launch cost. The
# flag-free file path amortises launches by SCAN-BATCHING 60 s chunks
# instead (_auto_perf_plan below); this cap still sizes the mesh-time
# path and debug runs, where stream batching is unavailable. The value
# has not been measured on the GPU.
AUTO_PERF_MAX_CHUNK_SECONDS = 120

# Launch-amortisation width for the flag-free file path: B consecutive
# 60 s chunks per device launch via the in-launch sequential scan — the
# same width the `--stream-batch 8` / `--offline-batch` recommendations
# use. The value has not been measured on the GPU.
AUTO_PERF_STREAM_BATCH = 8


def _probe_duration_seconds(audio_source: str) -> float | None:
    """Duration of a source file, or None when unprobeable.

    Auto-perf sizing is an optimisation, so any probe failure (corrupt
    header, missing ffprobe) degrades to "unknown" instead of raising."""
    from audio_pattern_detector_tpu.utils.audio_io import get_audio_duration

    if audio_source.lower().endswith(".wav"):
        try:
            with wave.open(audio_source, "rb") as w:
                rate = w.getframerate()
                return w.getnframes() / rate if rate else None
        except (wave.Error, OSError):
            return None
    # get_audio_duration raises when ffprobe fails (or is missing).
    try:
        return get_audio_duration(audio_source)
    except (ValueError, OSError):
        return None


def _auto_perf_chunk_seconds(
    audio_source: str, pattern_clips: list[AudioClip], sr: int
) -> int:
    """Big-chunk default sizing: as few launches as the file allows.

    Detections are chunk-size-invariant (pinned by the offline-scan and
    big-chunk equivalence tests), but every chunk pays a fixed per-launch
    cost on remote device runtimes — so this policy sizes chunks up to
    AUTO_PERF_MAX_CHUNK_SECONDS from the file duration instead of
    shipping the live-stream 60 s default. Small files keep 60 s chunks
    (single launch anyway; also keeps behaviour identical to the
    reference corpus flows). Falls back to 60 when the duration is
    unprobeable. Used where in-launch chunk batching is unavailable
    (mesh-time sharded scans, debug runs); everywhere else the file-mode
    default is _auto_perf_plan's 60 s scan-batching."""
    duration = _probe_duration_seconds(audio_source)
    if duration is None or duration <= 60:
        chunk = 60
    else:
        chunk = min(AUTO_PERF_MAX_CHUNK_SECONDS, int(np.ceil(duration)))
    # The engine requires seconds_per_chunk >= 2x the largest sliding
    # window (reference: audio_pattern_detector.py:122-136).
    max_sw = max(
        (max(1, int(np.ceil(c.clip_length_seconds()))) for c in pattern_clips),
        default=1,
    )
    return max(chunk, 2 * max_sw)


def _auto_perf_plan(
    audio_source: str, pattern_clips: list[AudioClip], sr: int
) -> tuple[int, int]:
    """File-mode default launch plan: (seconds_per_chunk, stream_batch).

    Scan-batching B x 60 s chunks in one launch pays the per-launch
    cost once per batch while KEEPING the 60 s overlap-save geometry
    (big chunks amortise the launch but inflate the correlation and
    candidate-scan work per chunk). So the flag-free file path keeps the
    60 s default chunk and batches consecutive chunks per launch,
    instead of enlarging chunks (_auto_perf_chunk_seconds still sizes
    mesh-time/debug runs). Results are chunk-size- AND
    batch-invariant (tests/test_stream_batch.py, tests/test_offline_scan.py).

    The batch width is balanced across the file's launches so a short
    final batch zero-pads as little as possible (padding rows compute
    real FFTs before their results are discarded): 9 chunks run as 2
    launches of 5, not 8 + 1-padded-to-8. Unknown duration keeps
    (60, 1) — batching blind would pad up to B-1 zero chunks on a
    sub-minute file. Clips longer than 30 s raise the chunk floor
    (engine requires >= 2x the largest sliding window, reference:
    audio_pattern_detector.py:122-136) and the batch re-balances on the
    raised chunk."""
    max_sw = max(
        (max(1, int(np.ceil(c.clip_length_seconds()))) for c in pattern_clips),
        default=1,
    )
    chunk = max(60, 2 * max_sw)
    duration = _probe_duration_seconds(audio_source)
    if duration is None or duration <= chunk:
        return chunk, 1
    n_chunks = int(np.ceil(duration / chunk))
    n_launches = int(np.ceil(n_chunks / AUTO_PERF_STREAM_BATCH))
    return chunk, int(np.ceil(n_chunks / n_launches))


def match_pattern(
    audio_source: str | None,
    pattern_files: list[str],
    debug_mode: bool = False,
    on_pattern_detected: PatternDetectedCallback | None = None,
    accumulate_results: bool = True,
    seconds_per_chunk: int | None = 60,
    chunk_seconds_auto_perf: bool = False,
    from_stdin: bool = False,
    target_sample_rate: int | None = None,
    debug_dir: str = "./tmp",
    height_min: float | None = None,
    profile: bool = False,
    trace_dir: str | None = None,
    offline_batch: int | None = None,
    offline_batch_mode: str = "scan",
    pipeline_depth: int | None = None,
    stream_batch: int = 1,
    stream_batch_mode: str = "scan",
    mesh_time: int | None = None,
    mesh_bank: int = 1,
    checkpoint_file: str | None = None,
) -> tuple[dict[str, list[float]] | None, float]:
    """Find pattern matches in an audio file or stdin stream.

    Library entry point with the reference's contract
    (reference: match.py:98-212). ``profile`` prints per-stage wall-clock
    stats to stderr after the run; ``trace_dir`` wraps the run in a
    jax.profiler device trace. ``offline_batch`` (file mode only) scans the
    whole file through the batched device path — N chunks per launch,
    streaming-identical results, events emitted post-scan.
    ``pipeline_depth`` caps how many chunks are in flight on the device
    (identical results; ready results are collected eagerly in order, so
    emission is not deferred by depth); None = auto (3).
    ``stream_batch`` runs that many consecutive chunks per device launch
    in the streaming loop (identical results; emission deferred to batch
    boundaries) — the live-stream launch amortiser.
    ``chunk_seconds_auto_perf`` (the CLI's file-mode default) applies the
    default launch plan for whole files: 60 s chunks scan-batched
    up to 8 per launch, width balanced across the file's launches
    (_auto_perf_plan; an explicit ``stream_batch`` keeps the caller's
    width, debug/mesh-time runs keep big-chunk sizing).
    ``checkpoint_file`` persists O(1) resume state after every chunk and
    resumes from the file when it exists (re-feed the same source; the
    already-processed prefix is skipped, and the resumed run's events
    continue exactly where the interrupted run stopped). Removed on a
    clean end of stream. Use the same chunk settings when resuming.
    """
    if not from_stdin:
        if audio_source is None or not os.path.exists(audio_source):
            raise ValueError(f"Audio {audio_source} does not exist")

    sr = target_sample_rate if target_sample_rate is not None else DEFAULT_TARGET_SAMPLE_RATE
    opts = EngineOptions(
        seconds_per_chunk=seconds_per_chunk,
        chunk_auto_perf=chunk_seconds_auto_perf,
        target_sample_rate=sr,
        debug_mode=debug_mode,
        debug_dir=debug_dir,
        height_min=height_min,
        profile=profile,
        trace_dir=trace_dir,
        offline_batch=offline_batch,
        offline_batch_mode=offline_batch_mode,
        pipeline_depth=pipeline_depth,
        stream_batch=stream_batch,
        stream_batch_mode=stream_batch_mode,
        mesh_time=mesh_time,
        mesh_bank=mesh_bank,
        checkpoint_file=checkpoint_file,
    )
    opts.validate(from_stdin)
    pattern_clips = _load_pattern_clips(pattern_files, sr)

    if from_stdin:
        return _match_pattern_wav_stdin(
            pattern_clips, opts, on_pattern_detected, accumulate_results
        )
    assert audio_source is not None
    return _match_pattern_file(
        audio_source, pattern_clips, opts, on_pattern_detected,
        accumulate_results,
    )


def match_pattern_many(
    audio_sources: list[str],
    pattern_files: list[str],
    on_pattern_detected: PatternDetectedCallback | None = None,
    on_file_start: Callable[[str], None] | None = None,
    on_file_end: Callable[[str, float], None] | None = None,
    accumulate_results: bool = True,
    seconds_per_chunk: int | None = 60,
    chunk_seconds_auto_perf: bool = False,
    target_sample_rate: int | None = None,
    height_min: float | None = None,
    profile: bool = False,
    trace_dir: str | None = None,
    offline_batch: int | None = None,
    offline_batch_mode: str = "scan",
    pipeline_depth: int | None = None,
    stream_batch: int = 1,
    stream_batch_mode: str = "scan",
    mesh_time: int | None = None,
    mesh_bank: int = 1,
) -> list[tuple[dict[str, list[float]] | None, float]]:
    """Scan MANY audio files against one pattern bank in a single process.

    Equivalent to calling :func:`match_pattern` once per file — identical
    detections and per-file timestamps — but the pattern clips are loaded
    and preprocessed once and the compiled device programs are shared
    across files, so per-file cost is just the scan itself. This is the
    batch-scanning surface the reference's one-process-per-file model
    lacks (reference: match.py:98 handles a single source per run).

    ``on_file_start(source)`` / ``on_file_end(source, total_time)`` fire
    around each file, in order; ``on_pattern_detected`` is shared across
    files (re-key any per-file state from ``on_file_start``). All sources
    are validated up front, before any scan starts. With
    ``chunk_seconds_auto_perf`` the launch plan (60 s chunks + balanced
    scan-batch width, _auto_perf_plan) is sized once from the longest
    file so every file shares one compiled program set. Debug mode is
    single-file only and not offered here.
    """
    if not audio_sources:
        raise ValueError("No audio sources passed")
    for src in audio_sources:
        if src is None or not os.path.exists(src):
            raise ValueError(f"Audio {src} does not exist")

    sr = target_sample_rate if target_sample_rate is not None else DEFAULT_TARGET_SAMPLE_RATE
    opts = EngineOptions(
        seconds_per_chunk=seconds_per_chunk,
        chunk_auto_perf=chunk_seconds_auto_perf,
        target_sample_rate=sr,
        height_min=height_min,
        profile=profile,
        trace_dir=trace_dir,
        offline_batch=offline_batch,
        offline_batch_mode=offline_batch_mode,
        pipeline_depth=pipeline_depth,
        stream_batch=stream_batch,
        stream_batch_mode=stream_batch_mode,
        mesh_time=mesh_time,
        mesh_bank=mesh_bank,
    )
    opts.validate(from_stdin=False)
    pattern_clips = _load_pattern_clips(pattern_files, sr)

    if (
        opts.chunk_auto_perf
        and opts.offline_batch is None
        and opts.mesh_time is None
    ):
        # One chunk size (and batch width) for the whole run, sized from
        # the longest file: every file then shares one compiled program
        # set (results are chunk-size- and batch-invariant, so this
        # changes throughput, not output). Debug runs keep the big-chunk
        # policy — the batched dispatch path has no artifact taps.
        if opts.debug_mode:
            opts.seconds_per_chunk = max(
                _auto_perf_chunk_seconds(src, pattern_clips, sr)
                for src in audio_sources
            )
        else:
            plans = [
                _auto_perf_plan(src, pattern_clips, sr)
                for src in audio_sources
            ]
            opts.seconds_per_chunk = max(c for c, _ in plans)
            if opts.stream_batch == 1:
                opts.stream_batch = max(b for _, b in plans)

    # At most two detector variants: the reference contract drops
    # --height-min for ffmpeg (non-WAV) sources (_opts_for_source). Both
    # share process-wide compiled executables.
    detectors: dict[float | None, Any] = {}
    results: list[tuple[dict[str, list[float]] | None, float]] = []
    for src in audio_sources:
        src_opts = _opts_for_source(opts, src)
        if src_opts.height_min not in detectors:
            detectors[src_opts.height_min] = src_opts.build_detector(
                pattern_clips
            )
        if on_file_start is not None:
            on_file_start(src)
        result = _scan_file_source(
            src,
            detectors[src_opts.height_min],
            src_opts,
            on_pattern_detected,
            accumulate_results,
        )
        if on_file_end is not None:
            on_file_end(src, result[1])
        results.append(result)
    return results


def match_pattern_many_parallel(
    audio_sources: list[str],
    pattern_files: list[str],
    mesh_stream: int = 1,
    *,
    on_file_start: "Callable[[int, str], None] | None" = None,
    on_file_detect: "Callable[[int, str, str, float], None] | None" = None,
    on_file_end: "Callable[[int, str, float], None] | None" = None,
    accumulate_results: bool = True,
    seconds_per_chunk: int | None = 60,
    chunk_seconds_auto_perf: bool = False,
    target_sample_rate: int | None = None,
    height_min: float | None = None,
    pipeline_depth: int | None = None,
    n_slots: int | None = None,
) -> list[tuple[dict[str, list[float]] | None, float]]:
    """Scan MANY audio files CONCURRENTLY: data parallelism over files.

    Where :func:`match_pattern_many` shares the pattern bank but scans
    files one after another, this batches one chunk from every in-flight
    file into a single vmapped device round (``MultiStreamSession``) and
    — with ``mesh_stream`` > 1 — partitions the rows across a ``stream``
    mesh axis, so N devices scan N files at full per-device rate (the
    SURVEY §2.3 "DP over files/streams" axis at the offline-scanning
    surface; the reference's model is one OS process per file,
    reference: match.py:98).

    Results are bit-identical to the sequential scan of each file (the
    session rides the engine's independent-lookback batch path). Files
    are assigned to slots in input order and recycled as they finish;
    callbacks carry the file's input INDEX and path (files may repeat)
    and fire as device rounds complete — i.e. interleaved across files.
    The CLI layer reorders into one per-file JSONL block in input order;
    library callers needing that ordering can do the same.

    ``n_slots`` (default: ``mesh_stream``, or ``min(n_files, 8)``
    unmeshed) is the batch width; it must be a multiple of
    ``mesh_stream``. ``pipeline_depth`` rounds stay in flight (default
    3, eager in-order collection).
    """
    if not audio_sources:
        raise ValueError("No audio sources passed")
    for src in audio_sources:
        if src is None or not os.path.exists(src):
            raise ValueError(f"Audio {src} does not exist")
    sr = (
        target_sample_rate
        if target_sample_rate is not None
        else DEFAULT_TARGET_SAMPLE_RATE
    )
    opts = EngineOptions(
        seconds_per_chunk=seconds_per_chunk,
        chunk_auto_perf=chunk_seconds_auto_perf,
        target_sample_rate=sr,
        height_min=height_min,
        pipeline_depth=pipeline_depth,
        mesh_stream=mesh_stream,
    )
    opts.validate(from_stdin=False)
    pattern_clips = _load_pattern_clips(pattern_files, sr)

    if opts.chunk_auto_perf:
        opts.seconds_per_chunk = max(
            _auto_perf_chunk_seconds(src, pattern_clips, sr)
            for src in audio_sources
        )

    mesh = None
    if mesh_stream > 1:
        from audio_pattern_detector_tpu.parallel.mesh import make_mesh

        mesh = make_mesh({"stream": mesh_stream})
    slots = n_slots if n_slots is not None else (
        mesh_stream if mesh_stream > 1 else min(len(audio_sources), 8)
    )
    if slots < 1 or slots % mesh_stream:
        raise ValueError(
            f"n_slots ({slots}) must be a positive multiple of "
            f"mesh_stream ({mesh_stream})"
        )
    depth = 3 if pipeline_depth is None else pipeline_depth

    # The reference contract drops --height-min for non-WAV (ffmpeg)
    # sources (_opts_for_source), giving at most two detector variants;
    # each variant runs its own parallel session, files grouped in input
    # order.
    groups: dict[float | None, list[tuple[int, str]]] = {}
    for idx, src in enumerate(audio_sources):
        hm = _opts_for_source(opts, src).height_min
        groups.setdefault(hm, []).append((idx, src))

    results: list[tuple[dict[str, list[float]] | None, float]] = [
        (None, 0.0)
    ] * len(audio_sources)
    for hm, items in groups.items():
        import dataclasses

        det = dataclasses.replace(opts, height_min=hm).build_detector(
            pattern_clips
        )
        _scan_group_parallel(
            det, items, slots, mesh, depth,
            on_file_start, on_file_detect, on_file_end,
            accumulate_results, results,
        )
    return results


def _scan_group_parallel(
    detector: "AudioPatternDetector",
    items: list[tuple[int, str]],
    n_slots: int,
    mesh: Any,
    depth: int,
    on_file_start: "Callable[[int, str], None] | None",
    on_file_detect: "Callable[[int, str, str, float], None] | None",
    on_file_end: "Callable[[int, str, float], None] | None",
    accumulate_results: bool,
    results: list,
) -> None:
    """Drive one detector variant's files through a MultiStreamSession.

    One chunk per active slot per round; finished files free their slot
    for the next pending file (session.reset, the serve.py recycling
    contract). Up to ``depth`` rounds stay in flight with eager in-order
    collection, so emission tracks the device and host reads stay ahead.
    """
    from collections import deque
    from contextlib import ExitStack

    from audio_pattern_detector_tpu.models.multistream import (
        MultiStreamSession,
    )

    session = MultiStreamSession(detector, n_streams=n_slots, mesh=mesh)
    chunk_bytes = detector._chunk_size
    sr = detector.target_sample_rate
    queue = deque(items)
    slot: list[dict | None] = [None] * n_slots
    inflight: deque = deque()  # (handle, fed slot ids)

    def assign() -> None:
        for s in range(n_slots):
            if slot[s] is None and queue:
                idx, src = queue.popleft()
                stack = ExitStack()
                print(
                    f"Finding pattern in audio file {Path(src).stem}...",
                    file=sys.stderr,
                )
                if src.lower().endswith(".wav"):
                    wrapper = _WavFileStreamWrapper(src, sr)
                    stack.callback(wrapper.close)
                    stream: Any = wrapper
                else:
                    stream = stack.enter_context(
                        ffmpeg_get_float32_pcm(
                            src, target_sample_rate=sr, ac=1
                        )
                    )
                session.reset(s)
                # Per-slot dtype: an int16 passthrough WAV streams raw
                # 16-bit PCM (2 bytes/sample) while an ffmpeg/resampled
                # neighbour streams f32 — MultiStreamSession batches
                # mixed-dtype rows bit-identically.
                from audio_pattern_detector_tpu.utils.clip import (
                    resolve_reader_dtype,
                )

                dtype = resolve_reader_dtype(stream)
                slot[s] = {
                    "idx": idx,
                    "src": src,
                    "stream": stream,
                    "dtype": dtype,
                    "chunk_bytes": (chunk_bytes // 4) * dtype.itemsize,
                    "stack": stack,
                    "eof": False,
                    "pending": 0,
                    "acc": (
                        {c.name: [] for c in detector.audio_clips}
                        if accumulate_results
                        else None
                    ),
                }
                if on_file_start is not None:
                    on_file_start(idx, src)

    def finalize(s: int) -> None:
        st = slot[s]
        assert st is not None
        st["stack"].close()
        total = session.total_time(s)
        if on_file_end is not None:
            on_file_end(st["idx"], st["src"], total)
        results[st["idx"]] = (st["acc"], total)
        slot[s] = None

    def collect_one() -> None:
        handle, fed = inflight.popleft()
        out = session.collect(handle)
        for s in fed:
            st = slot[s]
            assert st is not None
            st["pending"] -= 1
            # Timestamp-ordered within the chunk, like the serial emit:
            # build in clip order, STABLE-sort by timestamp only, so
            # equal-timestamp ties keep bank order (detector.py's
            # chunk_matches.sort(key=t) contract — sorting (t, name)
            # tuples would reorder ties by clip name and break the
            # byte-identical-stdout promise).
            matches = [
                (t, name) for name, ts in out[s].items() for t in ts
            ]
            matches.sort(key=lambda x: x[0])
            if on_file_detect is not None:
                for t, name in matches:
                    on_file_detect(st["idx"], st["src"], name, t)
            if st["acc"] is not None:
                for name, ts in out[s].items():
                    st["acc"][name].extend(ts)
            if st["eof"] and st["pending"] == 0:
                finalize(s)

    try:
        assign()
        while any(slot) or queue or inflight:
            chunks: list = [None] * n_slots
            fed: list[int] = []
            for s in range(n_slots):
                st = slot[s]
                if st is None or st["eof"]:
                    continue
                data = st["stream"].read(st["chunk_bytes"])
                if not data:
                    st["eof"] = True
                    if st["pending"] == 0:
                        finalize(s)
                    continue
                chunks[s] = np.frombuffer(data, dtype=st["dtype"])
                fed.append(s)
            if fed:
                handle = session.dispatch(chunks)
                for s in fed:
                    slot[s]["pending"] += 1  # type: ignore[index]
                inflight.append((handle, fed))
                while len(inflight) > 1 and session.round_ready(
                    inflight[0][0]
                ):
                    collect_one()
                while len(inflight) > depth:
                    collect_one()
            else:
                # Nothing dispatchable: drain every in-flight round (this
                # finalizes EOF slots), then refill from the queue.
                while inflight:
                    collect_one()
            assign()
    finally:
        # An escaping exception (corrupt file mid-stream, device error in
        # collect) must not leak the other slots' open WAV handles or
        # running ffmpeg children — the parallel analogue of the
        # sequential path's per-file try/finally (_scan_file_source).
        for st in slot:
            if st is not None:
                st["stack"].close()


def _load_pattern_clips(pattern_files: list[str], sr: int) -> list[AudioClip]:
    """Load pattern files into clips, rejecting duplicate clip names.

    ``name=path`` renames a clip (``--pattern-file intro_a=a/intro.wav``),
    resolving stem collisions between different files. The reference's
    duplicate-name error ADVISES this syntax but never implements it
    (reference: match.py:137-145); here the advice works. Only an
    argument that does not itself exist as a file is parsed as
    ``name=path``, so filenames containing ``=`` stay loadable.
    """
    clips: list[AudioClip] = []
    seen: dict[str, str] = {}
    for pattern_file in pattern_files:
        custom_name: str | None = None
        path = pattern_file
        if not os.path.exists(path) and "=" in path:
            maybe_name, maybe_path = path.split("=", 1)
            if maybe_name and os.path.exists(maybe_path):
                custom_name, path = maybe_name, maybe_path
        if not os.path.exists(path):
            raise ValueError(f"Pattern {pattern_file} does not exist")
        clip = AudioClip.from_audio_file(path, sample_rate=sr)
        if custom_name is not None:
            import dataclasses

            clip = dataclasses.replace(clip, name=custom_name)
        if clip.name in seen:
            raise ValueError(
                f"Duplicate clip name '{clip.name}' from files:\n"
                f"  - {seen[clip.name]}\n"
                f"  - {pattern_file}\n"
                f"Use --pattern-file with name=path syntax to specify unique names."
            )
        seen[clip.name] = pattern_file
        clips.append(clip)
    if not clips:
        raise ValueError("No pattern clips passed")
    return clips


def _scan_file_source(
    audio_source: str,
    detector: "AudioPatternDetector",
    opts: EngineOptions,
    on_pattern_detected: PatternDetectedCallback | None,
    accumulate_results: bool,
) -> tuple[dict[str, list[float]] | None, float]:
    """Scan one file through an already-built detector: WAV streams
    directly, anything else decodes through an ffmpeg child process."""
    sr = opts.target_sample_rate
    audio_name = Path(audio_source).stem
    print(f"Finding pattern in audio file {audio_name}...", file=sys.stderr)

    if audio_source.lower().endswith(".wav"):
        stream_wrapper = _WavFileStreamWrapper(audio_source, sr)
        try:
            return _scan(
                detector,
                AudioStream(
                    name=audio_name, audio_stream=stream_wrapper, sample_rate=sr
                ),
                opts,
                on_pattern_detected,
                accumulate_results,
            )
        finally:
            stream_wrapper.close()

    with ffmpeg_get_float32_pcm(audio_source, target_sample_rate=sr, ac=1) as stdout:
        return _scan(
            detector,
            AudioStream(name=audio_name, audio_stream=stdout, sample_rate=sr),
            opts,
            on_pattern_detected,
            accumulate_results,
        )


def _opts_for_source(opts: EngineOptions, audio_source: str) -> EngineOptions:
    """Per the reference contract the ffmpeg (non-WAV) path does not
    honour --height-min (reference: match.py:191-212 constructs its
    detector without it)."""
    if audio_source.lower().endswith(".wav") or opts.height_min is None:
        return opts
    from dataclasses import replace as _dc_replace

    return _dc_replace(opts, height_min=None)


def _match_pattern_file(
    audio_source: str,
    pattern_clips: list[AudioClip],
    opts: EngineOptions,
    on_pattern_detected: PatternDetectedCallback | None,
    accumulate_results: bool,
) -> tuple[dict[str, list[float]] | None, float]:
    """File mode: stream a WAV directly, anything else through ffmpeg."""
    sr = opts.target_sample_rate
    if (
        opts.chunk_auto_perf
        and not opts.debug_mode
        and opts.offline_batch is None
        and opts.mesh_time is None  # sharded scans size by the mesh instead
    ):
        opts.seconds_per_chunk, auto_batch = _auto_perf_plan(
            audio_source, pattern_clips, sr
        )
        # Only upgrade the default: an explicit --stream-batch keeps the
        # user's width (the 60 s chunk from the plan is the default
        # geometry for any width).
        if opts.stream_batch == 1:
            opts.stream_batch = auto_batch
    opts = _opts_for_source(opts, audio_source)
    return _scan_file_source(
        audio_source,
        opts.build_detector(pattern_clips),
        opts,
        on_pattern_detected,
        accumulate_results,
    )


def _match_pattern_wav_stdin(
    pattern_clips: list[AudioClip],
    opts: EngineOptions,
    on_pattern_detected: PatternDetectedCallback | None,
    accumulate_results: bool,
) -> tuple[dict[str, list[float]] | None, float]:
    sr = opts.target_sample_rate
    stream_wrapper = _WavStdinStreamWrapper(sr)
    print("Finding pattern in audio stream stdin...", file=sys.stderr)
    return _scan(
        opts.build_detector(pattern_clips),
        AudioStream(name="stdin", audio_stream=stream_wrapper, sample_rate=sr),
        opts,
        on_pattern_detected,
        accumulate_results,
    )


def _match_pattern_multiplexed_stdin(
    opts: EngineOptions,
    on_pattern_detected: PatternDetectedCallback | None,
    accumulate_results: bool,
) -> tuple[dict[str, list[float]] | None, float]:
    """Multiplexed stdin: patterns via the binary protocol, then WAV audio."""
    opts.validate(from_stdin=True)
    sr = opts.target_sample_rate
    pattern_clips = _read_patterns_from_multiplexed_stdin(sr)
    print("Reading WAV audio from stdin...", file=sys.stderr)
    stream_wrapper = _WavStdinStreamWrapper(sr)
    return _scan(
        opts.build_detector(pattern_clips),
        AudioStream(name="stdin", audio_stream=stream_wrapper, sample_rate=sr),
        opts,
        on_pattern_detected,
        accumulate_results,
    )


def _make_jsonl_callback(
    timestamp_format: str = "both",
    emit: Callable[..., None] = _emit_jsonl,
) -> PatternDetectedCallback:
    """pattern_detected JSONL emitter with per-clip equal-ms dedup
    (overlap-region duplicates are expected; reference: match.py:524-551).

    ``emit`` defaults to the process-wide stdout emitter; the socket
    server (serve.py) passes a per-connection emitter so every client
    gets the same event fields on its own stream."""
    last_ms: dict[str, int] = {}

    def callback(clip_name: str, timestamp: float) -> None:
        ts_ms = round(timestamp * 1000)
        if last_ms.get(clip_name) == ts_ms:
            return
        last_ms[clip_name] = ts_ms
        if timestamp_format == "formatted":
            emit(
                "pattern_detected",
                clip_name=clip_name,
                timestamp_formatted=seconds_to_time(timestamp),
            )
        elif timestamp_format == "ms":
            emit("pattern_detected", clip_name=clip_name, timestamp_ms=ts_ms)
        else:
            emit(
                "pattern_detected",
                clip_name=clip_name,
                timestamp_ms=ts_ms,
                timestamp_formatted=seconds_to_time(timestamp),
            )

    return callback


def _emit_jsonl_end(
    total_time: float,
    timestamp_format: str = "both",
    emit: Callable[..., None] = _emit_jsonl,
) -> None:
    if timestamp_format == "formatted":
        emit("end", total_time_formatted=seconds_to_time(total_time))
    elif timestamp_format == "ms":
        emit("end", total_time_ms=round(total_time * 1000))
    else:
        emit(
            "end",
            total_time_ms=round(total_time * 1000),
            total_time_formatted=seconds_to_time(total_time),
        )


def _run_match_with_output(
    args: argparse.Namespace,
    pattern_files: list[str],
    audio_source: str | None,
    opts: EngineOptions,
    from_stdin: bool = False,
) -> tuple[None, float]:
    timestamp_format: str = getattr(args, "timestamp_format", "both")
    callback = _make_jsonl_callback(timestamp_format)
    _emit_jsonl("start", source="stdin" if from_stdin else (audio_source or "unknown"))

    _, total_time = match_pattern(
        audio_source,
        pattern_files,
        debug_mode=args.debug,
        on_pattern_detected=callback,
        accumulate_results=False,
        seconds_per_chunk=opts.seconds_per_chunk,
        chunk_seconds_auto_perf=opts.chunk_auto_perf,
        from_stdin=from_stdin,
        target_sample_rate=getattr(args, "target_sample_rate", None),
        debug_dir=opts.debug_dir,
        height_min=opts.height_min,
        profile=opts.profile,
        trace_dir=opts.trace_dir,
        offline_batch=opts.offline_batch,
        offline_batch_mode=opts.offline_batch_mode,
        pipeline_depth=opts.pipeline_depth,
        stream_batch=opts.stream_batch,
        stream_batch_mode=opts.stream_batch_mode,
        mesh_time=opts.mesh_time,
        mesh_bank=opts.mesh_bank,
        checkpoint_file=opts.checkpoint_file,
    )
    print(f"Total time processed: {seconds_to_time(seconds=total_time)}", file=sys.stderr)
    _emit_jsonl_end(total_time, timestamp_format)
    return None, total_time


def _run_match_many(
    args: argparse.Namespace,
    pattern_files: list[str],
    audio_sources: list[str],
    opts: EngineOptions,
) -> None:
    """CLI runner for multiple audio files: one start/end JSONL block per
    file, in argument order, with the pattern bank shared across files.
    The per-clip equal-ms dedup resets per file (each block reads exactly
    like a single-file run's output)."""
    if opts.debug_mode:
        print("Error: --debug supports a single audio file", file=sys.stderr)
        sys.exit(1)
    timestamp_format: str = getattr(args, "timestamp_format", "both")

    # Rebound per file from on_file_start; the indirection keeps one
    # shared detector callback across the whole run.
    current_callback: list[PatternDetectedCallback] = [
        _make_jsonl_callback(timestamp_format)
    ]

    def on_detect(clip_name: str, timestamp: float) -> None:
        current_callback[0](clip_name, timestamp)

    def on_file_start(source: str) -> None:
        current_callback[0] = _make_jsonl_callback(timestamp_format)
        _emit_jsonl("start", source=source)

    def on_file_end(source: str, total_time: float) -> None:
        print(
            f"Total time processed: {seconds_to_time(seconds=total_time)}",
            file=sys.stderr,
        )
        _emit_jsonl_end(total_time, timestamp_format)

    match_pattern_many(
        audio_sources,
        pattern_files,
        on_pattern_detected=on_detect,
        on_file_start=on_file_start,
        on_file_end=on_file_end,
        accumulate_results=False,
        seconds_per_chunk=opts.seconds_per_chunk,
        chunk_seconds_auto_perf=opts.chunk_auto_perf,
        target_sample_rate=getattr(args, "target_sample_rate", None),
        height_min=opts.height_min,
        profile=opts.profile,
        trace_dir=opts.trace_dir,
        offline_batch=opts.offline_batch,
        offline_batch_mode=opts.offline_batch_mode,
        pipeline_depth=opts.pipeline_depth,
        stream_batch=opts.stream_batch,
        stream_batch_mode=opts.stream_batch_mode,
        mesh_time=opts.mesh_time,
        mesh_bank=opts.mesh_bank,
    )


def _run_match_many_parallel(
    args: argparse.Namespace,
    pattern_files: list[str],
    audio_sources: list[str],
    opts: EngineOptions,
) -> None:
    """CLI runner for ``match a.wav b.wav … --mesh-stream N``.

    Output is BYTE-IDENTICAL to the sequential multi-file runner
    (_run_match_many): one start/end JSONL block per file, in argument
    order, per-file equal-ms dedup. Files scan concurrently underneath
    (match_pattern_many_parallel); events for files behind the emission
    cursor stream live, later files' events buffer until their block's
    turn. Only the stderr diagnostics interleave in completion order.
    """
    timestamp_format: str = getattr(args, "timestamp_format", "both")
    n = len(audio_sources)
    cursor = 0
    state = ["pending"] * n  # pending | started | ended
    buffers: list[list[tuple[str, float]]] = [[] for _ in range(n)]
    callbacks: list[PatternDetectedCallback | None] = [None] * n
    totals = [0.0] * n

    def emit_start(i: int) -> None:
        callbacks[i] = _make_jsonl_callback(timestamp_format)
        _emit_jsonl("start", source=audio_sources[i])

    def advance() -> None:
        nonlocal cursor
        while cursor < n and state[cursor] != "pending":
            i = cursor
            if callbacks[i] is None:
                emit_start(i)
            cb = callbacks[i]
            assert cb is not None
            for clip_name, t in buffers[i]:
                cb(clip_name, t)
            buffers[i].clear()
            if state[i] != "ended":
                return  # head file now live; its events emit directly
            print(
                f"Total time processed: {seconds_to_time(seconds=totals[i])}",
                file=sys.stderr,
            )
            _emit_jsonl_end(totals[i], timestamp_format)
            cursor += 1

    def on_start(i: int, src: str) -> None:
        state[i] = "started"
        if i == cursor:
            advance()

    def on_detect(i: int, src: str, clip_name: str, t: float) -> None:
        cb = callbacks[i]
        if i == cursor and cb is not None:
            cb(clip_name, t)
        else:
            buffers[i].append((clip_name, t))

    def on_end(i: int, src: str, total: float) -> None:
        state[i] = "ended"
        totals[i] = total
        advance()

    match_pattern_many_parallel(
        audio_sources,
        pattern_files,
        mesh_stream=opts.mesh_stream,
        on_file_start=on_start,
        on_file_detect=on_detect,
        on_file_end=on_end,
        accumulate_results=False,
        seconds_per_chunk=opts.seconds_per_chunk,
        chunk_seconds_auto_perf=opts.chunk_auto_perf,
        target_sample_rate=getattr(args, "target_sample_rate", None),
        height_min=opts.height_min,
        pipeline_depth=opts.pipeline_depth,
    )
    assert cursor == n, "parallel scan ended with unemitted file blocks"


def _parse_chunk_seconds(args: argparse.Namespace) -> tuple[int | None, bool]:
    """(seconds_per_chunk, auto_perf): None CLI value → 60 s with file-mode
    auto-perf sizing; "auto" → engine-computed minimum; else the integer
    (values < 1 also defer to the engine's auto-computed minimum — the
    reference CLI passes any int through and its engine treats < 1 as
    auto, reference audio_pattern_detector.py:117-120)."""
    raw = getattr(args, "chunk_seconds", None)
    if raw is None:
        return 60, True
    if raw.lower() == "auto":
        return None, False
    try:
        return int(raw), False
    except ValueError:
        print(
            f"Error: --chunk-seconds must be 'auto' or an integer, "
            f"got '{raw}'",
            file=sys.stderr,
        )
        sys.exit(1)


def _int_or(value: int | None, default: int) -> int:
    """``default`` only for an absent value (None); 0/negatives pass
    through so EngineOptions.validate rejects them loudly instead of the
    old ``or default`` idiom silently mapping 0 to the sequential path."""
    return default if value is None else int(value)


def _collect_pattern_files(args: argparse.Namespace) -> list[str]:
    """Explicit --pattern-file paths plus --pattern-folder globs
    (``*.wav`` + ``*.apd.toml``, announced on stderr)."""
    pattern_files: list[str] = []
    if args.pattern_folder:
        for folder in args.pattern_folder:
            for ext in ("wav", "apd.toml"):
                for pattern_file in glob.glob(f"{folder}/*.{ext}"):
                    print(f"adding pattern file {pattern_file}...", file=sys.stderr)
                    pattern_files.append(pattern_file)
    if args.pattern_file:
        pattern_files.extend(args.pattern_file)
    return pattern_files


def cmd_match(args: argparse.Namespace) -> None:
    """Handler for the ``match`` subcommand."""
    seconds_per_chunk, chunk_auto_perf = _parse_chunk_seconds(args)
    sr = getattr(args, "target_sample_rate", None) or DEFAULT_TARGET_SAMPLE_RATE
    opts = EngineOptions(
        seconds_per_chunk=seconds_per_chunk,
        chunk_auto_perf=chunk_auto_perf,
        target_sample_rate=sr,
        debug_mode=args.debug,
        debug_dir=getattr(args, "debug_dir", "./tmp"),
        height_min=getattr(args, "height_min", None),
        pipeline_depth=getattr(args, "pipeline_depth", None),
        # None (flag absent/defaulted) means 1; explicit 0 or negatives
        # must reach EngineOptions.validate and fail loudly, not be
        # silently coerced into the sequential path.
        stream_batch=_int_or(getattr(args, "stream_batch", None), 1),
        stream_batch_mode=getattr(args, "stream_batch_mode", "scan") or "scan",
        mesh_time=getattr(args, "mesh_time", None),
        mesh_bank=_int_or(getattr(args, "mesh_bank", None), 1),
        mesh_stream=_int_or(getattr(args, "mesh_stream", None), 1),
        checkpoint_file=getattr(args, "checkpoint_file", None),
    )
    timestamp_format: str = getattr(args, "timestamp_format", "both")

    _named_files = args.audio_file
    if isinstance(_named_files, str):
        _named_files = [_named_files]
    if _named_files and (
        getattr(args, "stdin", False) or getattr(args, "multiplexed_stdin", False)
    ):
        # Without this the stdin branch would win and the named files
        # would be silently ignored — missing detections with no
        # diagnostic.
        print(
            "Error: audio files and --stdin/--multiplexed-stdin are "
            "mutually exclusive (the stdin stream would be scanned and "
            "the files silently ignored)",
            file=sys.stderr,
        )
        sys.exit(1)

    if getattr(args, "offline_batch", None) and (
        getattr(args, "stdin", False) or getattr(args, "multiplexed_stdin", False)
    ):
        # The engine raises the same contract for library callers
        # (EngineOptions.validate); catching it here keeps the CLI from
        # silently running the plain streaming loop while the user
        # believes they're getting the batched scan.
        print(
            "Error: --offline-batch requires file mode "
            "(whole-file scans; incompatible with --stdin/--multiplexed-stdin"
            " — use --stream-batch for live streams)",
            file=sys.stderr,
        )
        sys.exit(1)

    if opts.mesh_stream != 1 and (
        getattr(args, "stdin", False)
        or getattr(args, "multiplexed_stdin", False)
    ):
        # Same rationale as the offline-batch guard above: without this
        # the stdin branch would run the plain serial loop while the user
        # believes they're getting multi-device file parallelism.
        print(
            "Error: --mesh-stream requires file mode (data parallelism "
            "over multiple audio FILES; incompatible with "
            "--stdin/--multiplexed-stdin — use serve --mesh-stream for "
            "live streams)",
            file=sys.stderr,
        )
        sys.exit(1)

    if getattr(args, "multiplexed_stdin", False):
        # The multiplexed IPC mode ignores --profile/--trace-dir (matching
        # the reference surface, which exposes neither there).
        callback = _make_jsonl_callback(timestamp_format)
        _emit_jsonl("start", source="multiplexed-stdin")
        _, total_time = _match_pattern_multiplexed_stdin(
            opts, callback, accumulate_results=False
        )
        print(
            f"Total time processed: {seconds_to_time(seconds=total_time)}",
            file=sys.stderr,
        )
        _emit_jsonl_end(total_time, timestamp_format)
        return

    opts.profile = getattr(args, "profile", False)
    opts.trace_dir = getattr(args, "trace_dir", None)

    pattern_files = _collect_pattern_files(args)
    if not pattern_files:
        print(
            "Please provide either --pattern-file, --pattern-folder, or --multiplexed-stdin",
            file=sys.stderr,
        )
        sys.exit(1)

    audio_files = args.audio_file
    if isinstance(audio_files, str):  # library callers passing one path
        audio_files = [audio_files]
    if args.stdin:
        _run_match_with_output(args, pattern_files, None, opts, from_stdin=True)
    elif audio_files:
        opts.offline_batch = getattr(args, "offline_batch", None)
        opts.offline_batch_mode = getattr(args, "offline_batch_mode", "scan")
        if opts.mesh_stream != 1 and len(audio_files) == 1:
            print(
                "Error: --mesh-stream parallelises across MULTIPLE audio "
                "files (data parallelism over files); pass 2+ files, or "
                "use --mesh-time to shard a single file's scan",
                file=sys.stderr,
            )
            sys.exit(1)
        if len(audio_files) == 1:
            _run_match_with_output(args, pattern_files, audio_files[0], opts)
        else:
            if opts.checkpoint_file:
                # One checkpoint file cannot disambiguate which of the
                # files it belongs to.
                print(
                    "Error: --checkpoint-file supports a single audio "
                    "file or stdin",
                    file=sys.stderr,
                )
                sys.exit(1)
            if opts.mesh_stream != 1:
                try:
                    opts.validate(from_stdin=False)
                except ValueError as e:
                    print(f"Error: {e}", file=sys.stderr)
                    sys.exit(1)
                _run_match_many_parallel(
                    args, pattern_files, audio_files, opts
                )
            else:
                _run_match_many(args, pattern_files, audio_files, opts)
    else:
        print("Please provide an audio file or --stdin or --multiplexed-stdin", file=sys.stderr)
        sys.exit(1)


def cmd_show_config(args: argparse.Namespace) -> None:
    """Handler for the ``show-config`` subcommand."""
    target_sample_rate = getattr(args, "target_sample_rate", None)
    pattern_file = args.pattern_file
    if not os.path.exists(pattern_file):
        print(f"Error: Pattern {pattern_file} does not exist", file=sys.stderr)
        sys.exit(1)
    pattern_clips = [AudioClip.from_audio_file(pattern_file, sample_rate=target_sample_rate)]
    detector = AudioPatternDetector(
        audio_clips=pattern_clips,
        debug_mode=False,
        seconds_per_chunk=None,  # auto mode shows the computed minimum
        target_sample_rate=target_sample_rate,
    )
    print(json.dumps(detector.get_config(), indent=2, ensure_ascii=False))
