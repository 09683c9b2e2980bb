"""End-to-end smoke test of the detector on an NVIDIA GPU.

Runs the flagship deployment — a 64-clip bank (32 normal 1 s clips and 32
marker tones of 0.25 s) scanning 8 kHz mono audio in 60 s chunks —
through the entry points a user calls, in ONE process, and checks every
result against the repository's own references. Phases, one report line
each:

  device    JAX's first device is a GPU (no CPU fallback); the card's
            name and power limit from ``nvidia-smi``.
  uploads   int32, bool and int16 arrays round-trip ``jnp.asarray``; the
            packed int16-pair upload passes its bit-exact probe.
  corpus    the golden corpus through ``cli.main``: RTHK beep, CBS, the
            881/903 patterns against RTHK, the two-file run.
  flagship  a seeded 10-minute stream with embedded hits through
            ``AudioPatternDetector.find_clip_in_audio`` (streaming) and
            ``match_pattern``'s default file plan (scan-batched chunks);
            both must equal the host reference (models/hostpath.py,
            numpy f64) event for event, and find every embedded hit.
  numerics  correlation, loudness and marker spectra at flagship widths
            against ops/hostref.py in f64.
  serve     ``PatternServer`` on loopback with 8 concurrent clients; each
            client's JSONL equals ``match --stdin`` on the same bytes.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
A failed phase exits non-zero before it is printed.

``--four`` runs only the four-device paths the README advertises
(``match --mesh-stream 4``, ``match --mesh-time 4``, a meshed
``MultiStreamSession`` round), each against its one-device result.

Run from the repository root:
    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SAMPLES = os.path.join(REPO, "sample_audios")

# Timestamp tolerance of the golden-corpus gate (tests/test_integration_
# matching.py): detections may move by a few samples between FFT
# libraries, never by more than 20 ms.
TS_TOL_MS = 20

# Numeric tolerances against the f64 host references, with their reasons:
# * correlation: an f32 overlap-save FFT of N=32768 points accumulates
#   ~log2(N)·eps_f32·|x|·|clip| of rounding, ~1e-6 of the clip's
#   self-correlation peak; 1e-4 leaves two orders of margin and is still
#   far below the 0.25 detection threshold's resolution.
CORR_TOL = 1e-4
# * loudness: K-weighting by FFT convolution with a 4096-tap FIR plus f32
#   block sums; 0.01 LU is a gain error of 0.1 %, invisible to the
#   normalised correlation (it divides the gain back out).
LUFS_TOL = 0.01
# * marker spectra: |rfft| of 2000-point (and 200-point frame) windows in
#   f32, relative to the candidate's largest magnitude; ~1e-6 expected,
#   1e-4 bounds it. The accept decisions must be identical.
SPEC_TOL = 1e-4
# No matrix product is on this path (correlation, loudness and the marker
# verifier are FFTs and reductions), so TF32 matmul precision never applies.


class SmokeFailure(Exception):
    """A phase's check failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def report(phase: str, **fields: Any) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


@dataclass(frozen=True)
class Flagship:
    """The flagship deployment's shape (``FULL``); tests shrink it."""

    n_normal: int = 32
    n_marker: int = 32
    chunk_seconds: int = 60
    n_chunks: int = 10
    sample_rate: int = 8000
    seed: int = 0


FULL = Flagship()


# ── helpers ──────────────────────────────────────────────────────────


def nvidia_smi() -> list[str]:
    """One ``name, power.limit`` line per card, read by a child process
    that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def run_cli(argv: list[str], stdin_bytes: bytes | None = None) -> list[dict]:
    """``audio-pattern-detector-tpu <argv>`` in this process; its JSONL."""
    from audio_pattern_detector_tpu import cli

    out = io.StringIO()
    saved = sys.argv, sys.stdin
    sys.argv = ["audio-pattern-detector-tpu", *argv]
    if stdin_bytes is not None:
        sys.stdin = io.TextIOWrapper(io.BytesIO(stdin_bytes))
    try:
        with contextlib.redirect_stdout(out):
            cli.main()
    except SystemExit as e:
        if e.code not in (0, None):
            raise SmokeFailure(f"cli {argv} exited with {e.code}") from e
    finally:
        sys.argv, sys.stdin = saved
    return [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]


def blocks(events: list[dict]) -> list[tuple[dict[str, list[int]], int]]:
    """JSONL → one (clip → [timestamp_ms], total_time_ms) per start/end."""
    out: list[tuple[dict[str, list[int]], int]] = []
    cur: dict[str, list[int]] | None = None
    for ev in events:
        if ev["type"] == "start":
            cur = {}
        elif ev["type"] == "pattern_detected":
            check(cur is not None, f"event outside a block: {ev}")
            assert cur is not None
            cur.setdefault(ev["clip_name"], []).append(ev["timestamp_ms"])
        elif ev["type"] == "end":
            check(cur is not None, f"end outside a block: {ev}")
            assert cur is not None
            out.append((cur, ev["total_time_ms"]))
            cur = None
    return out


def check_block(
    block: tuple[dict[str, list[int]], int],
    want: dict[str, list[int]],
    total_ms: int | None,
    what: str,
) -> None:
    got, total = block
    check(
        sorted(got) == sorted(want),
        f"{what}: detected clips {sorted(got)} != {sorted(want)}",
    )
    for name, ms in want.items():
        check(
            len(got[name]) == len(ms)
            and all(abs(g - w) <= TS_TOL_MS for g, w in zip(got[name], ms)),
            f"{what}: {name} at {got[name]} ms, want {ms} ±{TS_TOL_MS}",
        )
    if total_ms is not None:
        check(total == total_ms, f"{what}: total {total} ms != {total_ms}")


def wav_bytes(samples_i16: np.ndarray, sr: int) -> bytes:
    """16-bit mono RIFF/WAVE bytes (the ``match --stdin`` wire format)."""
    data = np.asarray(samples_i16, dtype="<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sr, sr * 2, 2, 16)
    return (
        b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
        + b"fmt " + struct.pack("<I", 16) + fmt
        + b"data" + struct.pack("<I", len(data)) + data
    )


def to_pcm16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def write_patterns(directory: str, cfg: Flagship) -> list[str]:
    """The flagship bank as pattern files, as a user would pass them:
    seeded noise clips as 16-bit WAVs, marker tones as ``.apd.toml``."""
    rng = np.random.default_rng(cfg.seed)
    sr = cfg.sample_rate
    paths = []
    for i in range(cfg.n_normal):
        p = os.path.join(directory, f"normal_{i}.wav")
        with open(p, "wb") as f:
            f.write(wav_bytes(to_pcm16(0.4 * rng.standard_normal(sr)), sr))
        paths.append(p)
    for i in range(cfg.n_marker):
        p = os.path.join(directory, f"marker_{i}.apd.toml")
        with open(p, "w") as f:
            f.write(
                "[clip]\n"
                'source = "sine"\n'
                f"frequency_hz = {900.0 + 7.0 * i}\n"
                "duration_seconds = 0.25\n"
                "amplitude = 1.0\n\n"
                "[verification]\n"
                'strategy = "marker_tone"\n'
            )
        paths.append(p)
    return paths


def load_clips(pattern_files: list[str], sr: int) -> list:
    from audio_pattern_detector_tpu.utils.clip import AudioClip

    return [AudioClip.from_audio_file(p, sample_rate=sr) for p in pattern_files]


def make_stream(
    cfg: Flagship, clips: list, n_chunks: int, seed: int
) -> tuple[np.ndarray, list[tuple[str, float, float]]]:
    """Seeded noise with one normal and one marker hit per chunk.

    Returns (int16 samples, [(clip, start_s, duration_s)])."""
    sr, cs = cfg.sample_rate, cfg.chunk_seconds
    by_name = {c.name: c for c in clips}
    rng = np.random.default_rng(seed)
    audio = 0.05 * rng.standard_normal(n_chunks * cs * sr)
    hits = []
    for i in range(n_chunks):
        for name, frac, amp in (
            (f"normal_{(i + seed) % cfg.n_normal}", 1 / 6, 0.8),
            (f"marker_{(3 * i + seed) % cfg.n_marker}", 1 / 2, 0.7),
        ):
            clip = by_name[name].audio
            at = i * cs * sr + int(frac * cs * sr) + 997 * i
            audio[at : at + len(clip)] += amp * clip
            hits.append((name, at / sr, len(clip) / sr))
    return to_pcm16(audio), hits


def event_set(results: dict[str, list[float]]) -> set[tuple[str, int]]:
    return {(n, round(t * 1000)) for n, ts in results.items() for t in ts}


def host_reference(det: Any, audio: np.ndarray) -> set[tuple[str, int]]:
    """The same stream through the exact host path, chunk by chunk, with
    the engine's own overlap-save lookback and timestamp algebra."""
    from audio_pattern_detector_tpu.models import hostpath

    sr = det.target_sample_rate
    cs = int(det.seconds_per_chunk * sr)
    height_min = det.height_min if det.height_min is not None else 0.25
    events: set[tuple[str, int]] = set()
    prev = None
    for index, start in enumerate(range(0, len(audio), cs)):
        chunk = audio[start : start + cs]
        peaks = {}
        for name, cd in det._clip_datas.items():
            sw = cd["sliding_window"]
            section = (
                chunk if prev is None else np.concatenate((prev[-sw * sr :], chunk))
            )
            peaks[name] = hostpath.process_section_host(
                audio_section=section,
                clip=cd["clip"],
                correlation_clip=cd["correlation_clip"],
                correlation_clip_absolute_max=float(
                    cd["correlation_clip_absolute_max"]
                ),
                sr=sr,
                height_min=height_min,
                is_short_clip=len(cd["clip"]) / sr < 0.5,
                tone_frequency=det._tone_frequencies.get(name),
                verification_params=det._clip_strategy_params.get(name, {}).get(
                    "verification", {}
                ),
            )
        events |= event_set(det.peaks_to_times(peaks, index, prev is not None))
        prev = chunk
    return events


def check_hits(
    events: set[tuple[str, int]],
    hits: list[tuple[str, float, float]],
    durations: dict[str, float],
    what: str,
) -> int:
    """Every embedded hit is found; every event lies on an embedded hit.

    Found: an event of the hit's own clip within ±TS_TOL_MS of its start.
    On a hit: the event's clip window [t, t + clip duration] overlaps an
    embedded hit's span. A normal hit may only be reported under its own
    name. A marker hit may also be reported by bank tones 7 Hz away, a
    few tens of ms off: they sit inside the verifier's ±5 % frequency
    tolerance, so the host reference accepts them too. Returns that
    neighbour-tone count."""
    for name, start, _dur in hits:
        check(
            any(n == name and abs(ms - 1000 * start) <= TS_TOL_MS for n, ms in events),
            f"{what}: embedded {name} at {start:.3f} s not found",
        )
    neighbours = 0
    for name, ms in events:
        lo, hi = ms / 1000, ms / 1000 + durations[name]
        covering = [h for h in hits if lo < h[1] + h[2] and h[1] < hi]
        check(bool(covering), f"{what}: {name} at {ms} ms is on no embedded hit")
        if not any(h[0] == name for h in covering):
            check(
                name.startswith("marker_")
                and all(h[0].startswith("marker_") for h in covering),
                f"{what}: {name} at {ms} ms reported on another clip's hit",
            )
            neighbours += 1
    return neighbours


# ── phases ───────────────────────────────────────────────────────────


def phase_device(require_gpu: bool = True) -> dict[str, Any]:
    import jax

    devices = jax.devices()
    info = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    report("device", **info, jax=jax.__version__)
    if require_gpu:
        check(info["platform"] == "gpu", f"JAX platform is {info['platform']!r}, not 'gpu'")
    return info


def phase_uploads() -> None:
    import jax.numpy as jnp

    from audio_pattern_detector_tpu.ops.packing import packed_upload_supported

    cases = {
        "int32": np.array([-(2**31), -1, 0, 1, 2**31 - 1], dtype=np.int32),
        "bool": np.array([True, False, True]),
        "int16": np.array([-32768, -1, 0, 1, 32767], dtype=np.int16),
    }
    same = {}
    for name, host in cases.items():
        dev = jnp.asarray(host)
        back = np.asarray(dev)
        same[name] = bool(
            dev.dtype == host.dtype
            and back.dtype == host.dtype
            and np.array_equal(back, host)
        )
    packed = packed_upload_supported()
    report("uploads", came_back_as_itself=same, packed_upload_supported=packed)
    check(packed, "packed int16-pair upload does not round-trip bit-exactly")


def phase_corpus() -> None:
    t0 = time.perf_counter()
    rthk = os.path.join(SAMPLES, "rthk_section_with_beep.wav")
    cbs = os.path.join(SAMPLES, "cbs_news_audio_section.wav")
    rthk_toml = os.path.join(SAMPLES, "clips", "rthk_beep.apd.toml")
    cbs_clip = os.path.join(SAMPLES, "clips", "cbs_news.wav")
    rthk_want = {"rthk_beep": [1408, 2420]}
    cbs_want = {"cbs_news": [25899]}

    (b,) = blocks(run_cli(["match", "--pattern-file", rthk_toml, rthk]))
    check_block(b, rthk_want, 4078, "rthk")
    (b,) = blocks(run_cli(["match", "--pattern-file", cbs_clip, cbs]))
    check_block(b, cbs_want, None, "cbs")
    station = [
        os.path.join(SAMPLES, "clips", f)
        for f in ("881_beep.apd.toml", "881_beep_base64.apd.toml", "903_beep.apd.toml")
    ]
    argv = ["match"]
    for p in station:
        argv += ["--pattern-file", p]
    (b,) = blocks(run_cli(argv + [rthk]))
    check_block(b, {}, 4078, "881/903 vs rthk")
    two = blocks(
        run_cli(
            ["match", rthk, cbs, "--pattern-file", rthk_toml, "--pattern-file", cbs_clip]
        )
    )
    check(len(two) == 2, f"two-file run gave {len(two)} blocks")
    check_block(two[0], rthk_want, 4078, "two-file rthk block")
    check_block(two[1], cbs_want, None, "two-file cbs block")
    report("corpus", ok=True, seconds=time.perf_counter() - t0)


def phase_flagship(cfg: Flagship, pattern_files: list[str], workdir: str) -> Any:
    """Streaming and file-plan scans of one stream vs the host reference.

    Returns the detector (its bank feeds the numerics phase)."""
    import jax

    from audio_pattern_detector_tpu.match import match_pattern
    from audio_pattern_detector_tpu.models.bank import _class_step_fused_packed_jit
    from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
    from audio_pattern_detector_tpu.utils.clip import AudioStream

    sr = cfg.sample_rate
    clips = load_clips(pattern_files, sr)
    audio, hits = make_stream(cfg, clips, cfg.n_chunks, cfg.seed + 1)
    det = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=cfg.chunk_seconds)

    t0 = time.perf_counter()
    streamed, total = det.find_clip_in_audio(
        AudioStream("flagship", io.BytesIO(audio.tobytes()), sr, sample_dtype=np.int16)
    )
    t_stream = time.perf_counter() - t0
    wav = os.path.join(workdir, "flagship.wav")
    with open(wav, "wb") as f:
        f.write(wav_bytes(audio, sr))
    t0 = time.perf_counter()
    filed, file_total = match_pattern(wav, pattern_files, chunk_seconds_auto_perf=True)
    t_file = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = host_reference(det, audio.astype(np.float32) / np.float32(32768.0))
    t_host = time.perf_counter() - t0

    assert streamed is not None and filed is not None
    stream_ev, file_ev = event_set(streamed), event_set(filed)
    seconds = cfg.n_chunks * cfg.chunk_seconds
    check(total == seconds and file_total == seconds, f"totals {total}, {file_total}")
    check(
        stream_ev == host,
        f"streaming != host: only device {sorted(stream_ev - host)}, "
        f"only host {sorted(host - stream_ev)}",
    )
    check(
        file_ev == host,
        f"file plan != host: only device {sorted(file_ev - host)}, "
        f"only host {sorted(host - file_ev)}",
    )
    durations = {c.name: len(c.audio) / sr for c in clips}
    neighbours = check_hits(host, hits, durations, "flagship")

    bank = det._ensure_bank()
    sw = sorted(bank.classes)[0]
    cls = bank.classes[sw]
    S = cls["section_len"]
    compiled = _class_step_fused_packed_jit.lower(
        jax.ShapeDtypeStruct((S // 2,), np.float32),
        jax.ShapeDtypeStruct((), np.float32),
        cls["loud"],
        tuple((g.corr, g.verify) for g in cls["groups"]),
        metas=bank._metas[sw],
        height_min=bank.height_min,
        blocked=bank._blocked,
        merged=bank._merged,
    ).compile()
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    report(
        "flagship",
        clips=len(clips),
        audio_seconds=seconds,
        events=len(host),
        embedded_hits=len(hits),
        neighbour_tone_events=neighbours,
        streaming_seconds=t_stream,
        file_plan_seconds=t_file,
        host_reference_seconds=t_host,
        class_step_memory={
            k: getattr(mem, k, None)
            for k in (
                "argument_size_in_bytes",
                "output_size_in_bytes",
                "temp_size_in_bytes",
                "generated_code_size_in_bytes",
            )
        },
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
    )
    return det


def phase_numerics(cfg: Flagship, det: Any) -> None:
    """Each device stage of the class step at the bank's real widths
    against its f64 host reference (tolerances and reasons at the top)."""
    import jax.numpy as jnp

    from audio_pattern_detector_tpu.models.hostpath import _verify_marker_host
    from audio_pattern_detector_tpu.ops import hostref
    from audio_pattern_detector_tpu.ops.correlate import _correlate_raw
    from audio_pattern_detector_tpu.ops.loudness import integrated_loudness_device
    from audio_pattern_detector_tpu.ops.verify import marker_spectra, verify_marker

    sr = cfg.sample_rate
    bank = det._ensure_bank()
    sw = sorted(bank.classes)[0]
    cls = bank.classes[sw]
    S = cls["section_len"]
    rng = np.random.default_rng(cfg.seed + 2)
    section = (0.05 * rng.standard_normal(S)).astype(np.float32)
    marker_group = next(g for g in cls["groups"] if g.kind == "marker")
    m = marker_group.clip_len
    hit_at = S // 3
    section[hit_at : hit_at + m] += 0.7 * marker_group.clips_np[0] / np.abs(
        marker_group.clips_np[0]
    ).max()

    lufs_dev = float(integrated_loudness_device(jnp.asarray(section), S, cls["loud"]))
    lufs_host = hostref.integrated_loudness(section, sr)
    check(
        abs(lufs_dev - lufs_host) <= LUFS_TOL,
        f"loudness {lufs_dev} LUFS vs host {lufs_host}",
    )
    norm = hostref.loudness_normalize(section, lufs_host, -16.0)

    corr_err = 0.0
    for g in cls["groups"]:
        dev = np.asarray(_correlate_raw(jnp.asarray(norm), g.corr))
        for ci in range(len(g.names)):
            host = np.abs(hostref.fft_correlate_1d(norm, g.clips_np[ci]))
            err = float(np.abs(dev[ci, : len(host)] - host).max() / g.self_max_np[ci])
            corr_err = max(corr_err, err)
    check(corr_err <= CORR_TOL, f"correlation error {corr_err} > {CORR_TOL}")

    g = marker_group
    k = 16
    pos = np.concatenate(
        [[hit_at + m - 1], rng.integers(m, S - m, size=k - 1)]
    ).astype(np.int32)
    pos_g = np.broadcast_to(pos, (len(g.names), k))
    spec, fspec = marker_spectra(jnp.asarray(norm), jnp.asarray(pos_g), g.verify)
    want, fwant = hostref.marker_spectra(norm, pos, m, sr)
    spec_err = 0.0
    for got, ref in ((spec, want), (fspec, fwant)):
        if ref is None:
            continue
        scale = ref.max(axis=(-2, -1), keepdims=True)
        spec_err = max(
            spec_err, float((np.abs(np.asarray(got) - ref[None]) / scale[None]).max())
        )
    check(spec_err <= SPEC_TOL, f"marker spectra error {spec_err} > {SPEC_TOL}")
    accept = np.asarray(
        verify_marker(
            jnp.asarray(norm), jnp.asarray(pos_g), jnp.ones(pos_g.shape, bool), g.verify
        )
    )
    host_accept = np.array(
        [
            [
                _verify_marker_host(norm, int(p), m, g.tone_freqs[ci], sr,
                                    g.verification_params[ci])
                for p in pos
            ]
            for ci in range(len(g.names))
        ]
    )
    check(
        np.array_equal(accept, host_accept),
        f"marker accept masks differ at {np.argwhere(accept != host_accept).tolist()}",
    )
    check(bool(host_accept[0, 0]), "the embedded marker hit is not accepted")
    report(
        "numerics",
        section_len=S,
        groups=[(gg.kind, len(gg.names), gg.clip_len) for gg in cls["groups"]],
        lufs_device=lufs_dev,
        lufs_host=lufs_host,
        correlation_max_error=corr_err,
        marker_spectra_max_error=spec_err,
        marker_accepts=int(host_accept.sum()),
    )


def _serve_client(port: int, payload: bytes) -> list[dict]:
    sock = socket.create_connection(("127.0.0.1", port), timeout=300)
    try:
        sock.sendall(payload)
        sock.shutdown(socket.SHUT_WR)
        sock.settimeout(600)
        buf = b""
        while True:
            data = sock.recv(1 << 16)
            if not data:
                break
            buf += data
    finally:
        sock.close()
    return [json.loads(ln) for ln in buf.decode().splitlines()]


def phase_serve(
    cfg: Flagship, pattern_files: list[str], n_clients: int = 8, n_chunks: int = 2
) -> None:
    from audio_pattern_detector_tpu.serve import PatternServer

    sr = cfg.sample_rate
    clips = load_clips(pattern_files, sr)
    payloads = [
        wav_bytes(make_stream(cfg, clips, n_chunks, cfg.seed + 10 + i)[0], sr)
        for i in range(n_clients)
    ]
    server = PatternServer(
        clips,
        host="127.0.0.1",
        port=0,
        max_streams=n_clients,
        seconds_per_chunk=cfg.chunk_seconds,
    )
    server.warmup()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    results: list[list[dict] | None] = [None] * n_clients
    errors: list[BaseException] = []

    def client(i: int) -> None:
        try:
            results[i] = _serve_client(server.address[1], payloads[i])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
            check(not t.is_alive(), "serve client did not finish")
    finally:
        server.shutdown()
        thread.join(timeout=60)
    t_serve = time.perf_counter() - t0
    check(not thread.is_alive(), "server thread did not stop")
    if errors:
        raise SmokeFailure(f"serve client failed: {errors[0]!r}")

    argv = ["match", "--stdin", "--chunk-seconds", str(cfg.chunk_seconds)]
    for p in pattern_files:
        argv += ["--pattern-file", p]
    detections = 0
    for i, got in enumerate(results):
        assert got is not None
        want = run_cli(argv, stdin_bytes=payloads[i])
        check(got[0]["type"] == "start", f"client {i}: first event {got[0]}")
        check(
            got[1:] == want[1:],
            f"client {i}: serve JSONL differs from match --stdin",
        )
        detections += sum(ev["type"] == "pattern_detected" for ev in got)
    check(detections > 0, "serve clients saw no detections")
    report(
        "serve",
        clients=n_clients,
        audio_seconds_per_client=n_chunks * cfg.chunk_seconds,
        detections=detections,
        serve_seconds=t_serve,
    )


def phase_four(cfg: Flagship, workdir: str, n_devices: int = 4) -> None:
    """The README's multi-device paths, each against one device."""
    import jax

    from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
    from audio_pattern_detector_tpu.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu.parallel import make_mesh

    check(
        len(jax.devices()) >= n_devices,
        f"need {n_devices} devices, have {len(jax.devices())}",
    )
    sr = cfg.sample_rate
    pattern_files = write_patterns(workdir, cfg)
    clips = load_clips(pattern_files, sr)
    # One chunk size for every run: loudness and correlation are
    # normalised per section, so a borderline detection can depend on
    # the chunk size, and the flag-free plans differ (the one-device
    # file plan keeps 60 s chunks, the mesh paths take up to 120 s).
    pf: list[str] = ["--chunk-seconds", str(cfg.chunk_seconds)]
    for p in pattern_files:
        pf += ["--pattern-file", p]

    t0 = time.perf_counter()
    files = []
    for i in range(n_devices):
        path = os.path.join(workdir, f"station_{i}.wav")
        with open(path, "wb") as f:
            f.write(wav_bytes(make_stream(cfg, clips, 2, cfg.seed + 20 + i)[0], sr))
        files.append(path)
    serial = run_cli(["match", *files, *pf])
    meshed = run_cli(["match", "--mesh-stream", str(n_devices), *files, *pf])
    check(len(blocks(serial)) == n_devices, "serial multi-file run lost a block")
    check(
        meshed == serial,
        "--mesh-stream output differs from the serial run: "
        + json.dumps([(a, b) for a, b in zip(serial, meshed) if a != b][:6])
        + f" ({len(serial)} vs {len(meshed)} events)",
    )
    t_stream = time.perf_counter() - t0

    t0 = time.perf_counter()
    long_path = os.path.join(workdir, "archive.wav")
    long_audio, hits = make_stream(cfg, clips, 2 * n_devices, cfg.seed + 30)
    with open(long_path, "wb") as f:
        f.write(wav_bytes(long_audio, sr))
    (one,) = blocks(run_cli(["match", long_path, *pf]))
    (mt,) = blocks(run_cli(["match", "--mesh-time", str(n_devices), long_path, *pf]))

    def as_set(block: tuple[dict[str, list[int]], int]) -> set[tuple[str, int]]:
        return {(n, ms) for n, v in block[0].items() for ms in v}

    check(as_set(mt) == as_set(one) and mt[1] == one[1],
          f"--mesh-time events differ: {sorted(as_set(mt) ^ as_set(one))}")
    check_hits(
        as_set(one), hits, {c.name: len(c.audio) / sr for c in clips},
        "mesh-time archive",
    )
    t_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    det = AudioPatternDetector(audio_clips=clips, seconds_per_chunk=cfg.chunk_seconds)
    mesh = make_mesh({"stream": n_devices}, devices=jax.devices()[:n_devices])
    meshed_sess = MultiStreamSession(det, n_streams=n_devices, mesh=mesh)
    one_sess = MultiStreamSession(det, n_streams=n_devices)
    rounds = [
        make_stream(cfg, clips, 2, cfg.seed + 40 + i)[0].reshape(2, -1)
        for i in range(n_devices)
    ]
    ms_events = 0
    for r in range(2):
        chunks = [rounds[i][r] for i in range(n_devices)]
        got = meshed_sess.feed(chunks)
        want = one_sess.feed(chunks)
        check(got == want, f"meshed MultiStreamSession round {r} differs")
        ms_events += sum(len(v) for res in got for v in res.values())
    check(ms_events > 0, "meshed MultiStreamSession rounds saw no detections")
    report(
        "four",
        devices=n_devices,
        mesh_stream_files=n_devices,
        mesh_stream_seconds=t_stream,
        mesh_time_events=len(as_set(one)),
        mesh_time_seconds=t_time,
        multistream_events=ms_events,
        multistream_seconds=time.perf_counter() - t0,
    )


def result_line(info: dict[str, Any]) -> str:
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": info["platform"],
                "kind": info["kind"],
                "count": info["count"],
            },
        }
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--four",
        action="store_true",
        help="run only the four-device paths (needs four GPUs)",
    )
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    try:
        info = phase_device()
        for line in nvidia_smi():
            print(f"nvidia-smi: {line}", flush=True)
        from audio_pattern_detector_tpu.utils.compile_cache import (
            enable_persistent_cache,
        )

        report("cache", dir=enable_persistent_cache())
        with tempfile.TemporaryDirectory(prefix="apd_smoke_") as td:
            if args.four:
                phase_four(FULL, td)
            else:
                phase_uploads()
                phase_corpus()
                pattern_files = write_patterns(td, FULL)
                det = phase_flagship(FULL, pattern_files, td)
                phase_numerics(FULL, det)
                phase_serve(FULL, pattern_files)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    report("done", seconds=time.perf_counter() - t_start)
    print(result_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
