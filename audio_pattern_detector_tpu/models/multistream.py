"""Single-chip multi-stream serving: N independent live streams, one launch.

The reference's concurrency model is one OS process per stream
(reference: audio_pattern_detector.py:295-331 is a single sequential
loop; fan-out is left to the user). On an accelerator that wastes the
device. ``MultiStreamSession`` batches one chunk from every active
stream into ONE vmapped device launch per round via the pattern bank's
independent-lookback batch path
(``PatternBank.dispatch_chunks_batch(prev_tails=...)``), so a single
device serves N live stations at the per-stream chunk cadence.

Results are bit-identical to running each stream through the serial
engine: per-stream lookback, timestamp algebra, and flagged-row
resolution are the same code paths, just batched. Streams may end at
different times — pass ``None`` for finished streams (their row runs a
zero-length section and is discarded).
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu.models.detector import (
    AudioPatternDetector,
    StreamCheckpoint,
)


class MultiStreamSession:
    """Batch one chunk from each of N independent streams per device launch.

    Feed rounds are synchronous: call :meth:`feed` with one chunk (or
    ``None``) per stream; get per-stream ``{clip_name: [timestamps]}``
    back. Chunks must be float32 mono at the detector's target sample
    rate, at most ``seconds_per_chunk`` long (a shorter final chunk is
    fine, exactly as in the serial engine).
    """

    def __init__(
        self,
        detector: AudioPatternDetector,
        n_streams: int,
        mesh: Any = None,
        batch_mode: str | None = None,
        tile: int | None = None,
    ) -> None:
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if tile is not None and tile < 1:
            raise ValueError(f"tile must be >= 1, got {tile}")
        if tile is not None and mesh is not None:
            raise ValueError(
                "tile and mesh are mutually exclusive (a sharded round "
                "must batch all rows for the static row→device layout)"
            )
        if batch_mode not in (None, "scan", "vmap"):
            raise ValueError(
                f"batch_mode must be 'scan' or 'vmap', got {batch_mode!r}"
            )
        # Rows are independent in BOTH programs (the scan body carries no
        # state across rows — each is a complete fused step), so the mode
        # is purely an execution schedule. Default: "scan" single-device
        # (one chunk's intermediate memory); "vmap" when a mesh shards
        # the rows (GSPMD needs the parallel batch axis).
        if batch_mode == "scan" and mesh is not None:
            raise ValueError(
                "batch_mode='scan' cannot shard rows across a mesh; "
                "use 'vmap' (or omit batch_mode) with a mesh"
            )
        self._batch_mode = batch_mode or ("vmap" if mesh is not None else "scan")
        # Serving-capacity tiling: one round's N rows dispatch as
        # ceil(N/tile) launches of ONE compiled tile-row program (the
        # last tile padded with idle rows). Compile time and device
        # working memory are bounded by the tile, not the slot count —
        # a 256-slot server runs the same B=16 program sixteen times per
        # round instead of compiling a (huge, fully-unrolled) B=256
        # executable. None = a single full-width launch per round.
        self._tile = min(tile, n_streams) if tile is not None else None
        # Tiled rounds COMPACT: only active rows dispatch, gathered into
        # a greedy decomposition over this width ladder (the tile plus
        # every power of two below it — binary decomposition, so a
        # partial round never pads). Width ladders make device time and
        # upload bytes proportional to ACTIVE rows instead of slot
        # count: without them, a 64-slot server at low round occupancy
        # (fleet arrival transients, live paced stations) burns a full
        # 64 rows of FFT work and payload upload to advance 2-3 real
        # chunks. Each width
        # is one compiled program, shape-keyed; PatternServer.warmup
        # pre-compiles the ladder so no width compiles mid-service.
        self._tile_widths: list[int] | None = None
        if self._tile is not None:
            widths = {self._tile}
            w = 1
            while w < self._tile:
                widths.add(w)
                w *= 2
            self._tile_widths = sorted(widths, reverse=True)
        self.detector = detector
        self.n_streams = n_streams
        self._bank = detector._ensure_bank()
        sr = detector.target_sample_rate
        self._sr = sr
        self._chunk_samples = int(detector.seconds_per_chunk * sr)
        self._max_sw = max(
            d["sliding_window"] for d in detector._clip_datas.values()
        )
        self._tails: list[NDArray[np.float32] | None] = [None] * n_streams
        self._indices = [0] * n_streams
        self._times = [0.0] * n_streams
        self._empty = np.zeros(0, dtype=np.float32)
        # Optional data parallelism over streams: a mesh with a "stream"
        # axis partitions the batch rows across devices (GSPMD, no
        # collectives — rows are independent), so N chips serve
        # N × (n_streams / stream_axis) live stations with the same
        # per-round semantics. Rounds always batch all n_streams rows
        # (idle slots run zero-length sections), so the row→device
        # assignment is static.
        #
        # MULTI-HOST meshes (multi-controller JAX over DCN) work too:
        # ``n_streams`` then counts THIS process's local slots, each
        # process feeds only its own rows
        # (models/bank.py::_place / make_array_from_process_local_data)
        # and unpacks only its addressable payload shards. Contract: all
        # processes must call dispatch/collect in LOCKSTEP (every process
        # launches the same global program each round — the standard
        # multi-controller execution model; see tests/multihost_worker.py).
        self._sharding = None
        if mesh is not None:
            if "stream" not in mesh.axis_names:
                raise ValueError("mesh must have a 'stream' axis")
            stream_size = mesh.shape["stream"]
            import jax

            n_procs = jax.process_count()
            if n_procs > 1:
                if tuple(mesh.axis_names) != ("stream",):
                    raise ValueError(
                        "multi-host MultiStreamSession requires a 1-D "
                        f"'stream' mesh, got axes {mesh.axis_names}"
                    )
                if stream_size % n_procs:
                    raise ValueError(
                        f"stream axis ({stream_size}) must be divisible "
                        f"by the process count ({n_procs})"
                    )
                # Local rows stitch back in order only when each
                # process's devices form ONE contiguous run along the
                # stream axis (the _host_rows contract).
                procs_seen: list[int] = []
                for d in mesh.devices.flat:
                    p = d.process_index
                    if not procs_seen or procs_seen[-1] != p:
                        if p in procs_seen:
                            raise ValueError(
                                "multi-host mesh: stream-axis device "
                                "order must be process-contiguous"
                            )
                        procs_seen.append(p)
                local_devs = stream_size // n_procs
                if n_streams % local_devs:
                    raise ValueError(
                        f"n_streams {n_streams} (local) must be divisible "
                        f"by this process's stream-axis devices "
                        f"({local_devs})"
                    )
            elif n_streams % stream_size != 0:
                raise ValueError(
                    f"n_streams {n_streams} must be divisible by the "
                    f"mesh's stream axis ({stream_size})"
                )
            from jax.sharding import NamedSharding, PartitionSpec

            self._sharding = NamedSharding(
                mesh, PartitionSpec("stream", None)
            )

    def feed(
        self, chunks: Sequence[NDArray[np.float32] | None]
    ) -> list[dict[str, list[float]]]:
        """Process one chunk round; returns per-stream detection times.

        ``chunks[i] is None`` means stream ``i`` has no data this round
        (ended or stalled); its result is ``{}`` and its state is
        untouched. Timestamps are stream-local (seconds from that
        stream's start), computed with the reference algebra.

        Synchronous convenience: for faster-than-realtime driving, use
        :meth:`dispatch` / :meth:`collect` to keep several rounds in
        flight (the per-round launch + transfer + unpack otherwise
        serialize against device compute).
        """
        return self.collect(self.dispatch(chunks))

    def dispatch(
        self, chunks: Sequence[NDArray[np.float32] | None]
    ) -> Any:
        """Enqueue one chunk round (async); pair with :meth:`collect`.

        Stream state (lookback tails, indices, times) advances at
        dispatch time — the next round's lookback is host-known — so any
        number of rounds can be in flight before the first collect.
        """
        if len(chunks) != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} chunks, got {len(chunks)}"
            )
        batch: list[NDArray[np.float32]] = []
        tails: list[NDArray[np.float32] | None] = []
        rounds: list[NDArray[np.float32] | None] = []
        for i, chunk in enumerate(chunks):
            if chunk is not None:
                # int16 chunks ride through raw: the bank's batch
                # dispatch bit-packs them into upload lanes without ever
                # materialising f32 on the host (bit-identical results —
                # the device unpack IS the int16 -> f32 decode).
                if np.asarray(chunk).dtype == np.int16:
                    chunk = np.ascontiguousarray(chunk)
                else:
                    chunk = np.ascontiguousarray(chunk, dtype=np.float32)
                if chunk.ndim != 1 or len(chunk) > self._chunk_samples:
                    raise ValueError(
                        f"stream {i}: chunk must be 1-D with at most "
                        f"{self._chunk_samples} samples, got shape {chunk.shape}"
                    )
                # A zero-length chunk is an idle round, same as None — it
                # must not advance the chunk index or replace the lookback
                # tail with an empty array (that would shift every later
                # timestamp for the stream).
                if len(chunk) == 0:
                    chunk = None
            rounds.append(chunk)
            if chunk is None:
                batch.append(self._empty)
                tails.append(None)
            else:
                batch.append(chunk)
                tails.append(self._tails[i])

        if self._tile is None:
            dispatched = [
                self._bank.dispatch_chunks_batch(
                    batch, None, mode=self._batch_mode, prev_tails=tails,
                    sharding=self._sharding,
                )
            ]
            active = None
        else:
            # Compacted tiled round: gather the ACTIVE rows (slot order
            # preserved) and dispatch them as a greedy width-ladder
            # decomposition — largest tile width that fits the remaining
            # rows each step. The ladder contains every power of two up
            # to the tile, so the decomposition is exact: no idle-row
            # padding, device time and h2d bytes scale with the round's
            # real occupancy. collect() scatters rows back to slots via
            # the recorded gather order.
            active = [
                i for i in range(self.n_streams) if rounds[i] is not None
            ]
            assert self._tile_widths is not None
            dispatched = []
            k = 0
            while k < len(active):
                rem = len(active) - k
                w = next(
                    width for width in self._tile_widths if width <= rem
                )
                slots = active[k : k + w]
                k += w
                dispatched.append(
                    self._bank.dispatch_chunks_batch(
                        [batch[i] for i in slots],
                        None,
                        mode=self._batch_mode,
                        prev_tails=[tails[i] for i in slots],
                    )
                )
        # (stream_active, index, had_prev) snapshot for collect-time
        # timestamp conversion; then advance state for the next round.
        meta = []
        for i, chunk in enumerate(rounds):
            if chunk is None:
                meta.append(None)
                continue
            meta.append((self._indices[i], self._tails[i] is not None))
            self._tails[i] = batch[i][int(-self._max_sw * self._sr):].copy()
            self._indices[i] += 1
            self._times[i] += len(batch[i]) / self._sr
        return (dispatched, meta, active)

    def collect(self, handle: Any) -> list[dict[str, list[float]]]:
        """Block on a dispatched round; per-stream detection times."""
        dispatched, meta, active = handle
        rows: list[dict[str, list[int]]] = []
        for d in dispatched:
            rows.extend(self._bank.collect_chunks_batch(d))
        if active is None:
            results = rows[: self.n_streams]
        else:
            # Scatter the compacted rows back to their slots (idle slots
            # never dispatched a row).
            results = [dict() for _ in range(self.n_streams)]
            for pos, slot in enumerate(active):
                results[slot] = rows[pos]
        out: list[dict[str, list[float]]] = []
        for i, m in enumerate(meta):
            if m is None:
                out.append({})
                continue
            index, had_prev = m
            out.append(
                self.detector.peaks_to_times(results[i], index, had_prev)
            )
        return out

    def round_ready(self, handle: Any) -> bool:
        """Non-blocking: a dispatched round's payloads all completed."""
        from audio_pattern_detector_tpu.models.detector import (
            _dispatched_ready,
        )

        return all(_dispatched_ready(d) for d in handle[0])

    def checkpoint(self, stream: int) -> StreamCheckpoint:
        """O(1) resume state for one stream (models/detector.py
        StreamCheckpoint semantics)."""
        tail = self._tails[stream]
        if tail is not None and tail.dtype == np.int16:
            # The int16 serving fast path keeps tails raw in-session
            # (feed decodes mixed-dtype lookback on device), but
            # StreamCheckpoint's contract — and its to_bytes layout —
            # is f32 samples. Decode with the bitwise-pinned cast+scale
            # so a serialized resume reads the same bits the device
            # unpack would have produced.
            from audio_pattern_detector_tpu.models.bank import _pcm16_to_f32

            tail = _pcm16_to_f32(tail)
        elif tail is not None:
            tail = tail.copy()
        return StreamCheckpoint(
            self._indices[stream],
            tail,
            self._times[stream],
        )

    def total_time(self, stream: int) -> float:
        """Seconds of audio processed so far for one stream."""
        return self._times[stream]

    def reset(self, stream: int) -> None:
        """Reclaim one slot for a fresh stream.

        The serving layer (serve.py) reuses session slots across client
        connections; resetting restores the slot to its initial state
        (no lookback tail, chunk index 0) without touching any other
        stream or recompiling the batch program.
        """
        self._tails[stream] = None
        self._indices[stream] = 0
        self._times[stream] = 0.0
