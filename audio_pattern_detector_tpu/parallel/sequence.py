"""Sequence-parallel detection: one long stream sharded across the mesh.

The serial engine scans a stream as overlapping sections
(chunk + ``sliding_window`` seconds of lookback — reference:
audio_pattern_detector.py:400-412). Here every device owns one chunk-sized
time slice of the stream and receives its lookback halo from the left
neighbour (``jax.lax.ppermute``), so each device's section is
bit-identical to the section the serial loop would have built for that
chunk index — the FFT-correlation equivalent of ring attention's halo
exchange. A second mesh axis ("stream") runs independent streams in
parallel (DP).

Unbounded streams scan in successive slabs: a :class:`ShardedStreamSession`
carries the lookback tail from one slab to the next (device 0 of slab k+1
takes its halo from the host-carried tail rather than ppermute), and a
short final slab is zero-padded with per-device validity masking — the
distributed equivalents of the serial loop's ``previous_chunk`` carry and
final-short-chunk handling. Candidate-capacity overflow on any
(stream, device, clip) cell re-runs that cell's exact section on the host
path, preserving the serial engine's exactness contract
(reference: audio_pattern_detector.py:520-546).

Timestamp algebra on the host matches the serial engine exactly: the
stream's first chunk is lookback-free, every other chunk subtracts its
sliding-window seconds.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from numpy.typing import NDArray

from audio_pattern_detector_tpu.models.bank import (
    PatternBank,
    _class_step,
    _host_prefetch,
    _host_rows,
    _place,
    unpack_group,
)
from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.utils.clip import AudioClip

try:  # jax >= 0.4.35 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map  # type: ignore


class ShardedDetector:
    """Detector over a (stream, time) device mesh.

    ``detect(audio)`` takes a (B, T) float32 batch of equal-length streams
    of any positive length, shards B over the optional "stream" axis and
    time over the "time" axis (one chunk per time-device, looping over
    slabs for long streams), and returns per-stream, per-clip timestamps
    identical to running the serial engine with ``seconds_per_chunk =
    chunk_seconds`` on each stream. ``session()`` exposes the incremental
    slab-feeding form for unbounded streams.
    """

    def __init__(
        self,
        audio_clips: list[AudioClip],
        mesh: Mesh,
        chunk_seconds: int,
        target_sample_rate: "int | None" = None,
        height_min: "float | None" = None,
        detector: "AudioPatternDetector | None" = None,
    ) -> None:
        if "time" not in mesh.axis_names:
            raise ValueError("mesh must have a 'time' axis")
        self.mesh = mesh
        self.time_size = mesh.shape["time"]
        self.stream_size = mesh.shape.get("stream", 1)
        self.bank_size = mesh.shape.get("bank", 1)
        self.chunk_seconds = chunk_seconds

        # Slab bound first — before the serial detector's own per-chunk
        # f32-exactness guard — so oversized MESH configs get the error
        # that names the mesh knob (time axis), not just chunk size.
        from audio_pattern_detector_tpu.utils.audio_io import (
            DEFAULT_TARGET_SAMPLE_RATE,
        )

        sr = (
            detector.target_sample_rate
            if detector is not None
            else (target_sample_rate or DEFAULT_TARGET_SAMPLE_RATE)
        )
        if self.time_size * chunk_seconds * sr >= 2**31:
            # Device-side sample counts are i32 (f32-only transfers force
            # an (hi, lo) split that reconstructs into i32).
            raise ValueError(
                f"slab of {self.time_size * chunk_seconds * sr} samples "
                "exceeds the int32 sample-index range; reduce "
                "chunk_seconds or the time axis"
            )

        if detector is not None:
            # Reuse a caller-built serial detector (the CLI mesh path) so
            # clip validation / chunk resolution run once, not twice.
            if detector.seconds_per_chunk != chunk_seconds:
                raise ValueError(
                    "detector.seconds_per_chunk "
                    f"{detector.seconds_per_chunk} != chunk_seconds {chunk_seconds}"
                )
            self._detector = detector
        else:
            self._detector = AudioPatternDetector(
                audio_clips=audio_clips,
                seconds_per_chunk=chunk_seconds,
                target_sample_rate=target_sample_rate,
                height_min=height_min,
            )
        self.sample_rate = self._detector.target_sample_rate
        self.chunk_samples = chunk_seconds * self.sample_rate
        self.slab_samples = self.time_size * self.chunk_samples
        self.bank: PatternBank = self._detector._ensure_bank()
        self.max_halo = max(
            sw * self.sample_rate for sw in self.bank.classes
        )
        # Multi-host (DCN) contract: the "stream" axis spans processes
        # (process-contiguous rows — jax.devices() is process-major and
        # make_mesh keeps enumeration order), and
        # every host owns whole (time × bank) slices so halo exchange and
        # payload unpack stay host-local. Each process then feeds only its
        # own streams' rows; nothing but the ppermute halo crosses DCN.
        self.process_count = jax.process_count()
        if self.process_count > 1:
            if self.stream_size % self.process_count != 0:
                raise ValueError(
                    f"multi-host mesh needs the stream axis "
                    f"({self.stream_size}) divisible by the process count "
                    f"({self.process_count})"
                )
            local_slices = (
                (self.stream_size // self.process_count)
                * self.time_size
                * self.bank_size
            )
            if local_slices != jax.local_device_count():
                raise ValueError(
                    f"multi-host mesh places {local_slices} devices per "
                    f"process but {jax.local_device_count()} are local; "
                    "order the mesh stream-outermost with time x bank "
                    "within one host"
                )
        # Per-class group consts, padded to a bank-axis-divisible clip
        # count when the mesh has a "bank" axis (2-D bank × time sharding;
        # padded rows duplicate clip 0 and are sliced off on unpack).
        from audio_pattern_detector_tpu.parallel.bankshard import (
            pad_group_consts,
        )

        self._class_consts: dict[int, tuple] = {}
        for sw, cls in self.bank.classes.items():
            consts = []
            for g in cls["groups"]:
                g_real = len(g.names)
                g_pad = -(-g_real // self.bank_size) * self.bank_size
                consts.append(pad_group_consts(g.corr, g.verify, g_pad))
            self._class_consts[sw] = tuple(consts)
        # jit cache key: (sliding_window, slab-has-lookback-carry)
        self._jitted: dict[tuple[int, bool], Any] = {}

    # ── device program ──

    def _build_class_fn(self, sw: int, has_prev: bool):
        """shard_map'ed program for one sliding-window class.

        ``has_prev`` selects the first-slab variant (device 0's section has
        no lookback, like the serial stream head) vs the carried variant
        (device 0's halo arrives from the host-carried previous-slab tail).
        """
        cls = self.bank.classes[sw]
        metas = self.bank._metas[sw]
        height_min = self.bank.height_min
        halo = sw * self.sample_rate
        chunk = self.chunk_samples
        time_size = self.time_size
        has_stream = "stream" in self.mesh.axis_names
        has_bank = self.bank_size > 1
        blk_spec = P("stream" if has_stream else None, "time")
        tail_spec = P("stream" if has_stream else None, None)

        loud = cls["loud"]
        group_consts = self._class_consts[sw]
        if has_bank:
            from audio_pattern_detector_tpu.parallel.bankshard import (
                group_spec_tree,
            )

            gc_specs: Any = tuple(
                group_spec_tree(c, v, "bank") for c, v in group_consts
            )
            out_spec = P(
                "stream" if has_stream else None, "time", "bank"
            )
        else:
            gc_specs = P()
            out_spec = P(*blk_spec)

        def local_fn(blk, prev_tail, t_parts, loud_c, gconsts):
            # blk: (B_local, 1, chunk) — this device's time slice.
            # prev_tail: (B_local, halo) — lookback for device 0.
            # t_parts: (2,) f32 (hi, lo) split of the valid-sample count
            # (every upload is f32, see ops/_pytree.int_const; a single
            # f32 scalar would round counts >= 2^24 — large meshes with
            # long chunks exceed that). Each part is < 2^24 so the
            # f32 crossing is exact; reconstruction is exact in i32.
            t_actual = (
                t_parts[0].astype(jnp.int32) * 4096
                + t_parts[1].astype(jnp.int32)
            )
            local = blk[:, 0, :]
            tail = local[:, -halo:]
            # Left-neighbour halo via ppermute; device 0 takes the carried
            # tail (or none at the stream head).
            perm = [(i, i + 1) for i in range(time_size - 1)]
            recv = jax.lax.ppermute(tail, "time", perm)
            t_idx = jax.lax.axis_index("time")

            # Samples this device actually owns (short final slab masks
            # trailing devices via n_valid, exactly like the serial
            # engine's final short chunk).
            owned = jnp.clip(t_actual - t_idx * chunk, 0, chunk)

            if has_prev:
                halo_src = jnp.where(t_idx == 0, prev_tail, recv)
                section = jnp.concatenate([halo_src, local], axis=1)
                n_valid = (owned + halo).astype(jnp.int32)
            else:
                sec_with_halo = jnp.concatenate([recv, local], axis=1)
                sec_first = jnp.concatenate(
                    [local, jnp.zeros_like(local[:, :halo])], axis=1
                )
                section = jnp.where(t_idx == 0, sec_first, sec_with_halo)
                n_valid = (
                    owned + jnp.where(t_idx == 0, 0, halo)
                ).astype(jnp.int32)

            step = lambda s: _class_step(
                s,
                n_valid,
                loud_c,
                gconsts,
                metas=metas,
                height_min=height_min,
                lean=True,
            )
            outs = jax.vmap(step)(section)
            # Re-insert the time axis for the out_spec.
            return jax.tree_util.tree_map(lambda a: a[:, None], outs)

        mapped = shard_map(
            local_fn,
            mesh=self.mesh,
            in_specs=(P(*blk_spec, None), tail_spec, P(None), P(), gc_specs),
            out_specs=out_spec,
            check_vma=False,
        )
        return jax.jit(
            lambda blk, prev_tail, t_parts: mapped(
                blk, prev_tail, t_parts, loud, group_consts
            )
        )

    # ── host API ──

    def session(self) -> "ShardedStreamSession":
        """Start an incremental scan: feed slab after slab of one stream
        batch; results are serial-engine-identical across slab boundaries."""
        return ShardedStreamSession(self)

    def detect(self, audio: NDArray[np.float32]) -> dict[str, list[list[float]]]:
        """Scan a (B, T) batch of streams of any length T > 0; returns
        name -> per-stream sorted timestamp lists (serial-engine-identical
        algebra). Long streams loop over mesh-sized slabs internally."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        B, T = audio.shape
        if T <= 0:
            raise ValueError("stream length must be positive")

        sess = self.session()
        results: dict[str, list[list[float]]] = {
            name: [[] for _ in range(B)]
            for cls in self.bank.classes.values()
            for g in cls["groups"]
            for name in g.names
        }
        for start in range(0, T, self.slab_samples):
            slab = audio[:, start : start + self.slab_samples]
            part = sess.feed(slab)
            for name, per_stream in part.items():
                for b in range(B):
                    results[name][b].extend(per_stream[b])
        for name in results:
            for b in range(B):
                results[name][b].sort()
        return results


class ShardedStreamSession:
    """Carries lookback state between successive slabs of one stream batch.

    Every ``feed`` must supply a full slab (``time_axis × chunk_samples``
    samples per stream) except the last, which may be shorter; after a
    short slab the stream is finished and further feeds are rejected —
    the same contract as the serial loop, where only the final chunk may
    be short.
    """

    def __init__(self, sd: ShardedDetector) -> None:
        self._sd = sd
        self._carry: NDArray[np.float32] | None = None  # (B, max_halo)
        self._base = 0  # global chunk index of the next slab's device 0
        self._batch: int | None = None
        self._finished = False

    def feed(self, slab: NDArray[np.float32]) -> dict[str, list[list[float]]]:
        """One slab; returns name -> per-stream timestamp lists.

        Multi-host: every process calls feed in lockstep with the SAME
        slab length but only its OWN streams' rows (global batch =
        local batch × process count, process-contiguous); the returned
        results cover this process's streams."""
        sd = self._sd
        slab = np.asarray(slab, dtype=np.float32)
        if slab.ndim == 1:
            slab = slab[None, :]
        B, t_actual = slab.shape
        if self._finished:
            raise ValueError(
                "stream already finished: a short slab must be the last"
            )
        if self._batch is None:
            local_groups = sd.stream_size // sd.process_count
            if B % local_groups != 0:
                raise ValueError(
                    f"batch {B} must be divisible by this process's share "
                    f"of the stream axis ({local_groups})"
                )
            self._batch = B
        elif B != self._batch:
            raise ValueError(f"batch changed between slabs: {self._batch} -> {B}")
        if t_actual <= 0 or t_actual > sd.slab_samples:
            raise ValueError(
                f"slab length {t_actual} must be in (0, {sd.slab_samples}]"
            )
        if t_actual < sd.slab_samples:
            self._finished = True

        padded = slab
        if t_actual < sd.slab_samples:
            padded = np.zeros((B, sd.slab_samples), dtype=np.float32)
            padded[:, :t_actual] = slab
        blocks = padded.reshape(B, sd.time_size, sd.chunk_samples)

        has_stream = "stream" in sd.mesh.axis_names
        sharding = NamedSharding(
            sd.mesh, P("stream" if has_stream else None, "time", None)
        )
        global_rows = B * sd.process_count
        blocks_dev = _place(blocks, sharding, global_rows)
        tail_sharding = NamedSharding(
            sd.mesh, P("stream" if has_stream else None, None)
        )

        has_prev = self._carry is not None
        sr = sd.sample_rate
        chunk = sd.chunk_samples
        results: dict[str, list[list[float]]] = {}

        # Per-device stream algebra, shared by every class below.
        d_idx = np.arange(sd.time_size)
        owned_d = np.clip(t_actual - d_idx * chunk, 0, chunk)  # (Dt,)
        active_d = owned_d > 0
        index_d = self._base + d_idx

        # Valid-sample count as an exact f32 (hi, lo) pair — a single f32
        # scalar rounds at 2^24 samples, well inside big-mesh slab sizes.
        # Kept as a HOST array: multi-controller jit treats numpy inputs
        # as replicated (every process passes the identical value — the
        # lockstep slab-length contract), where a device-committed array
        # would be single-host.
        t_parts = np.asarray(
            [t_actual >> 12, t_actual & 0xFFF], dtype=np.float32
        )

        # Phase 1: dispatch EVERY class's device program back-to-back
        # (each payload's d2h prefetched at dispatch time) so no class
        # waits on an earlier class's blocking unpack before its program
        # is even enqueued.
        dispatched = []
        for sw, cls in sd.bank.classes.items():
            key = (sw, has_prev)
            if key not in sd._jitted:
                sd._jitted[key] = sd._build_class_fn(sw, has_prev)
            halo = sw * sr
            if has_prev:
                assert self._carry is not None
                prev_tail = np.ascontiguousarray(self._carry[:, -halo:])
            else:
                prev_tail = np.zeros((B, halo), dtype=np.float32)
            prev_tail_dev = _place(prev_tail, tail_sharding, global_rows)

            outs = sd._jitted[key](blocks_dev, prev_tail_dev, t_parts)
            for out in outs:
                # Enqueue each payload's d2h at dispatch time (see
                # models/bank.py::_host_prefetch) so transfers overlap
                # other classes' device compute and host unpack.
                _host_prefetch(out["packed"])
            dispatched.append((sw, cls, halo, prev_tail, outs))

        # Phase 2: blocking unpack + flag resolution per class.
        for sw, cls, halo, prev_tail, outs in dispatched:
            subtract_d = np.where((d_idx > 0) | has_prev, sw, 0.0)  # (Dt,)

            # Pass 1 (vectorised): clean timestamps per group + flagged
            # cells collected per (b, d) section.
            group_arrays = []
            flagged_cells: dict[tuple[int, int], list[tuple[int, int, bool]]] = {}
            for gi, (g, out) in enumerate(zip(cls["groups"], outs)):
                g_real = len(g.names)
                packed = _host_rows(out["packed"])[:, :, :g_real, :]
                pos, sel, host_fb, needs_full = unpack_group(packed, g.k_verify)
                clip_seconds = g.clip_len / sr

                # Vectorised timestamp algebra over (B, Dt, G, K):
                # t = pos/sr - subtract + index*chunk_s - clip_s, clamped.
                t_all = np.maximum(
                    pos / sr
                    - subtract_d[None, :, None, None]
                    + index_d[None, :, None, None] * sd.chunk_seconds
                    - clip_seconds,
                    0.0,
                )
                flagged = host_fb | needs_full  # (B, Dt, G)
                clean = (
                    sel
                    & ~flagged[..., None]
                    & active_d[None, :, None, None]
                )
                group_arrays.append((g, t_all, clean, clip_seconds))
                for b, d, ci in np.argwhere(
                    flagged & active_d[None, :, None]
                ):
                    flagged_cells.setdefault((int(b), int(d)), []).append(
                        (gi, int(ci), bool(host_fb[b, d, ci]))
                    )

            # Pass 2 (rare): resolve flagged cells exactly — row-granular
            # full-tier DEVICE reruns (whole-class rerun above the row
            # threshold), host path only for flag-1 / rerun overflow.
            cell_times: dict[tuple[int, int, int], list[float]] = {}
            for (b, d), triples in flagged_cells.items():
                raw = _device_section(
                    slab, prev_tail, b, d, chunk, halo,
                    int(owned_d[d]), has_prev,
                )
                resolved = sd.bank.resolve_flagged_rows(sw, triples, raw)
                for (gi, ci), hits in resolved.items():
                    clip_seconds = group_arrays[gi][3]
                    cell_times.setdefault((gi, b, ci), []).extend(
                        max(
                            p / sr
                            - subtract_d[d]
                            + index_d[d] * sd.chunk_seconds
                            - clip_seconds,
                            0.0,
                        )
                        for p in hits
                    )

            # Pass 3: assemble per-clip per-stream sorted lists. One
            # nonzero + lexsort + searchsorted per group replaces the old
            # per-(clip, stream) boolean-mask/sort loop — the surviving
            # Python work is only the required list construction per cell.
            for gi, (g, t_all, clean, _cs) in enumerate(group_arrays):
                n_clips = len(g.names)
                b_f, _d_f, c_f, _k_f = np.nonzero(clean)
                t_f = t_all[clean]
                # lexsort: last key is primary → grouped by clip, then
                # stream, time-ascending within each (clip, stream) cell.
                order = np.lexsort((t_f, b_f, c_f))
                t_sorted = t_f[order]
                cell_key = c_f[order] * B + b_f[order]
                bounds = np.searchsorted(
                    cell_key, np.arange(n_clips * B + 1)
                )
                for ci, name in enumerate(g.names):
                    per_stream: list[list[float]] = []
                    for b in range(B):
                        cell = ci * B + b
                        times = t_sorted[bounds[cell] : bounds[cell + 1]].tolist()
                        extra = cell_times.get((gi, b, ci))
                        if extra:
                            times = sorted(times + extra)
                        per_stream.append(times)
                    results[name] = per_stream
        # Advance carry/base for the next slab. A full slab always covers
        # the carry: the detector invariant chunk >= 2*sliding_window gives
        # slab_samples >= chunk_samples >= 2*max_halo.
        if not self._finished:
            self._carry = np.ascontiguousarray(slab[:, -sd.max_halo :])
            self._base += sd.time_size
        return results


def _device_section(
    slab: NDArray[np.float32],
    prev_tail: NDArray[np.float32],
    b: int,
    d: int,
    chunk: int,
    halo: int,
    owned: int,
    has_prev: bool,
) -> NDArray[np.float32]:
    """Reconstruct the exact raw section device (b, d) scanned — the
    host-fallback input for overflowed cells."""
    start = d * chunk
    end = start + owned
    if d == 0:
        if has_prev:
            return np.concatenate([prev_tail[b, -halo:], slab[b, :end]])
        return np.ascontiguousarray(slab[b, :end])
    return np.ascontiguousarray(slab[b, start - halo : end])


def detections_from_sharded(
    results: dict[str, list[list[float]]], stream_index: int = 0
) -> dict[str, list[float]]:
    """Flatten a ShardedDetector result to the serial engine's dict shape."""
    return {name: per_stream[stream_index] for name, per_stream in results.items()}
