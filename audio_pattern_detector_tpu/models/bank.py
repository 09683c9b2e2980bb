"""Pattern bank: compiles clips into shape-static device programs.

The reference iterates clips in Python and launches one native FFT per clip
per chunk (reference: audio_pattern_detector.py:306-313). Here clips are
grouped by (sliding_window, clip_len, strategy); each sliding-window class
gets ONE jitted device program that:

  1. loudness-normalises the class section (FFT-conv K-weighting + gating),
  2. correlates the section against every group's whole bank in one
     batched rfft·conj·irfft launch,
  3. finds peaks (vectorised plateau maxima + greedy distance) and
  4. verifies all candidates as masked, bank-batched tensor programs,

returning only integer peak positions + accept masks (a few KB) to host.
Every chunk of a stream — first, steady-state, and final short chunk —
reuses the same executable via dynamic ``n_valid`` masking.
"""

from __future__ import annotations

import os as _os
import time as _time
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu import native
from audio_pattern_detector_tpu.models import hostpath
from audio_pattern_detector_tpu.ops.correlate import (
    CorrelationBankConsts,
    bank_correlate,
    bank_correlate_multi,
    build_correlation_bank,
    class_overlap_save_geometry,
    section_segment_spectra,
)
from audio_pattern_detector_tpu.ops.loudness import (
    LoudnessConsts,
    build_loudness_consts,
    integrated_loudness_device,
    loudness_normalize_device,
)
from audio_pattern_detector_tpu.ops.packing import (
    packed_upload_supported,
    try_pack_pcm16,
)
from audio_pattern_detector_tpu.ops.peaks import (
    PeakCandidates,
    find_peaks_device_fast,
    greedy_distance_filter,
    greedy_survivors_blockwise,
    long_plateau_present,
    short_run_local_maxima_mask,
    topk_sparse,
)
from audio_pattern_detector_tpu.ops.verify import (
    MarkerVerifyConsts,
    NormalVerifyConsts,
    build_marker_verify_consts,
    build_normal_verify_consts,
    verify_marker,
    verify_normal,
)

_BIG = np.int32(2**30)

# Candidate-free groups skip the verify tail via lax.cond (_lean_tail).
# Read ONCE at import: the flag shapes traced programs but is not part of
# the jit cache key, so a mid-process env flip would silently reuse stale
# executables — import-time capture makes the semantics process-stable
# (A/Bs toggle it across processes).
_SKIP_EMPTY_VERIFY = _os.environ.get("APD_SKIP_EMPTY_VERIFY", "1") != "0"


# Cumulative wall seconds per dispatch_chunks_batch host stage, process-
# wide (same cheap monotonic bookkeeping as PatternServer.phase_seconds;
# a few timer reads per round). Read/reset by perf probes to attribute
# where a serving round's enqueue time goes: section assembly, int16
# pack, h2d upload, launch, or the d2h prefetch enqueue.
dispatch_phase_seconds: dict[str, float] = {
    "sections": 0.0,
    "pack": 0.0,
    "upload": 0.0,
    "launch": 0.0,
    "prefetch": 0.0,
}


def _pcm16_to_f32(raw: NDArray[np.int16]) -> NDArray[np.float32]:
    """Bitwise-pinned int16 -> f32 decode (cast, then scale in f32) —
    the same bits the stream wrappers and the device unpack produce."""
    from audio_pattern_detector_tpu import native

    return native.pcm16_to_f32_mono(raw)

# Small verification tier: chunks whose live-candidate count fits entirely
# below this bound verify through a 16-lane program instead of the full
# k_verify tier (see the two-tier cond in _class_step).
_SMALL_TIER = 16


def _two_tier_accept(verify_accept, vpos, valive, kv):
    """Two-tier verification, shared by the rich path (_class_step) and the
    WIDE-lean rerun (_lean_group_packed).

    Real chunks carry at most a handful of live candidates while ``kv``
    sizes for the worst case. The candidate compaction puts each row's
    live lanes FIRST, so when every row's survivors fit the small tier —
    true for all but pathological hit densities — verifying the first
    ``_SMALL_TIER`` lanes is exact and the heavy full-width gather is
    skipped at runtime (``lax.cond``; in vmapped batch contexts both
    branches execute — the win is for the streaming path). Callers gate
    on ``kv > _SMALL_TIER``.
    """
    max_alive = jnp.max(jnp.sum(valive.astype(jnp.int32), axis=1))

    def small_tier(_):
        acc = verify_accept(vpos[:, :_SMALL_TIER], valive[:, :_SMALL_TIER])
        return jnp.pad(acc, ((0, 0), (0, kv - _SMALL_TIER)))

    def full_tier(_):
        return verify_accept(vpos, valive)

    return jax.lax.cond(max_alive <= _SMALL_TIER, small_tier, full_tier, None)


@dataclass
class ClipGroup:
    """Clips sharing (sliding_window, clip_len, strategy) — one device batch."""

    names: list[str]
    clip_len: int
    sliding_window: int
    kind: str  # 'normal' | 'marker'
    k_detect: int
    k_verify: int
    corr: CorrelationBankConsts
    verify: "NormalVerifyConsts | MarkerVerifyConsts"
    # Host-side data for the exact fallback path.
    clips_np: NDArray[np.float32]  # (G, m) normalised clips
    corr_clips_np: NDArray[np.float32]  # (G, 2m-1)
    self_max_np: NDArray[np.float64]  # (G,)
    tone_freqs: list[float | None]
    verification_params: list[dict[str, Any]]


class PatternBank:
    """Device-compiled pattern bank for one detector configuration."""

    def __init__(
        self,
        clip_datas: dict[str, dict[str, Any]],
        tone_frequencies: dict[str, float],
        strategy_params: dict[str, dict[str, Any]],
        sample_rate: int,
        chunk_samples: int,
        height_min: float,
    ) -> None:
        self.sample_rate = sample_rate
        self.chunk_samples = chunk_samples
        self.height_min = float(height_min)
        # Packed (int16-pair) section upload: halves h2d bytes for 16-bit
        # PCM-exact chunks, bit-identical results (ops/packing.py). Guarded
        # by a one-per-process device round-trip of NaN-payload sentinel
        # patterns — a runtime that canonicalises NaNs in transfer would
        # silently corrupt near-full-scale samples, so packing auto-disables
        # there. APD_PACKED_UPLOAD=0 is the manual opt-out.
        self._packed_upload = (
            _os.environ.get("APD_PACKED_UPLOAD", "1") != "0"
            and packed_upload_supported()
        )
        # Batch payload-buffer pool: dispatch_chunks_batch fills a
        # (b, S) host staging array every round; allocating it fresh
        # each time hits glibc's mmap threshold for multi-MB sizes, so
        # EVERY round pays the full first-touch page-fault cost.
        # Buffers are keyed by
        # (kind, b, S) and recycled at COLLECT time — only after
        # _host_rows has materialised that dispatch's results, i.e.
        # after the program provably finished executing. That timing
        # makes reuse sound on EVERY backend, including CPU zero-copy
        # configurations where jnp.asarray may ALIAS the host buffer
        # (per-buffer and alignment-dependent on jax 0.9 CPU, so a
        # one-shot process-level probe cannot gate this): an
        # aliasing program reads the buffer during execution, and the
        # buffer is never refilled until after that execution completed.
        # (jax does not cache device arrays by host-buffer identity —
        # refilled buffers upload fresh values; probed explicitly.)
        self._payload_pool: dict[tuple, list] = {}

        # Block-summary lean tier (ops/peaks.py::greedy_survivors_rederive):
        # bitwise-identical survivors with no (G, L) scored/mask buffers.
        # Opt-in until measured.
        self._blocked = _os.environ.get("APD_BLOCK_LEAN") == "1"
        # Merged-irfft geometry (one inverse transform for ALL groups of
        # a class). Opt-in; a static jit arg so A/Bs toggle it without
        # retracing games.
        self._merged = _os.environ.get("APD_MERGED_IRFFT") == "1"
        # Donate the uploaded payload buffer to the batch program
        # (_DONATING_JITS): opt-in pending measurement; CPU backends
        # warn on donation.
        self._donate = _os.environ.get("APD_DONATE_UPLOAD") == "1"

        # ── Group clips by (sliding_window, clip_len, strategy) ──
        grouped: dict[tuple[int, int, str], list[str]] = {}
        for name, cd in clip_datas.items():
            kind = "marker" if name in tone_frequencies else "normal"
            key = (cd["sliding_window"], len(cd["clip"]), kind)
            grouped.setdefault(key, []).append(name)

        # One shared overlap-save geometry per sliding-window class (sized
        # for its largest clip), so the section's segment FFT is computed
        # once per chunk and reused by every group.
        class_clip_lens: dict[int, list[int]] = {}
        for (sw, m, kind) in grouped:
            class_clip_lens.setdefault(sw, []).append(m)

        _overlap_save = _os.environ.get("APD_NO_OVERLAP_SAVE") != "1"
        shared_geoms = {
            sw: class_overlap_save_geometry(
                sw * sample_rate + chunk_samples, ms
            )
            if _overlap_save
            else None
            for sw, ms in class_clip_lens.items()
        }

        self.classes: dict[int, dict[str, Any]] = {}
        for (sw, m, kind), names in sorted(grouped.items()):
            section_len = sw * sample_rate + chunk_samples
            cls = self.classes.setdefault(
                sw,
                {
                    "section_len": section_len,
                    "loud": None,
                    "groups": [],
                },
            )
            if cls["loud"] is None:
                cls["loud"] = build_loudness_consts(
                    section_len,
                    sample_rate,
                    overlap_save=_overlap_save,
                )

            clips_np = np.stack([clip_datas[n]["clip"] for n in names])
            corr_clips_np = np.stack([clip_datas[n]["correlation_clip"] for n in names])
            self_max_np = np.array(
                [float(clip_datas[n]["correlation_clip_absolute_max"]) for n in names]
            )
            corr = build_correlation_bank(
                clips_np,
                self_max_np,
                section_len,
                overlap_save=_overlap_save,
                shared_geometry=shared_geoms[sw],
            )

            full_len = corr.full_len
            # Post-distance survivors are bounded by full_len/m + 1; size the
            # verify tier to that bound (never overflows) and the raw
            # candidate tier with headroom (overflow -> exact host fallback).
            k_verify = min(1024, full_len // m + 4)
            k_detect = min(4096, max(64, 4 * (full_len // m) + 16))
            k_detect = max(k_detect, k_verify)

            if kind == "marker":
                dom = np.array([tone_frequencies[n] for n in names])
                vparams = [
                    strategy_params.get(n, {}).get("verification", {}) for n in names
                ]
                verify = build_marker_verify_consts(m, sample_rate, dom, vparams)
                tone_freqs: list[float | None] = [tone_frequencies[n] for n in names]
                # A real tone hit floods |corr| with a candidate comb —
                # peaks every half period across the ±m alignment envelope,
                # up to ~2·m·f/sr raw candidates per hit. Size k_detect to
                # hold ~8 simultaneous hits so hit-bearing chunks stay
                # on-device (flag 2 → row-granular full-tier rerun) instead
                # of overflowing to the host path; the wider lanes cost
                # nothing in the lean program (k_detect is only a flag
                # threshold there) and price only the rare rerun.
                comb = int(np.ceil(2.0 * m * float(dom.max()) / sample_rate))
                k_detect = min(16384, max(k_detect, 8 * comb + 256))
            else:
                verify = build_normal_verify_consts(corr_clips_np, m, sample_rate)
                vparams = [{} for _ in names]
                tone_freqs = [None for _ in names]

            cls["groups"].append(
                ClipGroup(
                    names=names,
                    clip_len=m,
                    sliding_window=sw,
                    kind=kind,
                    k_detect=k_detect,
                    k_verify=k_verify,
                    corr=corr,
                    verify=verify,
                    clips_np=clips_np,
                    corr_clips_np=corr_clips_np,
                    self_max_np=self_max_np,
                    tone_freqs=tone_freqs,
                    verification_params=vparams,
                )
            )

        # ── One program per sliding-window class. The jitted entry is
        # module-level with hashable static metadata, so compiled
        # executables are shared across detector instances (the jit cache
        # key is (shapes, metas, height_min)). ──
        self._metas: dict[int, tuple] = {}
        for sw, cls in self.classes.items():
            self._metas[sw] = tuple(
                (g.kind, g.clip_len, g.k_detect, g.k_verify) for g in cls["groups"]
            )
        # Class geometries + lazy single-row consts for the row-granular
        # full-tier rerun (hit path; see _full_tier_row).
        self._shared_geoms = shared_geoms
        self._row_consts: dict[tuple[int, int, int], tuple] = {}

    # ── Per-chunk execution ──
    #
    # dispatch_chunk enqueues the device programs and returns immediately
    # (JAX async dispatch); collect_chunk blocks on the results. The
    # streaming engine uses the pair to double-buffer host I/O against
    # device compute; process_chunk is the synchronous convenience wrapper.

    def _assemble_section(
        self,
        sw: int,
        chunk: NDArray[np.float32],
        previous_chunk: NDArray[np.float32] | None,
    ) -> tuple[NDArray[np.float32], int, NDArray[np.float32]]:
        """Overlap-save section assembly + zero-pad to the class's static
        section length (reference: audio_pattern_detector.py:400-412).
        Returns (padded_section, n_valid, raw_section). Shared by the
        serial and bank-sharded dispatch paths so upload optimisations
        apply to both."""
        raw_section = self._raw_section(sw, chunk, previous_chunk)
        n_valid = len(raw_section)
        if raw_section.dtype == np.int16:
            # int16 passthrough (file/stdin wrappers streaming raw 16-bit
            # PCM): pad in int16 — _dispatch_section bit-packs the padded
            # buffer into upload lanes with a zero-cost view (no host f32
            # decode, no re-quantise; int16 zeros decode to 0.0f exactly,
            # so padding matches the f32 path bit-for-bit).
            section = np.zeros(
                self.classes[sw]["section_len"], dtype=np.int16
            )
        else:
            section = np.zeros(
                self.classes[sw]["section_len"], dtype=np.float32
            )
        section[:n_valid] = raw_section
        return section, n_valid, raw_section

    def _raw_section(
        self,
        sw: int,
        chunk: NDArray[np.float32],
        previous_chunk: NDArray[np.float32] | None,
    ) -> NDArray[np.float32]:
        """The overlap-save lookback rule in ONE place: prepend the last
        ``sw`` seconds of the previous chunk (reference:
        audio_pattern_detector.py:400-412). Shared by the serial,
        bank-sharded, and batch dispatch paths.

        Rows may arrive as raw int16 (the serving fast path) or f32;
        a mixed pair (e.g. an int16-tail checkpoint resumed against a
        float stream) decodes the int16 side first — int16 + f32 must
        never concatenate raw (numpy would promote the PCM integers as
        if they were sample values)."""
        if previous_chunk is None:
            return chunk
        tail = previous_chunk[int(-sw * self.sample_rate):]
        if tail.dtype != chunk.dtype:
            if tail.dtype == np.int16:
                tail = _pcm16_to_f32(tail)
            if chunk.dtype == np.int16:
                chunk = _pcm16_to_f32(chunk)
        return np.concatenate((tail, chunk))

    def _dispatch_section(
        self,
        sw: int,
        section: NDArray[np.float32],
        n_valid: int,
        group_consts: "tuple | None" = None,
    ) -> Any:
        """Enqueue the fused lean program for one assembled section and
        prefetch its d2h; returns the flat payload handle. ``group_consts``
        overrides the class's own constants (the bank-sharded path passes
        its GSPMD-placed copies — same pytree structure, so the same
        executable logic partitions itself)."""
        cls = self.classes[sw]
        if group_consts is None:
            group_consts = tuple((g.corr, g.verify) for g in cls["groups"])
        if section.dtype == np.int16:
            # Passthrough rows are already on the PCM16 grid: bit-pack
            # with a view (guaranteed exact, no quantise/check pass), or
            # decode when packing is unavailable on this runtime.
            if self._packed_upload and len(section) % 2 == 0:
                packed = section.view(np.float32)
            else:
                packed = None
                section = _pcm16_to_f32(section)
        else:
            packed = try_pack_pcm16(section) if self._packed_upload else None
        if packed is not None:
            flat = _class_step_fused_packed_jit(
                jnp.asarray(packed),
                jnp.float32(n_valid),
                cls["loud"],
                group_consts,
                metas=self._metas[sw],
                height_min=self.height_min,
                blocked=self._blocked,
                merged=self._merged,
            )
        else:
            flat = _class_step_fused_jit(
                jnp.asarray(section),
                jnp.float32(n_valid),
                cls["loud"],
                group_consts,
                metas=self._metas[sw],
                height_min=self.height_min,
                blocked=self._blocked,
                merged=self._merged,
            )
        _host_prefetch(flat)
        return flat

    def dispatch_chunk(
        self,
        chunk: NDArray[np.float32],
        previous_chunk: NDArray[np.float32] | None,
    ) -> list[tuple[int, Any, NDArray[np.float32]]]:
        """Enqueue one stream chunk. Returns opaque per-class records."""
        dispatched = []
        for sw in self.classes:
            section, n_valid, raw_section = self._assemble_section(
                sw, chunk, previous_chunk
            )
            flat = self._dispatch_section(sw, section, n_valid)
            dispatched.append((sw, flat, raw_section))
        return dispatched

    def collect_chunk(
        self,
        dispatched: list[tuple[int, Any, NDArray[np.float32]]],
        padded_rows: "dict[int, tuple[int, ...]] | None" = None,
    ) -> dict[str, list[int]]:
        """Block on a dispatched chunk; returns accepted 'full'-index peak
        positions per clip name (ascending). ``padded_rows`` maps a class's
        sliding window to its per-group payload row counts when they were
        padded (bank-sharded dispatch)."""
        results: dict[str, list[int]] = {}
        for sw, flat, raw_section in dispatched:
            cls = self.classes[sw]
            flat_np = np.asarray(flat)  # ONE device->host transfer per class
            rows = padded_rows.get(sw) if padded_rows else None
            flagged: list[tuple[int, int, bool]] = []
            for gi, (g, packed) in enumerate(
                zip(cls["groups"], _split_fused(flat_np, cls["groups"], rows))
            ):
                pos, sel, host_fb, needs_full = unpack_group(packed, g.k_verify)
                for ci, name in enumerate(g.names):
                    if host_fb[ci] or needs_full[ci]:
                        flagged.append((gi, ci, bool(host_fb[ci])))
                    else:
                        results[name] = [int(p) for p in pos[ci][sel[ci]]]
            if flagged:
                if raw_section.dtype == np.int16:
                    # Passthrough rows stay int16 until a flagged cell
                    # actually needs the exact host/rerun path (rare).
                    raw_section = _pcm16_to_f32(raw_section)
                resolved = self.resolve_flagged_rows(sw, flagged, raw_section)
                for (gi, ci), hits in resolved.items():
                    results[cls["groups"][gi].names[ci]] = hits
        return results

    # Wide-rerun candidate-lane cap. A marker group's comb-sized k_detect
    # (thousands of lanes) prices the rerun's top_k + greedy far above what
    # real hit densities need (~600 candidates for one comb + crosstalk):
    # the capped program keeps the greedy filter on its parallel fixed-point
    # path and the top_k modest. Rows whose count exceeds the cap come back
    # host-flagged and escalate to the full-width program (then host).
    _WIDE_RERUN_CAP = 1024

    def _wide_metas(self, sw: int, capped: bool) -> tuple:
        if not capped:
            return self._metas[sw]
        return tuple(
            (kind, m, min(kd, self._WIDE_RERUN_CAP), kv)
            for kind, m, kd, kv in self._metas[sw]
        )

    def _full_tier_packed(
        self, sw: int, raw_section: NDArray[np.float32], capped: bool = True
    ) -> list[NDArray[np.float32]]:
        """Re-derive one section through the full-width (k_detect-lane)
        WIDE-lean device program — the complete tier behind the lean
        program's needs_full flag (rare: chunks near a pattern hit). Wide
        keeps the lean payload/verify structure, so the rerun costs about
        one extra lean launch, not the rich tier's k_verify-lane verify."""
        cls = self.classes[sw]
        S = cls["section_len"]
        section = np.zeros(S, dtype=np.float32)
        section[: len(raw_section)] = raw_section
        group_consts = tuple((g.corr, g.verify) for g in cls["groups"])
        outs = _class_step_jit(
            jnp.asarray(section),
            jnp.float32(len(raw_section)),
            cls["loud"],
            group_consts,
            metas=self._wide_metas(sw, capped),
            height_min=self.height_min,
            lean=True,
            wide=True,
        )
        return [np.asarray(o["packed"]) for o in outs]

    # Above this many flagged rows in one class, one whole-class rerun
    # launch beats per-row launches (each row launch carries a fixed
    # launch cost; the class program amortises it over G rows).
    _ROW_RERUN_MAX = 4

    def _row_consts_for(self, sw: int, gi: int, ci: int) -> tuple:
        """Single-row (corr, verify) consts for clip ``ci`` of group ``gi``
        — built once from the group's host data with the SAME class-shared
        overlap-save geometry, so the row's correlation is computed by the
        identical FFT decomposition the class program uses."""
        key = (sw, gi, ci)
        if key not in self._row_consts:
            cls = self.classes[sw]
            g = cls["groups"][gi]
            corr_row = build_correlation_bank(
                g.clips_np[ci : ci + 1],
                g.self_max_np[ci : ci + 1],
                cls["section_len"],
                overlap_save=g.corr.num_segments > 1,
                shared_geometry=self._shared_geoms.get(sw),
            )
            if g.kind == "marker":
                verify_row: Any = build_marker_verify_consts(
                    g.clip_len,
                    self.sample_rate,
                    np.array([g.tone_freqs[ci]], dtype=np.float64),
                    [g.verification_params[ci]],
                )
            else:
                verify_row = build_normal_verify_consts(
                    g.corr_clips_np[ci : ci + 1],
                    g.clip_len,
                    self.sample_rate,
                )
            self._row_consts[key] = (corr_row, verify_row)
        return self._row_consts[key]

    def _full_tier_row(
        self,
        sw: int,
        gi: int,
        ci: int,
        raw_section: NDArray[np.float32],
        capped: bool = True,
    ) -> NDArray[np.float32]:
        """Re-derive ONE clip row through the full-width single-tier
        program — the cheap rerun for hit-dense rows (a marker hit's
        candidate comb floods the 16-lane tier on exactly that clip's row;
        re-deriving the whole class costs G× the correlation work).

        Returns the row's packed payload (2·k_verify + 2,). One executable
        per group shape, cached process-wide like every class program."""
        cls = self.classes[sw]
        g = cls["groups"][gi]
        S = cls["section_len"]
        section = np.zeros(S, dtype=np.float32)
        section[: len(raw_section)] = raw_section
        kd = min(g.k_detect, self._WIDE_RERUN_CAP) if capped else g.k_detect
        outs = _class_step_jit(
            jnp.asarray(section),
            jnp.float32(len(raw_section)),
            cls["loud"],
            (self._row_consts_for(sw, gi, ci),),
            metas=((g.kind, g.clip_len, kd, g.k_verify),),
            height_min=self.height_min,
            lean=True,
            wide=True,
        )
        return np.asarray(outs[0]["packed"])[0]

    def resolve_flagged_rows(
        self,
        sw: int,
        flagged: "list[tuple[int, int, bool]]",
        raw_section: NDArray[np.float32],
    ) -> dict[tuple[int, int], list[int]]:
        """Resolve flagged (group, clip) rows of one section exactly.

        ``flagged``: (gi, ci, is_host_flag) triples. Host-flagged rows (1)
        take the exact host path. Device-flagged rows (2) re-derive through
        the row-granular full-tier program when few, or one whole-class
        full-tier launch when many; a rerun that itself overflows falls
        back to the host path. Returns {(gi, ci): accepted positions}."""
        cls = self.classes[sw]
        out: dict[tuple[int, int], list[int]] = {}
        device_rows = [(gi, ci) for gi, ci, host in flagged if not host]
        host_rows = [(gi, ci) for gi, ci, host in flagged if host]

        def rerun_rows(
            rows: "list[tuple[int, int]]",
            capped: bool,
            on_flag: Any,
        ) -> None:
            """One wide-rerun pass: class-wide above _ROW_RERUN_MAX, else
            row-granular. Accepted rows land in ``out``; rows the rerun
            itself host-flags route through ``on_flag``."""
            class_rerun: "list[NDArray[np.float32]] | None" = None
            if len(rows) > self._ROW_RERUN_MAX:
                class_rerun = self._full_tier_packed(
                    sw, raw_section, capped=capped
                )
            for gi, ci in rows:
                g = cls["groups"][gi]
                if class_rerun is not None:
                    rpos, rsel, rhost, _ = unpack_group(
                        class_rerun[gi], g.k_verify
                    )
                    pos_row, sel_row, flag = rpos[ci], rsel[ci], bool(rhost[ci])
                else:
                    packed_row = self._full_tier_row(
                        sw, gi, ci, raw_section, capped=capped
                    )
                    rpos, rsel, rhost, _ = unpack_group(packed_row, g.k_verify)
                    pos_row, sel_row, flag = rpos, rsel, bool(rhost)
                if flag:
                    on_flag(gi, ci)
                else:
                    out[(gi, ci)] = [int(p) for p in pos_row[sel_row]]

        # Capped-width rerun first; a host flag from it means either the
        # count exceeded the cap (escalate to the true k_detect width) or
        # a genuine host condition (resolved after escalation).
        escalate: list[tuple[int, int]] = []

        def route_capped_flag(gi: int, ci: int) -> None:
            if cls["groups"][gi].k_detect > self._WIDE_RERUN_CAP:
                escalate.append((gi, ci))
            else:
                host_rows.append((gi, ci))

        rerun_rows(device_rows, capped=True, on_flag=route_capped_flag)
        if escalate:
            rerun_rows(
                escalate,
                capped=False,
                on_flag=lambda gi, ci: host_rows.append((gi, ci)),
            )

        for gi, ci in host_rows:
            g = cls["groups"][gi]
            out[(gi, ci)] = self._host_fallback(g, ci, raw_section)
        return out

    def process_chunk(
        self,
        chunk: NDArray[np.float32],
        previous_chunk: NDArray[np.float32] | None,
    ) -> dict[str, list[int]]:
        """Synchronous dispatch + collect of one chunk."""
        return self.collect_chunk(self.dispatch_chunk(chunk, previous_chunk))

    # ── Batched offline execution ──
    #
    # Chunk sections only depend on host-known data (chunk i + tail of
    # chunk i-1), so an offline scan can assemble B sections up front and
    # run them as one vmapped launch — amortising launch overhead and
    # filling the chip for small banks.

    def process_chunks_batch(
        self,
        chunks: list[NDArray[np.float32]],
        previous_tail: NDArray[np.float32] | None,
        mode: str = "vmap",
    ) -> list[dict[str, list[int]]]:
        """Process consecutive stream chunks in one batched device launch.

        ``chunks[0]``'s lookback comes from ``previous_tail`` (None for the
        stream head); later chunks take it from their predecessor in the
        list. Returns per-chunk result dicts (same contract as
        process_chunk). All chunks but the last must be full-size.

        ``mode``: "vmap" computes the B chunks in parallel (B× intermediate
        memory — throughput when the chip has headroom); "scan" iterates
        them sequentially inside ONE launch (1× memory, per-launch overhead
        amortised over B — the right mode when launches are expensive,
        e.g. remote runtimes). Identical results.
        """
        return self.collect_chunks_batch(
            self.dispatch_chunks_batch(chunks, previous_tail, mode)
        )

    def _pool_get(
        self, key: tuple, shape: tuple, dtype: Any
    ) -> NDArray[Any]:
        """A recycled (page-warm) staging buffer for ``key``, or a fresh
        allocation (see _payload_pool in __init__ for the soundness
        argument)."""
        lst = self._payload_pool.get(key)
        if lst:
            return lst.pop()
        return np.empty(shape, dtype=dtype)

    def _pool_put(self, key: tuple, buf: NDArray[Any]) -> None:
        lst = self._payload_pool.setdefault(key, [])
        if len(lst) < 4:  # bound: pipeline depth + margin per size class
            lst.append(buf)

    def dispatch_chunks_batch(
        self,
        chunks: list[NDArray[np.float32]],
        previous_tail: NDArray[np.float32] | None,
        mode: str = "vmap",
        prev_tails: "list[NDArray[np.float32] | None] | None" = None,
        sharding: Any = None,
    ) -> "list[tuple[int, Any, list[NDArray[np.float32]], int, tuple | None]]":
        """Enqueue a chunk batch (async); pair with collect_chunks_batch.

        The split lets offline scans double-buffer: dispatch batch i+1
        while batch i's results transfer and unpack, hiding the per-launch
        round trip behind device compute (find_clip_in_array).

        By default the chunks are CONSECUTIVE (chunk i's lookback is
        chunk i−1, with ``previous_tail`` seeding the first). Passing
        ``prev_tails`` (one per chunk, None = no lookback) instead treats
        the rows as INDEPENDENT streams — the multi-stream serving path
        (models/multistream.py) batches one chunk from each of N live
        streams into this one launch.

        ``mode`` is purely an execution schedule — sections (including
        each row's lookback) are assembled on the host either way, and
        the scan body carries no state across rows, so both modes work
        for consecutive chunks AND independent streams with identical
        results. "scan" keeps one chunk's intermediate memory and
        amortises the launch over B; "vmap" is the parallel-axis
        form GSPMD can shard.

        ``sharding`` (a ``NamedSharding`` whose first dim partitions the
        batch axis, e.g. ``P("stream", None)``) places the batch across a
        device mesh: the vmapped program is embarrassingly parallel on B,
        so GSPMD runs each device's rows locally with no collectives —
        data parallelism over streams for the multi-chip serving path.
        Requires ``mode="vmap"`` (a sequential scan cannot be partitioned
        along the batch axis) and B divisible by the partition."""
        if mode not in ("vmap", "scan"):
            raise ValueError(f"mode must be 'vmap' or 'scan', got {mode!r}")
        if sharding is not None and mode != "vmap":
            raise ValueError("sharding requires mode='vmap'")
        if prev_tails is not None and len(prev_tails) != len(chunks):
            raise ValueError(
                f"prev_tails has {len(prev_tails)} entries for "
                f"{len(chunks)} chunks"
            )
        if not chunks:
            # collect_chunks_batch([]) mirrors this with an empty result
            # (and the packed-upload np.stack below needs >= 1 row).
            return []
        b = len(chunks)
        dispatched = []
        _t0 = _time.perf_counter()
        for sw, cls in self.classes.items():
            S = cls["section_len"]
            n_valids = np.zeros(b, dtype=np.int32)
            raws = []
            for bi, chunk in enumerate(chunks):
                if prev_tails is not None:
                    prev = prev_tails[bi]
                else:
                    prev = chunks[bi - 1] if bi > 0 else previous_tail
                raw = self._raw_section(sw, chunk, prev)
                raws.append(raw)
                n_valids[bi] = len(raw)
            _t1 = _time.perf_counter()
            dispatch_phase_seconds["sections"] += _t1 - _t0

            group_consts = tuple((g.corr, g.verify) for g in cls["groups"])
            # Packed upload (half the h2d bytes) when every row is 16-bit
            # PCM-exact. Rows that arrive as raw int16 (the serving fast
            # path) bit-pack with a zero-cost view — no f32 decode, no
            # round-trip check; f32 rows pay the per-chunk exactness
            # check and fall back to the float program when any sample
            # is off the PCM16 grid (ffmpeg floats, resampled streams).
            packed_rows: NDArray[np.float32] | None = None
            sections: NDArray[np.float32] | None = None
            pool_rec: "tuple[tuple, NDArray] | None" = None
            if self._packed_upload and S % 2 == 0:
                # One (b, S) int16 buffer filled row by row: int16 rows
                # (the serving fast path) copy straight in; f32 rows
                # quantise+check in a single C++ pass directly from the
                # raw section (native.pack_pcm16_into — no intermediate
                # f32 (b, S) array, no np.stack). Any off-grid row (or
                # no native library) abandons packing for the whole
                # batch — the f32 fallback below reproduces the exact
                # old path, so results are identical either way.
                rows_i16 = self._pool_get(("i16", b, S), (b, S), np.int16)
                ok_all = True
                for bi, raw in enumerate(raws):
                    if raw.dtype == np.int16 or len(raw) == 0:
                        # int16 rows AND zero-length rows (idle serving
                        # slots — always f32-typed) fill directly; the
                        # empty case must not reach the native packer so
                        # a no-native install keeps the all-int16 batch
                        # on the bit-pack path.
                        rows_i16[bi, : len(raw)] = raw
                        rows_i16[bi, len(raw):] = 0
                    else:
                        ok = native.pack_pcm16_into(raw, rows_i16[bi])
                        if not ok:  # None (no native .so) or lossy row
                            ok_all = False
                            break
                if ok_all:
                    packed_rows = rows_i16.view(np.float32)
                    pool_rec = (("i16", b, S), rows_i16)
                else:
                    # Abandoned pack: the buffer was never dispatched —
                    # recycle it immediately.
                    self._pool_put(("i16", b, S), rows_i16)
            if packed_rows is None:
                # np.empty + per-row tail zeroing: full rows (the steady
                # serving/offline case) skip the zero pass np.zeros
                # would pay every round.
                sections = self._pool_get(("f32", b, S), (b, S), np.float32)
                for bi, raw in enumerate(raws):
                    if raw.dtype == np.int16:
                        raw = _pcm16_to_f32(raw)
                        raws[bi] = raw
                    sections[bi, : len(raw)] = raw
                    if len(raw) < S:
                        sections[bi, len(raw):] = 0.0
                if self._packed_upload:
                    # Per-row packing: each row stays cache-resident
                    # through the round/compare/cast chain.
                    packs = [try_pack_pcm16(sections[bi]) for bi in range(b)]
                    if all(p is not None for p in packs):
                        packed_rows = self._pool_get(
                            ("pk", b, S // 2), (b, S // 2), np.float32
                        )
                        np.stack(packs, out=packed_rows)  # type: ignore[arg-type]
                        pool_rec = (("pk", b, S // 2), packed_rows)
                        # The f32 staging buffer was packed away, not
                        # dispatched — recycle it now.
                        self._pool_put(("f32", b, S), sections)
                        sections = None
            _t2 = _time.perf_counter()
            dispatch_phase_seconds["pack"] += _t2 - _t1
            if packed_rows is not None:
                step_jit = (
                    _class_step_scan_packed_jit
                    if mode == "scan"
                    else _class_step_batch_packed_jit
                )
                payload_np: NDArray[np.float32] = packed_rows
            else:
                step_jit = (
                    _class_step_scan_jit
                    if mode == "scan"
                    else _class_step_batch_jit
                )
                assert sections is not None  # float fallback built above
                payload_np = sections
                pool_rec = (("f32", b, S), sections)
            if self._donate and sharding is None:
                step_jit = _DONATING_JITS[(mode, packed_rows is not None)]
            if sharding is not None:
                # Mesh placement: rows land on their owning devices at
                # upload; the jitted program compiles against the sharded
                # avals (bank consts are uncommitted, so GSPMD replicates
                # them). Rows of one batch axis → same program, keyed by
                # sharding.
                from jax.sharding import NamedSharding, PartitionSpec
                import jax as _jax

                row_sharding = NamedSharding(
                    sharding.mesh, PartitionSpec(sharding.spec[0])
                )
                # Multi-host (DCN) meshes: each process places only its
                # LOCAL rows; the program's global batch is b rows per
                # process (_place / make_array_from_process_local_data).
                global_rows = b * _jax.process_count()
                payload = _place(payload_np, sharding, global_rows)
                n_valid_dev = _place(
                    n_valids.astype(np.float32), row_sharding, global_rows
                )
            else:
                payload = jnp.asarray(payload_np)
                n_valid_dev = jnp.asarray(n_valids.astype(np.float32))
            _t3 = _time.perf_counter()
            dispatch_phase_seconds["upload"] += _t3 - _t2
            flat = step_jit(
                payload,
                n_valid_dev,
                cls["loud"],
                group_consts,
                metas=self._metas[sw],
                height_min=self.height_min,
                blocked=self._blocked,
                merged=self._merged,
            )
            _t4 = _time.perf_counter()
            dispatch_phase_seconds["launch"] += _t4 - _t3
            _host_prefetch(flat)
            dispatched.append((sw, flat, raws, b, pool_rec))
            _t0 = _time.perf_counter()
            dispatch_phase_seconds["prefetch"] += _t0 - _t4
        return dispatched

    def collect_chunks_batch(
        self,
        dispatched: "list[tuple[int, Any, list[NDArray[np.float32]], int, tuple | None]]",
    ) -> list[dict[str, list[int]]]:
        """Block on a dispatched chunk batch; per-chunk result dicts."""
        if not dispatched:
            return []
        b = dispatched[0][3]
        results: list[dict[str, list[int]]] = [dict() for _ in range(b)]
        for sw, flat, raws, _b, pool_rec in dispatched:
            cls = self.classes[sw]
            # (B, total), ONE transfer per class; on a multi-host mesh
            # only this process's addressable rows are read (_host_rows).
            flat_np = _host_rows(flat)
            if pool_rec is not None:
                # The program's results are on the host, so its input
                # upload is long consumed: recycle the staging buffer
                # for a later dispatch (see _payload_pool).
                self._pool_put(*pool_rec)

            flagged_by_bi: dict[int, list[tuple[int, int, bool]]] = {}
            for gi, (g, packed) in enumerate(
                zip(cls["groups"], _split_fused(flat_np, cls["groups"]))
            ):
                pos, sel, host_fb, needs_full = unpack_group(packed, g.k_verify)
                for bi in range(b):
                    for ci, name in enumerate(g.names):
                        if host_fb[bi, ci] or needs_full[bi, ci]:
                            flagged_by_bi.setdefault(bi, []).append(
                                (gi, ci, bool(host_fb[bi, ci]))
                            )
                        else:
                            results[bi][name] = [
                                int(p) for p in pos[bi, ci][sel[bi, ci]]
                            ]
            for bi, flagged in flagged_by_bi.items():
                raw_bi = raws[bi]
                if raw_bi.dtype == np.int16:
                    # Serving fast-path rows stay int16 until a flagged
                    # cell actually needs the exact host path (rare).
                    raw_bi = _pcm16_to_f32(raw_bi)
                resolved = self.resolve_flagged_rows(sw, flagged, raw_bi)
                for (gi, ci), hits in resolved.items():
                    results[bi][cls["groups"][gi].names[ci]] = hits
        return results

    def _host_fallback(
        self, g: ClipGroup, ci: int, raw_section: NDArray[np.float32]
    ) -> list[int]:
        """Exact host path for candidate-capacity overflow (rare)."""
        return hostpath.process_section_host(
            audio_section=raw_section,
            clip=g.clips_np[ci],
            correlation_clip=g.corr_clips_np[ci],
            correlation_clip_absolute_max=float(g.self_max_np[ci]),
            sr=self.sample_rate,
            height_min=self.height_min,
            is_short_clip=g.clip_len / self.sample_rate < 0.5,
            tone_frequency=g.tone_freqs[ci],
            verification_params=g.verification_params[ci],
        )


def _place(
    local: NDArray[np.float32], sharding: Any, global_rows: int
) -> Any:
    """Place a host batch on a row-sharded mesh; multi-host aware.

    Single-process: plain ``device_put``. Multi-process (a mesh spanning
    hosts over DCN): each process passes only its LOCAL batch rows and
    they land on its addressable devices
    (``jax.make_array_from_process_local_data``) — the global array is
    assembled without any cross-host data movement, which is the whole
    point of sharding streams across hosts."""
    if jax.process_count() == 1:
        return jax.device_put(local, sharding)
    global_shape = (global_rows,) + local.shape[1:]
    return jax.make_array_from_process_local_data(sharding, local, global_shape)


def _host_rows(arr: Any) -> NDArray[np.float32]:
    """This process's batch rows of a row-sharded device result.

    Single-process: the whole array. Multi-process: only the addressable
    shards are read (each host unpacks and post-processes its own rows;
    rows owned by other hosts never cross DCN). Non-batch dims may
    themselves be sharded across this host's local devices, so the local
    block is stitched shard by shard; requires process-contiguous row
    placement (validated by the multi-host entry surfaces)."""
    if jax.process_count() == 1:
        return np.asarray(arr)
    shards = arr.addressable_shards

    def _bounds(sl, dim):
        return (sl.start or 0, dim if sl.stop is None else sl.stop)

    row_lo = min(_bounds(s.index[0], arr.shape[0])[0] for s in shards)
    row_hi = max(_bounds(s.index[0], arr.shape[0])[1] for s in shards)
    out = np.empty((row_hi - row_lo,) + arr.shape[1:], dtype=arr.dtype)
    for s in shards:
        lo, hi = _bounds(s.index[0], arr.shape[0])
        out[(slice(lo - row_lo, hi - row_lo),) + tuple(s.index[1:])] = (
            np.asarray(s.data)
        )
    return out


def _host_prefetch(flat) -> None:
    """Enqueue the decision payload's device→host copy at DISPATCH time.

    Without this the d2h is only requested when the collector blocks in
    ``np.asarray``, where it can queue behind an already-dispatched next
    program. Pre-enqueueing it right after the program lets the
    transfer ride the gap instead."""
    copy_async = getattr(flat, "copy_to_host_async", None)
    if copy_async is not None:
        copy_async()


def _split_fused(
    flat: NDArray[np.float32],
    groups: list[ClipGroup],
    rows: "tuple[int, ...] | None" = None,
) -> list[NDArray[np.float32]]:
    """Split a fused flat payload (..., total) into per-group (..., G, 2K+2)
    views; leading batch axes pass through. ``rows`` gives each group's row
    count in the payload when it differs from its clip count (the
    bank-sharded path pads groups to a shard-divisible size; padded rows
    duplicate clip 0 and are sliced off here)."""
    out = []
    off = 0
    for gi, g in enumerate(groups):
        gn = len(g.names)
        gr = rows[gi] if rows is not None else gn
        w = 2 * g.k_verify + 2
        blk = flat[..., off : off + gr * w].reshape(*flat.shape[:-1], gr, w)
        out.append(blk[..., :gn, :])
        off += gr * w
    return out


def unpack_group(
    packed: NDArray[np.float32], k_verify: int
) -> tuple[
    NDArray[np.int32], NDArray[np.bool_], NDArray[np.bool_], NDArray[np.bool_]
]:
    """Split a group's packed f32 payload (..., 2K+2) into (pos, selected,
    host_fallback, needs_full_tier) host arrays; leading batch axes pass
    through. ``host_fallback`` rows must be re-derived on the exact host
    path; ``needs_full_tier`` rows (lean payloads only) must be re-derived
    by the full-width device program (rich payloads never set it)."""
    pos = packed[..., :k_verify].astype(np.int32)
    sel = packed[..., k_verify : 2 * k_verify] != 0
    flag = packed[..., 2 * k_verify]
    host_fallback = (flag == 1.0) | (packed[..., 2 * k_verify + 1] != 0)
    needs_full = flag == 2.0
    return pos, sel, host_fallback, needs_full


def _lean_group_packed(
    norm: jnp.ndarray,
    corr: jnp.ndarray,  # (G, L) normalised correlation
    valid_len: jnp.ndarray,  # int32
    kind: str,
    m: int,
    k_detect: int,
    k_verify: int,
    height_min: float,
    verify_consts,
    wide: bool = False,
    blocked: bool = False,
) -> jnp.ndarray:
    """Production (lean) per-group tail: exact greedy survivors in-program.

    ``corr`` arrives NORMALISED (bank_correlate: divided by the per-row
    max(self_corr_max, observed max), exact zeros past ``valid_len``) for
    BOTH variants — every comparison below (threshold, plateau equality,
    greedy priority) and every verifier slice therefore operates on the
    exact f32 bits the full tier and the host reference operate on. Lean
    results are bitwise full-tier BY CONSTRUCTION; no threshold-boundary
    ulp guard, raw-tail guard, or quotient-collapse guard is needed (the
    raw-space formulation those guarded against is retired).

    The candidate mask costs one fused pass over (G, L); the greedy
    distance filter's survivor set is then computed DIRECTLY — for any raw
    candidate count — by blockwise iterated argmax-suppress
    (ops/peaks.py::greedy_survivors_blockwise), so a real hit's dense
    candidate comb (hundreds of raw candidates, 1-3 survivors) resolves in
    the same single launch as a zero-hit chunk. Everything after — bounds,
    position compaction, verification — runs at the fixed _SMALL_TIER lane
    width. Rows with more than _SMALL_TIER survivors are flagged for the
    host, which REruns the chunk through the full-width wide-lean program
    (`_class_step_jit(lean=True, wide=True)`) — one extra launch on the
    pathological chunk, no data-dependent control flow in the candidate
    stage of the hot program.

    ``wide=True`` is that RERUN variant: capture-based (top_k over the
    full k_detect lane width + lane-greedy, exact for every row with raw
    count ≤ k_detect; count overflow → exact host fallback) and two-tier
    verification so the rerun's cost stays near one lean launch instead
    of the rich tier's k_verify-lane-wide verify.

    Flag column semantics (index 2·k_verify): 0 = row exact as returned;
    1 = exact HOST fallback required (a ≥4-long plateau at/above the
    height threshold where the fused mask could differ from scipy
    semantics; on the wide variant also raw count > k_detect); 2 =
    full-tier device rerun required (> _SMALL_TIER greedy survivors).

    Exactness: greedy_survivors_blockwise IS the sequential tallest-first
    filter (ties to lower index), so the survivor set matches the
    capture-based full tier bitwise whenever neither flags; survivors ≤
    _SMALL_TIER ≤ the k_verify bound, so the padded payload is bitwise
    what the full tier would produce.
    """
    L = corr.shape[1]
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    with jax.named_scope("candidate_scan"):
        x = jnp.where(idx < valid_len, corr, -jnp.inf)
        plateau = long_plateau_present(x, height_min)

    if not wide and blocked:
        # Block-summary variant: the (G, L) mask/scored arrays have no
        # gather consumer — only their per-block maxima leave the fused
        # mask pass; each greedy round re-derives its candidates on a
        # ±2-halo window sliced from ``corr``. Bitwise-identical
        # survivors (ops/peaks.py::greedy_survivors_rederive), fewer
        # materialised (G, L) buffers.
        from audio_pattern_detector_tpu.ops.peaks import (
            greedy_survivors_rederive,
        )

        k_lanes = min(_SMALL_TIER, k_detect)
        pos, height, overflow = greedy_survivors_rederive(
            corr, valid_len, height_min, m, k_lanes
        )
        host_fallback = plateau
        needs_full = ~host_fallback & overflow
        flag = jnp.where(host_fallback, 1.0, jnp.where(needs_full, 2.0, 0.0))
        return _lean_tail(
            norm, corr, valid_len, kind, m, k_verify, verify_consts,
            pos, height, host_fallback, flag, k_lanes,
            pre_filtered=True,
        )

    if wide:
        mask = short_run_local_maxima_mask(x) & (x >= height_min)
        scored = jnp.where(mask, x, -jnp.inf)
        counts = jnp.sum(mask, axis=1)  # (G,)
        host_fallback = (counts > k_detect) | plateau
        k_lanes = k_detect
        # No in-program escalation remains at the full k_detect width:
        # any row whose raw count exceeds the lanes is already
        # host_fallback above, so the wide tier never emits flag 2.
        flag = jnp.where(host_fallback, 1.0, 0.0)
        height, pos = topk_sparse(scored, k_lanes)
        return _lean_tail(
            norm, corr, valid_len, kind, m, k_verify, verify_consts,
            pos, height, host_fallback, flag, k_lanes,
            wide=True,
        )

    k_lanes = min(_SMALL_TIER, k_detect)
    pos, height, overflow = candidate_scan(x, m, k_lanes, height_min)
    host_fallback = plateau
    needs_full = ~host_fallback & overflow
    flag = jnp.where(host_fallback, 1.0, jnp.where(needs_full, 2.0, 0.0))

    return _lean_tail(
        norm, corr, valid_len, kind, m, k_verify, verify_consts,
        pos, height, host_fallback, flag, k_lanes,
        pre_filtered=True,
    )


def candidate_scan(
    x: jnp.ndarray,  # (G, L) normalised correlation, -inf past valid_len
    m: int,
    k_lanes: int,
    height_min: float,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """The lean tier's candidate stage: the fused local-maximum/threshold
    mask pass over (G, L) and the exact greedy-distance survivors
    (ops/peaks.py::greedy_survivors_blockwise). Returns (pos, height,
    overflow), each row's first ``k_lanes`` survivors. Named
    ``candidate_scan`` in the compiled program so profiles can attribute
    its fusions."""
    with jax.named_scope("candidate_scan"):
        mask = short_run_local_maxima_mask(x) & (x >= height_min)
        scored = jnp.where(mask, x, -jnp.inf)
        return greedy_survivors_blockwise(scored, m, k_lanes)


def _lean_tail(
    norm, corr, valid_len, kind, m, k_verify, verify_consts,
    pos, height, host_fallback, flag, k_lanes,
    wide=False,
    pre_filtered=False,
):
    """Shared lean-tier tail: [greedy filter →] bounds → compact → verify
    → packed payload. ``corr`` is the NORMALISED correlation (exact zeros
    past ``valid_len``) — verifier slices read the same bits in every
    tier. With ``pre_filtered`` the lanes already ARE the greedy
    survivors (greedy_survivors_blockwise, production lean path) and the
    lane-greedy is skipped. ``wide`` (the rerun variant) compacts to the
    full k_verify lanes and verifies two-tier (small lane width unless a
    row's survivors overflow it — rare enough that the lax.cond's
    both-branch cost in batch contexts never applies: the rerun is only
    launched on single sections)."""
    alive = jnp.isfinite(height)
    if pre_filtered:
        keep = alive
    else:
        keep = greedy_distance_filter(
            PeakCandidates(pos, height, alive, host_fallback), m
        )
    # Candidate bound checks (reference: audio_pattern_detector.py:531-546).
    half = (2 * m - 1) // 2
    keep = keep & ~(pos + half > valid_len + 5) & ~(pos - half < -5)
    # Compact survivors, ascending by position.
    kv = min(k_verify, k_lanes)
    score = jnp.where(keep, -pos, -_BIG)
    sv, _ = jax.lax.top_k(score, kv)
    vpos = -sv
    valive = sv > -_BIG
    # Verify-tier overflow → exact host fallback (the same escape the
    # rich tier uses). With production k_verify sizing this never fires
    # on the small tier: the greedy distance filter leaves at most
    # full_len//m + 1 survivors per row (minimum spacing m over a
    # full_len row) and k_verify = min(1024, full_len//m + 4) exceeds
    # that bound — but the guard is computed unconditionally (one (G, K)
    # reduce) so shrunken/custom metas stay exact too. On the WIDE tier
    # k_verify can genuinely cap at 1024 below the survivor bound for
    # very short clips.
    verify_overflow = jnp.sum(keep, axis=1) > kv

    if kind == "marker":
        verify_accept = lambda p, a: verify_marker(norm, p, a, verify_consts)  # noqa: E731
    else:
        verify_accept = lambda p, a: verify_normal(corr, p, a, verify_consts)[0]  # noqa: E731

    if wide and kv > _SMALL_TIER:
        accept = _two_tier_accept(verify_accept, vpos, valive, kv)
    elif not wide and _SKIP_EMPTY_VERIFY:
        # Candidate-free groups skip the verify compute entirely: when no
        # lane is alive, ``sel = valive & accept`` is all-zero whatever
        # ``accept`` holds, and pos/flag/overflow are verify-independent
        # — so substituting zeros is bit-identical by construction. On a
        # marker-watch stream (hits rare), this drops the verify tail
        # from almost every chunk; hit-bearing chunks take the true
        # branch and pay exactly the old cost. A scalar-predicate
        # lax.cond runs only the taken branch; under vmap batching it
        # becomes a select (both run — still exact).
        # APD_SKIP_EMPTY_VERIFY=0 restores the unconditional tail.
        accept = jax.lax.cond(
            jnp.any(valive),
            lambda: verify_accept(vpos, valive),
            lambda: jnp.zeros(valive.shape, dtype=bool),
        )
    else:
        accept = verify_accept(vpos, valive)

    sel = (valive & accept).astype(jnp.float32)
    vposf = vpos.astype(jnp.float32)
    if kv < k_verify:
        pad = ((0, 0), (0, k_verify - kv))
        # Dead-lane padding matches the full tier's compaction output
        # bit-for-bit: position _BIG (from the -_BIG sentinel), sel 0.
        vposf = jnp.pad(vposf, pad, constant_values=float(_BIG))
        sel = jnp.pad(sel, pad)
    return jnp.concatenate(
        [
            vposf,
            sel,
            flag[:, None].astype(jnp.float32),
            verify_overflow[:, None].astype(jnp.float32),
        ],
        axis=1,
    )


def _class_step(
    section: jnp.ndarray,
    n_valid: jnp.ndarray,
    loud: LoudnessConsts,
    group_consts: tuple,
    *,
    metas: tuple,
    height_min: float,
    lean: bool = False,
    wide: bool = False,
    blocked: bool = False,
    merged: bool = False,
) -> list[dict[str, jnp.ndarray]]:
    """The full per-chunk device program for one sliding-window class.

    With ``lean=True`` (the production streaming configuration) each group
    returns only the packed int32 decision payload — (G, 2K+2), a few KB —
    so no other per-candidate tensor is materialised in HBM as a program
    output. The rich variant serves tests/debug introspection.

    ``wide=True`` is the flag-2 rerun program: lean structure and payload
    at the full k_detect candidate width (see _lean_group_packed). It
    exists because the rich tier's k_verify-lane-wide verification makes
    it far more expensive than the lean program (a marker group's comb-
    sized k_detect drives hundreds of verify lanes), while the rerun only
    ever needs the lean payload."""
    # n_valid arrives as f32 (every upload is f32, see
    # ops/_pytree.int_const); convert in-graph.
    n_valid = jnp.asarray(n_valid).astype(jnp.int32)
    lufs = integrated_loudness_device(section, n_valid, loud)
    norm = loudness_normalize_device(section, lufs)

    # One section-segment FFT for the whole class when every group shares
    # the class geometry (out_offset/pad_left set by the shared builder).
    shared_spec = None
    if group_consts and all(
        c.num_segments > 1 and c.pad_left >= 0 and c.step > 0
        for c, _ in group_consts
    ):
        first = group_consts[0][0]
        if all(
            (c.fft_len, c.step, c.pad_left, c.num_segments)
            == (first.fft_len, first.step, first.pad_left, first.num_segments)
            for c, _ in group_consts
        ):
            shared_spec = section_segment_spectra(norm, first)

    # Production lean path: normalised correlation (bank_correlate), so
    # every tier compares, orders, and verifies the SAME f32 bits — lean
    # results are bitwise full-tier by construction. The normalising
    # divide fuses into the irfft consumer chain: raw |corr| is never a
    # second materialised (G, L) tensor on this path. APD_MERGED_IRFFT
    # runs one irfft for all groups of the class (bank_correlate_multi).
    lean_packed = lean and height_min > 0 and not wide
    if shared_spec is not None and merged:
        correlations = bank_correlate_multi(
            n_valid, [c for c, _ in group_consts], shared_spec
        )
    else:
        correlations = [
            bank_correlate(norm, n_valid, c, shared_spec)
            for c, _ in group_consts
        ]

    outs = []
    for (kind, m, k_detect, k_verify), (_, verify_consts), corr_out in zip(
        metas, group_consts, correlations
    ):
        if wide:
            corr, valid_len = corr_out
            outs.append(
                {
                    "packed": _lean_group_packed(
                        norm,
                        corr,
                        valid_len,
                        kind,
                        m,
                        k_detect,
                        k_verify,
                        height_min,
                        verify_consts,
                        wide=True,
                    )
                }
            )
            continue
        if lean_packed:
            # Two-tier detection + verification (see _lean_group_packed).
            # height_min <= 0 needs the general plateau mask, so it stays
            # on the single-tier path below.
            corr, valid_len = corr_out
            outs.append(
                {
                    "packed": _lean_group_packed(
                        norm,
                        corr,
                        valid_len,
                        kind,
                        m,
                        k_detect,
                        k_verify,
                        height_min,
                        verify_consts,
                        blocked=blocked,
                    )
                }
            )
            continue
        corr, valid_len = corr_out

        # Fast strict-mask peak finder; a plateau at/above the height
        # threshold (virtually impossible on real material, where it could
        # differ from scipy's plateau-midpoint semantics) flags the row
        # into the same exact host fallback as candidate overflow.
        cand, plateau_flag = find_peaks_device_fast(
            corr, valid_len, height_min, m, k_detect
        )

        # Candidate bound checks (reference: audio_pattern_detector.py:531-546):
        # slice overshoot beyond ±5 around the correlation ends is skipped.
        half = (2 * m - 1) // 2
        after_bad = cand.pos + half > valid_len + 5
        before_bad = cand.pos - half < -5
        keep = cand.alive & ~after_bad & ~before_bad

        # Compact survivors, ascending by position, into the verify tier.
        score = jnp.where(keep, -cand.pos, -_BIG)
        sv, _ = jax.lax.top_k(score, k_verify)
        vpos = -sv
        valive = sv > -_BIG
        verify_overflow = jnp.sum(keep, axis=1) > k_verify

        if kind == "marker":
            verify_accept = lambda p, a: verify_marker(norm, p, a, verify_consts)  # noqa: E731
        else:
            verify_accept = lambda p, a: verify_normal(corr, p, a, verify_consts)[0]  # noqa: E731

        if lean and k_verify > _SMALL_TIER:
            accept = _two_tier_accept(verify_accept, vpos, valive, k_verify)
            sim = jnp.zeros_like(vpos, dtype=jnp.float32)
            r = jnp.zeros_like(vpos, dtype=jnp.float32)
        elif kind == "marker":
            accept = verify_marker(norm, vpos, valive, verify_consts)
            sim = jnp.zeros_like(vpos, dtype=jnp.float32)
            r = jnp.zeros_like(vpos, dtype=jnp.float32)
        else:
            accept, sim, r = verify_normal(corr, vpos, valive, verify_consts)

        # Pack the decision payload into one int32 tensor so the host pays
        # a single device->host transfer per group:
        # columns [0:K]=pos, [K:2K]=selected, [2K]=detect_ovf, [2K+1]=verify_ovf.
        detect_fallback = cand.overflow | plateau_flag
        # The packed decision payload crosses device->host as float32
        # (positions < 2**24 are exact; int32 transfers are rejected in the
        # backend's degraded state); unpack_group converts on host.
        packed = jnp.concatenate(
            [
                vpos.astype(jnp.float32),
                (valive & accept).astype(jnp.float32),
                detect_fallback[:, None].astype(jnp.float32),
                verify_overflow[:, None].astype(jnp.float32),
            ],
            axis=1,
        )
        if lean:
            outs.append({"packed": packed})
        else:
            outs.append(
                {
                    "packed": packed,
                    "pos": vpos,
                    "alive": valive,
                    "accept": accept,
                    "similarity": sim,
                    "pearson_r": r,
                    "detect_overflow": detect_fallback,
                    "verify_overflow": verify_overflow,
                    "lufs": lufs,
                }
            )
    return outs


# Module-level jit: executables are cached process-wide, keyed on section
# shape + static metas, so repeated detector construction (tests, CLI runs
# in one process) reuses compiled programs.
_class_step_jit = jax.jit(
    _class_step, static_argnames=("metas", "height_min", "lean", "wide", "blocked", "merged")
)


# Fused production step: every group's packed payload flattened into ONE
# f32 vector, so the host pays a single device->host transfer per class
# per chunk.
def _class_step_fused(
    section, n_valid, loud, group_consts, *, metas, height_min,
    blocked=False, merged=False,
):
    outs = _class_step(
        section, n_valid, loud, group_consts,
        metas=metas, height_min=height_min, lean=True,
        blocked=blocked, merged=merged,
    )
    return jnp.concatenate([o["packed"].reshape(-1) for o in outs])


_class_step_fused_jit = jax.jit(
    _class_step_fused, static_argnames=("metas", "height_min", "blocked", "merged")
)


# Packed-payload variant: the section crosses the boundary as int16 pairs
# in (S/2,) f32 lanes (ops/packing.py) and is unpacked in-graph — half the
# per-chunk h2d bytes, bit-exact when the pack succeeded host-side.
def _class_step_fused_packed(
    packed_section, n_valid, loud, group_consts, *, metas, height_min,
    blocked=False, merged=False,
):
    from audio_pattern_detector_tpu.ops.packing import unpack_pcm16

    return _class_step_fused(
        unpack_pcm16(packed_section), n_valid, loud, group_consts,
        metas=metas, height_min=height_min, blocked=blocked,
        merged=merged,
    )


_class_step_fused_packed_jit = jax.jit(
    _class_step_fused_packed, static_argnames=("metas", "height_min", "blocked", "merged")
)


# Batched variant: vmap over (section, n_valid); constants broadcast.
def _class_step_batch(
    sections, n_valids, loud, group_consts, *, metas, height_min,
    blocked=False, merged=False,
):
    import functools

    step = functools.partial(
        _class_step_fused, metas=metas, height_min=height_min,
        blocked=blocked, merged=merged,
    )
    return jax.vmap(step, in_axes=(0, 0, None, None))(
        sections, n_valids, loud, group_consts
    )


_class_step_batch_jit = jax.jit(
    _class_step_batch, static_argnames=("metas", "height_min", "blocked", "merged")
)


# Packed-payload batched variants: every row crosses the boundary as
# int16 pairs (half the h2d bytes — the batch-mode analogue of
# _class_step_fused_packed, same bit-exactness contract).
def _class_step_batch_packed(
    packed_sections, n_valids, loud, group_consts, *, metas, height_min,
    blocked=False, merged=False,
):
    import functools

    step = functools.partial(
        _class_step_fused_packed,
        metas=metas, height_min=height_min, blocked=blocked,
        merged=merged,
    )
    return jax.vmap(step, in_axes=(0, 0, None, None))(
        packed_sections, n_valids, loud, group_consts
    )


_class_step_batch_packed_jit = jax.jit(
    _class_step_batch_packed, static_argnames=("metas", "height_min", "blocked", "merged")
)


# Widest batch the scan variants inline as straight-line code. Below the
# cap the program is fully unrolled (no sequential-construct overhead); above
# it a short outer lax.scan of cap-wide unrolled steps bounds compile time
# and program size for wide servers / large --offline-batch values while
# amortising the per-iteration cost over the cap's rows.
_SCAN_UNROLL_CAP = 32


def _class_step_scan_packed(
    packed_sections, n_valids, loud, group_consts, *, metas, height_min,
    blocked=False, merged=False,
):
    def body(carry, inp):
        packed_section, n_valid = inp
        flat = _class_step_fused_packed(
            packed_section, n_valid, loud, group_consts,
            metas=metas, height_min=height_min,
            blocked=blocked, merged=merged,
        )
        return carry, flat

    # Unrolled for the same reason as _class_step_scan: each row unpacks
    # in-graph right where it is consumed, keeping live memory at one
    # chunk's footprint.
    _, packs = jax.lax.scan(
        body,
        0,
        (packed_sections, n_valids),
        unroll=min(packed_sections.shape[0], _SCAN_UNROLL_CAP),
    )
    return packs


_class_step_scan_packed_jit = jax.jit(
    _class_step_scan_packed, static_argnames=("metas", "height_min", "blocked", "merged")
)


# Scanned variant: one launch processes B chunks SEQUENTIALLY on-device
# (lax.scan over the batch axis). Same results as the vmapped program, but
# intermediate memory stays at one chunk's footprint and per-launch
# overhead amortises over B — the launch-bound offline mode for remote
# runtimes where each execution costs a round trip.
def _class_step_scan(
    sections, n_valids, loud, group_consts, *, metas, height_min,
    blocked=False, merged=False,
):
    def body(carry, inp):
        section, n_valid = inp
        flat = _class_step_fused(
            section, n_valid, loud, group_consts,
            metas=metas, height_min=height_min,
            blocked=blocked, merged=merged,
        )
        return carry, flat

    # Unrolled up to _SCAN_UNROLL_CAP: the chunk steps inline into
    # straight-line code with no per-iteration loop cost — XLA still reuses
    # buffers across the inlined steps, keeping memory near one chunk's
    # footprint. Past the cap the program would grow without bound (a
    # B=128 --offline-batch or untiled wide MultiStreamSession would
    # compile a 128x-unrolled executable: minutes of compile, compiler
    # memory blowup), so wide batches run a short outer scan whose
    # per-iteration cost amortises over the cap's rows.
    _, packs = jax.lax.scan(
        body,
        0,
        (sections, n_valids),
        unroll=min(sections.shape[0], _SCAN_UNROLL_CAP),
    )
    return packs  # (B, total)


_class_step_scan_jit = jax.jit(
    _class_step_scan, static_argnames=("metas", "height_min", "blocked", "merged")
)

# Donating twins of the four batch/scan programs: the payload (arg 0) is
# donated so XLA may alias its HBM buffer for outputs instead of holding
# both live. The
# dispatch path never re-reads the uploaded array, so donation is
# side-effect-free for results; kept as separate executables (donation
# is a compile-time property) selected by PatternBank._donate so A/Bs
# can alternate within one process.
_DONATING_JITS = {
    ("scan", True): jax.jit(
        _class_step_scan_packed,
        static_argnames=("metas", "height_min", "blocked", "merged"),
        donate_argnums=(0,),
    ),
    ("scan", False): jax.jit(
        _class_step_scan,
        static_argnames=("metas", "height_min", "blocked", "merged"),
        donate_argnums=(0,),
    ),
    ("vmap", True): jax.jit(
        _class_step_batch_packed,
        static_argnames=("metas", "height_min", "blocked", "merged"),
        donate_argnums=(0,),
    ),
    ("vmap", False): jax.jit(
        _class_step_batch,
        static_argnames=("metas", "height_min", "blocked", "merged"),
        donate_argnums=(0,),
    ),
}

