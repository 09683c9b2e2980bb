"""Bank sharding: the clip bank distributed across devices (TP analogue).

The clip bank is the framework's "model": precomputed conjugate spectra
(G, N//2+1), self-correlation curves, and verification constants. When a
bank outgrows one device's memory — or to cut per-chunk latency — the
bank's leading (G) axis shards across a mesh axis.

Correlation against a *replicated* section is embarrassingly parallel in
G: every device correlates the shared section against its clip shard and
verifies its own candidates, with zero cross-device traffic until the
(kilobyte-sized) results concatenate. Implemented with GSPMD: the bank
pytrees are device_put with a NamedSharding on their G axes and the
ordinary class-step jit partitions itself.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from audio_pattern_detector_tpu.models.bank import PatternBank
from audio_pattern_detector_tpu.ops.correlate import CorrelationBankConsts
from audio_pattern_detector_tpu.ops.verify import MarkerVerifyConsts, NormalVerifyConsts


def _shard_leading(mesh: Mesh, axis: str, arr: jnp.ndarray) -> jnp.ndarray:
    spec = P(axis, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def _shard_second(mesh: Mesh, axis: str, arr: jnp.ndarray) -> jnp.ndarray:
    """Shard axis 1 (for (2, G, ...) re/im-stacked spectra)."""
    spec = P(None, axis, *([None] * (arr.ndim - 2)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def _replicate(mesh: Mesh, arr: jnp.ndarray) -> jnp.ndarray:
    return jax.device_put(arr, NamedSharding(mesh, P()))


def shard_group_consts(
    mesh: Mesh,
    axis: str,
    corr: CorrelationBankConsts,
    verify: "NormalVerifyConsts | MarkerVerifyConsts",
) -> tuple[CorrelationBankConsts, Any]:
    """Re-place one group's constants: G-leading arrays sharded over
    ``axis``, shared structure replicated. Shapes are unchanged, so the
    ordinary class-step executable applies (GSPMD inserts the layout)."""
    corr_sharded = replace(
        corr,
        bank_rfft_conj_ri=_shard_second(mesh, axis, corr.bank_rfft_conj_ri),
        self_corr_max=_shard_leading(mesh, axis, corr.self_corr_max),
    )
    if isinstance(verify, NormalVerifyConsts):
        verify_sharded = replace(
            verify,
            corr_clip_partitions=_shard_leading(mesh, axis, verify.corr_clip_partitions),
            ds_clip=_shard_leading(mesh, axis, verify.ds_clip),
        )
    else:
        verify_sharded = replace(
            verify,
            hann_whole=_replicate(mesh, verify.hann_whole),
            freqs_whole=_replicate(mesh, verify.freqs_whole),
            band_whole=_shard_leading(mesh, axis, verify.band_whole),
            dom_freq=_shard_leading(mesh, axis, verify.dom_freq),
            lock_hz=_shard_leading(mesh, axis, verify.lock_hz),
            hann_frame=_replicate(mesh, verify.hann_frame),
            freqs_frame=_replicate(mesh, verify.freqs_frame),
            band_frame=_shard_leading(mesh, axis, verify.band_frame),
            thresholds=_shard_leading(mesh, axis, verify.thresholds),
        )
    return corr_sharded, verify_sharded


def pad_group_consts(
    corr: CorrelationBankConsts,
    verify: "NormalVerifyConsts | MarkerVerifyConsts",
    g_pad: int,
) -> tuple[CorrelationBankConsts, Any]:
    """Pad one group's constants to ``g_pad`` clip rows by repeating row 0.

    Duplicated rows compute exactly what clip 0 computes (same spectra,
    same verifier constants); callers slice results back to the real clip
    count, so padding only makes non-divisible groups shardable — it never
    changes results. Host numpy work, done once at init.
    """

    def pad0(a: Any) -> Any:
        arr = np.asarray(a)
        reps = np.concatenate(
            [arr, np.repeat(arr[:1], g_pad - arr.shape[0], axis=0)]
        )
        return jnp.asarray(reps)

    def pad1(a: Any) -> Any:  # (2, G, F) spectra
        arr = np.asarray(a)
        reps = np.concatenate(
            [arr, np.repeat(arr[:, :1], g_pad - arr.shape[1], axis=1)],
            axis=1,
        )
        return jnp.asarray(reps)

    g = corr.self_corr_max.shape[0]
    if g_pad == g:
        return corr, verify
    if g_pad < g:
        raise ValueError(f"cannot pad group of {g} down to {g_pad}")
    corr_p = replace(
        corr,
        bank_rfft_conj_ri=pad1(corr.bank_rfft_conj_ri),
        self_corr_max=pad0(corr.self_corr_max),
    )
    if isinstance(verify, NormalVerifyConsts):
        verify_p = replace(
            verify,
            corr_clip_partitions=pad0(verify.corr_clip_partitions),
            ds_clip=pad0(verify.ds_clip),
        )
    else:
        verify_p = replace(
            verify,
            band_whole=pad0(verify.band_whole),
            dom_freq=pad0(verify.dom_freq),
            lock_hz=pad0(verify.lock_hz),
            band_frame=pad0(verify.band_frame),
            thresholds=pad0(verify.thresholds),
        )
    return corr_p, verify_p


def group_spec_tree(
    corr: CorrelationBankConsts,
    verify: "NormalVerifyConsts | MarkerVerifyConsts",
    axis: str,
) -> tuple[CorrelationBankConsts, Any]:
    """PartitionSpec pytree matching one group's (corr, verify) consts:
    clip-bank (G) axes partitioned over ``axis``, shared structure
    replicated. For use as shard_map in_specs."""
    corr_spec = replace(
        corr,
        bank_rfft_conj_ri=P(None, axis, None),
        self_corr_max=P(axis),
    )
    if isinstance(verify, NormalVerifyConsts):
        verify_spec = replace(
            verify,
            corr_clip_partitions=P(axis, None, None),
            ds_clip=P(axis, None),
        )
    else:
        verify_spec = replace(
            verify,
            hann_whole=P(None),
            freqs_whole=P(None),
            band_whole=P(axis, None),
            dom_freq=P(axis),
            lock_hz=P(axis),
            hann_frame=P(None),
            freqs_frame=P(None),
            band_frame=P(axis, None),
            thresholds=P(axis, None),
        )
    return corr_spec, verify_spec


class BankShardedBank:
    """A PatternBank whose group constants live sharded across a mesh axis.

    Drop-in for PatternBank's dispatch/collect/process_chunk surface: same
    inputs, same results; the device programs run bank-parallel via GSPMD.
    Groups whose size does not divide the shard count are padded
    automatically with duplicate rows (results sliced back — see
    :func:`pad_group_consts`).
    """

    def __init__(self, bank: PatternBank, mesh: Mesh, axis: str = "bank") -> None:
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}")
        self._bank = bank
        self.mesh = mesh
        self.axis = axis
        n_shards = mesh.shape[axis]
        self._sharded: dict[int, tuple] = {}
        self._padded_rows: dict[int, tuple[int, ...]] = {}
        for sw, cls in bank.classes.items():
            shard_groups = []
            pad_rows = []
            for g in cls["groups"]:
                g_real = len(g.names)
                g_pad = -(-g_real // n_shards) * n_shards
                corr_c, verify_c = pad_group_consts(g.corr, g.verify, g_pad)
                shard_groups.append(
                    shard_group_consts(mesh, axis, corr_c, verify_c)
                )
                pad_rows.append(g_pad)
            self._sharded[sw] = tuple(shard_groups)
            self._padded_rows[sw] = tuple(pad_rows)

    # ── Per-chunk execution (same dispatch/collect pairing as
    # PatternBank: dispatch enqueues asynchronously, collect blocks) ──

    def dispatch_chunk(self, chunk, previous_chunk):
        """Enqueue one chunk over the sharded bank (async); returns the
        same per-class records PatternBank.dispatch_chunk does.

        Rides the serial path's shared helpers (section assembly, packed
        int16-pair upload, fused single-transfer payload, dispatch-time
        d2h prefetch) with the GSPMD-placed constants substituted — the
        jitted program partitions itself across the bank axis."""
        bank = self._bank
        dispatched = []
        for sw in bank.classes:
            section, n_valid, raw_section = bank._assemble_section(
                sw, chunk, previous_chunk
            )
            with self.mesh:
                flat = bank._dispatch_section(
                    sw, section, n_valid,
                    group_consts=self._sharded[sw],
                )
            dispatched.append((sw, flat, raw_section))
        return dispatched

    def collect_chunk(self, dispatched):
        """Block on a dispatched chunk; accepted peak positions per clip.

        Identical record shape to the serial path, so collection —
        including row-granular flag resolution (full-tier device rerun for
        flag-2, exact host path for flag-1) — delegates to
        PatternBank.collect_chunk; the padded-row map slices duplicate
        rows back off the fused payload."""
        return self._bank.collect_chunk(dispatched, padded_rows=self._padded_rows)

    def process_chunk(self, chunk, previous_chunk):
        """Synchronous dispatch + collect of one chunk."""
        return self.collect_chunk(self.dispatch_chunk(chunk, previous_chunk))
