"""Differential tests: device (JAX) kernels vs exact host implementations.

The device path is the production hot path; every kernel must agree with
the hostref/hostpath golden model on randomised inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_pattern_detector_tpu.models import hostpath
from audio_pattern_detector_tpu.ops import hostref
from audio_pattern_detector_tpu.ops.correlate import build_correlation_bank, bank_correlate
from audio_pattern_detector_tpu.ops.loudness import (
    build_loudness_consts,
    integrated_loudness_device,
    loudness_normalize_device,
)
from audio_pattern_detector_tpu.ops.peaks import find_peaks_device
from audio_pattern_detector_tpu.ops.verify import (
    build_marker_verify_consts,
    build_normal_verify_consts,
    verify_marker,
    verify_normal,
)

SR = 8000


class TestDeviceLoudness:
    @pytest.mark.parametrize("seed,n_seconds", [(0, 10.0), (1, 6.54), (2, 2.0)])
    def test_matches_host(self, seed, n_seconds):
        S = 12 * SR
        consts = build_loudness_consts(S, SR)
        rng = np.random.default_rng(seed)
        n = int(n_seconds * SR)
        sig = (0.2 * rng.standard_normal(n)).astype(np.float32)
        x = np.zeros(S, np.float32)
        x[:n] = sig
        dev = float(integrated_loudness_device(jnp.asarray(x), jnp.int32(n), consts))
        host = hostref.integrated_loudness(sig, SR)
        assert abs(dev - host) < 1e-4

    def test_short_section(self):
        S = 12 * SR
        consts = build_loudness_consts(S, SR)
        n = 3000  # < 0.5 s -> single-block path
        sig = 0.3 * np.sin(2 * np.pi * 700 * np.arange(n) / SR).astype(np.float32)
        x = np.zeros(S, np.float32)
        x[:n] = sig
        dev = float(integrated_loudness_device(jnp.asarray(x), jnp.int32(n), consts))
        host = hostref.integrated_loudness(sig, SR, block_size=n / SR)
        assert abs(dev - host) < 1e-4

    def test_silence(self):
        S = 12 * SR
        consts = build_loudness_consts(S, SR)
        x = jnp.zeros(S)
        assert float(integrated_loudness_device(x, jnp.int32(S), consts)) == -np.inf

    @pytest.mark.parametrize("n", [6000, 6800, 7600, 9200, 11600, 15600])
    def test_half_grid_block_count_matches_host(self, n):
        """Lengths where (n/sr - 0.4)/0.1 is an exact half-integer: the
        host/reference f64 rounding differs from the exact rational there
        (in a direction that varies with n), so a rational-exact device
        formula mis-counts the gating blocks by one. The device count comes
        from the f64-derived threshold table; a -6 dB tail block (inside
        both gates, so its inclusion shifts the gated mean) makes a
        one-block miscount diverge by ~0.2-0.9 LUFS, far past the FIR/f32
        tolerance."""
        S = 12 * SR
        consts = build_loudness_consts(S, SR)
        rng = np.random.default_rng(n)
        sig = (0.25 * rng.standard_normal(n)).astype(np.float32)
        sig[-2800:] *= 0.5
        x = np.zeros(S, np.float32)
        x[:n] = sig
        dev = float(integrated_loudness_device(jnp.asarray(x), jnp.int32(n), consts))
        host = hostref.integrated_loudness(sig, SR)
        assert abs(dev - host) < 1e-4

    def test_normalize_matches_host(self):
        sig = (0.05 * np.random.default_rng(3).standard_normal(SR)).astype(np.float32)
        lufs = hostref.integrated_loudness(sig, SR)
        host = hostref.loudness_normalize(sig, lufs, -16.0)
        dev = np.asarray(loudness_normalize_device(jnp.asarray(sig), jnp.float32(lufs)))
        host_scrubbed = np.nan_to_num(host, nan=0.0)
        np.testing.assert_allclose(dev, host_scrubbed, atol=2e-6)


class TestDeviceCorrelation:
    def test_matches_host_full_correlation(self):
        rng = np.random.default_rng(7)
        S = 4 * SR
        m = 2000
        n = S - 512
        clips = rng.standard_normal((3, m)).astype(np.float32)
        self_max = np.array(
            [np.abs(hostref.fft_correlate_1d(c, c)).max() for c in clips]
        )
        consts = build_correlation_bank(clips, self_max, S)
        sig = rng.standard_normal(n).astype(np.float32)
        section = np.zeros(S, np.float32)
        section[:n] = sig
        corr, valid_len = bank_correlate(jnp.asarray(section), jnp.int32(n), consts)
        corr = np.asarray(corr)
        assert int(valid_len) == n + m - 1
        for gi in range(3):
            host = np.abs(hostref.fft_correlate_1d(sig, clips[gi]))
            host = host / max(self_max[gi], host.max())
            np.testing.assert_allclose(
                corr[gi, : n + m - 1], host, atol=2e-4
            )
            # Padding region is exactly zero.
            assert np.all(corr[gi, n + m - 1 :] == 0)


class TestTopkSparse:
    """Hierarchical top-k vs lax.top_k on candidate-shaped inputs."""

    @pytest.mark.parametrize("seed,n_cand", [(0, 5), (1, 16), (2, 0), (3, 12)])
    def test_bitwise_identical_when_sparse(self, seed, n_cand):
        from audio_pattern_detector_tpu.ops.peaks import topk_sparse

        rng = np.random.default_rng(seed)
        G, L, k = 3, 49999, 16
        scored = np.full((G, L), -np.inf, np.float32)
        for g in range(G):
            pos = rng.choice(L, size=n_cand, replace=False)
            scored[g, pos] = rng.uniform(0.25, 1.0, size=n_cand).astype(
                np.float32
            )
        h, p = topk_sparse(jnp.asarray(scored), k)
        h_ref, p_ref = jax.lax.top_k(jnp.asarray(scored), k)
        np.testing.assert_array_equal(np.asarray(h), np.asarray(h_ref))
        # Positions of dead (-inf) lanes are arbitrary in both.
        aliveref = np.isfinite(np.asarray(h_ref))
        np.testing.assert_array_equal(
            np.asarray(p)[aliveref], np.asarray(p_ref)[aliveref]
        )

    def test_tie_breaks_to_lower_index(self):
        from audio_pattern_detector_tpu.ops.peaks import topk_sparse

        L, k = 30000, 16
        scored = np.full((1, L), -np.inf, np.float32)
        # Bitwise-equal candidates far apart (different blocks) + distinct.
        scored[0, [100, 7000, 21000]] = np.float32(0.5)
        scored[0, 12345] = np.float32(0.75)
        h, p = topk_sparse(jnp.asarray(scored), k)
        h, p = np.asarray(h)[0], np.asarray(p)[0]
        assert p[0] == 12345
        np.testing.assert_array_equal(p[1:4], [100, 7000, 21000])
        np.testing.assert_array_equal(h[:4], [0.75, 0.5, 0.5, 0.5])

    @pytest.mark.parametrize("seed", range(3))
    def test_dense_overflow_value_set(self, seed):
        """Even past the exactness condition (count > k), the returned
        value multiset equals full top_k's (distinct random values)."""
        from audio_pattern_detector_tpu.ops.peaks import topk_sparse

        rng = np.random.default_rng(100 + seed)
        L, k = 20000, 16
        scored = np.full((1, L), -np.inf, np.float32)
        pos = rng.choice(L, size=500, replace=False)
        scored[0, pos] = rng.uniform(0.1, 1.0, size=500).astype(np.float32)
        h, _ = topk_sparse(jnp.asarray(scored), k)
        h_ref, _ = jax.lax.top_k(jnp.asarray(scored), k)
        np.testing.assert_array_equal(np.asarray(h), np.asarray(h_ref))

    def test_clustered_in_one_block(self):
        from audio_pattern_detector_tpu.ops.peaks import topk_sparse

        L, k = 10000, 16
        scored = np.full((1, L), -np.inf, np.float32)
        # All candidates inside a single 512-block: stage 2 must still
        # surface every one through the block expansion.
        vals = np.linspace(0.3, 0.9, 10).astype(np.float32)
        scored[0, 1024:1034] = vals
        h, p = topk_sparse(jnp.asarray(scored), k)
        h, p = np.asarray(h)[0], np.asarray(p)[0]
        np.testing.assert_array_equal(h[:10], vals[::-1])
        np.testing.assert_array_equal(p[:10], np.arange(1033, 1023, -1))


def _seq_greedy_survivors(scored_row, min_distance, r_max):
    """Reference model: sequential tallest-first greedy (ties to lower
    index), the exact semantics greedy_survivors_blockwise must compute
    (reference: lib.rs:437-485 processes candidates in descending height
    and keeps those not suppressed by an earlier kept peak — identical to
    iterated argmax-suppress)."""
    work = scored_row.copy()
    pos, height = [], []
    while True:
        p = int(np.argmax(work))  # numpy argmax ties -> lowest index
        if not np.isfinite(work[p]):
            break
        pos.append(p)
        height.append(scored_row[p])
        work[max(0, p - (min_distance - 1)) : p + min_distance] = -np.inf
    overflow = len(pos) > r_max
    return pos[:r_max], height[:r_max], overflow


class TestGreedySurvivorsBlockwise:
    """greedy_survivors_blockwise (the lean tier's in-program distance
    filter) vs the sequential reference greedy, for candidate counts far
    past what any capture-based tier holds."""

    def _check(self, scored, m, r_max, block=512):
        from audio_pattern_detector_tpu.ops.peaks import (
            SURVIVOR_POS_SENTINEL,
            greedy_survivors_blockwise,
        )

        results = {
            unroll: tuple(
                map(
                    np.asarray,
                    greedy_survivors_blockwise(
                        jnp.asarray(scored), m, r_max, block=block,
                        unroll=unroll,
                    ),
                )
            )
            for unroll in (False, True)
        }
        # The statically-unrolled rounds must be bitwise the while_loop's.
        for a, b in zip(results[False], results[True]):
            np.testing.assert_array_equal(a, b)
        pos, height, overflow = results[False]
        for g in range(scored.shape[0]):
            epos, eh, eover = _seq_greedy_survivors(scored[g], m, r_max)
            n = len(epos)
            np.testing.assert_array_equal(pos[g, :n], epos, err_msg=f"row {g}")
            np.testing.assert_array_equal(height[g, :n], eh, err_msg=f"row {g}")
            assert (pos[g, n:] == SURVIVOR_POS_SENTINEL).all(), f"row {g}"
            assert np.all(np.isneginf(height[g, n:])), f"row {g}"
            assert bool(overflow[g]) == eover, f"row {g}"

    @pytest.mark.parametrize("seed,n_cand", [(0, 0), (1, 3), (2, 40), (3, 300)])
    def test_random_sparse_rows(self, seed, n_cand):
        rng = np.random.default_rng(seed)
        G, L = 3, 50021
        scored = np.full((G, L), -np.inf, np.float32)
        for g in range(G):
            p = rng.choice(L, size=n_cand, replace=False)
            scored[g, p] = rng.uniform(0.25, 1.0, size=n_cand).astype(np.float32)
        self._check(scored, m=rng.integers(5, 4000), r_max=16)

    def test_dense_hit_comb(self):
        """A hit-shaped comb: hundreds of candidates inside one clip-length
        span, 1 survivor — the case the capture-based tier had to flag."""
        L, m = 40000, 8000
        scored = np.full((1, L), -np.inf, np.float32)
        rng = np.random.default_rng(9)
        center = 17000
        offs = np.unique(rng.integers(-m + 1, m, size=400))
        scored[0, center + offs] = rng.uniform(0.25, 0.89, size=len(offs)).astype(
            np.float32
        )
        scored[0, center] = np.float32(0.9)
        self._check(scored, m=m, r_max=16)

    def test_survivor_overflow_flags(self):
        """More distance-spaced survivors than r_max: exactly the first
        r_max in greedy order are returned and overflow fires."""
        L, m, r_max = 60000, 1000, 8
        scored = np.full((1, L), -np.inf, np.float32)
        p = np.arange(500, L - 500, 1500)
        scored[0, p] = np.linspace(0.9, 0.3, len(p)).astype(np.float32)
        self._check(scored, m=m, r_max=r_max)

    def test_seed_gather_mismatch_degrades_to_overflow(self):
        """A block summary that disagrees with its gather (possible only
        through a caller bug)
        must surface as overflow=True — routing the row to the exact
        rerun — never as a silently wrong survivor, while healthy rows in
        the same batch are unaffected."""
        from audio_pattern_detector_tpu.ops.peaks import (
            SURVIVOR_POS_SENTINEL,
            greedy_survivors_from_blocks,
        )

        block, L, m, r_max = 512, 8192, 600, 8
        nb = L // block
        scored = np.full((2, L), -np.inf, np.float32)
        scored[0, [1000, 2000, 7000]] = [0.5, 0.9, 0.7]  # healthy row
        scored[1, [1500, 5000]] = [0.6, 0.8]
        padded = jnp.asarray(scored)
        bmax0 = np.max(scored.reshape(2, nb, block), axis=2)
        # Corrupt row 1: inflate an empty block's seed above every real
        # candidate (the stale-seed shape of the hazard).
        bmax0[1, 0] = 0.95
        off = jnp.arange(block, dtype=jnp.int32)[None, :]

        def gather(b_idx):
            vals = jax.vmap(
                lambda s, b: jax.lax.dynamic_slice(s, (b * block,), (block,))
            )(padded, b_idx)
            return vals, b_idx[:, None] * block + off

        pos, height, overflow = greedy_survivors_from_blocks(
            jnp.asarray(bmax0), gather, m, r_max, block
        )
        pos, height, overflow = map(np.asarray, (pos, height, overflow))
        # Healthy row: exact survivors, no overflow.
        np.testing.assert_array_equal(pos[0, :3], [2000, 7000, 1000])
        assert not overflow[0]
        # Corrupted row: flagged for rerun; every returned lane is dead
        # (no fabricated survivor position escaped).
        assert overflow[1]
        assert np.all(np.isneginf(height[1]))
        assert np.all(pos[1] == SURVIVOR_POS_SENTINEL)

    def test_cross_block_ties(self):
        """Bitwise-equal heights in different blocks must resolve to the
        lower index, matching the sequential priority rule."""
        L = 10000
        scored = np.full((1, L), -np.inf, np.float32)
        scored[0, [100, 2100, 4100, 6100]] = np.float32(0.5)
        scored[0, [1100, 3100]] = np.float32(0.75)
        self._check(scored, m=300, r_max=16, block=64)

    def test_suppression_spans_block_boundaries(self):
        """Suppression radius crossing block edges: partially-suppressed
        boundary blocks must recompute their masked max correctly."""
        L, block, m = 4096, 64, 100
        scored = np.full((1, L), -np.inf, np.float32)
        # Survivor near a block edge; victims straddle the next edges.
        scored[0, 127] = np.float32(0.9)
        scored[0, 128] = np.float32(0.8)   # suppressed, next block
        scored[0, 64] = np.float32(0.7)    # suppressed, same block
        scored[0, 226] = np.float32(0.6)   # just inside radius
        scored[0, 227] = np.float32(0.55)  # just outside -> survives
        scored[0, 3000] = np.float32(0.5)
        self._check(scored, m=m, r_max=16, block=block)

    def test_rows_exhaust_at_different_rounds(self):
        """Mixed-density rows in one batch: empty, 1-survivor, and
        many-survivor rows resolve correctly despite the shared loop."""
        L, m = 30000, 2000
        scored = np.full((4, L), -np.inf, np.float32)
        scored[1, 15000] = np.float32(0.9)
        p = np.arange(1000, 29000, 2500)
        scored[2, p] = np.linspace(0.8, 0.4, len(p)).astype(np.float32)
        rng = np.random.default_rng(21)
        q = rng.choice(L, size=200, replace=False)
        scored[3, q] = rng.uniform(0.25, 1.0, size=200).astype(np.float32)
        self._check(scored, m=m, r_max=16)


class TestDevicePeaks:
    @pytest.mark.parametrize("seed", range(4))
    def test_matches_host_find_peaks(self, seed):
        rng = np.random.default_rng(seed)
        L = 20000
        n_valid = L - 700
        x = np.zeros((1, L), np.float32)
        sig = np.abs(rng.standard_normal(n_valid)).astype(np.float32)
        # Smooth so peaks are sparse enough to fit the candidate tier.
        sig = np.convolve(sig, np.ones(15) / 15, mode="same").astype(np.float32)
        x[0, :n_valid] = sig
        height, distance = 0.95, 100  # ~1.1k raw candidates: fits k
        cand = find_peaks_device(
            jnp.asarray(x), jnp.int32(n_valid), height, distance, k=2048
        )
        got = np.sort(np.asarray(cand.pos)[0][np.asarray(cand.alive)[0]])
        want, _ = hostref.find_peaks(sig, height=height, distance=distance)
        assert not bool(np.asarray(cand.overflow)[0])
        np.testing.assert_array_equal(got, want)

    def test_plateau_handling(self):
        x = np.zeros((1, 64), np.float32)
        x[0, :12] = [0, 1, 1, 1, 0, 2, 2, 0, 0, 3, 0, 0]
        cand = find_peaks_device(jnp.asarray(x), jnp.int32(12), 0.5, 1, k=8)
        got = np.sort(np.asarray(cand.pos)[0][np.asarray(cand.alive)[0]])
        want, _ = hostref.find_peaks(x[0, :12], height=0.5, distance=1)
        np.testing.assert_array_equal(got, want)

    def test_overflow_flag(self):
        # Alternating signal = maximal number of local maxima.
        L = 1000
        x = np.zeros((1, L), np.float32)
        x[0, :L:2] = 1.0
        cand = find_peaks_device(jnp.asarray(x), jnp.int32(L), 0.5, 1, k=16)
        assert bool(np.asarray(cand.overflow)[0])

    @pytest.mark.parametrize("seed", range(4))
    def test_fast_variant_matches_exact_on_plateau_free(self, seed):
        from audio_pattern_detector_tpu.ops.peaks import find_peaks_device_fast

        rng = np.random.default_rng(seed)
        L = 20000
        n_valid = L - 700
        x = np.zeros((1, L), np.float32)
        sig = np.abs(rng.standard_normal(n_valid)).astype(np.float32)
        sig = np.convolve(sig, np.ones(15) / 15, mode="same").astype(np.float32)
        x[0, :n_valid] = sig
        height, distance = 0.95, 100
        fast, flag = find_peaks_device_fast(
            jnp.asarray(x), jnp.int32(n_valid), height, distance, k=2048
        )
        assert not bool(np.asarray(flag)[0])
        got = np.sort(np.asarray(fast.pos)[0][np.asarray(fast.alive)[0]])
        want, _ = hostref.find_peaks(sig, height=height, distance=distance)
        np.testing.assert_array_equal(got, want)

    def test_fast_variant_short_plateaus_exact(self):
        """Length-2/3 runs (the kind f32 tonal correlation produces) are
        handled exactly by the fused mask — no flag, scipy-identical."""
        from audio_pattern_detector_tpu.ops.peaks import find_peaks_device_fast

        x = np.zeros((1, 64), np.float32)
        x[0, :12] = [0, 1, 1, 1, 0, 2, 2, 0, 0, 3, 0, 0]
        cand, flag = find_peaks_device_fast(
            jnp.asarray(x), jnp.int32(12), 0.5, 1, k=8
        )
        assert not bool(np.asarray(flag)[0])
        got = np.sort(np.asarray(cand.pos)[0][np.asarray(cand.alive)[0]])
        want, _ = hostref.find_peaks(x[0, :12], height=0.5, distance=1)
        np.testing.assert_array_equal(got, want)  # midpoints 2, 5, 9

    def test_fast_variant_edge_runs_excluded(self):
        """Runs touching either array edge are not peaks (scipy rule)."""
        from audio_pattern_detector_tpu.ops.peaks import find_peaks_device_fast

        x = np.zeros((1, 64), np.float32)
        x[0, :10] = [2, 2, 2, 0, 0, 0, 0, 1, 1, 1]  # len-3 runs at both edges
        cand, flag = find_peaks_device_fast(
            jnp.asarray(x), jnp.int32(10), 0.5, 1, k=8
        )
        assert not bool(np.asarray(flag)[0])
        got = np.asarray(cand.pos)[0][np.asarray(cand.alive)[0]]
        want, _ = hostref.find_peaks(x[0, :10], height=0.5, distance=1)
        np.testing.assert_array_equal(np.sort(got), want)
        assert len(got) == 0

    def test_fast_variant_flags_long_plateau(self):
        from audio_pattern_detector_tpu.ops.peaks import find_peaks_device_fast

        x = np.zeros((1, 64), np.float32)
        x[0, :12] = [0, 1, 1, 1, 1, 0, 0, 0, 0, 3, 0, 0]  # length-4 run ≥ h
        _, flag = find_peaks_device_fast(
            jnp.asarray(x), jnp.int32(12), 0.5, 1, k=8
        )
        assert bool(np.asarray(flag)[0])

    def test_fast_variant_ignores_subheight_long_plateau(self):
        from audio_pattern_detector_tpu.ops.peaks import find_peaks_device_fast

        x = np.zeros((1, 64), np.float32)
        x[0, :12] = [0, 0.1, 0.1, 0.1, 0.1, 0, 0, 0, 0, 3, 0, 0]
        cand, flag = find_peaks_device_fast(
            jnp.asarray(x), jnp.int32(12), 0.5, 1, k=8
        )
        assert not bool(np.asarray(flag)[0])
        got = np.asarray(cand.pos)[0][np.asarray(cand.alive)[0]]
        np.testing.assert_array_equal(got, [9])

    def test_fast_variant_ignores_subheight_plateau(self):
        from audio_pattern_detector_tpu.ops.peaks import find_peaks_device_fast

        # Plateau at 0.1 (below height 0.5) must not flag; the strict mask
        # still finds the isolated peak at index 9 exactly.
        x = np.zeros((1, 64), np.float32)
        x[0, :12] = [0, 0.1, 0.1, 0.1, 0, 0.2, 0, 0, 0, 3, 0, 0]
        cand, flag = find_peaks_device_fast(
            jnp.asarray(x), jnp.int32(12), 0.5, 1, k=8
        )
        assert not bool(np.asarray(flag)[0])
        got = np.asarray(cand.pos)[0][np.asarray(cand.alive)[0]]
        want, _ = hostref.find_peaks(x[0, :12], height=0.5, distance=1)
        np.testing.assert_array_equal(np.sort(got), want)

    def test_fast_variant_nonpositive_height_uses_exact_path(self):
        from audio_pattern_detector_tpu.ops.peaks import find_peaks_device_fast

        x = np.zeros((1, 64), np.float32)
        x[0, :12] = [0, 1, 1, 1, 0, 2, 2, 0, 0, 3, 0, 0]
        cand, flag = find_peaks_device_fast(
            jnp.asarray(x), jnp.int32(12), 0.0, 1, k=8
        )
        assert not np.any(np.asarray(flag))
        got = np.sort(np.asarray(cand.pos)[0][np.asarray(cand.alive)[0]])
        want, _ = hostref.find_peaks(x[0, :12], height=0.0, distance=1)
        np.testing.assert_array_equal(got, want)

    def test_greedy_distance_chain(self):
        # A > B > C where A-B and B-C conflict but A-C don't: greedy keeps
        # A and C (B's suppression must not also kill C).
        x = np.zeros((1, 400), np.float32)
        x[0, 100] = 3.0
        x[0, 160] = 2.0
        x[0, 220] = 1.0
        cand = find_peaks_device(jnp.asarray(x), jnp.int32(400), 0.5, 100, k=8)
        got = np.sort(np.asarray(cand.pos)[0][np.asarray(cand.alive)[0]])
        want, _ = hostref.find_peaks(x[0], height=0.5, distance=100)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, [100, 220])


class TestDeviceVerifyNormal:
    def _setup(self, m=1600, seed=0):
        rng = np.random.default_rng(seed)
        clip = rng.standard_normal(m).astype(np.float32)
        cc = np.abs(hostref.fft_correlate_1d(clip, clip))
        self_max = cc.max()
        cc_n = (cc / self_max).astype(np.float32)
        return clip, cc_n, self_max

    @pytest.mark.parametrize("m", [1600, 3000])
    def test_accept_and_reject_match_host(self, m):
        clip, cc_n, self_max = self._setup(m)
        S = 4 * SR
        rng = np.random.default_rng(99)
        n = S - 100
        sig = (0.01 * rng.standard_normal(n)).astype(np.float32)
        sig[5000 : 5000 + m] += clip  # true occurrence
        sig[20000 : 20000 + m] += clip * np.linspace(1, 0, m).astype(np.float32)  # distorted

        norm = hostpath.normalize_section(sig, SR)
        corr_host = np.abs(hostref.fft_correlate_1d(norm, clip))
        corr_host /= max(self_max, corr_host.max())
        peaks, _ = hostref.find_peaks(corr_host, height=0.25, distance=m)

        consts = build_normal_verify_consts(cc_n[None, :], m, SR)
        bank = build_correlation_bank(clip[None, :], np.array([self_max]), S)
        section = np.zeros(S, np.float32)
        section[:n] = norm
        corr_dev, valid_len = bank_correlate(jnp.asarray(section), jnp.int32(n), bank)

        k = max(len(peaks), 1)
        pos = np.full((1, k), 2**30, np.int32)
        alive = np.zeros((1, k), bool)
        pos[0, : len(peaks)] = peaks
        alive[0, : len(peaks)] = True
        accept, sim, r = verify_normal(
            corr_dev, jnp.asarray(pos), jnp.asarray(alive), consts
        )
        accept = np.asarray(accept)[0]

        for i, peak in enumerate(peaks):
            cs = hostpath.slicing_with_zero_padding(corr_host, len(cc_n), int(peak))
            cs = cs / cs.max()
            want, _, _ = hostpath._verify_normal_host(cc_n, cs, is_short_clip=False)
            assert bool(accept[i]) == want, f"peak {peak}: device {accept[i]} host {want}"


class TestDeviceVerifyMarker:
    def test_matches_host_decisions(self):
        freq = 1040.0
        m = round(0.228375 * SR)
        t = np.arange(m) / SR
        tone = np.sin(2 * np.pi * freq * t).astype(np.float32)
        rng = np.random.default_rng(11)
        S = 2 * SR

        cases = []
        # clean isolated beep (accept)
        sec = (0.001 * rng.standard_normal(S)).astype(np.float32)
        sec[4000 : 4000 + m] += 0.7 * tone
        cases.append((sec, 4000, True))
        # sustained tone (reject: dirty flanks)
        sec2 = (0.001 * rng.standard_normal(S)).astype(np.float32)
        tt = np.arange(3 * m) / SR
        sec2[3000 : 3000 + 3 * m] += 0.7 * np.sin(2 * np.pi * freq * tt).astype(np.float32)
        cases.append((sec2, 3000 + m, False))
        # wrong frequency (reject)
        sec3 = (0.001 * rng.standard_normal(S)).astype(np.float32)
        sec3[4000 : 4000 + m] += 0.7 * np.sin(2 * np.pi * freq * 1.3 * t).astype(np.float32)
        cases.append((sec3, 4000, False))

        consts = build_marker_verify_consts(m, SR, np.array([freq]), [{}])
        for sec, start, expected in cases:
            peak = start + m - 1
            host = hostpath._verify_marker_host(sec, peak, m, freq, SR, {})
            assert host == expected
            dev = verify_marker(
                jnp.asarray(sec),
                jnp.asarray([[peak]], dtype=jnp.int32),
                jnp.asarray([[True]]),
                consts,
            )
            assert bool(np.asarray(dev)[0, 0]) == expected

    def test_per_clip_thresholds(self):
        freq = 1040.0
        m = round(0.228375 * SR)
        t = np.arange(m) / SR
        tone = np.sin(2 * np.pi * freq * t).astype(np.float32)
        sec = np.zeros(2 * SR, np.float32)
        sec[4000 : 4000 + m] = 0.7 * tone
        peak = 4000 + m - 1
        # Two clips, same tone; second has an impossible threshold.
        consts = build_marker_verify_consts(
            m, SR, np.array([freq, freq]), [{}, {"minimum_band_purity": 1.01}]
        )
        dev = verify_marker(
            jnp.asarray(sec),
            jnp.asarray([[peak], [peak]], dtype=jnp.int32),
            jnp.asarray([[True], [True]]),
            consts,
        )
        dev = np.asarray(dev)
        assert bool(dev[0, 0]) is True
        assert bool(dev[1, 0]) is False

    @pytest.mark.parametrize("m", [1827, 2000])
    def test_whole_window_spectra_match_host_f64(self, m):
        """marker_spectra's flank/match |rfft| equals the f64 host
        spectra of the same windows to f32 FFT accuracy (relative to each
        candidate's largest magnitude), at candidates inside and near both
        edges."""
        from audio_pattern_detector_tpu.ops.verify import marker_spectra

        freq = 1040.0
        rng = np.random.default_rng(5)
        sec = (0.05 * rng.standard_normal(2 * SR)).astype(np.float32)
        sec[5000 : 5000 + m] += 0.7 * np.sin(
            2 * np.pi * freq * np.arange(m) / SR
        ).astype(np.float32)
        pos = np.array([5000 + m - 1, m // 2, 2 * SR - 3], dtype=np.int32)
        consts = build_marker_verify_consts(m, SR, np.array([freq]), [{}])
        spec, _ = marker_spectra(
            jnp.asarray(sec), jnp.asarray(pos[None, :]), consts
        )
        want, _ = hostref.marker_spectra(sec, pos, m, SR)
        got = np.asarray(spec)[0]
        scale = want.max(axis=(-2, -1), keepdims=True)  # per candidate
        assert got.shape == want.shape
        assert float((np.abs(got - want) / scale).max()) <= 1e-4

    @pytest.mark.parametrize("m", [1827, 2000])
    def test_frame_spectra_match_host_f64(self, m):
        """The 25 ms frame spectra of the matched segment, same bound."""
        from audio_pattern_detector_tpu.ops.verify import marker_spectra

        rng = np.random.default_rng(9)
        sec = (0.1 * rng.standard_normal(2 * SR)).astype(np.float32)
        pos = np.array([4000 + m - 1, 9000], dtype=np.int32)
        consts = build_marker_verify_consts(m, SR, np.array([900.0]), [{}])
        _, fspec = marker_spectra(
            jnp.asarray(sec), jnp.asarray(pos[None, :]), consts
        )
        _, want = hostref.marker_spectra(sec, pos, m, SR)
        got = np.asarray(fspec)[0]
        assert got.shape == want.shape
        scale = want.max(axis=(-2, -1), keepdims=True)  # per candidate
        assert float((np.abs(got - want) / scale).max()) <= 1e-4

    def test_short_clip_has_no_frames(self):
        """A clip shorter than one 25 ms frame has no frame spectra on
        either side."""
        from audio_pattern_detector_tpu.ops.verify import marker_spectra

        m = 150  # < 200-sample frame at 8 kHz
        sec = np.zeros(SR, np.float32)
        consts = build_marker_verify_consts(m, SR, np.array([1000.0]), [{}])
        spec, fspec = marker_spectra(
            jnp.asarray(sec), jnp.asarray([[400]], dtype=jnp.int32), consts
        )
        _, want = hostref.marker_spectra(sec, np.array([400]), m, SR)
        assert fspec is None and want is None
        assert np.asarray(spec).shape == (1, 1, 3, m // 2 + 1)


class TestOverlapSaveCorrelation:
    def test_matches_single_fft_and_host(self):
        from audio_pattern_detector_tpu.ops.correlate import (
            build_correlation_bank,
        )
        from audio_pattern_detector_tpu.ops.loudness import (
            build_loudness_consts,
            integrated_loudness_device,
        )

        rng = np.random.default_rng(17)
        S = 9 * SR
        n = S - 777
        m = 1600
        sig = rng.standard_normal(n).astype(np.float32)
        x = np.zeros(S, np.float32)
        x[:n] = sig
        clips = rng.standard_normal((2, m)).astype(np.float32)
        smax = np.array([np.abs(hostref.fft_correlate_1d(c, c)).max() for c in clips])

        big = build_correlation_bank(clips, smax, S, overlap_save=False)
        seg = build_correlation_bank(clips, smax, S, overlap_save=True)
        assert seg.num_segments > 1
        c_big, _ = bank_correlate(jnp.asarray(x), jnp.int32(n), big)
        c_seg, vl = bank_correlate(jnp.asarray(x), jnp.int32(n), seg)
        np.testing.assert_allclose(np.asarray(c_seg), np.asarray(c_big), atol=1e-6)

        host = np.abs(hostref.fft_correlate_1d(sig, clips[0]))
        host = host / max(smax[0], host.max())
        np.testing.assert_allclose(
            np.asarray(c_seg)[0, : n + m - 1], host, atol=2e-4
        )

        # Loudness overlap-save equals the whole-signal convolution.
        lc_big = build_loudness_consts(S, SR, overlap_save=False)
        lc_seg = build_loudness_consts(S, SR, overlap_save=True)
        assert lc_seg.num_segments > 1
        l_big = float(integrated_loudness_device(jnp.asarray(x), jnp.int32(n), lc_big))
        l_seg = float(integrated_loudness_device(jnp.asarray(x), jnp.int32(n), lc_seg))
        assert abs(l_big - l_seg) < 1e-5


class TestSharedClassGeometry:
    """Class-shared overlap-save: one section segment FFT reused by every
    group of a sliding-window class (different clip lengths)."""

    def test_matches_per_group_geometry(self):
        from audio_pattern_detector_tpu.ops.correlate import (
            class_overlap_save_geometry,
            section_segment_spectra,
        )

        rng = np.random.default_rng(23)
        S = 9 * SR
        n = S - 777
        sig = rng.standard_normal(n).astype(np.float32)
        x = np.zeros(S, np.float32)
        x[:n] = sig
        xj = jnp.asarray(x)
        nv = jnp.int32(n)

        ms = [900, 1600, 2400]
        geom = class_overlap_save_geometry(S, ms)
        assert geom is not None
        spec = None
        for m in ms:
            clips = rng.standard_normal((2, m)).astype(np.float32)
            smax = np.array(
                [np.abs(hostref.fft_correlate_1d(c, c)).max() for c in clips]
            )
            shared = build_correlation_bank(clips, smax, S, shared_geometry=geom)
            solo = build_correlation_bank(clips, smax, S)
            # Every group shares one segment decomposition; only the
            # largest clip reads from lag offset 0.
            assert shared.out_offset == max(ms) - m
            if spec is None:
                spec = section_segment_spectra(xj, shared)
            c_shared, _ = bank_correlate(xj, nv, shared, spec)
            c_solo, _ = bank_correlate(xj, nv, solo)
            np.testing.assert_allclose(
                np.asarray(c_shared), np.asarray(c_solo), atol=2e-6
            )

    def test_multi_group_single_irfft_matches_per_group(self):
        from audio_pattern_detector_tpu.ops.correlate import (
            bank_correlate_multi,
            class_overlap_save_geometry,
            section_segment_spectra,
        )

        rng = np.random.default_rng(31)
        S = 9 * SR
        n = S - 123
        sig = rng.standard_normal(n).astype(np.float32)
        x = np.zeros(S, np.float32)
        x[:n] = sig
        xj, nv = jnp.asarray(x), jnp.int32(n)

        ms = [1200, 2600]
        geom = class_overlap_save_geometry(S, ms)
        consts = []
        for m in ms:
            clips = rng.standard_normal((3, m)).astype(np.float32)
            smax = np.array(
                [np.abs(hostref.fft_correlate_1d(c, c)).max() for c in clips]
            )
            consts.append(
                build_correlation_bank(clips, smax, S, shared_geometry=geom)
            )
        spec = section_segment_spectra(xj, consts[0])
        multi = bank_correlate_multi(nv, consts, spec)
        for c, (corr_m, vl_m) in zip(consts, multi):
            corr_s, vl_s = bank_correlate(xj, nv, c, spec)
            assert int(vl_m) == int(vl_s)
            np.testing.assert_array_equal(
                np.asarray(corr_m), np.asarray(corr_s)
            )

    def test_pattern_bank_assigns_shared_geometry(self):
        from audio_pattern_detector_tpu.utils.clip import AudioClip
        from audio_pattern_detector_tpu.models.detector import AudioPatternDetector

        rng = np.random.default_rng(5)
        # Two normal clips of different lengths in the same 1 s class.
        t1 = np.arange(int(0.6 * SR)) / SR
        t2 = np.arange(int(0.9 * SR)) / SR
        clip_a = (0.5 * np.sin(2 * np.pi * 620.0 * t1)).astype(np.float32)
        clip_b = (
            0.5 * np.sin(2 * np.pi * 870.0 * t2) * np.hanning(len(t2))
        ).astype(np.float32)
        det = AudioPatternDetector(
            [
                AudioClip(name="a", audio=clip_a, sample_rate=SR),
                AudioClip(name="b", audio=clip_b, sample_rate=SR),
            ],
            seconds_per_chunk=10,
        )
        bank = det._ensure_bank()
        (cls,) = bank.classes.values()
        geoms = {
            (g.corr.fft_len, g.corr.step, g.corr.num_segments)
            for g in cls["groups"]
        }
        assert len(cls["groups"]) == 2 and len(geoms) == 1
        offsets = sorted(g.corr.out_offset for g in cls["groups"])
        assert offsets[0] == 0 and offsets[1] > 0

        # End-to-end: embedded occurrences of both clips are found by the
        # shared-geometry device program at the exact embed times.
        audio = (0.01 * rng.standard_normal(20 * SR)).astype(np.float32)
        audio[3 * SR : 3 * SR + len(clip_a)] += clip_a
        audio[12 * SR : 12 * SR + len(clip_b)] += clip_b
        import io

        from audio_pattern_detector_tpu.utils.clip import AudioStream

        stream = AudioStream(
            name="synthetic",
            audio_stream=io.BytesIO(audio.tobytes()),
            sample_rate=SR,
        )
        results, total = det.find_clip_in_audio(stream)
        assert results is not None
        assert any(abs(t - 3.0) < 0.05 for t in results["a"]), results
        assert any(abs(t - 12.0) < 0.05 for t in results["b"]), results


class TestMultiRateLoudness:
    @pytest.mark.parametrize("rate", [16000, 44100])
    def test_matches_host_at_rate(self, rate):
        # 44100 exercises non-integer block-hop geometry (hop = 1102.5).
        from audio_pattern_detector_tpu.ops.loudness import (
            build_loudness_consts,
            integrated_loudness_device,
        )

        S = 3 * rate
        consts = build_loudness_consts(S, rate)
        rng = np.random.default_rng(rate)
        n = S - 1234
        sig = (0.2 * rng.standard_normal(n)).astype(np.float32)
        x = np.zeros(S, np.float32)
        x[:n] = sig
        dev = float(integrated_loudness_device(jnp.asarray(x), jnp.int32(n), consts))
        host = hostref.integrated_loudness(sig, rate)
        assert abs(dev - host) < 2e-4
