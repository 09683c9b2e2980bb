"""Device peak finding: vectorised plateau maxima + greedy distance filter.

scipy.signal.find_peaks semantics for the subset the detection engine uses
(height + distance; reference: native-helper/src/lib.rs:380-485,
audio_pattern_detector.py:520-522), reformulated for SIMD hardware:

* local maxima with plateau-midpoint via two associative scans (run-start /
  run-end indices through cummax), no data-dependent loops;
* the inherently sequential greedy tallest-first distance suppression runs
  over a fixed top-K candidate set (one fori_loop of K steps on (G, K)
  vectors, shared across the whole bank); a per-clip overflow flag reports
  when the candidate set exceeded K so the caller can fall back to the
  exact host path (never hit by real program material).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from audio_pattern_detector_tpu.ops.slicing import slice_rows_windows


class PeakCandidates(NamedTuple):
    pos: jnp.ndarray  # (G, K) int32 — 'full' correlation indices
    height: jnp.ndarray  # (G, K) f32
    alive: jnp.ndarray  # (G, K) bool
    overflow: jnp.ndarray  # (G,) bool — more raw candidates than K


def plateau_local_maxima_mask(
    x: jnp.ndarray,  # (G, L) f32, sentinel -inf at/after valid_len
) -> jnp.ndarray:
    """Boolean mask of plateau-midpoint local maxima (scipy semantics).

    A peak is a maximal run of equal values with strictly smaller neighbours
    on both sides; the floor midpoint of the run is flagged.
    """
    G, L = x.shape
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]

    neq_prev = jnp.concatenate(
        [jnp.ones((G, 1), dtype=bool), x[:, 1:] != x[:, :-1]], axis=1
    )
    neq_next = jnp.concatenate(
        [x[:, :-1] != x[:, 1:], jnp.ones((G, 1), dtype=bool)], axis=1
    )
    # Start index of the equal-value run containing i.
    run_start = jax.lax.cummax(jnp.where(neq_prev, idx, 0), axis=1)
    # End index of the run containing i (reverse cummin).
    run_end = jax.lax.cummin(
        jnp.where(neq_next, idx, L - 1), axis=1, reverse=True
    )

    left_ok = run_start > 0
    right_ok = run_end < L - 1
    prev_val = jnp.take_along_axis(
        x, jnp.maximum(run_start - 1, 0), axis=1
    )
    next_val = jnp.take_along_axis(
        x, jnp.minimum(run_end + 1, L - 1), axis=1
    )
    is_mid = idx == (run_start + run_end) // 2
    finite = jnp.isfinite(x)
    # A finite right neighbour is required: the last true sample before the
    # -inf padding sentinel is the array edge, and scipy never reports edges.
    return (
        left_ok
        & right_ok
        & is_mid
        & (prev_val < x)
        & (next_val < x)
        & finite
        & jnp.isfinite(next_val)
    )


def _shift(x: jnp.ndarray, offset: int) -> jnp.ndarray:
    """x[:, i + offset] with -inf beyond both ends (same shape as x)."""
    G, L = x.shape
    if offset == 0:
        return x
    pad = jnp.full((G, abs(offset)), -jnp.inf, dtype=x.dtype)
    if offset > 0:
        return jnp.concatenate([x[:, offset:], pad], axis=1)
    return jnp.concatenate([pad, x[:, :offset]], axis=1)


def plateau_run_mask(
    x: jnp.ndarray,
    xm2: jnp.ndarray,
    xm1: jnp.ndarray,
    xp1: jnp.ndarray,
    xp2: jnp.ndarray,
    fin_p1: jnp.ndarray,
    fin_p2: jnp.ndarray,
    left_ok: jnp.ndarray,
) -> jnp.ndarray:
    """Plateau-midpoint comparisons for runs of length 1–3, given shifted
    neighbours.

    The single source of truth for the exactness-critical comparison
    chain: :func:`short_run_local_maxima_mask` (full rows) and
    :func:`greedy_survivors_rederive`'s gathered windows both call this
    with their own shift/edge plumbing. ``fin_p1``/``fin_p2`` assert the right-side comparison
    partners are real samples (not edge fill); ``left_ok`` excludes
    length-3 runs touching the left array edge.
    """
    # Run of length 1 at i: x[i-1] < x[i] > x[i+1].
    len1 = (xm1 < x) & (xp1 < x) & fin_p1
    # Run of length 2 starting at i (midpoint floor((i+i+1)/2) = i):
    # x[i-1] < x[i] == x[i+1] > x[i+2].
    len2 = (xm1 < x) & (xp1 == x) & (xp2 < x) & fin_p2
    # Run of length 3 centred at i: x[i-2] < x[i-1] == x[i] == x[i+1] > x[i+2].
    len3 = (xm2 < x) & (xm1 == x) & (xp1 == x) & (xp2 < x) & fin_p2 & left_ok
    return len1 | len2 | len3


def short_run_local_maxima_mask(x: jnp.ndarray) -> jnp.ndarray:
    """Local-maxima mask handling plateau runs of length 1–3 exactly.

    Fully fused shifted comparisons — no run-extent scans, no gathers.
    scipy's plateau-midpoint semantics for runs up to length 3 (the floor
    midpoint is flagged; runs touching either array edge excluded); callers
    pair this with :func:`long_plateau_present` and fall back to the exact
    path for runs of length ≥ 4, which real f32 correlation data does not
    produce (length-2/3 runs DO occur: adjacent f32 values at smooth tonal
    correlation peaks round to equal bits).
    """
    idx = jnp.arange(x.shape[1], dtype=jnp.int32)[None, :]
    xm2, xm1 = _shift(x, -2), _shift(x, -1)
    xp1, xp2 = _shift(x, 1), _shift(x, 2)
    runs = plateau_run_mask(
        x, xm2, xm1, xp1, xp2,
        fin_p1=jnp.isfinite(xp1),
        fin_p2=jnp.isfinite(xp2),
        left_ok=idx > 1,
    )
    interior = (idx > 0) & (idx < x.shape[1] - 1)
    return runs & interior & jnp.isfinite(x)


def long_plateau_present(
    x: jnp.ndarray, height_min: "float | jnp.ndarray"
) -> jnp.ndarray:
    """(G,) bool — any equal-value run of length ≥ 4 at/above ``height_min``.

    When False for a row, :func:`short_run_local_maxima_mask` provably
    equals the general plateau-midpoint mask after the height filter:
    sub-height plateaus are removed by the filter in both formulations and
    every run of length ≤ 3 is handled exactly. (Requires
    ``height_min > 0`` so silence/zero runs stay below it.)
    ``height_min`` may be a (G, 1) per-row threshold (the lean path scales
    it by the row's correlation normaliser instead of dividing (G, L)).
    """
    quad = (
        (x[:, :-3] == x[:, 1:-2])
        & (x[:, 1:-2] == x[:, 2:-1])
        & (x[:, 2:-1] == x[:, 3:])
        & (x[:, :-3] >= height_min)
        & jnp.isfinite(x[:, :-3])
    )
    return jnp.any(quad, axis=1)


_TOPK_BLOCK = 512


def topk_sparse(
    scored: jnp.ndarray,  # (G, L) f32, non-candidates = -inf
    k: int,
    block: int = _TOPK_BLOCK,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Hierarchical top-k over a mostly--inf row: (height, pos), both (G, k).

    ``lax.top_k`` over the full (G, L≈500k) correlation reads and sorts
    every lane. This runs in three cheap stages instead:

    1. block-max over (G, nb, block) — one streaming pass that XLA fuses
       with the candidate-mask pass producing ``scored``;
    2. ``top_k`` over the (G, nb≈L/block) block maxima;
    3. slice-gather the k winning blocks (ascending block index) and
       ``top_k`` over the (G, k·block) expansion.

    Exactness: any global top-k element in an unexpanded block would be
    bounded by k distinct expanded block maxima, a contradiction — so the
    returned value multiset equals full ``top_k``'s except when a value tie
    straddles the k-th selection boundary. Gathering blocks in ascending
    index order makes stage-3 ties resolve to the lower global index, so
    whenever a row holds ≤ k finite entries (the condition under which
    every caller uses the result unflagged) the *finite* lanes are bitwise
    identical to ``lax.top_k(scored, k)``.

    Dead lanes (height == -inf) carry UNSPECIFIED positions: they point
    into whichever -inf element the stage-3 expansion happened to select,
    which generally differs from ``lax.top_k``'s choice and may lie in the
    block padding (pos >= L). Callers must gate every use of ``pos`` on
    ``isfinite(height)`` — all current callers do.
    """
    G, L = scored.shape
    nb = -(-L // block)
    if k * block * 4 >= nb * block:
        # Wide tiers (the full/rich path's k_detect ~ L/m lanes) would
        # expand most blocks anyway, so one flat top_k does less work.
        # Hierarchy pays only when the expansion is a small fraction of
        # the row.
        height, pos = jax.lax.top_k(scored, k)
        return height, pos.astype(jnp.int32)
    pad = nb * block - L
    if pad:
        scored = jnp.pad(scored, ((0, 0), (0, pad)), constant_values=-jnp.inf)
    bmax = jnp.max(scored.reshape(G, nb, block), axis=2)
    kb = min(k, nb)
    _, bidx = jax.lax.top_k(bmax, kb)
    border = jnp.sort(bidx, axis=1).astype(jnp.int32)
    gathered = slice_rows_windows(scored, border * block, block)
    height, li = jax.lax.top_k(gathered.reshape(G, kb * block), k)
    pos = jnp.take_along_axis(border, li // block, axis=1) * block + li % block
    return height, pos.astype(jnp.int32)


def select_candidates(
    x: jnp.ndarray,  # (G, L)
    peak_mask: jnp.ndarray,  # (G, L) bool
    k: int,
) -> PeakCandidates:
    """Top-K candidates by height (ties → lower index, matching the
    reference priority order, lib.rs:444-451)."""
    scored = jnp.where(peak_mask, x, -jnp.inf)
    height, pos = topk_sparse(scored, k)
    alive = jnp.isfinite(height)
    overflow = jnp.sum(peak_mask, axis=1) > k
    return PeakCandidates(pos, height, alive, overflow)


# Above this candidate count the O(K^2) conflict matrix of the parallel
# filter outweighs the sequential loop; fall back to the K-step scan.
# APD_SEQ_GREEDY=1 forces the sequential path (backend debugging knob).
# Read at TRACE time: it only takes effect for programs traced after the
# env change — the module-level jitted class programs cache per process,
# so set it before the first dispatch (same as APD_GREEDY_UNROLL /
# APD_MERGED_IRFFT).
import os as _os


def _parallel_greedy_max_k() -> int:
    return 0 if _os.environ.get("APD_SEQ_GREEDY") == "1" else 2048


def _greedy_distance_sequential(
    cand: PeakCandidates, min_distance: int
) -> jnp.ndarray:
    """Sequential greedy (vector ops per step, shared across bank).

    Candidates arrive height-desc sorted, so each row's alive lanes are a
    prefix (dead lanes carry -inf heights and never suppress). The loop
    therefore stops at the bank-wide alive maximum instead of walking all
    K lanes — on wide tiers (K = k_detect, thousands of lanes) the true
    candidate count is usually a small fraction of the lane width."""
    k = cand.pos.shape[1]
    lane = jnp.arange(k, dtype=jnp.int32)[None, :]
    n_alive = jnp.max(jnp.sum(cand.alive.astype(jnp.int32), axis=1))

    def cond(state):
        i, _ = state
        return i < n_alive

    def body(state):
        i, keep = state
        cur_alive = jax.lax.dynamic_index_in_dim(
            keep & cand.alive, i, axis=1
        )  # (G, 1)
        cur_pos = jax.lax.dynamic_index_in_dim(cand.pos, i, axis=1)  # (G, 1)
        d = jnp.abs(cand.pos - cur_pos)  # (G, K)
        suppress = cur_alive & (d < min_distance) & (lane != i)
        return i + 1, keep & ~suppress

    _, keep = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.ones_like(cand.alive))
    )
    return keep & cand.alive


def _greedy_distance_parallel(
    cand: PeakCandidates, min_distance: int
) -> jnp.ndarray:
    """Parallel fixed point of the greedy recurrence.

    The sequential greedy satisfies (and is the unique solution of, by
    induction on priority rank):
        keep(c) = alive(c) and no higher-priority kept candidate conflicts.
    Iterating S' = alive & ~any(conflict_with_higher & S) from S = alive
    converges to that fixed point in O(longest suppression chain) rounds —
    a handful in practice — with each round one (G, K, K) masked any().
    """
    pos = cand.pos
    g, k = pos.shape
    # conflict[g, i, j]: candidate j (higher priority: lower lane index)
    # within min_distance of candidate i.
    d = jnp.abs(pos[:, :, None] - pos[:, None, :])  # (G, K, K)
    higher = (
        jnp.arange(k, dtype=jnp.int32)[None, :] < jnp.arange(k, dtype=jnp.int32)[:, None]
    )  # (K, K), j < i
    conflict = (d < min_distance) & higher[None] & cand.alive[:, None, :]

    def cond(state):
        s, changed = state
        return changed

    def body(state):
        s, _ = state
        suppressed = jnp.any(conflict & s[:, None, :], axis=2)
        s_new = cand.alive & ~suppressed
        return s_new, jnp.any(s_new != s)

    init = cand.alive
    s0_sup = jnp.any(conflict & init[:, None, :], axis=2)
    state = (cand.alive & ~s0_sup, jnp.bool_(True))
    keep, _ = jax.lax.while_loop(cond, body, state)
    return keep & cand.alive


def greedy_distance_filter(
    cand: PeakCandidates, min_distance: int
) -> jnp.ndarray:
    """Greedy tallest-first suppression over height-sorted candidates.

    Candidates arrive sorted by priority (descending height, ties to lower
    index — matching the reference helper, lib.rs:444-451), so lane order
    is priority order. Exactly reproduces scipy.signal.find_peaks'
    sequential distance filter. Returns the surviving-alive mask.
    """
    if cand.pos.shape[1] <= _parallel_greedy_max_k():
        return _greedy_distance_parallel(cand, min_distance)
    return _greedy_distance_sequential(cand, min_distance)


def find_peaks_device(
    corr: jnp.ndarray,  # (G, L) normalised correlation, zeros >= valid_len
    valid_len: jnp.ndarray,  # int32 — true 'full' length
    height_min: float,
    distance: int,
    k: int,
) -> PeakCandidates:
    """find_peaks(height=height_min, distance=distance) over a masked bank.

    Positions at/after valid_len are sentinelled to -inf so runs cannot
    extend into the padding and the final true sample can never register as
    a peak (scipy never reports array edges).
    """
    L = corr.shape[1]
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    x = jnp.where(idx < valid_len, corr, -jnp.inf)
    mask = plateau_local_maxima_mask(x) & (x >= height_min)
    cand = select_candidates(x, mask, k)
    keep = greedy_distance_filter(cand, distance)
    return PeakCandidates(cand.pos, cand.height, keep, cand.overflow)


def find_peaks_device_fast(
    corr: jnp.ndarray,  # (G, L) normalised correlation, zeros >= valid_len
    valid_len: jnp.ndarray,  # int32 — true 'full' length
    height_min: float,
    distance: int,
    k: int,
) -> tuple[PeakCandidates, jnp.ndarray]:
    """Production variant of :func:`find_peaks_device`.

    With ``height_min > 0`` (the engine's domain: default 0.25) the
    plateau run-extent scans + neighbour gathers are replaced by the fused
    short-run mask (exact for plateau runs of length ≤ 3 — the kind f32
    tonal correlation actually produces), and a per-row ``plateau_flag``
    reports the one case where that could differ from scipy semantics — an
    equal-value run of length ≥ 4 at/above the height threshold. Callers
    treat the flag like candidate overflow and reroute the row to the
    exact host path. Returns (candidates, plateau_flag (G,) bool).
    """
    if height_min <= 0:  # static: fast mask needs sub-height zero runs
        cand = find_peaks_device(corr, valid_len, height_min, distance, k)
        return cand, jnp.zeros(corr.shape[0], dtype=bool)
    L = corr.shape[1]
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    x = jnp.where(idx < valid_len, corr, -jnp.inf)
    mask = short_run_local_maxima_mask(x) & (x >= height_min)
    cand = select_candidates(x, mask, k)
    keep = greedy_distance_filter(cand, distance)
    return (
        PeakCandidates(cand.pos, cand.height, keep, cand.overflow),
        long_plateau_present(x, height_min),
    )


SURVIVOR_POS_SENTINEL = 2**30  # dead survivor slots (== models/bank._BIG)


def greedy_survivors_blockwise(
    scored: jnp.ndarray,  # (G, L) candidates at their height, else -inf
    min_distance: int,
    r_max: int,
    block: int = _TOPK_BLOCK,
    unroll: "bool | None" = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Exact greedy-distance survivors for ANY raw candidate count.

    The sequential tallest-first filter (reference: lib.rs:437-485) is
    literally "take the globally tallest unsuppressed candidate, keep it,
    suppress |j - p| < min_distance, repeat". This computes that directly
    over a per-block max summary, so the lean tier no longer needs to
    capture top-k raw candidates at all — a real tone hit's comb of
    hundreds of raw candidates has only 1-3 survivors and resolves
    in-program, where a capture-based tier had to flag it for a rerun
    launch (the round-1 hit-path bottleneck).

    Per round: argmax over the (G, nb) block maxima -> argmax inside the
    winning block -> keep -> fully-suppressed blocks drop to -inf and the
    <= 2 boundary blocks get their masked max recomputed against all kept
    so far. Every argmax resolves ties to the lower index (lower block,
    then lower offset), matching the reference priority (descending
    height, ties to lower index). The while_loop exits when every row is
    exhausted — typical material runs 2-6 rounds, r_max bounds it.

    Returns (pos, height, overflow): pos (G, r_max) int32 in descending
    height order, SURVIVOR_POS_SENTINEL beyond each row's survivor count;
    height (G, r_max) with -inf sentinels; overflow (G,) bool — row has
    more than r_max survivors and must be re-derived at full width.

    Cost: the block-max reduce is one streaming pass that XLA fuses with
    the candidate-mask pass producing ``scored``; each round then touches
    only (G, nb) + three (G, block) gathers. Exact for dense rows.
    """
    G, L = scored.shape
    nb = -(-L // block)
    pad = nb * block - L
    padded = (
        jnp.pad(scored, ((0, 0), (0, pad)), constant_values=-jnp.inf)
        if pad
        else scored
    )
    bmax0 = jnp.max(padded.reshape(G, nb, block), axis=2)  # (G, nb)
    off_in_block = jnp.arange(block, dtype=jnp.int32)[None, :]

    def gather_block(b_idx):  # (G,) -> ((G, block) vals, (G, block) offs)
        vals = jax.vmap(
            lambda s, b: jax.lax.dynamic_slice(s, (b * block,), (block,))
        )(padded, b_idx)
        return vals, b_idx[:, None] * block + off_in_block

    return greedy_survivors_from_blocks(
        bmax0, gather_block, min_distance, r_max, block, unroll=unroll
    )


def greedy_survivors_from_blocks(
    bwork0: jnp.ndarray,  # (G, nb) per-block max of the scored rows
    gather_scored,  # (G,) int32 block ids -> ((G, Wg) vals, (G, Wg) offs)
    min_distance: int,
    r_max: int,
    block: int,
    unroll: "bool | None" = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Core of greedy_survivors_blockwise over an ABSTRACT block summary.

    ``bwork0[g, b]`` must be the max scored (candidate) value in block
    ``b`` — flat positions [b·block, (b+1)·block) — or -inf when the
    block holds no candidate. ``gather_scored(b_idx)`` must return, for
    each row's block ``b_idx[g]``, the scored values and their global
    positions, with positions ascending and every non-(-inf) lane's
    position inside the block's range (halo/padding lanes must come back
    -inf). This lets callers that never materialise the (G, L) scored
    array (greedy_survivors_rederive) run the exact greedy by re-deriving
    candidates on gathered windows per round.

    Same returns and exactness contract as greedy_survivors_blockwise.
    ``unroll`` selects statically-unrolled rounds over the
    ``lax.while_loop`` (identical results; None = the APD_GREEDY_UNROLL
    env knob).
    """
    if unroll is None:
        import os

        unroll = os.environ.get("APD_GREEDY_UNROLL", "0") == "1"
    G, nb = bwork0.shape
    barange = jnp.arange(nb, dtype=jnp.int32)[None, :]
    sentinel = jnp.int32(SURVIVOR_POS_SENTINEL)
    m = min_distance

    def masked_vals(b_idx, kept_pos):
        vals, offs = gather_scored(b_idx)
        supp = jnp.any(
            jnp.abs(offs[:, None, :] - kept_pos[:, :, None]) < m, axis=1
        )  # sentinel kept slots never suppress
        return jnp.where(supp, -jnp.inf, vals), offs

    def round_step(bwork, kept_pos, kept_h, r):
        bi = jnp.argmax(bwork, axis=1).astype(jnp.int32)  # ties: lower block
        bh = jnp.take_along_axis(bwork, bi[:, None], axis=1)[:, 0]

        blkm, offs = masked_vals(bi, kept_pos)
        j = jnp.argmax(blkm, axis=1).astype(jnp.int32)  # ties: lower offset
        p = jnp.take_along_axis(offs, j[:, None], axis=1)[:, 0]
        h = jnp.max(blkm, axis=1)
        # Invariant check: bwork is maintained as exactly the suppressed
        # candidate max per block, so the gathered max must equal the seed
        # bitwise. A mismatch means the caller's block summary disagrees
        # with its gather (a caller bug): refuse the round for
        # that row — it keeps nothing, suppresses nothing, its bwork stays
        # finite, and the loop exits at r_max with overflow=True, routing
        # the row to the exact rerun instead of keeping a wrong survivor.
        alive = (bh > -jnp.inf) & (h == bh)

        kept_pos = kept_pos.at[:, r].set(jnp.where(alive, p, sentinel))
        kept_h = kept_h.at[:, r].set(jnp.where(alive, h, -jnp.inf))

        lo = p - (m - 1)
        hi = p + (m - 1)
        full_in = (barange * block >= lo[:, None]) & (
            (barange + 1) * block - 1 <= hi[:, None]
        )
        bwork = jnp.where(alive[:, None] & full_in, -jnp.inf, bwork)
        for b_edge in (
            jnp.clip(lo // block, 0, nb - 1).astype(jnp.int32),
            jnp.clip(hi // block, 0, nb - 1).astype(jnp.int32),
        ):
            mv, _ = masked_vals(b_edge, kept_pos)
            new_max = jnp.max(mv, axis=1)
            cur = jnp.take_along_axis(bwork, b_edge[:, None], axis=1)[:, 0]
            upd = jnp.where(alive, jnp.minimum(cur, new_max), cur)
            bwork = jnp.where(barange == b_edge[:, None], upd[:, None], bwork)
        return bwork, kept_pos, kept_h

    kept_pos0 = jnp.full((G, r_max), sentinel, dtype=jnp.int32)
    kept_h0 = jnp.full((G, r_max), -jnp.inf, dtype=bwork0.dtype)

    if unroll:
        # Statically-unrolled rounds: identical per-round semantics, no
        # data-dependent loop construct (a lax.while_loop reads its
        # predicate back every iteration and blocks XLA's cross-chunk
        # pipelining inside scan-batched programs). All r_max
        # rounds always execute; exhausted rows pass through as no-ops
        # (alive=False), identical to the while_loop's post-exit state.
        bwork, kept_pos, kept_h = bwork0, kept_pos0, kept_h0
        for r in range(r_max):
            bwork, kept_pos, kept_h = round_step(bwork, kept_pos, kept_h, r)
    else:

        def body(state):
            bwork, kept_pos, kept_h, r = state
            bwork, kept_pos, kept_h = round_step(bwork, kept_pos, kept_h, r)
            return bwork, kept_pos, kept_h, r + 1

        def cond(state):
            bwork, _, _, r = state
            return (r < r_max) & jnp.any(bwork > -jnp.inf)

        bwork, kept_pos, kept_h, _ = jax.lax.while_loop(
            cond, body, (bwork0, kept_pos0, kept_h0, jnp.int32(0))
        )
    overflow = jnp.any(bwork > -jnp.inf, axis=1)
    return kept_pos, kept_h, overflow


def greedy_survivors_rederive(
    corr: jnp.ndarray,  # (G, L) NORMALISED correlation, zeros past valid_len
    valid_len: jnp.ndarray,  # int32
    height_min: "float | jnp.ndarray",
    min_distance: int,
    r_max: int,
    block: int = _TOPK_BLOCK,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """:func:`greedy_survivors_blockwise` without a (G, L) gather source.

    Bitwise-identical results — same candidate mask chain, same greedy
    core — but the scored array's ONLY consumer is the per-block max
    reduce, so XLA is free to fuse the whole where/compare/reshape/reduce
    chain into one streaming pass over ``corr`` instead of materialising
    the shifted copies and bool masks that
    :func:`greedy_survivors_blockwise`'s ``dynamic_slice`` gathers force
    into HBM. Each greedy round RE-DERIVES its candidates on a ±2-halo
    window sliced straight from ``corr`` (already materialised by the
    irfft): the exact :func:`plateau_run_mask` comparison chain on the
    exact values, so gathered maxima equal the block summary bitwise and
    :func:`greedy_survivors_from_blocks`' seed invariant holds by
    construction. Everything here reads the normalised array every tier
    compares.

    Callers must apply the same ``long_plateau_present`` escape they
    would pair with :func:`short_run_local_maxima_mask`: runs of length
    ≥ 4 at/above ``height_min`` are outside the mask's exact domain.
    """
    G, L = corr.shape
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    x = jnp.where(idx < valid_len, corr, -jnp.inf)
    mask = short_run_local_maxima_mask(x) & (x >= height_min)
    scored = jnp.where(mask, x, -jnp.inf)

    nb = -(-L // block)
    pad = nb * block - L
    padded = (
        jnp.pad(scored, ((0, 0), (0, pad)), constant_values=-jnp.inf)
        if pad
        else scored
    )
    bwork0 = jnp.max(padded.reshape(G, nb, block), axis=2)

    W = block + 4
    corr_w = jnp.pad(corr, ((0, 0), (0, W - L))) if L < W else corr
    woffs = jnp.arange(W, dtype=jnp.int32)[None, :]

    def gather_scored(b_idx):  # (G,) -> ((G, W) scored vals, (G, W) pos)
        start = jnp.clip(b_idx * block - 2, 0, max(L - W, 0))
        xw = slice_rows_windows(corr_w, start[:, None], W)[:, 0, :]
        c = start[:, None] + woffs  # global positions, ascending
        xv = jnp.where(c < valid_len, xw, -jnp.inf)
        # Window-local shifts: in-block lanes always see their true ±2
        # neighbourhood (the window carries a 2-sample halo on each side;
        # at the array edges the -inf window fill IS the full-width
        # _shift's pad, so the comparison partners match bitwise).
        neg1 = jnp.full((G, 1), -jnp.inf, xv.dtype)
        neg2 = jnp.full((G, 2), -jnp.inf, xv.dtype)
        xm1 = jnp.concatenate([neg1, xv[:, :-1]], axis=1)
        xm2 = jnp.concatenate([neg2, xv[:, :-2]], axis=1)
        xp1 = jnp.concatenate([xv[:, 1:], neg1], axis=1)
        xp2 = jnp.concatenate([xv[:, 2:], neg2], axis=1)
        runs = plateau_run_mask(
            xv, xm2, xm1, xp1, xp2,
            fin_p1=jnp.isfinite(xp1),
            fin_p2=jnp.isfinite(xp2),
            left_ok=c > 1,
        )
        in_block = (c >= b_idx[:, None] * block) & (
            c < (b_idx[:, None] + 1) * block
        )
        wmask = (
            runs
            & in_block
            & (c > 0)
            & (c < L - 1)
            & jnp.isfinite(xv)
            & (xv >= height_min)
        )
        return jnp.where(wmask, xv, -jnp.inf), c

    return greedy_survivors_from_blocks(
        bwork0, gather_scored, min_distance, r_max, block
    )
