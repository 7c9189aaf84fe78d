"""Batched Smith-Waterman scoring on device.

The reference extends every candidate with BWA's banded SW on the host
(mem_align1_core / mem_reg2aln — src/bwabridge.c:236-237, 301-311).  Here
*scoring* for all candidates runs on the device as one batched program:
``sw_score_banded``, a row sweep over diagonal-offset lanes (the
pipeline's device scorer), or ``sw_score_batch``, a ``lax.scan`` over
anti-diagonals.  Only filter survivors take the host C++ traceback path
for CIGARs (ema_tpu.native.align_batch), exactly mirroring the
reference's shape: cheap scoring for many, full DP for few.

Both are integer elementwise programs: every scan step is pure
elementwise math on [B, lanes] int32 vectors — the reference window is
shifted through a carried vector instead of gathered, and the best cell
is tracked per lane (elementwise max) with a single reduction after the
scan.  XLA compiles them for whichever device runs them.

Semantics are identical to native align_one (same recurrences, clip
penalty, N handling), so kernel scores and the C++ CIGARs agree; tests
cross-check them on random inputs.

Outputs per pair: clip-adjusted best score, read span (qb, qe), and the
ref-window offset of the alignment end.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG = -(1 << 28)


@functools.partial(jax.jit, static_argnames=("match", "mismatch", "gap_open",
                                             "gap_extend", "clip"))
def sw_score_batch(reads: jax.Array, read_lens: jax.Array,
                   refs: jax.Array, ref_lens: jax.Array,
                   match: int = 1, mismatch: int = 4,
                   gap_open: int = 6, gap_extend: int = 1, clip: int = 5):
    """Score a batch of (read, ref window) pairs.

    reads: int32 [B, m] codes (0-3, >=4 N); refs: int32 [B, n].
    Returns dict(score, qb, qe, ref_end) — each int32 [B].  ``score`` equals
    native.align_one's clip-penalized score; pairs with no positive-scoring
    alignment get score <= 0.
    """
    B, m = reads.shape
    _, n = refs.shape
    reads = reads.astype(jnp.int32)
    refs = refs.astype(jnp.int32)
    goe = gap_open + gap_extend

    # i indexes read rows 0..m (row 0 = virtual start row), diag d = i + j.
    i_idx = jnp.arange(m + 1, dtype=jnp.int32)                   # [m+1]

    def init_vec(fill):
        return jnp.full((B, m + 1), fill, jnp.int32)

    # d = 0: only cell (0, 0): H = 0
    H1 = jnp.where(i_idx[None, :] == 0, 0, NEG) + jnp.zeros((B, 1), jnp.int32)
    H2 = init_vec(NEG)
    V1 = init_vec(NEG)
    D1 = init_vec(NEG)
    S_H1 = init_vec(0)
    S_H2 = init_vec(0)
    S_V1 = init_vec(0)
    S_D1 = init_vec(0)

    # per-row best trackers (reduced once after the scan)
    bestv = init_vec(NEG)      # best clip-adjusted score ending at row i
    bestd = init_vec(0)        # diagonal d of that best
    bests = init_vec(0)        # alignment start read-pos of that best

    read_pad = jnp.pad(reads, ((0, 0), (1, 0)), constant_values=4)  # 1-based
    # ref padded on the right so column d-1 is always in-bounds (code 5
    # never matches)
    ref_pad = jnp.pad(refs, ((0, 0), (0, m + 1)), constant_values=5)
    rdiag0 = init_vec(5)       # rdiag[i] == ref[d-1-i], rolled each step

    valid_i = (i_idx[None, :] >= 1) & (i_idx[None, :] <= read_lens[:, None])
    end_adj = jnp.where(i_idx[None, :] == read_lens[:, None], 0, -clip)
    # fresh start at row i begins the alignment at read pos i-1;
    # clipping i-1 leading bases costs 0 when i == 1 else `clip`
    fresh = jnp.where(i_idx[None, :] == 1, 0, -clip)
    fresh_sh = i_idx[None, :] - 1
    rl = ref_lens[:, None]

    def shift_down(x, fill):
        """x[i] -> x[i-1] (value for index i comes from i-1)."""
        return jnp.concatenate([fill, x[:, :-1]], axis=1)

    negcol = jnp.full((B, 1), NEG, jnp.int32)
    zerocol = jnp.zeros((B, 1), jnp.int32)

    def step(carry, d):
        (H1, H2, V1, D1, S_H1, S_H2, S_V1, S_D1, rdiag,
         bestv, bestd, bests) = carry
        j_idx = d - i_idx[None, :]
        valid = valid_i & (j_idx >= 1) & (j_idx <= rl)

        # roll the ref anti-diagonal: rdiag[i] = ref[d-1-i]
        col = jax.lax.dynamic_slice_in_dim(ref_pad, d - 1, 1, axis=1)
        rdiag = shift_down(rdiag, col)

        H1_up = shift_down(H1, negcol)
        V1_up = shift_down(V1, negcol)
        SH1_up = shift_down(S_H1, zerocol)
        SV1_up = shift_down(S_V1, zerocol)
        v_open = H1_up - goe
        v_ext = V1_up - gap_extend
        V = jnp.maximum(v_open, v_ext)
        S_V = jnp.where(v_open >= v_ext, SH1_up, SV1_up)

        d_open = H1 - goe
        d_ext = D1 - gap_extend
        D = jnp.maximum(d_open, d_ext)
        S_D = jnp.where(d_open >= d_ext, S_H1, S_D1)

        H2_up = shift_down(H2, negcol)
        SH2_up = shift_down(S_H2, zerocol)

        # substitution score at cell (i, j=d-i): read[i-1] vs ref[j-1]
        sub = jnp.where((read_pad >= 4) | (rdiag >= 4), -1,
                        jnp.where(read_pad == rdiag, match, -mismatch))

        diag_base = jnp.maximum(H2_up, fresh)
        diag_s = jnp.where(H2_up >= fresh, SH2_up, fresh_sh)
        Hdiag = diag_base + sub

        H = jnp.maximum(jnp.maximum(Hdiag, D), V)
        S_H = jnp.where(Hdiag >= jnp.maximum(D, V), diag_s,
                        jnp.where(D >= V, S_D, S_V))
        H = jnp.where(valid, H, NEG)
        V = jnp.where(valid, V, NEG)
        D = jnp.where(valid, D, NEG)

        # track best with end-clip adjustment (per row; reduce after scan)
        cand = jnp.where(valid, H + end_adj, NEG)
        improve = cand > bestv
        bestv = jnp.where(improve, cand, bestv)
        bestd = jnp.where(improve, d, bestd)
        bests = jnp.where(improve, S_H, bests)

        return (H, H1, V, D, S_H, S_H1, S_V, S_D, rdiag,
                bestv, bestd, bests), None

    carry = (H1, H2, V1, D1, S_H1, S_H2, S_V1, S_D1, rdiag0,
             bestv, bestd, bests)
    carry, _ = jax.lax.scan(step, carry,
                            jnp.arange(1, m + n + 1, dtype=jnp.int32))
    bestv, bestd, bests = carry[-3:]

    # final reduction: best row; ties at equal score pick the smallest
    # diagonal then the smallest row, matching the ascending-d sweep
    maxv = jnp.max(bestv, axis=1, keepdims=True)
    tie = jnp.where(bestv == maxv, (m + n + 1) - bestd, -1)
    bi = jnp.argmax(tie, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(bestv, bi[:, None], axis=1)[:, 0]
    bd = jnp.take_along_axis(bestd, bi[:, None], axis=1)[:, 0]
    bs = jnp.take_along_axis(bests, bi[:, None], axis=1)[:, 0]

    return {
        "score": best,
        "qb": bs,
        "qe": bi,
        "ref_end": bd - bi,   # 1-based window col of last aligned ref base
    }


@functools.partial(jax.jit, static_argnames=("w_band", "match", "mismatch",
                                             "gap_open", "gap_extend",
                                             "clip"))
def sw_score_banded(reads: jax.Array, read_lens: jax.Array,
                    refs: jax.Array, ref_lens: jax.Array,
                    w_band: int,
                    match: int = 1, mismatch: int = 4,
                    gap_open: int = 6, gap_extend: int = 1, clip: int = 5,
                    wl: jax.Array = None):
    """Banded SW scorer: row sweep over diagonal-offset lanes.

    Same outputs/semantics as sw_score_batch restricted to alignments
    whose window diagonal j - i lies in [0, w_band) — which the chaining
    window construction guarantees for every chained hit (ops/chaining.py
    clamps windows to the chain diagonal range +- pad), mirroring the
    reference's banded extension (BWA w=100; SURVEY §2.3).

    ``wl`` (optional int32 [B]) is the per-candidate LOGICAL corridor:
    diagonals k >= wl[b] are excluded even though the physical lane
    count w_band is padded to its granularity — candidate b's result
    then depends only on its own window, not on which candidates share
    the call, and matches any other kernel given the same wl.

    Complexity: m sequential steps over [B, w_band] lanes (the
    anti-diagonal sweep needs m+n steps over [B, m] lanes).  The
    horizontal affine-gap dependency within a row is resolved with a
    log2(w_band) max-plus prefix scan — exact because a gap chain
    E->H->E is always dominated by one longer gap (gap_open > 0).
    """
    B, m = reads.shape
    _, n = refs.shape
    W = w_band
    # the tie-break key packs the read row index into the low 10 bits
    # (d_key below); reads >= 1024 bp would overflow into the primary key
    # and silently change the documented tie order (min d=2i+k, then min i)
    if m >= 1024:
        raise ValueError(f"banded SW tie-break packing requires read "
                         f"length < 1024 (got m={m})")
    reads = reads.astype(jnp.int32)
    goe = gap_open + gap_extend

    k_idx = jnp.arange(W, dtype=jnp.int32)[None, :]              # [1, W]
    rl = read_lens[:, None].astype(jnp.int32)
    nl = ref_lens[:, None].astype(jnp.int32)
    # per-candidate logical corridor: lanes k >= wl[b] never participate
    # (diagonal limit; makes results independent of the physical W and of
    # which candidates share the call)
    kmask = (jnp.ones((B, W), bool) if wl is None
             else k_idx < wl[:, None].astype(jnp.int32))

    # window cols padded so the per-row slice [i-1, i-1+W) is in-bounds
    ref_pad = jnp.pad(refs.astype(jnp.int32), ((0, 0), (0, m + W)),
                      constant_values=5)
    read_pad = jnp.pad(reads, ((0, 0), (0, 1)), constant_values=4)

    NEGc = jnp.full((B, W), NEG, jnp.int32)
    zero = jnp.zeros((B, W), jnp.int32)

    def shift_left(x, fill):
        """x[k] <- x[k+1] (lane k takes its right neighbor)."""
        return jnp.concatenate(
            [x[:, 1:], jnp.full((B, 1), fill, jnp.int32)], axis=1)

    def shift_right(x, s, fill):
        return jnp.concatenate(
            [jnp.full((B, s), fill, jnp.int32), x[:, :-s]], axis=1)

    ke = k_idx * gap_extend

    def step(carry, i):
        Hp, Fp, SHp, SFp, bestv, besti, bests = carry

        ref_row = jax.lax.dynamic_slice_in_dim(ref_pad, i - 1, W, axis=1)
        read_col = jax.lax.dynamic_slice_in_dim(read_pad, i - 1, 1, axis=1)
        valid = (i <= rl) & (i + k_idx <= nl) & kmask

        sub = jnp.where((read_col >= 4) | (ref_row >= 4), -1,
                        jnp.where(read_col == ref_row, match, -mismatch))
        fresh = jnp.where(i == 1, 0, -clip)
        fresh_s = i - 1

        Hd = jnp.maximum(Hp, fresh) + sub
        Sd = jnp.where(Hp >= fresh, SHp, fresh_s)

        f_open = shift_left(Hp, NEG) - goe
        f_ext = shift_left(Fp, NEG) - gap_extend
        F = jnp.maximum(f_open, f_ext)
        SF = jnp.where(f_open >= f_ext,
                       shift_left(SHp, 0), shift_left(SFp, 0))

        # horizontal gaps: exclusive max-plus prefix scan over the row
        H0 = jnp.maximum(Hd, F)
        S0 = jnp.where(Hd >= F, Sd, SF)
        A = jnp.where(valid, H0 + ke, NEG)
        P = shift_right(A, 1, NEG)
        PS = shift_right(S0, 1, 0)
        s = 1
        while s < W:
            P2 = shift_right(P, s, NEG)
            PS2 = shift_right(PS, s, 0)
            PS = jnp.where(P2 > P, PS2, PS)
            P = jnp.maximum(P, P2)
            s *= 2
        E = P - ke - gap_open
        # merge with the reference tie priority: diag >= horizontal >= vert
        H = jnp.maximum(H0, E)
        SH = jnp.where(Hd >= jnp.maximum(E, F), Sd,
                       jnp.where(E >= F, PS, SF))
        H = jnp.where(valid, H, NEG)
        F = jnp.where(valid, F, NEG)

        end_adj = jnp.where(i == rl, 0, -clip)
        cand = jnp.where(valid, H + end_adj, NEG)
        improve = cand > bestv
        bestv = jnp.where(improve, cand, bestv)
        besti = jnp.where(improve, i, besti)
        bests = jnp.where(improve, SH, bests)

        return (H, F, SH, SF, bestv, besti, bests), None

    carry0 = (NEGc, NEGc, zero, zero, NEGc, zero, zero)
    carry, _ = jax.lax.scan(step, carry0,
                            jnp.arange(1, m + 1, dtype=jnp.int32))
    bestv, besti, bests = carry[-3:]

    # best lane; ties minimize d = i + j = 2i + k, then i — the order the
    # ascending-d anti-diagonal sweep produces
    maxv = jnp.max(bestv, axis=1, keepdims=True)
    d_key = (2 * besti + k_idx) * 1024 + besti
    key = jnp.where(bestv == maxv, d_key, jnp.int32(1 << 30))
    bk = jnp.argmin(key, axis=1).astype(jnp.int32)
    bi = jnp.take_along_axis(besti, bk[:, None], axis=1)[:, 0]
    bs = jnp.take_along_axis(bests, bk[:, None], axis=1)[:, 0]

    return {
        "score": maxv[:, 0],
        "qb": bs,
        "qe": bi,
        "ref_end": bi + bk,
    }
