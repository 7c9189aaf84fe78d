"""Batched FM-index operations in JAX (the device seeding engine).

The reference's seeding runs inside BWA (`mem_align1_core`: SMEM seeding,
reference src/bwabridge.c:236-237).  Our batched design does
backward search over the occ-block layout from ``build.py``:

  - ``rank``: one row gather + 2-bit equality popcounts per query — no
    data-dependent control flow, vectorizes over thousands of queries.
  - ``seed_reads``: a ``lax.scan`` over read positions (right to left)
    carrying one (lo, hi) interval per read; when the interval empties, the
    previous interval is emitted as a maximal-suffix seed and the search
    restarts — the batched analog of greedy MEM chopping.
  - ``locate``: batched LF-walk to the nearest sampled SA row.

Everything is int32; arrays live on device and are shared across batches.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("occ_blocks", "counts", "sa_mark_words", "sa_mark_rank",
                 "sa_values", "primary"),
    meta_fields=("sa_rate", "n"))
@dataclasses.dataclass(frozen=True)
class FMIndexArrays:
    """Device-resident FM-index (see build.ReferenceIndex)."""

    occ_blocks: jax.Array     # int32 [n_blocks, 12]
    counts: jax.Array         # int32 [5]
    sa_mark_words: jax.Array  # uint32 bitmap of value-sampled rows
    sa_mark_rank: jax.Array   # int32 prefix counts per bitmap word
    sa_values: jax.Array      # int32 SA values of marked rows
    primary: jax.Array        # int32 scalar
    sa_rate: int              # static
    n: int                    # static: text length

    @classmethod
    def from_index(cls, idx) -> "FMIndexArrays":
        return cls(
            occ_blocks=jnp.asarray(idx.occ_blocks, dtype=jnp.int32),
            counts=jnp.asarray(idx.counts, dtype=jnp.int32),
            sa_mark_words=jnp.asarray(idx.sa_mark_words, dtype=jnp.uint32),
            sa_mark_rank=jnp.asarray(idx.sa_mark_rank, dtype=jnp.int32),
            sa_values=jnp.asarray(idx.sa_values, dtype=jnp.int32),
            primary=jnp.asarray(idx.primary, dtype=jnp.int32),
            sa_rate=int(idx.sa_rate),
            n=int(idx.fm_n),      # both strands: 2x the forward text
        )


def _popcount32(x: jax.Array) -> jax.Array:
    return jax.lax.population_count(x.astype(jnp.uint32)).astype(jnp.int32)


def rank(fm: FMIndexArrays, c: jax.Array, k: jax.Array) -> jax.Array:
    """occ(c, k): occurrences of char c in the first k rows of the full BWT.

    c, k: broadcastable int32 arrays.  Valid for 0 <= k <= n+1.
    """
    c = jnp.asarray(c, jnp.int32)
    k = jnp.asarray(k, jnp.int32)
    # remove the $ row from the count space
    adj = k - (k > fm.primary).astype(jnp.int32)
    blk = adj >> 7
    off = adj & 127

    row = fm.occ_blocks[blk]                       # [..., 12]
    base = jnp.take_along_axis(
        row[..., :4], c[..., None], axis=-1)[..., 0]

    words = row[..., 4:12].astype(jnp.uint32)       # [..., 8]
    pattern = (c.astype(jnp.uint32) * jnp.uint32(0x55555555))[..., None]
    x = words ^ pattern
    eq = (~(x | (x >> 1))) & jnp.uint32(0x55555555)  # 1 bit per matching base

    # mask to bases strictly before `off` within the block
    wi = jnp.arange(8, dtype=jnp.int32)
    nbase = jnp.clip(off[..., None] - 16 * wi, 0, 16)
    # (1 << 2*nbase) - 1 without 32-bit shift overflow:
    full = nbase >= 16
    wordmask = jnp.where(
        full, jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << (2 * nbase).astype(jnp.uint32)) - jnp.uint32(1))
    cnt = _popcount32(eq & wordmask).sum(axis=-1, dtype=jnp.int32)
    return base + cnt


def extend_backward(fm: FMIndexArrays, lo: jax.Array, hi: jax.Array,
                    c: jax.Array) -> tuple[jax.Array, jax.Array]:
    """One backward-search step: prepend char c to the pattern.

    (lo, hi) is the half-open SA-row interval of the current pattern.
    """
    cc = fm.counts[c]
    return cc + rank(fm, c, lo), cc + rank(fm, c, hi)


@functools.partial(jax.jit, static_argnames=("max_seeds", "min_seed_len"))
def seed_reads(fm: FMIndexArrays, reads: jax.Array, lens: jax.Array,
               max_seeds: int = 16, min_seed_len: int = 19):
    """Greedy maximal-suffix seeding over a batch of reads.

    reads: int32/uint8 [B, L] base codes (0-3; >=4 = N, breaks seeds).
    lens: int32 [B].

    Scans right-to-left; at each step tries to extend the current interval
    by the next char; on failure emits the current seed (if long enough) and
    restarts at that char.  Returns per-seed arrays [B, max_seeds]:
      seed_lo, seed_hi (SA-row interval), seed_qb (read offset of seed
      start), seed_len, and per-read seed counts [B].
    """
    B, L = reads.shape
    reads = reads.astype(jnp.int32)
    n_rows = jnp.int32(fm.n + 1)

    def empty_interval():
        return jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32)

    def step(state, t):
        lo, hi, span, n_seeds, s_lo, s_hi, s_qb, s_len = state
        pos = lens - 1 - t                   # per-read position (right-aligned)
        active = pos >= 0
        c = jnp.where(active, reads[jnp.arange(B), jnp.maximum(pos, 0)], 4)
        valid_c = c < 4
        c_safe = jnp.where(valid_c, c, 0)

        has_interval = span > 0
        nlo, nhi = extend_backward(fm, lo, hi, c_safe)
        ext_ok = valid_c & has_interval & (nhi > nlo)

        # fresh interval for restarts
        flo = jnp.where(valid_c, fm.counts[c_safe], 0)
        fhi = jnp.where(valid_c, fm.counts[c_safe + 1], 0)
        fresh_ok = valid_c & (fhi > flo)

        # emit the previous seed when the extension fails while a seed is live
        emit = active & has_interval & ~ext_ok & (span >= min_seed_len)
        slot = jnp.minimum(n_seeds, max_seeds - 1)
        b_idx = jnp.arange(B)

        def scatter(arr, val):
            return arr.at[b_idx, slot].set(
                jnp.where(emit & (n_seeds < max_seeds), val, arr[b_idx, slot]))

        s_lo = scatter(s_lo, lo)
        s_hi = scatter(s_hi, hi)
        s_qb = scatter(s_qb, pos + 1)
        s_len = scatter(s_len, span)
        n_seeds = n_seeds + (emit & (n_seeds < max_seeds)).astype(jnp.int32)

        lo = jnp.where(~active, lo, jnp.where(ext_ok, nlo, jnp.where(fresh_ok, flo, 0)))
        hi = jnp.where(~active, hi, jnp.where(ext_ok, nhi, jnp.where(fresh_ok, fhi, 0)))
        span = jnp.where(~active, span,
                         jnp.where(ext_ok, span + 1,
                                   jnp.where(fresh_ok, 1, 0)))
        return (lo, hi, span, n_seeds, s_lo, s_hi, s_qb, s_len), None

    z = jnp.zeros((B, max_seeds), jnp.int32)
    lo0, hi0 = empty_interval()
    init = (lo0, hi0, jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32),
            z, z, z, z)
    (lo, hi, span, n_seeds, s_lo, s_hi, s_qb, s_len), _ = jax.lax.scan(
        step, init, jnp.arange(L, dtype=jnp.int32))

    # final flush: emit the live seed at the read start
    emit = (span >= min_seed_len) & (n_seeds < max_seeds)
    slot = jnp.minimum(n_seeds, max_seeds - 1)
    b_idx = jnp.arange(B)
    s_lo = s_lo.at[b_idx, slot].set(jnp.where(emit, lo, s_lo[b_idx, slot]))
    s_hi = s_hi.at[b_idx, slot].set(jnp.where(emit, hi, s_hi[b_idx, slot]))
    s_qb = s_qb.at[b_idx, slot].set(jnp.where(emit, 0, s_qb[b_idx, slot]))
    s_len = s_len.at[b_idx, slot].set(jnp.where(emit, span, s_len[b_idx, slot]))
    n_seeds = n_seeds + emit.astype(jnp.int32)

    return s_lo, s_hi, s_qb, s_len, n_seeds


def _is_marked(fm: FMIndexArrays, rows: jax.Array) -> jax.Array:
    w = fm.sa_mark_words[rows >> 5]
    return ((w >> (rows & 31).astype(jnp.uint32)) & jnp.uint32(1)) != 0


def _marked_value(fm: FMIndexArrays, rows: jax.Array) -> jax.Array:
    """SA value of a *marked* row via bitmap rank into sa_values."""
    wi = rows >> 5
    w = fm.sa_mark_words[wi]
    below = w & ((jnp.uint32(1) << (rows & 31).astype(jnp.uint32)) - jnp.uint32(1))
    idx = fm.sa_mark_rank[wi] + jax.lax.population_count(below).astype(jnp.int32)
    return fm.sa_values[idx]


@jax.jit
def locate(fm: FMIndexArrays, rows: jax.Array) -> jax.Array:
    """Batched SA lookup: BWT rows -> text positions via LF-walk.

    rows: int32 [...].  Each LF step decrements the SA value by one, so a
    row whose value is divisible by sa_rate is reached within sa_rate-1
    steps — a fixed-trip-count loop of pure rank queries.
    """
    rows = jnp.asarray(rows, jnp.int32)
    steps = jnp.zeros_like(rows)
    done = _is_marked(fm, rows)
    val = jnp.where(done, _marked_value(fm, rows), 0)

    def body(i, carry):
        rows, steps, done, val = carry
        # BWT char at the current row (marked rows — incl. the $/primary
        # row, whose SA value 0 is always marked — are already done)
        adj = rows - (rows > fm.primary).astype(jnp.int32)
        blk = adj >> 7
        off = adj & 127
        row_words = fm.occ_blocks[blk, 4:12].astype(jnp.uint32)
        w = jnp.take_along_axis(row_words, (off >> 4)[..., None], axis=-1)[..., 0]
        ch = ((w >> (2 * (off & 15)).astype(jnp.uint32)) & jnp.uint32(3)).astype(jnp.int32)
        nrows = fm.counts[ch] + rank(fm, ch, rows)
        nrows = jnp.where(done, rows, nrows)
        nsteps = jnp.where(done, steps, steps + 1)
        fresh = ~done & _is_marked(fm, nrows)
        nval = jnp.where(fresh, _marked_value(fm, nrows) + nsteps, val)
        return nrows, nsteps, done | fresh, nval

    rows, steps, done, val = jax.lax.fori_loop(
        0, fm.sa_rate - 1, body, (rows, steps, done, val))
    return val


@functools.partial(jax.jit, static_argnames=(
    "max_seeds", "min_seed_len", "max_hits", "budget", "max_occ"))
def seed_locate_reads(fm: FMIndexArrays, reads: jax.Array,
                      lens: jax.Array, *, max_seeds: int = 16,
                      min_seed_len: int = 19, max_hits: int = 3000,
                      budget: int = 32768, max_occ: int = 3000):
    """Fused greedy seeding -> hit compaction -> SA locate: ONE dispatch.

    The two-step path (seed_reads readback, host _compact_seed_hits,
    locate upload) crosses the host<->device boundary twice per chunk
    and ships the dense [4, B, S] seed stack back.  Here the
    exact same compaction (prefix-sum + even max_occ sampling, matching
    pipeline._compact_seed_hits value-for-value) runs on device via
    searchsorted over the per-seed hit counts, and locate runs in the
    same program.

    Returns (packed [4, budget] i32 = (owner, qb, seed_len, text_pos),
    total hits i32, frac_rep [B] f32).  Slots >= total are garbage —
    callers slice [:total].  When total > budget the caller must fall
    back to the unbounded two-step path.
    """
    B, L = reads.shape
    s_lo, s_hi, s_qb, s_len, n_seeds = seed_reads(
        fm, reads, lens, max_seeds=max_seeds, min_seed_len=min_seed_len)
    S = max_seeds
    live = jnp.arange(S, dtype=jnp.int32)[None, :] < n_seeds[:, None]
    width = jnp.where(live, jnp.maximum(s_hi - s_lo, 0), 0)

    # BWA frac_rep: fraction of read bases covered by over-max_occ seeds
    # (greedy seeds are disjoint in read coords; clip for safety)
    l_rep = jnp.where(width > max_occ, s_len, 0).sum(axis=1)
    frac_rep = jnp.minimum(
        l_rep / jnp.maximum(lens, 1), 1.0).astype(jnp.float32)

    take = jnp.minimum(width, max_hits).reshape(-1)        # [B*S]
    offs = jnp.cumsum(take)                                # inclusive
    total = offs[-1]
    h = jnp.arange(budget, dtype=jnp.int32)
    src = jnp.searchsorted(offs, h, side="right").astype(jnp.int32)
    src = jnp.minimum(src, B * S - 1)
    start = offs[src] - take[src]
    i_loc = h - start
    w = width.reshape(-1)[src]
    t = jnp.maximum(take[src], 1)
    # even sampling, split to avoid i32 overflow (== (i_loc * w) // t)
    samp = i_loc * (w // t) + (i_loc * (w % t)) // t
    rows = s_lo.reshape(-1)[src] + jnp.where(w > t, samp, i_loc)
    rows = jnp.where(h < total, rows, 0)
    pos = locate(fm, rows)
    packed = jnp.stack([src // S, s_qb.reshape(-1)[src],
                        s_len.reshape(-1)[src], pos.astype(jnp.int32)])
    return packed, total, frac_rep


def expand_seed_hits(s_lo: jax.Array, s_hi: jax.Array, max_hits: int):
    """Expand SA intervals into up to ``max_hits`` rows each (even sampling).

    Returns rows [.., max_hits] and a validity mask.  Mirrors the
    reference's max_occ capping (BWA samples seeds with too many hits;
    EMA raises the cap to 3000 — src/align.c:185).
    """
    width = s_hi - s_lo
    i = jnp.arange(max_hits, dtype=jnp.int32)
    take = jnp.minimum(width, max_hits)
    # even sampling across the interval when width > max_hits; split the
    # product so i * width cannot overflow int32 for near-limit intervals
    stride = (i * (width[..., None] // max_hits)
              + (i * (width[..., None] % max_hits)) // max_hits)
    idx = jnp.where(width[..., None] > max_hits, stride, i)
    rows = s_lo[..., None] + idx
    valid = i < take[..., None]
    return jnp.where(valid, rows, 0), valid
