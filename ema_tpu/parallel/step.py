"""The sharded on-device candidate-generation step.

One fused, jittable program per batch of oriented reads:

    seed (FM backward search)  ->  locate (LF-walk)  ->  window gather
    ->  batched banded-SW scoring  ->  per-read best reduction

sharded over a ('data', 'cand') mesh: reads split along ``data``; each
read's candidate slots (sampled SA-interval hits) split along ``cand``,
recombined with an all-gather argmax.  Global batch statistics are
psum-reduced — the in-network replacement for the reference's
files-on-disk merge (SURVEY.md §2.4 P6).

This is the compile-shape of the hot path; the full pipeline
(ema_tpu.core.pipeline) interleaves the same device calls with host
chaining/traceback and uses this module's mesh for multi-chip batches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ema_tpu.index import fmindex
from ema_tpu.ops.sw import sw_score_banded
from ema_tpu.parallel.mesh import CAND_AXIS, DATA_AXIS

NEG = -(1 << 28)


class StepOut(NamedTuple):
    best_score: jax.Array     # int32 [B] clip-adjusted best SW score
    best_gpos: jax.Array      # int32 [B] global text pos of best window start
    n_aligned: jax.Array      # int32 [] reads with a positive-score candidate
    sum_score: jax.Array      # int32 [] sum of positive best scores


def _expand_hits_shard(s_lo: jax.Array, s_hi: jax.Array, k_local: int,
                       shard: jax.Array, n_shards: int):
    """Shard-local slice of ``fmindex.expand_seed_hits``.

    Hit slots are numbered globally 0..k_local*n_shards-1 and sampled evenly
    across the SA interval (BWA max_occ-style capping, src/align.c:185);
    shard ``i`` materializes slots [i*k_local, (i+1)*k_local).
    """
    width = s_hi - s_lo
    total = k_local * n_shards
    i = shard * k_local + jnp.arange(k_local, dtype=jnp.int32)
    take = jnp.minimum(width, total)
    # overflow-safe even sampling (i * width can exceed int32)
    stride = (i * (width[..., None] // total)
              + (i * (width[..., None] % total)) // total)
    idx = jnp.where(width[..., None] > total, stride, i)
    rows = s_lo[..., None] + idx
    valid = i < take[..., None]
    return jnp.where(valid, rows, 0), valid


@functools.partial(
    jax.jit,
    static_argnames=("max_seeds", "hits_per_seed", "window_pad",
                     "min_seed_len", "n_cand_shards",
                     "match", "mismatch", "gap_open", "gap_extend", "clip"))
def candidate_core(fm: fmindex.FMIndexArrays, text: jax.Array,
                   reads: jax.Array, lens: jax.Array,
                   cand_index: jax.Array = 0,
                   *, max_seeds: int = 8, hits_per_seed: int = 4,
                   window_pad: int = 16, min_seed_len: int = 19,
                   n_cand_shards: int = 1,
                   match: int = 1, mismatch: int = 4,
                   gap_open: int = 6, gap_extend: int = 1, clip: int = 5):
    """Device align step for one shard: [B, L] oriented reads -> best hits.

    ``text``: uint8 [n] device-resident 2-bit genome.  Returns
    (best_score [B], best_gpos [B]) for this shard's candidate slots.
    """
    B, L = reads.shape
    S, K = max_seeds, hits_per_seed
    W = L + 2 * window_pad
    n = text.shape[0]          # forward text (fm covers both strands, 2n)

    s_lo, s_hi, s_qb, s_len, _ = fmindex.seed_reads(
        fm, reads, lens, max_seeds=S, min_seed_len=min_seed_len)

    cand_index = jnp.asarray(cand_index, jnp.int32)
    rows, valid = _expand_hits_shard(s_lo, s_hi, K, cand_index, n_cand_shards)
    pos = fmindex.locate(fm, rows)                       # [B, S, K]
    # reverse-strand hits (upper half of the fm space) are dropped in this
    # demo step — the full pipeline maps them back to forward coordinates
    valid = valid & (pos + s_len[..., None] <= n)

    win_lo = pos - s_qb[..., None] - window_pad
    win_lo = jnp.clip(win_lo, 0, max(n - W, 0)).astype(jnp.int32)
    flat_lo = win_lo.reshape(B, S * K)
    vmask = valid.reshape(B, S * K)

    gather_idx = jnp.minimum(
        flat_lo[..., None] + jnp.arange(W, dtype=jnp.int32), n - 1)
    wins = text[gather_idx].astype(jnp.int32)            # [B, S*K, W]

    reads_rep = jnp.broadcast_to(
        reads[:, None, :], (B, S * K, L)).reshape(-1, L)
    lens_rep = jnp.broadcast_to(lens[:, None], (B, S * K)).reshape(-1)
    ref_lens = jnp.where(vmask, W, 0).reshape(-1)

    # banded row-sweep: the window is built around the seed diagonal, so
    # a 128-lane corridor covers every candidate; the main pipeline's
    # device scorer
    w_band = ((2 * window_pad + 2 + 127) // 128) * 128
    out = sw_score_banded(
        reads_rep, lens_rep, wins.reshape(-1, W), ref_lens, w_band,
        match=match, mismatch=mismatch, gap_open=gap_open,
        gap_extend=gap_extend, clip=clip)
    score = jnp.where(vmask, out["score"].reshape(B, S * K), NEG)
    k = jnp.argmax(score, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(score, k[:, None], axis=1)[:, 0]
    best_gpos = jnp.take_along_axis(flat_lo, k[:, None], axis=1)[:, 0]
    return best, best_gpos


def make_sharded_candidate_step(mesh: Mesh, fm: fmindex.FMIndexArrays,
                                text: jax.Array, **static):
    """Build the jitted multi-chip step over ``mesh``.

    Returned fn: (reads [B, L], lens [B]) -> StepOut, with B divisible by
    the data-axis size.  The FM index and text are replicated (the
    reference likewise holds one full BWA index per process,
    src/bwabridge.c:77-96); reads are sharded along ``data``; candidate
    slots along ``cand``.
    """
    n_cand = mesh.shape[CAND_AXIS]
    static.setdefault("n_cand_shards", n_cand)

    def local_step(fm, text, reads, lens):
        ci = jax.lax.axis_index(CAND_AXIS)
        best, gpos = candidate_core(fm, text, reads, lens, ci, **static)
        # recombine candidate shards: all-gather per-shard bests, argmax
        alls = jax.lax.all_gather(best, CAND_AXIS)       # [n_cand, b]
        allg = jax.lax.all_gather(gpos, CAND_AXIS)
        w = jnp.argmax(alls, axis=0)
        best = jnp.take_along_axis(alls, w[None, :], axis=0)[0]
        gpos = jnp.take_along_axis(allg, w[None, :], axis=0)[0]
        # global stats ride the device interconnect, not a host merge
        pos_mask = best > 0
        n_aligned = jax.lax.psum(pos_mask.sum().astype(jnp.int32), DATA_AXIS)
        sum_score = jax.lax.psum(
            jnp.where(pos_mask, best, 0).sum().astype(jnp.int32), DATA_AXIS)
        return StepOut(best, gpos, n_aligned, sum_score)

    fm_specs = jax.tree_util.tree_map(lambda _: P(), fm)
    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(fm_specs, P(), P(DATA_AXIS, None), P(DATA_AXIS)),
        out_specs=StepOut(P(DATA_AXIS), P(DATA_AXIS), P(), P()),
        check_vma=False)

    @jax.jit
    def step(reads, lens):
        return sharded(fm, text, reads, lens)

    return step
