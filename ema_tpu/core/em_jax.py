"""The cloud EM model as dense batched JAX ops (device path).

Port of the reference's EM loop (src/align.c:431-543) with the exact
semantics of the host implementation in ``ema_tpu.core.groups``:

  - gammas over padded [G, E, C] arrays (G barcode groups, E entries =
    (pair, mate) keys, C candidates per entry),
  - cloud weights by scatter-add over local cloud ids, renormalized within
    disjoint-set chains (align.c:125-143) or per-entry for many_clouds
    platforms,
  - the two-phase in-place update order (later-inserted mate first) that
    the reference gets implicitly from reverse-insertion iteration
    (align.c:444-521) is replicated with phase masks,
  - ``normalize_log_probs`` numerics in float64: max-shift, the
    log(1e-50) - log(n) floor, exact 1.0 for single-candidate rows
    (src/util.c:129-163).

Everything is fixed-shape: jit once per (G, E, C, NC) bucket.  The host
path (numpy, groups.py) and this one agree to float64 round-off; tests
cross-check them on random groups.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ema_tpu import config

_LOG_EPSILON = float(np.log(1e-50))


def _ftype():
    """float64 when x64 is enabled (host parity), else float32.

    groups.dispatch_em_device_batch traces under x64, so the pipeline's
    EM is always float64."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


class EMInputs(NamedTuple):
    """Padded EM problem, batched over G groups.

    Shapes: [G, E, C] unless noted.  Invalid slots must be masked out in
    ``cmask`` / ``emask``; ``cand_cloud`` / ``comp`` values must stay in
    [0, NC) even for padding.
    """

    score: jax.Array        # f64 raw log-prob alignment scores
    cmask: jax.Array        # bool candidate validity
    active: jax.Array       # bool record active & not duplicate
    cand_cloud: jax.Array   # i32 local cloud ids
    rec_chrom: jax.Array    # i32
    rec_pos: jax.Array      # i32
    rec_rev: jax.Array      # i32 (0/1)
    mate_entry: jax.Array   # i32 [G, E]: index of mate entry or -1
    emask: jax.Array        # bool [G, E] entry validity
    comp: jax.Array         # i32 [G, NC] chain component of each cloud
    run_em: jax.Array       # bool [G]: group meets the >=30-pair gate


def normalize_log_probs_jnp(p: jax.Array, mask: jax.Array) -> jax.Array:
    """Batched reference normalize_log_probs over the last axis (f64)."""
    p = p.astype(_ftype())
    counts = mask.sum(axis=-1)
    pm = jnp.where(mask, p, -jnp.inf)
    pmax = jnp.max(pm, axis=-1, keepdims=True)
    pmax = jnp.where(jnp.isfinite(pmax), pmax, 0.0)
    shifted = jnp.where(mask, pm - pmax, 0.0)
    thresh = (_LOG_EPSILON - jnp.log(jnp.maximum(counts, 1)))[..., None]
    vals = jnp.where(mask & (shifted >= thresh), jnp.exp(shifted), 0.0)
    totals = vals.sum(axis=-1, keepdims=True)
    out = jnp.where(totals > 0, vals / jnp.where(totals > 0, totals, 1.0), 0.0)
    single = (counts == 1)[..., None]
    return jnp.where(single, jnp.where(mask, 1.0, 0.0), out)


def _cloud_weights(gammas, weight_mask, cand_cloud, comp, nc, many):
    """Scatter-add expected coverage per cloud; chain-normalize."""
    G = gammas.shape[0]
    g_idx = jnp.arange(G, dtype=jnp.int32)[:, None, None]
    exp_cov = jnp.zeros((G, nc), _ftype()).at[g_idx, cand_cloud].add(
        jnp.where(weight_mask, gammas, 0.0))
    if many:
        return exp_cov
    gi = jnp.arange(G, dtype=jnp.int32)[:, None]
    totals = jnp.zeros((G, nc), _ftype()).at[gi, comp].add(exp_cov)
    t = jnp.take_along_axis(totals, comp, axis=1)
    return jnp.where(t > 0, exp_cov / jnp.where(t > 0, t, 1.0), exp_cov)


def _recompute(inp: EMInputs, gammas, weights, many):
    """One full-entry gamma recompute (align.c:444-521), all entries."""
    cloud_w = jnp.take_along_axis(
        weights[:, None, :],
        jnp.broadcast_to(inp.cand_cloud, inp.score.shape), axis=2)
    if many:
        tot = jnp.where(inp.cmask, cloud_w, 0.0).sum(axis=-1, keepdims=True)
        cloud_w = jnp.where(tot > 0, cloud_w / jnp.where(tot > 0, tot, 1.0),
                            0.0)
    log_w = jnp.log(jnp.where(cloud_w > 0, cloud_w, 1e-300))

    # best mate score: [G, E, C(self), C(mate)]
    me = jnp.maximum(inp.mate_entry, 0)[..., None]       # [G, E, 1]
    has_mate = (inp.mate_entry >= 0)[..., None]          # [G, E, 1]

    # gather mate rows along E: arr [G, E, C] -> arr[g, mate_entry[g, e], :]
    def mg(arr):
        return jnp.take_along_axis(
            arr, jnp.broadcast_to(me, arr.shape[:2] + (arr.shape[2],)),
            axis=1)

    m_chrom = mg(inp.rec_chrom)[:, :, None, :]           # [G, E, 1, C]
    m_pos = mg(inp.rec_pos)[:, :, None, :]
    m_rev = mg(inp.rec_rev)[:, :, None, :]
    m_cloud = mg(inp.cand_cloud)[:, :, None, :]
    m_gamma = mg(gammas)[:, :, None, :]
    m_mask = mg(inp.cmask)[:, :, None, :] & has_mate[..., None]

    i_chrom = inp.rec_chrom[..., None]                   # [G, E, C, 1]
    i_pos = inp.rec_pos[..., None]
    i_rev = inp.rec_rev[..., None]
    i_cloud = inp.cand_cloud[..., None]

    ok = (m_mask & (m_chrom == i_chrom) & (m_rev != i_rev)
          & (m_cloud == i_cloud) & (m_gamma != 0.0))
    d = jnp.where(i_rev == 1, i_pos - m_pos, m_pos - i_pos)
    pen = jnp.where((d >= config.INSERT_MIN) & (d <= config.INSERT_MAX),
                    0.0, config.UNPAIRED_PENALTY)
    ms = pen + jnp.log(jnp.where(ok & (m_gamma > 0), m_gamma, 1.0))
    ms = jnp.where(ok, ms, -jnp.inf)
    best_mate = jnp.maximum(ms.max(axis=-1), config.UNPAIRED_PENALTY)
    best_mate = jnp.where(has_mate, best_mate, config.UNPAIRED_PENALTY)

    new = inp.score + log_w + best_mate
    return normalize_log_probs_jnp(jnp.where(inp.cmask, new, 0.0), inp.cmask)


@functools.partial(jax.jit, static_argnames=("many", "em_iters"))
def em_run(inp: EMInputs, *, many: bool = False,
           em_iters: int = config.EM_ITERS):
    """Full EM: init gammas from scores, iterate, return (gammas, weights).

    Groups with ``run_em`` False keep their score-normalized init gammas
    (the reference's < 30 pairs gate, align.c:345) but still produce
    weights.

    Integer inputs may arrive narrowed (i16/i8) to shrink the
    host->device transfer — the EM payload is the align loop's largest
    upload (~20 B/cell at i32); everything upcasts to i32 here, inside
    the jit, where the cast fuses for free.
    """
    inp = inp._replace(
        cand_cloud=inp.cand_cloud.astype(jnp.int32),
        rec_chrom=inp.rec_chrom.astype(jnp.int32),
        rec_rev=inp.rec_rev.astype(jnp.int32),
        mate_entry=inp.mate_entry.astype(jnp.int32),
        comp=inp.comp.astype(jnp.int32))
    nc = inp.comp.shape[1]
    gammas = normalize_log_probs_jnp(inp.score, inp.cmask)
    init_gammas = gammas
    weights = _cloud_weights(gammas, inp.cmask, inp.cand_cloud, inp.comp,
                             nc, many)

    e_idx = jnp.arange(inp.mate_entry.shape[1], dtype=jnp.int32)[None, :]
    phase_b = (inp.mate_entry >= 0) & (e_idx < inp.mate_entry) & inp.emask
    phase_a = inp.emask & ~phase_b
    wmask = inp.active & inp.cmask

    def one_iter(carry, _):
        gammas, weights = carry
        for phase in (phase_a, phase_b):
            new = _recompute(inp, gammas, weights, many)
            gammas = jnp.where(phase[..., None] & inp.cmask, new, gammas)
        weights = _cloud_weights(gammas, wmask, inp.cand_cloud, inp.comp,
                                 nc, many)
        return (gammas, weights), None

    (em_gammas, em_weights), _ = jax.lax.scan(
        one_iter, (gammas, weights), None, length=em_iters)

    run = inp.run_em
    gammas = jnp.where(run[:, None, None], em_gammas, init_gammas)
    weights = jnp.where(run[:, None], em_weights, weights)
    return gammas, weights
