"""Chaining-fidelity artifact (VERDICT r4 #8): candidate-set recall vs
brute-force ground truth on a repeat-family stress world.

The reference inherits BWA-MEM's chain filtering (mem_chain_flt:
drop_ratio 0.5, min chain weight) via mem_align1_core
(reference src/bwabridge.c:236-237).  Our chaining (ops/chaining.py)
is deliberately MORE permissive — top-K chains by weight with no
drop-ratio — and prunes later on actual SW scores (the
EXTRA_SEARCH_DEPTH window of align.c:1020-1024).  A weight-based filter
can only lose candidates relative to that, so the fidelity question is
recall: does our candidate set contain every locus a score-based oracle
says is eligible?

Ground truth here is exhaustive: reads are simulated from planted
repeat families whose copy positions are KNOWN, so for every in-repeat
read the full set of plausible loci (the same offset in every family
copy) is enumerable, and each is scored with the pipeline's own exact
banded-SW kernel in both orientations.  A locus is ELIGIBLE if its
brute-force score is within the pipeline's provable score margin
(EXTRA_SEARCH_DEPTH * per-edit cost + clip slack — the same bound
_finalize_candidates uses) of the best locus.  Recall = eligible loci
that appear in the pipeline's candidate set.

    EMA_TPU_ROUND=05 python tools/chain_recall.py
Writes CHAIN_r05.json; tests/test_chain_recall.py gates >= 99.9% on a
smaller world.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(m):
    print(m, file=sys.stderr, flush=True)


def build_world(rng, genome_bp, n_pairs, div_rates=(0.0, 0.005, 0.01,
                                                    0.02, 0.05),
                n_fam=3, n_copies=10, err=0.003):
    """Genome with repeat families at known copy positions (+ diverged
    copies) and simulated pairs.  Returns (genome, families, sim tuple)
    where families = [(unit_len, [copy_starts...]), ...] (0-based)."""
    from tests.simulate import rand_genome, simulate_pairs, to_str

    genome = rand_genome(rng, genome_bp)
    unit_len = max(genome_bp // 1500, 2000)
    families = []
    taken = []
    for fam in range(n_fam):
        src = int(rng.integers(0, genome_bp - unit_len))
        unit = genome[src:src + unit_len].copy()
        starts = [src]
        for c in range(n_copies - 1):
            at = int(rng.integers(0, genome_bp - unit_len))
            # keep copies disjoint so locus arithmetic stays exact
            if any(abs(at - t) < unit_len for t in taken + starts):
                continue
            cp = unit.copy()
            rate = div_rates[c % len(div_rates)]
            if rate:
                nmut = int(rate * unit_len)
                p = rng.integers(0, unit_len, nmut)
                cp[p] = (cp[p] + rng.integers(1, 4, nmut)) % 4
            genome[at:at + unit_len] = cp
            starts.append(at)
        taken.extend(starts)
        families.append((unit_len, sorted(starts)))
    sim = simulate_pairs(
        rng, to_str(genome), n_barcodes=max(n_pairs // 60, 1),
        frags_per_bc=(2, 4), pairs_per_frag=(15, 25), frag_len=20_000,
        read_len=100, err=err)
    return genome, families, sim


def measure_recall(genome, families, sim, cfg=None, margin_extra=0):
    """Run the pipeline, capture candidates, brute-force-score all
    family-translated loci for in-repeat reads, and compute recall of
    eligible loci.  Returns the payload dict."""
    from ema_tpu import config, native
    from ema_tpu.core.pipeline import Aligner, ReadBatch
    from ema_tpu.index import build_index

    ids, bc_strs, bcs, s1, q1, s2, q2, truth = sim
    n_pairs = len(ids)
    idx = build_index({"chr": genome})
    params = (cfg or config.RunConfig()).aligner

    # capture candidate sets; chunk-local owner maps back to global pair
    # ids via batch.ids
    batches = []

    def sink(batch, cs):
        batches.append((batch, cs))

    aligner = Aligner(idx, cfg or config.RunConfig())
    aligner.replay_sink = sink
    batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
    aligner.align_batch_to_sam(batch)

    # global read key = (pair id string, mate) -> candidate gpos list
    cands: dict = {}
    for b, cs in batches:
        for o, g in zip(cs.owner, cs.gpos):
            pr, mate = int(o) // 2, int(o) % 2
            cands.setdefault((b.ids[pr], mate), []).append(int(g))

    # --- brute-force eligible loci for in-repeat reads ------------------
    # read span must lie fully inside a copy so the same offset exists in
    # every copy of the family
    L = 100
    fam_of_pos = np.full(genome.shape[0], -1, np.int32)
    for fi, (ul, starts) in enumerate(families):
        for st in starts:
            fam_of_pos[st:st + ul] = fi

    # the pipeline's FINAL keep-window is edit-distance-based
    # (align.c:1020-1024: dist - best_dist <= EXTRA_SEARCH_DEPTH); on a
    # substitution world one edit costs match+mismatch score.  Staying
    # one edit INSIDE the boundary keeps window-edge ties (legitimately
    # kept or dropped, as in the reference) out of the denominator.
    margin = ((config.EXTRA_SEARCH_DEPTH - 1)
              * (params.match + params.mismatch) + margin_extra)

    pad = 32
    jobs = []        # (read_key, loci[], rows in oriented array)
    ori_rows = []
    codes = batch.codes
    for i in range(n_pairs):
        t = truth[i]
        for mate, tp in ((0, t["pos1"]), (1, t["pos2"])):
            p0 = tp - 1                      # 0-based read start
            fi = fam_of_pos[p0]
            if fi < 0 or fam_of_pos[min(p0 + L - 1,
                                        genome.shape[0] - 1)] != fi:
                continue
            ul, starts = families[fi]
            base = max(s for s in starts if s <= p0)
            off = p0 - base
            if off + L > ul:
                continue
            loci = [s + off for s in starts]
            rows = []
            cd = codes[2 * i + mate]
            fw = np.asarray(cd, np.uint8)[:L]
            rc = (3 - fw)[::-1].copy()
            for orient in (fw, rc):
                rows.append(len(ori_rows))
                ori_rows.append(orient)
            jobs.append(((ids[i], mate), loci, rows))

    if not jobs:
        return {"error": "no in-repeat reads"}

    oriented = np.stack(ori_rows)
    olens = np.full(oriented.shape[0], L, np.int32)
    owners, wlo = [], []
    for _, loci, rows in jobs:
        for lx in loci:
            for r in rows:
                owners.append(r)
                wlo.append(lx - pad)
    owners = np.asarray(owners, np.int64)
    wlo = np.asarray(wlo, np.int64)
    wlen = np.full(owners.shape[0], L + 2 * pad, np.int64)
    W = 128
    out = native.sw_banded_native(
        oriented, olens, idx.text, owners, wlo, wlen.astype(np.int64), W,
        match=params.match, mismatch=params.mismatch,
        gap_open=params.gap_open, gap_extend=params.gap_extend,
        clip=params.clip_penalty,
        wl=np.full(owners.shape[0], W, np.int32))
    scores = np.asarray(out["score"], np.int64)

    # fold both orientations: score of a locus = max(fw, rc).  Recall is
    # stratified by the locus's edit-delta vs the best locus (score delta
    # / (match+mismatch) on a substitution world): selection, mapq and XA
    # hinge on the near-co-optimal bands; the far bands approach the
    # seeding limit every MEM-seeded aligner shares (a 5%-diverged copy
    # leaves few exact seeds >= min_seed_len).
    per_mm = params.match + params.mismatch
    bands = [(0, "d0"), (3, "d_le3"), (6, "d_le6"),
             (config.EXTRA_SEARCH_DEPTH - 1, "d_le11")]
    k = 0
    n_eligible = n_hit = n_reads_cov = n_reads = 0
    band_tot = {nm: 0 for _, nm in bands}
    band_hit = {nm: 0 for _, nm in bands}
    miss_examples = []
    for key, loci, rows in jobs:
        nl = len(loci)
        sc = scores[k:k + 2 * nl].reshape(nl, 2).max(axis=1)
        k += 2 * nl
        best = int(sc.max())
        elig = [(lx, int(s)) for lx, s in zip(loci, sc)
                if s >= best - margin]
        got = np.asarray(sorted(cands.get(key, [])), np.int64)
        n_reads += 1
        hit = 0
        for lx, s in elig:
            n_eligible += 1
            j = int(np.searchsorted(got, lx - 2 * pad))
            ok = bool(j < got.shape[0] and got[j] <= lx + 2 * pad)
            n_hit += ok
            hit += ok
            delta_edits = (best - s) / per_mm
            for lim, nm in bands:
                if delta_edits <= lim:
                    band_tot[nm] += 1
                    band_hit[nm] += ok
            if not ok and len(miss_examples) < 10:
                miss_examples.append(
                    {"read": str(key), "locus": int(lx),
                     "score": s, "best": best})
        n_reads_cov += hit == len(elig)

    by_band = {nm: {"n": band_tot[nm],
                    "recall_pct": round(
                        100.0 * band_hit[nm] / max(band_tot[nm], 1), 4)}
               for _, nm in bands}
    return {
        "n_pairs": n_pairs,
        "in_repeat_reads": n_reads,
        "eligible_loci": n_eligible,
        "recalled_loci": n_hit,
        "recall_pct": round(100.0 * n_hit / max(n_eligible, 1), 4),
        "recall_by_edit_delta": by_band,
        "reads_fully_covered_pct": round(
            100.0 * n_reads_cov / max(n_reads, 1), 4),
        "score_margin": int(margin),
        "miss_examples": miss_examples,
    }


def main():
    import dataclasses

    from ema_tpu import config
    from ema_tpu.utils.backend import ensure_backend
    ensure_backend()
    rng = np.random.default_rng(2026)
    genome, families, sim = build_world(rng, 12_000_000, 30_000)
    log(f"{len(sim[0])} pairs; families: "
        f"{[(ul, len(st)) for ul, st in families]}")
    # smem = the reference's seeding semantics (and our default on
    # multi-core hosts); greedy = the 1-core-host throughput default,
    # measured here so its repeat-recall tradeoff is on the record
    payload = {}
    for mode in ("smem", "greedy"):
        ap = dataclasses.replace(config.DEFAULT_ALIGNER_PARAMS,
                                 seeding=mode)
        res = measure_recall(genome, families, sim,
                             cfg=config.RunConfig(aligner=ap))
        log(f"{mode}: recall {res['recall_pct']}%")
        payload[mode] = res
    payload["what"] = (
        "candidate-set recall vs exhaustive brute-force ground truth on "
        "a diverged-repeat stress world: every family-translated locus "
        "of every in-repeat read scored with the exact banded-SW kernel "
        "in both orientations; eligible = within the pipeline's provable "
        "EXTRA_SEARCH_DEPTH score margin of the best locus.  Our "
        "chaining keeps strictly more than BWA's mem_chain_flt "
        "(drop_ratio 0.5) would, and prunes on real SW scores instead")
    rnd = os.environ.get("EMA_TPU_ROUND", "05")
    path = os.path.join(REPO, f"CHAIN_r{rnd}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
