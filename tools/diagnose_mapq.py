"""Diagnose the bimodal mapq spectrum (VERDICT r4 #7).

The mapq FORMULA is parity-proven: the reference's own compiled
mem_approx_mapq_se_insist reproduces our mapq byte-for-byte on replayed
candidates (CONCORDANCE_r04 mapq_exact_pct=100.0).  What this tool
settles is where the 10-39 mass goes, by decomposing the three-way min
(samrecord.c:142-148: min(gamma_mapq, score_mapq, bwa_approx_mapq)) and
the approx-mapq inputs on a repeat-family world:

  - per final-mapq bucket: which term binds;
  - for multi-candidate reads: is the second-best candidate a SAME-locus
    near-duplicate (a dedup gap would compress sub -> score) or a true
    other-locus repeat hit;
  - the sub/score ratio distribution feeding approx_mapq.

    EMA_TPU_ROUND=05 python tools/diagnose_mapq.py [--genome N --pairs N]
Writes MAPQ_DIAG_r{round}.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=8_000_000)
    ap.add_argument("--pairs", type=int, default=20_000)
    a = ap.parse_args()

    from tests.simulate import rand_genome, simulate_pairs, to_str
    from ema_tpu import config
    from ema_tpu.core import score as score_mod
    from ema_tpu.core.pipeline import Aligner, ReadBatch
    from ema_tpu.index import build_index
    from ema_tpu.utils.backend import ensure_backend

    ensure_backend()

    rng = np.random.default_rng(2026)
    genome = rand_genome(rng, a.genome)
    n_fam, n_copies, unit_len = 4, 12, a.genome // 2500
    for fam in range(n_fam):
        src = int(rng.integers(0, a.genome - unit_len))
        unit = genome[src:src + unit_len].copy()
        for c in range(n_copies):
            at = int(rng.integers(0, a.genome - unit_len))
            genome[at:at + unit_len] = unit
    idx = build_index({"chr": genome})
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
        rng, to_str(genome), n_barcodes=max(a.pairs // 60, 1),
        frags_per_bc=(2, 4), pairs_per_frag=(15, 25), frag_len=30_000,
        read_len=100, err=0.003)
    n_pairs = len(ids)
    log(f"{n_pairs} pairs on {a.genome/1e6:.0f} Mbp w/ repeats")

    # --- capture final_mapq terms ------------------------------------
    terms = {"gamma": [], "score": [], "bwa": []}
    orig_final = score_mod.final_mapq

    def spy_final(gamma, score_mapq, bwa_mapq):
        terms["gamma"].append(np.atleast_1d(
            score_mod.gamma_mapq(gamma)).copy())
        terms["score"].append(np.atleast_1d(
            np.asarray(score_mapq)).copy())
        terms["bwa"].append(np.atleast_1d(np.asarray(bwa_mapq)).copy())
        return orig_final(gamma, score_mapq, bwa_mapq)

    score_mod.final_mapq = spy_final
    # pipeline.py binds `score_mod` at module import; patch there too
    import ema_tpu.core.pipeline as pl
    import ema_tpu.core.samout as so
    pl.score_mod.final_mapq = spy_final
    so.score_mod.final_mapq = spy_final

    # --- capture candidate sets ---------------------------------------
    cand_stats = {"two_plus": 0, "same_locus_2nd": 0, "other_locus_2nd": 0,
                  "sub_ratio": []}

    def sink(batch, cs):
        N = cs.owner.shape[0]
        if not N:
            return
        # physical read key (owner already physical read id here)
        order = np.lexsort((np.arange(N), -cs.sw.astype(np.int64),
                            cs.owner))
        own_s = cs.owner[order]
        first = np.ones(N, bool)
        first[1:] = own_s[1:] != own_s[:-1]
        starts = np.nonzero(first)[0]
        counts = np.diff(np.concatenate([starts, [N]]))
        multi = counts >= 2
        cand_stats["two_plus"] += int(multi.sum())
        b_i = order[starts[multi]]
        s_i = order[starts[multi] + 1]
        same_chrom = cs.chrom[b_i] == cs.chrom[s_i]
        close = (np.abs(cs.gpos[b_i].astype(np.int64)
                        - cs.gpos[s_i].astype(np.int64)) <= 150)
        same = same_chrom & close
        cand_stats["same_locus_2nd"] += int(same.sum())
        cand_stats["other_locus_2nd"] += int((~same).sum())
        with np.errstate(divide="ignore", invalid="ignore"):
            r = cs.sw[s_i] / np.maximum(cs.sw[b_i], 1)
        cand_stats["sub_ratio"].append(r.astype(np.float32))

    aligner = Aligner(idx, config.RunConfig())
    aligner.replay_sink = sink
    batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
    t0 = time.time()
    sam = aligner.align_batch_to_sam(batch)
    log(f"aligned in {time.time()-t0:.0f}s; {len(sam)} records")
    score_mod.final_mapq = orig_final
    pl.score_mod.final_mapq = orig_final
    so.score_mod.final_mapq = orig_final

    g = np.concatenate(terms["gamma"]).astype(np.int64)
    s = np.concatenate(terms["score"]).astype(np.int64)
    b = np.concatenate(terms["bwa"]).astype(np.int64)
    final = np.clip(np.minimum(np.minimum(g, s), b), 0, 60)

    buckets = [(0, 10), (10, 20), (20, 30), (30, 40), (40, 50), (50, 61)]
    decomp = {}
    for lo, hi in buckets:
        m = (final >= lo) & (final < hi)
        n = int(m.sum())
        if n:
            binds = {
                "gamma_binds_pct": round(100.0 * float(
                    (g[m] == final[m]).mean()), 1),
                "score_binds_pct": round(100.0 * float(
                    (s[m] == final[m]).mean()), 1),
                "bwa_binds_pct": round(100.0 * float(
                    (b[m] == final[m]).mean()), 1),
            }
        else:
            binds = {}
        decomp[f"mapq_{lo}_{hi-1}"] = {"n": n, **binds}
    # where do the RAW bwa-approx values land (before the min)?
    bwa_hist = {f"{lo}_{hi-1}": int(((b >= lo) & (b < hi)).sum())
                for lo, hi in buckets}
    gamma_hist = {f"{lo}_{hi-1}": int(((np.clip(g, 0, 60) >= lo)
                                       & (np.clip(g, 0, 60) < hi)).sum())
                  for lo, hi in buckets}

    ratios = (np.concatenate(cand_stats["sub_ratio"])
              if cand_stats["sub_ratio"] else np.zeros(0, np.float32))
    payload = {
        "what": ("mapq bimodality decomposition on a repeat-family world; "
                 "formula parity vs the compiled reference is separately "
                 "proven (CONCORDANCE mapq_exact_pct=100)"),
        "n_pairs": n_pairs,
        "records": int(final.shape[0]),
        "final_decomposition": decomp,
        "bwa_approx_raw_hist": bwa_hist,
        "gamma_mapq_raw_hist": gamma_hist,
        "multi_candidate_reads": cand_stats["two_plus"],
        "second_best_same_locus": cand_stats["same_locus_2nd"],
        "second_best_other_locus": cand_stats["other_locus_2nd"],
        "sub_over_score_quantiles": {
            q: round(float(np.quantile(ratios, float(q))), 3)
            for q in ("0.1", "0.5", "0.9")} if ratios.size else {},
    }
    rnd = os.environ.get("EMA_TPU_ROUND", "05")
    path = os.path.join(REPO, f"MAPQ_DIAG_r{rnd}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
