"""Front-half accuracy artifact (VERDICT r3 #5): % of simulated pairs
placed at truth, proper-pair rate, and mapq calibration at chr20 scale.

The align-core (EM/selection/SAM) half is parity-proven against the
compiled reference (CONCORDANCE_r03.json, 100.000% on 103k records); the
candidate-generation half (seeding -> chaining -> banded SW -> mate
rescue -> mapq, align.c:986-1061 semantics) cannot be compared against
real BWA-MEM here (the bwa submodule is empty and the environment has no
egress — documented in BASELINE.md), so its accuracy is MEASURED against
simulation ground truth instead: % of primary records within +-5 bp of
the simulated position, % proper pairs, and the empirical error rate per
mapq bin (calibration: high mapq must mean low error).

Usage:
    python tools/measure_accuracy.py [--genome 32000000] [--pairs 80000]
Writes ACCURACY_r{round}.json at the repo root and prints it.
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


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=32_000_000)
    ap.add_argument("--pairs", type=int, default=80_000)
    ap.add_argument("--err", type=float, default=0.003)
    ap.add_argument("--tol", type=int, default=5)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()

    from tests.simulate import rand_genome, simulate_pairs, to_str
    from ema_tpu import config
    from ema_tpu.core.pipeline import Aligner, ReadBatch
    from ema_tpu.index import build_index
    from ema_tpu.utils.backend import ensure_backend

    ensure_backend()
    import jax

    rng = np.random.default_rng(2026)
    t0 = time.time()
    genome = rand_genome(rng, a.genome)
    # plant repeat families (~2% of the genome) so multi-mapping reads
    # exist and the mapq calibration bins are populated — a plain random
    # genome maps 100% at mapq>=50, which validates nothing about mapq
    # copies carry VARYING divergence: exact copies make sub == score for
    # every in-repeat read (mapq pinned to 0 — MAPQ_DIAG_r05 traced the
    # empty 10-39 calibration buckets to exactly this), while real
    # genomic repeat families are diverged, which grades the mapq middle
    # (sub < score by varying margins).  Rates straddle the read error
    # rate so some copies are distinguishable and some are not.
    n_fam, n_copies, unit_len = 4, 12, a.genome // 2500
    div_rates = [0.0, 0.002, 0.005, 0.01, 0.02, 0.04]
    for fam in range(n_fam):
        src = int(rng.integers(0, a.genome - unit_len))
        unit = genome[src:src + unit_len].copy()
        for c in range(n_copies):
            at = int(rng.integers(0, a.genome - unit_len))
            cp = unit.copy()
            rate = div_rates[c % len(div_rates)]
            if rate:
                nmut = int(rate * unit_len)
                pos = rng.integers(0, unit_len, nmut)
                cp[pos] = (cp[pos] + rng.integers(1, 4, nmut)) % 4
            genome[at:at + unit_len] = cp
    gs = to_str(genome)
    idx = build_index({"chr20sim": genome})
    log(f"index: {a.genome/1e6:.0f} Mbp ({n_fam}x{n_copies} repeat "
        f"units of {unit_len} bp) in {time.time()-t0:.0f}s")

    t0 = time.time()
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
        rng, gs, n_barcodes=max(a.pairs // 60, 1), frags_per_bc=(2, 4),
        pairs_per_frag=(15, 25), frag_len=30_000, read_len=100, err=a.err)
    n_pairs = len(ids)
    log(f"simulated {n_pairs} pairs in {time.time()-t0:.0f}s")

    aligner = Aligner(idx, config.RunConfig())
    batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
    t0 = time.time()
    sam = aligner.align_batch_to_sam(batch)
    wall = time.time() - t0
    log(f"aligned in {wall:.0f}s ({n_pairs/wall:.0f} pairs/s)")

    truth_by_id = {ids[i]: truth[i] for i in range(n_pairs)}
    n_primary = n_at = n_proper = n_mapped = 0
    mapq_tot = np.zeros(61, np.int64)
    mapq_err = np.zeros(61, np.int64)
    for ln in sam:
        if ln.startswith("@"):
            continue
        f = ln.split("\t")
        flag = int(f[1])
        if flag & (0x100 | 0x800):        # secondary/supplementary
            continue
        n_primary += 1
        if flag & 0x4:
            continue
        n_mapped += 1
        if flag & 0x2:
            n_proper += 1
        t = truth_by_id[f[0]]
        want = t["pos1"] if (flag & 0x40) else t["pos2"]
        ok = abs(int(f[3]) - want) <= a.tol
        n_at += ok
        mq = min(int(f[4]), 60)
        mapq_tot[mq] += 1
        mapq_err[mq] += not ok

    hi30_n = int(mapq_tot[30:].sum())
    hi30_err = int(mapq_err[30:].sum())
    bins = [(0, 10), (10, 20), (20, 30), (30, 40), (40, 50), (50, 61)]
    calib = {}
    for lo, hi in bins:
        tot = int(mapq_tot[lo:hi].sum())
        err = int(mapq_err[lo:hi].sum())
        calib[f"mapq_{lo}_{hi-1}"] = {
            "n": tot, "err_rate": round(err / tot, 5) if tot else None}

    payload = {
        "what": ("front-half accuracy vs simulation truth at config-3 "
                 "scale (BWA-MEM comparison impossible here: empty bwa "
                 "submodule + zero egress, see BASELINE.md)"),
        "platform": jax.default_backend(),
        "genome_bp": a.genome,
        "n_pairs": n_pairs,
        "read_err_rate": a.err,
        "tol_bp": a.tol,
        "primary_records": n_primary,
        "mapped_pct": round(100.0 * n_mapped / max(n_primary, 1), 3),
        "at_truth_pct_of_mapped": round(100.0 * n_at / max(n_mapped, 1), 3),
        "at_truth_pct_of_all": round(100.0 * n_at / max(n_primary, 1), 3),
        "at_truth_pct_mapq30plus": round(
            100.0 * (1 - hi30_err / max(hi30_n, 1)), 3),
        "proper_pair_pct": round(100.0 * n_proper / max(n_primary, 1), 3),
        "mapq_calibration": calib,
        "align_wall_s": round(wall, 1),
        "pairs_per_sec": round(n_pairs / wall, 1),
    }
    rnd = os.environ.get("EMA_TPU_ROUND", "05")
    out = a.out or os.path.join(REPO, f"ACCURACY_r{rnd}.json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    log(f"wrote {out}")
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
