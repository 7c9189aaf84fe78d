"""Measure record-level concordance vs the compiled reference align core
at scale, and write CONCORDANCE_r{round}.json at the repo root.

Runs the same dual-stack drive as tests/test_oracle_align.py but on a
larger world (~10k pairs incl. a repeat family), reporting per-field
agreement percentages.  Usage:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/measure_concordance.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from ema_tpu import config
    from ema_tpu.core.pipeline import Aligner, ReadBatch
    from ema_tpu.index import build_index
    from ema_tpu.utils import samdiff
    from ema_tpu.utils.replay import ReplayWriter
    from tests import oracle
    from tests.simulate import rand_genome, simulate_pairs, to_str

    if not oracle.reference_available():
        print("reference tree unavailable", file=sys.stderr)
        return 1

    rng = np.random.default_rng(20260817)
    g1 = rand_genome(rng, 1_600_000)
    g2 = rand_genome(rng, 800_000)
    g2[50_000:58_000] = g1[100_000:108_000]      # cross-contig dup
    unit = g1[200_000:201_500].copy()
    for k in range(40):                      # dense repeat family
        at = 210_000 + k * 1_600
        g1[at:at + 1_500] = unit
    unit2 = g1[900_000:902_000].copy()
    for k in range(25):                      # second, longer-period family
        at = 920_000 + k * 2_500
        g1[at:at + 2_000] = unit2
    contigs = {"chr1": g1, "chr2": g2}
    gs = to_str(np.concatenate([g1, g2]))

    ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
        rng, gs, n_barcodes=400, frags_per_bc=(2, 6),
        pairs_per_frag=(20, 55), frag_len=25_000, read_len=100, err=0.004)
    n_pairs = len(ids)
    print(f"world: {n_pairs} pairs, {len(set(bc_strs))} barcodes")

    import tempfile
    tmp = tempfile.mkdtemp(prefix="concord_")
    bucket = os.path.join(tmp, "bucket")
    with open(bucket, "w") as f:
        for i in range(n_pairs):
            f.write(f"{bc_strs[i]} @{ids[i]} {s1[i]} {q1[i]} "
                    f"{s2[i]} {q2[i]}\n")

    t0 = time.time()
    idx = build_index(contigs)
    aligner = Aligner(idx, config.RunConfig(batch_size=1024, seed=7))
    writer = ReplayWriter(os.path.join(tmp, "replay"),
                          idx.names, [int(x) for x in idx.lengths])
    aligner.replay_sink = writer.add
    batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
    lines = aligner.align_batch_to_sam(batch)
    writer.close()
    ours = os.path.join(tmp, "ours.sam")
    with open(ours, "w") as f:
        f.write("".join(l if l.endswith("\n") else l + "\n"
                        for l in lines))
    t_ours = time.time() - t0

    t0 = time.time()
    ref = os.path.join(tmp, "ref.sam")
    oracle.run_align_oracle(os.path.join(tmp, "replay"), bucket, ref)
    t_ref = time.time() - t0

    st = samdiff.diff_sams(ours, ref)
    print(st.summary())
    for m in st.mismatches[:20]:
        print("  ", m)

    s = st.shared or 1
    out = {
        "round": int(os.environ.get("EMA_TPU_ROUND", "05")),
        "what": "record-level concordance vs the reference's own "
                "compiled EM/selection/SAM stack (bwabridge candidate "
                "replay; identical candidates both sides; -t1, no -d)",
        "n_pairs": n_pairs,
        "records_ours": st.n_a,
        "records_ref": st.n_b,
        "shared": st.shared,
        "only_ours": st.only_a,
        "only_ref": st.only_b,
        "concordance_pct": round(100.0 * st.concordance(), 4),
        "pos_pct": round(100.0 * st.pos_match / s, 4),
        "flag_pct": round(100.0 * st.flag_match / s, 4),
        "cigar_pct": round(100.0 * st.cigar_match / s, 4),
        "mapq_exact_pct": round(100.0 * st.mapq_match / s, 4),
        "mapq_within5_pct": round(100.0 * st.mapq_close / s, 4),
        "xg_close_pct": round(100.0 * st.xg_close / s, 4),
        "mi_bijection_pct": round(100.0 * st.mi_consistent / s, 4),
        "bx_pct": round(100.0 * st.bx_match / s, 4),
        "mate_fields_pct": round(100.0 * st.mate_match / s, 4),
        "seq_qual_pct": round(100.0 * st.seq_match / s, 4),
        "xa_pct": round(100.0 * st.xa_match / s, 4),
        "mismatch_examples": st.mismatches[:10],
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), f"CONCORDANCE_r{os.environ.get('EMA_TPU_ROUND', '04')}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}  (ours {t_ours:.1f}s, oracle {t_ref:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
