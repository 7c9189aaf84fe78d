"""Quality-parity study of the -d density optimizer vs the reference.

The reference's simulated annealer is time-seeded (src/split.c:54-59), so
bit-identical comparison is impossible by design; SURVEY.md calls for a
tolerance-based comparison instead.  This tool runs both stacks with the
density optimizer ON over the same repeat-heavy world (identical candidates
via bwabridge replay) and reports:

  1. concordance on the deterministic subset (records in non-bad clouds,
     XF:i:0 in both outputs) — must be 100%;
  2. position-agreement rate inside bad clouds (stochastic subset);
  3. the true SA energy of each stack's final picks under ONE shared
     evaluator mirroring src/split.c's objective: per bad (BX, MI) cloud,
     E = sum_bins log_density_prob(count) + sum_records gen_score/SCORE_SCALE
     (bins of 1000 bp anchored at the cloud's min pos; generative score
     recomputed from each record's CIGAR+NM per align.c:846-913).

Writes DENSITY_r03.json at the repo root.  Usage:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/measure_density_opt.py
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def _parse_sam(path):
    """-> dict[(qname, mate)] = dict(chrom,pos,rev,cigar,nm,bx,mi,xf)."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.rstrip("\n").split("\t")
            flag = int(t[1])
            if flag & 0x100:              # secondary (none emitted, safety)
                continue
            mate = 1 if flag & 0x80 else 0
            tags = {}
            for tag in t[11:]:
                k, typ, v = tag.split(":", 2)
                tags[k] = v
            out[(t[0], mate)] = dict(
                chrom=t[2], pos=int(t[3]), rev=int(bool(flag & 0x10)),
                unmapped=int(bool(flag & 0x4)), cigar=t[5],
                nm=int(tags.get("NM", "0")), bx=tags.get("BX", ""),
                mi=int(tags.get("MI", "-1")), xf=int(tags.get("XF", "0")))
    return out


_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def _gen_score(cigar: str, nm: int, error_rate: float) -> float:
    """align.c:846-913 generative log-prob from a SAM CIGAR string + NM."""
    from ema_tpu import config
    if cigar == "*":
        return 0.0
    m = indel = runs = clip = 0
    for n, op in _CIG_RE.findall(cigar):
        n = int(n)
        if op in "M=X":
            m += n
        elif op in "ID":
            indel += n
            runs += 1
        elif op in "SH":
            clip += n
    mism = nm - indel
    return (float(m - mism) * np.log(1.0 - error_rate)
            + float(mism) * np.log(error_rate)
            + float(runs) * np.log(config.INDEL_RATE)
            + float(clip) * np.log(config.CLIP_RATE))


def _cloud_energies(recs, error_rate: float):
    """Per bad (BX, MI) cloud: shared SA-objective energy of final picks."""
    from ema_tpu import config
    from ema_tpu.core.split import _log_density_prob

    profile = config.get_platform_profile("10x")
    ldp = profile.log_density_probs
    clouds = {}
    for (qname, mate), r in recs.items():
        if r["unmapped"] or r["xf"] != 1:
            continue
        clouds.setdefault((r["bx"], r["mi"]), []).append(r)
    energies = {}
    for key, rs in clouds.items():
        pos = np.array([r["pos"] for r in rs], np.int64)
        lo = pos.min()
        bins = np.bincount((pos - lo) // config.BIN_SIZE)
        # empty bins contribute log_density_prob(0) too (the SA
        # objective's transition deltas include the 0 <-> 1 terms)
        e = sum(_log_density_prob(int(c), ldp) for c in bins)
        e += sum(_gen_score(r["cigar"], r["nm"], error_rate) for r in rs) \
            / config.SCORE_SCALE
        energies[key] = (e, len(rs))
    return energies


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from ema_tpu import config
    from ema_tpu.core.pipeline import Aligner, ReadBatch
    from ema_tpu.index import build_index
    from ema_tpu.utils.replay import ReplayWriter
    from tests import oracle
    from tests.simulate import rand_genome, simulate_pairs, to_str

    if not oracle.reference_available():
        print("reference tree unavailable", file=sys.stderr)
        return 1

    n_runs = 3
    for i, a in enumerate(sys.argv):
        if a == "--seeds" and i + 1 < len(sys.argv):
            n_runs = int(sys.argv[i + 1])

    rng = np.random.default_rng(20260818)
    g1 = rand_genome(rng, 700_000)
    unit = g1[200_000:201_500].copy()
    for k in range(40):                  # dense repeat family -> bad clouds
        at = 210_000 + k * 1_600
        g1[at:at + 1_500] = unit
    unit2 = g1[400_000:401_200].copy()
    for k in range(30):
        at = 410_000 + k * 1_400
        g1[at:at + 1_200] = unit2
    contigs = {"chr1": g1}
    gs = to_str(g1)

    ids, bc_strs, bcs, s1, q1, s2, q2, _ = simulate_pairs(
        rng, gs, n_barcodes=120, frags_per_bc=(2, 5),
        pairs_per_frag=(20, 50), frag_len=25_000, read_len=100, err=0.004)
    n_pairs = len(ids)
    print(f"world: {n_pairs} pairs, {len(set(bc_strs))} barcodes")

    import tempfile
    tmp = tempfile.mkdtemp(prefix="densopt_")
    bucket = os.path.join(tmp, "bucket")
    with open(bucket, "w") as f:
        for i in range(n_pairs):
            f.write(f"{bc_strs[i]} @{ids[i]} {s1[i]} {q1[i]} "
                    f"{s2[i]} {q2[i]}\n")

    # ours is deterministic given RunConfig.seed; a single seed is one
    # draw from the same distribution the reference samples by time() —
    # run 3 seeds and compare means (seed 7's output is the diffed one)
    t0 = time.time()
    idx = build_index(contigs)
    ours_paths = []
    for si, seed in enumerate(range(7, 7 + n_runs)):
        aligner = Aligner(idx, config.RunConfig(
            batch_size=1024, seed=seed, apply_density_opt=True))
        if si == 0:
            writer = ReplayWriter(os.path.join(tmp, "replay"),
                                  idx.names, [int(x) for x in idx.lengths])
            aligner.replay_sink = writer.add
        batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
        lines = aligner.align_batch_to_sam(batch)
        if si == 0:
            writer.close()
        p = os.path.join(tmp, f"ours{si}.sam")
        with open(p, "w") as f:
            f.write("".join(l if l.endswith("\n") else l + "\n"
                            for l in lines))
        ours_paths.append(p)
    ours_path = ours_paths[0]
    t_ours = time.time() - t0

    # the reference annealer is srand(time(NULL))-seeded: one run is one
    # random roll.  Run it three times (>=1.1s apart so time() differs)
    # and compare our deterministic shipped behavior against each roll.
    t0 = time.time()
    ref_paths = []
    for r in range(n_runs):
        p = os.path.join(tmp, f"ref{r}.sam")
        oracle.run_align_oracle(os.path.join(tmp, "replay"), bucket, p,
                                apply_opt=1)
        ref_paths.append(p)
        if r < n_runs - 1:
            time.sleep(1.1)               # time-seeded: distinct rolls
    t_ref = time.time() - t0

    ours = _parse_sam(ours_path)
    refs = [_parse_sam(p) for p in ref_paths]
    ref = refs[0]
    shared = sorted(set(ours) & set(ref))
    only = len(set(ours) ^ set(ref))

    det = det_ok = sto = sto_pos_ok = 0
    for k in shared:
        a, b = ours[k], ref[k]
        if a["xf"] == 0 and b["xf"] == 0:
            det += 1
            det_ok += int((a["chrom"], a["pos"], a["rev"], a["cigar"])
                          == (b["chrom"], b["pos"], b["rev"], b["cigar"]))
        else:
            sto += 1
            sto_pos_ok += int((a["chrom"], a["pos"]) == (b["chrom"], b["pos"]))

    err = config.get_platform_profile("10x").error_rate

    def per_bx(recs):
        out = {}
        for (bx, _), (e, nrec) in _cloud_energies(recs, err).items():
            out[bx] = out.get(bx, 0.0) + e
        return out

    # compare per barcode: each stack's own MI clustering, summed per BX;
    # seed-mean of ours vs roll-mean of the reference
    per_bx_os = [per_bx(_parse_sam(p)) for p in ours_paths]
    per_bx_rs = [per_bx(r) for r in refs]
    both = sorted(b for b in per_bx_os[0]
                  if all(b in pr for pr in per_bx_rs + per_bx_os))
    tol = 1e-6
    ours_mean = {b: sum(po[b] for po in per_bx_os) / len(per_bx_os)
                 for b in both}
    ref_mean = {b: sum(pr[b] for pr in per_bx_rs) / len(per_bx_rs)
                for b in both}
    wins = int(sum(ours_mean[b] > ref_mean[b] + tol for b in both))
    losses = int(sum(ours_mean[b] < ref_mean[b] - tol for b in both))
    ties = len(both) - wins - losses
    # Wilson 95% CI on the win fraction among decided barcodes — the
    # statistical support VERDICT r3 #6 asks for (claim advantage only
    # if the lower bound clears 0.5)
    nd = wins + losses
    if nd:
        z = 1.959964
        ph = wins / nd
        den = 1 + z * z / nd
        ctr = (ph + z * z / (2 * nd)) / den
        hw = z * ((ph * (1 - ph) / nd + z * z / (4 * nd * nd)) ** 0.5) / den
        win_ci = (round(ctr - hw, 4), round(ctr + hw, 4))
    else:
        win_ci = (None, None)
    ours_totals = [round(sum(po[b] for b in both), 3) for po in per_bx_os]
    tot_o = sum(ours_totals) / len(ours_totals)
    ref_totals = [round(sum(pr[b] for b in both), 3) for pr in per_bx_rs]
    tot_r = sum(ref_totals) / len(ref_totals)

    out = {
        "round": int(os.environ.get("EMA_TPU_ROUND", "05")),
        "what": "-d density-optimizer quality parity vs the reference's "
                "own compiled annealer (time-seeded -> tolerance-based "
                "comparison per SURVEY; identical candidates via "
                "bwabridge replay; shared energy evaluator = "
                "split.c objective)",
        "n_pairs": n_pairs,
        "shared_records": len(shared),
        "records_only_one_side": only,
        "deterministic_records": det,
        "deterministic_concordance_pct":
            round(100.0 * det_ok / max(det, 1), 4),
        "bad_cloud_records": int(sto),
        "bad_cloud_pos_agreement_pct":
            round(100.0 * sto_pos_ok / max(sto, 1), 4),
        "bad_barcodes_compared": len(both),
        "energy_ours_runs": ours_totals,
        "energy_ours_mean": round(tot_o, 3),
        "energy_ref_runs": ref_totals,
        "energy_ref_mean": round(tot_r, 3),
        "energy_wins": wins, "energy_ties": ties, "energy_losses": losses,
        "win_rate_decided": round(wins / nd, 4) if nd else None,
        "win_rate_wilson95": list(win_ci),
        "n_runs_per_side": n_runs,
        "claim": ("advantage" if nd and win_ci[0] is not None
                  and win_ci[0] > 0.5 else
                  "parity" if nd and win_ci[1] is not None
                  and win_ci[1] >= 0.5 else "disadvantage"),
        "note": f"energy is the SA objective of the FINAL picks; higher "
                f"is better; ours = {n_runs} RunConfig seeds of the "
                f"shipped config (SPLIT_RESTARTS chains, best-energy "
                f"pick), reference = {n_runs} rolls of its time-seeded "
                f"single chain; wins/ties/losses compare per-barcode "
                f"means; the claim key is gated on the Wilson interval",
    }
    rnd = os.environ.get("EMA_TPU_ROUND", "05")
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), f"DENSITY_r{rnd}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(f"wrote {path}  (ours {t_ours:.1f}s, oracle {t_ref:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
