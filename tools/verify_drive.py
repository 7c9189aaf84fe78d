"""End-to-end CLI verify drive on synthetic data (the /verify recipe).

Builds a genome + interleaved FASTQ + whitelist with tests/simulate.py,
drives the real CLI (count -> preproc -> index -> align), and validates
every SAM record against simulation truth (+-5 bp), BX/MI/XG tags and
proper-pair flags.  Run CPU-pinned:

    JAX_PLATFORMS=cpu python tools/verify_drive.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from simulate import (rand_genome, simulate_pairs, parse_sam_line,  # noqa: E402
                      to_str)

MATE1_TRIM = 7


def run_cli(args, cwd, stdin_path=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    stdin = open(stdin_path, "rb") if stdin_path else None
    try:
        subprocess.run([sys.executable, "-m", "ema_tpu.cli", *args],
                       cwd=cwd, env=env, stdin=stdin, check=True)
    finally:
        if stdin:
            stdin.close()


def main():
    rng = np.random.default_rng(20260818)
    genome = to_str(rand_genome(rng, 400_000))
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
        rng, genome, n_barcodes=40, frags_per_bc=(2, 5),
        pairs_per_frag=(8, 20), frag_len=12_000)
    n_pairs = len(ids)
    print(f"simulated {n_pairs} pairs, {len(set(bc_strs))} barcodes")

    d = tempfile.mkdtemp(prefix="ema_verify_")
    ref = os.path.join(d, "ref.fa")
    with open(ref, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(genome), 80):
            f.write(genome[i:i + 80] + "\n")
    wl = os.path.join(d, "wl.txt")
    with open(wl, "w") as f:
        for b in sorted(set(bc_strs)):
            f.write(b + "\n")
    fq = os.path.join(d, "inter.fq")
    with open(fq, "w") as f:
        for i in range(n_pairs):
            r1 = bc_strs[i] + "G" * MATE1_TRIM + s1[i]
            f.write(f"@{ids[i]}\n{r1}\n+\n" + "I" * len(r1) + "\n")
            f.write(f"@{ids[i]}\n{s2[i]}\n+\n" + "I" * len(s2[i]) + "\n")

    run_cli(["count", "-w", wl, "-o", os.path.join(d, "cnt")], d,
            stdin_path=fq)
    run_cli(["preproc", "-w", wl, "-o", os.path.join(d, "bkt"), "-n", "4",
             "-h", os.path.join(d, "cnt.ema-ncnt")], d, stdin_path=fq)
    run_cli(["index", "-r", ref], d)

    sam_paths = []
    for b in range(4):
        bkt = os.path.join(d, "bkt", f"ema-bin-{b:03d}")
        if not os.path.exists(bkt):
            continue
        out = os.path.join(d, f"out{b}.sam")
        run_cli(["align", "-r", ref, "-s", bkt, "-o", out], d)
        sam_paths.append(out)

    truth_by_id = {ids[i]: truth[i] for i in range(n_pairs)}
    n_rec = n_at_truth = n_proper = n_primary = 0
    missing_tags = 0
    seen = set()
    for sp in sam_paths:
        for line in open(sp):
            if line.startswith("@"):
                continue
            rec = parse_sam_line(line)
            n_rec += 1
            flag = rec["flag"]
            if flag & 0x900:
                continue
            n_primary += 1
            t = truth_by_id[rec["qname"]]
            want = t["pos1"] if (flag & 0x40) else t["pos2"]
            if abs(rec["pos"] - want) <= 5:
                n_at_truth += 1
            if flag & 0x2:
                n_proper += 1
            tags = rec["tags"]
            if "BX" not in tags or "MI" not in tags or "XG" not in tags:
                missing_tags += 1
            seen.add((rec["qname"], flag & 0xC0))
    print(f"records={n_rec} primary={n_primary} at_truth={n_at_truth} "
          f"proper={n_proper} missing_tags={missing_tags}")
    assert n_primary == 2 * n_pairs, (n_primary, 2 * n_pairs)
    assert len(seen) == 2 * n_pairs
    at = n_at_truth / n_primary
    pp = n_proper / n_primary
    assert at >= 0.98, f"at-truth rate {at:.4f} < 0.98"
    assert pp >= 0.98, f"proper-pair rate {pp:.4f} < 0.98"
    assert missing_tags == 0
    print(f"VERIFY OK: {at * 100:.2f}% at truth, {pp * 100:.2f}% proper, "
          f"tags complete ({d})")


if __name__ == "__main__":
    main()
