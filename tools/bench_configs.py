"""Recorded benchmarks for BASELINE.md configs 3 and 4.

BASELINE.md's benchmark matrix (driver-defined):
  (3) `align -1/-2` vs human chr20 with EM + mate rescue
  (4) `align -x` 500 buckets with `-d`

Both configs run against simulated genomes (generated from a seed, no
download) through the REAL CLI: one subprocess at a time, the same
entry points a user runs.  The result prints as one JSON line, with the
platform, device kind and device count the CLI reported; ``--out``
also writes it to a file.

Usage:
    python tools/bench_configs.py config3 [--genome 32000000 --pairs 100000]
    python tools/bench_configs.py config4 [--buckets 500 --pairs 100000]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cli_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_cli(args, **kw) -> float:
    t0 = time.time()
    subprocess.run([sys.executable, "-m", "ema_tpu.cli", *args],
                   env=cli_env(), check=True, cwd=REPO, **kw)
    return time.time() - t0


def run_cli_stages(args) -> tuple[float, dict]:
    """Run a CLI align and parse its stage summary (':: align: 1.23s ...'
    stderr lines from utils/metrics.py) into {stage: seconds}."""
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "ema_tpu.cli", *args],
                       env=cli_env(), check=True, cwd=REPO,
                       stderr=subprocess.PIPE, text=True)
    wall = time.time() - t0
    stages = {}
    for ln in r.stderr.splitlines():
        ln = ln.strip()
        if ln.startswith("ema_tpu: platform="):
            stages["device"] = ln.split(": ", 1)[1]
        if ln.startswith("::") and ":" in ln[3:]:
            body = ln[2:].strip()
            name, _, rest = body.partition(":")
            rest = rest.strip()
            if rest[:1].isdigit() and "s" in rest:
                try:
                    stages[name.strip()] = float(rest.split("s")[0])
                except ValueError:
                    pass
    sys.stderr.write(r.stderr)
    return wall, stages


def simulate(tmp, genome_bp: int, n_pairs: int, seed: int = 7):
    sys.path.insert(0, REPO)
    from tests.simulate import rand_genome, simulate_pairs, to_str

    rng = np.random.default_rng(seed)
    g = rand_genome(rng, genome_bp)
    gs = to_str(g)
    fa = os.path.join(tmp, "ref.fa")
    with open(fa, "w") as f:
        f.write(">chr20sim\n")
        for i in range(0, len(gs), 70):
            f.write(gs[i:i + 70] + "\n")
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
        rng, gs, n_barcodes=max(n_pairs // 60, 1), frags_per_bc=(2, 4),
        pairs_per_frag=(15, 25), frag_len=30_000, read_len=100, err=0.003)
    return fa, ids, bc_strs, s1, q1, s2, q2


def write_artifact(payload: dict, out) -> None:
    if out:
        with open(out, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        log(f"wrote {out}")
    print(json.dumps(payload))


def config3(genome_bp: int, n_pairs: int, out_json=None) -> None:
    """align -1/-2: streaming pair-FASTQ mode, EM + mate rescue on."""
    with tempfile.TemporaryDirectory() as tmp:
        fa, ids, bc_strs, s1, q1, s2, q2 = simulate(tmp, genome_bp, n_pairs)
        f1 = os.path.join(tmp, "r1.fq")
        f2 = os.path.join(tmp, "r2.fq")
        with open(f1, "w") as a, open(f2, "w") as b:
            for i in range(len(ids)):
                rid = f"{ids[i]}:{bc_strs[i]}"
                a.write(f"@{rid}\n{s1[i]}\n+\n{q1[i]}\n")
                b.write(f"@{rid}\n{s2[i]}\n+\n{q2[i]}\n")
        t_index = run_cli(["index", "-r", fa])
        log(f"index: {t_index:.1f}s for {genome_bp/1e6:.0f} Mbp")
        out = os.path.join(tmp, "out.sam")
        # the index is built ONCE and loaded by every align run (the
        # reference loads a prebuilt index too, bwa_idx_load).  Cold run
        # populates the persistent XLA compilation cache; the warm run is
        # what every subsequent user invocation sees and is the headline.
        t_cold, st_cold = run_cli_stages(
            ["align", "-r", fa, "-1", f1, "-2", f2, "-o", out])
        t_warm, st_warm = run_cli_stages(
            ["align", "-r", fa, "-1", f1, "-2", f2, "-o", out])
        n_rec = sum(1 for ln in open(out) if not ln.startswith("@"))
        assert n_rec >= 2 * len(ids), (n_rec, len(ids))
        write_artifact({
            "metric": "align_pair_fastq_pairs_per_sec",
            "value": round(len(ids) / t_warm, 1),
            "unit": "pairs/s",
            "genome_bp": genome_bp,
            "n_pairs": len(ids),
            "index_build_s": round(t_index, 1),
            "align_warm_wall_s": round(t_warm, 1),
            "align_cold_wall_s": round(t_cold, 1),
            "compile_s_est": round(max(t_cold - t_warm, 0.0), 1),
            "stages_warm": st_warm,
            "cold_pairs_per_sec": round(len(ids) / t_cold, 1),
            "device": st_warm.pop("device", "unknown"),
            "note": ("chr20-scale simulated genome; full CLI path: streaming -1/-2 reader, EM, "
                     "mate rescue, SAM emission.  Index built once and "
                     "loaded (not rebuilt) by each align; warm run uses "
                     "the persistent XLA compilation cache"),
        }, out_json)


def config4(n_buckets: int, n_pairs: int, genome_bp: int,
            out_json=None) -> None:
    """align -x over many preproc buckets with -d (density opt)."""
    with tempfile.TemporaryDirectory() as tmp:
        fa, ids, bc_strs, s1, q1, s2, q2 = simulate(tmp, genome_bp, n_pairs)
        uniq = sorted(set(bc_strs))
        bucket_of = {b: hash(b) % n_buckets for b in uniq}
        fhs = {}
        os.makedirs(os.path.join(tmp, "bkt"))
        for i in range(len(ids)):
            k = bucket_of[bc_strs[i]]
            if k not in fhs:
                fhs[k] = open(
                    os.path.join(tmp, "bkt", f"ema-bin-{k:03d}"), "w")
            fhs[k].write(f"{bc_strs[i]} @{ids[i]} {s1[i]} {q1[i]} "
                         f"{s2[i]} {q2[i]}\n")
        for fh in fhs.values():
            fh.close()
        buckets = sorted(
            os.path.join(tmp, "bkt", n) for n in os.listdir(
                os.path.join(tmp, "bkt")))
        t_index = run_cli(["index", "-r", fa])
        out = os.path.join(tmp, "out.sam")
        t_cold, _ = run_cli_stages(["align", "-r", fa, "-x", "-d",
                                    "-o", out, *buckets])
        t_warm, st_warm = run_cli_stages(["align", "-r", fa, "-x", "-d",
                                          "-o", out, *buckets])
        import glob as _g
        n_rec = 0
        for p in _g.glob(out + "*"):
            if not os.path.isfile(p):
                continue
            n_rec += sum(1 for ln in open(p) if not ln.startswith("@"))
        assert n_rec >= 2 * len(ids), (n_rec, len(ids))
        write_artifact({
            "metric": "align_multibucket_pairs_per_sec",
            "value": round(len(ids) / t_warm, 1),
            "unit": "pairs/s",
            "n_buckets": len(buckets),
            "n_pairs": len(ids),
            "genome_bp": genome_bp,
            "index_build_s": round(t_index, 1),
            "align_warm_wall_s": round(t_warm, 1),
            "align_cold_wall_s": round(t_cold, 1),
            "compile_s_est": round(max(t_cold - t_warm, 0.0), 1),
            "cold_pairs_per_sec": round(len(ids) / t_cold, 1),
            "device": st_warm.get("device", "unknown"),
            "note": ("GRCh38-scale config scaled to one run: "
                     "-x bucket mode with default small-bucket "
                     "coalescing and -d density optimization; index "
                     "built once, warm run uses the persistent XLA "
                     "compilation cache"),
        }, out_json)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=["config3", "config4"])
    ap.add_argument("--genome", type=int, default=None)
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--buckets", type=int, default=500)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    a = ap.parse_args()
    if a.which == "config3":
        config3(a.genome or 32_000_000, a.pairs, a.out)
    else:
        config4(a.buckets, a.pairs, a.genome or 8_000_000, a.out)


if __name__ == "__main__":
    main()
