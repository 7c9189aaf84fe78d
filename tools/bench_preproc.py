"""BASELINE config-2 benchmark: count + preproc, ours vs the REAL
reference preprocessor.

The reference publishes no numbers (BASELINE.md), but its preprocessor
compiles standalone (tests/oracle builds cpp/count.cc + correct.cc behind
a tiny driver), so this stage's vs-reference ratio can be MEASURED, not
estimated: both stacks run on the same 4M-barcode-whitelist /
Hamming-2 / 50-bucket input (BASELINE.md config 2) and outputs are
asserted byte-identical before timing is reported.

Usage: python tools/bench_preproc.py [n_pairs] [wl_size]
Prints one JSON line:
  {"config": 2, "n_pairs": N, "ours": {...}, "reference": {...},
   "speedup_count": X, "speedup_preproc": Y}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BASES = np.frombuffer(b"ACGT", np.uint8)


def make_dataset(out_dir: str, n_pairs: int, wl_size: int, seed=7):
    """Vectorized 10x-style whitelist + interleaved FASTQ: ~10% H1
    errors, ~5% H2 errors, ~2% N-containing, ~3% off-whitelist."""
    rng = np.random.default_rng(seed)
    wl_codes = rng.integers(0, 4, (wl_size, 16)).astype(np.uint8)
    wl_codes = np.unique(BASES[wl_codes], axis=0)
    wl_path = os.path.join(out_dir, "wl.txt")
    with open(wl_path, "wb") as f:
        f.write(b"\n".join(row.tobytes() for row in wl_codes) + b"\n")

    pick = rng.integers(0, wl_codes.shape[0], n_pairs)
    bcs = wl_codes[pick].copy()
    kind = rng.random(n_pairs)
    # H1: one substitution
    h1 = kind < 0.10
    pos = rng.integers(0, 16, n_pairs)
    sub = BASES[rng.integers(0, 4, n_pairs)]
    rows = np.nonzero(h1)[0]
    bcs[rows, pos[rows]] = sub[rows]
    # H2: two substitutions
    h2 = (kind >= 0.10) & (kind < 0.15)
    rows = np.nonzero(h2)[0]
    for shift in (0, 5):
        p2 = (pos[rows] + shift) % 16
        bcs[rows, p2] = BASES[rng.integers(0, 4, rows.shape[0])]
    # N in barcode
    hn = (kind >= 0.15) & (kind < 0.17)
    rows = np.nonzero(hn)[0]
    bcs[rows, pos[rows]] = ord("N")
    # off-whitelist random
    off = (kind >= 0.17) & (kind < 0.20)
    rows = np.nonzero(off)[0]
    bcs[rows] = BASES[rng.integers(0, 4, (rows.shape[0], 16))]

    tail = BASES[rng.integers(0, 4, (n_pairs, 84))]
    r2 = BASES[rng.integers(0, 4, (n_pairs, 100))]
    q1 = np.full((n_pairs, 100), ord("I"), np.uint8)
    q2 = np.full((n_pairs, 100), ord("I"), np.uint8)

    fq_path = os.path.join(out_dir, "inter.fq")
    with open(fq_path, "wb") as f:
        chunk = []
        for i in range(n_pairs):
            r1 = bcs[i].tobytes() + tail[i].tobytes()
            chunk.append(b"@p%d\n%s\n+\n%s\n@p%d\n%s\n+\n%s\n" % (
                i, r1, q1[i].tobytes(), i, r2[i].tobytes(),
                q2[i].tobytes()))
            if len(chunk) >= 8192:
                f.write(b"".join(chunk))
                chunk = []
        f.write(b"".join(chunk))
    return wl_path, fq_path


def _prime(*paths):
    """Pull files into the page cache so every timed run sees the same
    I/O state (whoever runs after a churny stage would otherwise pay
    cold-disk reads the earlier runs didn't)."""
    for p in paths:
        with open(p, "rb") as f:
            while f.read(1 << 22):
                pass


def run_timed(cmd, stdin_path, env=None, prime=()):
    _prime(stdin_path, *prime)
    with open(stdin_path, "rb") as f:
        t0 = time.time()
        subprocess.run(cmd, stdin=f, check=True, env=env,
                       stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)
    return time.time() - t0


def tree_bytes(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def main():
    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    wl_size = int(sys.argv[2]) if len(sys.argv) > 2 else 4_000_000

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle import build_preproc_oracle
    oracle = build_preproc_oracle()
    assert oracle is not None, "reference tree unavailable"

    import tempfile
    with tempfile.TemporaryDirectory(prefix="bench_preproc_") as td:
        print(f":: generating {n_pairs} pairs / {wl_size} whitelist",
              file=sys.stderr)
        wl, fq = make_dataset(td, n_pairs, wl_size)

        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        # --- reference ---
        ref_cnt = os.path.join(td, "refcnt")
        t_ref_count = run_timed(
            [str(oracle), "count", wl, ref_cnt, "0"], fq, prime=(wl,))
        ref_out = os.path.join(td, "refout")
        os.makedirs(ref_out)
        t_ref_pre = run_timed(
            [str(oracle), "correct", wl, ref_out, "1", "0", "1", "50",
             "0", ref_cnt + ".ema-ncnt"], fq,
            prime=(wl, ref_cnt + ".ema-ncnt"))

        # --- ours ---
        # a fresh cache dir makes the first run genuinely cold (the
        # shared /tmp cache may hold this whitelist's map order from an
        # earlier bench invocation)
        cache = os.path.join(td, "cache")
        env = dict(env, EMA_TPU_CACHE_DIR=cache)
        # make sure the self-compiling native .so is current BEFORE timing:
        # a source change would otherwise bill one g++ build (~6 s) to the
        # first timed run (the reference's compile isn't timed either)
        subprocess.run(
            [sys.executable, "-c",
             "from ema_tpu import native; native.get_lib()"],
            check=True, env=env)
        our_cnt = os.path.join(td, "ourcnt")
        # primary timing: the official CLI launcher (bin/ema-tpu), run in
        # the AMBIENT environment — the launcher starts a -S interpreter
        # for jax-free subcommands, so ambient==clean by construction
        # (mirrors the reference's zero-interpreter-tax compiled binary)
        launcher = os.path.join(REPO, "bin", "ema-tpu")
        t_our_count = run_timed(
            [launcher, "count", "-w", wl, "-o", our_cnt], fq, env=env,
            prime=(wl,))
        # warm pass: the whitelist map-order disk cache is now populated
        # (every run after the first on a given whitelist pays this)
        t_our_count_warm = run_timed(
            [launcher, "count", "-w", wl, "-o", our_cnt], fq, env=env,
            prime=(wl,))
        # secondary: bare `python -m` in the ambient env (pays whatever
        # interpreter startup the site config imposes — recorded so the
        # launcher's saving is visible, not hidden)
        t_our_count_ambient = run_timed(
            [sys.executable, "-m", "ema_tpu.cli", "count", "-w", wl,
             "-o", our_cnt], fq, env=env, prime=(wl,))
        our_out = os.path.join(td, "ourout")
        os.makedirs(our_out)
        t_our_pre = run_timed(
            [launcher, "preproc", "-w", wl,
             "-o", our_out, "-n", "50", "-h", our_cnt + ".ema-ncnt"],
            fq, env=env, prime=(wl, our_cnt + ".ema-ncnt"))

        # --- byte parity before reporting any number ---
        for a, b in (((our_cnt + ".ema-ncnt"), (ref_cnt + ".ema-ncnt")),
                     ((our_cnt + ".ema-fcnt"), (ref_cnt + ".ema-fcnt"))):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f"count mismatch: {a}"
        ours_t, refs_t = tree_bytes(our_out), tree_bytes(ref_out)
        assert ours_t.keys() == refs_t.keys(), (
            sorted(ours_t), sorted(refs_t))
        for k in ours_t:
            assert ours_t[k] == refs_t[k], f"bucket mismatch: {k}"

        print(json.dumps({
            "config": 2,
            "n_pairs": n_pairs,
            "wl_size": wl_size,
            "byte_identical": True,
            "ours": {"count_s": round(t_our_count, 2),
                     "count_pym_ambient_s": round(t_our_count_ambient, 2),
                     "count_warm_s": round(t_our_count_warm, 2),
                     "preproc_s": round(t_our_pre, 2)},
            "env_note": ("count_s/preproc_s/count_warm_s time the official "
                         "bin/ema-tpu launcher in the AMBIENT environment "
                         "(the launcher runs jax-free subcommands under "
                         "python -S, so site-level ML-runtime imports are "
                         "skipped by design); count_pym_ambient_s is bare "
                         "`python -m ema_tpu.cli` in the same ambient env "
                         "and pays the site tax"),
            "reference": {"count_s": round(t_ref_count, 2),
                          "preproc_s": round(t_ref_pre, 2)},
            "speedup_count": round(t_ref_count / t_our_count, 3),
            "speedup_preproc": round(t_ref_pre / t_our_pre, 3),
        }))


if __name__ == "__main__":
    main()
