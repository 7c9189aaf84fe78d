"""Profile smem_seed_batch round-by-round on the bench.py world.

Round isolation via parameters (no code changes):
  round 1 only        split_width=0, max_mem_intv=0
  rounds 1+2          max_mem_intv=0
  rounds 1+2+3        defaults
Plus greedy_seed_batch for the old-default comparison.
"""
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, ".")

from tests.simulate import rand_genome, simulate_pairs, to_str  # noqa: E402

from ema_tpu import native  # noqa: E402
from ema_tpu.index import build_index  # noqa: E402

GENOME = 3_000_000
N_PAIRS = 50_000
READ_LEN = 100

rng = np.random.default_rng(2026)
genome = rand_genome(rng, GENOME)
genome_str = to_str(genome)
idx = build_index({"chr1": genome})
n_bc = max(N_PAIRS // 60, 1)
ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
    rng, genome_str, n_barcodes=n_bc, frags_per_bc=(2, 4),
    pairs_per_frag=(15, 25), frag_len=30_000, read_len=READ_LEN,
    err=0.003)
n_pairs = len(ids)
print(f"{n_pairs} pairs", file=sys.stderr)

# codes like ReadBatch.from_pairs would build them
LUT = np.full(256, 4, np.uint8)
for i, ch in enumerate("ACGT"):
    LUT[ord(ch)] = i
    LUT[ord(ch.lower())] = i


def to_codes(seqs):
    B = len(seqs)
    L = max(len(s) for s in seqs)
    out = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s.encode(), np.uint8)
        out[i, :len(b)] = LUT[b]
        lens[i] = len(b)
    return out, lens


codes1, lens1 = to_codes(s1)
codes2, lens2 = to_codes(s2)
codes = np.concatenate([codes1, codes2])
lens = np.concatenate([lens1, lens2])
print(f"{codes.shape[0]} reads", file=sys.stderr)

t0 = time.time()
ktab = native.smem_kmer_table(idx.occ_blocks, idx.counts, idx.primary,
                              idx.fm_n, k=10)
print(f"ktab: {time.time()-t0:.2f}s", file=sys.stderr)

args = (idx.occ_blocks, idx.counts, idx.primary, idx.fm_n, codes, lens)


def run(label, **kw):
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        out = native.smem_seed_batch(*args, n_threads=1, **kw)
        best = min(best, time.time() - t0)
    n = codes.shape[0]
    print(f"{label:28s} {best:6.2f}s  {n/best/1e3:7.1f}k reads/s  "
          f"mean_seeds={out[4].mean():.2f}")
    return best


t0 = time.time()
g = native.greedy_seed_batch(*args, min_seed_len=19, max_seeds=16,
                             n_threads=1)
tg = time.time() - t0
n = codes.shape[0]
print(f"{'greedy (old default)':28s} {tg:6.2f}s  {n/tg/1e3:7.1f}k reads/s  "
      f"mean_seeds={g[4].mean():.2f}")

run("smem r1 only", split_width=0, max_mem_intv=0)
run("smem r1+r2", max_mem_intv=0)
run("smem r1+r2+r3 (no ktab)")
run("smem r1+r2+r3 (ktab k10)", kmer_tab=ktab)
