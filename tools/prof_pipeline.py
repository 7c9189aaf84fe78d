"""True per-stage walls: full align pass with inflight_chunks=1 on CPU.

With one chunk worker, stage timers measure real wall (no time-slice
inflation).  EMA_TPU_SEEDING=greedy|smem picks the seeder.
"""
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, ".")

from tests.simulate import rand_genome, simulate_pairs, to_str  # noqa: E402

import dataclasses  # noqa: E402

from ema_tpu import config  # noqa: E402
from ema_tpu.core.pipeline import Aligner, ReadBatch  # noqa: E402
from ema_tpu.index import build_index  # noqa: E402
from ema_tpu.utils.metrics import Metrics  # noqa: E402

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

seeding = os.environ.get("EMA_TPU_SEEDING") or None
cfg = config.RunConfig(inflight_chunks=1)
if seeding:
    cfg = dataclasses.replace(
        cfg, aligner=dataclasses.replace(cfg.aligner, seeding=seeding))
aligner = Aligner(idx, cfg)

batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
t0 = time.time()
aligner.align_batch_to_sam(batch)
print(f"warmup: {time.time()-t0:.1f}s", file=sys.stderr)

met = Metrics()
aligner.metrics = met
best = float("inf")
for k in range(3):
    t0 = time.time()
    aligner.align_batch_to_sam(batch)
    best = min(best, time.time() - t0)
    print(f"pass {k}: {time.time()-t0:.2f}s", file=sys.stderr)
print(f"best: {best:.2f}s = {n_pairs/best:.0f} pairs/s "
      f"(seeding={aligner.cfg.aligner.seeding})")
met.report()
