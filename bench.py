"""Align-stage benchmark: read pairs/sec on one GPU, in one process.

Simulates a 3 Mbp genome and ~50k barcoded 2x100 bp pairs (~60 per
barcode, so the EM gate engages), builds the FM index, then runs the
full align pipeline (seed -> chain -> SW -> EM -> SAM) once to compile
every shape and PASSES more times, timed.  Exits non-zero unless JAX's
default device is a GPU.

Prints the device and the passes on stderr, and ONE JSON line on stdout:
  {"metric": "align_read_pairs_per_sec", "value": <median>, ...}
with the median, min and max pairs/s over the timed passes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

GENOME = 3_000_000
N_PAIRS = 50_000
READ_LEN = 100
PASSES = 5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [repo, os.path.join(repo, "tests")]
    from ema_tpu import config
    from ema_tpu.core.pipeline import Aligner, ReadBatch
    from ema_tpu.index import build_index
    from ema_tpu.utils.backend import describe_devices, ensure_backend
    from simulate import rand_genome, simulate_pairs, to_str

    devs = ensure_backend()
    if devs[0].platform != "gpu":
        log(f"bench: needs a GPU; JAX found {describe_devices()}")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    log(f"bench: {describe_devices()}; nvidia-smi: {smi}")

    rng = np.random.default_rng(2026)
    genome = rand_genome(rng, GENOME)
    idx = build_index({"chr1": genome})
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
        rng, to_str(genome), n_barcodes=max(N_PAIRS // 60, 1),
        frags_per_bc=(2, 4), pairs_per_frag=(15, 25), frag_len=30_000,
        read_len=READ_LEN, err=0.003)
    n_pairs = len(ids)
    batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
    aligner = Aligner(idx, config.RunConfig())

    t0 = time.perf_counter()
    aligner.align_batch_to_sam(batch)
    log(f"warmup (compiles every shape): {time.perf_counter() - t0:.1f} s")
    rates = []
    for k in range(PASSES):
        t0 = time.perf_counter()
        aligner.align_batch_to_sam(batch)
        rates.append(n_pairs / (time.perf_counter() - t0))
        log(f"pass {k}: {rates[-1]:.1f} pairs/s")

    print(json.dumps({
        "metric": "align_read_pairs_per_sec",
        "value": float(np.median(rates)),
        "unit": "pairs/s",
        "min": min(rates),
        "max": max(rates),
        "passes": PASSES,
        "n_pairs": n_pairs,
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "nvidia_smi": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
