"""In-process A/B benchmark for align-pipeline configurations.

Holds the dataset and the process fixed and *alternates timed passes*
between configurations, so both sides of a comparison see the same
machine state (one process, so one JAX client per card).

Usage:
    python tools/ab_align.py devem hostem            # device vs host EM
    python tools/ab_align.py banded native           # SW on device vs host
    python tools/ab_align.py greedy smem             # seeding strategies
    python tools/ab_align.py b4096 b8192             # chunk sizes
    EMA_TPU_AB_REPS=4 python tools/ab_align.py ...   # passes per config

Prints one line per config with all pass times and the median, then a
JSON summary line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

GENOME = 3_000_000
N_PAIRS = 50_000
READ_LEN = 100


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


SPECS = {
    "devem": dict(device_em=True),
    "hostem": dict(device_em=False),
    "banded": dict(sw="banded"),
    "scan": dict(sw="scan"),
    "native": dict(sw="native"),
    "greedy": dict(seeding="greedy"),
    "smem": dict(seeding="smem"),
    "seednat": dict(seed_impl="native"),    # host C++ greedy seed+locate
    "seeddev": dict(seed_impl="device"),    # fused XLA seed_locate_reads
    "default": dict(),
}


def make_aligner(idx, name: str):
    from ema_tpu import config
    from ema_tpu.core.pipeline import Aligner

    # "+"-combined specs: e.g. seeddev+t6+b8192
    spec = {}
    for part in name.split("+"):
        if part in SPECS:
            spec.update(SPECS[part])
        elif part.startswith("b") and part[1:].isdigit():
            spec["batch"] = int(part[1:])
        elif part.startswith("t") and part[1:].isdigit():
            spec["inflight"] = int(part[1:])
        else:
            raise SystemExit(f"unknown config spec: {part}")
    kw = {}
    if "device_em" in spec:
        kw["device_em"] = spec["device_em"]
    if "batch" in spec:
        kw["batch_size"] = spec["batch"]
    if "inflight" in spec:
        kw["inflight_chunks"] = spec["inflight"]
    ap = config.DEFAULT_ALIGNER_PARAMS
    if "seeding" in spec:
        ap = dataclasses.replace(ap, seeding=spec["seeding"])
    cfg = config.RunConfig(aligner=ap, **kw)
    saved = {}
    for env_key, spec_key in (("EMA_TPU_SW_IMPL", "sw"),
                              ("EMA_TPU_SEED_IMPL", "seed_impl")):
        saved[env_key] = os.environ.pop(env_key, None)
        if spec_key in spec:
            os.environ[env_key] = spec[spec_key]
    try:
        return Aligner(idx, cfg)
    finally:
        for env_key, old in saved.items():
            os.environ.pop(env_key, None)
            if old is not None:
                os.environ[env_key] = old


def main() -> None:
    names = sys.argv[1:] or ["devem", "hostem"]
    reps = int(os.environ.get("EMA_TPU_AB_REPS", "3"))
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tests.simulate import rand_genome, simulate_pairs, to_str

    import jax

    from ema_tpu.core.pipeline import ReadBatch
    from ema_tpu.index import build_index
    from ema_tpu.utils.backend import describe_devices, ensure_backend

    ensure_backend()
    log(f"devices: {describe_devices()}")

    rng = np.random.default_rng(2026)
    genome = rand_genome(rng, GENOME)
    idx = build_index({"chr1": genome})
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
        rng, to_str(genome), n_barcodes=max(N_PAIRS // 60, 1),
        frags_per_bc=(2, 4), pairs_per_frag=(15, 25), frag_len=30_000,
        read_len=READ_LEN, err=0.003)
    n_pairs = len(ids)
    log(f"{n_pairs} pairs; configs={names} reps={reps}")

    aligners = {n: make_aligner(idx, n) for n in names}

    def one_pass(al) -> float:
        batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
        t0 = time.time()
        n = len(al.align_batch_to_sam(batch))
        dt = time.time() - t0
        assert n == 2 * n_pairs
        return dt

    check_equal = os.environ.get("EMA_TPU_AB_CHECK_EQUAL") == "1"
    sams = {}
    for n, al in aligners.items():
        t0 = time.time()
        if check_equal:
            batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
            sams[n] = al.align_batch_to_sam(batch)
        else:
            one_pass(al)
        log(f"warmup[{n}]: {time.time()-t0:.1f}s")
    if check_equal:
        base = sams[names[0]]
        for n in names[1:]:
            assert sams[n] == base, \
                f"SAM output differs between {names[0]} and {n}"
        log(f"SAM outputs identical across {names} "
            f"({len(base)} records)")

    times = {n: [] for n in names}
    for r in range(reps):
        for n in names:
            dt = one_pass(aligners[n])
            times[n].append(dt)
            log(f"rep{r} {n}: {dt:.2f}s ({n_pairs/dt:.0f} pairs/s)")

    summary = {}
    for n in names:
        med = float(np.median(times[n]))
        summary[n] = n_pairs / med
        log(f"{n}: passes {['%.2f' % t for t in times[n]]} "
            f"median {med:.2f}s = {n_pairs/med:.0f} pairs/s")
    dev = jax.devices()[0]
    print(json.dumps({"pairs_per_sec_median": summary,
                      "platform": dev.platform,
                      "device_kind": dev.device_kind}))


if __name__ == "__main__":
    main()
