"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Asserts the sharded candidate step (shard_map over ('data','cand')) equals
the single-device program, mirroring SURVEY.md §4's "shard-merge ==
single-host result" requirement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ema_tpu.index import build_index, fmindex
from ema_tpu.parallel import make_mesh, make_sharded_candidate_step
from ema_tpu.parallel.step import candidate_core

STATIC = dict(max_seeds=4, window_pad=12, min_seed_len=19)


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(5)
    contigs = {"c1": rng.integers(0, 4, 6000).astype(np.uint8)}
    idx = build_index(contigs, sa_rate=8)
    fm = fmindex.FMIndexArrays.from_index(idx)
    text = jnp.asarray(idx.text)

    n_reads, L = 16, 80
    starts = rng.integers(0, idx.n - L, n_reads)
    reads = np.stack([idx.text[s:s + L] for s in starts]).astype(np.int32)
    mut = rng.random((n_reads, L)) < 0.01
    reads = np.where(mut, rng.integers(0, 4, reads.shape), reads)
    lens = np.full(n_reads, L, np.int32)
    return idx, fm, text, jnp.asarray(reads), jnp.asarray(lens), starts


@pytest.mark.parametrize("n_data,n_cand", [(8, 1), (4, 2), (2, 4)])
def test_sharded_equals_single_device(toy, n_data, n_cand):
    idx, fm, text, reads, lens, starts = toy
    k_total = 8
    single_best, single_gpos = candidate_core(
        fm, text, reads, lens, 0,
        hits_per_seed=k_total, n_cand_shards=1, **STATIC)

    mesh = make_mesh(n_data, n_cand)
    step = make_sharded_candidate_step(
        mesh, fm, text, hits_per_seed=k_total // n_cand, **STATIC)
    out = step(reads, lens)

    np.testing.assert_array_equal(np.asarray(out.best_score),
                                  np.asarray(single_best))
    np.testing.assert_array_equal(np.asarray(out.best_gpos),
                                  np.asarray(single_gpos))
    # psum stats match host-side reductions
    b = np.asarray(single_best)
    assert int(out.n_aligned) == int((b > 0).sum())
    assert int(out.sum_score) == int(b[b > 0].sum())


def test_step_finds_true_positions(toy):
    idx, fm, text, reads, lens, starts = toy
    mesh = make_mesh(4, 2)
    step = make_sharded_candidate_step(mesh, fm, text,
                                       hits_per_seed=4, **STATIC)
    out = step(reads, lens)
    gpos = np.asarray(out.best_gpos)
    score = np.asarray(out.best_score)
    L = int(lens[0])
    hit = np.abs((gpos + STATIC["window_pad"]) - starts) <= STATIC["window_pad"]
    assert (score > 0.8 * L).mean() >= 0.8
    assert hit[score > 0.8 * L].mean() >= 0.9


def test_full_pipeline_meshed_sam_equality():
    """The REAL Aligner on the virtual 8-device mesh emits exactly the
    single-device SAM (chaining, traceback, EM, selection, emission all
    sharded) — the pytest twin of __graft_entry__.dryrun_multichip's
    half 3 (VERDICT r3 #3)."""
    import os

    from tests.simulate import rand_genome, simulate_pairs, to_str
    from ema_tpu import config
    from ema_tpu.core.pipeline import Aligner, ReadBatch
    from ema_tpu.index import build_index

    saved = {k: os.environ.get(k)
             for k in ("EMA_TPU_SW_IMPL", "EMA_TPU_SEED_IMPL")}
    os.environ["EMA_TPU_SW_IMPL"] = "banded"
    os.environ["EMA_TPU_SEED_IMPL"] = "device"
    try:
        rng = np.random.default_rng(29)
        genome = rand_genome(rng, 80_000)
        idx = build_index({"chr1": genome})
        ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
            rng, to_str(genome), n_barcodes=4, frags_per_bc=(2, 3),
            pairs_per_frag=(12, 20), frag_len=12_000, read_len=100,
            err=0.003)
        batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)

        meshed = Aligner(idx, config.RunConfig())
        assert meshed._data_sharding is not None \
            and meshed._data_sharding.mesh.size > 1
        single = Aligner(idx, config.RunConfig(data_parallel_chips=False))
        assert single._data_sharding is None

        sam_m = meshed.align_batch_to_sam(batch)
        sam_s = single.align_batch_to_sam(batch)
        assert sam_m == sam_s
        assert len(sam_m) >= 2 * len(ids)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_meshed_aligners_share_one_launch_lock():
    """Meshed programs hold collectives that every device must run in one
    order, so every meshed Aligner in the process (a ShardedAligner's
    per-shard Aligners too) launches device programs under one lock;
    a one-device Aligner takes none."""
    from ema_tpu import config
    from ema_tpu.core import pipeline
    from ema_tpu.index import build_index

    idx = build_index({"c": np.random.default_rng(3).integers(
        0, 4, 5000).astype(np.uint8)})
    a, b = (pipeline.Aligner(idx, config.RunConfig()) for _ in range(2))
    assert a._data_sharding is not None
    assert a._dev_lock is b._dev_lock is pipeline._MESH_LOCK
    single = pipeline.Aligner(idx, config.RunConfig(data_parallel_chips=False))
    assert single._dev_lock is not pipeline._MESH_LOCK


@pytest.mark.slow
def test_full_pipeline_meshed_sam_equality_bench_scale():
    """Bench-world-scale twin of dryrun_multichip half 3 (VERDICT r4 #5):
    >=10k records, diverged repeat families (multi-chain clouds), and the
    -d density optimizer ON — the collision/bad-cloud and split paths run
    under sharding and must emit the exact single-device SAM."""
    import __graft_entry__ as ge

    n_rec = ge._dryrun_full_pipeline(8)
    assert n_rec >= 10_000, n_rec
