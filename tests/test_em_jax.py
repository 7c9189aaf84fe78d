"""Device EM (em_jax) vs host EM (groups.py numpy) equivalence."""

import numpy as np
import pytest

from ema_tpu import config
from ema_tpu.core import groups
from ema_tpu.core.em_jax import normalize_log_probs_jnp
from ema_tpu.core.records import empty_records
from ema_tpu.utils.logprobs import normalize_log_probs_batch


def test_normalize_log_probs_jnp_matches_numpy():
    rng = np.random.default_rng(0)
    p = -rng.random((20, 7)) * 30
    mask = rng.random((20, 7)) < 0.7
    mask[0] = False                      # empty row
    mask[1] = False
    mask[1, 3] = True                    # single-candidate row
    got = np.asarray(normalize_log_probs_jnp(p, mask))
    want = normalize_log_probs_batch(p, mask)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


def _synthetic_group(rng, n_pairs=40, profile=None):
    """Build a RECORD_DTYPE group with clouds, mates and multimaps."""
    profile = profile or config.get_platform_profile("10x")
    rows = []
    idents = []
    base_positions = rng.integers(1, 5, 4).cumsum() * 100_000
    for p in range(n_pairs):
        cluster = int(rng.integers(0, len(base_positions)))
        anchor = int(base_positions[cluster]) + int(rng.integers(0, 20_000))
        for mate in (0, 1):
            n_cand = int(rng.integers(1, 4))
            for c in range(n_cand):
                pos = anchor + (200 if mate else 0) + c * int(
                    rng.integers(0, 2_000_000, 1)[0] if c else 0)
                rows.append((p, mate, 0, max(pos, 1),
                             int(rng.integers(0, 2)),
                             -float(rng.random() * 8)))
                idents.append(f"r{p}")
    recs = empty_records(len(rows))
    for i, (p, mate, chrom, pos, rev, score) in enumerate(rows):
        recs["pair"][i] = p
        recs["mate"][i] = mate
        recs["chrom"][i] = chrom
        recs["pos"][i] = pos
        recs["rev"][i] = rev
        recs["score"][i] = score
        recs["bc"][i] = 42
    return recs, np.array(idents, dtype=object), profile


@pytest.mark.parametrize("platform", ["10x", "tru"])
def test_device_em_matches_host(platform):
    rng = np.random.default_rng(3)
    profile = config.get_platform_profile(platform)
    recs, idents, _ = _synthetic_group(rng, n_pairs=45, profile=profile)

    host = groups.process_barcode_group(
        recs.copy(), idents.copy(), profile, n_pairs_in_group=45,
        use_device_em=False)
    dev = groups.process_barcode_group(
        recs.copy(), idents.copy(), profile, n_pairs_in_group=45,
        use_device_em=True)

    np.testing.assert_allclose(dev.gamma, host.gamma, rtol=1e-9, atol=1e-12)
    assert dev.emit_pairs == host.emit_pairs
    np.testing.assert_array_equal(dev.cloud_id, host.cloud_id)
    np.testing.assert_array_equal(dev.records["duplicate"],
                                  host.records["duplicate"])


def test_em_run_batched_groups_match_single():
    """em_run over a [G, E, C] batch == per-group runs (padding safety)."""
    import jax.numpy as jnp

    from ema_tpu.core import em_jax

    rng = np.random.default_rng(4)
    G, E, C, NC = 3, 10, 4, 12
    sh = (G, E, C)
    mate = (np.arange(E)[None, :] ^ 1).astype(np.int32) \
        * np.ones((G, 1), np.int32)
    kw = dict(
        score=-rng.random(sh) * 12,
        cmask=rng.random(sh) < 0.7,
        active=np.ones(sh, bool),
        cand_cloud=rng.integers(0, NC, sh).astype(np.int32),
        rec_chrom=rng.integers(0, 2, sh).astype(np.int32),
        rec_pos=rng.integers(1, 5_000, sh).astype(np.int32),
        rec_rev=rng.integers(0, 2, sh).astype(np.int32),
        mate_entry=mate,
        emask=np.ones((G, E), bool),
        comp=np.broadcast_to(np.arange(NC, dtype=np.int32), (G, NC)).copy(),
        run_em=np.ones(G, bool),
    )
    kw["cmask"][:, :, 0] = True          # every entry has >=1 candidate
    batched = em_jax.em_run(
        em_jax.EMInputs(**{k: jnp.asarray(v) for k, v in kw.items()}))
    for g in range(G):
        single = em_jax.em_run(em_jax.EMInputs(
            **{k: jnp.asarray(np.asarray(v)[g:g + 1]) for k, v in kw.items()}))
        np.testing.assert_allclose(np.asarray(batched[0])[g],
                                   np.asarray(single[0])[0], rtol=1e-12)


def test_device_em_small_group_skips_em():
    rng = np.random.default_rng(9)
    recs, idents, profile = _synthetic_group(rng, n_pairs=5)
    host = groups.process_barcode_group(
        recs.copy(), idents.copy(), profile, n_pairs_in_group=5,
        use_device_em=False)
    dev = groups.process_barcode_group(
        recs.copy(), idents.copy(), profile, n_pairs_in_group=5,
        use_device_em=True)
    np.testing.assert_allclose(dev.gamma, host.gamma, rtol=1e-12)
    assert dev.emit_pairs == host.emit_pairs


@pytest.mark.parametrize("platform", ["10x", "tru"])
def test_native_flat_em_matches_numpy(platform):
    """C++ em_run_flat (deep-candidate path) == numpy run_em_host."""
    rng = np.random.default_rng(11)
    profile = config.get_platform_profile(platform)
    recs, idents, _ = _synthetic_group(rng, n_pairs=45, profile=profile)
    st_np = groups.sweep_group(recs.copy(), idents, profile)
    st_cc = groups.sweep_group(recs.copy(), idents, profile)
    assert st_np.needs_em
    assert st_np.cmask.shape[1] <= groups.EM_NATIVE_C  # numpy path is real
    groups.run_em_host(st_np)
    groups.run_em_native(st_cc)
    np.testing.assert_allclose(st_cc.gammas, st_np.gammas,
                               rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(st_cc.weights, st_np.weights,
                               rtol=1e-12, atol=1e-300)


def test_deep_candidate_group_em_bounded_memory():
    """A group whose entries hold ~1500 candidates each must run EM in
    linear memory (the vectorized [C, C] mate term would allocate
    gigabytes) and still concentrate gamma via cloud weights."""
    n_cand = 1500
    n_anchor = 40
    rows = []
    idents = []
    for p in range(n_anchor):            # unique anchor pairs in cloud 0
        for mate in (0, 1):
            rows.append((p, mate, 0, 1000 + 60 * p + 200 * mate,
                         mate, -1.0))
            idents.append(f"a{p}")
    # one deep pair: candidates at 1 Mb spacing (each its own cloud),
    # first candidate inside the anchor cloud
    for mate in (0, 1):
        for c in range(n_cand):
            rows.append((n_anchor, mate, 0,
                         1500 + 200 * mate + c * 1_000_000, mate, -1.0))
            idents.append("deep")
    recs = empty_records(len(rows))
    for i, (p, mate, chrom, pos, rev, score) in enumerate(rows):
        recs["pair"][i] = p
        recs["mate"][i] = mate
        recs["chrom"][i] = chrom
        recs["pos"][i] = pos
        recs["rev"][i] = rev
        recs["score"][i] = score
        recs["bc"][i] = 9
    res = groups.process_barcode_group(
        recs, np.array(idents, dtype=object),
        config.get_platform_profile("10x"))
    R = res.records
    deep_best = [a for a, b in res.emit_pairs
                 if str(res.idents[a]) == "deep"] + \
                [b for a, b in res.emit_pairs
                 if b >= 0 and str(res.idents[b]) == "deep"]
    assert deep_best
    for i in deep_best:
        assert R["pos"][i] < 10_000       # the in-cloud copy wins
        assert res.gamma[i] > 0.9


@pytest.mark.parametrize("platform", ["10x", "tru"])
def test_sweep_fast_path_matches_loop(monkeypatch, platform):
    """The vectorized collision-free sweep == the per-record loop."""
    rng = np.random.default_rng(19)
    profile = config.get_platform_profile(platform)
    recs, idents, _ = _synthetic_group(rng, n_pairs=60, profile=profile)
    st_fast = groups.sweep_group(recs.copy(), idents, profile)
    monkeypatch.setattr(groups, "_sweep_fast", lambda R, p: None)
    st_loop = groups.sweep_group(recs.copy(), idents, profile)
    assert st_fast.n_entries == st_loop.n_entries
    assert st_fast.n_clouds == st_loop.n_clouds
    np.testing.assert_array_equal(st_fast.cand_rec, st_loop.cand_rec)
    np.testing.assert_array_equal(st_fast.cand_cloud, st_loop.cand_cloud)
    np.testing.assert_array_equal(st_fast.cmask, st_loop.cmask)
    np.testing.assert_array_equal(st_fast.mate_entry, st_loop.mate_entry)
    np.testing.assert_array_equal(st_fast.gammas, st_loop.gammas)
    np.testing.assert_array_equal(st_fast.weights, st_loop.weights)
    # components may be labeled by different roots but must partition
    # the clouds identically
    def canon(comp):
        _, inv = np.unique(comp, return_inverse=True)
        return inv
    np.testing.assert_array_equal(canon(st_fast.comp), canon(st_loop.comp))


def test_sweep_collision_falls_back():
    """A same-cloud duplicate (bad cloud) must take the loop path and
    mark the cloud bad."""
    rows = [(0, 0, 0, 1000, 0, -1.0), (0, 1, 0, 1300, 1, -1.0),
            (1, 0, 0, 1500, 0, -1.0), (1, 0, 0, 1800, 0, -1.5)]
    recs = empty_records(len(rows))
    idents = []
    for i, (p, mate, chrom, pos, rev, score) in enumerate(rows):
        recs["pair"][i] = p
        recs["mate"][i] = mate
        recs["chrom"][i] = chrom
        recs["pos"][i] = pos
        recs["rev"][i] = rev
        recs["score"][i] = score
        idents.append(f"r{p}")
    st = groups.sweep_group(recs, np.array(idents, dtype=object),
                            config.get_platform_profile("10x"))
    assert st.cloud_bad[0] == 1


def test_em_cpu_placement_equivalent():
    """The pipeline's EM placements emit the same SAM: the jitted EM on
    the default device (float64 whatever the x64 setting) and the host
    numpy/C++ EM (RunConfig(device_em=False))."""
    import jax
    import numpy as np

    from tests.simulate import rand_genome, simulate_pairs, to_str
    from ema_tpu import config
    from ema_tpu.core.pipeline import Aligner, ReadBatch
    from ema_tpu.index import build_index

    rng = np.random.default_rng(33)
    genome = rand_genome(rng, 60_000)
    idx = build_index({"c1": genome})
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
        rng, to_str(genome), n_barcodes=3, frags_per_bc=(1, 2),
        pairs_per_frag=(16, 22), frag_len=9_000, read_len=80, err=0.003)
    batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)

    def sam(device_em):
        al = Aligner(idx, config.RunConfig(device_em=device_em))
        assert al.cfg.device_em == (device_em is not False)
        return al.align_batch_to_sam(batch)

    base = sam(False)
    assert sam(None) == base
    with jax.enable_x64(False):
        assert sam(None) == base
    assert len(base) == 2 * len(ids)
