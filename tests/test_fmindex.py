"""FM-index tests: rank/backward-search/locate/seeding vs brute force."""

import numpy as np
import pytest
import jax.numpy as jnp

from ema_tpu.index.build import build_index
from ema_tpu.index import fmindex as fm


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(3)
    text = rng.integers(0, 4, size=5000).astype(np.uint8)
    idx = build_index({"chr1": text})
    return idx, text


@pytest.fixture(scope="module")
def fma(small_index):
    idx, _ = small_index
    return fm.FMIndexArrays.from_index(idx)


def all_occurrences(text, pat):
    n, m = len(text), len(pat)
    hits = [i for i in range(n - m + 1) if (text[i:i + m] == pat).all()]
    return sorted(hits)


class TestBackwardSearch:
    def test_find_all_occurrences(self, small_index, fma):
        # the FM text packs both strands: occurrences are found in the
        # concatenated fw+rc text (upper half = reverse strand)
        idx, text = small_index
        text2 = np.concatenate([text, (3 - text)[::-1]])
        rng = np.random.default_rng(4)
        for trial in range(20):
            m = int(rng.integers(3, 15))
            start = int(rng.integers(0, len(text) - m))
            pat = text[start:start + m]

            lo = jnp.zeros((1,), jnp.int32)
            hi = jnp.full((1,), idx.fm_n + 1, jnp.int32)
            for c in pat[::-1]:
                lo, hi = fm.extend_backward(fma, lo, hi, jnp.full((1,), c, jnp.int32))
            width = int(hi[0] - lo[0])
            expected = all_occurrences(text2, pat)
            assert width == len(expected)

            rows = jnp.arange(int(lo[0]), int(hi[0]), dtype=jnp.int32)
            pos = sorted(np.asarray(fm.locate(fma, rows)).tolist())
            assert pos == expected

    def test_absent_pattern(self, small_index, fma):
        idx, text = small_index
        # pattern longer than any repeat and random: overwhelmingly absent
        pat = np.array([0, 1, 2, 3] * 8, dtype=np.uint8)
        if all_occurrences(text, pat):
            pytest.skip("random text contained the probe")
        lo = jnp.zeros((1,), jnp.int32)
        hi = jnp.full((1,), idx.fm_n + 1, jnp.int32)
        for c in pat[::-1]:
            lo, hi = fm.extend_backward(fma, lo, hi, jnp.full((1,), c, jnp.int32))
        assert int(hi[0]) <= int(lo[0])


class TestLocate:
    def test_all_rows(self, small_index, fma):
        idx, text = small_index
        # locate of every BWT row must be a permutation of 0..fm_n (2n)
        rows = jnp.arange(idx.fm_n + 1, dtype=jnp.int32)
        pos = np.sort(np.asarray(fm.locate(fma, rows)))
        np.testing.assert_array_equal(pos, np.arange(idx.fm_n + 1))


class TestSeeding:
    def test_perfect_read_single_seed(self, small_index, fma):
        idx, text = small_index
        L = 80
        reads = np.stack([text[100:100 + L], text[777:777 + L]])
        s_lo, s_hi, s_qb, s_len, n_seeds = fm.seed_reads(
            fma, jnp.asarray(reads), jnp.full((2,), L, jnp.int32))
        n_seeds = np.asarray(n_seeds)
        for b, start in enumerate((100, 777)):
            assert n_seeds[b] >= 1
            # the first emitted seed is the longest suffix-anchored match;
            # a unique perfect read yields one full-length seed
            qb = int(np.asarray(s_qb)[b, 0])
            ln = int(np.asarray(s_len)[b, 0])
            assert qb == 0 and ln == L
            rows = np.asarray(s_lo)[b, 0] + np.arange(
                np.asarray(s_hi)[b, 0] - np.asarray(s_lo)[b, 0])
            pos = np.asarray(fm.locate(fma, jnp.asarray(rows, jnp.int32)))
            assert start in pos.tolist()

    def test_read_with_center_mismatch_two_seeds(self, small_index, fma):
        idx, text = small_index
        L = 80
        read = text[1000:1000 + L].copy()
        read[40] = (read[40] + 1) % 4
        s_lo, s_hi, s_qb, s_len, n_seeds = fm.seed_reads(
            fma, jnp.asarray(read[None]), jnp.full((1,), L, jnp.int32))
        qbs = np.asarray(s_qb)[0][:int(n_seeds[0])]
        lens = np.asarray(s_len)[0][:int(n_seeds[0])]
        # expect a right seed covering [41, 80) and a left-anchored seed
        # (greedy chop may lose a few bases to a spurious restart around the
        # mismatch — extension DP recovers them; true SMEMs would give [0,40))
        spans = sorted(zip(qbs.tolist(), lens.tolist()))
        assert any(q == 41 and l == 39 for q, l in spans)
        assert any(q == 0 and l >= 19 for q, l in spans)

    def test_n_bases_break_seeds(self, small_index, fma):
        idx, text = small_index
        read = text[2000:2060].copy().astype(np.int32)
        read[30] = 4  # N
        s_lo, s_hi, s_qb, s_len, n_seeds = fm.seed_reads(
            fma, jnp.asarray(read[None]), jnp.full((1,), 60, jnp.int32))
        qbs = np.asarray(s_qb)[0][:int(n_seeds[0])]
        lens = np.asarray(s_len)[0][:int(n_seeds[0])]
        for q, l in zip(qbs, lens):
            assert not (q <= 30 < q + l)

    def test_expand_hits_cap(self):
        lo = jnp.array([10], jnp.int32)
        hi = jnp.array([500], jnp.int32)
        rows, valid = fm.expand_seed_hits(lo, hi, 8)
        assert valid.all()
        r = np.asarray(rows)[0]
        assert r[0] == 10 and (np.diff(r) > 0).all() and r[-1] < 500


class TestSeedingCompleteness:
    """Property: every error-free read drawn from the text produces at
    least one seed hit at its true position (across random lengths,
    positions, and strand via caller-side revcomp)."""

    def test_random_substring_always_seeded(self):
        import jax.numpy as jnp

        from ema_tpu.index import build_index
        from ema_tpu.index import fmindex as fm_mod

        rng = np.random.default_rng(123)
        text = rng.integers(0, 4, 30_000).astype(np.uint8)
        idx = build_index({"c": text})
        fma = fm_mod.FMIndexArrays.from_index(idx)

        B = 64
        lens = rng.integers(19, 140, B).astype(np.int32)
        starts = np.array([rng.integers(0, idx.n - L) for L in lens])
        L = int(lens.max())
        reads = np.full((B, L), 4, np.uint8)
        for i in range(B):
            reads[i, :lens[i]] = idx.text[starts[i]:starts[i] + lens[i]]

        s_lo, s_hi, s_qb, s_len, n_seeds = fm_mod.seed_reads(
            fma, jnp.asarray(reads.astype(np.int32)), jnp.asarray(lens),
            max_seeds=16, min_seed_len=19)
        rows, valid = fm_mod.expand_seed_hits(s_lo, s_hi, 32)
        pos = np.asarray(fm_mod.locate(fma, rows))
        valid = np.asarray(valid)
        qb = np.asarray(s_qb)
        for i in range(B):
            hit_starts = (pos[i] - qb[i][:, None])[valid[i]]
            assert starts[i] in hit_starts, (i, starts[i], lens[i])


class TestSeedLocateFused:
    """seed_locate_reads (one device program) must reproduce the
    two-step path (seed_reads -> _compact_seed_hits -> locate)
    value-for-value, including the even max_occ sampling and the
    overflow signal."""

    def _two_step(self, fma, codes, lens, max_hits):
        from ema_tpu.core.pipeline import (_compact_seed_hits,
                                           locate_rows_bucketed)
        s_lo, s_hi, s_qb, s_len, n_seeds = fm.seed_reads(
            fma, jnp.asarray(codes), jnp.asarray(lens),
            max_seeds=16, min_seed_len=19)
        stack = np.stack([np.asarray(a) for a in
                          (s_lo, s_hi, s_qb, s_len)]).astype(np.int64)
        nsd = np.asarray(n_seeds)
        owner, qb, slen, rows = _compact_seed_hits(stack, nsd, max_hits)
        pos = locate_rows_bucketed(fma, rows)
        return owner, qb, slen, pos

    def _check(self, genome, codes, lens, max_hits=3000, budget=4096):
        idx = build_index({"c": genome})
        fma = fm.FMIndexArrays.from_index(idx)
        packed, total, frac = fm.seed_locate_reads(
            fma, jnp.asarray(codes), jnp.asarray(lens),
            max_seeds=16, min_seed_len=19, max_hits=max_hits,
            budget=budget, max_occ=3000)
        owner, qb, slen, pos = self._two_step(fma, codes, lens, max_hits)
        total = int(total)
        assert total == owner.shape[0]
        assert total <= budget
        ph = np.asarray(packed)[:, :total]
        np.testing.assert_array_equal(ph[0], owner)
        np.testing.assert_array_equal(ph[1], qb)
        np.testing.assert_array_equal(ph[2], slen)
        np.testing.assert_array_equal(ph[3], pos)

    def test_random_reads_match_two_step(self):
        rng = np.random.default_rng(5)
        genome = rng.integers(0, 4, 20_000, dtype=np.uint8)
        B, L = 33, 80
        starts = rng.integers(0, genome.shape[0] - L, B)
        codes = np.stack([genome[s:s + L] for s in starts]).copy()
        # sprinkle mismatches + an all-N read + a short read
        for i in range(0, B, 3):
            codes[i, rng.integers(0, L)] = rng.integers(0, 4)
        codes[1] = 4
        lens = np.full(B, L, np.int32)
        lens[2] = 10
        self._check(genome, codes, lens)

    def test_repeat_capping_matches_two_step(self):
        rng = np.random.default_rng(6)
        unit = rng.integers(0, 4, 200, dtype=np.uint8)
        genome = np.tile(unit, 60)          # deep repeat: wide intervals
        codes = np.stack([unit[:64]] * 8)
        lens = np.full(8, 64, np.int32)
        # cap below the repeat depth: exercises the even sampling
        self._check(genome, codes, lens, max_hits=16, budget=4096)

    def test_overflow_reports_total_above_budget(self):
        rng = np.random.default_rng(7)
        unit = rng.integers(0, 4, 120, dtype=np.uint8)
        genome = np.tile(unit, 80)
        codes = np.stack([unit[:64]] * 16)
        lens = np.full(16, 64, np.int32)
        idx = build_index({"c": genome})
        fma = fm.FMIndexArrays.from_index(idx)
        packed, total, frac = fm.seed_locate_reads(
            fma, jnp.asarray(codes), jnp.asarray(lens),
            max_seeds=16, min_seed_len=19, max_hits=3000,
            budget=256, max_occ=3000)
        assert int(total) > 256     # caller must take the fallback path


class TestHostFM:
    """Host C++ greedy seeding + locate vs the device programs.

    The CPU-backend FM path (native.greedy_seed_batch / locate_batch)
    must be value-identical to index/fmindex.seed_reads / locate —
    pipeline.generate_candidates mixes them freely by backend.
    """

    def test_greedy_seed_equality(self, small_index, fma):
        from ema_tpu import native
        idx, text = small_index
        rng = np.random.default_rng(11)
        B, L = 128, 80
        starts = rng.integers(0, idx.n - L, B)
        codes = np.stack([text[s:s + L] for s in starts]).astype(np.int32)
        mut = rng.random((B, L)) < 0.03
        codes = np.where(mut, rng.integers(0, 5, (B, L)), codes)  # incl. N
        lens = rng.integers(20, L + 1, B).astype(np.int32)
        codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 4)

        dev = [np.asarray(x) for x in fm.seed_reads(
            fma, jnp.asarray(codes), jnp.asarray(lens),
            max_seeds=16, min_seed_len=19)]
        host = native.greedy_seed_batch(
            idx.occ_blocks, idx.counts, idx.primary, idx.fm_n,
            codes.astype(np.uint8), lens, min_seed_len=19, max_seeds=16)
        assert np.array_equal(dev[4], host[4])          # n_seeds
        live = np.arange(16)[None, :] < dev[4][:, None]
        for a, b in zip(dev[:4], host[:4]):
            assert np.array_equal(np.where(live, a, 0),
                                  np.where(live, b, 0))
        assert dev[4].sum() > 0

    def test_locate_equality(self, small_index, fma):
        from ema_tpu import native
        idx, _ = small_index
        rng = np.random.default_rng(12)
        rows = rng.integers(0, idx.fm_n + 1, 5000).astype(np.int64)
        dev = np.asarray(fm.locate(fma, jnp.asarray(rows))).astype(np.int64)
        host = native.locate_batch(idx, rows)
        assert np.array_equal(dev, host)

    def test_pipeline_sam_identical_across_seed_impls(self, monkeypatch):
        """End-to-end: EMA_TPU_SEED_IMPL=native == device, line for line."""
        from ema_tpu import config
        from ema_tpu.core.pipeline import Aligner, ReadBatch
        from tests.simulate import rand_genome, simulate_pairs, to_str

        rng = np.random.default_rng(13)
        genome = rand_genome(rng, 150_000)
        ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
            rng, to_str(genome), n_barcodes=8, frags_per_bc=(1, 2),
            pairs_per_frag=(8, 15), frag_len=15_000, read_len=90,
            err=0.004)
        idx = build_index({"chr1": genome})
        batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
        lines = {}
        for impl in ("native", "device"):
            monkeypatch.setenv("EMA_TPU_SEED_IMPL", impl)
            al = Aligner(idx, config.RunConfig(
                batch_size=512, seed=5,
                aligner=config.AlignerParams(seeding="greedy")))
            assert al.placement.host_fm == (impl == "native")
            lines[impl] = al.align_batch_to_sam(batch)
        assert lines["native"] == lines["device"]

    def test_greedy_seed_equality_deep_repeats(self):
        """Wide SA intervals keep lo/hi in different occ blocks — the
        occ2 fallback path — and exercise interval restarts."""
        from ema_tpu import native
        rng = np.random.default_rng(21)
        unit = rng.integers(0, 4, 150, dtype=np.uint8)
        genome = np.concatenate([np.tile(unit, 50),
                                 rng.integers(0, 4, 2000, dtype=np.uint8),
                                 np.tile(unit[:37], 40)])
        idx = build_index({"c": genome})
        fma = fm.FMIndexArrays.from_index(idx)
        B, L = 64, 100
        codes = np.stack([genome[s:s + L] for s in
                          rng.integers(0, idx.n - L, B)]).astype(np.int32)
        # homopolymer rows: maximal restart churn
        codes[0] = 0
        codes[1] = np.arange(L) % 2
        lens = np.full(B, L, np.int32)
        dev = [np.asarray(x) for x in fm.seed_reads(
            fma, jnp.asarray(codes), jnp.asarray(lens),
            max_seeds=16, min_seed_len=19)]
        host = native.greedy_seed_batch(
            idx.occ_blocks, idx.counts, idx.primary, idx.fm_n,
            codes.astype(np.uint8), lens, min_seed_len=19, max_seeds=16)
        assert np.array_equal(dev[4], host[4])
        live = np.arange(16)[None, :] < dev[4][:, None]
        for a, b in zip(dev[:4], host[:4]):
            assert np.array_equal(np.where(live, a, 0),
                                  np.where(live, b, 0))
