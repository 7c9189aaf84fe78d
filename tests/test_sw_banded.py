"""Banded row-sweep SW scorer vs the anti-diagonal scan and a numpy DP.

Two oracles:
  1. planted in-corridor alignments: the banded kernel must equal
     sw_score_batch exactly (the corridor covers every alignment the
     chaining window was built for);
  2. a direct numpy banded DP on random inputs (exact recurrences,
     including the max-plus prefix-scan equivalence for horizontal gaps).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ema_tpu.ops import sw


def _np_banded(reads, rlens, refs, nlens, W, match=1, mismatch=4,
               go=6, ge=1, clip=5):
    """Reference banded DP (cell-by-cell, with full E recurrence)."""
    B, m = reads.shape
    NEG = -(1 << 28)
    out = {k: np.zeros(B, np.int32) for k in ("score", "qb", "qe",
                                              "ref_end")}
    out["score"][:] = NEG
    for b in range(B):
        rl, nl = int(rlens[b]), int(nlens[b])
        H = np.full((rl + 1, W + 2), NEG, np.int64)   # H[i][k]
        F = np.full_like(H, NEG)
        SH = np.zeros_like(H)
        SF = np.zeros_like(H)
        best = (NEG, 0, 0, 0, 0)   # score, d, i, start, k
        for i in range(1, rl + 1):
            E = NEG
            SE = 0
            for k in range(W):
                j = i + k
                if j > nl:
                    break
                rc = reads[b, i - 1]
                fc = refs[b, j - 1]
                s = -1 if (rc >= 4 or fc >= 4) else \
                    (match if rc == fc else -mismatch)
                fresh = 0 if i == 1 else -clip
                hp = H[i - 1][k]
                hd = max(hp, fresh) + s
                sd = SH[i - 1][k] if hp >= fresh else i - 1
                fo = H[i - 1][k + 1] - go - ge
                fe = F[i - 1][k + 1] - ge
                f = max(fo, fe)
                sf = SH[i - 1][k + 1] if fo >= fe else SF[i - 1][k + 1]
                h = max(hd, E, f)
                sh = sd if hd >= max(E, f) else (SE if E >= f else sf)
                H[i][k] = h
                F[i][k] = f
                SH[i][k] = sh
                SF[i][k] = sf
                adj = h + (0 if i == rl else -clip)
                cand = (adj, 2 * i + k, i, sh, k)
                if cand[0] > best[0] or (
                        cand[0] == best[0]
                        and (cand[1], cand[2]) < (best[1], best[2])):
                    best = cand
                # E for the NEXT k in this row opens from this full H
                eo = h - go - ge
                ee = E - ge
                if eo >= ee:
                    E, SE = eo, sh
                else:
                    E = ee
        out["score"][b] = best[0]
        out["qb"][b] = best[3]
        out["qe"][b] = best[2]
        out["ref_end"][b] = best[2] + best[4]
    return out


def _run_banded(reads, rlens, refs, nlens, W):
    o = sw.sw_score_banded(jnp.asarray(reads), jnp.asarray(rlens),
                           jnp.asarray(refs), jnp.asarray(nlens), W)
    return {k: np.asarray(v) for k, v in o.items()}


class TestBandedVsNumpy:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_exact(self, seed):
        rng = np.random.default_rng(seed)
        B, m, n, W = 16, 40, 96, 64
        reads = rng.integers(0, 4, (B, m)).astype(np.int32)
        refs = rng.integers(0, 4, (B, n)).astype(np.int32)
        rlens = rng.integers(20, m + 1, B).astype(np.int32)
        nlens = rng.integers(50, n + 1, B).astype(np.int32)
        # plant partial copies so positive alignments exist
        for b in range(B):
            off = rng.integers(0, 30)
            ln = min(int(rlens[b]), int(nlens[b]) - off)
            refs[b, off:off + ln] = reads[b, :ln]
            if rng.random() < 0.7:
                p = rng.integers(0, ln)
                refs[b, off + p] = (refs[b, off + p] + 1) % 4
        got = _run_banded(reads, rlens, refs, nlens, W)
        want = _np_banded(reads, rlens, refs, nlens, W)
        for k in ("score", "qb", "qe", "ref_end"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_with_ns_and_indels(self):
        rng = np.random.default_rng(9)
        B, m, n, W = 12, 50, 128, 96
        reads = rng.integers(0, 4, (B, m)).astype(np.int32)
        refs = rng.integers(0, 4, (B, n)).astype(np.int32)
        rlens = np.full(B, m, np.int32)
        nlens = np.full(B, n, np.int32)
        for b in range(B):
            r = list(reads[b, :m])
            # indel: delete/insert a block in the planted copy
            cut = rng.integers(10, 30)
            gap = rng.integers(1, 6)
            if b % 2:
                planted = r[:cut] + r[cut + gap:]
            else:
                planted = r[:cut] + list(rng.integers(0, 4, gap)) + r[cut:]
            off = rng.integers(0, 20)
            ln = min(len(planted), n - off)
            refs[b, off:off + ln] = planted[:ln]
        reads[3, 7] = 4   # N in read
        refs[5, 30] = 4   # N in ref
        got = _run_banded(reads, rlens, refs, nlens, W)
        want = _np_banded(reads, rlens, refs, nlens, W)
        for k in ("score", "qb", "qe", "ref_end"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class TestBandedVsUnbanded:
    def test_in_corridor_equals_unbanded(self):
        """When every optimal alignment's diagonal is in [0, W), banded
        and anti-diagonal kernels agree exactly."""
        rng = np.random.default_rng(4)
        B, m = 24, 60
        W = 64
        n = m + W - 1   # corridor covers the whole window
        reads = rng.integers(0, 4, (B, m)).astype(np.int32)
        refs = rng.integers(0, 4, (B, n)).astype(np.int32)
        rlens = rng.integers(40, m + 1, B).astype(np.int32)
        nlens = np.full(B, n, np.int32)
        for b in range(B):
            off = rng.integers(0, W - 8)
            ln = min(int(rlens[b]), n - off)
            refs[b, off:off + ln] = reads[b, :ln]
            for _ in range(rng.integers(0, 3)):
                p = rng.integers(0, ln)
                refs[b, off + p] = (refs[b, off + p] + rng.integers(1, 4)) % 4
        got = _run_banded(reads, rlens, refs, nlens, W)
        want = {k: np.asarray(v) for k, v in sw.sw_score_batch(
            jnp.asarray(reads), jnp.asarray(rlens), jnp.asarray(refs),
            jnp.asarray(nlens)).items()}
        for k in ("score", "qb", "qe", "ref_end"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class TestNativeScorer:
    def test_native_equals_banded_scan(self):
        """The threaded host C++ scorer must match the XLA banded kernel
        bit-for-bit (same corridor, same tie rules) — it is the CPU
        backend's default scorer."""
        from ema_tpu import native

        rng = np.random.default_rng(11)
        R, L, n = 64, 80, 5000
        oriented = rng.integers(0, 5, (R, L)).astype(np.uint8)
        olens = rng.integers(40, L + 1, R).astype(np.int32)
        text = rng.integers(0, 4, n).astype(np.uint8)
        N, W = 200, 128
        owners = rng.integers(0, R, N).astype(np.int64)
        win_lo = rng.integers(-50, n - 100, N).astype(np.int64)
        win_len = rng.integers(100, 220, N).astype(np.int32)
        # plant real alignments for half the candidates
        for c in range(0, N, 2):
            o = int(owners[c])
            rl = int(olens[o])
            off = int(rng.integers(0, 40))
            for j in range(min(rl, int(win_len[c]) - off)):
                col = int(win_lo[c]) + off + j
                if 0 <= col < n:
                    text[col] = oriented[o, j]

        got = native.sw_banded_native(oriented, olens, text, owners,
                                      win_lo, win_len, W)
        # reference: gather windows w/ sentinel masking + banded scan
        cols = win_lo[:, None] + np.arange(int(win_len.max()))[None, :]
        wins = np.where((cols < 0) | (cols >= n), 5,
                        text[np.clip(cols, 0, n - 1)]).astype(np.int32)
        import jax.numpy as jnp
        want = {k: np.asarray(v) for k, v in sw.sw_score_banded(
            jnp.asarray(oriented[owners].astype(np.int32)),
            jnp.asarray(olens[owners]), jnp.asarray(wins),
            jnp.asarray(win_len), W).items()}
        for k in ("score", "qb", "qe", "ref_end"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_simd_dispatch_equals_scalar(self):
        """Where the .so compiled the AVX-512 inter-candidate kernel, the
        dispatch path must match the striped scalar kernel bit-for-bit
        (both are also pinned against the XLA kernel above)."""
        from ema_tpu import native

        rng = np.random.default_rng(23)
        R, L, n = 32, 100, 4000
        oriented = rng.integers(0, 5, (R, L)).astype(np.uint8)
        olens = rng.integers(30, L + 1, R).astype(np.int32)
        text = rng.integers(0, 4, n).astype(np.uint8)
        N, W = 123, 128     # non-multiple of the 16-lane block size
        owners = rng.integers(0, R, N).astype(np.int64)
        win_lo = rng.integers(-60, n - 80, N).astype(np.int64)
        win_len = rng.integers(0, 260, N).astype(np.int32)  # incl. tiny
        a = native.sw_banded_native(oriented, olens, text, owners,
                                    win_lo, win_len, W)
        b = native.sw_banded_native(oriented, olens, text, owners,
                                    win_lo, win_len, W, force_scalar=True)
        for k in ("score", "qb", "qe", "ref_end"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class TestCrossBackendPipeline:
    def test_native_and_xla_scorers_identical_sam(self):
        """The per-candidate logical corridor makes the full pipeline's
        SAM output identical whichever SW scorer runs (host C++ vs XLA
        banded) — including contig-edge overhangs, truncated windows and
        repeat families where physical lane padding used to differ."""
        import numpy as np

        from tests.simulate import rand_genome, simulate_pairs, to_str
        from ema_tpu.index import build_index
        from ema_tpu import config
        from ema_tpu.core.pipeline import Aligner, ReadBatch

        rng = np.random.default_rng(4242)
        g = rand_genome(rng, 300_000)
        unit = g[40_000:41_500].copy()
        for k in range(12):                     # repeat family
            g[50_000 + k * 1_600:50_000 + k * 1_600 + 1_500] = unit
        gs = to_str(g)
        ids, bc_strs, bcs, s1, q1, s2, q2, _ = simulate_pairs(
            rng, gs, n_barcodes=30, frags_per_bc=(2, 3),
            pairs_per_frag=(10, 20), frag_len=20_000, read_len=100,
            err=0.005)
        # contig-edge overhang reads (window truncation paths)
        ids += ["edgeA", "edgeB"]
        bcs += [bcs[0], bcs[0]]
        s1 += ["A" * 40 + gs[:60], gs[-60:] + "C" * 40]
        q1 += ["I" * 100] * 2
        s2 += [gs[200:300], gs[-300:-200]]
        q2 += ["I" * 100] * 2

        idx = build_index({"c": g})
        outs = {}
        import os
        for impl in ("native", "banded"):
            os.environ["EMA_TPU_SW_IMPL"] = impl
            try:
                al = Aligner(idx, config.RunConfig(batch_size=512, seed=7))
                assert al.placement.sw == impl
                batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
                outs[impl] = sorted(al.align_batch_to_sam(batch))
            finally:
                del os.environ["EMA_TPU_SW_IMPL"]
        assert outs["native"] == outs["banded"]


def _windows(text, win_lo, win_len):
    """Gather SW windows off the text, out-of-text columns -> sentinel 5."""
    n = text.shape[0]
    cols = win_lo[:, None] + np.arange(int(win_len.max()))[None, :]
    return np.where((cols < 0) | (cols >= n), 5,
                    text[np.clip(cols, 0, n - 1)]).astype(np.int32)


def _planted_world(rng, R, L, n, N, win_lo_range, win_len_range,
                   lo_read=None, max_off=None):
    """Random reads + text with real alignments planted in half the
    candidate windows (so scores span the interesting range)."""
    oriented = rng.integers(0, 5, (R, L)).astype(np.uint8)
    olens = rng.integers(lo_read or L // 2, L + 1, R).astype(np.int32)
    text = rng.integers(0, 4, n).astype(np.uint8)
    owners = rng.integers(0, R, N).astype(np.int64)
    win_lo = rng.integers(*win_lo_range, N).astype(np.int64)
    win_len = rng.integers(*win_len_range, N).astype(np.int32)
    for c in range(0, N, 2):
        o = int(owners[c])
        off = int(rng.integers(0, max(int(win_len[c]) - int(olens[o]), 1)))
        if max_off is not None:
            off = min(off, max_off)
        for j in range(min(int(olens[o]), int(win_len[c]) - off)):
            col = int(win_lo[c]) + off + j
            if 0 <= col < n and rng.random() < 0.97:
                text[col] = min(int(oriented[o, j]), 3)
    return oriented, olens, text, owners, win_lo, win_len


class TestLogicalCorridor:
    def test_wl_masking_identical_across_kernels(self):
        """Per-candidate logical corridors (wl) must produce identical
        outputs from the XLA row-sweep and the host C++ scorer, for
        random corridors narrower than the physical band; candidates
        whose corridor spans the whole window also equal the
        anti-diagonal scan (which has no corridor)."""
        import jax.numpy as jnp

        from ema_tpu import native
        from ema_tpu.ops.sw import sw_score_banded, sw_score_batch

        rng = np.random.default_rng(3)
        R, L, n, N, W = 16, 80, 3000, 48, 128
        oriented, olens, text, owners, win_lo, win_len = _planted_world(
            rng, R, L, n, N, (0, n - W), (90, W + 1), lo_read=40)
        wl = rng.integers(1, W + 1, N).astype(np.int32)
        full = np.arange(N) % 2 == 0
        wl[full] = W                # corridor covers every window diagonal
        wins = _windows(text, win_lo, win_len)
        reads = oriented[owners].astype(np.int32)
        rlens = olens[owners]

        want = {k: np.asarray(v) for k, v in sw_score_banded(
            jnp.asarray(reads), jnp.asarray(rlens), jnp.asarray(wins),
            jnp.asarray(win_len), W, wl=jnp.asarray(wl)).items()}
        host = native.sw_banded_native(oriented, olens, text, owners,
                                       win_lo, win_len, W, wl=wl)
        scan = {k: np.asarray(v) for k, v in sw_score_batch(
            jnp.asarray(reads[full]), jnp.asarray(rlens[full]),
            jnp.asarray(wins[full]), jnp.asarray(win_len[full])).items()}
        planted = np.arange(N)[full] % 4 == 0
        for k in ("score", "qb", "qe", "ref_end"):
            np.testing.assert_array_equal(host[k], want[k],
                                          err_msg="native " + k)
            # the scan may also find off-corridor (j < i) alignments; on
            # the planted windows the in-corridor optimum dominates
            np.testing.assert_array_equal(scan[k][planted],
                                          want[k][full][planted],
                                          err_msg="scan " + k)

    def test_wl_masking_native_matches_xla(self):
        """The host kernels honor the same per-candidate corridor."""
        import jax.numpy as jnp

        from ema_tpu import native
        from ema_tpu.ops.sw import sw_score_banded

        rng = np.random.default_rng(9)
        R, L, n = 24, 70, 4000
        oriented = rng.integers(0, 5, (R, L)).astype(np.uint8)
        olens = rng.integers(40, L + 1, R).astype(np.int32)
        text = rng.integers(0, 4, n).astype(np.uint8)
        N, W = 100, 128
        owners = rng.integers(0, R, N).astype(np.int64)
        win_lo = rng.integers(-30, n - 90, N).astype(np.int64)
        win_len = rng.integers(90, 220, N).astype(np.int32)
        wl = rng.integers(1, W + 1, N).astype(np.int32)

        for force_scalar in (False, True):
            got = native.sw_banded_native(oriented, olens, text, owners,
                                          win_lo, win_len, W, wl=wl,
                                          force_scalar=force_scalar)
            cols = win_lo[:, None] + np.arange(int(win_len.max()))[None, :]
            wins = np.where((cols < 0) | (cols >= n), 5,
                            text[np.clip(cols, 0, n - 1)]).astype(np.int32)
            want = {k: np.asarray(v) for k, v in sw_score_banded(
                jnp.asarray(oriented[owners].astype(np.int32)),
                jnp.asarray(olens[owners]), jnp.asarray(wins),
                jnp.asarray(win_len), W, wl=jnp.asarray(wl)).items()}
            for k in ("score", "qb", "qe", "ref_end"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class TestXlaVsNative:
    """The device scorer (XLA banded) against the host C++ scorer at the
    pipeline's shapes: 150 bp reads in a 128-lane chained corridor, and
    mate-rescue windows whose corridor is the whole insert window."""

    @pytest.mark.parametrize("kind", ["chained", "rescue"])
    def test_read_length_150(self, kind):
        import jax.numpy as jnp

        from ema_tpu import native
        from ema_tpu.ops.sw import sw_score_banded

        rng = np.random.default_rng(150 + len(kind))
        R, L, n, N = 24, 150, 20_000, 40
        if kind == "chained":
            lo, ln = (-40, n - 300), (150, 250)
        else:
            lo, ln = (-100, n - 800), (650, 800)
        oriented, olens, text, owners, win_lo, win_len = _planted_world(
            rng, R, L, n, N, lo, ln, lo_read=140,
            max_off=30 if kind == "chained" else None)
        # chained: the chain's logical corridor; rescue: the full window
        wl = (rng.integers(40, 129, N).astype(np.int32)
              if kind == "chained" else win_len.astype(np.int32))
        W = 128 if kind == "chained" else ((int(wl.max()) + 127) // 128) * 128
        got = native.sw_banded_native(oriented, olens, text, owners,
                                      win_lo, win_len, int(wl.max()), wl=wl)
        wins = _windows(text, win_lo, win_len)
        want = {k: np.asarray(v) for k, v in sw_score_banded(
            jnp.asarray(oriented[owners].astype(np.int32)),
            jnp.asarray(olens[owners]), jnp.asarray(wins),
            jnp.asarray(win_len), W, wl=jnp.asarray(wl)).items()}
        assert (want["score"] >= 40).sum() >= N // 4    # planted hits found
        for k in ("score", "qb", "qe", "ref_end"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    @pytest.mark.gpu
    @pytest.mark.parametrize("kind", ["chained", "rescue"])
    def test_on_card(self, gpu, kind):
        """The same check with the XLA kernel compiled for the card."""
        self.test_read_length_150(kind)
