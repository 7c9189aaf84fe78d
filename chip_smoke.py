"""Smoke test of the align path on NVIDIA GPUs, checked against the host.

Run from the repository root on a machine with a GPU, in one process:

    python chip_smoke.py            # phases a-c on one card
    python chip_smoke.py --four     # phase d only, on four cards

a. Device: JAX version, device kind, the card's name and power limit
   (nvidia-smi), the compile-cache directory and the placement table.
b. Kernel parity on the card, on a 64 Mbp index: XLA banded SW (chained
   and mate-rescue widths) vs the host C++ scorer, device locate vs host
   locate on >= 1M rows, fused device greedy seed+locate vs host greedy
   seeding + locate (all exactly equal), and the jitted EM vs the numpy
   EM (within GAMMA_RTOL / GAMMA_ATOL).
c. End to end through the CLI, in this process: count -> preproc ->
   index -> align of ~100k 2x150 bp 10x pairs (~60 per barcode, so the
   EM gate engages; mate rescue on).  The SAM must equal the host path's
   (native SW, native FM, host EM) field for field by utils/samdiff.
   The same bucket through the device path with SW on the host scorer
   (the end-to-end SW A/B) and through the host path, each timed warm
   with stage spans, must give the same SAM.
d. (--four) The meshed Aligner over four cards must emit the SAM of a
   one-card Aligner on the phase-c world, and the sharded candidate step
   on a (2, 2) mesh must equal candidate_core on one card.  Each pass
   prints a progress line; with none for WATCHDOG_S seconds the script
   dumps every thread's stack and exits 1.

The world (genome, reads, index) is generated from --seed and cached in
.smoke_cache/ under a key of seed and size.  Every phase either passes
or the script exits non-zero; the last line of stdout is the JSON
result, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import faulthandler
import hashlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

GENOME_BP = 64_000_000
N_PAIRS = 100_000
READ_LEN = 150
PAIRS_PER_BC = 60
# simulate_pairs settings: 2-4 fragments per barcode x 15-25 pairs per
# fragment gives ~60 pairs per barcode
SIM = dict(frags_per_bc=(2, 5), pairs_per_frag=(15, 26), frag_len=30_000,
           read_len=READ_LEN, err=0.003)
SW_CANDIDATES = 65_536          # one pipeline SW_CHUNK
LOCATE_ROWS = 1 << 20
SEED_READS = 8_192
# device EM (float64) vs numpy EM: the two evaluate the same float64
# expressions but with different exp/log implementations and summation
# orders, so gammas differ by a few ulps per operation, compounded over
# EM_ITERS rounds; 1e-9 relative is far below what any output reads
# (XG prints 5 digits, selection compares gammas between candidates).
GAMMA_RTOL = 1e-9
GAMMA_ATOL = 1e-12
# phase d: with no progress line for this long, dump every thread's stack
# and exit 1 (a collective that never completes hangs without an error)
WATCHDOG_S = 180

CARD = "card unknown"


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(msg: str) -> None:
    """A line that carries a time: tagged with the card and its limit."""
    log(f"{msg}  [{CARD}]")


def progress(msg: str) -> None:
    """A timed line that also re-arms the hang watchdog."""
    timed(msg)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)


def contract_line(platform: str, kind: str, count: int) -> str:
    """The result line; refuses any platform but a GPU."""
    if platform != "gpu":
        raise ValueError(f"platform {platform!r} is not a GPU")
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": int(count)}})


def nvidia_smi() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def require_gpus(n: int):
    """The GPU devices, or exit 2 (before any result is printed)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        sys.stderr.write(f"chip_smoke: needs {n} GPU(s); JAX found "
                         f"{len(devs)} {devs[0].platform} device(s)\n")
        sys.exit(2)
    return devs[:n]


class CompileLog:
    """Counts XLA compiles and persistent-cache hits, and sums the
    trace/lower/compile seconds."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax.monitoring

        self.seconds = 0.0
        self.compiles = 0
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)
        jax.monitoring.register_event_listener(self._on_event)

    def _on(self, name, dur, **_):
        if name in self.EVENTS:
            self.seconds += dur
            self.compiles += name.endswith("backend_compile_duration")

    def _on_event(self, name, **_):
        self.cache_hits += name == "/jax/compilation_cache/cache_hits"

    def mark(self):
        return self.seconds, self.compiles, self.cache_hits


# ----------------------------------------------------------------------
# the world: genome, reads, index
# ----------------------------------------------------------------------

class World:
    """A simulated chromosome-scale genome and 10x read pairs on disk.

    The cache key holds the seed, the sizes and a hash of the simulation
    settings and of tests/simulate.py, so a changed generator never
    reuses an old world.
    """

    def __init__(self, seed: int, genome_bp: int, n_pairs: int):
        h = hashlib.sha256(json.dumps(
            [SIM, PAIRS_PER_BC], sort_keys=True).encode())
        with open(os.path.join(REPO, "tests", "simulate.py"), "rb") as f:
            h.update(f.read())
        self.dir = os.path.join(
            REPO, ".smoke_cache",
            f"s{seed}_g{genome_bp}_p{n_pairs}_{h.hexdigest()[:12]}")
        self.ref = os.path.join(self.dir, "ref.fa")
        self.fq = os.path.join(self.dir, "inter.fq")
        self.wl = os.path.join(self.dir, "wl.txt")
        self.truth = os.path.join(self.dir, "truth.npz")
        self.seed, self.genome_bp, self.n_pairs = seed, genome_bp, n_pairs

    def build(self) -> None:
        """Write ref.fa, inter.fq, wl.txt and truth.npz (cached)."""
        if os.path.exists(self.truth):
            log(f"world: cached in {os.path.relpath(self.dir, REPO)}")
            return
        # the tests directory itself: a site-packages `tests` package
        # would shadow `tests.simulate`
        sys.path.insert(0, os.path.join(REPO, "tests"))
        import simulate as sim
        t0 = time.perf_counter()
        os.makedirs(self.dir, exist_ok=True)
        rng = np.random.default_rng(self.seed)
        genome = sim.plant_repeat_families(
            rng, sim.rand_genome(rng, self.genome_bp))
        gs = sim.to_str(genome)
        with open(self.ref, "w") as f:
            f.write(">chr20sim\n")
            for i in range(0, len(gs), 1 << 20):
                blk = np.frombuffer(gs[i:i + (1 << 20)].encode(), np.uint8)
                f.write(b"\n".join(blk[j:j + 80].tobytes() for j in range(
                    0, blk.shape[0], 80)).decode() + "\n")
        ids, bc_strs, bcs, s1, q1, s2, q2, truth = sim.simulate_pairs(
            rng, gs, n_barcodes=max(self.n_pairs // PAIRS_PER_BC, 1), **SIM)
        with open(self.wl, "w") as f:
            f.write("".join(b + "\n" for b in sorted(set(bc_strs))))
        with open(self.fq, "w") as f:
            for i in range(len(ids)):
                r1 = bc_strs[i] + "G" * 7 + s1[i]
                f.write(f"@{ids[i]}\n{r1}\n+\n{'I' * len(r1)}\n"
                        f"@{ids[i]}\n{s2[i]}\n+\n{q2[i]}\n")
        np.savez(self.truth,
                 pos1=np.array([t["pos1"] for t in truth], np.int64),
                 pos2=np.array([t["pos2"] for t in truth], np.int64))
        timed(f"world: {self.genome_bp} bp genome, {len(ids)} pairs over "
              f"{len(set(bc_strs))} barcodes, written in "
              f"{time.perf_counter() - t0:.1f} s")

    def index(self):
        """The FM index, built through the CLI on first use (cached)."""
        from ema_tpu import cli
        from ema_tpu.index import ReferenceIndex

        path = self.ref + ".emaidx.npz"
        if os.path.exists(path):
            log("index: cached")
        else:
            t0 = time.perf_counter()
            if cli.main(["index", "-r", self.ref]) != 0:
                raise RuntimeError("ema_tpu index failed")
            timed(f"index: built in {time.perf_counter() - t0:.1f} s")
        return ReferenceIndex.load(path)

    def pairs(self):
        """(forward read-1 codes [P, L], 0-based read-1 starts [P])."""
        t = np.load(self.truth)
        codes = []
        lut = np.full(256, 4, np.uint8)
        for i, c in enumerate(b"ACGT"):
            lut[c] = i
        with open(self.fq, "rb") as f:
            for k, line in enumerate(f):
                if k % 8 == 1:
                    codes.append(lut[np.frombuffer(line[23:23 + READ_LEN],
                                                   np.uint8)])
        return np.stack(codes), t["pos1"] - 1


# ----------------------------------------------------------------------
# phase a
# ----------------------------------------------------------------------

def phase_a(devs) -> None:
    import jax

    from ema_tpu.utils.backend import compile_cache_dir, ensure_backend

    ensure_backend()
    log(f"a. jax {jax.__version__}, platform {devs[0].platform}, "
        f"device_kind {devs[0].device_kind}, count {len(devs)}")
    log(f"a. compile cache: {compile_cache_dir()}")


def print_placement(aligner) -> None:
    for stage, where in aligner.placement_table().items():
        log(f"a. placement {stage}: {where}")


# ----------------------------------------------------------------------
# phase b: kernel parity on the card
# ----------------------------------------------------------------------

def _median_time(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _sw_case(rng, reads, starts, idx, kind: str):
    """SW_CANDIDATES (read, window, corridor) triples at pipeline widths.

    chained: a 150 bp read in its chain window (read + 24 bp each side)
    with a logical corridor wl <= 128 covering the true diagonal;
    rescue: a mate-rescue insert window of 700-800 columns whose
    corridor is the whole window.  One candidate in eight gets a random
    window, so scores span both signs.
    """
    n = SW_CANDIDATES
    pick = rng.integers(0, reads.shape[0], n)
    oriented = reads[pick]
    olens = np.full(n, READ_LEN, np.int32)
    owners = np.arange(n, dtype=np.int64)
    if kind == "chained":
        off = rng.integers(0, 49, n)
        win_len = np.full(n, READ_LEN + 48, np.int32)
        wl = np.minimum(off + 1 + rng.integers(0, 128, n), 128)
    else:
        off = rng.integers(0, 550, n)
        win_len = rng.integers(700, 801, n).astype(np.int32)
        wl = win_len.copy()
    win_lo = starts[pick] - off
    junk = rng.random(n) < 0.125
    win_lo[junk] = rng.integers(0, idx.n - 1000, int(junk.sum()))
    return (oriented, olens, owners, win_lo.astype(np.int64), win_len,
            wl.astype(np.int32))


def phase_b(world, idx, aligner) -> None:
    import jax
    import jax.numpy as jnp

    from ema_tpu import config, native
    from ema_tpu.core import groups as groups_mod
    from ema_tpu.core.pipeline import (LANE, WIN_BUCKET, ReadBatch,
                                       _compact_seed_hits, _gather_score,
                                       _round_up, locate_rows_bucketed)
    from ema_tpu.index import fmindex

    rng = np.random.default_rng(world.seed + 1)
    reads, starts = world.pairs()
    p = config.DEFAULT_ALIGNER_PARAMS
    sc = dict(match=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
              gap_extend=p.gap_extend)
    text_dev = jnp.asarray(idx.text)

    # --- SW: XLA banded on the card vs the host C++ scorer -------------
    for kind in ("chained", "rescue"):
        o, ol, own, wlo, wlen, wl = _sw_case(rng, reads, starts, idx, kind)
        w_max = _round_up(int(wlen.max()), WIN_BUCKET)
        w_band = min(_round_up(int(wl.max()), LANE), _round_up(w_max, LANE))
        args = (text_dev, jnp.asarray(o), jnp.asarray(ol),
                jnp.asarray(own.astype(np.int32)),
                jnp.asarray(wlo.astype(np.int32)), jnp.asarray(wlen),
                jnp.asarray(wl))

        def dev():
            return jax.block_until_ready(_gather_score(
                *args, w_max=w_max, w_band=w_band, clip=p.clip_penalty,
                sw_impl="banded", **sc))

        got = {k: np.asarray(v) for k, v in dev().items()}
        t_dev = _median_time(dev, 5)

        def host():
            return native.sw_banded_native(
                o, ol, idx.text, own, wlo, wlen, int(wl.max()),
                clip=p.clip_penalty, wl=wl, **sc)

        want = host()
        t_host = _median_time(host, 3)
        for k in ("score", "qb", "qe", "ref_end"):
            if not np.array_equal(got[k], want[k]):
                bad = int((got[k] != want[k]).sum())
                raise AssertionError(f"b. SW {kind}: {k} differs on {bad} "
                                     f"of {SW_CANDIDATES} candidates")
        pos = int((want["score"] > 0).sum())
        timed(f"b. SW {kind}: {SW_CANDIDATES} candidates, w_band "
              f"{w_band}, window {w_max}: exact (score/qb/qe/ref_end; "
              f"{pos} positive); XLA banded on device "
              f"{t_dev * 1e3:.1f} ms/chunk, host native "
              f"{t_host * 1e3:.1f} ms/chunk")

    # --- locate: device vs host on >= 1M rows ---------------------------
    fma = fmindex.FMIndexArrays.from_index(idx)
    rows = rng.integers(0, idx.fm_n + 1, LOCATE_ROWS).astype(np.int64)
    dev_pos = locate_rows_bucketed(fma, rows)          # compiles
    t_dev = _median_time(lambda: locate_rows_bucketed(fma, rows), 3)
    rows_dev = jnp.asarray(rows.astype(np.int32))
    jax.block_until_ready(fmindex.locate(fma, rows_dev))
    t_kern = _median_time(lambda: jax.block_until_ready(
        fmindex.locate(fma, rows_dev)), 3)
    host_pos = native.locate_batch(idx, rows)
    t_host = _median_time(lambda: native.locate_batch(idx, rows), 3)
    if not np.array_equal(dev_pos, host_pos):
        raise AssertionError(
            f"b. locate differs on {int((dev_pos != host_pos).sum())} rows")
    timed(f"b. locate: {LOCATE_ROWS} rows exact; device "
          f"{t_dev * 1e3:.1f} ms through the pipeline's chunked path (incl. "
          f"transfers), {t_kern * 1e3:.1f} ms one resident call; host "
          f"native {t_host * 1e3:.1f} ms")

    # --- greedy seed + locate: fused device program vs host C++ -------
    codes = reads[:SEED_READS]
    lens = np.full(SEED_READS, READ_LEN, np.int32)
    budget = 4 * SEED_READS
    packed, total, frac = fmindex.seed_locate_reads(
        fma, jnp.asarray(codes), jnp.asarray(lens), max_seeds=16,
        min_seed_len=p.seed_len, max_hits=p.max_hits_per_seed,
        budget=budget, max_occ=p.max_occ)
    total = int(total)
    sm = native.greedy_seed_batch(idx.occ_blocks, idx.counts, idx.primary,
                                  idx.fm_n, codes, lens,
                                  min_seed_len=p.seed_len, max_seeds=16)
    owner, qb, slen, hrows = _compact_seed_hits(sm[:4], sm[4],
                                                p.max_hits_per_seed)
    hp = native.locate_batch(idx, hrows)
    if total > budget or total != owner.shape[0]:
        raise AssertionError(f"b. seed+locate: {total} device hits vs "
                             f"{owner.shape[0]} host (budget {budget})")
    ph = np.asarray(packed)[:, :total]
    for name, a, b in (("owner", ph[0], owner), ("qb", ph[1], qb),
                       ("seed_len", ph[2], slen), ("pos", ph[3], hp)):
        if not np.array_equal(a, b):
            raise AssertionError(f"b. seed+locate: {name} differs")
    log(f"b. greedy seed+locate: {SEED_READS} reads, {total} hits exact "
        "(owner/qb/seed_len/pos)")

    # --- EM: jitted EM on the card vs the numpy EM ----------------------
    batch = ReadBatch.from_pairs(*_bucket_rows(world, 12_000))
    cs = aligner.generate_candidates(batch)
    recs, idents, _ = aligner.candidates_to_records(batch, cs)
    o = np.argsort(recs["bc"], kind="stable")
    recs, idents = recs[o], idents[o]
    bcs = recs["bc"]
    starts_g = np.concatenate([[0], np.nonzero(np.diff(bcs))[0] + 1,
                               [bcs.shape[0]]])
    per_bc = {}
    for b in batch.bc:
        per_bc[int(b)] = per_bc.get(int(b), 0) + 1
    states = groups_mod.sweep_groups_batch(
        recs, idents, starts_g, config.get_platform_profile("10x"),
        rng=np.random.default_rng(0),
        n_pairs_list=[per_bc[int(bcs[s])] for s in starts_g[:-1]])
    host_st = copy.deepcopy(states)
    groups_mod.run_em_host_batch(host_st)
    dev_st = copy.deepcopy(states)
    groups_mod.dispatch_em_device_batch(dev_st)()
    n_em = worst = 0.0
    for h, d in zip(host_st, dev_st):
        if not h.needs_em:
            continue
        n_em += 1
        np.testing.assert_allclose(d.gammas, h.gammas, rtol=GAMMA_RTOL,
                                   atol=GAMMA_ATOL)
        worst = max(worst, float(np.abs(d.gammas - h.gammas).max()))
    if n_em == 0:
        raise AssertionError("b. EM: no group reached the EM gate")
    log(f"b. EM: {int(n_em)} EM-gated groups, device float64 vs numpy "
        f"max |dgamma| {worst:.3g} (rtol {GAMMA_RTOL}, atol {GAMMA_ATOL})")


def _bucket_rows(world, n_pairs: int):
    """The first ``n_pairs`` (whole barcodes) of preproc's bucket."""
    from ema_tpu import io as io_mod

    rows = io_mod.read_special_rows(_bucket(world), False, 16)
    bcs = rows[1]
    end = min(n_pairs, len(bcs))
    while 0 < end < len(bcs) and bcs[end] == bcs[end - 1]:
        end += 1
    return [r[:end] for r in rows]


def _bucket(world) -> str:
    return os.path.join(world.dir, "bkt", "ema-bin-000")


# ----------------------------------------------------------------------
# phase c: end to end through the CLI
# ----------------------------------------------------------------------

@contextlib.contextmanager
def _stdin_from(path):
    saved = sys.stdin
    with open(path) as f:
        sys.stdin = f
        try:
            yield
        finally:
            sys.stdin = saved


def _cli(args, stdin=None) -> str:
    """ema_tpu.cli in this process; returns its stderr (also echoed)."""
    from ema_tpu import cli

    err = io.StringIO()
    ctx = _stdin_from(stdin) if stdin else contextlib.nullcontext()
    with ctx, contextlib.redirect_stderr(err):
        rc = cli.main(args)
    sys.stderr.write(err.getvalue())
    if rc != 0:
        raise RuntimeError(f"ema_tpu {args[0]} exited {rc}")
    return err.getvalue()


def preprocess(world) -> None:
    """count -> preproc into one bucket (cached with the world)."""
    if os.path.exists(_bucket(world)):
        log("c. count + preproc: cached")
        return
    cnt = os.path.join(world.dir, "cnt")
    t0 = time.perf_counter()
    _cli(["count", "-w", world.wl, "-o", cnt], stdin=world.fq)
    _cli(["preproc", "-w", world.wl, "-o", os.path.join(world.dir, "bkt"),
          "-n", "1", "-h", cnt + ".ema-ncnt"], stdin=world.fq)
    timed(f"c. count + preproc: {time.perf_counter() - t0:.1f} s")


def _spans(stderr: str) -> dict:
    """Stage spans from the CLI's metrics summary (thread-seconds)."""
    out = {}
    for line in stderr.splitlines():
        if line.startswith("::   ") and ": " in line[5:]:
            name, rest = line[5:].split(": ", 1)
            out[name] = (float(rest.split("s", 1)[0]),
                         rest.split("s", 1)[1].strip())
    return out


@contextlib.contextmanager
def _env(**kv):
    saved = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _warm_aligner(world, idx, label: str, cfg, **env):
    """An Aligner under placement overrides ``env``, timed like the CLI's
    align span: one cold call, then a warm call with stage timers.
    Writes the warm call's SAM body and returns its path."""
    from ema_tpu import io as io_mod
    from ema_tpu.core.pipeline import Aligner
    from ema_tpu.utils.metrics import Metrics

    with _env(**env):
        al = Aligner(idx, cfg)
    batch = io_mod.read_special_fastq(_bucket(world))
    al.align_batch_to_sam(batch)              # compiles, lazy tables
    al.metrics = Metrics()
    t0 = time.perf_counter()
    lines = al.align_batch_to_sam(batch)
    dt = time.perf_counter() - t0
    path = os.path.join(world.dir, f"{label}.sam")
    with open(path, "w") as f:
        f.writelines(lines)
    n = len(batch.ids)
    timed(f"c. {label}: {n} pairs, {n / dt:.0f} pairs/s (warm align "
          f"{dt:.2f} s)")
    for k in sorted(al.metrics.wall):
        timed(f"c. {label} span {k}: {al.metrics.wall[k]:.2f} s "
              f"n={al.metrics.items.get(k, 0)}")
    return path


def _sam_equal(a: str, b: str, what: str) -> int:
    """Field-for-field equality by samdiff; returns the record count."""
    from ema_tpu.utils.samdiff import diff_sams

    st = diff_sams(a, b)
    fields = ("pos_match", "flag_match", "cigar_match", "mapq_match",
              "bx_match", "xg_close", "mi_consistent", "mate_match",
              "seq_match", "xa_match")
    bad = [f for f in fields if getattr(st, f) != st.shared]
    if st.only_a or st.only_b or not st.shared or bad:
        raise AssertionError(f"{what}: SAMs differ ({bad}; only_a "
                             f"{st.only_a}, only_b {st.only_b})\n"
                             + st.summary() + "\n"
                             + "\n".join(st.mismatches))
    return st.shared


def _accuracy(sam: str, world):
    t = np.load(world.truth)
    n = ok = hi = hi_wrong = 0
    with open(sam) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fl = line.split("\t", 6)
            flag = int(fl[1])
            if flag & 0x900:
                continue
            n += 1
            i = int(fl[0][3:])
            want = t["pos1"][i] if flag & 0x40 else t["pos2"][i]
            good = not flag & 0x4 and abs(int(fl[3]) - want) <= 5
            ok += good
            if int(fl[4]) >= 30:
                hi += 1
                hi_wrong += not good
    return n, ok, hi, hi_wrong


def phase_c(world, idx, clog: CompileLog) -> None:
    import jax

    preprocess(world)
    world.index()                     # cached: the index step is done
    out = os.path.join(world.dir, "device.sam")
    args = ["align", "-r", world.ref, "-s", _bucket(world), "-o", out]
    os.environ["EMA_TPU_STAGE_TIMERS"] = "1"
    try:
        c0 = clog.mark()
        t0 = time.perf_counter()
        _cli(args)
        cold = time.perf_counter() - t0
        c1 = clog.mark()
        t0 = time.perf_counter()
        err = _cli(args)
        warm = time.perf_counter() - t0
        c2 = clog.mark()
    finally:
        os.environ.pop("EMA_TPU_STAGE_TIMERS")
    spans = _spans(err)
    if "sw[device]" not in spans or "em[device]" not in spans:
        raise AssertionError(f"c. stage spans lack sw[device]/em[device]: "
                             f"{sorted(spans)}")
    n_pairs = int(spans["align"][1].split("n=")[1].split()[0])
    align_s = spans["align"][0]
    stats = jax.local_devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", -1)
    timed(f"c. device path (CLI): {n_pairs} pairs, {n_pairs / align_s:.0f} "
          f"pairs/s (warm align {align_s:.2f} s; CLI call cold "
          f"{cold:.1f} s, warm {warm:.1f} s)")
    timed(f"c. compile: {c1[1] - c0[1]} compiles and {c1[2] - c0[2]} "
          f"persistent-cache hits, {c1[0] - c0[0]:.1f} s trace+lower+compile "
          f"in the cold call; {c2[1] - c1[1]} compiles in the warm call")
    log(f"c. peak device memory: {peak / 2**30:.2f} GiB "
        f"(peak_bytes_in_use {peak})")
    chunk_s = sum(v[0] for k, v in spans.items() if "[" in k)
    for k, (s, rest) in sorted(spans.items()):
        timed(f"c. device path span {k}: {s:.2f} s {rest}")
    sw_s = spans["sw[device]"][0]
    log(f"c. SW share: sw[device] {sw_s:.2f} thread-s = "
        f"{100 * sw_s / align_s:.1f}% of the align wall, "
        f"{100 * sw_s / chunk_s:.1f}% of all stage thread-seconds")

    from ema_tpu import config

    # end-to-end SW A/B: the device path with SW moved to the host scorer
    ab = _warm_aligner(world, idx, "device path, SW on host",
                       config.RunConfig(), EMA_TPU_SW_IMPL="native")
    n_rec = _sam_equal(out, ab, "c. SW on device vs SW on host")
    log(f"c. SW on device SAM == SW on host SAM: {n_rec} records")
    host = _warm_aligner(world, idx, "host path",
                         config.RunConfig(device_em=False),
                         EMA_TPU_SW_IMPL="native", EMA_TPU_SEED_IMPL="native")
    n_rec = _sam_equal(out, host, "c. device vs host")
    log(f"c. device SAM == host SAM by samdiff: {n_rec} records, every "
        "field (pos/flag/cigar/mapq/BX/XG/MI/mate/seq/XA)")
    n, ok, hi, hi_wrong = _accuracy(out, world)
    log(f"c. accuracy vs truth: {ok}/{n} primary records within 5 bp "
        f"({100 * ok / n:.3f}%); wrong at mapq>=30: {hi_wrong}/{hi}")
    if ok < 0.95 * n or hi_wrong > 0.01 * max(hi, 1):
        raise AssertionError("c. accuracy below 95% at truth or above 1% "
                             "wrong at mapq>=30")


# ----------------------------------------------------------------------
# phase d: four cards
# ----------------------------------------------------------------------

def phase_d(world, idx, devs) -> None:
    import jax
    import jax.numpy as jnp

    from ema_tpu import config, io as io_mod
    from ema_tpu.core.pipeline import Aligner
    from ema_tpu.index import fmindex
    from ema_tpu.parallel import make_mesh, make_sharded_candidate_step
    from ema_tpu.parallel.step import candidate_core

    preprocess(world)
    batch = io_mod.read_special_fastq(_bucket(world))
    n = len(batch.ids)
    progress("d. Aligners: building")
    meshed = Aligner(idx, config.RunConfig())
    if meshed._data_sharding is None \
            or meshed._data_sharding.mesh.size != len(devs):
        raise AssertionError("d. the Aligner did not mesh over the cards")
    single = Aligner(idx, config.RunConfig(data_parallel_chips=False))
    res = {}
    for name, al in (("meshed", meshed), ("single", single)):
        for p in ("cold", "warm"):
            progress(f"d. {name} Aligner, {p} pass: start")
            t0 = time.perf_counter()
            res[name] = al.align_batch_to_sam(batch)
            dt = time.perf_counter() - t0
            progress(f"d. {name} Aligner, {p} pass: {n} pairs in {dt:.1f} "
                     f"s ({n / dt:.0f} pairs/s)")
    if res["meshed"] != res["single"]:
        n_bad = sum(a != b for a, b in zip(res["meshed"], res["single"]))
        raise AssertionError(f"d. meshed SAM differs from one card on "
                             f"{n_bad} lines")
    log(f"d. meshed over {len(devs)} cards == one card: "
        f"{len(res['meshed'])} SAM lines identical")

    reads, _ = world.pairs()
    m = min(4096, reads.shape[0]) // 4 * 4
    reads = jnp.asarray(reads[:m].astype(np.int32))
    lens = jnp.full(m, READ_LEN, jnp.int32)
    fm = fmindex.FMIndexArrays.from_index(idx)
    text = jnp.asarray(idx.text)
    static = dict(max_seeds=4, window_pad=12, min_seed_len=19)
    best, gpos = candidate_core(fm, text, reads, lens, 0, hits_per_seed=8,
                                n_cand_shards=1, **static)
    step = make_sharded_candidate_step(make_mesh(2, 2, devs), fm, text,
                                       hits_per_seed=4, **static)
    progress("d. sharded candidate step: start")
    out = jax.block_until_ready(step(reads, lens))
    faulthandler.cancel_dump_traceback_later()
    b = np.asarray(best)
    if not (np.array_equal(np.asarray(out.best_score), b)
            and np.array_equal(np.asarray(out.best_gpos), np.asarray(gpos))
            and int(out.n_aligned) == int((b > 0).sum())
            and int(out.sum_score) == int(b[b > 0].sum())):
        raise AssertionError("d. sharded candidate step != candidate_core")
    log(f"d. sharded candidate step on a (2, 2) mesh == candidate_core on "
        f"one card: {m} reads, {int(out.n_aligned)} aligned")


# ----------------------------------------------------------------------

def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run phase d (four cards) and nothing else")
    ap.add_argument("--seed", type=int, default=20,
                    help="seed of the simulated genome and reads")
    a = ap.parse_args(argv)

    n_cards = 4 if a.four else 1
    devs = require_gpus(n_cards)
    smi = nvidia_smi()
    for line in smi:
        log(line)
    CARD = smi[0]
    clog = CompileLog()
    phase_a(devs)

    from ema_tpu.core.pipeline import Aligner

    world = World(a.seed, GENOME_BP, N_PAIRS)
    world.build()
    idx = world.index()
    if a.four:
        phase_d(world, idx, devs)
    else:
        preprocess(world)
        aligner = Aligner(idx)
        print_placement(aligner)
        phase_b(world, idx, aligner)
        del aligner
        phase_c(world, idx, clog)
    log(f"card: {CARD}")
    log(contract_line(devs[0].platform, devs[0].device_kind, len(devs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
