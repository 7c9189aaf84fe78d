"""The align pipeline: batched candidate generation + per-barcode EM.

Stage layout (host <-> device choreography; compare the reference call
stack in SURVEY.md §3.1):

  1. encode reads (host); revcomp rows derived on device
                                             [read_fastq_* in the reference]
  2. seeding: FM backward search + locate    [mem_align1_core seeding, L0]
     (device, batched over forward rows; or SMEM in threaded host C++)
  3. chaining (host, vectorized numpy)       [mem_chain]
  4. SW scoring of all candidate windows     [banded extension]
     (device, one batched wavefront)
  5. mate rescue windows + second SW pass    [mem_matesw, bwabridge.c:213-283]
  6. CIGAR traceback for survivors (C++)     [mem_reg2aln per kept candidate]
  7. generative rescoring + mapq (host)      [score_alignment, align.c:846-913]
  8. per-barcode clouds + EM + selection     [find_clouds_and_align core]
  9. SAM emission (host)                     [print_sam_record]
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Dict, Iterator, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ema_tpu import config, native
from ema_tpu.core import groups as groups_mod
from ema_tpu.core import samout
from ema_tpu.core import score as score_mod
from ema_tpu.core.records import RECORD_DTYPE, empty_records
from ema_tpu.index import fmindex
from ema_tpu.ops import chaining
from ema_tpu.ops.sw import sw_score_banded, sw_score_batch

_BASE_LUT = np.full(256, 4, dtype=np.uint8)
for _b, _c in zip(b"ACGTacgt", [0, 1, 2, 3, 0, 1, 2, 3]):
    _BASE_LUT[_b] = _c

WINDOW_PAD = 24          # slack around the chain diagonal for the SW window
MAX_CIGAR_OPS = 64

# shape-bucketing granularity: device calls are padded up to these multiples
# so XLA compiles a handful of program shapes instead of one per batch
ROW_BUCKET = 256         # oriented-read rows (seeding)
CAND_BUCKET = 512        # candidate pairs (SW scoring)
WIN_BUCKET = 64          # SW ref-window width
SW_CHUNK = 16 * 4096     # max candidate pairs per SW device call
LANE = 128               # banded-SW lane granularity (w_band rounds up to
                         # it; a starting value, not yet measured on the
                         # H100)
# occ-table size above which seeding/locate run as device programs on an
# accelerator: below it the table stays cache-resident for the host C++
# rank walk; above it the device's memory bandwidth wins.  A starting
# value, not yet measured on the H100.
DEVICE_FM_MIN_OCC_BYTES = 128 << 20

# Meshed device programs hold collectives, and every device must run them
# in one order.  Chunk workers (and the per-shard Aligners of a
# ShardedAligner) launch them from several threads; unserialized, two
# programs can reach the devices' queues in different orders, and each
# device then waits in a different program's rendezvous for ever.  One
# process-wide lock, since all meshes span the same local devices.
_MESH_LOCK = threading.Lock()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_rows(n: int, cap: int, lo: int = 256) -> int:
    """Pad row counts to power-of-two buckets up to ``cap``.

    Small inputs (tiny -x buckets of a few hundred pairs) would otherwise
    pad straight to the full device-chunk shape and waste most of the
    seeding scan; pow2 buckets give at most ~6 compile shapes, reused
    across buckets, with <2x padding waste.
    """
    p = lo
    while p < n and p < cap:
        p *= 2
    if n <= p:
        return p
    return _round_up(n, ROW_BUCKET)


@jax.jit
def _orient_device(spad, slpad):
    """[R, L] forward codes -> [2R, L] forward+revcomp rows on device.

    The SW scorer needs both orientations; deriving the reverse
    complement on device halves the host->device upload per chunk
    (the read matrix is the largest transfer).
    """
    L = spad.shape[1]
    pos = slpad[:, None] - 1 - jnp.arange(L, dtype=jnp.int32)[None, :]
    valid = pos >= 0
    src = jnp.take_along_axis(spad, jnp.maximum(pos, 0), axis=1)
    rc = jnp.where(src < 4, 3 - jnp.minimum(src, 3), 4).astype(spad.dtype)
    rc = jnp.where(valid, rc, jnp.asarray(4, spad.dtype))
    return (jnp.concatenate([spad, rc], axis=0),
            jnp.concatenate([slpad, slpad]))


@functools.partial(jax.jit, static_argnames=(
    "w_max", "w_band", "match", "mismatch", "gap_open", "gap_extend",
    "clip", "sw_impl"))
def _gather_score(text, oriented, olens, owners, win_lo, win_len, wl, *,
                  w_max, w_band, match, mismatch, gap_open, gap_extend,
                  clip, sw_impl="banded"):
    """Gather reads + ref windows on device, then batched SW scoring.

    Window columns outside the text mask to sentinel 5 (win_lo may be
    negative at a contig start — ops/chaining.py keeps window diagonals
    >= 0 that way, the banded kernel's corridor invariant).
    """
    n = text.shape[0]
    reads = oriented[owners].astype(jnp.int32)
    rlens = olens[owners]
    cols = win_lo[:, None] + jnp.arange(w_max, dtype=jnp.int32)
    gathered = text[jnp.clip(cols, 0, n - 1)].astype(jnp.int32)
    wins = jnp.where((cols < 0) | (cols >= n), 5, gathered)
    if sw_impl == "banded":
        sw_fn = functools.partial(sw_score_banded, w_band=w_band, wl=wl)
    else:
        sw_fn = sw_score_batch
    return sw_fn(reads, rlens, wins, win_len,
                 match=match, mismatch=mismatch, gap_open=gap_open,
                 gap_extend=gap_extend, clip=clip)


@dataclasses.dataclass
class ReadBatch:
    """P read pairs, host-side."""

    ids: List[str]
    bc: np.ndarray               # uint64 [P]
    seqs: List[str]              # [2P], mate-interleaved (2*i + mate)
    quals: List[str]
    codes: np.ndarray            # uint8 [2P, L]
    lens: np.ndarray             # int32 [2P]

    @classmethod
    def from_pairs(cls, ids, bcs, seq1, qual1, seq2, qual2) -> "ReadBatch":
        P = len(ids)
        # mate-interleave via slice assignment (C speed; the per-pair
        # Python loop cost ~0.1 s/pass at bench shapes)
        seqs: List[str] = [None] * (2 * P)
        quals: List[str] = [None] * (2 * P)
        seqs[0::2] = seq1
        seqs[1::2] = seq2
        quals[0::2] = qual1
        quals[1::2] = qual2
        # vectorized code-matrix fill: one blob decode + scatter (the
        # per-read loop dominated host time at bench shapes)
        lens = np.fromiter((len(s) for s in seqs), np.int32, 2 * P)
        L = max(int(lens.max()) if P else 1, 1)
        codes = np.full((2 * P, L), 4, np.uint8)
        if P:
            flat = np.frombuffer("".join(seqs).encode(), np.uint8)
            rows = np.repeat(np.arange(2 * P), lens)
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            cols = np.arange(flat.shape[0]) - np.repeat(starts, lens)
            codes[rows, cols] = _BASE_LUT[flat]
        return cls(list(ids), np.asarray(bcs, np.uint64), seqs, quals,
                   codes, lens)


@dataclasses.dataclass
class CandidateSet:
    """Flat candidate arrays over one batch (owner = oriented read index)."""

    owner: np.ndarray            # int64 [N] read index 0..2P-1
    rev: np.ndarray              # int8 [N]
    gpos: np.ndarray             # int64 [N] text pos of alignment start
    chrom: np.ndarray            # int32 [N]
    pos_local: np.ndarray        # int64 [N] 1-based contig-local position
    sw: np.ndarray               # int32 [N]
    qb: np.ndarray               # int32
    qe: np.ndarray               # int32
    clip: np.ndarray             # int32
    nm: np.ndarray               # int32
    cigars: np.ndarray           # uint32 [N, MAX_CIGAR_OPS]
    n_cigar: np.ndarray          # int32
    seedcov: np.ndarray          # int32
    sub: np.ndarray              # int32 per-candidate: best other sw score
    sub_n: np.ndarray            # int32
    frac_rep: np.ndarray         # float32
    unique: np.ndarray           # bool


def on_accelerator() -> bool:
    """True when JAX's default backend is an accelerator (not the CPU)."""
    return jax.default_backend() != "cpu"


SW_IMPLS = ("banded", "scan", "native")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where each align stage runs, resolved once per Aligner.

    ``sw``: "banded" (XLA row-sweep on the default device), "scan" (the
    anti-diagonal XLA scan) or "native" (threaded host C++).
    ``host_fm``: greedy seeding and SA locate in host C++ instead of the
    device FM programs.  SMEM seeding (the default seeder) always runs in
    host C++; EM placement follows ``RunConfig.device_em``.
    """

    sw: str
    host_fm: bool
    batch_size: int
    inflight_chunks: int


def resolve_placement(occ_bytes: int) -> Placement:
    """The placement rule: device stages on an accelerator, host C++ on
    CPU backends (where the threaded host kernels beat XLA:CPU ~7-10x at
    pipeline shapes).  On an accelerator, seeding/locate stay on the host
    while the occ table is small enough to be cache-resident
    (DEVICE_FM_MIN_OCC_BYTES).  ``EMA_TPU_SW_IMPL`` (banded|scan|native)
    and ``EMA_TPU_SEED_IMPL`` (device|native) override the rule.
    """
    import os
    accel = on_accelerator()
    sw = os.environ.get("EMA_TPU_SW_IMPL")
    if sw not in SW_IMPLS:
        sw = "banded" if accel else "native"
    seed = os.environ.get("EMA_TPU_SEED_IMPL")
    if seed in ("native", "device"):
        host_fm = seed == "native"
    else:
        host_fm = not accel or occ_bytes <= DEVICE_FM_MIN_OCC_BYTES
    return Placement(sw=sw, host_fm=host_fm,
                     batch_size=4096 if accel else 2048,
                     inflight_chunks=4 if accel else 5)


class Aligner:
    """Holds the index on device and runs batched alignment."""

    def __init__(self, index, cfg: Optional[config.RunConfig] = None):
        from ema_tpu.utils.backend import ensure_backend
        ensure_backend()
        self.index = index
        self.cfg = cfg or config.RunConfig()
        self.placement = resolve_placement(index.occ_blocks.nbytes)
        pl = self.placement
        # SMEM + re-seeding is the reference's seeding semantics (BWA-MEM
        # mem_align1_core) and the default everywhere: greedy
        # maximal-suffix seeding cannot see diverged repeat copies (a
        # maximal segment's interval only holds loci matching the whole
        # segment), which CHAIN_r05 measured as 60% vs 100% recall of
        # near-co-optimal loci.  Greedy stays an opt-in fast mode.
        self.cfg = dataclasses.replace(
            self.cfg,
            batch_size=self.cfg.batch_size or pl.batch_size,
            inflight_chunks=self.cfg.inflight_chunks or pl.inflight_chunks,
            device_em=(True if self.cfg.device_em is None
                       else self.cfg.device_em),
            aligner=dataclasses.replace(
                self.cfg.aligner,
                seeding=self.cfg.aligner.seeding or "smem"))
        # device-resident FM arrays and genome, only where a device
        # program reads them
        self.fma = (None if pl.host_fm
                    else fmindex.FMIndexArrays.from_index(index))
        self.text_dev = (None if pl.sw == "native"
                         else jnp.asarray(index.text))
        self._cloud_id = 0
        self._id_lock = threading.Lock()   # MI ids under concurrent buckets
        self._contig_blob = None
        self._defer_dist_window = False
        # optional (batch, CandidateSet) tap for the reference-oracle
        # replay (utils/replay.ReplayWriter.add); called from chunk
        # workers, so a sink must be thread-safe
        self.replay_sink = None
        # optional fine-grained stage timers (utils/metrics.Metrics):
        # set to publish the host/device time split; chunk workers run
        # concurrently, so stage sums are thread-seconds, not wall
        self.metrics = None
        self._dev_lock = contextlib.nullcontext()
        self._init_mesh()

    def placement_table(self) -> Dict[str, str]:
        """Stage -> where it runs, as resolved for this Aligner."""
        dev = jax.default_backend()
        host_fm = self.placement.host_fm
        smem = self.cfg.aligner.seeding == "smem"
        return {
            "seed": ("host C++ (smem)" if smem
                     else "host C++ (greedy)" if host_fm
                     else f"{dev} (greedy)"),
            "locate": "host C++" if host_fm else dev,
            "sw": ("host C++" if self.placement.sw == "native"
                   else f"{dev} (XLA {self.placement.sw})"),
            "em": f"{dev} (em_jax)" if self.cfg.device_em else "host",
            "batch_size": str(self.cfg.batch_size),
            "inflight_chunks": str(self.cfg.inflight_chunks),
        }

    def _init_mesh(self) -> None:
        """Multi-chip: shard batched device calls over a data mesh.

        With N>1 local devices, read rows / candidate pairs shard along a
        'data' axis (the index is replicated, as the reference replicates
        its BWA index per process) and XLA partitions the jitted seeding/
        scoring programs; all shape buckets are multiples of common device
        counts.  Single chip: plain single-device dispatch.
        """
        self._data_sharding = None
        # LOCAL devices only: under jax.distributed each host aligns its
        # own bucket shard independently (buckets hashed to hosts over
        # the network, batches over the host's devices — SURVEY §5.8); a
        # global mesh would demand identical per-process data
        devs = jax.local_devices()
        if len(devs) <= 1 or not self.cfg.data_parallel_chips:
            return
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ema_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(len(devs), 1, devs)
        self._data_sharding = NamedSharding(mesh, P("data"))
        # device programs launch one at a time (host stages still overlap)
        self._dev_lock = _MESH_LOCK
        repl = NamedSharding(mesh, P())
        if self.text_dev is not None:
            self.text_dev = jax.device_put(self.text_dev, repl)
        if self.fma is not None:
            self.fma = jax.device_put(self.fma, repl)

    def _shard_rows(self, x: np.ndarray):
        """Device-put a batch array, sharded along axis 0 when meshed."""
        if self._data_sharding is not None \
                and x.shape[0] % self._data_sharding.mesh.size == 0:
            return jax.device_put(x, self._data_sharding)
        return jnp.asarray(x)

    def _smem_kmer_tab(self):
        """Per-index k-mer bi-interval table for SMEM round 3 (lazy).

        Built once (~20 ms, 24 MB at k=10) and shared by every chunk's
        smem_seed_batch call; output-identical to seeding without it.
        EMA_TPU_SMEM_KMER sets k (0 disables).
        """
        tab = getattr(self, "_smem_ktab", False)
        if tab is False:
            with self._id_lock:    # chunk workers race the first build
                tab = getattr(self, "_smem_ktab", False)
                if tab is False:
                    import os as _os
                    k = int(_os.environ.get("EMA_TPU_SMEM_KMER", "10"))
                    tab = None
                    if k > 0:
                        from ema_tpu import native as _native
                        idx = self.index
                        tab = _native.smem_kmer_table(
                            idx.occ_blocks, idx.counts, idx.primary,
                            idx.fm_n, k=k)
                    self._smem_ktab = tab
        return tab

    # ------------------------------------------------------------------
    # candidate generation
    # ------------------------------------------------------------------

    def _mst(self, name: str, n_items: int = 0):
        return (self.metrics.stage(name, n_items) if self.metrics
                else contextlib.nullcontext())

    def generate_candidates(self, batch: ReadBatch) -> CandidateSet:
        params = self.cfg.aligner
        idx = self.index
        codes, lens = batch.codes, batch.lens
        n_reads, L = codes.shape

        # orient: rows [0, n_reads) forward, [n_reads, 2n) reverse-complement
        pos = lens[:, None] - 1 - np.arange(L)[None, :]
        valid = pos >= 0
        src = np.take_along_axis(codes, np.maximum(pos, 0), axis=1)
        rc_vals = np.where(src < 4, 3 - np.minimum(src, 3), 4).astype(np.uint8)
        # NB: not np.putmask — its values are indexed by flat position
        # modulo len(values), which scrambles rows when reads have
        # different lengths (partial masks)
        rc = np.where(valid, rc_vals, np.uint8(4))
        oriented = np.concatenate([codes, rc], axis=0)
        olens = np.concatenate([lens, lens])

        # --- seed ---------------------------------------------------------
        # both strands live in the FM text, so only the FORWARD read is
        # seeded (half the rows); reverse-strand hits land in the upper
        # half of the FM coordinate space.  The padded forward rows are
        # uploaded ONCE; the reverse-complement rows the SW scorer needs
        # are derived on device (_orient_device) instead of uploaded.
        rows_pad = _pow2_rows(n_reads, 2 * self.cfg.batch_size)
        # the full-native CPU path (host seeding/locate + host SW) never
        # touches the device inside candidate generation — skip the padded
        # upload and the on-device revcomp derivation entirely
        pl = self.placement
        full_native = pl.host_fm and pl.sw == "native"
        if full_native:
            spad_dev = slpad_dev = opad_dev = lpad_dev = None
        else:
            spad = np.full((rows_pad, L), 4, np.uint8)
            spad[:n_reads] = codes
            slpad = np.zeros(rows_pad, np.int32)
            slpad[:n_reads] = lens
            with self._dev_lock:
                spad_dev = self._shard_rows(spad)
                slpad_dev = self._shard_rows(slpad)
                # device rows for SW: [0, rows_pad) fwd, [rows_pad,
                # 2*rows_pad) revcomp — logical oriented read r maps to
                # device row r if r < n_reads else rows_pad + (r - n_reads)
                opad_dev, lpad_dev = _orient_device(spad_dev, slpad_dev)
        row_map = (n_reads, rows_pad)

        seed_stack = nsd = hp = None
        if params.seeding == "smem":
            # full SMEM enumeration + re-seeding in threaded host C++
            # (bwt_smem1 semantics); overlaps with device SW of the
            # previous in-flight chunk
            with self._mst("seed[smem,host]", n_reads):
                sm = native.smem_seed_batch(
                    idx.occ_blocks, idx.counts, idx.primary, idx.fm_n,
                    codes, lens,
                    min_seed_len=params.min_seed_len,
                    split_len=int(params.min_seed_len * 1.5 + 0.499),
                    split_width=params.split_width,
                    max_mem_intv=params.max_mem_intv,
                    kmer_tab=self._smem_kmer_tab())
                # keep the native int32 planes as-is: stacking + int64
                # widening here cost ~0.6 s/pass in fresh-mmap page
                # faults (the [4, B, 64] int64 temp is re-mapped every
                # chunk); _compact_seed_hits gathers then widens only
                # the compacted vectors
                seed_stack = sm[:4]
                nsd = sm[4]
        elif self.placement.host_fm:
            # greedy chop in host C++ (value-identical to the device
            # seeder; CPU backends — the scalar rank walk beats the
            # XLA:CPU scan ~7x and skips the device roundtrip)
            with self._mst("seed[native,host]", n_reads):
                sm = native.greedy_seed_batch(
                    idx.occ_blocks, idx.counts, idx.primary, idx.fm_n,
                    codes, lens, min_seed_len=params.seed_len,
                    max_seeds=16)
                seed_stack = sm[:4]
                nsd = sm[4]
        else:
            # greedy maximal-suffix chop, fused with hit compaction and
            # SA locate in ONE device program (fmindex.seed_locate_reads)
            # — the two-step path crosses the host-device boundary twice
            budget = 4 * rows_pad
            with self._mst("seed+locate[device]", n_reads), self._dev_lock:
                packed, total_dev, frd = fmindex.seed_locate_reads(
                    self.fma, spad_dev, slpad_dev, max_seeds=16,
                    min_seed_len=params.seed_len,
                    max_hits=params.max_hits_per_seed, budget=budget,
                    max_occ=params.max_occ)
                total = int(total_dev)
                if total <= budget:
                    ph = np.asarray(packed)
                    frac_rep_read = np.asarray(frd)[:n_reads]
                    owner = ph[0, :total].astype(np.int64)
                    qb = ph[1, :total].astype(np.int64)
                    slen = ph[2, :total].astype(np.int64)
                    hp = ph[3, :total].astype(np.int64)
            if hp is None:
                # hit-budget overflow (deep-repeat chunk): fall back to
                # the unbounded two-step path
                with self._mst("seed[device]", n_reads), self._dev_lock:
                    s_lo, s_hi, s_qb, s_len, n_seeds = fmindex.seed_reads(
                        self.fma, spad_dev, slpad_dev,
                        max_seeds=16, min_seed_len=params.seed_len)
                    seed_stack = tuple(
                        np.asarray(a)[:n_reads]
                        for a in (s_lo, s_hi, s_qb, s_len))
                    nsd = np.asarray(n_seeds)[:n_reads]

        if hp is None:
            # --- host: compact seed hits; device: locate real rows ------
            # (one small stacked transfer; most SA intervals hold 1-2 rows,
            # so locating the dense [B, S, K] expansion would be ~1000x
            # wasted work) repeat fraction per physical read: fraction of
            # read bases covered by seeds whose SA interval exceeds max_occ
            # (BWA's l_rep/frac_rep, consumed by the mapq formula the
            # reference adapted, align.c:958-984).  Greedy seeds are
            # disjoint in read coords; SMEMs may overlap, so the sum
            # over-counts — clip to 1.
            n_s = seed_stack[0].shape[1]
            s_live = np.arange(n_s)[None, :] < nsd[:, None]
            s_width = np.where(s_live, seed_stack[1] - seed_stack[0], 0)
            l_rep = np.where(s_width > params.max_occ,
                             seed_stack[3], 0).sum(axis=1)
            frac_rep_read = np.minimum(
                l_rep / np.maximum(lens, 1), 1.0).astype(np.float32)

            owner, qb, slen, rows_flat = _compact_seed_hits(
                seed_stack, nsd, params.max_hits_per_seed)
            if self.placement.host_fm:
                # host LF walk (smem seeding lands here too on CPU)
                with self._mst("locate[native,host]", rows_flat.shape[0]):
                    hp = native.locate_batch(idx, rows_flat)
            else:
                with self._mst("locate[device]", rows_flat.shape[0]), \
                        self._dev_lock:
                    hp = locate_rows_bucketed(self.fma, rows_flat,
                                              self._shard_rows)

        # map both-strands hits to (oriented read, forward-text pos):
        # a hit at fm pos p >= n is the reverse strand — the REVCOMP of the
        # read matches the forward text at 2n - p - seed_len, and the seed's
        # read offset flips to the rc-read frame (bwabridge.c:319-332)
        n_fwd = idx.n
        strand = hp >= n_fwd
        # drop hits crossing the fw|rc boundary; anything else is fully on
        # one strand and tpos is non-negative by construction
        keep = strand | (hp + slen <= n_fwd)
        tpos = np.where(strand, 2 * n_fwd - hp - slen, hp)
        rl = lens[owner].astype(np.int64)
        qb2 = np.where(strand, rl - qb - slen, qb)
        owner2 = owner + strand * n_reads
        owner2, qb2, slen, tpos = (owner2[keep], qb2[keep], slen[keep],
                                   tpos[keep])

        read_lens2 = olens.astype(np.int64)
        with self._mst("chain[host]", owner2.shape[0]):
            cands = chaining.chain_hits(
                owner2, qb2, slen, tpos, 2 * n_reads, read_lens2, idx.n,
                band_width=params.band_width, pad=WINDOW_PAD,
                max_candidates=params.max_candidates_per_read)

        co = cands.owner
        win_lo = cands.win_lo
        win_len = cands.win_len
        seedcov = cands.seedcov
        weight = cands.weight

        # --- score all candidate windows (device, or host C++) ---------
        sw_stage = "sw[host]" if pl.sw == "native" else "sw[device]"
        with self._mst(sw_stage, co.shape[0]):
            sw = self._score_windows(opad_dev, lpad_dev, co, win_lo,
                                     win_len, row_map, olens_host=olens,
                                     oriented_host=oriented,
                                     wl=cands.wl)

        # --- mate rescue ------------------------------------------------
        ro, rlo, rlen = self._rescue_windows(
            n_reads, olens, co, win_lo, sw["score"], params)
        if ro.shape[0]:
            with self._mst(sw_stage, ro.shape[0]):
                # rescue = full SW over the insert window (mem_matesw):
                # the corridor is the whole window, no chain constraint
                rsw = self._score_windows(opad_dev, lpad_dev, ro, rlo,
                                          rlen, row_map, olens_host=olens,
                                          oriented_host=oriented,
                                          wl=rlen.astype(np.int32))
            min_rescue = params.min_seed_len * params.match
            keep_r = rsw["score"] >= min_rescue
            co = np.concatenate([co, ro[keep_r]])
            win_lo = np.concatenate([win_lo, rlo[keep_r]])
            win_len = np.concatenate([win_len, rlen[keep_r]])
            seedcov = np.concatenate(
                [seedcov, (rsw["qe"] - rsw["qb"])[keep_r].astype(np.int32)])
            weight = np.concatenate(
                [weight, rsw["score"][keep_r].astype(np.int32)])
            sw = {k: np.concatenate([sw[k], rsw[k][keep_r]]) for k in sw}

        with self._mst("traceback+finalize[host]", co.shape[0]):
            return self._finalize_candidates(
                batch, oriented, olens, n_reads, co, win_lo, win_len,
                seedcov, weight, sw, params, frac_rep_read)

    def _score_windows(self, oriented_dev, olens_dev, owners, win_lo,
                       win_len, row_map=None, olens_host=None,
                       oriented_host=None, wl=None):
        """Score candidate (read, window) pairs.

        ``oriented_dev``/``olens_dev`` are the device-resident padded read
        arrays (forward rows then device-derived revcomp rows); only the
        small per-candidate index vectors cross the host->device boundary
        — reads and ref windows are gathered on device (the genome lives
        in HBM, self.text_dev).  ``row_map = (n_reads, rows_pad)`` maps
        logical oriented-read ids to device rows.

        ``wl`` (int32 [N]) is the per-candidate LOGICAL corridor:
        diagonals k >= wl[b] are excluded in every kernel (host and
        device), so a candidate's result depends only on its own chain
        geometry (ops/chaining.py emits it) — not on the physical lane
        padding of the kernel that scored it, nor on which candidates
        share the call/chunk.  None = the full window (mate rescue).
        """
        N = owners.shape[0]
        if N == 0:
            z = np.zeros(0, np.int32)
            return {"score": z, "qb": z, "qe": z, "ref_end": z}
        # very large candidate sets (deep-repeat batches under the
        # max_occ-scale hit caps) run in fixed-size chunks: bounds device
        # memory for the [N, Wmax] window gather and reuses one compiled
        # program for the big chunks
        wl_cand = np.maximum(wl if wl is not None else win_len,
                             1).astype(np.int32)
        if self.placement.sw == "native" and oriented_host is not None \
                and olens_host is not None:
            # threaded host C++ banded DP straight off the packed text —
            # the CPU-backend scorer (no device roundtrip, no padding;
            # per-candidate exact corridor, ~2.5x fewer inner iterations
            # than the 128-rounded band at pipeline shapes)
            w_band = int(wl_cand.max()) if N else 1
            return native.sw_banded_native(
                oriented_host, olens_host, self.index.text, owners,
                win_lo, win_len, w_band,
                match=self.cfg.aligner.match,
                mismatch=self.cfg.aligner.mismatch,
                gap_open=self.cfg.aligner.gap_open,
                gap_extend=self.cfg.aligner.gap_extend,
                clip=self.cfg.aligner.clip_penalty, wl=wl_cand)
        if N > SW_CHUNK:
            outs = [self._score_windows(
                        oriented_dev, olens_dev, owners[s:s + SW_CHUNK],
                        win_lo[s:s + SW_CHUNK], win_len[s:s + SW_CHUNK],
                        row_map, olens_host=olens_host,
                        oriented_host=oriented_host,
                        wl=wl_cand[s:s + SW_CHUNK])
                    for s in range(0, N, SW_CHUNK)]
            return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        # physical band width: lane-aligned cover of the widest logical
        # corridor in this call (the per-candidate wl mask makes results
        # independent of this padding) — computed on LOGICAL oriented
        # ids, before the device-row remap
        Wmax = _round_up(int(win_len.max()), WIN_BUCKET)
        if self.placement.sw == "banded":
            w_band = _round_up(max(int(wl_cand.max()), 1), LANE)
            w_band = min(w_band, _round_up(Wmax, LANE))
        else:
            w_band = _round_up(Wmax, LANE)
        if row_map is not None:
            n_fw, rpad = row_map
            owners = np.where(owners < n_fw, owners,
                              owners - n_fw + rpad)
        # bucket both the batch and window axes to bound compile shapes
        Npad = _round_up(N, CAND_BUCKET)
        own = np.zeros(Npad, np.int32)
        own[:N] = owners
        wlo = np.zeros(Npad, np.int32)
        wlo[:N] = win_lo
        wlen = np.zeros(Npad, np.int32)
        wlen[:N] = win_len
        wlp = np.zeros(Npad, np.int32)
        wlp[:N] = wl_cand
        p = self.cfg.aligner
        with self._dev_lock:
            out = jax.device_get(_gather_score(
                self.text_dev, oriented_dev, olens_dev,
                self._shard_rows(own), self._shard_rows(wlo),
                self._shard_rows(wlen), self._shard_rows(wlp),
                w_max=Wmax, w_band=w_band, match=p.match,
                mismatch=p.mismatch,
                gap_open=p.gap_open, gap_extend=p.gap_extend,
                clip=p.clip_penalty, sw_impl=self.placement.sw))
        return {k: np.asarray(v)[:N] for k, v in out.items()}

    def _rescue_windows(self, n_reads, olens, co, win_lo, sw_score, params):
        """Mate-rescue windows, fully vectorized (reference
        pes = {-35, 500, 200, 100}, FR orientation only —
        bwabridge.c:213-231)."""
        if co.shape[0] == 0:
            return (np.zeros(0, np.int64),) * 3
        olens = olens.astype(np.int64)
        # best score per oriented read
        best = np.zeros(2 * n_reads, np.int64)
        np.maximum.at(best, co, sw_score)

        # candidate anchor ~ window start + pad
        anchor = win_lo + WINDOW_PAD
        good = np.nonzero(sw_score >= best[co] - params.rescue_score_delta)[0]
        pad2 = WINDOW_PAD

        r = co[good]
        fwd = r < n_reads
        read = np.where(fwd, r, r - n_reads)
        pair, mate = read // 2, read % 2
        mread = pair * 2 + (1 - mate)
        # FR: mate aligns in the opposite orientation
        ro = mread + np.where(fwd, n_reads, 0)
        g = anchor[good]
        lb = olens[mread]
        g_end = g + olens[read]
        lo = np.where(fwd, g + params.pes_low - pad2,
                      g_end - params.pes_high - lb - pad2)
        hi = np.where(fwd, g + params.pes_high + lb + pad2,
                      g_end - params.pes_low + pad2)
        # lo unclamped: out-of-text columns mask to a sentinel in the
        # window gathers (keeps window diagonals >= 0 for the banded SW)
        hi = np.minimum(hi, self.index.n)
        rlen = (hi - lo).astype(np.int32)
        ok = rlen > params.min_seed_len
        ro, rlo, rlen = ro[ok].astype(np.int64), lo[ok], rlen[ok]
        if ro.shape[0] == 0:
            return (np.zeros(0, np.int64),) * 3

        # cap rescue attempts per mate side, best-scoring triggers first
        # (the reference attempts at most ~50 mate-SWs per side,
        # bwabridge.c:263-283) — without this, deep-repeat candidates
        # would each spawn a rescue window
        sc = sw_score[good][ok]
        n_k = ro.shape[0]
        order_r = np.lexsort((-sc, ro))
        ro_s = ro[order_r]
        firstr = np.ones(n_k, bool)
        firstr[1:] = ro_s[1:] != ro_s[:-1]
        idxr = np.arange(n_k)
        rankr = idxr - np.maximum.accumulate(np.where(firstr, idxr, 0))
        keep_cap = np.zeros(n_k, bool)
        keep_cap[order_r] = rankr < params.rescue_max_per_side
        ro, rlo, rlen = ro[keep_cap], rlo[keep_cap], rlen[keep_cap]
        if ro.shape[0] == 0:
            return (np.zeros(0, np.int64),) * 3

        # dedupe 1: skip a rescue whose window already holds a candidate of
        # the same oriented read (within band).  Existing windows sorted by
        # a composite (owner, pos) key; overlap = non-empty range query.
        span = np.int64(self.index.n) + 701
        ekeys = np.sort(co.astype(np.int64) * span + win_lo)
        lo_k = ro * span + (rlo - 600)
        hi_k = ro * span + (rlo + rlen)
        keep = np.searchsorted(ekeys, hi_k, side="right") \
            <= np.searchsorted(ekeys, lo_k, side="left")

        # dedupe 2: identical rescue windows (first occurrence wins)
        rkey = ro * span + (rlo // 64)
        _, first_idx = np.unique(rkey, return_index=True)
        uniq = np.zeros(ro.shape[0], bool)
        uniq[first_idx] = True
        keep &= uniq
        return ro[keep], rlo[keep], rlen[keep]

    def _finalize_candidates(self, batch, oriented, olens, n_reads,
                             co, win_lo, win_len, seedcov, weight, sw,
                             params, frac_rep_read=None) -> CandidateSet:
        """Order, filter, traceback, and assemble per-candidate arrays."""
        idx = self.index
        L_arr = olens[co] if co.shape[0] else np.zeros(0, np.int32)
        clip = (L_arr - (sw["qe"] - sw["qb"])).astype(np.int32)

        # order: per oriented read by score desc (reference: mem returns
        # score-sorted; best_dist comes from the first candidate)
        ord1 = np.lexsort((win_lo, -sw["score"], co))
        co, win_lo, win_len = co[ord1], win_lo[ord1], win_len[ord1]
        seedcov, weight, clip = seedcov[ord1], weight[ord1], clip[ord1]
        sw = {k: v[ord1] for k, v in sw.items()}

        # drop non-positive scores and heavy clipping (align.c:1015-1017)
        ok = (sw["score"] > 0) & (clip < L_arr[ord1] // 2)
        # pre-traceback survivors: a *score*-window bound on the later
        # edit-distance window (align.c:1020-1024) instead of a fixed
        # per-read rank cap.  One extra edit-distance unit costs at most
        # max(match+mismatch, gap_open+gap_extend+match) SW score vs the
        # leader (a scattered 1-bp indel is the worst case), so anything
        # below this margin cannot pass the EXTRA_SEARCH_DEPTH filter;
        # the per-orientation leader only widens the window (safe).  The
        # leader is the best *surviving* candidate (a clip-dropped top
        # scorer must not tighten the cutoff).
        # MAX_CANDIDATES (samdict.h:9) stays as the hard valve.
        n_rows_o = oriented.shape[0]
        lead_score = np.full(n_rows_o, np.iinfo(np.int32).min, np.int64)
        np.maximum.at(lead_score, co[ok], sw["score"][ok].astype(np.int64))
        per_edit = max(params.match + params.mismatch,
                       params.gap_open + params.gap_extend + params.match)
        margin = (config.EXTRA_SEARCH_DEPTH * per_edit
                  + 2 * params.gap_open + 2 * params.clip_penalty)
        ok &= sw["score"] >= lead_score[co] - margin
        # rank among surviving candidates per read (array is score-sorted)
        first = np.ones(co.shape[0], bool)
        first[1:] = co[1:] != co[:-1]
        c_ok = np.cumsum(ok.astype(np.int64))
        seg_base = np.maximum.accumulate(
            np.where(first, c_ok - ok.astype(np.int64), 0))
        ok &= (c_ok - 1 - seg_base) < config.MAX_CANDIDATES
        co, win_lo, win_len = co[ok], win_lo[ok], win_len[ok]
        seedcov, weight, clip = seedcov[ok], weight[ok], clip[ok]
        sw = {k: v[ok] for k, v in sw.items()}

        if co.shape[0] == 0:
            return _empty_candidate_set()

        # --- traceback for survivors: gapless shortcut + C++ DP ---------
        # one threaded native call; windows are read straight off the
        # packed genome text inside the kernel (no [N, Wmax] host gather,
        # so deep-repeat batches with ~10^6 near-tie survivors no longer
        # need chunking for RSS either)
        nat = native.traceback_batch(
            oriented, olens, co, idx.text, win_lo, win_len, sw,
            match=params.match, mismatch=params.mismatch,
            gap_open=params.gap_open, gap_extend=params.gap_extend,
            clip_penalty=params.clip_penalty, max_cigar=MAX_CIGAR_OPS)

        gpos = win_lo + nat["pos"]
        nm = nat["nm"].astype(np.int32)
        dist = nm + clip

        # edit-distance window filter vs the physical read's best-scoring
        # candidate across both strands (align.c:1020-1024: regs.a[0] of
        # the score-sorted region list, which spans strands).  As a shard
        # of a ShardedAligner the filter is deferred to the cross-shard
        # merge: a per-shard leader's window could drop candidates the
        # global leader's window keeps.
        phys = np.where(co >= n_reads, co - n_reads, co)
        if self._defer_dist_window:
            ok = np.ones(co.shape[0], bool)
        else:
            ok = _dist_window_keep(phys, sw["score"], dist, n_reads)
        # contig containment: alignment must not cross a contig boundary
        chrom = idx.contig_of(gpos).astype(np.int32)
        ref_len = _cigar_ref_len(nat["cigars"], nat["n_cigar"])
        ends = gpos + ref_len - 1
        ok &= (gpos >= 0) & (chrom == idx.contig_of(np.maximum(ends, gpos))) \
            & (nat["pos"] >= 0)

        co, win_lo = co[ok], win_lo[ok]
        seedcov, weight, clip = seedcov[ok], weight[ok], clip[ok]
        sw = {k: v[ok] for k, v in sw.items()}
        gpos, nm, chrom = gpos[ok], nm[ok], chrom[ok]
        cigars, n_cigar = nat["cigars"][ok], nat["n_cigar"][ok]

        # uniqueness + sub stats per oriented read.  ``sub`` (the best score
        # among the read's *other* candidates) feeds the BWA-shaped mapq;
        # both orientations of one read share the statistics, as in BWA
        # where alnregs of one read span both strands.
        N = co.shape[0]
        phys = np.where(co >= n_reads, co - n_reads, co)
        n_per = np.bincount(phys, minlength=n_reads)
        unique = n_per[phys] == 1
        _, sub = _best_and_sub(phys, sw["score"], n_reads)
        sub_n = np.maximum(n_per[phys] - 2, 0)

        rev = (co >= n_reads).astype(np.int8)
        pos_local = gpos - idx.offsets[chrom] + 1
        frac_rep = (frac_rep_read[phys].astype(np.float32)
                    if frac_rep_read is not None
                    else np.zeros(N, np.float32))

        return CandidateSet(
            owner=np.where(rev == 1, co - n_reads, co).astype(np.int64),
            rev=rev, gpos=gpos, chrom=chrom, pos_local=pos_local,
            sw=sw["score"].astype(np.int32),
            qb=sw["qb"].astype(np.int32), qe=sw["qe"].astype(np.int32),
            clip=clip.astype(np.int32), nm=nm,
            cigars=cigars, n_cigar=n_cigar.astype(np.int32),
            seedcov=seedcov.astype(np.int32),
            sub=sub.astype(np.int32), sub_n=sub_n.astype(np.int32),
            frac_rep=frac_rep,
            unique=unique)

    # ------------------------------------------------------------------
    # record assembly + group processing
    # ------------------------------------------------------------------

    def candidates_to_records(self, batch: ReadBatch, cs: CandidateSet,
                              pair_offset: int = 0):
        """CandidateSet -> RECORD_DTYPE array + ident array + cigar pool."""
        N = cs.owner.shape[0]
        recs = empty_records(N)
        pairs = cs.owner // 2
        mates = cs.owner % 2
        recs["bc"] = batch.bc[pairs]
        recs["chrom"] = cs.chrom
        recs["pos"] = cs.pos_local
        recs["pair"] = pairs + pair_offset
        recs["mate"] = mates.astype(np.int8)
        recs["rev"] = cs.rev
        score, score_mapq = score_mod.score_alignments(
            cs.cigars, cs.n_cigar, cs.nm, self.cfg.platform.error_rate)
        recs["score"] = score
        recs["score_mapq"] = score_mapq
        recs["mapq"] = score_mod.approx_mapq(
            cs.sw.astype(np.int64), cs.sub.astype(np.int64),
            (cs.qe - cs.qb).astype(np.int64), cs.seedcov.astype(np.int64),
            cs.sub_n.astype(np.int64), cs.frac_rep.astype(np.float64),
            self.cfg.aligner,
            rspan=_cigar_ref_len(cs.cigars, cs.n_cigar).astype(np.int64))
        recs["clip"] = cs.clip
        recs["clip_edit_dist"] = cs.nm + cs.clip
        recs["edit_dist"] = cs.nm
        recs["sw_score"] = cs.sw
        recs["unique"] = cs.unique
        recs["aln_pos0"] = cs.pos_local - 1

        pool = cs.cigars.reshape(-1)
        recs["cig_off"] = np.arange(N, dtype=np.int64) * cs.cigars.shape[1]
        recs["cig_len"] = cs.n_cigar

        idents = np.array([batch.ids[p] for p in pairs], dtype=object)
        return recs, idents, pool

    def align_batch_to_sam(self, batch: ReadBatch,
                           cloud_id_base: Optional[int] = None) -> List[str]:
        """Full pipeline for one ReadBatch; returns all SAM lines."""
        out: List[str] = []
        for chunk_lines in self.iter_batch_sam(batch, cloud_id_base):
            out.extend(chunk_lines)
        return out

    def iter_batch_sam(self, batch: ReadBatch,
                       cloud_id_base=None,
                       group_sink=None) -> Iterator[List[str]]:
        """Full pipeline for one ReadBatch whose barcodes are complete.

        Candidate generation runs in device-sized chunks
        (cfg.batch_size pairs) with several chunks in flight; barcode
        groups are processed *incrementally* as soon as all their chunks
        have landed, so the host-side EM/selection/SAM phase of early
        barcodes overlaps later chunks' device time — the software analog
        of the reference's in_lock/out_lock streaming (align.c:307-341).
        Yields lists of SAM lines as groups complete (bounded memory).

        ``cloud_id_base``: start of a private MI (cloud id) namespace for
        this call — used by -x so each bucket's ids are deterministic
        regardless of bucket concurrency/resume order; a callable
        ``(bc, n_clouds) -> base`` allocates per-group (bucket-coalesced
        -x); None draws from the aligner-wide counter.

        ``group_sink``: optional ``(bc, lines)`` callback; when given,
        each barcode group's lines go to the sink instead of being
        yielded (the coalesced -x path routes them to per-bucket parts).
        """
        P = len(batch.ids)
        B = max(self.cfg.batch_size, 1)

        # pre-sort pairs by barcode so chunk records are bc-monotone and
        # every barcode is contiguous across at most adjacent chunks
        order = np.argsort(batch.bc, kind="stable")
        if not np.array_equal(order, np.arange(P)):
            batch = _reorder_batch(batch, order)
        if not isinstance(batch.seqs, np.ndarray):
            # object ndarrays: _emit_group fancy-indexes the FULL batch's
            # read strings once per barcode group; converting the list per
            # group cost ~1.3s/pass at bench shapes
            batch = dataclasses.replace(
                batch, seqs=np.asarray(batch.seqs, dtype=object),
                quals=np.asarray(batch.quals, dtype=object))

        def work(s: int):
            e = min(s + B, P)
            sub = ReadBatch(
                ids=batch.ids[s:e], bc=batch.bc[s:e],
                seqs=batch.seqs[2 * s:2 * e], quals=batch.quals[2 * s:2 * e],
                codes=batch.codes[2 * s:2 * e], lens=batch.lens[2 * s:2 * e])
            cs = self.generate_candidates(sub)
            if self.replay_sink is not None:
                self.replay_sink(sub, cs)
            recs, idents, part_pool = self.candidates_to_records(sub, cs, s)
            # bc-sort within the chunk (candidate order interleaves the
            # forward and reverse orientations); stable, so within one
            # barcode the chunk-position order is preserved
            o = np.argsort(recs["bc"], kind="stable")
            return recs[o], idents[o], part_pool

        pair_bc: Dict[int, int] = {}
        for b in batch.bc:
            pair_bc[int(b)] = pair_bc.get(int(b), 0) + 1

        lines: List[str] = []
        alloc_base = cloud_id_base if callable(cloud_id_base) else None
        local_cloud_id = (None if cloud_id_base is None or alloc_base
                          else [int(cloud_id_base)])
        rng = np.random.default_rng(self.cfg.seed)
        chunk_starts = list(range(0, P, B))
        pend_recs = empty_records(0)
        pend_ids = np.zeros(0, dtype=object)
        # geometric-growth CIGAR pool (appending a chunk is amortized O(1);
        # a per-chunk concatenate would be O(chunks^2))
        pool = np.zeros(1 << 16, np.uint32)
        pool_len = 0

        def pool_append(part: np.ndarray) -> None:
            nonlocal pool, pool_len
            need = pool_len + part.shape[0]
            if need > pool.shape[0]:
                grown = np.zeros(max(need, 2 * pool.shape[0]), np.uint32)
                grown[:pool_len] = pool[:pool_len]
                pool = grown
            pool[pool_len:need] = part
            pool_len = need

        def sweep_and_dispatch(recs, idents, up_to_bc):
            """Sweep complete barcode groups (bc < up_to_bc) and LAUNCH
            their batched EM; returns (end, emit_state).  The device EM
            call is dispatched asynchronously — ``finish_and_emit`` on
            the *previous* batch runs while it is in flight, hiding the
            device round trip behind host selection/emission."""
            bcs = recs["bc"]
            if up_to_bc is None:
                end = recs.shape[0]
            else:
                end = int(np.searchsorted(bcs, up_to_bc, side="left"))
            starts = np.concatenate(
                [[0], np.nonzero(np.diff(bcs[:end]))[0] + 1, [end]])
            if end > 0:
                n_pairs_list = [pair_bc.get(int(bcs[s]), 0)
                                for s in starts[:-1]]
                states = groups_mod.sweep_groups_batch(
                    recs, idents, starts, self.cfg.platform,
                    apply_opt=self.cfg.apply_density_opt, rng=rng,
                    n_pairs_list=n_pairs_list)
            else:
                states = []
            with self._mst("em[device]" if self.cfg.device_em
                           else "em[host]", len(states)):
                if self.cfg.device_em:
                    # one padded device call for all EM-gated groups
                    em_wait = groups_mod.dispatch_em_device_batch(states)
                else:
                    # one padded numpy pass for all EM-gated groups
                    groups_mod.run_em_host_batch(states)
                    em_wait = None
            return end, (states, em_wait)

        def finish_and_emit(emit_state) -> None:
            states, em_wait = emit_state
            if em_wait is not None:
                with self._mst("em[device]"):
                    em_wait()
            finished = []
            with self._mst("select+emit[host]",
                           sum(st.n for st in states)):
                for st in states:
                    # reserve a cloud-id range atomically: unlike the
                    # reference's racy static cloud_id++ (align.c:19-23),
                    # concurrent buckets never produce duplicate MI ids
                    g_bc = int(st.R["bc"][0]) if st.n else 0
                    if alloc_base is not None:
                        base = alloc_base(g_bc, st.n_clouds)
                    elif local_cloud_id is not None:
                        base = local_cloud_id[0]
                        local_cloud_id[0] += st.n_clouds
                    else:
                        with self._id_lock:
                            base = self._cloud_id
                            self._cloud_id += st.n_clouds
                    finished.append((g_bc, base))
                results = groups_mod.finish_groups_batch(
                    states, [b for _, b in finished])
                finished = [(g_bc, res)
                            for (g_bc, _), res in zip(finished, results)]
                # emission batches across ALL of this emit batch's groups
                # (one native call; per-group numpy dispatch dominated
                # the host phase) — scalar fallback stays per-group
                line_lists = self._emit_groups(
                    batch, [res for _, res in finished], pool)
            for (g_bc, _), glines in zip(finished, line_lists):
                if group_sink is not None:
                    group_sink(g_bc, glines)
                else:
                    lines.extend(glines)

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        workers = max(self.cfg.inflight_chunks, 1)
        with ThreadPoolExecutor(max_workers=workers) as ex:
            # bounded submission window: at most ``workers`` chunk results
            # buffered at once (ex.map would submit everything up front and
            # let finished record arrays pile up if the group phase lags)
            futs = deque()
            next_submit = 0
            while next_submit < len(chunk_starts) and len(futs) < workers:
                futs.append(ex.submit(work, chunk_starts[next_submit]))
                next_submit += 1
            k = 0
            pending = None          # one emit batch with its EM in flight
            while futs:
                recs, idents, part_pool = futs.popleft().result()
                if next_submit < len(chunk_starts):
                    futs.append(ex.submit(work, chunk_starts[next_submit]))
                    next_submit += 1
                recs["cig_off"] += pool_len
                pool_append(part_pool)
                pend_recs = np.concatenate([pend_recs, recs])
                pend_ids = np.concatenate([pend_ids, idents])
                last = k + 1 >= len(chunk_starts)
                limit = None if last else int(batch.bc[chunk_starts[k + 1]])
                done, bstate = sweep_and_dispatch(pend_recs, pend_ids,
                                                  limit)
                pend_recs = pend_recs[done:]
                pend_ids = pend_ids[done:]
                if pending is not None:
                    finish_and_emit(pending)
                pending = bstate
                k += 1
                if lines:
                    yield lines
                    lines = []
            if pending is not None:
                finish_and_emit(pending)
        if lines:
            yield lines

    def align_stream(self, groups, flush_pairs: Optional[int] = None
                     ) -> Iterator[List[str]]:
        """Streaming alignment over an iterator of whole barcode groups.

        ``groups`` yields (ids, bcs, s1, q1, s2, q2) tuples, one complete
        barcode each (io.iter_fastq_pair_groups) — the analog of the
        reference's group-at-a-time readers (align.c:637-744).  Groups
        accumulate into bounded flush batches (default 8 device chunks)
        and SAM lines are yielded as they are produced, so RSS stays flat
        regardless of input size.
        """
        flush = flush_pairs or 8 * max(self.cfg.batch_size, 1)
        ids: List[str] = []
        bcs: List[int] = []
        s1: List[str] = []
        q1: List[str] = []
        s2: List[str] = []
        q2: List[str] = []

        def drain():
            batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
            yield from self.iter_batch_sam(batch)
            for lst in (ids, bcs, s1, q1, s2, q2):
                lst.clear()

        for g in groups:
            ids.extend(g[0])
            bcs.extend(g[1])
            s1.extend(g[2])
            q1.extend(g[3])
            s2.extend(g[4])
            q2.extend(g[5])
            if len(ids) >= flush:
                yield from drain()
        if ids:
            yield from drain()

    def _emit_groups(self, batch: ReadBatch, results, pool
                     ) -> List[List[str]]:
        """SAM lines for many GroupResults: one batched native emission
        (samout.emit_groups_lines) on the fast path; the scalar
        format_record path (bx_index != "1") stays per-group."""
        if self.cfg.bx_index != "1":
            return [self._emit_group(batch, res, pool) for res in results]
        rg_id = None
        if self.cfg.read_group:
            at = self.cfg.read_group.find("ID:")
            if at >= 0:
                rg_id = self.cfg.read_group[at + 3:].split("\t")[0]
        is_hap = self.cfg.platform.name == "haplotag"
        bc_len = self.cfg.platform.bc_len
        lr_tags = not self.cfg.nobc
        if self._contig_blob is None:
            self._contig_blob = samout.make_contig_blob(self.index.names)
        blob, coff = self._contig_blob
        rg_tag = rg_id.split()[0] if rg_id else None

        from ema_tpu.utils.barcodes import decode_bc
        groups = []
        for res in results:
            R = res.records
            if lr_tags and len(R):
                bc_str = decode_bc(int(R["bc"][0]), bc_len, is_hap)
            else:
                bc_str = ""
            bx_full = bc_str if is_hap else (
                f"{bc_str}-1" if lr_tags and len(R) else "")
            mapqs = score_mod.final_mapq(res.gamma, R["score_mapq"],
                                         R["mapq"])
            groups.append((res, bx_full, mapqs))
        return samout.emit_groups_lines(
            groups, pool, MAX_CIGAR_OPS, batch.seqs, batch.quals,
            blob, coff, rg_tag, self.cfg.nobc)

    def _emit_group(self, batch: ReadBatch, res, pool) -> List[str]:
        """SAM lines for one processed barcode group (GroupResult)."""
        R = res.records
        RI = res.idents

        names = self.index.names
        rg_id = None
        if self.cfg.read_group:
            at = self.cfg.read_group.find("ID:")
            if at >= 0:
                rg_id = self.cfg.read_group[at + 3:].split("\t")[0]
        is_hap = self.cfg.platform.name == "haplotag"
        # bc_len 0 (tru/cpt) decodes to an empty string, so BX becomes a
        # literal "-1" — the reference's own output for these platforms
        # (decode_bc_default with BC_LEN=0, samrecord.c:252-256)
        bc_len = self.cfg.platform.bc_len
        lr_tags = not self.cfg.nobc
        if lr_tags and len(R):
            from ema_tpu.utils.barcodes import decode_bc
            bc_str = decode_bc(int(R["bc"][0]), bc_len, is_hap)
        else:
            bc_str = ""
        # 3-way-min mapq for the whole group in one vector op
        mapqs = score_mod.final_mapq(res.gamma, R["score_mapq"], R["mapq"])

        # fast path: vectorized prep + C++ string assembly.  The scalar
        # path below remains for bx_index != "1" (the unmapped-mate BX
        # suffix is hardwired to -1, samout.format_record else-branch).
        if self.cfg.bx_index == "1":
            if self._contig_blob is None:
                self._contig_blob = samout.make_contig_blob(names)
            blob, coff = self._contig_blob
            bx_full = bc_str if is_hap else (
                f"{bc_str}-1" if lr_tags and len(R) else "")
            rg_tag = rg_id.split()[0] if rg_id else None
            return samout.emit_group_lines(
                res, pool, MAX_CIGAR_OPS, batch.seqs, batch.quals,
                blob, coff, rg_tag, bx_full, self.cfg.nobc, mapqs)

        def cigar_of(i):
            off = int(R["cig_off"][i])
            return pool[off:off + int(R["cig_len"][i])]

        def read_of(i):
            r = int(R["pair"][i]) * 2 + int(R["mate"][i])
            return batch.seqs[r], batch.quals[r]

        def alt_of(i):
            a = int(res.alt_idx[i])
            if a < 0:
                return None
            return {
                "chrom": names[int(R["chrom"][a])],
                "pos": int(R["pos"][a]),
                "cigar": cigar_of(a),
                "edit_dist": int(R["edit_dist"][a]),
                "rev": int(R["rev"][a]),
            }

        lines = []
        for a, b in res.emit_pairs:
            ra = R[a]
            rb = R[b] if b >= 0 else None
            seq_a, qual_a = read_of(a)
            ident = str(RI[a])
            lines.append(samout.format_record(
                ra, rb, ident, names[int(ra["chrom"])],
                names[int(rb["chrom"])] if rb is not None else None,
                seq_a, qual_a, cigar_of(a),
                cigar_of(b) if b >= 0 else None,
                float(res.gamma[a]), int(res.cloud_id[a]),
                int(res.cloud_bad[a]), alt_of(a),
                rg_id, self.cfg.bx_index, is_hap, bc_len,
                mapq=int(mapqs[a]), bc_str=bc_str, lr_tags=lr_tags))
            if rb is not None:
                seq_b, qual_b = read_of(b)
                lines.append(samout.format_record(
                    rb, ra, ident, names[int(rb["chrom"])],
                    names[int(ra["chrom"])],
                    seq_b, qual_b, cigar_of(b), cigar_of(a),
                    float(res.gamma[b]), int(res.cloud_id[b]),
                    int(res.cloud_bad[b]), alt_of(b),
                    rg_id, self.cfg.bx_index, is_hap, bc_len,
                    mapq=int(mapqs[b]), bc_str=bc_str, lr_tags=lr_tags))
            else:
                # unmapped mate record (samrecord.c:157-174)
                r = int(ra["pair"]) * 2 + (1 - int(ra["mate"]))
                lines.append(samout.format_record(
                    None, ra, ident, "*", names[int(ra["chrom"])],
                    batch.seqs[r], batch.quals[r], None, cigar_of(a),
                    0.0, 0, 0, None, rg_id, self.cfg.bx_index,
                    is_hap, bc_len, bc_str=bc_str, lr_tags=lr_tags))
        return lines


class ShardedAligner(Aligner):
    """Aligner over a contig-sharded index (ShardedIndex).

    Runs candidate generation against every FM-index shard and merges the
    per-shard CandidateSets with global contig numbering, re-applying the
    cross-shard edit-distance window and uniqueness/second-best statistics
    that the reference gets for free from its single 64-bit BWA index.
    """

    def __init__(self, index, cfg: Optional[config.RunConfig] = None):
        self.index = index                    # ShardedIndex facade
        self.cfg = cfg or config.RunConfig()
        self.subs = [Aligner(sh, self.cfg) for sh in index.shards]
        for sub in self.subs:
            sub._defer_dist_window = True     # window applied at merge
        if self.subs:
            self.cfg = self.subs[0].cfg       # auto defaults resolved
        self._cloud_id = 0
        self._id_lock = threading.Lock()
        self._contig_blob = None
        self._defer_dist_window = False
        self.replay_sink = None
        self.metrics = None
        if self.subs:
            self.placement = self.subs[0].placement

    def generate_candidates(self, batch: ReadBatch) -> CandidateSet:
        css = [sub.generate_candidates(batch) for sub in self.subs]
        return _merge_candidate_sets(css, self.index.contig_base,
                                     2 * len(batch.ids))


def _merge_candidate_sets(css: List[CandidateSet], contig_base: List[int],
                          n_reads: int) -> CandidateSet:
    """Concatenate per-shard candidates; redo global filters and stats."""
    if not css:
        return _empty_candidate_set()
    parts = {}
    for f in CandidateSet.__dataclass_fields__:
        vals = [getattr(cs, f) for cs in css]
        if f == "chrom":
            vals = [v + np.int32(contig_base[i]) for i, v in enumerate(vals)]
        parts[f] = np.concatenate(vals) if vals else vals
    cs = CandidateSet(**parts)
    N = cs.owner.shape[0]
    if N == 0:
        return cs

    # global edit-distance window vs the best-scoring candidate per read
    # (align.c:1020-1024; per-shard filtering used per-shard bests)
    keep = _dist_window_keep(cs.owner, cs.sw, cs.nm + cs.clip, n_reads)
    cs = CandidateSet(**{
        f: getattr(cs, f)[keep] for f in CandidateSet.__dataclass_fields__})
    N = cs.owner.shape[0]

    # global uniqueness + sub stats (mirrors _finalize_candidates)
    n_per = np.bincount(cs.owner, minlength=n_reads)
    cs.unique[:] = n_per[cs.owner] == 1
    _, sub = _best_and_sub(cs.owner, cs.sw, n_reads)
    cs.sub[:] = sub
    cs.sub_n[:] = np.maximum(n_per[cs.owner] - 2, 0)
    return cs


def _dist_window_keep(owner: np.ndarray, scores: np.ndarray,
                      dist: np.ndarray, n_owners: int) -> np.ndarray:
    """Keep candidates within EXTRA_SEARCH_DEPTH of the owner's leader.

    Leader = the owner's highest-scoring candidate (first in array order
    on ties), whose clip+edit distance anchors the window — the
    reference's regs.a[0] (align.c:1020-1024).
    """
    N = owner.shape[0]
    if N == 0:
        return np.zeros(0, bool)
    order = np.lexsort((np.arange(N), -scores.astype(np.int64), owner))
    o_sorted = owner[order]
    lead = np.ones(N, bool)
    lead[1:] = o_sorted[1:] != o_sorted[:-1]
    li = order[lead]
    leader_of = np.zeros(n_owners, np.int64)
    leader_of[owner[li]] = li
    best_dist = dist[leader_of[owner]]
    is_leader = np.zeros(N, bool)
    is_leader[li] = True
    return is_leader | (dist - best_dist <= config.EXTRA_SEARCH_DEPTH)


def _best_and_sub(owner: np.ndarray, scores: np.ndarray, n_owners: int):
    """Per-candidate (best, second-best-as-sub) over owner groups.

    ``sub`` for a best-scoring candidate is the max among the owner's
    *other* candidates (one occurrence of the max masked out, first in
    array order); for a non-best candidate it is the owner's best.
    """
    N = owner.shape[0]
    best = np.zeros(n_owners, np.int64)
    np.maximum.at(best, owner, scores)
    is_best = scores == best[owner]
    first_best = np.zeros(N, bool)
    if N:
        # sort each owner's best entries first (stably by index): the
        # group leader is that owner's first best candidate in array order
        order = np.lexsort((np.arange(N), ~is_best, owner))
        o_sorted = owner[order]
        lead = np.ones(N, bool)
        lead[1:] = o_sorted[1:] != o_sorted[:-1]
        first_best[order[lead]] = True
    second = np.zeros(n_owners, np.int64)
    np.maximum.at(second, owner[~first_best], scores[~first_best])
    sub = np.where(is_best, second[owner], best[owner])
    return best, sub


HIT_BUCKET = 8192


def _compact_seed_hits(seed_stack: np.ndarray, n_seeds: np.ndarray,
                       max_hits: int):
    """Dense per-seed SA intervals -> flat hit rows (host, vectorized).

    seed_stack: 4 planes (lo, hi, qb, len), each [B, S] — a tuple of the
    native seeder's int32 outputs or a stacked [4, B, S] array; kept
    narrow until after the compacting gathers (full-plane int64 widening
    re-mmapped tens of MB per chunk).  Intervals wider than ``max_hits``
    are evenly sampled (BWA max_occ capping, src/align.c:185).
    Returns (owner [H], qb [H], seed_len [H], sa_rows [H]) int64 arrays.
    """
    s_lo, s_hi, s_qb, s_len = seed_stack
    B, S = s_lo.shape
    live = np.arange(S)[None, :] < n_seeds[:, None]
    width = np.where(live, np.maximum(s_hi - s_lo, 0), 0)
    take = np.minimum(width, max_hits)
    b_idx, s_idx = np.nonzero(take)
    take_f = take[b_idx, s_idx].astype(np.int64)
    total = int(take_f.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    off = np.zeros(take_f.shape[0], np.int64)
    np.cumsum(take_f[:-1], out=off[1:])
    rep = np.repeat(np.arange(take_f.shape[0]), take_f)
    i_loc = np.arange(total, dtype=np.int64) - off[rep]
    w = width[b_idx, s_idx].astype(np.int64)[rep]
    t = take_f[rep]
    rows = (s_lo[b_idx, s_idx].astype(np.int64)[rep]
            + np.where(w > t, (i_loc * w) // t, i_loc))
    return (b_idx[rep].astype(np.int64),
            s_qb[b_idx, s_idx].astype(np.int64)[rep],
            s_len[b_idx, s_idx].astype(np.int64)[rep], rows)


LOCATE_CHUNK = 8 * HIT_BUCKET


def locate_rows_bucketed(fma, rows: np.ndarray, put=jnp.asarray) -> np.ndarray:
    """Device locate over a flat row list with bounded compile shapes.

    Small batches pad to power-of-two multiples of HIT_BUCKET; anything
    larger runs in fixed LOCATE_CHUNK windows, so deep-repeat batches
    (millions of sampled hits under the max_occ cap) reuse one compiled
    program instead of one per distinct size.
    """
    H = rows.shape[0]
    if H == 0:
        return np.zeros(0, np.int64)
    if H <= LOCATE_CHUNK:
        Hp = _pow2_rows(H, LOCATE_CHUNK, lo=HIT_BUCKET)
        rp = np.zeros(Hp, np.int32)
        rp[:H] = rows
        return np.asarray(fmindex.locate(fma, put(rp)))[:H].astype(np.int64)
    out = np.empty(H, np.int64)
    rp = np.zeros(LOCATE_CHUNK, np.int32)
    for s in range(0, H, LOCATE_CHUNK):
        e = min(s + LOCATE_CHUNK, H)
        rp[:e - s] = rows[s:e]
        rp[e - s:] = 0
        out[s:e] = np.asarray(
            fmindex.locate(fma, put(rp)))[:e - s].astype(np.int64)
    return out


def _reorder_batch(batch: ReadBatch, order: np.ndarray) -> ReadBatch:
    """Reorder a ReadBatch's pairs by ``order``."""
    rows = np.stack([2 * order, 2 * order + 1], axis=1).reshape(-1)
    return ReadBatch(
        ids=[batch.ids[i] for i in order],
        bc=batch.bc[order],
        seqs=[batch.seqs[r] for r in rows],
        quals=[batch.quals[r] for r in rows],
        codes=batch.codes[rows],
        lens=batch.lens[rows])


def _cigar_ref_len(cigars: np.ndarray, n_cigar: np.ndarray) -> np.ndarray:
    B, max_ops = cigars.shape
    off = np.arange(B, dtype=np.int64) * max_ops
    return native.cigar_stats_pool(cigars, off, n_cigar)[4]


def _empty_candidate_set() -> CandidateSet:
    z = np.zeros(0, np.int64)
    z32 = np.zeros(0, np.int32)
    return CandidateSet(
        owner=z, rev=np.zeros(0, np.int8), gpos=z, chrom=z32, pos_local=z,
        sw=z32, qb=z32, qe=z32, clip=z32, nm=z32,
        cigars=np.zeros((0, MAX_CIGAR_OPS), np.uint32), n_cigar=z32,
        seedcov=z32, sub=z32, sub_n=z32,
        frac_rep=np.zeros(0, np.float32), unique=np.zeros(0, bool))
