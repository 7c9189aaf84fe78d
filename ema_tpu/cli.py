"""Command-line interface: count / preproc / align / index / help.

Mirrors the reference CLI (src/main.c:78-118) with one addition: an
``index`` mode that builds our FM-index from a FASTA (the reference
delegates this to `bwa index`).

    ema_tpu count   -w wl.txt -o prefix < interleaved.fq
    ema_tpu preproc -w wl.txt -o outdir [-n N] [-h] [-b] [-t T] prefix.ema-ncnt...
    ema_tpu index   -r ref.fa [-o ref.fa.emaidx.npz]
    ema_tpu align   -r ref.fa [-s bucket | -1 r1.fq [-2 r2.fq] | -x f1 f2...]
                    [-o out.sam] [-R RG] [-d] [-p platform] [-i idx] [-t T]
    ema_tpu samdiff a.sam b.sam [--pos-tol N] [--fail-under PCT]
"""

from __future__ import annotations

import argparse
import os
import sys

from ema_tpu import __version__, config


def _index_path(ref: str) -> str:
    return ref + ".emaidx.npz"


def _sharded_index_path(ref: str) -> str:
    return ref + ".emaidx.d"


def _load_or_build_index(ref: str):
    from ema_tpu.index import (MAX_SHARD_BASES, ReferenceIndex, ShardedIndex,
                               build_index, build_index_sharded)
    p = _index_path(ref)
    if os.path.exists(p):
        try:
            return ReferenceIndex.load(p)
        except Exception as e:      # stale format / truncated artifact
            sys.stderr.write(f"ema_tpu: unusable index at {p} ({e!r}); "
                             "rebuilding\n")
            os.unlink(p)
    pd = _sharded_index_path(ref)
    if os.path.isdir(pd):
        try:
            idx = ShardedIndex.load(pd)
            if idx.n_shards == 0:
                raise ValueError("no shard files")
            return idx
        except Exception as e:
            sys.stderr.write(f"ema_tpu: unusable index at {pd} ({e!r}); "
                             "rebuilding\n")
            import shutil
            shutil.rmtree(pd)
    sys.stderr.write(f"ema_tpu: building index for {ref}...\n")
    from ema_tpu.index import build_and_save_sharded
    from ema_tpu.index.build import parse_fasta
    contigs = parse_fasta(ref)
    total = sum(a.shape[0] for a in contigs.values())
    if total > MAX_SHARD_BASES:      # ~1 Gbp/shard cap, e.g. full GRCh38
        # n_workers=1: inside align mode JAX may already be initialized
        # and fork() would risk a deadlock — run `ema_tpu index -r ref -j N`
        # beforehand for the parallel build
        idx = build_and_save_sharded(contigs, pd, n_workers=1)
    else:
        idx = build_index(contigs)
        idx.save(p)
    return idx


def _run_coalesced_buckets(aligner, inputs, ns_of, mi_shift, part_path,
                           man, sort, chrom_names, is_hap, bc_len, met,
                           batch_size, do_bucket) -> None:
    """-x: batch many small bucket files per device call.

    Barcode buckets are often tiny (hundreds of pairs each with -n 500,
    reference main.c:141); aligning them one device batch per bucket
    pays fixed dispatch latency ~500 times.  Coalescing reads whole
    buckets until ~4 device chunks of pairs accumulate, aligns them as
    ONE bc-sorted batch, and routes each barcode group's SAM lines back
    to its bucket's part file.  Per-bucket MI namespaces and manifest
    resume are preserved: a bucket's groups are always whole and visited
    in bc order, so its cloud-id sequence is independent of which other
    buckets share the batch.  Buckets sharing a barcode (never true for
    preproc output, which partitions barcodes) fall back to the
    per-bucket path to keep the reference's separate-group semantics.
    """
    import time

    from ema_tpu import io as io_mod
    from ema_tpu.core.pipeline import ReadBatch
    from ema_tpu.parallel.distrib import sort_sam_lines

    todo = [p for p in inputs
            if not (man is not None and man.is_done(p)
                    and os.path.exists(part_path(p)))]
    target = 4 * max(batch_size, 1)
    i = 0
    while i < len(todo):
        t0 = time.time()
        group = []
        pairs_n = 0
        while i < len(todo) and (not group or pairs_n < target):
            rows = io_mod.read_special_rows(todo[i], is_hap, bc_len)
            group.append((todo[i], rows))
            pairs_n += len(rows[0])
            i += 1

        bc2bucket = {}
        conflict = False
        for p, rows in group:
            for b in set(rows[1]):
                if bc2bucket.setdefault(b, p) != p:
                    conflict = True
        if conflict:
            for p, _ in group:
                do_bucket(p)
            continue

        ids, bcs, s1, q1, s2, q2 = [], [], [], [], [], []
        for p, rows in group:
            ids += rows[0]
            bcs += rows[1]
            s1 += rows[2]
            q1 += rows[3]
            s2 += rows[4]
            q2 += rows[5]
        batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)

        counters: dict = {}

        def alloc(bc, n_clouds):
            p = bc2bucket[bc]
            base = (ns_of[p] << mi_shift) + counters.get(p, 0)
            counters[p] = counters.get(p, 0) + n_clouds
            return base

        buf = {p: [] for p, _ in group}

        def sink(bc, glines):
            buf[bc2bucket[bc]].extend(glines)

        with met.stage("align", len(ids)):
            for _ in aligner.iter_batch_sam(batch, alloc, sink):
                pass
        dt = time.time() - t0
        for p, _ in group:
            body = buf[p]
            if sort:
                body = sort_sam_lines(body, chrom_names)
            pp = part_path(p)
            with open(pp + ".tmp", "w") as fh:
                fh.writelines(body)
            os.replace(pp + ".tmp", pp)
            if man is not None:
                man.mark_done(p, pp, len(body), dt / len(group))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        sys.stderr.write(f"EMA-TPU version {__version__}\n"
                         "note: use 'ema_tpu help' for usage information.\n")
        return 0
    mode, rest = argv[0], argv[1:]

    if mode == "help":
        print(__doc__)
        return 0

    if mode == "samdiff":
        from ema_tpu.utils.samdiff import main as samdiff_main
        return samdiff_main(rest)

    if mode == "count":
        ap = argparse.ArgumentParser(prog="ema_tpu count", add_help=False)
        ap.add_argument("-w", dest="wl")
        ap.add_argument("-o", dest="out", required=True)
        ap.add_argument("-p", dest="haplotag", action="store_true")
        a = ap.parse_args(rest)
        if not a.wl and not a.haplotag:
            sys.stderr.write("error: specify barcode whitelist with -w\n")
            return 1
        from ema_tpu.preproc.count import count
        stats = count(a.wl, a.out, sys.stdin.buffer, is_haplotag=a.haplotag)
        sys.stderr.write(f":: Reads with OK barcode: {stats['nice']} out of "
                         f"{stats['total']}\n:: Ignored {stats['ignored']} "
                         "reads\n")
        return 0

    if mode == "preproc":
        ap = argparse.ArgumentParser(prog="ema_tpu preproc", add_help=False)
        ap.add_argument("-w", dest="wl")
        ap.add_argument("-n", dest="nbuckets", type=int, default=500)
        ap.add_argument("-h", dest="h2", action="store_true")
        ap.add_argument("-o", dest="out", required=True)
        ap.add_argument("-b", dest="bx", action="store_true")
        ap.add_argument("-t", dest="threads", type=int, default=1)
        ap.add_argument("-p", dest="haplotag", action="store_true")
        ap.add_argument("--coordinator", default=None,
                        help="multi-host: jax.distributed coordinator "
                             "address host:port")
        ap.add_argument("--nprocs", type=int, default=None,
                        help="multi-host: total number of processes")
        ap.add_argument("--procid", type=int, default=None,
                        help="multi-host: this process's id (0-based)")
        ap.add_argument("inputs", nargs="*")
        a = ap.parse_args(rest)
        if not a.wl and not a.haplotag:
            sys.stderr.write("error: specify barcode whitelist with -w\n")
            return 1
        if not a.inputs:
            sys.stderr.write("warning: no input files specified; "
                             "nothing to do\n")
            return 0
        distributed = a.coordinator is not None
        out_dir = a.out
        if distributed:
            # one jax process per host; each host streams its own FASTQ
            # chunk + local count outputs, allreduces priors/totals so
            # bucket routing is globally consistent, and writes its
            # bucket files under a per-host subdirectory (concatenating
            # host files of one bucket index yields the exact logical
            # bucket a single-process run produces)
            from ema_tpu.parallel.distrib import init_distributed
            pid, _ = init_distributed(a.coordinator, a.nprocs, a.procid)
            out_dir = os.path.join(a.out, f"host{pid:02d}")
        from ema_tpu.preproc.correct import correct
        stats = correct(a.wl, a.inputs, out_dir, sys.stdin.buffer,
                        do_h2=a.h2, do_bx_format=a.bx,
                        n_buckets=a.nbuckets, is_haplotag=a.haplotag,
                        n_threads=max(a.threads, 1),
                        distributed=distributed)
        sys.stderr.write(
            f":: Stats: no change: {stats['nochange']}\n"
            f"         no barcode: {stats['nobucket']}\n"
            f"       H1-corrected: {stats['h1']}\n"
            f"       H2-corrected: {stats['h2']}\n")
        return 0

    if mode == "index":
        ap = argparse.ArgumentParser(prog="ema_tpu index", add_help=False)
        ap.add_argument("-r", dest="ref", required=True)
        ap.add_argument("-o", dest="out")
        ap.add_argument("--shard-bases", type=int, default=None,
                        help="force contig-sharded indexing with this "
                             "shard size (auto beyond ~2^30 bases: both "
                             "strands of a shard must fit int32 rows)")
        ap.add_argument("-j", dest="workers", type=int, default=None,
                        help="parallel shard-build processes "
                             "(default: one per shard up to cpu count)")
        ap.add_argument("--from-bwa", action="store_true",
                        help="build from an existing `bwa index` "
                             "(<ref>.pac/.ann/.amb) instead of parsing "
                             "the FASTA (reference: bwa_idx_load, "
                             "bwabridge.c:79)")
        a = ap.parse_args(rest)
        from ema_tpu.index import (MAX_SHARD_BASES, build_and_save_sharded,
                                   build_index)
        from ema_tpu.index.build import parse_fasta
        if a.from_bwa:
            import os as _os
            if (_os.path.exists(a.ref + ".bwt")
                    and _os.path.exists(a.ref + ".sa")
                    and not a.shard_bases):
                # complete BWA index present: consume the prebuilt
                # FM-index directly — no suffix-array construction
                # (bwa_idx_load semantics, bwabridge.c:77-96)
                from ema_tpu.index.bwa_import import import_bwa_index
                idx = import_bwa_index(a.ref)
                idx.save(a.out or _index_path(a.ref))
                return 0
            from ema_tpu.index.bwa_import import load_bwa_contigs
            contigs = load_bwa_contigs(a.ref)
        else:
            contigs = parse_fasta(a.ref)
        total = sum(arr.shape[0] for arr in contigs.values())
        if a.shard_bases or total > MAX_SHARD_BASES:
            build_and_save_sharded(
                contigs, a.out or _sharded_index_path(a.ref),
                max_shard_bases=a.shard_bases or MAX_SHARD_BASES,
                n_workers=a.workers)
        else:
            idx = build_index(contigs)
            idx.save(a.out or _index_path(a.ref))
        return 0

    if mode == "align":
        ap = argparse.ArgumentParser(prog="ema_tpu align", add_help=False)
        ap.add_argument("-r", dest="ref", required=True)
        ap.add_argument("-1", dest="fq1")
        ap.add_argument("-2", dest="fq2")
        ap.add_argument("-s", dest="fqx")
        ap.add_argument("-x", dest="multi", action="store_true")
        ap.add_argument("-o", dest="out")
        ap.add_argument("-R", dest="rg")
        ap.add_argument("-d", dest="dens", action="store_true")
        ap.add_argument("-p", dest="platform", default="10x")
        ap.add_argument("-i", dest="bx_index", default="1")
        ap.add_argument("-t", dest="threads", type=int, default=None,
                        help="in-flight device chunks (1 disables overlap)")
        ap.add_argument("-j", dest="jobs", type=int, default=2,
                        help="concurrent bucket files in -x mode (the "
                             "reference runs one OpenMP thread per input "
                             "file, main.c:396-406); one bucket's host "
                             "group phase overlaps another's device time. "
                             "Applies with --no-coalesce (default -x mode "
                             "batches many small buckets per device call)")
        ap.add_argument("--no-coalesce", action="store_true",
                        help="-x: process each bucket file in its own "
                             "device batches instead of coalescing small "
                             "buckets (coalescing keeps per-bucket "
                             "outputs, MI namespaces and resume)")
        ap.add_argument("--coordinator", default=None,
                        help="multi-host: jax.distributed coordinator "
                             "address host:port (implies --shard/"
                             "--nshards from the process topology)")
        ap.add_argument("--nprocs", type=int, default=None,
                        help="multi-host: total number of processes")
        ap.add_argument("--procid", type=int, default=None,
                        help="multi-host: this process's id (0-based)")
        ap.add_argument("--shard", type=int, default=None,
                        help="this host's shard id (0-based)")
        ap.add_argument("--nshards", type=int, default=None,
                        help="total hosts; buckets are hashed across them")
        ap.add_argument("--manifest", default=None,
                        help="JSONL progress manifest; completed buckets "
                             "are skipped on resume (-x mode)")
        ap.add_argument("--profile", default=None,
                        help="write a jax.profiler trace to this dir")
        ap.add_argument("--sort", action="store_true",
                        help="coordinate-sort the output SAM body")
        ap.add_argument("--device-em", action="store_true",
                        help="run the cloud-EM iterations on device")
        ap.add_argument("--seeding", choices=("greedy", "smem"),
                        default=None,
                        help="seed finder: batched device scan (greedy) "
                             "or exact SMEM enumeration with BWA "
                             "re-seeding in host C++ (smem)")
        ap.add_argument("--nobc", action="store_true",
                        help="no-barcode mode: plain paired alignment, no "
                             "linked-read tags (replaces `bwa mem` on the "
                             "preproc ema-nobc output)")
        ap.add_argument("inputs", nargs="*")
        a = ap.parse_args(rest)

        n_modes = int(a.multi) + int(a.fqx is not None) + \
            int(a.fq1 is not None or a.fq2 is not None)
        if n_modes != 1:
            sys.stderr.write(
                "error: must specify *exactly one* of -1/-2, -s or -x\n")
            return 1
        if a.fq1 is None and a.fq2 is not None:
            sys.stderr.write("error: cannot specify -2 without -1\n")
            return 1

        # unescape \t \n \r \\ in -R, single pass left-to-right (reference
        # util.c escape(), util.c:97-118)
        if a.rg:
            out_rg, i = [], 0
            while i < len(a.rg):
                c = a.rg[i]
                if c == "\\" and i + 1 < len(a.rg):
                    nxt = a.rg[i + 1]
                    rep = {"t": "\t", "n": "\n", "r": "\r",
                           "\\": "\\"}.get(nxt)
                    if rep is not None:
                        out_rg.append(rep)
                        i += 2
                        continue
                out_rg.append(c)
                i += 1
            rg = "".join(out_rg)
        else:
            rg = "@RG\tID:rg1\tSM:sample1"
        if rg and (not rg.startswith("@RG\t") or "\tID:" not in rg):
            sys.stderr.write(f"error: malformed read group: '{rg}'\n")
            return 1
        try:
            profile = config.get_platform_profile(a.platform)
        except ValueError:
            sys.stderr.write(f"error: invalid platform name: '{a.platform}'\n")
            return 1

        if a.coordinator is not None:
            # multi-host -x: one jax process per host; bucket shards
            # default to the process topology (SURVEY §5.8: buckets over
            # the network, batches over the host's local devices)
            from ema_tpu.parallel.distrib import init_distributed
            pid, pcount = init_distributed(a.coordinator, a.nprocs,
                                           a.procid)
            if a.nshards is None:
                a.shard, a.nshards = pid, pcount
            if a.out and a.nshards > 1:
                from ema_tpu.parallel.distrib import shard_path
                a.out = shard_path(a.out, a.shard or 0, a.nshards)

        import time

        from ema_tpu import io as io_mod
        from ema_tpu.core.pipeline import Aligner
        from ema_tpu.core.samout import write_sam_header
        from ema_tpu.utils.backend import describe_devices, ensure_backend
        from ema_tpu.utils.metrics import Metrics, device_trace

        ensure_backend()
        sys.stderr.write(f"ema_tpu: {describe_devices()}\n")
        met = Metrics()
        with met.stage("index_load"):
            idx = _load_or_build_index(a.ref)
        aligner_params = config.DEFAULT_ALIGNER_PARAMS
        if a.seeding:
            import dataclasses as _dc
            aligner_params = _dc.replace(aligner_params, seeding=a.seeding)
        cfg = config.RunConfig(platform=profile, read_group=rg,
                               bx_index=a.bx_index,
                               aligner=aligner_params,
                               apply_density_opt=a.dens,
                               inflight_chunks=(max(a.threads, 1)
                                                if a.threads else None),
                               device_em=True if a.device_em else None,
                               nobc=a.nobc)
        from ema_tpu.index import ShardedIndex
        if isinstance(idx, ShardedIndex):
            from ema_tpu.core.pipeline import ShardedAligner
            aligner = ShardedAligner(idx, cfg)
        else:
            aligner = Aligner(idx, cfg)
        if os.environ.get("EMA_TPU_STAGE_TIMERS") == "1":
            aligner.metrics = met      # publish the host/device split
        cmd = "ema_tpu align " + " ".join(rest)
        header = write_sam_header(idx.names, idx.lengths, rg,
                                  __version__, cmd)
        is_hap = profile.name == "haplotag"
        # bc_len 0 (tru/cpt) must stay 0: BX decodes to '' -> 'BX:Z:-1',
        # the reference's own output for these platforms
        bc_len = profile.bc_len

        def align_one_input(path_or_pair, out_fh, cloud_base=None):
            n = 0
            if path_or_pair[0] == "pair" and not a.sort:
                # streaming -1/-2: whole barcode groups flow from disk
                # through bounded flush batches straight to the writer —
                # flat RSS on WGS-scale inputs (align.c:637-744 analog)
                groups = io_mod.iter_fastq_pair_groups(
                    path_or_pair[1], path_or_pair[2],
                    "none" if a.nobc else profile.name)
                with met.stage("align"):
                    for lines in aligner.align_stream(groups):
                        for line in lines:
                            out_fh.write(line)
                            n += 1
                return n
            with met.stage("read_input"):
                if path_or_pair[0] == "special":
                    batch = io_mod.read_special_fastq(
                        path_or_pair[1], is_hap, bc_len)
                else:
                    batch = io_mod.read_fastq_pair(
                        path_or_pair[1], path_or_pair[2],
                        "none" if a.nobc else profile.name)
            with met.stage("align", len(batch.ids)):
                lines = aligner.align_batch_to_sam(batch, cloud_base)
            if a.sort:
                # -x: per-part sort, so the final pass is a streaming
                # k-way merge instead of an in-memory global sort
                from ema_tpu.parallel.distrib import sort_sam_lines
                lines = sort_sam_lines(lines, idx.names)
            with met.stage("write_output"):
                for line in lines:
                    out_fh.write(line)
                    n += 1
            return n

        with device_trace(a.profile):
            if a.multi:
                # -x: many buckets; shard across hosts, track progress,
                # write per-bucket parts, concatenate at the end
                from ema_tpu.parallel.distrib import buckets_for_host
                from ema_tpu.utils.manifest import RunManifest

                inputs = list(a.inputs)
                # deterministic per-bucket MI namespaces, keyed by the
                # bucket's position in the *full* input list so ids stay
                # unique across host shards and byte-identical on resume.
                # The namespace width adapts to the bucket count so the
                # largest base still fits SAM's int32 'i' tag range
                # (500 buckets -> 2^22 clouds each; 1000 -> 2^21).
                ns_of = {p: i for i, p in enumerate(inputs)}
                mi_shift = max(31 - max(len(inputs) - 1, 1).bit_length(),
                               10)
                if a.nshards:
                    inputs = buckets_for_host(
                        inputs, a.shard or 0, a.nshards)
                man = RunManifest(a.manifest) if a.manifest else None
                parts_dir = (a.out or "ema_out.sam") + ".parts"
                os.makedirs(parts_dir, exist_ok=True)

                import threading
                from concurrent.futures import ThreadPoolExecutor
                man_lock = threading.Lock()

                def part_path(p: str) -> str:
                    return os.path.join(
                        parts_dir, os.path.basename(p) + ".sam")

                def do_bucket(p: str) -> str:
                    part = part_path(p)
                    with man_lock:
                        done = (man is not None and man.is_done(p)
                                and os.path.exists(part))
                    if done:
                        return part
                    t0 = time.time()
                    with open(part + ".tmp", "w") as fh:
                        n = align_one_input(("special", p), fh,
                                            cloud_base=ns_of[p] << mi_shift)
                    os.replace(part + ".tmp", part)
                    if man is not None:
                        with man_lock:
                            man.mark_done(p, part, n, time.time() - t0)
                    return part

                parts = [part_path(p) for p in inputs]
                if a.no_coalesce or len(inputs) <= 1:
                    jobs = max(1, min(a.jobs, len(inputs) or 1))
                    if jobs == 1:
                        for p in inputs:
                            do_bucket(p)
                    else:
                        with ThreadPoolExecutor(max_workers=jobs) as bx:
                            list(bx.map(do_bucket, inputs))
                else:
                    _run_coalesced_buckets(
                        aligner, inputs, ns_of, mi_shift, part_path, man,
                        a.sort, idx.names, is_hap, bc_len, met,
                        aligner.cfg.batch_size, do_bucket)
                out = open(a.out, "w") if a.out else sys.stdout
                if a.sort:
                    # streaming k-way merge of the sorted parts (bounded
                    # memory; parts were sorted at write time above)
                    from ema_tpu.parallel.distrib import merge_sorted_streams
                    merge_sorted_streams(out, parts, idx.names, header)
                else:
                    out.write(header)
                    for part in parts:
                        with open(part) as fh:
                            for line in fh:
                                out.write(line)
                if a.out:
                    out.close()
            else:
                out = open(a.out, "w") if a.out else sys.stdout
                out.write(header)
                if a.fqx:
                    align_one_input(("special", a.fqx), out)
                else:
                    align_one_input(("pair", a.fq1, a.fq2), out)
                if a.out:
                    out.close()
        met.report()
        return 0

    sys.stderr.write("error: unrecognized mode\n")
    return 1


if __name__ == "__main__":
    sys.exit(main())
