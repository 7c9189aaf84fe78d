"""Real 2-process jax.distributed test (SURVEY §4's multi-host ask).

Spawns two OS processes that initialize jax.distributed against a local
coordinator on the CPU backend, run the distributed preproc path (priors
and per-barcode totals allreduced in-network), and write per-host bucket
files.  The parent asserts:

  * allreduce_counts really sums across processes,
  * concatenated per-host bucket files are byte-identical to the
    single-process run on the full input (global routing consistency).
"""

from __future__ import annotations

import io
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests.test_oracle_preproc import make_dataset, write_wl

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)
    import jax
    jax.config.update("jax_platforms", "cpu")

    coord, procid, wl, cnt_prefix, outdir, fq_path = sys.argv[1:7]
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=2, process_id=int(procid))

    from ema_tpu.parallel.distrib import allreduce_counts
    local = np.arange(5, dtype=np.int64) + 10 * int(procid)
    summed = allreduce_counts(local)
    np.save(os.path.join(outdir, f"allreduce{procid}.npy"), summed)

    from ema_tpu.preproc.correct import correct
    with open(fq_path, "rb") as f:
        correct(wl, [cnt_prefix], os.path.join(outdir, f"host0{procid}"),
                f, do_h2=True, n_buckets=4, distributed=True)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


_ALIGN_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)
    import jax
    jax.config.update("jax_platforms", "cpu")

    coord, procid, ref, outdir = sys.argv[1:5]
    buckets = sys.argv[5:]
    from ema_tpu import cli
    rc = cli.main(["align", "-r", ref, "-x",
                   "--coordinator", coord, "--nprocs", "2",
                   "--procid", procid,
                   "-o", os.path.join(outdir, "out.sam"), *buckets])
    raise SystemExit(rc)
""")


def test_two_process_distributed_align(tmp_path):
    """align -x --coordinator: two real jax.distributed processes shard
    the bucket list by process topology; their shard outputs together
    must equal the single-process run record-for-record."""
    import numpy as np

    from ema_tpu import cli
    from tests.simulate import rand_genome, simulate_pairs, to_str

    rng = np.random.default_rng(6)
    gs = to_str(rand_genome(rng, 120_000))
    ref = tmp_path / "ref.fa"
    with open(ref, "w") as f:
        f.write(">c1\n")
        for i in range(0, len(gs), 70):
            f.write(gs[i:i + 70] + "\n")

    ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
        rng, gs, n_barcodes=6, frags_per_bc=(1, 2), pairs_per_frag=(6, 10))
    # four special-format buckets, two barcodes-ish each
    uniq = sorted(set(bc_strs))
    buckets = []
    for b in range(4):
        p = tmp_path / f"ema-bin-{b:03d}"
        with open(p, "w") as f:
            for i in range(len(ids)):
                if uniq.index(bc_strs[i]) % 4 == b:
                    f.write(f"{bc_strs[i]} @{ids[i]} {s1[i]} {q1[i]} "
                            f"{s2[i]} {q2[i]}\n")
        buckets.append(str(p))

    single = tmp_path / "single.sam"
    assert cli.main(["align", "-r", str(ref), "-x", "-o", str(single),
                     *buckets]) == 0

    worker = tmp_path / "align_worker.py"
    worker.write_text(_ALIGN_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__))
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    dirs = []
    procs = []
    for i in range(2):
        d = tmp_path / f"host{i}"
        d.mkdir()
        dirs.append(d)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), coord, str(i), str(ref),
             str(d), *buckets],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-3000:]

    def records(path):
        out = {}
        for ln in open(path):
            if ln.startswith("@"):
                continue
            f = ln.rstrip("\n").split("\t")
            # ignore MI (per-bucket namespaces differ only by id value,
            # compared elsewhere as a bijection) and PG-ish variance
            key = (f[0], int(f[1]) & 0xC0)
            out[key] = (f[1], f[2], f[3], f[4], f[5], f[9])
        return out

    want = records(single)
    got = {}
    import glob
    for d in dirs:
        for shard in glob.glob(str(d / "out.shard*.sam")):
            got.update(records(shard))
    assert got == want


def test_two_process_distributed_preproc(tmp_path):
    from ema_tpu.preproc import correct as correct_mod
    from ema_tpu.preproc import count as count_mod

    wl, fq = make_dataset(seed=11, n_wl=200, n_pairs=400)
    wl_path = write_wl(tmp_path, wl)

    # split the interleaved FASTQ stream in half (pair-aligned)
    lines = fq.decode().splitlines(keepends=True)
    mid = (len(lines) // 16) * 8
    chunks = ["".join(lines[:mid]).encode(),
              "".join(lines[mid:]).encode()]
    fq_paths = []
    for i, c in enumerate(chunks):
        p = tmp_path / f"chunk{i}.fq"
        p.write_bytes(c)
        fq_paths.append(p)

    # per-host count on the local chunk only
    prefixes = []
    for i, c in enumerate(chunks):
        pref = tmp_path / f"cnt{i}"
        count_mod.count(str(wl_path), str(pref), io.BytesIO(c))
        prefixes.append(str(pref) + ".ema-ncnt")

    # single-process baseline on the full input with BOTH count outputs
    single = tmp_path / "single"
    correct_mod.correct(str(wl_path), prefixes, str(single),
                        io.BytesIO(fq), do_h2=True, n_buckets=4)

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__))
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(i), str(wl_path),
             prefixes[i], str(tmp_path), str(fq_paths[i])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)
    ]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-3000:]

    # 1. the allreduce really summed across processes
    want = (np.arange(5) + 0) + (np.arange(5) + 10)
    for i in range(2):
        got = np.load(tmp_path / f"allreduce{i}.npy")
        np.testing.assert_array_equal(got, want)

    # 2. concatenated per-host buckets == single-process buckets, byte
    # for byte (global routing identical; stream order preserved)
    for b in range(4):
        name = f"ema-bin-{b:03d}"
        merged = b"".join(
            (tmp_path / f"host0{i}" / name).read_bytes()
            for i in range(2))
        assert merged == (single / name).read_bytes(), name
    merged_nobc = b"".join(
        (tmp_path / f"host0{i}" / "ema-nobc").read_bytes()
        for i in range(2))
    assert merged_nobc == (single / "ema-nobc").read_bytes()
