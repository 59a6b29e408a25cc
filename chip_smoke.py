#!/usr/bin/env python
"""Smoke run of khmer_tpu's main path on one NVIDIA GPU.

    python chip_smoke.py [--seed 1]
    python chip_smoke.py --four-cards     # the sharded paths on 4 GPUs

One process drives the card and calls the CLI entry points in-process
(a second JAX process could not reserve the card's memory). Phases:

1. device check: JAX's first device must be a GPU; no CPU fallback;
2. reads from --seed: a 5 Mbp random genome, 1,000,000 reads of
   150 bp (30x, 1% substitutions) written as FASTQ to a scratch dir;
3. `load-into-counting.py -k 20 -M 2e9 --tpu-layout blocked`, compared
   byte for byte (table and n_unique) with a numpy model of the
   blocked layout (tests/oracle.py);
4. `load-into-counting.py -k 20 -N 4 -M 2e9` (exact khmer layout),
   compared by digest with the host tier's .ct;
   both phases also time the host's parse + hash pass alone;
5. the device tier (KHMER_TPU_ENGINE=device) of normalize-by-median,
   trim-low-abund, unique-kmers and do-partition on the repo's data,
   each compared with the host tier and the pinned reference outputs,
   and normalize-by-median on the first 200,000 generated reads.

Every phase prints its wall time, compile time, rate (with the card's
name and power limit) and the device's peak memory so far. Any failed
comparison raises, so the script exits non-zero; only a run in which
every phase passed ends with the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

With --four-cards only the sharded paths run, on 4 GPUs
(__graft_entry__.dryrun_multichip): counting and HLL on the first
200,000 generated reads, partitioning and diginorm on those of them
that lie in the genome's first 100 kb (~6x, so reads join up), every
table at -x 2e9 -N 4.
"""

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data")

K = 20
READ_LEN = 150
ERROR_RATE = 0.01
GENOME_LEN = 5_000_000
N_READS = 1_000_000
MEMORY = "2e9"        # -M: bytes of counting table
BATTERY_READS = 200_000
# mesh partitioning costs ~3 ms of host BFS bookkeeping per tag, so the
# four-card graph checks take the reads of one genome window
GRAPH_WINDOW = 100_000


def log(msg):
    print(msg, flush=True)


# -- reads ------------------------------------------------------------------

def generate_reads(seed, genome_len=GENOME_LEN, n_reads=N_READS,
                   read_len=READ_LEN, error_rate=ERROR_RATE,
                   batch=100_000):
    """Reads of a random genome, from `seed` alone.

    Returns ([n_reads, read_len] uint8 codes (A=0, T=1, C=2, G=3),
    [n_reads] genome offsets). Each read is a uniform window of the
    genome, from either strand, with independent substitutions at
    `error_rate` per base.
    """
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    reads = np.empty((n_reads, read_len), np.uint8)
    starts = np.empty(n_reads, np.int64)
    cols = np.arange(read_len)
    for lo in range(0, n_reads, batch):
        n = min(batch, n_reads - lo)
        s = rng.integers(0, genome_len - read_len + 1, n)
        starts[lo:lo + n] = s
        r = genome[s[:, None] + cols]
        flip = rng.random(n) < 0.5
        r[flip] = r[flip, ::-1] ^ np.uint8(1)     # reverse complement
        err = rng.random((n, read_len)) < error_rate
        r[err] = (r[err] + rng.integers(1, 4, int(err.sum()),
                                        dtype=np.uint8)) & np.uint8(3)
        reads[lo:lo + n] = r
    return reads, starts


def write_fastq(path, reads, batch=100_000):
    """Uncompressed FASTQ: @r<8 digits>, the bases, '+', all-'I' quals."""
    n, L = reads.shape
    letters = np.frombuffer(b"ATCG", np.uint8)
    rec = 11 + L + 3 + L + 1
    with open(path, "wb") as f:
        for lo in range(0, n, batch):
            m = min(batch, n - lo)
            idx = np.arange(lo, lo + m)
            out = np.empty((m, rec), np.uint8)
            out[:, 0] = ord("@")
            out[:, 1] = ord("r")
            for d in range(8):
                out[:, 2 + d] = ord("0") + (idx // 10 ** (7 - d)) % 10
            out[:, 10] = ord("\n")
            out[:, 11:11 + L] = letters[reads[lo:lo + m]]
            out[:, 11 + L:14 + L] = np.frombuffer(b"\n+\n", np.uint8)
            out[:, 14 + L:14 + 2 * L] = ord("I")
            out[:, -1] = ord("\n")
            f.write(out.tobytes())


def reads_as_strings(reads):
    letters = np.frombuffer(b"ATCG", np.uint8)
    return [row.tobytes().decode() for row in letters[reads]]


# -- helpers ----------------------------------------------------------------

class Card:
    """The device under test and what is printed beside every rate."""

    def __init__(self, n_devices):
        import jax

        devs = jax.devices()
        if devs[0].platform != "gpu":
            raise SystemExit("chip_smoke: JAX's first device is %r "
                             "(platform %s), not a GPU"
                             % (devs[0].device_kind, devs[0].platform))
        if len(devs) < n_devices:
            raise SystemExit("chip_smoke: %d GPU(s) present, %d needed"
                             % (len(devs), n_devices))
        self.devices = devs
        self.device = devs[0]
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        self.smi = smi.stdout.strip().splitlines()
        self.label = self.smi[0]
        log("jax %s; %d device(s); device_kind %s"
            % (jax.__version__, len(devs), self.device.device_kind))
        log("nvidia-smi name,power.limit: %s" % " | ".join(self.smi))

    def peak_bytes(self):
        return max(d.memory_stats()["peak_bytes_in_use"]
                   for d in self.devices)


@contextlib.contextmanager
def phase(card, name):
    log("== %s" % name)
    t0 = time.perf_counter()
    yield
    log("== %s: passed, wall %.3f s, device peak bytes in use so far %d"
        % (name, time.perf_counter() - t0, card.peak_bytes()))


@contextlib.contextmanager
def engine(mode):
    old = os.environ.get("KHMER_TPU_ENGINE")
    os.environ["KHMER_TPU_ENGINE"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["KHMER_TPU_ENGINE"]
        else:
            os.environ["KHMER_TPU_ENGINE"] = old


def run_cli(main, argv, cwd):
    """Run one CLI main() in-process in `cwd`; returns (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old_argv, old_cwd = sys.argv, os.getcwd()
    sys.argv = list(argv)
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            try:
                main()
            except SystemExit as e:
                if e.code not in (None, 0):
                    raise RuntimeError("%s exited with %r:\n%s"
                                       % (argv[0], e.code,
                                          err.getvalue()[-3000:]))
    finally:
        sys.argv = old_argv
        os.chdir(old_cwd)
    return out.getvalue(), err.getvalue()


def digest(path, algo="sha256"):
    """Streamed digest of a file (2 GB tables never sit in memory)."""
    h = hashlib.new(algo)
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 24), b""):
            h.update(blk)
    return h.hexdigest()


def info_unique(info_path):
    with open(info_path) as f:
        m = re.search(r"Total number of unique k-mers: (\d+)", f.read())
    return int(m.group(1))


def check(ok, what):
    if not ok:
        raise AssertionError(what)
    log("   ok: %s" % what)


def dense_step(card, kind, primes, with_bigcount, reps=10):
    """Compile the dense consume step for these tables, print its
    memory analysis, and time it on one staged batch of random hashes
    (`reps` steps after one warm-up, ending in block_until_ready)."""
    import jax
    import jax.numpy as jnp

    from khmer_tpu.core import pipeline, sketch_kernels

    step = pipeline.make_dense_consume(kind, tuple(primes),
                                       with_bigcount=with_bigcount)
    if kind == "blocked":
        tables = (jax.ShapeDtypeStruct((primes[0], 128), jnp.uint8),)
    else:
        tables = tuple(jax.ShapeDtypeStruct((p,), jnp.uint8)
                       for p in primes)
    u64 = jax.ShapeDtypeStruct((), jnp.uint64)
    t0 = time.perf_counter()
    compiled = step.lower(
        tables, u64, u64, jax.ShapeDtypeStruct((), jnp.bool_),
        jax.ShapeDtypeStruct((pipeline.DENSE_CHUNK,), jnp.uint64),
        jax.ShapeDtypeStruct((), jnp.int32)).compile()
    dt = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    log("   dense consume step (%s, %d events/batch) compiled in %.3f s; "
        "memory_analysis: argument %d, output %d, alias %d, temp %d, "
        "generated code %d bytes"
        % (kind, pipeline.DENSE_CHUNK, dt, ma.argument_size_in_bytes,
           ma.output_size_in_bytes, ma.alias_size_in_bytes,
           ma.temp_size_in_bytes, ma.generated_code_size_in_bytes))

    rng = np.random.default_rng(0)
    hashes = jax.device_put(rng.integers(
        0, 2**63, pipeline.DENSE_CHUNK, dtype=np.uint64), card.device)
    nvalid = jnp.int32(pipeline.DENSE_CHUNK)
    state = (sketch_kernels.init_tables(kind, primes), jnp.uint64(0),
             jnp.uint64(0), jnp.zeros((), bool))
    for i in range(reps + 1):
        if i == 1:
            jax.block_until_ready(state)
            t0 = time.perf_counter()
        state = compiled(*state, hashes, nvalid)[:4]
    jax.block_until_ready(state)
    step_s = (time.perf_counter() - t0) / reps
    log("   dense consume step (%s) with inputs staged: %.3f ms per "
        "batch = %.1f k-mers/s on %s"
        % (kind, step_s * 1e3, pipeline.DENSE_CHUNK / step_s, card.label))
    del state


def host_pass(fq, n_kmers):
    """Time the host's parse + hash pass alone (the CLI's dense path
    without the device); print the chunk sizes it ships, which are the
    dense step shapes the CLI compiles."""
    from khmer_tpu.core import pipeline
    from khmer_tpu.io import native

    hasher = pipeline.DenseHasher(K, "twobit")
    sizes = set()
    t0 = time.perf_counter()
    for codes, meta, _ in native.pack_blocks(fq):
        sizes.update(len(h) for h, _ in hasher.add_block(
            codes, meta[:, 0], meta[:, 1]))
    sizes.update(len(h) for h, _ in hasher.flush())
    wall = time.perf_counter() - t0
    log("   host parse + hash pass alone: %.3f s = %.1f k-mers/s (host "
        "CPU); dense step shapes the CLI compiles: %s"
        % (wall, n_kmers / wall, sorted(sizes)))


# -- phases -----------------------------------------------------------------

def count_blocked(card, work, fq, reads):
    from khmer_tpu.cli import load_into_counting
    from khmer_tpu.core import blocked, sketch_kernels
    from tests.oracle import blocked_model, twobit_hashes

    nblocks = sketch_kernels.get_n_primes_near_x(
        1, int(float(MEMORY)) // blocked.LANES + 1)[0]
    n_kmers = reads.shape[0] * (reads.shape[1] - K + 1)
    dense_step(card, "blocked", (nblocks,), False)
    host_pass(fq, n_kmers)
    out = os.path.join(work, "blocked.ct")
    t0 = time.perf_counter()
    run_cli(load_into_counting.main,
            ["load-into-counting.py", "-k", str(K), "-M", MEMORY,
             "--tpu-layout", "blocked", out, fq], work)
    wall = time.perf_counter() - t0
    log("   load-into-counting blocked: %d k-mers in %.3f s = %.1f "
        "k-mers/s end to end (parse, hash, count, save) on %s"
        % (n_kmers, wall, n_kmers / wall, card.label))
    got_unique = info_unique(out + ".info")

    t0 = time.perf_counter()
    want_table, want_unique = blocked_model(twobit_hashes(reads, K),
                                            nblocks)
    log("   numpy blocked model over the full stream (%d k-mers, %d "
        "blocks): %.3f s" % (n_kmers, nblocks, time.perf_counter() - t0))
    header = 4 + 2 + 20
    got_table = np.fromfile(out, np.uint8, offset=header)
    check(got_table.size == nblocks * blocked.LANES,
          "blocked table holds %d blocks (-M %s)" % (nblocks, MEMORY))
    check(np.array_equal(got_table, want_table),
          "blocked table bytes equal the numpy model")
    check(got_unique == want_unique,
          "blocked n_unique %d equals the model's %d"
          % (got_unique, want_unique))
    del got_table, want_table
    os.unlink(out)


def count_exact(card, work, fq, reads):
    from khmer_tpu import Countgraph
    from khmer_tpu.cli import load_into_counting
    from khmer_tpu.core import hostengine, sketch_kernels

    primes = sketch_kernels.get_n_primes_near_x(4, float(MEMORY) / 4)
    check(sketch_kernels.use_v2_path("byte", primes, 1 << 20),
          "the exact layout at -M %s takes the v2 update" % MEMORY)
    n_kmers = reads.shape[0] * (reads.shape[1] - K + 1)
    dense_step(card, "byte", primes, True)
    out = os.path.join(work, "exact.ct")
    t0 = time.perf_counter()
    run_cli(load_into_counting.main,
            ["load-into-counting.py", "-k", str(K), "-N", "4", "-M",
             MEMORY, out, fq], work)
    wall = time.perf_counter() - t0
    log("   load-into-counting exact: %d k-mers in %.3f s = %.1f "
        "k-mers/s end to end (parse, hash, count, save) on %s"
        % (n_kmers, wall, n_kmers / wall, card.label))
    got_unique = info_unique(out + ".info")

    t0 = time.perf_counter()
    host = Countgraph(K, 1, 0, primes=primes)
    host.set_use_bigcount(True)
    hostengine.consume_seqfile(host, fq)
    t1 = time.perf_counter()
    host_out = os.path.join(work, "exact_host.ct")
    host.save(host_out)
    t2 = time.perf_counter()
    host_unique = host.n_unique_kmers()
    del host
    log("   host tier count: %.3f s; save of its %d-byte .ct: %.3f s "
        "(host CPU)" % (t1 - t0, os.path.getsize(host_out), t2 - t1))
    check(digest(out) == digest(host_out),
          "exact .ct is byte-identical to the host tier's")
    check(got_unique == host_unique,
          "exact n_unique %d equals the host tier's %d"
          % (got_unique, host_unique))
    os.unlink(out)
    os.unlink(host_out)


def battery_run(name, main, argv, outputs, work):
    """Run one CLI under the host and the device engine; compare the
    named output files. Returns {engine: (stderr, {output: path})}."""
    res = {}
    for mode in ("host", "device"):
        cwd = os.path.join(work, "%s_%s" % (name, mode))
        t0 = time.perf_counter()
        with engine(mode):
            _, err = run_cli(main, [a.replace("@", cwd) for a in argv],
                             cwd)
        log("   %s, %s engine: %.3f s" % (name, mode,
                                          time.perf_counter() - t0))
        res[mode] = (err, {o: os.path.join(cwd, o) for o in outputs})
    for o in outputs:
        check(digest(res["host"][1][o]) == digest(res["device"][1][o]),
              "%s: device-tier %s is identical to the host tier's"
              % (name, o))
    return res


def partition_vs_golden(stamps):
    """Device-tier tagging + partition BFS against the reference's
    partition map (tests/test_partition_stamps.py, same parameters)."""
    import gzip

    from khmer_tpu import Nodegraph
    from khmer_tpu.core.partition import SubsetPartition

    want = {}
    with gzip.open(os.path.join(REPO, "tests", "golden",
                                "stamps_ref_pmap.txt.gz"), "rt") as f:
        for line in f:
            tag, pid = line.split()
            want[int(tag)] = int(pid)
    t0 = time.perf_counter()
    with engine("device"):
        ng = Nodegraph(20, 12.5e6, 4)
        ng.consume_seqfile_and_tag(stamps)
        sp = SubsetPartition(ng)
        sp.do_partition(0, 0, stop_big_traversals=True)
        counts = sp.count_partitions()
        got = {t: sp.get_partition_id(t) for t in want}
    log("   partition API, device engine: %.3f s"
        % (time.perf_counter() - t0))
    check(sorted(ng.all_tags) == sorted(want),
          "device-tier tag set equals the reference's %d tags"
          % len(want))
    check(counts == (51, 16025), "device-tier partitioning: %d "
          "partitions, %d unassigned == (51, 16025)" % counts)
    check(got == want, "device-tier partition ids equal the reference "
          "pmap")


def n_records(path, marker):
    with open(path, "rb") as f:
        return sum(1 for line in f if line.startswith(marker))


def device_battery(card, work, reads):
    from khmer_tpu.cli import (do_partition, normalize_by_median,
                               trim_low_abund, unique_kmers)
    from tests.test_fullscale_oracles import ABUNDTRIM_MD5, KEEP_MD5

    stamps = os.path.join(DATA, "stamps-reads.fa.gz")
    res = battery_run(
        "normalize-by-median", normalize_by_median.main,
        ["normalize-by-median.py", "-C", "20", "-k", "20", "-x", "1e8",
         "-N", "4", stamps], ["stamps-reads.fa.gz.keep"], work)
    keep = res["device"][1]["stamps-reads.fa.gz.keep"]
    check(n_records(keep, b">") == 7416, "diginorm keeps 7,416 reads")
    check(digest(keep, "md5") == KEEP_MD5, "diginorm .keep matches the reference")

    res = battery_run(
        "trim-low-abund", trim_low_abund.main,
        ["trim-low-abund.py", "-C", "2", "-Z", "20", "-x", "2.5e7", "-N",
         "4", "-k", "20", os.path.join(DATA, "25k.fq.gz")],
        ["25k.fq.gz.abundtrim"], work)
    check(digest(res["device"][1]["25k.fq.gz.abundtrim"], "md5")
          == ABUNDTRIM_MD5,
          "trim-low-abund .abundtrim matches the reference")

    res = battery_run(
        "unique-kmers", unique_kmers.main,
        ["unique-kmers.py", "-k", "20", "-e", "0.01",
         os.path.join(DATA, "stamps-genomes.fa")], [], work)
    for mode in ("host", "device"):
        est = int(re.search(r"Total estimated number of unique 20-mers: "
                            r"(\d+)", res[mode][0]).group(1))
        check(est == 7948, "unique-kmers %s estimate %d == 7,948"
              % (mode, est))

    res = battery_run(
        "do-partition", do_partition.main,
        ["do-partition.py", "-k", "20", "-x", "12.5e6", "-N", "4",
         "--no-big-traverse", "--keep-subsets", "@/stamps", stamps],
        ["stamps.subset.0.pmap", "stamps-reads.fa.gz.part"], work)
    n_out = [re.search(r"output (\d+) partitions", res[m][0]).group(1)
             for m in ("host", "device")]
    check(n_out[0] == n_out[1], "do-partition annotated reads with %s "
          "partitions on both tiers" % n_out[0])
    partition_vs_golden(stamps)

    # the first 200k reads cover the genome ~6x, so -C 5 (not 20) is
    # what makes diginorm discard some of them
    fq = os.path.join(work, "gen200k.fq")
    write_fastq(fq, reads[:BATTERY_READS])
    res = battery_run(
        "normalize-by-median (generated reads)", normalize_by_median.main,
        ["normalize-by-median.py", "-C", "5", "-k", "20", "-x", "1e8",
         "-N", "4", fq], ["gen200k.fq.keep"], work)
    kept = n_records(res["device"][1]["gen200k.fq.keep"], b"@r")
    check(0 < kept < BATTERY_READS, "diginorm -C 5 kept %d of the first "
          "%d generated reads" % (kept, BATTERY_READS))


def four_cards(card, seed):
    import __graft_entry__ as graft

    with phase(card, "reads (seed %d)" % seed):
        codes, starts = generate_reads(seed, n_reads=BATTERY_READS)
        reads = reads_as_strings(codes)
        graph_reads = [r for r, s in zip(reads, starts)
                       if s + READ_LEN <= GRAPH_WINDOW]
        log("   %d reads of %d bp; cut: partitioning and diginorm take "
            "the %d of them that lie in the genome's first %d bp"
            % (len(reads), READ_LEN, len(graph_reads), GRAPH_WINDOW))
    with phase(card, "sharded paths on %d GPUs vs single-device and "
               "numpy references (-x 2e9 -N 4: 2e9 bins of every table "
               "kind per card)" % len(card.devices)):
        graft.dryrun_multichip(len(card.devices), reads, graph_reads,
                               k=K, tablesize=2e9)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on 4 GPUs")
    args = ap.parse_args(argv)
    n_devices = 4 if args.four_cards else 1

    card = Card(n_devices)
    import khmer_tpu  # noqa: F401  (x64 mode, compile cache)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            four_cards(card, args.seed)
        else:
            with phase(card, "reads (seed %d)" % args.seed):
                reads, _ = generate_reads(args.seed)
                fq = os.path.join(work, "reads.fq")
                write_fastq(fq, reads)
                log("   %d reads of %d bp from a %d bp genome, %d k-mers"
                    " (k=%d), %d FASTQ bytes"
                    % (N_READS, READ_LEN, GENOME_LEN,
                       N_READS * (READ_LEN - K + 1), K,
                       os.path.getsize(fq)))
            with phase(card, "count, blocked layout, -M %s" % MEMORY):
                count_blocked(card, work, fq, reads)
            with phase(card, "count, exact khmer layout, -M %s" % MEMORY):
                count_exact(card, work, fq, reads)
            with phase(card, "device-tier battery vs host tier"):
                device_battery(card, work, reads)

    print(json.dumps({"ok": True, "device": {
        "platform": card.device.platform,
        "kind": card.device.device_kind,
        "count": len(card.devices)}}), flush=True)


if __name__ == "__main__":
    main()
