"""Multi-host (2-process) validation: jax.distributed over the CPU
backend, per-host file decomposition, DCN merges, and a global-mesh
sharded consume — compared against a single-process oracle.

This is the SURVEY §5.8 story made runnable on one machine: two real
JAX processes form one multi-controller SPMD program (an 8-device mesh,
4 per process), standing in for two hosts.
"""

import json
import os
import random
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_inputs(workdir, nfiles=2):
    rng = random.Random(99)
    pool = ["".join(rng.choice("ACGT") for _ in range(120))
            for _ in range(8)]
    for i in range(nfiles):
        with open(os.path.join(workdir, "part%d.fa" % i), "w") as fp:
            for j in range(40):
                seq = rng.choice(pool)
                fp.write(">p%d_r%d\n%s\n" % (i, j, seq))


def run_workers(workdir, nprocs=2, timeout=600, local_devices=None,
                table_size=20000):
    if local_devices is None:
        local_devices = max(8 // nprocs, 1)
    port = _free_port()
    coordinator = "127.0.0.1:%d" % port
    out = os.path.join(workdir, "result.json")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = []
    for pid in range(nprocs):
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, coordinator, str(nprocs),
             str(pid), out, workdir, str(local_devices),
             str(table_size)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=timeout)
        outs.append((p.returncode, so.decode(), se.decode()))
    for rc, so, se in outs:
        assert rc == 0, "worker failed rc=%s\nstdout:%s\nstderr:%s" % (
            rc, so[-2000:], se[-2000:])
    with open(out) as f:
        return json.load(f)


def test_two_process_run_matches_single_process_oracle(tmp_path):
    _write_inputs(str(tmp_path))
    result = run_workers(str(tmp_path))
    assert result["processes"] == 2
    assert result["devices"] == 8

    # single-process oracle over BOTH files
    from khmer_tpu import HLLCounter, Nodegraph
    from khmer_tpu.core.partition import SubsetPartition

    g = Nodegraph(15, 20000, 4)
    for i in range(2):
        g.consume_seqfile_and_tag(str(tmp_path / ("part%d.fa" % i)))
    assert result["n_tags"] == len(g.all_tags)
    want_bits = [int(__import__("numpy").unpackbits(t).sum())
                 for t in g.host_view()]
    assert result["merged_unique_bits"] == want_bits

    sp = SubsetPartition(g)
    sp.do_partition(0, 0)
    n_part, n_un = sp.count_partitions()
    assert result["n_partitions"] == n_part
    assert result["n_unassigned"] == n_un

    h = HLLCounter(0.01, 15)
    for i in range(2):
        h.consume_seqfile(str(tmp_path / ("part%d.fa" % i)))
    assert result["hll_estimate"] == h.estimate_cardinality()

    assert result["global_consume_unique"] > 0


def test_four_process_run_matches_single_process_oracle(tmp_path):
    """SURVEY §5.8 at N=4: four jax.distributed processes (2 virtual
    devices each -> one 8-device global mesh), four input files, tag
    range split four ways, pmaps folded on process 0 — all results
    equal to the single-process oracle, with DCN phase timings
    recorded (see scripts/bench_multihost.py for the scaling sweep)."""
    _write_inputs(str(tmp_path), nfiles=4)
    result = run_workers(str(tmp_path), nprocs=4)
    assert result["processes"] == 4
    assert result["devices"] == 8

    from khmer_tpu import HLLCounter, Nodegraph
    from khmer_tpu.core.partition import SubsetPartition

    g = Nodegraph(15, 20000, 4)
    for i in range(4):
        g.consume_seqfile_and_tag(str(tmp_path / ("part%d.fa" % i)))
    assert result["n_tags"] == len(g.all_tags)
    want_bits = [int(__import__("numpy").unpackbits(t).sum())
                 for t in g.host_view()]
    assert result["merged_unique_bits"] == want_bits

    sp = SubsetPartition(g)
    sp.do_partition(0, 0)
    n_part, n_un = sp.count_partitions()
    assert result["n_partitions"] == n_part
    assert result["n_unassigned"] == n_un

    h = HLLCounter(0.01, 15)
    for i in range(4):
        h.consume_seqfile(str(tmp_path / ("part%d.fa" % i)))
    assert result["hll_estimate"] == h.estimate_cardinality()
    assert result["global_consume_unique"] > 0
    assert set(result["timings"]) >= {
        "dcn_union_s", "partition_bfs_s", "pmap_fold_s",
        "global_consume_s", "hll_merge_s"}
