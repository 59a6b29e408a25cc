"""CPU checks of the GPU smoke run's pieces and of the start-up rules:
the read generator, the numpy blocked-layout model, the compile-cache
placement, and that nothing falls back to the CPU or needs a TPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from tests.oracle import blocked_model, twobit_hashes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    res = subprocess.run(
        [sys.executable, "-c",
         "import khmer_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == want


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "not a GPU" in res.stderr


def test_read_generator_is_deterministic():
    a, sa = cs.generate_reads(7, genome_len=5000, n_reads=300, batch=128)
    b, sb = cs.generate_reads(7, genome_len=5000, n_reads=300, batch=128)
    c, _ = cs.generate_reads(8, genome_len=5000, n_reads=300, batch=128)
    assert a.shape == (300, cs.READ_LEN) and a.dtype == np.uint8
    assert a.max() <= 3
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sa, sb)
    assert not np.array_equal(a, c)


def test_read_generator_error_rate_and_strands():
    reads, starts = cs.generate_reads(3, genome_len=2000, n_reads=2000,
                                      error_rate=0.0)
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 2000, dtype=np.uint8)
    fwd = rev = 0
    for r, s in zip(reads[:200], starts[:200]):
        window = genome[s:s + cs.READ_LEN]
        if np.array_equal(r, window):
            fwd += 1
        elif np.array_equal(r[::-1] ^ 1, window):
            rev += 1
    assert fwd + rev == 200 and fwd > 50 and rev > 50
    noisy, _ = cs.generate_reads(3, genome_len=2000, n_reads=2000)
    rate = np.mean(noisy != reads)
    assert 0.005 < rate < 0.015


def test_fastq_writer_roundtrip(tmp_path):
    from khmer_tpu.io.fastx import FastxParser

    reads, _ = cs.generate_reads(5, genome_len=3000, n_reads=250,
                                 batch=100)
    path = str(tmp_path / "r.fq")
    cs.write_fastq(path, reads, batch=100)
    recs = list(FastxParser(path))
    assert [r.name for r in recs[:2]] == ["r00000000", "r00000001"]
    assert [r.sequence for r in recs] == cs.reads_as_strings(reads)
    assert all(r.quality == "I" * cs.READ_LEN for r in recs)


def test_twobit_hashes_match_host_hashing():
    from khmer_tpu.ops import hashing as H

    reads, _ = cs.generate_reads(2, genome_len=1000, n_reads=20)
    want = np.concatenate([H.host_hash_windows(r, 20) for r in reads])
    np.testing.assert_array_equal(twobit_hashes(reads, 20), want)


@pytest.mark.parametrize("tablesize", [64, 1e5])
def test_blocked_model_matches_blocked_countgraph(tmp_path, tablesize):
    """The numpy model equals the device path, including saturated
    lanes (the 64-byte table holds 2 blocks for ~39k k-mers)."""
    from khmer_tpu.core.blocked import BlockedCountgraph

    reads, _ = cs.generate_reads(11, genome_len=3000, n_reads=300)
    path = str(tmp_path / "r.fq")
    cs.write_fastq(path, reads)
    g = BlockedCountgraph(20, tablesize, 4)
    g.consume_seqfile(path)
    table, n_unique = blocked_model(twobit_hashes(reads, 20), g.nblocks)
    got = np.asarray(g.tables[0]).ravel()
    np.testing.assert_array_equal(got, table)
    assert g.n_unique_kmers() == n_unique
    if tablesize == 64:
        assert table.max() == 255


_TPU_ONLY = re.compile(
    r"pallas\.tpu|pallas\s+import\s+tpu|pltpu|"
    r"platform\s*==\s*[\"']tpu[\"']|_clear_backends")


def test_no_tpu_only_code():
    paths = [os.path.join(REPO, "bench.py"),
             os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "__graft_entry__.py")]
    for top in ("khmer_tpu", "scripts"):
        for root, _, files in os.walk(os.path.join(REPO, top)):
            paths.extend(os.path.join(root, f) for f in files
                         if f.endswith(".py"))
    hits = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if _TPU_ONLY.search(line):
                    hits.append("%s:%d: %s" % (p, i, line.strip()))
    assert not hits, "\n".join(hits)
