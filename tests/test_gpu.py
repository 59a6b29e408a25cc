"""Counting on an NVIDIA GPU against the plain references.

These need the card and skip elsewhere; run them there with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import numpy as np
import pytest

import chip_smoke as cs
from tests.oracle import blocked_model, twobit_hashes

pytestmark = pytest.mark.gpu


def _reads(tmp_path, n_reads):
    reads, _ = cs.generate_reads(4, genome_len=200_000, n_reads=n_reads)
    path = str(tmp_path / "reads.fq")
    cs.write_fastq(path, reads)
    return reads, path


def test_blocked_consume_on_gpu_matches_model(gpu_device, tmp_path):
    from khmer_tpu.core.blocked import BlockedCountgraph

    reads, path = _reads(tmp_path, 40_000)
    g = BlockedCountgraph(20, 2.5e6, 4)
    g.consume_seqfile(path)
    assert g.tables[0].devices() == {gpu_device}
    table, n_unique = blocked_model(twobit_hashes(reads, 20), g.nblocks)
    np.testing.assert_array_equal(np.asarray(g.tables[0]).ravel(), table)
    assert g.n_unique_kmers() == n_unique


def test_exact_consume_on_gpu_matches_host_tier(gpu_device, tmp_path):
    from khmer_tpu import Countgraph
    from khmer_tpu.core import hostengine, sketch_kernels

    if not hostengine.available():
        pytest.skip("needs the native host engine")
    _, path = _reads(tmp_path, 40_000)
    primes = sketch_kernels.get_n_primes_near_x(4, 2.5e7)
    assert sketch_kernels.use_v2_path("byte", primes, 1 << 20)
    dev = Countgraph(20, 1, 0, primes=primes)
    dev.set_use_bigcount(True)
    dev.consume_seqfile(path)
    assert dev.tables[0].devices() == {gpu_device}
    host = Countgraph(20, 1, 0, primes=primes)
    host.set_use_bigcount(True)
    hostengine.consume_seqfile(host, path)
    for a, b in zip(dev.tables, host.host_view()):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert dev.n_unique_kmers() == host.n_unique_kmers()
