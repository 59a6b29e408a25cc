"""Multi-device sharded counting: equivalence with the single-device
engine on the virtual 8-device CPU mesh (the mesh analog of khmer's
banding-composition test, tests/test_banding.py)."""

import numpy as np
import pytest

import jax

from khmer_tpu.core import pipeline
from khmer_tpu.core.sketch import Countgraph
from khmer_tpu.parallel import sharded


@pytest.fixture
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return sharded.make_mesh(jax.devices()[:8])


def test_sharded_counts_match_oracle(mesh):
    k = 8
    chunk = 1 << 12
    rng = np.random.default_rng(7)
    reads = ["".join("ATCG"[b] for b in rng.integers(0, 4, 50))
             for _ in range(60)]
    # include duplicates to exercise counts > 1
    reads = reads + reads[:10]

    packer = pipeline.FlatPacker(k, chunk=chunk)
    chunks = []
    for seq in reads:
        chunks.extend(packer.add(seq))
    tail = packer.flush()
    if tail is not None:
        chunks.append(tail)

    graph = sharded.ShardedCountgraph(k, 2048, 3, mesh)
    oracle = Countgraph(k, 1, 0, primes=graph._primes)
    for codes, starts, nfill in chunks:
        graph.consume_chunk(codes, starts, nfill)
    for seq in reads:
        oracle.consume(seq)

    all_hashes = np.unique(np.concatenate(
        [oracle._hashes_for_sequence(s) for s in reads]))
    pad = ((len(all_hashes) + 255) // 256) * 256
    hp = np.zeros(pad, dtype=np.uint64)
    hp[: len(all_hashes)] = all_hashes
    got = graph.get_counts(hp)[: len(all_hashes)]
    want = oracle.get_counts_for_hashes(all_hashes)
    np.testing.assert_array_equal(got, want)
    assert graph.n_unique_kmers() == oracle.n_unique_kmers()


def test_sharded_to_local_roundtrip(mesh):
    k = 8
    graph = sharded.ShardedCountgraph(k, 2048, 2, mesh)
    packer = pipeline.FlatPacker(k, chunk=1 << 12)
    chunks = packer.add("ATCGATCGATCGGGATTACA" * 3)
    tail = packer.flush()
    if tail is not None:
        chunks.append(tail)
    for codes, starts, nfill in chunks:
        graph.consume_chunk(codes, starts, nfill)
    local = graph.to_local_countgraph()
    assert local.get("ATCGATCG") >= 1


def test_graft_entry_compiles():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    jax.jit(fn).lower(*args).compile()


def test_dryrun_multichip():
    import importlib.util
    import os

    if len(jax.devices()) < 4:
        pytest.skip("needs 4+ devices")
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(4)


def test_sharded_blocked_matches_single_device(mesh):
    """Block-range-sharded blocked Count-Min == single-device blocked
    sketch: counts, n_unique, and gathered table bytes."""
    from khmer_tpu.core.blocked import BlockedCountgraph

    k = 8
    chunk = 1 << 12
    rng = np.random.default_rng(13)
    reads = ["".join("ATCG"[b] for b in rng.integers(0, 4, 50))
             for _ in range(50)]
    reads = reads + reads[:8]

    packer = pipeline.FlatPacker(k, chunk=chunk)
    chunks = []
    for seq in reads:
        chunks.extend(packer.add(seq))
    tail = packer.flush()
    if tail is not None:
        chunks.append(tail)

    graph = sharded.ShardedBlockedCountgraph(k, 4096, 4, mesh)
    oracle = BlockedCountgraph(k, 1, 1, primes=(graph.nblocks,))
    for codes, starts, nfill in chunks:
        graph.consume_chunk(codes, starts, nfill)
    for seq in reads:
        oracle.consume(seq)

    all_hashes = np.unique(np.concatenate(
        [oracle._hashes_for_sequence(s) for s in reads]))
    pad = ((len(all_hashes) + 255) // 256) * 256
    hp = np.zeros(pad, dtype=np.uint64)
    hp[: len(all_hashes)] = all_hashes
    got = graph.get_counts(hp)[: len(all_hashes)]
    want = oracle.get_counts_for_hashes(all_hashes)
    np.testing.assert_array_equal(got, want)
    assert graph.n_unique_kmers() == oracle.n_unique_kmers()

    local = graph.to_local()
    np.testing.assert_array_equal(np.asarray(local.tables[0]),
                                  np.asarray(oracle.tables[0]))


def test_sharded_routed_exact_matches_oracle(mesh):
    """all_to_all-routed exact-layout consume == serial oracle
    (counts, n_unique) — the routed analog of the banding test."""
    k = 8
    chunk = 1 << 12
    rng = np.random.default_rng(11)
    reads = ["".join("ATCG"[b] for b in rng.integers(0, 4, 60))
             for _ in range(50)]
    reads = reads + reads[:20]  # duplicates: counts > 1 + credit races

    packer = pipeline.FlatPacker(k, chunk=chunk)
    chunks = []
    for seq in reads:
        chunks.extend(packer.add(seq))
    tail = packer.flush()
    if tail is not None:
        chunks.append(tail)

    graph = sharded.ShardedCountgraph(k, 2048, 3, mesh, route=True,
                                      route_slack=4.0)
    oracle = Countgraph(k, 1, 0, primes=graph._primes)
    for codes, starts, nfill in chunks:
        graph.consume_chunk(codes, starts, nfill)
    for seq in reads:
        oracle.consume(seq)

    all_hashes = np.unique(np.concatenate(
        [oracle._hashes_for_sequence(s) for s in reads]))
    pad = ((len(all_hashes) + 255) // 256) * 256
    hp = np.zeros(pad, dtype=np.uint64)
    hp[: len(all_hashes)] = all_hashes
    got = graph.get_counts(hp)[: len(all_hashes)]
    want = oracle.get_counts_for_hashes(all_hashes)
    np.testing.assert_array_equal(got, want)
    assert graph.n_unique_kmers() == oracle.n_unique_kmers()


def test_sharded_routed_overflow_demotes_exactly(mesh):
    """A pathologically skewed stream (one repeated k-mer) overflows
    the fixed route capacity; the chunk must be REPLAYED on the
    gathered path (with a warning + routing demoted) so results stay
    exact — never an undercount, never an abort."""
    k = 8
    chunk = 1 << 12
    packer = pipeline.FlatPacker(k, chunk=chunk)
    chunks = []
    for _ in range(4):
        chunks.extend(packer.add("ACGTACGT" * 64))
    tail = packer.flush()
    if tail is not None:
        chunks.append(tail)
    graph = sharded.ShardedCountgraph(k, 2048, 3, mesh, route=True,
                                      route_slack=0.05)
    oracle = sharded.ShardedCountgraph(k, 2048, 3, mesh, route=False)
    with pytest.warns(RuntimeWarning, match="route capacity"):
        for codes, starts, nfill in chunks:
            graph.consume_chunk(codes, starts, nfill)
    for codes, starts, nfill in chunks:
        oracle.consume_chunk(codes, starts, nfill)
    assert graph.route is False  # demoted for the rest of the stream
    assert graph.n_unique_kmers() == oracle.n_unique_kmers()
    import numpy as np

    for a, b in zip(graph.tables, oracle.tables):
        assert np.array_equal(np.asarray(a), np.asarray(b))
