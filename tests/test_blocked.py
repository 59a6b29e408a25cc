"""Blocked Count-Min sketch: semantics + integration.

The blocked layout keeps a k-mer's four sub-counters inside one
128-byte block (core/blocked.py). Its *defined* semantics mirror
ByteStorage::add (storage.hh:571-624): saturating u8 counters, count =
min over the four lanes, new-k-mer iff some lane was zero at the
moment of the sequentially-ordered add. These tests check the batched
device kernels against a sequential numpy oracle of that definition.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from khmer_tpu import BlockedCountgraph, BlockedCounttable
from khmer_tpu.core import blocked as B


def _oracle(nblocks, table, hashes, valid):
    """Sequential adds under the blocked definition."""
    table = table.copy()
    mixed = np.asarray(B.mix64(jnp.asarray(hashes)))
    n_unique = 0
    event_new = np.zeros(len(hashes), bool)
    for e, (h, v) in enumerate(zip(hashes, valid)):
        if not v:
            continue
        blk = int(h % nblocks)
        is_new = False
        for t in range(B.SUB):
            lane = t * B.QUART + int((mixed[e] >> np.uint64(5 * t))
                                     & np.uint64(B.QUART - 1))
            if table[blk, lane] == 0:
                is_new = True
            if table[blk, lane] < 255:
                table[blk, lane] += 1
        if is_new:
            n_unique += 1
            event_new[e] = True
    return table, n_unique, event_new


def _counts_oracle(nblocks, table, hashes):
    mixed = np.asarray(B.mix64(jnp.asarray(hashes)))
    out = []
    for e, h in enumerate(hashes):
        blk = int(h % nblocks)
        c = 255
        for t in range(B.SUB):
            lane = t * B.QUART + int((mixed[e] >> np.uint64(5 * t))
                                     & np.uint64(B.QUART - 1))
            c = min(c, int(table[blk, lane]))
        out.append(c)
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_blocked_update_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    NB = 211
    M = 512
    table = np.zeros((NB, B.LANES), np.uint8)
    for rnd in range(3):
        hashes = (rng.integers(0, 150, M).astype(np.uint64)
                  * np.uint64(0x9E3779B97F4A7C15))
        valid = rng.random(M) < 0.85
        want_tab, want_nu, want_new = _oracle(NB, table, hashes, valid)
        tabs, n_unique, overflow, out = B.blocked_update_core(
            NB, (jnp.asarray(table),), jnp.uint64(0),
            jnp.zeros((), bool), jnp.asarray(hashes),
            jnp.asarray(valid), True)
        assert not bool(overflow)
        assert (np.asarray(tabs[0]) == want_tab).all()
        assert int(n_unique) == want_nu
        assert (np.asarray(out["event_new"]) == want_new).all()
        table = want_tab
        got = np.asarray(B.gather_counts(NB, tabs, jnp.asarray(hashes)))
        assert (got == _counts_oracle(NB, table, hashes)).all()


def test_blocked_saturation():
    NB = 97
    M = 512
    table = np.full((NB, B.LANES), 254, np.uint8)
    rng = np.random.default_rng(2)
    hashes = rng.integers(0, 30, M).astype(np.uint64)
    valid = np.ones(M, bool)
    want_tab, want_nu, _ = _oracle(NB, table, hashes, valid)
    tabs, n_unique, overflow, _ = B.blocked_update_core(
        NB, (jnp.asarray(table),), jnp.uint64(0), jnp.zeros((), bool),
        jnp.asarray(hashes), jnp.asarray(valid), False)
    assert not bool(overflow)
    assert (np.asarray(tabs[0]) == want_tab).all()
    assert int(n_unique) == want_nu == 0


def test_blocked_sketch_api_and_consume():
    rng = np.random.default_rng(7)
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 400))
    bg = BlockedCountgraph(20, 1e5, 4)
    n = bg.consume(seq)
    assert n == len(seq) - 19
    assert bg.get(seq[:20]) >= 1
    med, avg, dev = bg.get_median_count(seq)
    assert med >= 1
    # second consume doubles counts
    bg.consume(seq)
    assert bg.get(seq[:20]) >= 2
    assert bg.n_unique_kmers() <= 2 * n


def test_blocked_consume_seqfile_matches_per_read_consume(tmp_path):
    rng = np.random.default_rng(9)
    reads = ["".join("ACGT"[b] for b in rng.integers(0, 4, 80))
             for _ in range(60)]
    fq = tmp_path / "reads.fa"
    fq.write_text("".join(">r%d\n%s\n" % (i, s)
                          for i, s in enumerate(reads)))
    a = BlockedCounttable(21, 1e5, 4)
    n_reads, n_cons = a.consume_seqfile(str(fq))
    assert n_reads == 60

    b = BlockedCounttable(21, 1e5, 4)
    for s in reads:
        b.consume(s)
    assert a.n_unique_kmers() == b.n_unique_kmers()
    assert (np.asarray(a.tables[0]) == np.asarray(b.tables[0])).all()


def test_blocked_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 300))
    bg = BlockedCounttable(20, 1e5, 4)
    bg.consume(seq)
    fn = str(tmp_path / "x.bct")
    bg.save(fn)
    # OXLI-framed with the private extension type byte
    head = open(fn, "rb").read(6)
    assert head[:4] == b"OXLI" and head[5] == B.SAVED_BLOCKED

    lg = BlockedCounttable.load(fn)
    assert lg.ksize() == 20
    assert lg.nblocks == bg.nblocks
    assert (np.asarray(lg.tables[0]) == np.asarray(bg.tables[0])).all()
    assert lg.get(seq[:20]) == bg.get(seq[:20])
    assert lg.n_occupied() == bg.n_occupied()

    # khmer-type files must be rejected
    from khmer_tpu import Countgraph
    cg = Countgraph(6, 1000, 2)
    ct = str(tmp_path / "a.ct")
    cg.save(ct)
    with pytest.raises(OSError):
        BlockedCounttable.load(ct)


def test_blocked_graph_ops():
    """Graph membership probes work through the blocked storage."""
    rng = np.random.default_rng(6)
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 120))
    bg = BlockedCountgraph(20, 1e5, 4)
    bg.consume_and_tag(seq)
    assert len(bg.all_tags) >= 1
    assert bg.kmer_degree(seq[:20]) >= 1


def test_blocked_cli_load_into_counting(tmp_path):
    """--tpu-layout blocked builds, saves, and reloads via the CLI."""
    import sys

    from khmer_tpu.cli import load_into_counting

    out = str(tmp_path / "cli.bct")
    argv = sys.argv
    try:
        sys.argv = ["load-into-counting.py", "-k", "20", "-x", "1e5",
                    "-N", "4", "--tpu-layout", "blocked", out,
                    "/root/reference/tests/test-data/100-reads.fq.gz"]
        load_into_counting.main()
    finally:
        sys.argv = argv
    from khmer_tpu.core.blocked import BlockedCountgraph
    g = BlockedCountgraph.load(out)
    assert g.ksize() == 20
    assert g.n_occupied() > 3000
