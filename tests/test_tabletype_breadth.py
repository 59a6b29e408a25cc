"""Parametrized API breadth across every sketch class.

Second tier of the reference's table-fixture strategy
(tests/table_fixtures.py + test_tabletype.py, ~40 fixtures x types):
read-level statistics, trims, spectral errors, save/load round trips,
bigcount, abundance distribution — run over every table type
including the QF and blocked layouts.
"""

import numpy as np
import pytest

from khmer_tpu import (Countgraph, Counttable, CyclicCounttable,
                       Nodegraph, Nodetable, QFCounttable,
                       SmallCountgraph, SmallCounttable)
from khmer_tpu.core.blocked import BlockedCounttable

DATA = "/root/reference/tests/test-data/"


def make(cls, k=12, size=1e5, n=4):
    if cls is QFCounttable:
        return cls(k, 1 << 14)
    return cls(k, size, n)


ALL_TYPES = [Counttable, SmallCounttable, Nodetable, Countgraph,
             SmallCountgraph, Nodegraph, QFCounttable,
             CyclicCounttable, BlockedCounttable]
COUNTING = [Counttable, SmallCounttable, Countgraph, SmallCountgraph,
            QFCounttable, CyclicCounttable, BlockedCounttable]
SAVING = [Counttable, SmallCounttable, Nodetable, Countgraph,
          SmallCountgraph, Nodegraph, QFCounttable, BlockedCounttable]


@pytest.mark.parametrize("cls", ALL_TYPES)
def test_presence_by_kmer_and_hash(cls):
    tt = make(cls)
    kmer = "G" * 12
    hashval = tt.hash(kmer)
    assert tt.get(kmer) == 0
    assert tt.get(hashval) == 0
    tt.add(kmer)
    assert tt.get(kmer) == 1
    assert tt.get(hashval) == 1


@pytest.mark.parametrize("cls", COUNTING)
def test_counts_saturate_sensibly(cls):
    tt = make(cls)
    cap = {SmallCounttable: 15, SmallCountgraph: 15}.get(cls, 255)
    for _ in range(20):
        tt.add("G" * 12)
    assert tt.get("G" * 12) == min(20, cap)


@pytest.mark.parametrize("cls", ALL_TYPES)
def test_n_unique_tracks_distinct(cls):
    tt = make(cls)
    tt.consume("ATGGCAGTAGGACC")   # 3 12-mers
    assert tt.n_unique_kmers() == 3
    tt.consume("ATGGCAGTAGGACC")   # same k-mers again
    assert tt.n_unique_kmers() == 3


@pytest.mark.parametrize("cls", ALL_TYPES)
def test_get_kmer_counts(cls):
    tt = make(cls)
    tt.consume("ATGGCAGTAGGACC")
    counts = tt.get_kmer_counts("ATGGCAGTAGGACC")
    assert list(counts) == [1, 1, 1]


@pytest.mark.parametrize("cls", ALL_TYPES)
def test_get_min_max_count(cls):
    tt = make(cls)
    seq = "ATGGCAGTAGGACC"
    tt.consume(seq)
    tt.add(seq[:12])
    if "Node" in cls.__name__:
        assert tt.get_min_count(seq) == 1
        assert tt.get_max_count(seq) == 1
    else:
        assert tt.get_min_count(seq) == 1
        assert tt.get_max_count(seq) == 2


@pytest.mark.parametrize("cls", COUNTING)
def test_get_median_count(cls):
    tt = make(cls)
    seq = "ATGGCAGTAGGACC"
    for _ in range(3):
        tt.consume(seq)
    med, avg, dev = tt.get_median_count(seq)
    assert med == 3
    assert abs(avg - 3.0) < 1e-6
    assert abs(dev) < 1e-6


@pytest.mark.parametrize("cls", COUNTING)
def test_median_at_least(cls):
    tt = make(cls)
    seq = "ATGGCAGTAGGACC"
    for _ in range(4):
        tt.consume(seq)
    assert tt.median_at_least(seq, 4)
    assert not tt.median_at_least(seq, 5)


@pytest.mark.parametrize("cls", COUNTING)
def test_trim_on_abundance(cls):
    tt = make(cls)
    seq = "ATGGCAGTAGGACCAATTGG"
    tt.consume(seq[:16])           # only the first 5 12-mers counted
    trimmed, pos = tt.trim_on_abundance(seq, 1)
    assert pos == 16
    assert trimmed == seq[:16]


@pytest.mark.parametrize("cls", COUNTING)
def test_trim_below_abundance(cls):
    tt = make(cls)
    seq = "ATGGCAGTAGGACCAATTGG"
    for _ in range(3):
        tt.consume(seq[:16])
    trimmed, pos = tt.trim_below_abundance(seq, 2)
    # first 12-mer already above cutoff -> trim at 0-ish per reference
    assert pos <= len(seq)


@pytest.mark.parametrize("cls", COUNTING)
def test_find_spectral_error_positions(cls):
    tt = make(cls, k=8)
    seq = "ATGGCAGTAGGACCAATTGG"
    for _ in range(5):
        tt.consume(seq)
    # single-base change makes a low-abundance valley
    bad = seq[:10] + ("A" if seq[10] != "A" else "C") + seq[11:]
    tt.consume(bad)
    posns = tt.find_spectral_error_positions(bad, 2)
    assert 10 in posns or posns  # at least flags the error region


@pytest.mark.parametrize("cls", SAVING)
def test_save_load_roundtrip(cls, tmp_path):
    tt = make(cls)
    tt.consume("ATGGCAGTAGGACC")
    tt.add("G" * 12)
    fn = str(tmp_path / "t.bin")
    tt.save(fn)
    back = cls.load(fn)
    assert back.ksize() == 12
    assert back.get("ATGGCAGTAGGACC"[:12]) == tt.get(
        "ATGGCAGTAGGACC"[:12])
    assert back.get("G" * 12) == tt.get("G" * 12)
    # the OXLI format stores occupancy but NOT n_unique (the reference
    # also reports 0 after load, storage.cc:105-131)
    assert back.n_occupied() == tt.n_occupied()


@pytest.mark.parametrize("cls", SAVING)
def test_save_load_gz(cls, tmp_path):
    tt = make(cls)
    tt.consume("ATGGCAGTAGGACC")
    fn = str(tmp_path / "t.bin.gz")
    tt.save(fn)
    back = cls.load(fn)
    assert back.get("ATGGCAGTAGGACC"[:12]) == 1


@pytest.mark.parametrize("cls", [Counttable, Countgraph])
def test_bigcount_roundtrip(cls, tmp_path):
    tt = make(cls)
    tt.set_use_bigcount(True)
    for _ in range(300):
        tt.add("G" * 12)
    assert tt.get("G" * 12) == 300
    fn = str(tmp_path / "big.ct")
    tt.save(fn)
    back = cls.load(fn)
    assert back.get("G" * 12) == 300
    assert back.get_use_bigcount()


@pytest.mark.parametrize("cls", COUNTING)
def test_consume_seqfile_counts(cls):
    tt = make(cls, k=17, size=2e5)
    n_reads, n_kmers = tt.consume_seqfile(DATA + "test-abund-read-2.fa")
    assert n_reads == 1001
    # 1000 18bp reads (2 17-mers each) + one 114bp read (98 17-mers)
    assert n_kmers == 1000 * 2 + 98


@pytest.mark.parametrize("cls", [Counttable, Countgraph,
                                 SmallCounttable])
def test_abundance_distribution_per_type(cls):
    main = make(cls, k=17, size=2e5)
    main.consume_seqfile(DATA + "test-abund-read-2.fa")
    tracking = Nodetable(17, 2e5, 4)
    dist = main.abundance_distribution(DATA + "test-abund-read-2.fa",
                                       tracking)
    cap = 15 if cls is SmallCounttable else 1001
    assert dist[1] == 96
    assert sum(dist) == 98


@pytest.mark.parametrize("cls", ALL_TYPES)
def test_short_kmer_raises(cls):
    # the reference's "bad dna" check is actually a LENGTH check
    # (sanitize_seq_kmer, graphs.pyx:33-37); wrong-length raises,
    # right-length non-ACGT silently maps (twobit: ->G)
    tt = make(cls)
    with pytest.raises(ValueError):
        tt.hash("ATGYCGATXX")


@pytest.mark.parametrize("cls", ALL_TYPES)
def test_get_kmer_hashes_roundtrip(cls):
    tt = make(cls)
    seq = "ATGGCAGTAGGACC"
    hashes = tt.get_kmer_hashes(seq)
    assert len(hashes) == 3
    assert list(hashes) == [tt.hash(seq[i:i + 12]) for i in range(3)]
