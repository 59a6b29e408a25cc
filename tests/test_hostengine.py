"""Cross-engine equivalence: native host tier vs JAX device tier.

Both engines must produce bit-identical results (tables, tags,
n_unique, partition maps, keep decisions).  The native engine is the
latency path (src/hostgraph.cc); the JAX path is the throughput /
mesh-sharded path — see doc/gpu.md "dual-engine runtime".
"""

import os
import random

import numpy as np
import pytest

from khmer_tpu import Countgraph, Nodegraph, SmallCountgraph
from khmer_tpu.core import hostengine

pytestmark = pytest.mark.skipif(not hostengine.available(),
                                reason="native host engine not built")


class _Rec:
    def __init__(self, seq, name="r", quality=""):
        self.name = name
        self.sequence = seq
        self.cleaned_seq = seq
        self.quality = quality


def _random_reads(n, length, seed, coverage_pool=None):
    rng = random.Random(seed)
    reads = []
    for i in range(n):
        if coverage_pool and rng.random() < 0.5:
            seq = rng.choice(coverage_pool)
            # mutate a base now and then
            if rng.random() < 0.3:
                j = rng.randrange(len(seq))
                seq = seq[:j] + rng.choice("ACGT") + seq[j + 1:]
        else:
            seq = "".join(rng.choice("ACGT") for _ in range(length))
        reads.append(_Rec(seq, "read%d" % i))
    return reads


def _pool(seed, n=8, length=220):
    rng = random.Random(seed)
    return ["".join(rng.choice("ACGT") for _ in range(length))
            for _ in range(n)]


def _force(monkeypatch, value):
    monkeypatch.setenv("KHMER_TPU_ENGINE", value)


@pytest.mark.parametrize("cls,size", [(Nodegraph, 3e4),
                                      (Countgraph, 3e4),
                                      (SmallCountgraph, 3e4)])
def test_consume_and_tag_engines_match(monkeypatch, cls, size):
    reads = _random_reads(300, 90, seed=7, coverage_pool=_pool(3))

    _force(monkeypatch, "device")
    gd = cls(17, size, 4)
    rd, cd = gd.consume_seqfile_and_tag(list(reads))

    _force(monkeypatch, "host")
    gh = cls(17, size, 4)
    rh, ch = gh.consume_seqfile_and_tag(list(reads))

    assert (rd, cd) == (rh, ch)
    assert gd.all_tags == gh.all_tags
    assert gd.n_unique_kmers() == gh.n_unique_kmers()
    assert gd.n_occupied() == gh.n_occupied()
    for a, b in zip(gd.host_view(), gh.host_view()):
        assert np.array_equal(a, b)


def test_find_all_tags_engines_match(monkeypatch):
    reads = _random_reads(200, 120, seed=11, coverage_pool=_pool(5))
    _force(monkeypatch, "host")
    g = Nodegraph(15, 2e4, 4)
    g.consume_seqfile_and_tag(list(reads))
    tags = sorted(g.all_tags)[:50]

    from khmer_tpu.core.partition import find_all_tags_batch
    from khmer_tpu.ops import hashing as H

    starts = []
    for t in tags:
        s = H.reverse_hash(t, 15)
        _, f, r = H._hash_scalar(s, 15)
        starts.append((f, r))

    for stop_big in (False, True):
        _force(monkeypatch, "host")
        host = find_all_tags_batch(g, starts,
                                   stop_big_traversals=stop_big)
        _force(monkeypatch, "device")
        dev = find_all_tags_batch(g, starts,
                                  stop_big_traversals=stop_big)
        assert host == dev


def test_do_partition_engines_match(monkeypatch):
    reads = _random_reads(250, 100, seed=13, coverage_pool=_pool(9))
    results = {}
    for eng in ("host", "device"):
        _force(monkeypatch, eng)
        g = Nodegraph(15, 2e4, 4)
        g.consume_seqfile_and_tag(list(reads))
        from khmer_tpu.core.partition import SubsetPartition

        sp = SubsetPartition(g)
        sp.do_partition(0, 0, stop_big_traversals=True)
        results[eng] = (sorted(g.all_tags),
                        {t: sp.get_partition_id(t) for t in g.all_tags},
                        sp.count_partitions())
    assert results["host"] == results["device"]


def test_diginorm_engines_match(monkeypatch):
    reads = _random_reads(400, 80, seed=17, coverage_pool=_pool(21, n=4))
    bundles = [[a, b] for a, b in zip(reads[::2], reads[1::2])]

    def run(engine):
        _force(monkeypatch, engine)
        g = Countgraph(17, 3e4, 4)
        if engine == "host":
            from khmer_tpu.core.hostengine import NativeNormalizer

            norm = NativeNormalizer(g, 5)
        else:
            from khmer_tpu.core.diginorm_scan import ScanNormalizer

            norm = ScanNormalizer(g, 5, window=64)
        kept = []
        W = 64
        for s in range(0, len(bundles), W):
            for res in norm.process_window(bundles[s:s + W]):
                kept.extend(r.name for r in res)
        norm.finalize()
        return kept, g.n_unique_kmers(), [np.array(t)
                                          for t in g.host_view()]

    kh, uh, th = run("host")
    kd, ud, td = run("device")
    assert kh == kd
    assert uh == ud
    for a, b in zip(th, td):
        assert np.array_equal(a, b)


def test_median_counts_match(monkeypatch):
    reads = _random_reads(150, 70, seed=23, coverage_pool=_pool(29))
    _force(monkeypatch, "host")
    g = Countgraph(17, 3e4, 4)
    for r in reads:
        g.consume(r.cleaned_seq)
    codes, starts, ends, _ = hostengine.pack_records(reads)
    med, avg, std = hostengine.median_counts(g, codes, starts, ends)
    for i, r in enumerate(reads):
        m2, a2, s2 = g.get_median_count(r.cleaned_seq)
        assert med[i] == m2
        assert abs(avg[i] - a2) < 1e-4 * max(1.0, abs(a2))
        assert abs(std[i] - s2) < 1e-3 * max(1.0, abs(s2))


def test_trim_filter_matches_trim_on_abundance(monkeypatch):
    reads = _random_reads(150, 60, seed=31, coverage_pool=_pool(37))
    _force(monkeypatch, "host")
    g = Countgraph(17, 3e4, 4)
    for r in reads[:75]:
        g.consume(r.cleaned_seq)
    codes, starts, ends, _ = hostengine.pack_records(reads)
    trim_at = hostengine.trim_filter(g, codes, starts, ends, cutoff=2)
    for i, r in enumerate(reads):
        _, expect = g.trim_on_abundance(r.cleaned_seq, 2)
        assert trim_at[i] == expect, r.cleaned_seq


def test_hll_against_python_engine():
    from khmer_tpu import HLLCounter

    reads = _random_reads(120, 150, seed=41)
    h1 = HLLCounter(0.01, 20)
    for r in reads:
        h1.consume_string(r.cleaned_seq)

    h2 = HLLCounter(0.01, 20)
    regs = h2._registers_array()
    codes, starts, ends, _ = hostengine.pack_records(reads)
    for s in range(0, len(reads), 40):
        e = min(s + 40, len(reads))
        import ctypes

        hostengine._load().hg_hll_consume(
            20, h2.ncounters_log2, regs.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            hostengine._arr(codes, hostengine._u8p),
            hostengine._arr(starts[s:e], hostengine._i64p),
            hostengine._arr(ends[s:e], hostengine._i64p), e - s)
    h2._adopt_registers(regs)
    assert h1.estimate_cardinality() == h2.estimate_cardinality()


def test_aligner_native_matches_python_engine():
    """hg_subalign must reproduce the Python A* bit for bit
    (scores, alignments, truncation) across random reads."""
    import random

    from khmer_tpu import Countgraph, ReadAligner

    rng = random.Random(51)
    genome = "".join(rng.choice("ACGT") for _ in range(1500))
    g = Countgraph(17, 5e4, 4)
    for _ in range(6):
        g.consume(genome)
    al = ReadAligner(g, 2, 1.0)
    for trial in range(30):
        i = rng.randrange(0, len(genome) - 80)
        s = list(genome[i:i + 80])
        for _ in range(rng.randrange(0, 4)):
            j = rng.randrange(80)
            s[j] = rng.choice("ACGT")
        if rng.random() < 0.3:  # an indel now and then
            j = rng.randrange(78)
            del s[j]
        read = "".join(s)

        native = al.align(read)

        real = al._native_subalign
        al._native_subalign = lambda *a, **k: None
        try:
            al._count_cache.clear()
            python = al.align(read)
        finally:
            al._native_subalign = real
        assert native == python, (trial, read, native, python)


def test_traverse_from_kmer_engines_match(monkeypatch):
    """hg_traverse_from_kmer == the Python bfs (counts AND keeper
    sets) across radii/caps/thresholds, with stop tags present."""
    reads = _random_reads(150, 100, seed=61, coverage_pool=_pool(67))
    _force(monkeypatch, "host")
    g = Nodegraph(15, 2e4, 4)
    for r in reads:
        g.consume(r.cleaned_seq)
    hashes = sorted({int(h) for r in reads[:5]
                     for h in g._hashes_for_sequence(r.cleaned_seq)})
    g.stop_tags.update(hashes[::7])

    from khmer_tpu.core import traversal as T

    for start in hashes[1::11][:8]:
        for kwargs in ({"radius": 3}, {"radius": 10},
                       {"radius": 40, "max_count": 25},
                       {"radius": 1000}):
            _force(monkeypatch, "host")
            kh = set()
            ch = T.traverse_from_kmer(g, start, keeper=kh, **kwargs)
            _force(monkeypatch, "device")
            kd = set()
            cd = T.traverse_from_kmer(g, start, keeper=kd, **kwargs)
            assert (ch, kh) == (cd, kd), (start, kwargs)
        _force(monkeypatch, "host")
        sh = T.calc_connected_graph_size(g, start, max_size=30)
        _force(monkeypatch, "device")
        sd = T.calc_connected_graph_size(g, start, max_size=30)
        assert sh == sd


def test_labeled_consume_engines_match(monkeypatch):
    """Per-read native labeled consume == Python engine: tag sets,
    tag->label maps, n_consumed, tables."""
    from khmer_tpu import GraphLabels, Nodegraph

    reads = _random_reads(250, 95, seed=71, coverage_pool=_pool(73))

    def run(engine):
        _force(monkeypatch, engine)
        g = Nodegraph(17, 3e4, 4)
        lh = GraphLabels(g)
        tr, nc = lh.consume_seqfile_and_tag_with_labels(list(reads))
        return (tr, nc, sorted(g.all_tags),
                {t: sorted(v) for t, v in lh.tag_labels.items()},
                g.n_unique_kmers(),
                [np.array(t) for t in g.host_view()])

    host = run("host")
    dev = run("device")
    assert host[:5] == dev[:5]
    for a, b in zip(host[5], dev[5]):
        assert np.array_equal(a, b)


def test_sweep_for_tags_engines_match(monkeypatch):
    """hg_sweep_for_tags == the Python sweep across ranges/flags."""
    from khmer_tpu.core.partition import sweep_for_tags

    reads = _random_reads(200, 110, seed=81, coverage_pool=_pool(83))
    _force(monkeypatch, "host")
    g = Nodegraph(15, 2e4, 4)
    g.consume_seqfile_and_tag(list(reads))
    some = sorted(g.all_tags)
    g.stop_tags.update(some[::9])

    queries = [r.cleaned_seq for r in reads[:12]]
    queries.append(reads[0].cleaned_seq[:40])
    for q in queries:
        for rng_ in (0, 2, 10, 40):
            for stop in (False, True):
                for big in (False, True):
                    _force(monkeypatch, "host")
                    th = sweep_for_tags(g, q, range=rng_,
                                        break_on_stop_tags=stop,
                                        stop_big_traversals=big)
                    _force(monkeypatch, "device")
                    td = sweep_for_tags(g, q, range=rng_,
                                        break_on_stop_tags=stop,
                                        stop_big_traversals=big)
                    assert th == td, (q[:20], rng_, stop, big)


def test_abundance_distribution_engines_match(monkeypatch):
    from khmer_tpu import Countgraph, Nodegraph
    from khmer_tpu.core import pipeline

    reads = _random_reads(300, 90, seed=91, coverage_pool=_pool(93))

    def run(engine):
        _force(monkeypatch, engine)
        g = Countgraph(17, 3e4, 4)
        for r in reads:
            g.consume(r.cleaned_seq)
        tracking = Nodegraph(17, 3e4, 4)
        return pipeline.abundance_distribution(g, list(reads), tracking)

    host = run("host")
    dev = run("device")
    assert host == dev
    assert sum(host) > 0
