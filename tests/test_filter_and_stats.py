"""filter-abund / filter-abund-single / count-median / unique-kmers /
abundance-dist-single CLI tests; oracles from the reference suite."""

import os

from khmer_tpu.io.fastx import FastxParser

from .script_utils import copy_test_data, runscript


def _make_counting(infilename, tmpdir, SIZE=1e7, N=2, K=20, BIGCOUNT=True):
    args = ['-x', str(SIZE), '-N', str(N), '-k', str(K)]
    if not BIGCOUNT:
        args.append('-b')
    outfile = os.path.join(str(tmpdir), 'out.ct')
    args.extend([outfile, infilename])
    runscript('load-into-counting.py', args)
    return outfile


def test_filter_abund_1(tmp_path):
    # reference tests/test_filter_abund.py:42-66
    infile = copy_test_data('test-abund-read-2.fa', tmp_path)
    counting_ht = _make_counting(infile, tmp_path, K=17)
    args = [counting_ht, infile]
    runscript('filter-abund.py', args, in_directory=str(tmp_path))
    outfile = infile + '.abundfilt'
    assert os.path.exists(outfile), outfile
    seqs = set(r.sequence for r in FastxParser(outfile))
    assert len(seqs) == 1, seqs
    assert 'GGTTGACGGGGCTCAGGG' in seqs


def test_filter_abund_2(tmp_path):
    infile = copy_test_data('test-abund-read-2.fa', tmp_path)
    counting_ht = _make_counting(infile, tmp_path, K=17)
    args = ['-C', '1', counting_ht, infile, infile]
    runscript('filter-abund.py', args, in_directory=str(tmp_path))
    outfile = infile + '.abundfilt'
    seqs = set(r.sequence for r in FastxParser(outfile))
    assert len(seqs) == 2, seqs
    assert 'GGTTGACGGGGCTCAGGG' in seqs


def test_filter_abund_2_stdin(tmp_path):
    infile = copy_test_data('test-abund-read-2.fa', tmp_path)
    counting_ht = _make_counting(infile, tmp_path, K=17)
    args = ['-C', '1', counting_ht, '-']
    (status, out, err) = runscript('filter-abund.py', args,
                                   in_directory=str(tmp_path),
                                   fail_ok=True)
    assert status == 1
    assert ("Accepting input from stdin; output filename must be provided"
            in str(err))


def test_filter_abund_single_1(tmp_path):
    infile = copy_test_data('test-abund-read-2.fa', tmp_path)
    args = ['-x', '1e7', '-N', '2', '-k', '17', infile]
    runscript('filter-abund-single.py', args,
              in_directory=str(tmp_path))
    outfile = infile + '.abundfilt'
    assert os.path.exists(outfile), outfile
    seqs = set(r.sequence for r in FastxParser(outfile))
    assert len(seqs) == 1, seqs
    assert 'GGTTGACGGGGCTCAGGG' in seqs


def test_count_median(tmp_path):
    # reference tests/test_scripts.py:465-481 — float32-exact stats
    infile = copy_test_data('test-abund-read-2.fa', tmp_path)
    outfile = infile + '.counts'
    counting_ht = _make_counting(infile, tmp_path, K=8)
    args = [counting_ht, infile, outfile]
    runscript('count-median.py', args)
    assert os.path.exists(outfile), outfile
    data = [x.strip() for x in open(outfile).readlines()[1:]]
    data = set(data)
    assert len(data) == 2, data
    assert 'seq,1001,1001.0,0.0,18' in data, data
    assert '895:1:37:17593:9954/1,1,103.803741455,303.702941895,114' in \
        data, data


def test_unique_kmers_defaults(tmp_path):
    # reference tests/test_scripts.py:2805-2816
    infile = copy_test_data('random-20-a.fa', tmp_path)
    args = ['-k', '20', '-e', '0.01', infile]
    _, out, err = runscript('unique-kmers.py', args,
                            in_directory=str(tmp_path))
    err = err.splitlines()
    assert ('Estimated number of unique 20-mers in {0}: 3950'.format(
        infile) in err), err
    assert 'Total estimated number of unique 20-mers: 3950' in err


def test_unique_kmers_report_fp(tmp_path):
    infile = copy_test_data('random-20-a.fa', tmp_path)
    outfile = str(tmp_path / 'report.unique')
    args = ['-k', '20', '-e', '0.01', '-R', outfile, infile]
    _, out, err = runscript('unique-kmers.py', args,
                            in_directory=str(tmp_path))
    with open(outfile) as report_fp:
        outf = report_fp.read().splitlines()
        assert '3950 20 (total)' in outf
        assert '3950 20 total' in outf


def test_abundance_dist_single(tmp_path):
    # reference: test_abundance_dist_single (same histogram as two-stage)
    infile = copy_test_data('test-abund-read-2.fa', tmp_path)
    outfile = str(tmp_path / 'test.dist')
    args = ['-x', '1e7', '-N', '2', '-k', '17', '-z', '-t', infile,
            outfile]
    # reference passes -t/--threads; ours accepts -T
    args = ['-x', '1e7', '-N', '2', '-k', '17', '-z', infile, outfile]
    runscript('abundance-dist-single.py', args,
              in_directory=str(tmp_path))
    with open(outfile) as fp:
        fp.readline()
        line = fp.readline().strip()
        assert line == '1,96,96,0.98', line
        line = fp.readline().strip()
        assert line == '1001,2,98,1.0', line


def test_profiler_trace_hook(tmp_path, monkeypatch):
    """KHMER_TPU_TRACE captures a JAX profiler trace around consume
    (SURVEY §5.1: the framework's tracing aux subsystem)."""
    import os

    from khmer_tpu import Counttable
    from tests.conftest import reference_file

    logdir = str(tmp_path / "trace")
    monkeypatch.setenv("KHMER_TPU_TRACE", logdir)
    ct = Counttable(20, 1e5, 2)
    ct.consume_seqfile(reference_file("random-20-a.fa"))
    assert ct.n_unique_kmers() > 0
    # a plugins/profile/<run>/ dir with a .trace.json.gz or .xplane.pb
    found = []
    for root, _dirs, files in os.walk(logdir):
        found.extend(files)
    assert found, "no trace artifacts written"


def test_profiler_annotate_and_memstats():
    from khmer_tpu.utils import profiling

    with profiling.annotate("unit-test-region"):
        pass
    stats = profiling.device_memory_stats()
    assert isinstance(stats, dict)
