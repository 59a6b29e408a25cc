"""Shell-level stdin/stdout streaming tests.

The reference validates every streaming-capable script through real
shell pipes (tests/test_streaming_io.py:82-189). These run the CLI
launchers as subprocesses with actual pipes on the same golden data.
"""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
DATA = "/root/reference/tests/test-data"


def run_shell(cmd, fail_ok=False):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(["bash", "-ec", cmd], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=540)
    if r.returncode != 0 and not fail_ok:
        raise AssertionError("cmd failed (%d):\n%s\nstderr:\n%s"
                             % (r.returncode, cmd, r.stderr[-2000:]))
    return r.returncode, r.stdout, r.stderr


def test_interleave_split_pipe(tmp_path):
    out1 = tmp_path / "a.fq"
    out2 = tmp_path / "b.fq"
    run_shell(
        "{s}/interleave-reads.py {d}/paired.fq.1 {d}/paired.fq.2 -o - |"
        " {s}/split-paired-reads.py -1 {o1} -2 {o2} -".format(
            s=SCRIPTS, d=DATA, o1=out1, o2=out2))
    assert open(out1).read() == open(
        os.path.join(DATA, "paired.fq.1")).read()
    assert open(out2).read() == open(
        os.path.join(DATA, "paired.fq.2")).read()


def test_split_paired_stdin_requires_outnames():
    status, _, err = run_shell(
        "{s}/interleave-reads.py {d}/paired.fq.1 {d}/paired.fq.2 -o - |"
        " {s}/split-paired-reads.py -".format(s=SCRIPTS, d=DATA),
        fail_ok=True)
    assert status != 0
    assert "Accepting input from stdin; output filenames must be " \
        "provided." in err, err


def test_split_paired_one_output_to_stdout(tmp_path):
    out1 = tmp_path / "a.fq"
    out2 = tmp_path / "b.fq"
    run_shell(
        "{s}/interleave-reads.py {d}/paired.fq.1 {d}/paired.fq.2 -o - |"
        " {s}/split-paired-reads.py -1 - -2 {o2} - > {o1}".format(
            s=SCRIPTS, d=DATA, o1=out1, o2=out2))
    assert open(out1).read() == open(
        os.path.join(DATA, "paired.fq.1")).read()
    assert open(out2).read() == open(
        os.path.join(DATA, "paired.fq.2")).read()


def test_fastq_to_fasta_stdout(tmp_path):
    _, out, _ = run_shell(
        "{s}/fastq-to-fasta.py {d}/test-fastq-reads.fq".format(
            s=SCRIPTS, d=DATA))
    assert out.count(">") == 100


def test_normalize_stdin_requires_outname():
    status, _, err = run_shell(
        "cat {d}/test-abund-read-2.fa | {s}/normalize-by-median.py "
        "-k 17 -x 1e7 -".format(s=SCRIPTS, d=DATA), fail_ok=True)
    assert status != 0
    assert "output filename must" in err, err


def test_normalize_pipe_to_stdout(tmp_path):
    out = tmp_path / "keep.fa"
    run_shell(
        "cat {d}/test-abund-read-2.fa | {s}/normalize-by-median.py "
        "-C 1 -k 17 -x 1e7 -o - - > {o}".format(s=SCRIPTS, d=DATA,
                                                o=out))
    body = open(out).read()
    assert body.count(">") == 1, body[:200]


def test_load_into_counting_from_pipe(tmp_path):
    ct = tmp_path / "out.ct"
    _, _, err = run_shell(
        "cat {d}/test-abund-read-2.fa | {s}/load-into-counting.py "
        "-x 1e7 -N 2 -k 20 {ct} -".format(s=SCRIPTS, d=DATA, ct=ct))
    assert "Total number of unique k-mers: 95" in err, err
    assert os.path.exists(ct)


def test_trim_low_abund_pipe_out(tmp_path):
    out = tmp_path / "trimmed.fa"
    run_shell(
        "{s}/trim-low-abund.py -k 17 -x 1e7 -N 2 -o - "
        "{d}/test-abund-read-2.fa > {o}".format(s=SCRIPTS, d=DATA,
                                                o=out))
    assert open(out).read().count(">") > 0


def test_filter_abund_pipe_out(tmp_path):
    ct = tmp_path / "g.ct"
    out = tmp_path / "filt.fa"
    run_shell(
        "{s}/load-into-counting.py -x 1e7 -k 17 {ct} "
        "{d}/test-abund-read-2.fa".format(s=SCRIPTS, d=DATA, ct=ct))
    run_shell(
        "{s}/filter-abund.py -o - {ct} {d}/test-abund-read-2.fa "
        "> {o}".format(s=SCRIPTS, d=DATA, ct=ct, o=out))
    body = open(out).read()
    # every read trims down to the single high-abundance 18-mer region
    assert body.count(">") == 1001
    seqs = {ln for ln in body.splitlines() if not ln.startswith(">")}
    assert seqs == {"GGTTGACGGGGCTCAGGG"}


def test_extract_paired_reads_pipe(tmp_path):
    pe = tmp_path / "out.pe"
    se = tmp_path / "out.se"
    run_shell(
        "cat {d}/paired-mixed.fa | {s}/extract-paired-reads.py "
        "-p {pe} -s {se} -".format(s=SCRIPTS, d=DATA, pe=pe, se=se))
    assert os.path.exists(pe) and os.path.exists(se)


def test_interleave_gzip_roundtrip(tmp_path):
    inter = tmp_path / "inter.fq.gz"
    out1 = tmp_path / "a.fq"
    out2 = tmp_path / "b.fq"
    run_shell(
        "{s}/interleave-reads.py {d}/paired.fq.1 {d}/paired.fq.2 "
        "--gzip -o {i}".format(s=SCRIPTS, d=DATA, i=inter))
    run_shell(
        "zcat {i} | {s}/split-paired-reads.py -1 {o1} -2 {o2} -".format(
            s=SCRIPTS, i=inter, o1=out1, o2=out2))
    assert open(out1).read() == open(
        os.path.join(DATA, "paired.fq.1")).read()


def test_unique_kmers_stdin():
    _, _, err = run_shell(
        "cat {d}/test-abund-read-2.fa | {s}/unique-kmers.py -k 20 "
        "-e 0.01 -".format(s=SCRIPTS, d=DATA))
    # HLL estimate for the file's 95 true uniques at e=0.01
    assert "unique 20-mers: 94" in err, err
