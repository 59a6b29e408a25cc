#!/usr/bin/env python
"""khmer_tpu — GPU k-mer counting and de Bruijn graph engine."""

import subprocess
import sys

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py

SCRIPTS = {
    "load-into-counting.py": "khmer_tpu.cli.load_into_counting:main",
    "load-graph.py": "khmer_tpu.cli.load_graph:main",
    "normalize-by-median.py": "khmer_tpu.cli.normalize_by_median:main",
    "trim-low-abund.py": "khmer_tpu.cli.trim_low_abund:main",
    "filter-abund.py": "khmer_tpu.cli.filter_abund:main",
    "filter-abund-single.py": "khmer_tpu.cli.filter_abund_single:main",
    "abundance-dist.py": "khmer_tpu.cli.abundance_dist:main",
    "abundance-dist-single.py":
        "khmer_tpu.cli.abundance_dist_single:main",
    "count-median.py": "khmer_tpu.cli.count_median:main",
    "unique-kmers.py": "khmer_tpu.cli.unique_kmers:main",
    "do-partition.py": "khmer_tpu.cli.do_partition:main",
    "partition-graph.py": "khmer_tpu.cli.partition_graph:main",
    "merge-partitions.py": "khmer_tpu.cli.merge_partitions:main",
    "annotate-partitions.py": "khmer_tpu.cli.annotate_partitions:main",
    "extract-partitions.py": "khmer_tpu.cli.extract_partitions:main",
    "make-initial-stoptags.py":
        "khmer_tpu.cli.make_initial_stoptags:main",
    "find-knots.py": "khmer_tpu.cli.find_knots:main",
    "filter-stoptags.py": "khmer_tpu.cli.filter_stoptags:main",
    "extract-paired-reads.py":
        "khmer_tpu.cli.extract_paired_reads:main",
    "split-paired-reads.py": "khmer_tpu.cli.split_paired_reads:main",
    "interleave-reads.py": "khmer_tpu.cli.interleave_reads:main",
    "extract-long-sequences.py":
        "khmer_tpu.cli.extract_long_sequences:main",
    "fastq-to-fasta.py": "khmer_tpu.cli.fastq_to_fasta:main",
    "sample-reads-randomly.py":
        "khmer_tpu.cli.sample_reads_randomly:main",
    "readstats.py": "khmer_tpu.cli.readstats:main",
}


class BuildNative(Command):
    """Build the native I/O shared library (src/fastx_io.cc)."""

    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        subprocess.run(["make", "-C", "src"], check=True)


class BuildPyWithNative(build_py):
    def run(self):
        try:
            subprocess.run(["make", "-C", "src"], check=False)
        except Exception:
            pass
        super().run()


setup(
    name="khmer_tpu",
    version="0.1.0",
    description="GPU k-mer counting and de Bruijn graph engine "
                "(khmer-compatible)",
    packages=find_packages(exclude=["tests"]),
    package_data={"khmer_tpu.core": ["data/*.npz"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    entry_points={
        "console_scripts":
            ["%s = %s" % (name.replace(".py", ""), target)
             for name, target in SCRIPTS.items()]
            + ["oxli = khmer_tpu.cli.oxli_cmd:main"],
    },
    cmdclass={"build_native": BuildNative,
              "build_py": BuildPyWithNative},
)
