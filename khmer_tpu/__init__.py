"""khmer_tpu — an accelerator k-mer counting and de Bruijn graph engine.

A from-scratch JAX/XLA re-design of the capabilities of khmer
(github.com/dib-lab/khmer): streaming k-mer counting into Bloom-filter
(Nodegraph) and Count-Min (Countgraph) sketches held in device memory and
sharded by hash range across a device mesh, plus the algorithms built on top
(digital normalization, abundance trimming, HyperLogLog cardinality, and
tag-based de Bruijn graph partitioning).

Outputs are bit/record-compatible with khmer's OXLI v4 binary formats and
its reference CLI scripts.
"""

import os as _os

import jax

# The whole engine is built on native 64-bit hashes (HashIntoType=uint64 in
# the reference, include/oxli/oxli.hh:115), so integer x64 mode is on.
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: JAX itself honours JAX_COMPILATION_CACHE_DIR;
# without it the cache lives at a fixed path inside the checkout, so a
# later process (or run) finds the same entries again.
if not jax.config.jax_compilation_cache_dir:
    jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))

__version__ = "0.1.0"

from khmer_tpu.core.sketch import (  # noqa: E402
    Countgraph,
    Counttable,
    CyclicCounttable,
    Nodegraph,
    Nodetable,
    QFCounttable,
    SmallCountgraph,
    SmallCounttable,
)
from khmer_tpu.core.blocked import (  # noqa: E402
    BlockedCountgraph,
    BlockedCounttable,
)
from khmer_tpu.core.hll import HLLCounter  # noqa: E402
from khmer_tpu.core.labels import GraphLabels  # noqa: E402
from khmer_tpu.core.aligner import ReadAligner  # noqa: E402
from khmer_tpu.core.assembly import (  # noqa: E402
    JunctionCountAssembler,
    LinearAssembler,
    SimpleLabeledAssembler,
)
from khmer_tpu.core.oxli_io import (  # noqa: E402
    extract_countgraph_info,
    extract_nodegraph_info,
    load_countgraph,
    load_nodegraph,
)
from khmer_tpu.ops.hashing import (  # noqa: E402
    forward_hash,
    forward_hash_no_rc,
    hash_murmur3,
    hash_no_rc_murmur3,
    reverse_complement,
    reverse_hash,
)
from khmer_tpu.core.sketch_kernels import (  # noqa: E402
    get_n_primes_near_x,
)
from khmer_tpu.io.fastx import ReadParser  # noqa: E402


# NOTE: nothing here touches jax.devices(): that would initialise the
# backends at import and freeze the CPU device count
# (jax_num_cpu_devices) before a test session or a dry run can set it.

# Memory-per-bucket ratios per graph type (reference: khmer/__init__.py:86-92)
_buckets_per_byte = {
    # calculated by hand from settings in third-party/cqf/gqf.h
    "qfcounttable": 1 / 1.26,
    "countgraph": 1,
    "smallcountgraph": 2,
    "nodegraph": 8,
}


def calc_expected_collisions(graph, force=False, max_false_pos=0.2):
    """FP-rate guard mirroring reference khmer/__init__.py:181-215."""
    import math
    import sys

    sizes = graph.hashsizes()
    n_ht = float(len(sizes))
    occupancy = float(graph.n_occupied())
    min_size = min(sizes)

    fp_one = occupancy / float(min_size)
    fp_all = fp_one ** n_ht

    if fp_all > max_false_pos:
        print("**", file=sys.stderr)
        print(
            "** ERROR: the graph structure is too small for this data set."
            "Increase data structure size with --max_memory_usage/-M.",
            file=sys.stderr,
        )
        print("** Do not use these results!!", file=sys.stderr)
        print("**", file=sys.stderr)
        print("** (estimated false positive rate of %.3f;" % fp_all,
              file=sys.stderr, end=' ')
        print("max recommended %.3f)" % max_false_pos, file=sys.stderr)
        print("**", file=sys.stderr)

        if not force:
            sys.exit(1)

    return fp_all


__all__ = [
    "BlockedCountgraph",
    "BlockedCounttable",
    "Countgraph",
    "Counttable",
    "CyclicCounttable",
    "HLLCounter",
    "Nodegraph",
    "Nodetable",
    "QFCounttable",
    "SmallCountgraph",
    "SmallCounttable",
    "calc_expected_collisions",
    "extract_countgraph_info",
    "extract_nodegraph_info",
    "forward_hash",
    "forward_hash_no_rc",
    "hash_murmur3",
    "hash_no_rc_murmur3",
    "get_n_primes_near_x",
    "load_countgraph",
    "load_nodegraph",
    "reverse_complement",
    "reverse_hash",
]
