#!/usr/bin/env python
"""The blocked Count-Min layout — khmer_tpu extension.

All four of a k-mer's counters live inside one 128-byte block, so a
batch update costs one row-scatter + one row-gather instead of eight
element ops (see khmer_tpu/core/blocked.py). Counts are NOT
bit-compatible with
khmer's (a blocked sketch has its own collision profile).

Usage: blocked.py <reads.fa/fq[.gz]>
"""

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

from khmer_tpu import BlockedCounttable, Counttable

ksize = 21
target_table_size = 5e7
num_tables = 4

blocked = BlockedCounttable(ksize, target_table_size, num_tables)
nseqs, nkmers = blocked.consume_seqfile(sys.argv[1])
print('blocked sketch: %d sequences, %d k-mers, %d unique'
      % (nseqs, nkmers, blocked.n_unique_kmers()))

exact = Counttable(ksize, target_table_size, num_tables)
exact.consume_seqfile(sys.argv[1])
print('exact khmer-layout sketch: %d unique' % exact.n_unique_kmers())
