#! /usr/bin/env python
"""Find nullomers: K-mers absent from a set of contigs.

Reference example: examples/python-nullomers/find-nullomers.py (uses
exact counting with the reversible 2-bit hash, whose range is exactly
4**K). Batched difference: instead of a Python loop calling
``ct.get(i)`` 4**K times, the whole hash range is counted with ONE
batched device gather per chunk — the enumeration runs at device
gather speed.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))

import numpy as np

from khmer_tpu import Countgraph
from khmer_tpu.ops import hashing as H

K = 11
SIZE = 4 ** K                 # important: use exact counting


def main():
    p = argparse.ArgumentParser()
    p.add_argument('contigs', nargs='+')
    p.add_argument('--all', action='store_true',
                   help='print every k-mer with its count, not just '
                        'nullomers')
    args = p.parse_args()

    assert K % 2 == 1, "K must be odd"

    print('allocating lots of memory for exact counts: {} bytes'
          .format(SIZE))
    # Countgraph: the reversible 2-bit hash covers exactly 4**K bins
    ct = Countgraph(K, SIZE, 1)

    for filename in args.contigs:
        print('consuming {}'.format(filename))
        ct.consume_seqfile(filename)
    print('...done!')

    print('Scanning all {}-mers in device batches'.format(K))
    CHUNK = 1 << 20
    n_null = 0
    for start in range(0, SIZE, CHUNK):
        hashes = np.arange(start, min(start + CHUNK, SIZE),
                           dtype=np.uint64)
        counts = ct.get_counts_for_hashes(hashes)
        if args.all:
            for h, c in zip(hashes, counts):
                print(H.reverse_hash(int(h), K), int(c))
        else:
            for h in hashes[counts == 0]:
                # canonical bins only: skip the revcomp duplicate
                s = H.reverse_hash(int(h), K)
                if int(h) == min(int(h),
                                 H.forward_hash(H.reverse_complement(s),
                                                K)):
                    print(s)
                    n_null += 1
    if not args.all:
        print('found {} nullomers'.format(n_null), file=sys.stderr)


if __name__ == '__main__':
    main()
