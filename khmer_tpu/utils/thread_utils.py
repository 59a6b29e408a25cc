"""Batched read filtering with a host writer.

Batched replacement for the reference's thread-pool read filter
(khmer/thread_utils.py:73-160, `ThreadedSequenceProcessor`): there the
parallelism was N Python threads each applying `process_fn` to groups
of reads, with a writer thread draining an output queue. Here the
expensive per-read work (k-mer counting / trimming) is already batched
onto the device by the callers, so the processor is a deterministic
grouped map — same API (`process_fn(record) -> (name, seq)`), same
progress reporting, but output order is stable (the reference's
threaded version interleaves nondeterministically).
"""

import sys

from khmer_tpu.io.fastx import ReadParser, Record, write_record
from khmer_tpu.utils.logger import log_info

DEFAULT_WORKER_THREADS = 8
DEFAULT_GROUPSIZE = 100


def verbose_loader(filename):
    """Read iterator that additionally prints progress info to stderr.

    Reference: khmer/thread_utils.py:54-59.
    """
    for num, record in enumerate(ReadParser(filename)):
        if num % 100000 == 0:
            log_info('... filtering {num}', num=num)
        yield record


verbose_fasta_iter = verbose_loader


class ThreadedSequenceProcessor(object):
    """API-compatible grouped sequence filter (reference
    khmer/thread_utils.py:73-241). `n_workers` is accepted for
    signature parity; batching happens on-device in process_fn's
    closure, so host threads are not used.
    """

    def __init__(self, process_fn, n_workers=DEFAULT_WORKER_THREADS,
                 group_size=DEFAULT_GROUPSIZE, verbose=True):
        self.process_fn = process_fn
        self.n_workers = n_workers
        self.group_size = group_size
        self.verbose = verbose

        self.n_processed = 0
        self.n_written = 0
        self.bp_processed = 0
        self.bp_written = 0

    def start(self, inputiter, outfp):
        if self.verbose:
            print('starting threads', file=sys.stderr)
            print('starting writer', file=sys.stderr)
            print('loading...', file=sys.stderr)

        for record in inputiter:
            name, sequence = self.process_fn(record)
            self.n_processed += 1
            self.bp_processed += len(record.sequence)

            if name:
                quality = getattr(record, 'quality', None)
                if quality:
                    quality = quality[:len(sequence)]
                    out = Record(name=name, sequence=sequence,
                                 quality=quality)
                else:
                    out = Record(name=name, sequence=sequence)
                self.n_written += 1
                self.bp_written += len(sequence)
                write_record(out, outfp)

            if self.verbose and self.n_processed % 500000 == 0:
                self._report()

        if self.verbose:
            print("DONE writing.", file=sys.stderr, end='\n')
            self._report()

    def _report(self):
        print("processed %d / wrote %d / removed %d" %
              (self.n_processed, self.n_written,
               self.n_processed - self.n_written), file=sys.stderr)
        print("processed %d bp / wrote %d bp / removed %d bp" %
              (self.bp_processed, self.bp_written,
               self.bp_processed - self.bp_written), file=sys.stderr)
        if self.bp_processed:
            discarded = self.bp_processed - self.bp_written
            percent = float(discarded) / float(self.bp_processed) * 100
            print("discarded %.1f%%" % percent, file=sys.stderr)
