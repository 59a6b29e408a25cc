#!/usr/bin/env python
"""Do digital normalization (remove mostly redundant sequences).

Mirrors the reference scripts/normalize-by-median.py exactly (same
flags, same .keep outputs).  The sequential keep/discard loop runs on
the native host tier (core/hostengine.py) when built, else the
device-scan engine (core/diginorm_scan.py).  -R report rows carry the
same (total, kept) values as the reference — accounting is per bundle
— but rows are emitted when a window flushes, so they can appear up to
one window later in wall-clock time than the reference's.

% normalize-by-median.py [ -C <cutoff> ] <data1> <data2> ...
"""

import argparse
import os
import sys
import textwrap
from contextlib import contextmanager

import khmer_tpu
from khmer_tpu import calc_expected_collisions, load_countgraph
from khmer_tpu.cli import args as khmer_args
from khmer_tpu.cli.args import (FileType as khFileType, add_loadgraph_args,
                                build_counting_args, calculate_graphsize,
                                check_argument_range, report_on_config,
                                sanitize_help)
from khmer_tpu.core.diginorm_scan import ScanNormalizer
from khmer_tpu.io.fastx import FastxParser, write_record
from khmer_tpu.io.pairing import broken_paired_reader, clean_input_reads
from khmer_tpu.utils.kfile import (add_output_compression_type, check_space,
                                   check_space_for_graph,
                                   check_valid_file_exists,
                                   describe_file_handle, get_file_writer)
from khmer_tpu.utils.logger import configure_logging, log_error, log_info

DEFAULT_DESIRED_COVERAGE = 20
# reads per device dispatch: larger windows amortize the host<->device
# round-trip (the keep set is identical at every size; the best size on
# the GPU is not measured yet)
WINDOW = int(os.environ.get("KHMER_TPU_DIGINORM_WINDOW", 16384))


class WithDiagnostics:
    """Boilerplate reporting of total/kept statistics
    (reference :72-152)."""

    def __init__(self, report_fp=None, report_frequency=100000):
        self.report_fp = report_fp
        if report_fp:
            report_fp.write('total,kept,f_kept\n')
        self.total = 0
        self.kept = 0
        self.report_frequency = report_frequency
        self.next_report_at = report_frequency
        self.last_report_at = report_frequency

    def account(self, n_reads_in_bundle, n_kept, ifilename):
        self.total += n_reads_in_bundle
        self.kept += n_kept
        if self.total >= self.next_report_at:
            self.next_report_at += self.report_frequency
            self.last_report_at = self.total
            perc_kept = self.kept / float(self.total)
            log_info('... kept {kept} of {tot} or {perc_kept:.1%} so'
                     'far', kept=self.kept, tot=self.total,
                     perc_kept=perc_kept)
            log_info('... in file {name}', name=ifilename)
            if self.report_fp:
                print("{total},{kept},{f_kept:.4}".format(
                    total=self.total, f_kept=perc_kept, kept=self.kept),
                    file=self.report_fp)
                self.report_fp.flush()

    def finish_file(self, ifilename, reads_start):
        if self.total == reads_start:
            log_info('SKIPPED empty file {name}', name=ifilename)
        else:
            perc_kept = self.kept / float(self.total)
            log_info('DONE with {inp}; kept {kept} of {total} or '
                     '{perc_kept:.1%}', inp=ifilename, kept=self.kept,
                     total=self.total, perc_kept=perc_kept)
        if self.report_fp and self.total != self.last_report_at:
            perc_kept = self.kept / float(self.total)
            print("{total},{kept},{f_kept:.4}".format(
                total=self.total, f_kept=perc_kept, kept=self.kept),
                file=self.report_fp)
            self.report_fp.flush()


@contextmanager
def catch_io_errors(ifile, out, single_out, force, corrupt_files):
    """reference :182-198."""
    try:
        yield
    except (IOError, OSError, ValueError) as error:
        log_error('** ERROR: {error}', error=str(error))
        log_error('** Failed on {name}: ', name=ifile)
        if not single_out:
            os.remove(out.name)
        if not force:
            log_error('** Exiting!')
            sys.exit(1)
        else:
            log_error('*** Skipping error file, moving on...')
            corrupt_files.append(ifile)


def get_parser():
    epilog = """\
    Discard sequences based on whether or not their median k-mer abundance
    lies above a specified cutoff. Kept sequences will be placed in
    <fileN>.keep.

    Example::

        normalize-by-median.py -k 17 tests/test-data/test-abund-read-2.fa
    """
    parser = build_counting_args(
        descr="Do digital normalization (remove mostly redundant "
        "sequences)", epilog=textwrap.dedent(epilog),
        citations=['diginorm'])
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    parser.add_argument('-C', '--cutoff', help="when the median "
                        "k-mer coverage level is above this number the "
                        "read is not kept.",
                        type=check_argument_range(0, 256, "cutoff"),
                        default=DEFAULT_DESIRED_COVERAGE)
    parser.add_argument('-p', '--paired', action='store_true',
                        help='require that all sequences be properly '
                        'paired')
    parser.add_argument('--force_single', dest='force_single',
                        action='store_true',
                        help='treat all sequences as single-ended/unpaired')
    parser.add_argument('-u', '--unpaired-reads',
                        metavar="unpaired_reads_filename",
                        help='include a file of unpaired reads to which '
                        '-p/--paired does not apply.')
    parser.add_argument('-s', '--savegraph', metavar="filename",
                        default=None,
                        help='save the k-mer countgraph to disk after all '
                        'reads are loaded.')
    parser.add_argument('-R', '--report',
                        help='write progress report to report_filename',
                        metavar='report_filename',
                        type=argparse.FileType('w'))
    parser.add_argument('--report-frequency',
                        metavar='report_frequency', type=int,
                        default=100000,
                        help='report progress every report_frequency reads')
    parser.add_argument('-f', '--force', dest='force',
                        help='continue past file reading errors',
                        action='store_true')
    parser.add_argument('-o', '--output', metavar="filename",
                        type=khFileType('wb'),
                        default=None, dest='single_output_file',
                        help='only output a single file with '
                        'the specified filename; use a single dash "-" to '
                        'specify that output should go to STDOUT (the '
                        'terminal)')
    parser.add_argument('input_filenames',
                        metavar='input_sequence_filename',
                        help='Input FAST[AQ] sequence filename.',
                        nargs='+')
    add_loadgraph_args(parser)
    add_output_compression_type(parser)
    return parser


def main():  # pylint: disable=too-many-branches,too-many-statements
    parser = sanitize_help(get_parser())
    args = parser.parse_args()

    configure_logging(args.quiet)
    report_on_config(args)

    report_fp = args.report
    force_single = args.force_single

    filenames = []
    basenames = []
    for pathfilename in args.input_filenames:
        filenames.append(pathfilename)
        if args.single_output_file:
            continue
        basename = os.path.basename(pathfilename)
        if basename in basenames:
            log_error('ERROR: Duplicate filename--Cannot handle this!')
            log_error('** Exiting!')
            sys.exit(1)
        basenames.append(basename)

    check_valid_file_exists(args.input_filenames)
    check_space(args.input_filenames, args.force)
    if args.savegraph is not None:
        graphsize = calculate_graphsize(args, 'countgraph')
        check_space_for_graph(args.savegraph, graphsize, args.force)

    if args.loadgraph:
        log_info('loading k-mer countgraph from {graph}',
                 graph=args.loadgraph)
        countgraph = load_countgraph(args.loadgraph)
    else:
        log_info('making countgraph')
        countgraph = khmer_args.create_countgraph(args)

    from khmer_tpu.core import hostengine

    if (hostengine.use_host_for(countgraph, "diginorm")
            and not countgraph._use_bigcount and args.cutoff <= 255):
        # latency tier: the sequential keep/consume loop runs in one
        # native pass per window (see doc/gpu.md "dual-engine runtime")
        norm = hostengine.NativeNormalizer(countgraph, args.cutoff)
    elif countgraph.storage_kind == "byte":
        norm = ScanNormalizer(countgraph, args.cutoff, window=WINDOW)
    else:
        from khmer_tpu.core.diginorm import BatchedNormalizer

        norm = BatchedNormalizer(countgraph, args.cutoff, window=512)
    diag = WithDiagnostics(report_fp, args.report_frequency)

    files = []
    for element in filenames:
        files.append([element, args.paired])
    if args.unpaired_reads:
        files.append([args.unpaired_reads, False])

    corrupt_files = []
    outfp = None
    output_name = None

    if args.single_output_file:
        outfp = get_file_writer(args.single_output_file, args.gzip,
                                args.bzip)
    else:
        if '-' in filenames or '/dev/stdin' in filenames:
            print("Accepting input from stdin; output filename must "
                  "be provided with '-o'.", file=sys.stderr)
            sys.exit(1)

    for filename, require_paired in files:
        if not args.single_output_file:
            output_name = os.path.basename(filename) + '.keep'
            outfp = open(output_name, 'wb')
            outfp = get_file_writer(outfp, args.gzip, args.bzip)

        reads_start = diag.total
        with catch_io_errors(filename, outfp, args.single_output_file,
                             args.force, corrupt_files):
            screed_iter = clean_input_reads(FastxParser(filename))
            reader = broken_paired_reader(screed_iter,
                                          min_length=args.ksize,
                                          force_single=force_single,
                                          require_paired=require_paired)

            window = []
            for _, is_paired, read0, read1 in reader:
                bundle = [r for r in (read0, read1) if r]
                window.append(bundle)
                if len(window) >= WINDOW:
                    _flush(norm, diag, window, outfp, filename)
                    window = []
            if window:
                _flush(norm, diag, window, outfp, filename)

            log_info('output in {name}',
                     name=describe_file_handle(outfp))
            if not args.single_output_file:
                outfp.close()
        diag.finish_file(filename, reads_start)

    norm.finalize()
    log_info('Total number of unique k-mers: {umers}',
             umers=countgraph.n_unique_kmers())

    if args.savegraph is not None:
        log_info('...saving to {name}', name=args.savegraph)
        countgraph.save(args.savegraph)

    fp_rate = calc_expected_collisions(countgraph, False,
                                       max_false_pos=.8)
    # for max_false_pos see Zhang et al., http://arxiv.org/abs/1309.2975

    log_info('fp rate estimated to be {fpr:1.3f}', fpr=fp_rate)

    if args.force and len(corrupt_files) > 0:
        log_error("** WARNING: Finished with errors!")
        log_error("** I/O Errors occurred in the following files:")
        log_error("\t" + " ".join(corrupt_files))


def _flush(norm, diag, window, outfp, filename):
    kept_lists = norm.process_window(window)
    for bundle, kept in zip(window, kept_lists):
        for record in kept:
            write_record(record, outfp)
        diag.account(len(bundle), len(kept), filename)


if __name__ == '__main__':
    main()
