"""User-facing sketch classes mirroring the khmer Python API.

Class map (reference: khmer/_oxli/graphs.pyx:26-28, include/oxli/
hashtable.hh:591-627, hashgraph.hh:273-296):

    Counttable        murmur hash + byte (Count-Min) storage
    SmallCounttable   murmur hash + nibble storage
    Nodetable         murmur hash + bit (Bloom) storage
    CyclicCounttable  cyclic hash + byte storage (host fallback)
    Countgraph        reversible 2-bit hash + byte storage (+graph ops)
    SmallCountgraph   reversible 2-bit hash + nibble storage (+graph ops)
    Nodegraph         reversible 2-bit hash + bit storage (+graph ops)

State lives on device as tuples of uint8 arrays (one per prime-sized
table); updates/queries run through the jitted batch pipelines in
sketch_kernels. A host-side dict holds the rare bigcount overflow map
(reference: storage.hh:513 _bigcounts).
"""

import math

import jax.numpy as jnp
import numpy as np

from khmer_tpu.core import sketch_kernels as K
from khmer_tpu.ops import hashing as H

MAX_KCOUNT = K.MAX_KCOUNT
MAX_BIGCOUNT = K.MAX_BIGCOUNT


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class _Sketch:
    """Base: k-mer hashing + batched sketch updates/queries."""

    storage_kind = None   # "byte" | "nibble" | "bit"
    hash_family = None    # "twobit" | "murmur" | "cyclic"
    supports_bigcount = False

    def __init__(self, ksize, starting_size, n_tables, primes=None):
        if ksize > H.KSIZE_MAX:
            raise ValueError("k-mer size must be <= %d" % H.KSIZE_MAX)
        if ksize < 1:
            raise ValueError("k-mer size must be >= 1")
        self._ksize = int(ksize)
        if primes is None:
            primes = K.get_n_primes_near_x(int(n_tables), int(starting_size))
            if len(primes) != n_tables:
                raise RuntimeError("unable to find enough prime table sizes")
        self._primes = tuple(int(p) for p in primes)
        self._tables_dev = None   # device residency (tuple of jax arrays)
        self._tables_host = None  # host residency (tuple of numpy arrays)
        self._n_unique = jnp.uint64(0)
        self._overflow = jnp.zeros((), bool)
        self._use_bigcount = False
        self._bigcounts = {}

    # -- table residency --------------------------------------------------
    #
    # Tables live on device (tuple of jax arrays, the throughput tier) or
    # on host (tuple of numpy arrays, mutated in place by the native
    # engine in src/hostgraph.cc), or both when in sync.  `tables` always
    # yields the device residency, materializing zeros / uploading the
    # host copy lazily; host_view() yields a read-only host mirror
    # without dropping the device copy; host_tables() yields a writable
    # host copy and makes the host authoritative until the next device
    # access re-uploads.  A sketch driven purely through the native
    # engine never touches the device at all (critical for the
    # latency-bound small-stream paths — see doc/gpu.md).

    @property
    def tables(self):
        if self._tables_dev is None:
            if self._tables_host is not None:
                self._tables_dev = tuple(jnp.asarray(t)
                                         for t in self._tables_host)
            else:
                self._tables_dev = K.init_tables(self.storage_kind,
                                                 self._primes)
        return self._tables_dev

    @tables.setter
    def tables(self, value):
        self._tables_dev = tuple(value)
        self._tables_host = None

    def host_view(self):
        """Read-only numpy mirror of the tables (device copy kept)."""
        if self._tables_host is None:
            if self._tables_dev is not None:
                self._tables_host = tuple(np.array(t)
                                          for t in self._tables_dev)
            else:
                self._tables_host = K.init_host_tables(
                    self.storage_kind, self._primes)
        return self._tables_host

    def host_tables(self):
        """Writable numpy tables; host becomes the authority."""
        tabs = self.host_view()
        self._tables_dev = None
        return tabs

    def tables_resident_on_host(self):
        return self._tables_dev is None and self._tables_host is not None

    # -- introspection ---------------------------------------------------

    def ksize(self):
        return self._ksize

    def hashsizes(self):
        return list(self._primes)

    def n_tables(self):
        return len(self._primes)

    def n_unique_kmers(self):
        K.check_v2_overflow(self._overflow)
        return int(self._n_unique)

    def n_occupied(self):
        """Occupied bins in table 0.

        The reference tracks 0->1 transitions of table 0 only
        (storage.hh:581-589) and *preserves* the loaded header value on
        save even when stale; `_occupied_offset` (set on load) keeps that
        behavior while we recompute transitions from the live table.
        """
        return self._count_nonzero_t0() + getattr(self,
                                                  "_occupied_offset", 0)

    def _count_nonzero_t0(self):
        if self.tables_resident_on_host():
            return K.host_occupied(self.storage_kind,
                                   self._tables_host[0])
        t0 = self.tables[0]
        if self.storage_kind == "byte":
            return int(K.byte_occupied(t0))
        elif self.storage_kind == "nibble":
            return int(K.make_nibble_occupied(self._primes[0])(t0))
        else:
            return int(K.bit_occupied(t0))

    def get_raw_tables(self):
        """Numpy copies of the raw table bytes (read-only use)."""
        return [np.array(t) for t in self.host_view()]

    # -- hashing ---------------------------------------------------------

    def hash(self, kmer):
        """Hash a k-mer string to its canonical 64-bit value."""
        if len(kmer) != self._ksize:
            raise ValueError(
                "Expected k-mer length %d but got %d."
                % (self._ksize, len(kmer)))
        if self.hash_family == "twobit":
            return H._hash_scalar(kmer, self._ksize)[0]
        elif self.hash_family == "murmur":
            return H._hash_murmur_scalar(kmer)[0]
        else:
            raise NotImplementedError(self.hash_family)

    def reverse_hash(self, hashval):
        raise ValueError("reverse_hash not supported by this hash family")

    def _hashes_for_sequence(self, seq):
        """All canonical window hashes of one sequence (numpy uint64)."""
        if len(seq) < self._ksize:
            return np.zeros(0, dtype=np.uint64)
        codes = H.encode_dna(seq)
        return self._hashes_for_codes(codes)

    def _hashes_for_codes(self, codes):
        if self.hash_family == "twobit":
            # zero-dispatch host hash (bit-identical; the jit path
            # below costs a device round trip per sequence)
            return H.host_hash_windows(codes, self._ksize)
        n = len(codes)
        L = max(_round_up(n, 32), self._ksize + 31)
        padded = np.zeros(L, dtype=np.uint8)
        padded[:n] = codes
        hs = np.asarray(
            _hash_padded(self._ksize, self.hash_family, L)(padded))
        return hs[: n - self._ksize + 1]

    # -- counting --------------------------------------------------------

    def _coerce_hashes(self, item):
        """str kmer | int hash | ndarray -> uint64 numpy array."""
        if isinstance(item, str):
            if len(item) != self._ksize:
                raise ValueError(
                    "Expected k-mer length %d but got %d."
                    % (self._ksize, len(item)))
            return np.asarray([self.hash(item)], dtype=np.uint64)
        if isinstance(item, (int, np.integer)):
            return np.asarray([item], dtype=np.uint64)
        return np.asarray(item, dtype=np.uint64)

    def _update_fn(self, with_event_new=False):
        return K.make_update(
            self.storage_kind, self._primes,
            with_bigcount=(self._use_bigcount
                           and self.storage_kind == "byte"),
            with_event_new=with_event_new)

    def _get_fn(self):
        return K.make_get(self.storage_kind, self._primes)

    def _commit_hashes(self, hashes, valid=None):
        """Apply a batch of canonical hashes to the sketch, in order."""
        hashes = np.asarray(hashes, dtype=np.uint64).ravel()
        M0 = hashes.shape[0]
        if M0 == 0:
            return 0
        M = max(_round_up(M0, 256), 256)
        hb = np.zeros(M, dtype=np.uint64)
        hb[:M0] = hashes
        vb = np.zeros(M, dtype=bool)
        vb[:M0] = True if valid is None else np.asarray(valid, bool).ravel()
        self.tables, out = self._update_fn()(
            self.tables, self._n_unique, jnp.asarray(hb), jnp.asarray(vb))
        self._n_unique = out["n_unique"]
        if "v2_overflow" in out:
            self._overflow = jnp.logical_or(self._overflow,
                                            out["v2_overflow"])
        if self._use_bigcount and ("sat_total" in out or "satev_total" in out):
            self._absorb_saturation(out)
        return int(np.sum(vb))

    def _commit_device_hashes(self, hashes_dev, valid_dev):
        """Device-resident batch commit (hot path; no host roundtrip)."""
        self.tables, out = self._update_fn()(
            self.tables, self._n_unique, hashes_dev.ravel(),
            valid_dev.ravel())
        self._n_unique = out["n_unique"]
        if "v2_overflow" in out:
            self._overflow = jnp.logical_or(self._overflow,
                                            out["v2_overflow"])
        if self._use_bigcount and ("sat_total" in out or "satev_total" in out):
            self._absorb_saturation(out)

    def _absorb_saturation(self, out):
        """Fold the batch's saturated-hash report into the bigcount map."""
        if "satev_total" in out:
            self._absorb_saturation_events(out)
            return
        total = int(out["sat_total"])
        if total == 0:
            return
        if total > out["sat_hash"].shape[0]:
            raise RuntimeError(
                "bigcount saturation overflow: %d saturated hashes in one "
                "batch (max %d); use smaller batches" %
                (total, out["sat_hash"].shape[0]))
        sat_hash = np.asarray(out["sat_hash"])
        sat_trig = np.asarray(out["sat_triggers"])
        for h, trig in zip(sat_hash, sat_trig):
            if trig <= 0:
                continue
            self._bigcount_add(int(h), int(trig))

    def _absorb_saturation_events(self, out):
        """Image-path report: per-event saturation candidates.

        Every event of a fully-saturated hash is a candidate, so the
        exact per-hash occurrence count (and pre-batch min) can be
        reconstructed by grouping the compacted events on host.
        """
        total = int(out["satev_total"])
        if total == 0:
            return
        if total > out["satev_hash"].shape[0]:
            # compacted slots overflowed: fetch the full event view
            cand = np.asarray(out["satev_cand_full"])
            hs = np.asarray(out["satev_hash_full"])[cand]
            ms = np.asarray(out["satev_m_full"])[cand]
        else:
            hs = np.asarray(out["satev_hash"])
            ms = np.asarray(out["satev_m"])
        groups = {}
        for h, m in zip(hs, ms):
            if m < 0:
                continue
            h = int(h)
            cnt, _ = groups.get(h, (0, 0))
            groups[h] = (cnt + 1, int(m))
        for h, (cnt, m) in groups.items():
            triggers = cnt - max(0, MAX_KCOUNT - m)
            if triggers > 0:
                self._bigcount_add(h, triggers)

    def _bigcount_add(self, h, triggers):
        b = self._bigcounts.get(h, 0)
        self._bigcounts[h] = min(max(b, MAX_KCOUNT) + triggers,
                                 MAX_BIGCOUNT)

    def count(self, kmer):
        """Increment the count for one k-mer (str or hash)."""
        self._commit_hashes(self._coerce_hashes(kmer))
        return 1

    add = count

    def get(self, kmer):
        """Retrieve the count for one k-mer (str or hash)."""
        hashes = self._coerce_hashes(kmer)
        return int(self.get_counts_for_hashes(hashes)[0])

    def get_counts_for_hashes(self, hashes):
        """Counts (with bigcount fixup) for an array of hashes -> numpy."""
        hashes = np.asarray(hashes, dtype=np.uint64).ravel()
        M0 = hashes.shape[0]
        if M0 == 0:
            return np.zeros(0, dtype=np.uint32)
        M = max(_round_up(M0, 256), 256)
        hb = np.zeros(M, dtype=np.uint64)
        hb[:M0] = hashes
        counts = np.asarray(self._get_fn()(self.tables, jnp.asarray(hb)))
        counts = counts[:M0].astype(np.uint32)
        if self._use_bigcount and self._bigcounts:
            sat = counts == MAX_KCOUNT
            if sat.any():
                for i in np.nonzero(sat)[0]:
                    counts[i] = self._bigcounts.get(int(hashes[i]),
                                                    MAX_KCOUNT)
        return counts

    # -- sequence-level ops ----------------------------------------------

    def consume(self, seq):
        """Count all k-mers in a sequence; returns how many."""
        if len(seq) < self._ksize:
            raise ValueError("sequence length must >= the hashtable k-size")
        return self._commit_hashes(self._hashes_for_sequence(seq))

    def get_kmers(self, seq):
        return [seq[i:i + self._ksize]
                for i in range(len(seq) - self._ksize + 1)]

    def get_kmer_hashes(self, seq):
        return [int(h) for h in self._hashes_for_sequence(seq)]

    def get_kmer_hashes_as_hashset(self, seq):
        return set(self.get_kmer_hashes(seq))

    def get_kmer_counts(self, seq):
        hashes = self._hashes_for_sequence(seq)
        return [int(c) for c in self.get_counts_for_hashes(hashes)]

    def get_min_count(self, seq):
        counts = self.get_kmer_counts(seq)
        return min(min(counts), MAX_KCOUNT) if counts else MAX_KCOUNT

    def get_max_count(self, seq):
        counts = self.get_kmer_counts(seq)
        return max(counts) if counts else 0

    def get_median_count(self, seq):
        """(median, average, stddev) of the k-mer counts of a sequence.

        Median is the medioid (sorted middle element, rounds down);
        average/stddev accumulate in float32 exactly like the C++
        (src/oxli/hashtable.cc:299-328) so printed digits match.
        """
        counts = self.get_counts_for_hashes(self._hashes_for_sequence(seq))
        if counts.size == 0:
            raise ValueError("no k-mer counts for this string; too short?")
        return _median_avg_stddev(counts)

    def median_at_least(self, seq, cutoff):
        """True if the medioid count is >= cutoff (diginorm primitive)."""
        counts = self.get_counts_for_hashes(self._hashes_for_sequence(seq))
        if counts.size == 0:
            raise ValueError("no k-mer counts for this string; too short?")
        min_req = int(0.5 + (len(seq) - self._ksize + 1) / 2.0)
        return int((counts >= cutoff).sum()) >= min_req

    def trim_on_abundance(self, seq, min_abund):
        """Trim at the first k-mer below min_abund.

        Returns (trimmed_seq, trim_at) — reference: hashtable.cc:504-533.
        """
        pos = self._trim_pos(seq, min_abund, below=False)
        return seq[:pos], pos

    def trim_below_abundance(self, seq, max_abund):
        """Trim at the first k-mer above max_abund."""
        pos = self._trim_pos(seq, max_abund, below=True)
        return seq[:pos], pos

    def _trim_pos(self, seq, cutoff, below):
        counts = self.get_counts_for_hashes(self._hashes_for_sequence(seq))
        if counts.size == 0:
            return 0
        bad = (counts > cutoff) if below else (counts < cutoff)
        # a single-window sequence always trims to 0 (the C++ iterator
        # is done() right after the first next(), hashtable.cc:513-520)
        if bad[0] or counts.size == 1:
            return 0
        idx = np.nonzero(bad[1:])[0]
        if idx.size:
            return int(self._ksize + idx[0])
        return len(seq)

    def find_spectral_error_positions(self, seq, max_abund):
        """Positions of count<=max_abund "error" k-mer runs.

        Mirrors src/oxli/hashtable.cc:565-612.
        """
        counts = self.get_counts_for_hashes(self._hashes_for_sequence(seq))
        if counts.size == 0:
            raise ValueError("sequence too short")
        posns = []
        n = counts.size
        i = 0
        # find the first trusted k-mer
        while i < n and counts[i] <= max_abund:
            i += 1
        if i == n:
            return posns
        if i > 0:
            posns.append(i - 1)
        while i < n:
            if counts[i] <= max_abund:  # error
                posns.append(i + self._ksize - 1)
                while i < n and counts[i] <= max_abund:
                    i += 1
            else:
                i += 1
        return posns

    # -- bigcount --------------------------------------------------------

    def set_use_bigcount(self, value):
        if value and not self.supports_bigcount:
            raise ValueError("Bigcount is not supported for this storage.")
        self._use_bigcount = bool(value)

    def get_use_bigcount(self):
        return self._use_bigcount

    # -- file-level ops (implemented over khmer_tpu.io) -------------------

    def consume_seqfile(self, path_or_parser, batcher=None):
        """Count all k-mers in a FASTA/FASTQ file.

        Returns (n_reads, n_consumed). Reference: hashtable.cc:125-150.
        """
        from khmer_tpu.core import pipeline
        return pipeline.consume_seqfile(self, path_or_parser)

    def consume_seqfile_with_mask(self, path_or_parser, mask, threshold=0,
                                  consume_masked=False):
        from khmer_tpu.core import pipeline
        return pipeline.consume_seqfile(
            self, path_or_parser, mask=mask, threshold=threshold,
            consume_masked=consume_masked)

    def consume_seqfile_banding(self, path_or_parser, num_bands, band):
        from khmer_tpu.core import pipeline
        return pipeline.consume_seqfile(
            self, path_or_parser, num_bands=num_bands, band=band)

    def consume_seqfile_banding_with_mask(self, path_or_parser, num_bands,
                                          band, mask, threshold=0,
                                          consume_masked=False):
        from khmer_tpu.core import pipeline
        return pipeline.consume_seqfile(
            self, path_or_parser, num_bands=num_bands, band=band, mask=mask,
            threshold=threshold, consume_masked=consume_masked)

    def abundance_distribution(self, path_or_parser, tracking):
        from khmer_tpu.core import pipeline
        return pipeline.abundance_distribution(self, path_or_parser,
                                               tracking)

    def abundance_distribution_with_reads_parser(self, parser, tracking):
        return self.abundance_distribution(parser, tracking)

    # -- save/load -------------------------------------------------------

    def save(self, filename):
        from khmer_tpu.core import oxli_io
        oxli_io.save_sketch(self, filename)

    @classmethod
    def load(cls, filename):
        from khmer_tpu.core import oxli_io
        return oxli_io.load_sketch(cls, filename)


def _median_avg_stddev(counts):
    """Sequential float32 reduction matching hashtable.cc:299-328."""
    average = np.float32(0)
    for c in counts:
        average = np.float32(average + np.float32(c))
    average = np.float32(average / np.float32(counts.size))
    stddev = np.float32(0)
    for c in counts:
        d = np.float32(np.float32(c) - average)
        stddev = np.float32(stddev + np.float32(d * d))
    stddev = np.float32(stddev / np.float32(counts.size))
    stddev = np.float32(np.sqrt(stddev))
    median = int(np.sort(counts)[counts.size // 2])
    return median, float(average), float(stddev)


class _TwoBitMixin:
    hash_family = "twobit"

    def reverse_hash(self, hashval):
        return H.reverse_hash(int(hashval), self._ksize)


class _MurmurMixin:
    hash_family = "murmur"


class Counttable(_MurmurMixin, _Sketch):
    """Count-Min sketch with murmur hashing (reference Counttable)."""

    storage_kind = "byte"
    supports_bigcount = True


class SmallCounttable(_MurmurMixin, _Sketch):
    """4-bit Count-Min sketch with murmur hashing."""

    storage_kind = "nibble"


class Nodetable(_MurmurMixin, _Sketch):
    """Bloom filter with murmur hashing."""

    storage_kind = "bit"

    def count(self, kmer):
        self._commit_hashes(self._coerce_hashes(kmer))
        return 1

    add = count


class CyclicCounttable(_Sketch):
    """Count-Min sketch with cyclic rolling hash.

    The reference uses a third-party CyclicHash (irreversible h + r
    canonicalization). Implemented host-side; rarely used.
    """

    storage_kind = "byte"
    hash_family = "cyclic"
    supports_bigcount = True

    def hash(self, kmer):
        from khmer_tpu.ops import cyclic
        if len(kmer) != self._ksize:
            raise ValueError("Expected k-mer length %d but got %d."
                             % (self._ksize, len(kmer)))
        return cyclic.hash_cyclic(kmer, self._ksize)

    def _hashes_for_sequence(self, seq):
        from khmer_tpu.ops import cyclic
        if len(seq) < self._ksize:
            return np.zeros(0, dtype=np.uint64)
        return cyclic.hash_cyclic_windows(seq, self._ksize)

    def consume_seqfile(self, path_or_parser, batcher=None):
        """File consume: cyclic window hashes come from the vectorized
        host closed form (ops/cyclic.hash_cyclic_windows — the
        reference wraps a third-party CyclicHash the same way,
        kmer_hash.cc:210-258) and commit in large batches, one device
        dispatch per ~256k events instead of one per read."""
        from khmer_tpu.core import pipeline

        k = self._ksize
        n_reads = 0
        n_consumed = 0
        buf = []
        buffered = 0
        for record in pipeline.records_from(path_or_parser):
            seq = record.cleaned_seq
            n_reads += 1
            if len(seq) >= k:
                hashes = self._hashes_for_sequence(seq)
                buf.append(hashes)
                buffered += hashes.size
                n_consumed += int(hashes.size)
                if buffered >= (1 << 18):
                    self._commit_hashes(np.concatenate(buf))
                    buf = []
                    buffered = 0
        if buf:
            self._commit_hashes(np.concatenate(buf))
        return n_reads, n_consumed


class QFCounttable(_MurmurMixin, _Sketch):
    """Counting quotient filter table (reference QFStorage wrapper,
    include/oxli/storage.hh:413-458).

    Backed by a real host-side rank-and-select CQF (core/qf.py): the
    packed qfblock structure, byte-compatible SAVED_QFCOUNT files, and
    counting keyed by ``khash % range`` exactly as the reference.
    """

    storage_kind = "qf"

    def __init__(self, ksize, size):
        # size must be a power of two
        if size & (size - 1) != 0:
            raise ValueError("size has to be a power of two, not %s" % size)
        from khmer_tpu.core import qf
        self._ksize = int(ksize)
        if self._ksize > H.KSIZE_MAX:
            raise ValueError("k-mer size must be <= %d" % H.KSIZE_MAX)
        self._qf = qf.QuotientFilter(int(size))
        self._primes = (int(size),)
        self._use_bigcount = False
        self._bigcounts = {}

    def count(self, kmer):
        h = self._coerce_hashes(kmer)[0]
        self._qf.insert(int(h))
        return 1

    add = count

    def get(self, kmer):
        h = self._coerce_hashes(kmer)[0]
        return self._qf.count(int(h))

    def get_counts_for_hashes(self, hashes):
        return self._qf.counts_many(
            np.asarray(hashes, dtype=np.uint64).ravel())

    def _commit_hashes(self, hashes, valid=None):
        hashes = np.asarray(hashes, dtype=np.uint64).ravel()
        if valid is not None:
            hashes = hashes[np.asarray(valid, bool).ravel()[:len(hashes)]]
        self._qf.insert_many(hashes)
        return len(hashes)

    def n_unique_kmers(self):
        return self._qf.n_unique

    def n_occupied(self):
        return self._qf.n_occupied

    def hashsizes(self):
        return list(self._primes)

    def consume_seqfile(self, path_or_parser, batcher=None):
        """Host-path file consume: the CQF state lives host-side, so
        stream records instead of the device flat pipeline."""
        from khmer_tpu.core import pipeline

        k = self._ksize
        n_reads = 0
        n_consumed = 0
        for record in pipeline.records_from(path_or_parser):
            seq = record.cleaned_seq
            n_reads += 1
            if len(seq) >= k:
                n_consumed += self.consume(seq)
        return n_reads, n_consumed

    def save(self, filename):
        """OXLI v4 SAVED_QFCOUNT file (reference storage.cc:919-955)."""
        from khmer_tpu.core import oxli_io

        with oxli_io._open_write(filename) as f:
            f.write(oxli_io.SAVED_SIGNATURE)
            f.write(bytes([oxli_io.SAVED_FORMAT_VERSION]))
            f.write(bytes([oxli_io.SAVED_QFCOUNT]))
            self._qf.save(f, self.ksize())

    @classmethod
    def load(cls, filename):
        from khmer_tpu.core import oxli_io
        from khmer_tpu.core.qf import QuotientFilter

        with oxli_io._open_read(filename) as f:
            oxli_io._check_header(f, oxli_io.SAVED_QFCOUNT, filename,
                                  "quotient filter")
            qf, ksize = QuotientFilter.load(f)
        obj = cls(ksize, qf.nslots)
        obj._qf = qf
        return obj


# --------------------------------------------------------------------------
# Hashgraph layer (graph semantics over the 2-bit reversible hash)
# --------------------------------------------------------------------------

from khmer_tpu.core.graphmixin import HashgraphMixin  # noqa: E402


class Countgraph(HashgraphMixin, _TwoBitMixin, _Sketch):
    """Count-Min sketch + de Bruijn graph ops (reference Countgraph)."""

    storage_kind = "byte"
    supports_bigcount = True

    def __init__(self, ksize, starting_size, n_tables, primes=None):
        _Sketch.__init__(self, ksize, starting_size, n_tables, primes)
        self._init_graph()
        self._use_bigcount = False


class SmallCountgraph(HashgraphMixin, _TwoBitMixin, _Sketch):
    """4-bit Count-Min sketch + graph ops."""

    storage_kind = "nibble"

    def __init__(self, ksize, starting_size, n_tables, primes=None):
        _Sketch.__init__(self, ksize, starting_size, n_tables, primes)
        self._init_graph()


class Nodegraph(HashgraphMixin, _TwoBitMixin, _Sketch):
    """Bloom filter + de Bruijn graph ops (reference Nodegraph)."""

    storage_kind = "bit"

    def __init__(self, ksize, starting_size, n_tables, primes=None):
        _Sketch.__init__(self, ksize, starting_size, n_tables, primes)
        self._init_graph()

    def update(self, other):
        """Bitwise-OR merge of an equal-shaped Nodegraph (Bloom union).

        Reference: Nodegraph::update_from (src/oxli/hashgraph.cc:892-907).
        """
        if (self._ksize != other._ksize
                or self._primes != other._primes):
            raise ValueError(
                "both nodegraphs must have same ksize and table sizes")
        self.tables = tuple(
            jnp.bitwise_or(a, b) for a, b in zip(self.tables, other.tables))
        # reference invalidates these counters on merge the same way
        # (occupancy is recomputed from table 0; n_unique is a lower bound)
        self._n_unique = jnp.maximum(self._n_unique, other._n_unique)

    update_from = update


# caching for padded single-sequence hashers ------------------------------

import functools  # noqa: E402

import jax  # noqa: E402


@functools.lru_cache(maxsize=None)
def _hash_padded(k, hash_family, L):
    @jax.jit
    def fn(codes):
        return H.hash_windows(codes, k, hash_family)

    return fn
