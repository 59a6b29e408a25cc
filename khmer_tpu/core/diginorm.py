"""Digital normalization & streaming-trim support — batched,
sequential-exact.

The reference algorithms (scripts/normalize-by-median.py:155-179,
scripts/trim-low-abund.py:162-238) are strictly sequential: each
consumed read updates the countgraph, changing later decisions. The
device engine restores exactness per *window* of read bundles:

  1. one device call hashes every read in the window and gathers its
     *per-table* bin counts from the current sketch;
  2. a host pass walks bundles in stream order, maintaining a delta map
     of (table, bin) -> adds committed within this window; each read's
     effective count is min_t(saturate(base_t + delta_t)), which equals
     what the sequential reference would see — including
     false-positive-induced decisions;
  3. consumed reads' hashes are committed to the device sketch in
     stream order in one batched update at window end
     (n_unique/bigcount statistics remain path-exact).
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp

from khmer_tpu.core import pipeline
from khmer_tpu.core import sketch_kernels as K
from khmer_tpu.ops import hashing as H

MAX_KCOUNT = K.MAX_KCOUNT


@functools.lru_cache(maxsize=None)
def make_pertable_counts(kind, primes, k, hash_family):
    """[B, L] codes -> (hashes [B, W], per-table counts [T, B, W])."""
    primes = tuple(int(p) for p in primes)

    @jax.jit
    def fn(tables, codes, lengths):
        W = codes.shape[-1] - k + 1
        hashes = H.hash_windows(codes, k, hash_family)
        win = jnp.arange(W, dtype=jnp.int32)[None, :]
        valid = win <= (lengths[:, None] - k)
        per = []
        for t, p in enumerate(primes):
            bins = hashes % np.uint64(p)
            if kind == "byte":
                c = jnp.take(tables[t], bins).astype(jnp.uint16)
            elif kind == "nibble":
                byte = jnp.take(tables[t], bins // np.uint64(2)).astype(
                    jnp.uint16)
                odd = (bins % np.uint64(2)).astype(jnp.uint16)
                c = jnp.where(odd == 1, byte & 0xF, byte >> 4)
            else:
                byte = jnp.take(tables[t], bins // np.uint64(8)).astype(
                    jnp.int32)
                bit = (jnp.int32(1)
                       << (bins % np.uint64(8)).astype(jnp.int32))
                c = ((byte & bit) != 0).astype(jnp.uint16)
            per.append(c)
        return hashes, jnp.stack(per), valid

    return fn


class SeqWindow:
    """Sequential-exact count evaluation over a window of sequences.

    One device call gathers per-table base counts for every sequence;
    effective counts (reflecting consumes committed earlier within the
    window, tracked via a (table, bin) -> adds delta map) then equal
    what the sequential reference would observe at each stream point.
    """

    def __init__(self, graph, seqs):
        self.graph = graph
        self.k = graph.ksize()
        self._primes = tuple(graph._primes)
        self._sat = {"nibble": 15, "bit": 1}.get(
            graph.storage_kind, MAX_KCOUNT)
        self._delta = {}
        self._commit = []
        self._data = []
        if seqs:
            hashes, per, lengths = self._eval(seqs)
            T = len(self._primes)
            for s in range(len(seqs)):
                nwin = int(lengths[s]) - self.k + 1
                if nwin <= 0:
                    self._data.append((None, None, None, 0))
                    continue
                h = hashes[s, :nwin]
                base = per[:, s, :nwin].astype(np.int32)
                keys = np.empty((T, nwin), dtype=np.uint64)
                for t in range(T):
                    keys[t] = (h % np.uint64(self._primes[t])
                               + (np.uint64(t) << np.uint64(60)))
                self._data.append((h, base, keys, nwin))

    def _eval(self, seqs):
        k = self.k
        fn = make_pertable_counts(self.graph.storage_kind, self._primes,
                                  k, self.graph.hash_family)
        L = max(pipeline._bucket_len(max(len(s) for s in seqs)), k + 1)
        B = pipeline._bucket_rows(len(seqs))
        codes = np.zeros((B, L), dtype=np.uint8)
        lengths = np.zeros(B, dtype=np.int32)
        for i, s in enumerate(seqs):
            c = H.encode_dna(s)
            codes[i, : len(c)] = c
            lengths[i] = len(c)
        hashes, per, valid = fn(self.graph.tables, jnp.asarray(codes),
                                jnp.asarray(lengths))
        return (np.asarray(hashes), np.asarray(per), lengths)

    def counts(self, idx):
        """Effective min-over-tables counts of sequence idx, as the
        sequential reference would see them right now."""
        h, base, keys, nwin = self._data[idx]
        if nwin == 0:
            return np.zeros(0, np.int32)
        counts = base
        if self._delta:
            adj = np.zeros_like(base)
            delta = self._delta
            flat = keys.ravel()
            for j in range(flat.shape[0]):
                d = delta.get(int(flat[j]))
                if d:
                    adj.flat[j] = d
            counts = np.minimum(base + adj, self._sat)
        return counts.min(axis=0)

    def median(self, idx):
        """Medioid effective count (reference get_median_count)."""
        eff = self.counts(idx)
        if eff.size == 0:
            raise ValueError("no k-mer counts for this string; too short?")
        return int(np.sort(eff)[eff.size // 2])

    def consume(self, idx):
        """Record sequence idx as consumed (affects later counts)."""
        h, base, keys, nwin = self._data[idx]
        if nwin == 0:
            return
        self._commit.append(h)
        delta = self._delta
        for key in keys.ravel():
            key = int(key)
            delta[key] = delta.get(key, 0) + 1

    def flush(self):
        """Apply all consumes to the device sketch, in stream order."""
        if self._commit:
            self.graph._commit_hashes(np.concatenate(self._commit))
            self._commit = []


class BatchedNormalizer:
    """Window-batched exact diginorm engine."""

    def __init__(self, countgraph, desired_coverage, window=512):
        self.graph = countgraph
        self.C = int(desired_coverage)
        self.window = window
        self.k = countgraph.ksize()

    def finalize(self):
        """No-op: this engine commits straight to the countgraph
        (interface parity with ScanNormalizer)."""

    def process_window(self, bundles):
        """bundles: list of lists of records (1 or 2 reads each).

        Returns, per bundle, the list of kept records — exactly as the
        sequential reference would decide.
        """
        n = len(bundles)
        kept_out = [[] for _ in range(n)]
        seqs = []
        for bundle in bundles:
            for r in bundle:
                seqs.append(r.cleaned_seq)
        if not seqs:
            return kept_out
        win = SeqWindow(self.graph, seqs)

        C = self.C
        si = 0
        for i, bundle in enumerate(bundles):
            idxs = list(range(si, si + len(bundle)))
            si += len(bundle)
            # keep iff any read's median < C (coverages_at_least -> all)
            all_at_least = True
            for idx in idxs:
                eff = win.counts(idx)
                if eff.size == 0:
                    continue
                min_req = int(0.5 + eff.size / 2.0)
                if int((eff >= C).sum()) < min_req:
                    all_at_least = False
                    break
            if not all_at_least:
                kept_out[i] = list(bundle)
                for idx in idxs:
                    win.consume(idx)
        win.flush()
        return kept_out
