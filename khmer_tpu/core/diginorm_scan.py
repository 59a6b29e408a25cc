"""Device-resident digital normalization: lax.scan over read bundles.

The diginorm keep/discard decision is inherently sequential — every
kept bundle's k-mers update the countgraph and change later medians
(reference scripts/normalize-by-median.py:155-179). Round 1 restored
exactness with a host-side delta map (core/diginorm.py.SeqWindow), but
its per-read Python work capped throughput near 500 reads/s. This
engine keeps the WHOLE sequential loop on device:

- a window of B bundles (<=2 reads each) is hashed in one vector op;
- `lax.scan` walks bundles in stream order carrying the count tables:
  gather per-table counts -> median_at_least test (hashtable.cc:333)
  -> conditional scatter-add of the bundle's k-mers;
- tables are u32 shadows of the u8 countgraph: since every add is +1,
  the saturating-u8 count equals min(total_adds, 255), so queries
  clamp at read time and `finalize()` writes exact u8 tables back;
- n_unique keeps the reference's exact add() semantics (some table
  bin zero at the moment of the add): the bundle's pre-state is the
  gathered counts, and first-hit-per-bin inside the bundle is resolved
  by one small sort per step (winner by stream position).

The per-bundle random-op cost (~8 * windows gathers + scatter) matches
khmer's own per-read work; the scan keeps it all on-device with one
dispatch per window.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from khmer_tpu.core import sketch_kernels as K
from khmer_tpu.core import pipeline
from khmer_tpu.ops import hashing as H

MAX_KCOUNT = K.MAX_KCOUNT


def _step_gather(primes, tables, h2):
    """Per-bundle gathers: bins [T,2,W], pre-bundle counts old
    [T,2,W], and the clamped min-over-tables counts [2,W]."""
    T = len(primes)
    bins = jnp.stack([
        (h2 % np.uint64(p)).astype(jnp.int32) for p in primes])
    old = jnp.stack([
        tables[t].at[bins[t]].get(mode="clip").astype(jnp.int32)
        for t in range(T)])
    counts = jnp.min(jnp.minimum(old, MAX_KCOUNT), axis=0)
    return bins, old, counts


def _med_at_least(counts, valid2, nvalid2, present2, X):
    """median_at_least(X) per read (hashtable.cc:333-364); absent
    reads pass vacuously."""
    ge = jnp.sum((valid2 & (counts >= X)).astype(jnp.int32), axis=1)
    min_req = jnp.floor(0.5 + nvalid2.astype(jnp.float32)
                        / 2.0).astype(jnp.int32)
    return jnp.where(present2, ge >= min_req, True)


def _consume_bundle(primes, offsets, id_bound, tables, n_unique, bins,
                    old, do):
    """Commit the bundle's adds (where `do`) with exact n_unique:
    credit = first event of the bundle to hit a bin whose pre-bundle
    count is zero, in any table — resolved by one small sort over the
    bundle's (table, bin) ids."""
    T = len(primes)
    W2 = do.size  # 2 * W
    ids = jnp.where(do[None, :, :],
                    bins.astype(jnp.int64) + offsets[:T, None, None],
                    id_bound).reshape(T, W2)
    order = jnp.broadcast_to(jnp.arange(W2, dtype=jnp.int32), (T, W2))
    oldf = old.reshape(T, W2)
    ids_s, ord_s, old_s = jax.lax.sort(
        (ids.ravel(), order.ravel(), oldf.ravel()), num_keys=2)
    first = (ids_s < id_bound) & \
        ((jnp.arange(T * W2) == 0) | (ids_s != jnp.roll(ids_s, 1)))
    fresh_first = first & (old_s == 0)
    ev = jnp.zeros(W2 + 1, bool).at[
        jnp.where(fresh_first, ord_s, jnp.int32(W2))].set(
        True, mode="drop")
    n_unique = n_unique + jnp.sum(
        ev[:W2].astype(jnp.uint32)).astype(jnp.uint64)
    new_tables = tuple(
        tables[t].at[jnp.where(do, bins[t], jnp.int32(primes[t]))
                     ].add(1, mode="drop")
        for t in range(T))
    return new_tables, n_unique


@functools.lru_cache(maxsize=None)
def make_med_ok(primes, k, hash_family, cutoff, L):
    """jit: (tables_u32, codes [2B, L], lengths [2B]) -> [B] bool —
    True iff every present read of the bundle has median_at_least(C)
    under the CURRENT tables (i.e. the bundle would be rejected).

    Counts only grow during diginorm, and median_at_least is monotone
    in the counts, so a True here is final: only False bundles (the
    few percent of "keep candidates") need the sequential scan.
    """
    primes = tuple(int(p) for p in primes)
    C = int(cutoff)

    @jax.jit
    def med_ok(tables, codes, lengths):
        W = codes.shape[-1] - k + 1
        hashes = H.hash_windows(codes, k, hash_family)
        win = jnp.arange(W, dtype=jnp.int32)[None, :]
        valid = win <= (lengths[:, None] - k)
        counts = jnp.full(hashes.shape, jnp.int32(MAX_KCOUNT))
        for t, p in enumerate(primes):
            c = tables[t].at[(hashes % np.uint64(p)).astype(jnp.int32)
                             ].get(mode="clip").astype(jnp.int32)
            counts = jnp.minimum(counts, c)
        ge = jnp.sum((valid & (counts >= C)).astype(jnp.int32), axis=1)
        nvalid = jnp.maximum(lengths - (k - 1), 0)
        min_req = jnp.floor(0.5 + nvalid.astype(jnp.float32)
                            / 2.0).astype(jnp.int32)
        ok = (ge >= min_req) | (lengths < k)   # absent reads pass
        return jnp.all(ok.reshape(-1, 2), axis=1)

    return med_ok


@functools.lru_cache(maxsize=None)
def make_diginorm_window(primes, k, hash_family, cutoff, nbundles, L):
    """jit: (tables_u32, n_unique, codes [2B, L], lengths [2B])
    -> (tables_u32, n_unique, keep [B] bool)."""
    primes = tuple(int(p) for p in primes)
    T = len(primes)
    W = L - k + 1
    C = int(cutoff)
    # unique id per (table, bin), inactive sorts last
    offsets = np.cumsum([0] + list(primes)).astype(np.int64)
    id_bound = np.int64(offsets[-1])

    def bundle_step(carry, xs):
        tables, n_unique = carry
        h2, valid2, nvalid2, present2 = xs      # [2,W],[2,W],[2],[2]

        bins, old, counts = _step_gather(primes, tables, h2)
        med_ok = _med_at_least(counts, valid2, nvalid2, present2, C)
        keep = ~jnp.all(med_ok)
        do = keep & valid2 & present2[:, None]   # [2, W] adds to commit
        tables, n_unique = _consume_bundle(
            primes, offsets, id_bound, tables, n_unique, bins, old, do)
        return (tables, n_unique), keep

    @functools.partial(jax.jit, donate_argnums=(0,))
    def window(tables, n_unique, codes, lengths):
        hashes = H.hash_windows(codes, k, hash_family)     # [2B, W]
        win = jnp.arange(W, dtype=jnp.int32)[None, :]
        valid = win <= (lengths[:, None] - k)
        B = codes.shape[0] // 2
        xs = (hashes.reshape(B, 2, W),
              valid.reshape(B, 2, W),
              jnp.maximum(lengths - (k - 1), 0).reshape(B, 2),
              (lengths >= k).reshape(B, 2))
        (tables, n_unique), keep = jax.lax.scan(
            bundle_step, (tables, n_unique), xs, unroll=8)
        return tables, n_unique, keep

    return window


@functools.lru_cache(maxsize=None)
def make_trim1_window(primes, k, hash_family, cutoff, trim_cov,
                      digi_cov, nbundles, L):
    """trim-low-abund pass 1 as a device scan
    (reference scripts/trim-low-abund.py:190-238).

    Per bundle, in stream order:
      branch 0: --diginorm and min coverage >= digi_cov  -> drop
      branch 1: min coverage >= trim_cov -> emit trimmed (trim_at out)
      branch 2: otherwise -> consume k-mers (feedback!), save for pass2

    jit: (tables_u32, n_unique, codes [2B,L], lengths [2B])
      -> (tables, n_unique, branch [B] i32, trim_at [B,2] i32)
    """
    primes = tuple(int(p) for p in primes)
    W = L - k + 1
    CUT = int(cutoff)
    TRIM = int(trim_cov)
    offsets = np.cumsum([0] + list(primes)).astype(np.int64)
    id_bound = np.int64(offsets[-1])

    def bundle_step(carry, xs):
        tables, n_unique = carry
        h2, valid2, nvalid2, present2 = xs

        bins, old, counts = _step_gather(primes, tables, h2)
        ge_trim = jnp.all(_med_at_least(counts, valid2, nvalid2,
                                        present2, TRIM))
        if digi_cov is not None:
            ge_digi = jnp.all(_med_at_least(counts, valid2, nvalid2,
                                            present2, int(digi_cov)))
            branch = jnp.where(ge_digi, 0, jnp.where(ge_trim, 1, 2))
        else:
            branch = jnp.where(ge_trim, 1, 2)

        # trim position per read (hashtable.cc:504-533): first k-mer
        # past the 0th whose count < cutoff; bad 0th or single-window
        # reads trim to 0; untouched reads trim to their length
        pos = jnp.arange(W, dtype=jnp.int32)[None, :]
        bad = valid2 & (counts < CUT)
        b0 = bad[:, 0]
        rest = bad & (pos >= 1)
        exists = jnp.any(rest, axis=1)
        j0 = jnp.min(jnp.where(rest, pos, jnp.int32(W)), axis=1)
        seqlen = nvalid2 + (k - 1)
        trim_at = jnp.where(
            b0 | (nvalid2 == 1), 0,
            jnp.where(exists, k + j0 - 1, seqlen)).astype(jnp.int32)

        do = (branch == 2) & valid2 & present2[:, None]
        tables, n_unique = _consume_bundle(
            primes, offsets, id_bound, tables, n_unique, bins, old, do)
        return (tables, n_unique), (branch, trim_at)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def window(tables, n_unique, codes, lengths):
        hashes = H.hash_windows(codes, k, hash_family)
        win = jnp.arange(W, dtype=jnp.int32)[None, :]
        valid = win <= (lengths[:, None] - k)
        B = codes.shape[0] // 2
        xs = (hashes.reshape(B, 2, W),
              valid.reshape(B, 2, W),
              jnp.maximum(lengths - (k - 1), 0).reshape(B, 2),
              (lengths >= k).reshape(B, 2))
        (tables, n_unique), (branch, trim_at) = jax.lax.scan(
            bundle_step, (tables, n_unique), xs, unroll=8)
        return tables, n_unique, branch, trim_at

    return window


class ScanTrimmerState:
    """u32 shadow tables + window driver for trim-low-abund pass 1."""

    def __init__(self, graph, cutoff, trim_cov, digi_cov=None,
                 window=512):
        if graph.storage_kind != "byte":
            raise ValueError("scan trimmer requires byte storage")
        self.graph = graph
        self.k = graph.ksize()
        self.cutoff = int(cutoff)
        self.trim_cov = int(trim_cov)
        self.digi_cov = digi_cov
        self.window = window
        self._primes = tuple(graph._primes)
        self._tables = tuple(t.astype(jnp.uint32) for t in graph.tables)
        self._n_unique = graph._n_unique
        self._dirty = False

    def process_window(self, bundles):
        """Returns (branch [n], trim_at [n, 2]) numpy arrays."""
        n = len(bundles)
        B = self.window
        if n > B:
            raise ValueError("window too large")
        maxlen = max(max((len(r.cleaned_seq) for r in b), default=0)
                     for b in bundles)
        if maxlen > pipeline.MAX_ROW_LEN:
            return None  # caller falls back to the host engine
        L = max(pipeline._bucket_len(maxlen), self.k + 7)
        codes = np.zeros((2 * B, L), dtype=np.uint8)
        lengths = np.zeros(2 * B, dtype=np.int32)
        for i, bundle in enumerate(bundles):
            for j, rec in enumerate(bundle[:2]):
                c = H.encode_dna(rec.cleaned_seq)
                codes[2 * i + j, : len(c)] = c
                lengths[2 * i + j] = len(c)
        fn = make_trim1_window(
            self._primes, self.k, self.graph.hash_family, self.cutoff,
            self.trim_cov,
            None if self.digi_cov is None else int(self.digi_cov), B, L)
        self._tables, self._n_unique, branch, trim_at = fn(
            self._tables, self._n_unique, jnp.asarray(codes),
            jnp.asarray(lengths))
        self._dirty = True
        return np.asarray(branch)[:n], np.asarray(trim_at)[:n]

    def finalize(self):
        if not self._dirty:
            return
        self.graph.tables = tuple(
            jnp.minimum(t, MAX_KCOUNT).astype(jnp.uint8)
            for t in self._tables)
        self.graph._n_unique = self._n_unique
        self._dirty = False

    def reload(self):
        """Re-seed the shadow from the countgraph (after host-side
        windows mutated it directly)."""
        self._tables = tuple(t.astype(jnp.uint32)
                             for t in self.graph.tables)
        self._n_unique = self.graph._n_unique
        self._dirty = False


class ScanNormalizer:
    """Window-batched, device-sequential exact diginorm engine."""

    def __init__(self, countgraph, desired_coverage, window=512):
        if countgraph.storage_kind != "byte":
            raise ValueError("ScanNormalizer requires byte storage; use "
                             "BatchedNormalizer for other kinds")
        self.graph = countgraph
        self.C = int(desired_coverage)
        self.window = window
        self.k = countgraph.ksize()
        self._primes = tuple(countgraph._primes)
        # u32 shadow: min(total, 255) == the u8 saturating count
        self._reseed_from_graph()
        self._dirty = False

    def process_window(self, bundles):
        """bundles: list of record lists (1 or 2 reads). Returns kept
        records per bundle, exactly as the sequential reference."""
        n = len(bundles)
        out = [[] for _ in range(n)]
        if n == 0:
            return out
        B = self.window
        if n > B:
            raise ValueError("window too large")
        maxlen = max(max((len(r.cleaned_seq) for r in b), default=0)
                     for b in bundles)
        if maxlen > pipeline.MAX_ROW_LEN:
            # pathological long reads: exact host-side window instead
            return self._host_window(bundles)
        L = max(pipeline._bucket_len(maxlen), self.k + 7)
        codes = np.zeros((2 * B, L), dtype=np.uint8)
        lengths = np.zeros(2 * B, dtype=np.int32)
        for i, bundle in enumerate(bundles):
            for j, rec in enumerate(bundle[:2]):
                c = H.encode_dna(rec.cleaned_seq)
                codes[2 * i + j, : len(c)] = c
                lengths[2 * i + j] = len(c)

        # phase A (vector, one dispatch): bundles whose reads already
        # meet the coverage cutoff are rejected for good (monotone)
        rejected = self._phase_a(codes, lengths, L)
        cand = np.nonzero(~rejected[:n])[0]
        if cand.size == 0:
            return out

        # phase B: sequential scan over the keep candidates only, in
        # fixed-size chunks so exactly ONE scan shape ever compiles
        CB = 128
        fn = self._scan_fn(CB, L)
        for s in range(0, cand.size, CB):
            sub = cand[s:s + CB]
            rows = np.zeros((2 * CB, L), dtype=np.uint8)
            rlen = np.zeros(2 * CB, dtype=np.int32)
            src = np.stack([2 * sub, 2 * sub + 1], axis=1).ravel()
            rows[: 2 * sub.size] = codes[src]
            rlen[: 2 * sub.size] = lengths[src]
            self._tables, self._n_unique, keep = fn(
                self._tables, self._n_unique, jnp.asarray(rows),
                jnp.asarray(rlen))
            keep = np.asarray(keep)
            for i, b in enumerate(sub):
                if keep[i]:
                    out[b] = list(bundles[b])
        self._dirty = True
        return out

    def _phase_a(self, codes, lengths, L):
        fa = make_med_ok(self._primes, self.k, self.graph.hash_family,
                         self.C, L)
        return np.asarray(fa(self._tables, jnp.asarray(codes),
                             jnp.asarray(lengths)))

    def _scan_fn(self, CB, L):
        return make_diginorm_window(self._primes, self.k,
                                    self.graph.hash_family, self.C, CB,
                                    L)

    def _host_window(self, bundles):
        """Stream-order exact fallback through the delta-map engine."""
        from khmer_tpu.core.diginorm import BatchedNormalizer

        self.finalize()
        out = BatchedNormalizer(self.graph, self.C,
                                window=len(bundles)).process_window(
            bundles)
        self._reseed_from_graph()
        return out

    def _reseed_from_graph(self):
        self._tables = tuple(t.astype(jnp.uint32)
                             for t in self.graph.tables)
        self._n_unique = self.graph._n_unique

    def finalize(self):
        """Write the u32 shadow back into the countgraph as exact
        saturated u8 tables (+ statistics)."""
        if not self._dirty:
            return
        self.graph.tables = tuple(
            jnp.minimum(t, MAX_KCOUNT).astype(jnp.uint8)
            for t in self._tables)
        self.graph._n_unique = self._n_unique
        self._dirty = False
