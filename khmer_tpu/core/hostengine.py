"""Native host engine bindings + dispatch policy.

The runtime has two execution tiers with bit-identical semantics:

- the **device tier** (JAX/XLA kernels in sketch_kernels.py /
  blocked.py / parallel/*) — the throughput path for bulk counting and
  the scale-out path across a device mesh;
- the **host tier** (src/hostgraph.cc via ctypes) — the latency path
  for sequential state machines over small streams (tagging, diginorm,
  partition BFS, HLL, trims), where per-window device round trips
  outweigh the work itself.

The dispatcher sends those families to the host tier whenever the
native library loads; the result is identical either way
(tests/test_hostengine.py; on the GPU, chip_smoke.py).

Env overrides: KHMER_TPU_ENGINE = auto (default) | host | device,
KHMER_TPU_HOST_THREADS = BFS thread count.
"""

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_LIB_TRIED = False

_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "src")
_LIB_PATH = os.path.join(_SRC_DIR, "libkhmer_tpu_host.so")

KIND = {"bit": 0, "byte": 1, "nibble": 2}

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_llp = ctypes.POINTER(ctypes.c_longlong)
_u8pp = ctypes.POINTER(_u8p)


def _load():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    lib = _open_lib(rebuild=not os.path.exists(_LIB_PATH))
    if lib is None:
        return None
    try:
        _bind(lib)
    except AttributeError:
        # stale prebuilt .so predating newer exports: force a rebuild
        # once, then degrade gracefully (numpy/device fallbacks) rather
        # than crash every host-tier entry point. The stale handle must
        # be dlclosed first — glibc dlopen dedups by path string and
        # would hand back the old mapping.
        try:
            import _ctypes

            _ctypes.dlclose(lib._handle)
        except Exception:
            pass
        lib = _open_lib(rebuild=True)
        if lib is None:
            return None
        try:
            _bind(lib)
        except AttributeError:
            return None
    _LIB = lib
    return _LIB


def _open_lib(rebuild):
    if rebuild:
        try:
            subprocess.run(["make", "-B", "-C", _SRC_DIR,
                            os.path.basename(_LIB_PATH)], check=True,
                           capture_output=True, timeout=180)
        except Exception:
            return None
    try:
        return ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None


def _bind(lib):
    lib.hg_set_create.restype = ctypes.c_void_p
    lib.hg_set_create.argtypes = [ctypes.c_longlong]
    lib.hg_set_add.restype = None
    lib.hg_set_add.argtypes = [ctypes.c_void_p, _u64p, ctypes.c_longlong]
    lib.hg_set_size.restype = ctypes.c_longlong
    lib.hg_set_size.argtypes = [ctypes.c_void_p]
    lib.hg_set_export.restype = ctypes.c_longlong
    lib.hg_set_export.argtypes = [ctypes.c_void_p, _u64p,
                                  ctypes.c_longlong]
    lib.hg_set_clear.restype = None
    lib.hg_set_clear.argtypes = [ctypes.c_void_p]
    lib.hg_set_free.restype = None
    lib.hg_set_free.argtypes = [ctypes.c_void_p]

    lib.hg_consume_block.restype = ctypes.c_longlong
    lib.hg_consume_block.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int, ctypes.c_int,
        _u8p, _i64p, _i64p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, _u64p, ctypes.c_longlong, _llp, _u64p, _u64p]

    lib.hg_consume_block_murmur.restype = ctypes.c_longlong
    lib.hg_consume_block_murmur.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int, ctypes.c_int,
        _u8p, _i64p, _i64p, ctypes.c_longlong,
        ctypes.c_int, _u64p, ctypes.c_longlong, _llp, _u64p, _u64p]

    lib.hg_diginorm.restype = ctypes.c_longlong
    lib.hg_diginorm.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int, ctypes.c_int,
        _u8p, _i64p, _i64p, _i64p, ctypes.c_longlong, ctypes.c_int,
        _u8p, _u64p, _u64p]

    lib.hg_trim1.restype = ctypes.c_longlong
    lib.hg_trim1.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int, ctypes.c_int,
        _u8p, _i64p, _i64p, _i64p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _i32p, _i32p, _u64p, _u64p]

    lib.hg_trim_filter.restype = None
    lib.hg_trim_filter.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int, ctypes.c_int,
        _u8p, _i64p, _i64p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p]

    lib.hg_hll_consume.restype = ctypes.c_longlong
    lib.hg_hll_consume.argtypes = [
        ctypes.c_int, ctypes.c_int, _u8p, _u8p, _i64p, _i64p,
        ctypes.c_longlong]

    lib.hg_find_all_tags_range.restype = ctypes.c_longlong
    lib.hg_find_all_tags_range.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int,
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int,
        ctypes.c_int, _u64p, ctypes.c_int64,
        _u64p, ctypes.c_int64,
        _u64p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _u64p, ctypes.c_longlong, _i64p]

    _dbl = ctypes.c_double
    _dblp = ctypes.POINTER(_dbl)
    _i8p = ctypes.POINTER(ctypes.c_int8)
    _u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.hg_subalign.restype = ctypes.c_longlong
    lib.hg_subalign.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _dbl,
        _dblp, _dblp, _i8p,
        _u8p, ctypes.c_longlong,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_longlong,
        _dbl, ctypes.c_int,
        _u8p, _u8p, _i32p, _u8p, _u16p, ctypes.c_longlong,
        _dblp, ctypes.POINTER(ctypes.c_int)]

    lib.hg_abund_dist.restype = ctypes.c_longlong
    lib.hg_abund_dist.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int,
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int,
        ctypes.c_int, _u8p, _i64p, _i64p, ctypes.c_longlong,
        _u64p, _u64p, ctypes.c_longlong]

    lib.hg_add_hashes.restype = ctypes.c_longlong
    lib.hg_add_hashes.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int,
        _u64p, ctypes.c_longlong, _u64p, _u64p,
        ctypes.c_int, _u64p, ctypes.c_longlong, _llp]

    lib.hg_sweep_for_tags.restype = ctypes.c_longlong
    lib.hg_sweep_for_tags.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int, ctypes.c_int,
        _u8p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        _u64p, ctypes.c_int64, _u64p, ctypes.c_int64,
        _u64p, ctypes.c_longlong, _llp]

    lib.hg_traverse_from_kmer.restype = ctypes.c_longlong
    lib.hg_traverse_from_kmer.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, _u64p, ctypes.c_int64,
        _u64p, ctypes.c_longlong]

    lib.hg_median_counts.restype = None
    lib.hg_median_counts.argtypes = [
        ctypes.c_int, _u8pp, _u64p, ctypes.c_int, ctypes.c_int,
        _u8p, _i64p, _i64p, ctypes.c_longlong, _i32p, _f32p, _f32p]

    lib.hg_hash_dense.restype = ctypes.c_longlong
    lib.hg_hash_dense.argtypes = [
        _u8p, ctypes.c_longlong, _i32p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, _u64p]

    lib.hg_hash_dense_reads.restype = ctypes.c_longlong
    lib.hg_hash_dense_reads.argtypes = [
        _u8p, _i64p, _i64p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, _u64p]


def available():
    return _load() is not None


def mode():
    return os.environ.get("KHMER_TPU_ENGINE", "auto")


def use_host_for(sketch, op="graph"):
    """Dispatch decision for one sketch + operation family."""
    m = mode()
    if m == "device":
        return False
    if not available():
        return False
    if getattr(sketch, "mesh", None) is not None:
        return False  # mesh-sharded facade: stay on the device tier
    if sketch.storage_kind not in KIND:
        return False
    if op in ("graph", "diginorm", "trim") and \
            sketch.hash_family != "twobit":
        return False
    if op == "murmur" and sketch.hash_family != "murmur":
        return False
    return True


def n_threads():
    try:
        return max(1, int(os.environ.get("KHMER_TPU_HOST_THREADS",
                                         os.cpu_count() or 1)))
    except ValueError:
        return 1


# ----------------------------------------------------------------------
# marshalling helpers

def _tables_args(sketch):
    """(writable host tables kept alive, u8** array, primes array)."""
    tabs = sketch.host_tables()
    ptrs = (_u8p * len(tabs))(*[t.ctypes.data_as(_u8p) for t in tabs])
    primes = np.asarray(sketch._primes, dtype=np.uint64)
    return tabs, ptrs, primes.ctypes.data_as(_u64p), primes


def _view_args(sketch):
    """Read-only variant (device copy kept)."""
    tabs = sketch.host_view()
    ptrs = (_u8p * len(tabs))(*[t.ctypes.data_as(_u8p) for t in tabs])
    primes = np.asarray(sketch._primes, dtype=np.uint64)
    return tabs, ptrs, primes.ctypes.data_as(_u64p), primes


def _arr(a, ptr_t):
    return np.ascontiguousarray(a).ctypes.data_as(ptr_t)


def hash_dense(codes, starts, nfill, k, hash_family):
    """Dense canonical window hashes of a FlatPacker chunk, in stream
    order (native hg_hash_dense; None when the library is unavailable).

    `starts` are the ascending read-start offsets (int32, pad entries
    >= nfill ignored); boundary-spanning windows are skipped, so the
    result has one hash per real k-mer — the zero-padding-tax input for
    the device tier's dense consume path.
    """
    lib = _load()
    if lib is None:
        return None
    family = 0 if hash_family == "twobit" else 1
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    out = np.empty(max(int(nfill), 1), dtype=np.uint64)
    n = lib.hg_hash_dense(
        codes.ctypes.data_as(_u8p), int(nfill),
        starts.ctypes.data_as(_i32p), len(starts),
        int(k), family, out.ctypes.data_as(_u64p))
    return out[:n]


def hash_dense_reads(codes, offs, lens, k, hash_family):
    """Dense canonical hashes for a native-parser block, in read order
    (one C call per block; None when the library is unavailable)."""
    lib = _load()
    if lib is None:
        return None
    family = 0 if hash_family == "twobit" else 1
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.empty(max(int(lens.sum()), 1), dtype=np.uint64)
    n = lib.hg_hash_dense_reads(
        codes.ctypes.data_as(_u8p), offs.ctypes.data_as(_i64p),
        lens.ctypes.data_as(_i64p), len(lens),
        int(k), family, out.ctypes.data_as(_u64p))
    return out[:n]


def _sorted_u64(seq):
    a = np.fromiter(seq, np.uint64, len(seq)) if not isinstance(
        seq, np.ndarray) else np.asarray(seq, np.uint64)
    a = np.sort(a)
    return a


def _sorted_cached(graph, attr):
    """Sorted-array view of a graph's tag/stoptag SET, cached until the
    set's identity or size changes (the sets only grow in place or get
    replaced wholesale).  Knot detection calls traverse_from_kmer once
    per tag while stop_tags grows into the hundreds of thousands — a
    fresh fromiter+sort per call turned O(n) walks O(n^2)."""
    s = getattr(graph, attr)
    cache = getattr(graph, "_sorted_cache", None)
    if cache is None:
        cache = graph._sorted_cache = {}
    hit = cache.get(attr)
    if hit is not None and hit[0] is s and hit[1] == len(s):
        return hit[2]
    arr = _sorted_u64(s)
    cache[attr] = (s, len(s), arr)
    return arr


class NativeSet:
    """Owning wrapper around the native u64 set."""

    def __init__(self, init=None, hint=64):
        self._lib = _load()
        self._h = self._lib.hg_set_create(int(hint))
        if init is not None and len(init):
            self.add_many(init)

    def add_many(self, values):
        a = np.fromiter(values, np.uint64, len(values)) if not \
            isinstance(values, np.ndarray) else np.asarray(values,
                                                           np.uint64)
        a = np.ascontiguousarray(a)
        self._lib.hg_set_add(self._h, a.ctypes.data_as(_u64p), len(a))

    def __len__(self):
        return int(self._lib.hg_set_size(self._h))

    def export(self):
        n = len(self)
        out = np.empty(n, dtype=np.uint64)
        got = self._lib.hg_set_export(self._h, out.ctypes.data_as(_u64p),
                                      n)
        assert got == n
        return out

    def close(self):
        if self._h:
            self._lib.hg_set_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ----------------------------------------------------------------------
# record packing: flat (codes, starts, ends) from various sources

def pack_records(records, keep_records=False):
    """Pack parsed records into flat code arrays.

    Returns (codes u8, starts i64, ends i64, records-or-None).
    """
    from khmer_tpu.ops import hashing as H

    seqs = []
    kept = [] if keep_records else None
    for rec in records:
        seqs.append(rec.cleaned_seq)
        if keep_records:
            kept.append(rec)
    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    ends = np.cumsum(lens)
    starts = ends - lens
    codes = np.empty(int(ends[-1]) if n else 0, dtype=np.uint8)
    for s, st in zip(seqs, starts):
        codes[st:st + len(s)] = H.encode_dna(s)
    return codes, starts, ends, kept


def iter_packed_source(source, chunk_bases=1 << 24):
    """Yield (codes, starts, ends, n_records) chunks from a file path or
    record iterable, preferring the native parser for paths."""
    if isinstance(source, str):
        from khmer_tpu.io import native as ionat

        if ionat.available():
            for codes, meta, _names in ionat.pack_blocks(source):
                starts = np.ascontiguousarray(meta[:, 0])
                ends = np.ascontiguousarray(meta[:, 0] + meta[:, 1])
                yield codes, starts, ends, len(meta)
            return
    from khmer_tpu.core import pipeline

    batch = []
    total = 0
    for rec in pipeline.records_from(source):
        batch.append(rec)
        total += len(rec.cleaned_seq)
        if total >= chunk_bases:
            codes, starts, ends, _ = pack_records(batch)
            yield codes, starts, ends, len(batch)
            batch = []
            total = 0
    if batch:
        codes, starts, ends, _ = pack_records(batch)
        yield codes, starts, ends, len(batch)


# ----------------------------------------------------------------------
# high-level operations

def consume_seqfile(sketch, source):
    """Plain counting consume on the host tier (twobit or murmur
    family).  Returns (total_reads, n_consumed)."""
    lib = _load()
    kind = KIND[sketch.storage_kind]
    tabs, ptrs, primes_p, _keep = _tables_args(sketch)
    k = sketch.ksize()
    uq = ctypes.c_uint64(0)
    oc = ctypes.c_uint64(0)
    total_reads = 0
    n_consumed = 0
    track_sat = 1 if (getattr(sketch, "_use_bigcount", False)
                      and sketch.storage_kind == "byte") else 0
    for codes, starts, ends, n in iter_packed_source(source):
        total_reads += n
        sat_cap = len(codes) + 16
        sat = np.empty(sat_cap, dtype=np.uint64) if track_sat else \
            np.empty(1, dtype=np.uint64)
        sat_n = ctypes.c_longlong(0)
        args = (kind, ptrs, primes_p, len(tabs), k,
                _arr(codes, _u8p), _arr(starts, _i64p), _arr(ends, _i64p),
                n, track_sat, sat.ctypes.data_as(_u64p),
                sat_cap if track_sat else 1, ctypes.byref(sat_n),
                ctypes.byref(uq), ctypes.byref(oc))
        if sketch.hash_family == "twobit":
            got = lib.hg_consume_block(
                kind, ptrs, primes_p, len(tabs), k,
                _arr(codes, _u8p), _arr(starts, _i64p),
                _arr(ends, _i64p), n, 0, 0, None, None,
                track_sat, sat.ctypes.data_as(_u64p),
                sat_cap if track_sat else 1, ctypes.byref(sat_n),
                ctypes.byref(uq), ctypes.byref(oc))
        else:
            got = lib.hg_consume_block_murmur(*args)
        if got < 0:
            raise RuntimeError("host consume saturation overflow")
        n_consumed += int(got)
        for h in sat[:sat_n.value]:
            sketch._bigcount_add(int(h), 1)
    _bump_unique(sketch, int(uq.value))
    return total_reads, n_consumed


def consume_seqfile_and_tag(graph, source):
    """Tagging consume on the host tier (reference
    hashgraph.cc:279-320).  Returns (total_reads, n_consumed)."""
    lib = _load()
    kind = KIND[graph.storage_kind]
    tabs, ptrs, primes_p, _keep = _tables_args(graph)
    k = graph.ksize()
    density = graph._tag_density
    tags = NativeSet(init=_sorted_u64(graph.all_tags),
                     hint=max(64, len(graph.all_tags)))
    uq = ctypes.c_uint64(0)
    oc = ctypes.c_uint64(0)
    sat_n = ctypes.c_longlong(0)
    track_sat = 1 if (getattr(graph, "_use_bigcount", False)
                      and graph.storage_kind == "byte") else 0
    total_reads = 0
    n_consumed = 0
    for codes, starts, ends, n in iter_packed_source(source):
        total_reads += n
        sat_cap = (len(codes) + 16) if track_sat else 1
        sat = np.empty(sat_cap, dtype=np.uint64)
        got = lib.hg_consume_block(
            kind, ptrs, primes_p, len(tabs), k,
            _arr(codes, _u8p), _arr(starts, _i64p), _arr(ends, _i64p),
            n, 1, density, ctypes.c_void_p(tags._h), None,
            track_sat, sat.ctypes.data_as(_u64p), sat_cap,
            ctypes.byref(sat_n), ctypes.byref(uq), ctypes.byref(oc))
        if got < 0:
            raise RuntimeError("host consume saturation overflow")
        n_consumed += int(got)
        for h in sat[:sat_n.value]:
            graph._bigcount_add(int(h), 1)
    graph.all_tags = set(int(t) for t in tags.export())
    tags.close()
    _bump_unique(graph, int(uq.value))
    return total_reads, n_consumed


def _bump_unique(sketch, delta):
    if delta:
        sketch._n_unique = np.uint64(int(sketch._n_unique) + delta)


def find_all_tags_range(graph, starts, break_on_stop_tags,
                        stop_big_traversals, count_range=None,
                        counting=None):
    """find_all_tags for many start tags (canonical hashes) at once.

    Returns a list of sorted numpy arrays, one per start — identical to
    per-tag sequential reference runs (subset.cc:213-300).
    """
    lib = _load()
    kind = KIND[graph.storage_kind]
    tabs, ptrs, primes_p, _keep = _view_args(graph)
    k = graph.ksize()
    tags_sorted = _sorted_cached(graph, "all_tags")
    stops_sorted = _sorted_cached(graph, "stop_tags")
    sarr = np.ascontiguousarray(np.asarray(starts, dtype=np.uint64))
    n = len(sarr)
    if count_range is not None:
        cg = counting if counting is not None else graph
        ctabs, cptrs, cprimes_p, _ck = _view_args(cg)
        ckind = KIND[cg.storage_kind]
        use_range, cmin, cmax = 1, int(count_range[0]), int(count_range[1])
    else:
        ctabs, cptrs, cprimes_p = tabs, ptrs, primes_p
        ckind, use_range, cmin, cmax = kind, 0, 0, 0
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    cap = max(1024, 8 * n)
    while True:
        out = np.empty(cap, dtype=np.uint64)
        got = lib.hg_find_all_tags_range(
            kind, ptrs, primes_p, len(tabs),
            ckind, cptrs, cprimes_p, len(ctabs),
            k, _arr(tags_sorted, _u64p), len(tags_sorted),
            _arr(stops_sorted, _u64p), len(stops_sorted),
            _arr(sarr, _u64p), n,
            1 if break_on_stop_tags else 0,
            1 if stop_big_traversals else 0,
            graph._tag_density,
            use_range, cmin, cmax, n_threads(),
            out.ctypes.data_as(_u64p), cap,
            out_offsets.ctypes.data_as(_i64p))
        if got >= 0:
            break
        cap = -got
    return [out[out_offsets[i]:out_offsets[i + 1]] for i in range(n)]


def diginorm_window(graph, codes, starts, ends, bundle_offsets, cutoff):
    """Sequential-exact diginorm over one window of bundles.

    Mutates the graph's host tables in place; returns keep flags per
    bundle (uint8 array).
    """
    lib = _load()
    kind = KIND[graph.storage_kind]
    tabs, ptrs, primes_p, _keep = _tables_args(graph)
    k = graph.ksize()
    nb = len(bundle_offsets) - 1
    keep = np.zeros(nb, dtype=np.uint8)
    uq = ctypes.c_uint64(0)
    oc = ctypes.c_uint64(0)
    lib.hg_diginorm(
        kind, ptrs, primes_p, len(tabs), k,
        _arr(codes, _u8p), _arr(starts, _i64p), _arr(ends, _i64p),
        _arr(bundle_offsets, _i64p), nb, int(cutoff),
        keep.ctypes.data_as(_u8p), ctypes.byref(uq), ctypes.byref(oc))
    _bump_unique(graph, int(uq.value))
    return keep


def trim1_window(graph, codes, starts, ends, bundle_offsets, cutoff,
                 trim_cov, digi_cov):
    """trim-low-abund pass-1 over one window of bundles.

    Returns (branch i32 per bundle, trim_at i32 per read)."""
    lib = _load()
    kind = KIND[graph.storage_kind]
    tabs, ptrs, primes_p, _keep = _tables_args(graph)
    k = graph.ksize()
    nb = len(bundle_offsets) - 1
    branch = np.zeros(nb, dtype=np.int32)
    trim_at = np.zeros(len(starts), dtype=np.int32)
    uq = ctypes.c_uint64(0)
    oc = ctypes.c_uint64(0)
    lib.hg_trim1(
        kind, ptrs, primes_p, len(tabs), k,
        _arr(codes, _u8p), _arr(starts, _i64p), _arr(ends, _i64p),
        _arr(bundle_offsets, _i64p), nb, int(cutoff), int(trim_cov),
        -1 if digi_cov is None else int(digi_cov),
        branch.ctypes.data_as(_i32p), trim_at.ctypes.data_as(_i32p),
        ctypes.byref(uq), ctypes.byref(oc))
    _bump_unique(graph, int(uq.value))
    return branch, trim_at


def trim_filter(graph, codes, starts, ends, cutoff,
                variable_coverage=False, normalize_to=20):
    """Read-only trim positions (filter-abund); -1 for reads < k."""
    lib = _load()
    kind = KIND[graph.storage_kind]
    tabs, ptrs, primes_p, _keep = _view_args(graph)
    k = graph.ksize()
    trim_at = np.zeros(len(starts), dtype=np.int32)
    lib.hg_trim_filter(
        kind, ptrs, primes_p, len(tabs), k,
        _arr(codes, _u8p), _arr(starts, _i64p), _arr(ends, _i64p),
        len(starts), int(cutoff), 1 if variable_coverage else 0,
        int(normalize_to), trim_at.ctypes.data_as(_i32p))
    return trim_at


def abundance_distribution(main, source, tracking):
    """Host-tier abundance histogram (hashtable.cc:451-502 semantics,
    tracking-table dedup in stream order, bigcount re-binning).
    Returns a list of MAX_BIGCOUNT+1 ints."""
    lib = _load()
    mt, mptrs, mprimes_p, _mk = _view_args(main)
    tt, tptrs, tprimes_p, _tk = _tables_args(tracking)
    dist = np.zeros(65536 + 1, dtype=np.uint64)
    sat_all = []
    for codes, starts, ends, n in iter_packed_source(source):
        # at most one first-seen saturated k-mer per window of the
        # chunk, so len(codes) slots can never overflow
        cap = len(codes) + 16
        sat = np.empty(cap, dtype=np.uint64)
        got = lib.hg_abund_dist(
            KIND[main.storage_kind], mptrs, mprimes_p, len(mt),
            KIND[tracking.storage_kind], tptrs, tprimes_p, len(tt),
            main.ksize(), _arr(codes, _u8p), _arr(starts, _i64p),
            _arr(ends, _i64p), n,
            dist.ctypes.data_as(_u64p),
            sat.ctypes.data_as(_u64p), cap)
        assert got >= 0
        sat_all.extend(int(h) for h in sat[:got])
    if getattr(main, "_use_bigcount", False) and main._bigcounts:
        for h in sat_all:
            nn = main._bigcounts.get(h, 255)
            if nn != 255:
                dist[255] -= 1
                dist[nn] += 1
    return [int(x) for x in dist[:65536]]


def add_hashes(sketch, hashes):
    """Sequential-exact adds of pre-hashed canonical k-mers against the
    host table mirror; returns the number of new k-mers."""
    lib = _load()
    kind = KIND[sketch.storage_kind]
    tabs, ptrs, primes_p, _keep = _tables_args(sketch)
    h = np.ascontiguousarray(np.asarray(hashes, dtype=np.uint64))
    uq = ctypes.c_uint64(0)
    oc = ctypes.c_uint64(0)
    track_sat = 1 if (getattr(sketch, "_use_bigcount", False)
                      and sketch.storage_kind == "byte") else 0
    sat_cap = (len(h) + 16) if track_sat else 1
    sat = np.empty(sat_cap, dtype=np.uint64)
    sat_n = ctypes.c_longlong(0)
    got = lib.hg_add_hashes(
        kind, ptrs, primes_p, len(tabs), _arr(h, _u64p), len(h),
        ctypes.byref(uq), ctypes.byref(oc),
        track_sat, sat.ctypes.data_as(_u64p), sat_cap,
        ctypes.byref(sat_n))
    if got < 0:
        raise RuntimeError("saturation overflow")
    for hh in sat[:sat_n.value]:
        sketch._bigcount_add(int(hh), 1)
    _bump_unique(sketch, int(uq.value))
    return int(got)


def per_table_counts(sketch, hashes):
    """[n_tables, n] per-table raw counts off the host mirror (the
    repartition HCK evaluation needs per-table values, not the min)."""
    tabs = sketch.host_view()
    h = np.asarray(hashes, dtype=np.uint64).ravel()
    out = np.zeros((len(tabs), len(h)), dtype=np.uint16)
    for t, (tab, p) in enumerate(zip(tabs, sketch._primes)):
        bins = h % np.uint64(p)
        if sketch.storage_kind == "byte":
            out[t] = tab[bins.astype(np.int64)]
        elif sketch.storage_kind == "bit":
            byte = tab[(bins >> np.uint64(3)).astype(np.int64)]
            out[t] = (byte >> (bins & np.uint64(7)).astype(np.uint8)) & 1
        else:
            byte = tab[(bins >> np.uint64(1)).astype(np.int64)]
            odd = (bins & np.uint64(1)).astype(bool)
            out[t] = np.where(odd, byte & 0x0F, byte >> 4)
    return out


def sweep_for_tags(graph, seq, sweep_range, break_on_stop_tags,
                   stop_big_traversals):
    """Perimeter tag sweep on the host tier (subset.cc:305-394).

    Returns (tagged_set, total_traversed)."""
    from khmer_tpu.ops import hashing as H

    lib = _load()
    kind = KIND[graph.storage_kind]
    tabs, ptrs, primes_p, _keep = _view_args(graph)
    tags_sorted = _sorted_cached(graph, "all_tags")
    stops_sorted = _sorted_cached(graph, "stop_tags")
    codes = np.ascontiguousarray(H.encode_dna(seq))
    total = ctypes.c_longlong(0)
    cap = max(1024, len(tags_sorted))
    while True:
        out = np.empty(cap, dtype=np.uint64)
        got = lib.hg_sweep_for_tags(
            kind, ptrs, primes_p, len(tabs), graph.ksize(),
            _arr(codes, _u8p), len(codes), int(sweep_range),
            1 if break_on_stop_tags else 0,
            1 if stop_big_traversals else 0,
            _arr(tags_sorted, _u64p), len(tags_sorted),
            _arr(stops_sorted, _u64p), len(stops_sorted),
            out.ctypes.data_as(_u64p), cap, ctypes.byref(total))
        if got >= 0:
            break
        cap = -got
    return set(int(t) for t in out[:got]), int(total.value)


def traverse_from_kmer(graph, start_canon, radius=None, max_count=0,
                       threshold=0, keeper=None):
    """Bounded BFS on the host tier (hashgraph.cc:503-570 semantics).

    Returns (count, keeper_set)."""
    lib = _load()
    kind = KIND[graph.storage_kind]
    tabs, ptrs, primes_p, _keep = _view_args(graph)
    stops = _sorted_cached(graph, "stop_tags")
    cap = 4096
    while True:
        out = np.empty(cap, dtype=np.uint64)
        got = lib.hg_traverse_from_kmer(
            kind, ptrs, primes_p, len(tabs), graph.ksize(),
            int(start_canon),
            -1 if radius is None else int(radius), int(max_count),
            int(threshold), _arr(stops, _u64p), len(stops),
            out.ctypes.data_as(_u64p), cap)
        if got >= 0:
            break
        cap = max(cap * 4, -got)
    found = set(int(v) for v in out[:got])
    if keeper is not None:
        keeper.update(found)
        return int(got), keeper
    return int(got), found


def host_neighbors_batch(graph, f_arr, r_arr):
    """(nf, nr, ncanon, present) via numpy against the host table
    mirror — the zero-dispatch analog of graphmixin.neighbors_batch
    for the per-node traversal paths (sweep_for_tags etc.)."""
    k = graph.ksize()
    tabs = graph.host_view()
    primes = graph._primes
    kind = graph.storage_kind
    f = np.asarray(f_arr, dtype=np.uint64).reshape(-1, 1)
    r = np.asarray(r_arr, dtype=np.uint64).reshape(-1, 1)
    bitmask = np.uint64((1 << (2 * k)) - 1) if k < 32 else \
        np.uint64(0xFFFFFFFFFFFFFFFF)
    shift = np.uint64(2 * k - 2)
    b = np.arange(4, dtype=np.uint64)[None, :]
    comp_b = b ^ np.uint64(1)
    rf = ((f << np.uint64(2)) | b) & bitmask
    rr = (r >> np.uint64(2)) | (comp_b << shift)
    lf = (f >> np.uint64(2)) | (b << shift)
    lr = ((r << np.uint64(2)) | comp_b) & bitmask
    nf = np.concatenate([rf, lf], axis=1)
    nr = np.concatenate([rr, lr], axis=1)
    nc = np.minimum(nf, nr)
    present = np.ones(nc.shape, bool)
    flat = nc.ravel()
    for t, p in zip(tabs, primes):
        bins = flat % np.uint64(p)
        if kind == "bit":
            byte = t[(bins >> np.uint64(3)).astype(np.int64)]
            bit = (byte >> (bins & np.uint64(7)).astype(np.uint8)) & 1
            present &= (bit != 0).reshape(nc.shape)
        elif kind == "byte":
            present &= (t[bins.astype(np.int64)] != 0).reshape(nc.shape)
        else:  # nibble
            byte = t[(bins >> np.uint64(1)).astype(np.int64)]
            odd = (bins & np.uint64(1)).astype(bool)
            nib = np.where(odd, byte & 0x0F, byte >> 4)
            present &= (nib != 0).reshape(nc.shape)
    return nf, nr, nc, present


def median_counts(graph, codes, starts, ends):
    """(median, average, stddev) per read (hashtable.cc:299-328);
    median -1 marks reads shorter than k."""
    lib = _load()
    kind = KIND[graph.storage_kind]
    tabs, ptrs, primes_p, _keep = _view_args(graph)
    k = graph.ksize()
    n = len(starts)
    med = np.zeros(n, dtype=np.int32)
    avg = np.zeros(n, dtype=np.float32)
    std = np.zeros(n, dtype=np.float32)
    lib.hg_median_counts(
        kind, ptrs, primes_p, len(tabs), k,
        _arr(codes, _u8p), _arr(starts, _i64p), _arr(ends, _i64p), n,
        med.ctypes.data_as(_i32p), avg.ctypes.data_as(_f32p),
        std.ctypes.data_as(_f32p))
    return med, avg, std


class LabeledTagConsumer:
    """Per-read tagged consume with found-tag capture — the labels
    path (reference labelhash.cc:216-307 tags exactly like
    consume_sequence_and_tag and links every hit/placed tag to the
    read's label).  Holds a persistent native tag set across reads;
    call finish() to write tags/n_unique back to the graph."""

    def __init__(self, graph):
        self.graph = graph
        self._lib = _load()
        self._tabs, self._ptrs, self._primes_p, self._pk = \
            _tables_args(graph)
        self._kind = KIND[graph.storage_kind]
        self._k = graph.ksize()
        self._tags = NativeSet(init=_sorted_u64(graph.all_tags),
                               hint=max(64, len(graph.all_tags)))
        self._found = NativeSet(hint=64)
        self._uq = ctypes.c_uint64(0)
        self._oc = ctypes.c_uint64(0)
        self._sat_n = ctypes.c_longlong(0)
        self._sat = np.empty(1, dtype=np.uint64)
        self._track_sat = 0
        if getattr(graph, "_use_bigcount", False) and \
                graph.storage_kind == "byte":
            self._track_sat = 1

    def consume_read(self, seq):
        """Returns (n_consumed_new, found_tag_array)."""
        from khmer_tpu.ops import hashing as H

        codes = np.ascontiguousarray(H.encode_dna(seq))
        starts = np.zeros(1, dtype=np.int64)
        ends = np.asarray([len(codes)], dtype=np.int64)
        self._lib.hg_set_clear(self._found._h)
        sat_cap = (len(codes) + 16) if self._track_sat else 1
        sat = np.empty(sat_cap, dtype=np.uint64)
        got = self._lib.hg_consume_block(
            self._kind, self._ptrs, self._primes_p, len(self._tabs),
            self._k, _arr(codes, _u8p), _arr(starts, _i64p),
            _arr(ends, _i64p), 1, 1, self.graph._tag_density,
            ctypes.c_void_p(self._tags._h),
            ctypes.c_void_p(self._found._h),
            self._track_sat, sat.ctypes.data_as(_u64p), sat_cap,
            ctypes.byref(self._sat_n), ctypes.byref(self._uq),
            ctypes.byref(self._oc))
        for h in sat[: self._sat_n.value]:
            self.graph._bigcount_add(int(h), 1)
        return int(got), self._found.export()

    def finish(self):
        self.graph.all_tags = set(int(t) for t in self._tags.export())
        _bump_unique(self.graph, int(self._uq.value))
        self._tags.close()
        self._found.close()


class NativeNormalizer:
    """Window-batched exact diginorm on the host tier (drop-in for
    core.diginorm_scan.ScanNormalizer)."""

    def __init__(self, countgraph, desired_coverage, window=None):
        if countgraph.storage_kind not in KIND:
            raise ValueError("native normalizer needs bit/byte/nibble "
                             "storage")
        if countgraph.hash_family != "twobit":
            raise ValueError("native normalizer needs the 2-bit hash")
        self.graph = countgraph
        self.C = int(desired_coverage)

    def process_window(self, bundles):
        n = len(bundles)
        out = [[] for _ in range(n)]
        if n == 0:
            return out
        recs = []
        bundle_offsets = np.zeros(n + 1, dtype=np.int64)
        for i, b in enumerate(bundles):
            recs.extend(b)
            bundle_offsets[i + 1] = len(recs)
        codes, starts, ends, _ = pack_records(recs)
        keep = diginorm_window(self.graph, codes, starts, ends,
                               bundle_offsets, self.C)
        for i in range(n):
            if keep[i]:
                out[i] = list(bundles[i])
        return out

    def finalize(self):
        # host tables are authoritative already; nothing to flush
        pass


class NativeTrimmer:
    """trim-low-abund pass-1 engine on the host tier (drop-in for
    core.diginorm_scan.ScanTrimmerState)."""

    def __init__(self, graph, cutoff, trim_cov, digi_cov=None,
                 window=None):
        if graph.storage_kind not in KIND or \
                graph.hash_family != "twobit":
            raise ValueError("native trimmer needs 2-bit hash and "
                             "bit/byte/nibble storage")
        self.graph = graph
        self.cutoff = int(cutoff)
        self.trim_cov = int(trim_cov)
        self.digi_cov = digi_cov

    def process_window(self, bundles):
        n = len(bundles)
        recs = []
        bundle_offsets = np.zeros(n + 1, dtype=np.int64)
        for i, b in enumerate(bundles):
            recs.extend(b[:2])
            bundle_offsets[i + 1] = len(recs)
        codes, starts, ends, _ = pack_records(recs)
        branch, flat_trim = trim1_window(
            self.graph, codes, starts, ends, bundle_offsets,
            self.cutoff, self.trim_cov, self.digi_cov)
        # reshape per-bundle [n, 2] like the device engine
        trim_at = np.zeros((n, 2), dtype=np.int32)
        for i in range(n):
            for j in range(min(2, bundle_offsets[i + 1]
                               - bundle_offsets[i])):
                trim_at[i, j] = flat_trim[bundle_offsets[i] + j]
        return branch, trim_at

    def finalize(self):
        pass

    def reload(self):
        pass


def hll_consume(registers, p, k, source):
    """Stream a file through the native HLL ingester; returns
    (total_reads, n_consumed).  registers is mutated in place.

    Reads fan out over KHMER_TPU_HOST_THREADS host threads, each
    filling a private register set (the ctypes call releases the GIL);
    register max-merge is order-independent, so the estimate is
    bit-identical to the sequential pass — the same property the
    multihost DCN merge relies on (parallel/multihost.max_registers).
    """
    import threading

    lib = _load()
    nt = n_threads()
    total_reads = 0
    n_consumed = 0
    priv = [np.zeros_like(registers) for _ in range(nt - 1)]
    for codes, starts, ends, n in iter_packed_source(source):
        total_reads += n
        if nt == 1 or n < 2:
            n_consumed += int(lib.hg_hll_consume(
                int(k), int(p), registers.ctypes.data_as(_u8p),
                _arr(codes, _u8p), _arr(starts, _i64p),
                _arr(ends, _i64p), n))
            continue
        codes_p = _arr(codes, _u8p)
        starts_c = np.ascontiguousarray(starts, dtype=np.int64)
        ends_c = np.ascontiguousarray(ends, dtype=np.int64)
        counts = [0] * nt

        def work(t, regs):
            lo = t * n // nt
            hi = (t + 1) * n // nt
            counts[t] = int(lib.hg_hll_consume(
                int(k), int(p), regs.ctypes.data_as(_u8p), codes_p,
                starts_c[lo:hi].ctypes.data_as(_i64p),
                ends_c[lo:hi].ctypes.data_as(_i64p), hi - lo))

        threads = [threading.Thread(target=work,
                                    args=(t + 1, priv[t]))
                   for t in range(nt - 1)]
        for th in threads:
            th.start()
        work(0, registers)
        for th in threads:
            th.join()
        n_consumed += sum(counts)
    for regs in priv:
        np.maximum(registers, regs, out=registers)
    return total_reads, n_consumed
