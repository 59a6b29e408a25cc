"""Host->device streaming pipeline: pack reads, hash, commit batches.

This is the batched replacement for the reference's threaded
consume_seqfile loop (src/oxli/hashtable.cc:125-274): instead of N
pthreads hammering shared tables with atomics, reads are packed on host
into fixed-shape [B, L] 2-bit code tensors (shape-bucketed to bound
recompilation), hashed on device with vectorized rolling/murmur kernels,
and committed through the exact batched update pipeline in sketch_kernels.

Batches are committed strictly in stream order, so path-dependent
statistics (n_unique_kmers, bigcount) match the reference's sequential
semantics exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from khmer_tpu.core import sketch_kernels as K
from khmer_tpu.ops import hashing as H

# default batch geometry
TARGET_KMERS = 1 << 19
MAX_ROW_LEN = 4096
_L_LADDER = [64, 128, 256, 512, 1024, 2048, 4096]

# flat-stream pipeline chunk: one fixed shape for the whole run
FLAT_CHUNK = 1 << 21
FLAT_MAX_READS = FLAT_CHUNK // 8

# dense-stream pipeline chunk: pre-hashed k-mers per device step
DENSE_CHUNK = 1 << 20


class FlatPacker:
    """Pack cleaned reads back-to-back into fixed-size 1-D code chunks.

    Fixed shape: a single [FLAT_CHUNK] uint8 code buffer plus the read
    start offsets; windows spanning read boundaries are masked on
    device. One compiled shape serves the entire stream (the [B, L]
    row format recompiles per shape and wastes padding).

    A read that does not fit in the remaining space is split: the next
    chunk starts with the last k-1 bases (same implicit read id 0 =
    "continuation"), so every k-window is produced exactly once, in
    stream order.
    """

    def __init__(self, k, chunk=FLAT_CHUNK, track_segments=False):
        self.k = k
        self.chunk = chunk
        self._codes = np.zeros(chunk, dtype=np.uint8)
        self._starts = []
        self._fill = 0
        # optional per-read window segments: (win_offset, n_windows,
        # is_continuation) per chunk, for host passes that need per-read
        # grouping (tagging)
        self.track_segments = track_segments
        self._segments = []

    def add(self, seq):
        """Add one cleaned sequence. Returns a list of full chunks."""
        return self.add_codes(H.encode_dna(seq))

    def add_codes(self, codes):
        """Add one read's 2-bit codes (native-parser fast path)."""
        k = self.k
        out = []
        n = len(codes)
        if n < k:
            return out
        pos = 0  # next window start still to be produced
        while n - pos >= k:
            space = self.chunk - self._fill
            if space < k:
                out.append(self._flush_full())
                continue
            take = min(n - pos, space)
            if pos == 0:
                # new read: start marker (continuations re-enter at
                # offset 0 of a fresh chunk with no marker -> rid 0)
                self._starts.append(self._fill)
            if self.track_segments:
                self._segments.append((self._fill, take - k + 1,
                                       pos > 0))
            self._codes[self._fill:self._fill + take] = \
                codes[pos:pos + take]
            self._fill += take
            if pos + take == n:
                break
            # chunk full mid-read: flush and continue with k-1 overlap
            out.append(self._flush_full())
            pos = pos + take - (k - 1)
        if self.chunk - self._fill < k:
            out.append(self._flush_full())
        return out

    def _flush_full(self):
        b = self.flush()
        assert b is not None
        return b

    def flush_ladder(self, min_size=1 << 18):
        """Flush the tail as ONE size-quantized chunk.

        A partial final chunk padded to the full FLAT_CHUNK pays
        scatter cost per padded window: a 60%-full tail wastes 40% of
        the kernel. Splitting the tail into several steps would add
        dispatches and compiled shapes instead, so the tail stays a
        SINGLE step: emit one chunk whose length is the
        smallest multiple of ``min_size`` (power of two below it) that
        holds the fill. Padding waste is bounded by min_size/fill and
        the compiled-shape count by chunk/min_size + log2(min_size).

        Returns a list of (codes, starts, nfill) (empty or one entry).
        """
        if self.track_segments:
            raise RuntimeError("ladder flush does not track segments")
        if self._fill == 0:
            return []
        fill = self._fill
        if fill >= self.chunk:
            return [self._flush_full()]
        size = min_size
        if fill <= min_size:
            # small tail: power-of-two ladder below min_size
            while size // 2 >= max(fill, 2 * self.k):
                size //= 2
        else:
            size = ((fill + min_size - 1) // min_size) * min_size
        starts = np.asarray(self._starts, dtype=np.int64)
        pstarts = np.full(FLAT_MAX_READS, self.chunk, dtype=np.int32)
        pstarts[: len(starts)] = starts
        piece = self._codes[:size].copy()
        self._codes = np.zeros(self.chunk, dtype=np.uint8)
        self._starts = []
        self._fill = 0
        return [(piece, pstarts, fill)]

    def flush(self):
        """(codes[CHUNK], starts[FLAT_MAX_READS], nfill[, segments])."""
        if self._fill == 0:
            return None
        if len(self._starts) > FLAT_MAX_READS:
            raise RuntimeError("too many reads in one chunk")
        starts = np.full(FLAT_MAX_READS, self.chunk, dtype=np.int32)
        starts[: len(self._starts)] = self._starts
        codes = self._codes
        nfill = self._fill
        segments = self._segments
        self._codes = np.zeros(self.chunk, dtype=np.uint8)
        self._starts = []
        self._fill = 0
        self._segments = []
        if self.track_segments:
            return codes, starts, nfill, segments
        return codes, starts, nfill


@functools.lru_cache(maxsize=None)
def make_flat_consume(kind, primes, k, hash_family, with_event_new=False,
                      with_bigcount=False, band=None, mask_kind=None,
                      mask_primes=None, threshold=0, consume_masked=False,
                      chunk=FLAT_CHUNK):
    """One fused jit for the flat-stream hot path: read-boundary masks,
    hashing, optional band/mask filters, sketch update, consumed count.

    step(tables, n_unique, n_consumed, overflow, codes, starts, nfill
         [, mask_tables])
      -> (tables, n_unique, n_consumed, overflow, out)

    `overflow` is the sticky v2 collision-overflow flag (device bool);
    callers thread it through the stream and check it once at the end.
    """
    primes = tuple(int(p) for p in primes)
    if mask_primes is not None:
        mask_primes = tuple(int(p) for p in mask_primes)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(tables, n_unique, n_consumed, overflow, codes, starts, nfill,
             mask_tables=None):
        W = chunk - k + 1
        # read ids from start offsets; windows must stay within one read
        rid = jnp.zeros(chunk, jnp.int32).at[starts].add(1, mode="drop")
        rid = jnp.cumsum(rid)
        valid = (rid[:W] == rid[k - 1:]) & \
            (jnp.arange(W, dtype=jnp.int32) + (k - 1) < nfill)
        hashes = H.hash_windows(codes, k, hash_family)
        if band is not None:
            lo, hi = band
            valid = valid & (hashes >= np.uint64(lo)) \
                & (hashes < np.uint64(hi))
        if mask_kind is not None:
            counts = K._gather_counts(mask_kind, mask_primes, mask_tables,
                                      hashes)
            if consume_masked:
                valid = valid & (counts >= threshold)
            else:
                valid = valid & (counts <= threshold)
        return _update_dispatch(kind, primes, tables, n_unique,
                                n_consumed, overflow, hashes, valid,
                                with_bigcount, with_event_new)

    return step


def _update_dispatch(kind, primes, tables, n_unique, n_consumed, overflow,
                     hashes, valid, with_bigcount, with_event_new):
    """Shared post-hash consume dispatch (flat + dense paths)."""
    W = hashes.shape[0]
    if kind == "blocked":
        from khmer_tpu.core import blocked

        tables, n_unique, overflow, out = blocked.blocked_update_core(
            primes[0], tables, n_unique, overflow, hashes, valid,
            with_event_new)
        if with_event_new:
            out["valid"] = valid
            out["hashes"] = hashes
        n_consumed = n_consumed + jnp.sum(valid).astype(jnp.uint64)
        return tables, n_unique, n_consumed, overflow, out
    if K.use_v2_path(kind, primes, W):
        tables, n_unique, overflow, out = K.v2_update_core(
            primes, tables, n_unique, overflow, hashes, valid,
            with_bigcount, with_event_new)
        if with_event_new:
            out["valid"] = valid
            out["hashes"] = hashes
        n_consumed = n_consumed + jnp.sum(valid).astype(jnp.uint64)
        return tables, n_unique, n_consumed, overflow, out
    if K.use_image_path(kind, primes):
        tables, n_unique, out = K.image_update_outputs(
            primes, tables, n_unique, hashes, valid, with_bigcount,
            with_event_new)
        if with_event_new:
            out["valid"] = valid
            out["hashes"] = hashes
        n_consumed = n_consumed + jnp.sum(valid).astype(jnp.uint64)
        return tables, n_unique, n_consumed, overflow, out
    d = K._dedup_batch(hashes, valid)
    tables, min_old, any_credit = K._apply_update(kind, primes,
                                                  tables, d)
    new_u = d["uvalid"] & any_credit
    n_unique = n_unique + jnp.sum(
        jnp.where(new_u, 1, 0)).astype(jnp.uint64)
    n_consumed = n_consumed + jnp.sum(valid).astype(jnp.uint64)
    out = {}
    M = hashes.shape[0]
    if with_event_new:
        out["event_new"] = jnp.zeros(M, bool).at[
            jnp.where(new_u, d["ufirst"], M)].set(True, mode="drop")
        out["valid"] = valid
        out["hashes"] = hashes
    if with_bigcount:
        triggers = d["ucnt"] - jnp.maximum(K.MAX_KCOUNT - min_old, 0)
        sat = d["uvalid"] & (triggers > 0)
        out["sat_total"] = jnp.sum(sat.astype(jnp.int32))
        slots = min(K.SAT_SLOTS, M)
        sat_idx = jnp.nonzero(sat, size=slots, fill_value=M - 1)[0]
        out["sat_hash"] = jnp.take(d["uh"], sat_idx)
        out["sat_triggers"] = jnp.where(
            jnp.take(sat, sat_idx), jnp.take(triggers, sat_idx), 0)
    return tables, n_unique, n_consumed, overflow, out


def _dense_numpy(codes, starts, nfill, k, hash_family):
    """Numpy fallback for hostengine.hash_dense (same contract).

    Work is bounded at nfill: a ladder-flushed tail ships the full
    pack-chunk buffer with a small fill, and hashing the padding
    would dominate the call."""
    nfill = int(nfill)
    if nfill < k:
        return np.zeros(0, np.uint64)
    codes = np.asarray(codes)[:nfill]
    W = nfill - k + 1
    rid = np.zeros(nfill, np.int32)
    s = np.asarray(starts)
    rid[s[s < nfill]] = 1
    rid = np.cumsum(rid)
    valid = rid[:W] == rid[k - 1:]
    flat = (H.host_hash_windows(codes, k) if hash_family == "twobit"
            else H.host_murmur_hash_windows(codes, k))
    return flat[valid]


def _dense_tail_size(n, chunk, min_size=4096):
    """Smallest ladder size >= n: power of two, refined to three
    mantissa bits (j/16 * 2^e, j in 9..16) — pad waste < 1/9 of the
    tail, compiled shapes bounded at 8 per octave (only sizes actually
    seen compile)."""
    if n >= chunk:
        return chunk
    size = min_size
    while size < n:
        size *= 2
    if size > min_size:
        step = size // 16
        for j in range(9, 16):
            if n <= step * j:
                return step * j
    return size


class DenseHasher:
    """Host side of the dense consume path: reads in, fixed-shape
    chunks of canonical k-mer hashes out — with ZERO invalid entries.

    The windowed flat path ships 2-bit code chunks and masks read-
    boundary/padding windows on device, so every masked window still
    occupies a scatter slot. Hashing on the host (native
    hg_hash_dense; numpy fallback) lets the device receive only real
    k-mers, at 8 bytes each instead of one code byte per base. Host
    hashing overlaps with async device dispatch.

    Stream order is preserved end-to-end, so order-dependent statistics
    (n_unique credit) are bit-identical to the windowed path.
    """

    def __init__(self, k, hash_family, chunk=DENSE_CHUNK,
                 pack_chunk=FLAT_CHUNK):
        self.k = k
        self.family = hash_family
        self.chunk = chunk
        self._packer = FlatPacker(k, chunk=pack_chunk)
        self._buf = np.empty(chunk, np.uint64)
        self._fill = 0

    def _hash(self, flat):
        from khmer_tpu.core import hostengine

        codes, starts, nfill = flat
        dense = hostengine.hash_dense(codes, starts, nfill, self.k,
                                      self.family)
        if dense is None:
            dense = _dense_numpy(codes, starts, nfill, self.k,
                                 self.family)
        return dense

    def _push(self, dense):
        out = []
        n = len(dense)
        pos = 0
        while n - pos > 0:
            take = min(self.chunk - self._fill, n - pos)
            self._buf[self._fill:self._fill + take] = \
                dense[pos:pos + take]
            self._fill += take
            pos += take
            if self._fill == self.chunk:
                out.append((self._buf, self.chunk))
                self._buf = np.empty(self.chunk, np.uint64)
                self._fill = 0
        return out

    def add_codes(self, codes):
        """Add one read's 2-bit codes; returns full (hashes, n) chunks."""
        out = []
        for flat in self._packer.add_codes(codes):
            out.extend(self._push(self._hash(flat)))
        return out

    def add(self, seq):
        return self.add_codes(H.encode_dna(seq))

    def add_block(self, codes, offs, lens):
        """Add a whole native-parser block (one C call, no per-read
        Python); returns full (hashes, n) chunks. Don't interleave with
        per-read add() mid-stream — the packer buffer would reorder."""
        from khmer_tpu.core import hostengine

        dense = hostengine.hash_dense_reads(codes, offs, lens, self.k,
                                            self.family)
        if dense is None:
            out = []
            for o, ln in zip(offs, lens):
                if ln >= self.k:
                    out.extend(self.add_codes(codes[o:o + ln]))
            return out
        return self._push(dense)

    def flush(self):
        """Flush the tail as one ladder-quantized (hashes, n) chunk."""
        flat = self._packer.flush()
        out = []
        if flat is not None:
            out.extend(self._push(self._hash(flat)))
        if self._fill:
            size = _dense_tail_size(self._fill, self.chunk)
            tail = np.zeros(size, np.uint64)
            tail[: self._fill] = self._buf[: self._fill]
            out.append((tail, self._fill))
            self._fill = 0
        return out


@functools.lru_cache(maxsize=None)
def make_dense_consume(kind, primes, with_event_new=False,
                       with_bigcount=False, chunk=DENSE_CHUNK):
    """One jit for the dense consume hot path: pre-hashed k-mers in,
    sketch update out (see DenseHasher).

    step(tables, n_unique, n_consumed, overflow, hashes, nvalid)
      -> (tables, n_unique, n_consumed, overflow, out)
    """
    primes = tuple(int(p) for p in primes)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(tables, n_unique, n_consumed, overflow, hashes, nvalid):
        valid = jnp.arange(chunk, dtype=jnp.int32) < nvalid
        return _update_dispatch(kind, primes, tables, n_unique,
                                n_consumed, overflow, hashes, valid,
                                with_bigcount, with_event_new)

    return step


def consume_chunk_size(kind, primes):
    """Stream chunk size for a sketch.

    The sort-free blocked path (core/blocked.py) is exact at any batch
    size below its scatter-min sentinel, so every layout streams at
    the full flat-chunk size.
    """
    return FLAT_CHUNK


def _bucket_len(n):
    for b in _L_LADDER:
        if n <= b:
            return b
    return MAX_ROW_LEN


def _bucket_rows(n):
    b = 64
    while b < n:
        b *= 2
    return b


class Batcher:
    """Pack cleaned sequences into shape-bucketed [B, L] code batches.

    Long sequences are split into MAX_ROW_LEN chunks overlapping by k-1 so
    every k-window is preserved, in order.
    """

    def __init__(self, k, target_kmers=TARGET_KMERS):
        self.k = k
        self.target = target_kmers
        self._rows = []   # list of (codes np.uint8 [n], n)
        self._kmers = 0
        self._maxlen = 0

    def add(self, seq):
        """Add one cleaned sequence; returns packed batch if full."""
        k = self.k
        n = len(seq)
        if n > MAX_ROW_LEN:
            out = []
            step = MAX_ROW_LEN - (k - 1)
            for s in range(0, n, step):
                chunk = seq[s:s + MAX_ROW_LEN]
                if len(chunk) < k and s > 0:
                    break
                b = self.add(chunk)
                if b is not None:
                    out.append(b)
            return out if out else None
        codes = H.encode_dna(seq)
        self._rows.append(codes)
        self._maxlen = max(self._maxlen, n)
        self._kmers += max(0, n - k + 1)
        if self._kmers >= self.target:
            return self.flush()
        return None

    def flush(self):
        """Pack and clear accumulated rows; None if empty."""
        if not self._rows:
            return None
        L = _bucket_len(max(self._maxlen, self.k))
        B = _bucket_rows(len(self._rows))
        codes = np.zeros((B, L), dtype=np.uint8)
        lengths = np.zeros(B, dtype=np.int32)
        for i, row in enumerate(self._rows):
            codes[i, : len(row)] = row
            lengths[i] = len(row)
        self._rows = []
        self._kmers = 0
        self._maxlen = 0
        return codes, lengths

    def __bool__(self):
        return bool(self._rows)


@functools.lru_cache(maxsize=None)
def make_hash_batch(k, hash_family, with_fr=False):
    """[B, L] codes + [B] lengths -> [B, W] canonical hashes + valid mask."""

    @jax.jit
    def fn(codes, lengths):
        W = codes.shape[-1] - k + 1
        canon, f, r = (H.rolling_hash_windows(codes, k)
                       if hash_family == "twobit"
                       else H.murmur_hash_windows(codes, k))
        win = jnp.arange(W, dtype=jnp.int32)[None, :]
        valid = win <= (lengths[:, None] - k)
        if with_fr:
            return canon, f, r, valid
        return canon, valid

    return fn


def _band_filter(hashes, valid, num_bands, band):
    lo, hi = H.compute_band_interval(num_bands, band)
    return valid & (hashes >= np.uint64(lo)) & (hashes < np.uint64(hi))


@functools.lru_cache(maxsize=None)
def make_mask_filter(mask_kind, mask_primes, threshold, consume_masked):
    """Keep k-mers whose count in the mask table passes the threshold.

    reference: hashtable.cc:175-183 (consume iff count <= threshold, or
    count >= threshold when consume_masked).
    """
    @jax.jit
    def fn(mask_tables, hashes, valid):
        counts = K._gather_counts(mask_kind, mask_primes, mask_tables,
                                  hashes)
        if consume_masked:
            return valid & (counts >= threshold)
        return valid & (counts <= threshold)

    return fn


def records_from(source):
    """Normalize a path / parser / record-iterable into a record iterator."""
    from khmer_tpu.io.fastx import FastxParser

    if isinstance(source, str):
        return FastxParser(source)
    return source


def consume_seqfile(sketch, source, mask=None, threshold=0,
                    consume_masked=False, num_bands=None, band=None,
                    callback=None, callback_every=None):
    """Count every k-mer of every read; returns (n_reads, n_consumed).

    Mirrors Hashtable::consume_seqfile and its _with_mask / _banding
    variants (src/oxli/hashtable.cc:125-274). Uses the flat-stream
    pipeline: one fused jit shape for the whole file.

    Set $KHMER_TPU_TRACE=<logdir> to capture a JAX profiler trace of
    the consume (khmer_tpu.utils.profiling).
    """
    from khmer_tpu.utils.profiling import maybe_trace

    with maybe_trace("consume_seqfile"):
        return _consume_seqfile(sketch, source, mask, threshold,
                                consume_masked, num_bands, band,
                                callback, callback_every)


def _consume_seqfile(sketch, source, mask=None, threshold=0,
                     consume_masked=False, num_bands=None, band=None,
                     callback=None, callback_every=None):
    k = sketch.ksize()
    band_interval = None
    if num_bands:
        band_interval = H.compute_band_interval(num_bands, band)
    chunk = consume_chunk_size(sketch.storage_kind, sketch._primes)
    with_bigcount = (sketch._use_bigcount
                     and sketch.storage_kind == "byte")
    # dense path: host hashes, device updates — zero invalid scatter
    # slots (band/mask variants keep the windowed path, whose device-
    # side hashes feed their filters). KHMER_TPU_ENGINE=device keeps
    # the windowed device-hash path so the device-tier battery
    # (tests/device/) genuinely exercises it — host hashing IS host-
    # tier work.
    import os as _os

    use_dense = (mask is None and band_interval is None
                 and not _os.environ.get("KHMER_TPU_NO_DENSE")
                 and _os.environ.get("KHMER_TPU_ENGINE") != "device")
    steps = {}

    def step_for(size):
        if size not in steps:
            steps[size] = make_flat_consume(
                sketch.storage_kind, sketch._primes, k,
                sketch.hash_family,
                with_bigcount=with_bigcount,
                band=band_interval,
                mask_kind=None if mask is None else mask.storage_kind,
                mask_primes=None if mask is None else mask._primes,
                threshold=int(threshold),
                consume_masked=bool(consume_masked),
                chunk=size)
        return steps[size]

    def dense_step_for(size):
        if size not in steps:
            steps[size] = make_dense_consume(
                sketch.storage_kind, sketch._primes,
                with_bigcount=with_bigcount, chunk=size)
        return steps[size]

    packer = (DenseHasher(k, sketch.hash_family, pack_chunk=chunk)
              if use_dense else FlatPacker(k, chunk=chunk))
    n_reads = 0
    tables = sketch.tables
    n_unique = sketch._n_unique
    n_consumed = jnp.zeros((), jnp.uint64)
    overflow = jnp.zeros((), bool)
    pending_sat = []

    def absorb(out):
        if "satev_total" in out:
            # absorb eagerly so the full-event fallback buffers are
            # released per chunk
            sketch.tables = tables
            sketch._absorb_saturation(out)
        elif "sat_total" in out:
            pending_sat.append(out)

    def commit_dense(items):
        nonlocal tables, n_unique, n_consumed, overflow
        for harr, nvalid in items:
            tables, n_unique, n_consumed, overflow, out = \
                dense_step_for(len(harr))(
                    tables, n_unique, n_consumed, overflow,
                    jnp.asarray(harr), jnp.int32(nvalid))
            absorb(out)

    def commit_flat(chunks):
        nonlocal tables, n_unique, n_consumed, overflow
        for codes, starts, nfill in chunks:
            extra = () if mask is None else (mask.tables,)
            tables, n_unique, n_consumed, overflow, out = step_for(
                len(codes))(
                tables, n_unique, n_consumed, overflow,
                jnp.asarray(codes), jnp.asarray(starts),
                jnp.int32(nfill), *extra)
            absorb(out)

    commit = commit_dense if use_dense else commit_flat

    use_native = False
    if isinstance(source, str) and callback is None:
        from khmer_tpu.io import native

        use_native = native.available()
    if use_native:
        from khmer_tpu.io import native

        for codes_blk, meta, _ in native.pack_blocks(source):
            if use_dense:
                n_reads += len(meta)
                commit(packer.add_block(codes_blk, meta[:, 0],
                                        meta[:, 1]))
            else:
                for so, sl, _no, _nl in meta:
                    n_reads += 1
                    if sl >= k:
                        commit(packer.add_codes(codes_blk[so:so + sl]))
    else:
        for record in records_from(source):
            seq = record.cleaned_seq
            n_reads += 1
            if len(seq) >= k:
                commit(packer.add(seq))
            if callback is not None and callback_every \
                    and n_reads % callback_every == 0:
                callback(n_reads)
    commit(packer.flush() if use_dense else packer.flush_ladder())

    sketch.tables = tables
    sketch._n_unique = n_unique
    for out in pending_sat:
        sketch._absorb_saturation(out)
    K.check_v2_overflow(overflow)
    return n_reads, int(n_consumed)


def abundance_distribution(main, source, tracking):
    """Histogram of k-mer counts over reads, deduplicated by `tracking`.

    Mirrors Hashtable::abundance_distribution (hashtable.cc:451-502):
    per k-mer in stream order, if tracking says unseen, track it and
    histogram the main count. Returns a list of MAX_BIGCOUNT+1 ints.
    """
    from khmer_tpu.core import hostengine

    k = main.ksize()
    if tracking.ksize() != k:
        raise ValueError("tracking table k-size must match")
    if hostengine.use_host_for(main, "graph") and \
            hostengine.use_host_for(tracking, "trim") and \
            tracking.hash_family == main.hash_family:
        return hostengine.abundance_distribution(main, source, tracking)
    batcher = Batcher(k)
    hash_fn = make_hash_batch(k, main.hash_family)
    step = K.make_abund_dist(tracking.storage_kind, tracking._primes,
                             main.storage_kind, main._primes)
    dist = jnp.zeros(K.MAX_BIGCOUNT + 2, dtype=jnp.uint64)
    sat_hashes = []

    def commit(batch):
        nonlocal dist
        if batch is None:
            return
        if isinstance(batch, list):
            for b in batch:
                commit(b)
            return
        codes, lengths = batch
        hashes, valid = hash_fn(jnp.asarray(codes), jnp.asarray(lengths))
        tt, dist2, n_sat, sat_hash = step(
            tracking.tables, dist, main.tables,
            hashes.ravel(), valid.ravel())
        tracking.tables = tt
        dist = dist2
        n_sat = int(n_sat)
        if n_sat:
            if n_sat > sat_hash.shape[0]:
                raise RuntimeError("too many saturated k-mers in one batch")
            hs = np.asarray(sat_hash)
            sat_hashes.extend(int(h) for h in hs
                              if h != 0xFFFFFFFFFFFFFFFF)

    for record in records_from(source):
        seq = record.cleaned_seq
        if len(seq) >= k:
            commit(batcher.add(seq))
    commit(batcher.flush())

    out = np.asarray(dist[: K.MAX_BIGCOUNT + 1]).astype(np.uint64)
    # saturated counts resolve through the host-side bigcount map
    for h in sat_hashes:
        c = main._bigcounts.get(h, K.MAX_KCOUNT) if main._use_bigcount \
            else K.MAX_KCOUNT
        out[min(c, K.MAX_BIGCOUNT)] += 1
    return [int(x) for x in out]


def counts_for_records(sketch, records):
    """Batched per-read k-mer count arrays; yields (record, counts np).

    Count arrays include host-side bigcount fixup. Reads shorter than k
    yield an empty array.
    """
    from khmer_tpu.core import hostengine

    if hostengine.use_host_for(sketch, "graph"):
        yield from _counts_for_records_host(sketch, records)
        return

    k = sketch.ksize()
    get_fn = sketch._get_fn()
    hash_fn = make_hash_batch(k, sketch.hash_family)
    pending = []
    batcher = Batcher(k)

    def process(batch):
        if batch is None:
            counts = hs = None
        else:
            codes, lengths = batch
            hashes, valid = hash_fn(jnp.asarray(codes),
                                    jnp.asarray(lengths))
            counts = np.asarray(get_fn(sketch.tables,
                                       hashes)).astype(np.uint32)
            hs = (np.asarray(hashes)
                  if sketch._use_bigcount and sketch._bigcounts else None)
        i = 0
        for rec in pending:
            n = len(rec.cleaned_seq) - k + 1
            if n <= 0:
                yield rec, np.zeros(0, dtype=np.uint32)
                continue
            c = counts[i, :n].copy()
            if hs is not None:
                sat = c == K.MAX_KCOUNT
                for j in np.nonzero(sat)[0]:
                    c[j] = sketch._bigcounts.get(int(hs[i, j]),
                                                 K.MAX_KCOUNT)
            yield rec, c
            i += 1
        pending.clear()

    for record in records:
        seq = record.cleaned_seq
        if len(seq) >= k:
            if len(seq) > MAX_ROW_LEN:
                if pending:
                    yield from process(batcher.flush())
                # long reads take the scalar path
                yield record, sketch.get_counts_for_hashes(
                    sketch._hashes_for_sequence(seq))
                continue
            pending.append(record)
            batch = batcher.add(seq)
            if batch is not None:
                yield from process(batch)
        else:
            pending.append(record)
    if pending:
        yield from process(batcher.flush())


def _counts_for_records_host(sketch, records):
    """Host-tier counts_for_records: flat zero-dispatch hashing per
    window + a numpy gather off the host table mirror."""
    from khmer_tpu.core import hostengine
    from khmer_tpu.ops import hashing as H

    k = sketch.ksize()
    tabs = sketch.host_view()
    primes = sketch._primes
    kind = sketch.storage_kind
    bigs = sketch._bigcounts if (sketch._use_bigcount
                                 and sketch._bigcounts) else None

    def gather(flat):
        if kind == "bit":
            m = np.ones(flat.shape, np.uint32)
        else:
            m = np.full(flat.shape, np.uint32(
                K.MAX_KCOUNT if kind == "byte" else 15))
        for t, p in zip(tabs, primes):
            bins = flat % np.uint64(p)
            if kind == "byte":
                c = t[bins.astype(np.int64)].astype(np.uint32)
            elif kind == "bit":
                byte = t[(bins >> np.uint64(3)).astype(np.int64)]
                bit = (byte >> (bins & np.uint64(7)).astype(np.uint8)) & 1
                c = bit.astype(np.uint32)
                m &= c
                continue
            else:
                byte = t[(bins >> np.uint64(1)).astype(np.int64)]
                odd = (bins & np.uint64(1)).astype(bool)
                c = np.where(odd, byte & 0x0F, byte >> 4).astype(np.uint32)
            m = np.minimum(m, c)
        return m

    window = []
    for record in records:
        window.append(record)
        if len(window) < 16384:
            continue
        yield from _emit_host_counts(sketch, window, k, gather, bigs)
        window = []
    if window:
        yield from _emit_host_counts(sketch, window, k, gather, bigs)


def _emit_host_counts(sketch, window, k, gather, bigs):
    from khmer_tpu.core import hostengine
    from khmer_tpu.ops import hashing as H

    codes, starts, ends, _ = hostengine.pack_records(window)
    flat = H.host_hash_windows(codes, k)
    counts = gather(flat) if flat.size else np.zeros(0, np.uint32)
    for i, rec in enumerate(window):
        lo, hi = starts[i], ends[i] - k + 1
        if hi <= lo:
            yield rec, np.zeros(0, dtype=np.uint32)
            continue
        c = counts[lo:hi].copy()
        if bigs is not None:
            sat = c == K.MAX_KCOUNT
            for j in np.nonzero(sat)[0]:
                c[j] = bigs.get(int(flat[lo + j]), K.MAX_KCOUNT)
        yield rec, c
