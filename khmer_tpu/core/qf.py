"""Counting quotient filter — a real rank-and-select CQF.

Replaces the reference's gqf-backed QFStorage (third-party/cqf/gqf.c,
wrapped at include/oxli/storage.hh:413-458) with an independent
implementation of the same structure (Pandey et al., "A General-Purpose
Counting Filter: Counting Quotient Filter", SIGMOD 2017):

- ``2**q`` slots of 8 bits; a key (``khash % range``, range = 2**(q+8))
  splits into quotient (high q bits) and 8-bit remainder;
- per 64-slot block: ``occupieds``/``runends`` bitvectors, an ``offset``
  byte, and the slot bytes — the exact packed qfblock layout the
  reference serializes (gqf.h:37-53);
- remainders of one quotient form a *run*, sorted ascending, placed at
  the first free slot >= the quotient; repeats are squeezed with the
  gqf counter encoding (gqf.c encode_counter): ``[r]``, ``[r,r]``,
  ``[r,0,r]`` / ``[0,0,0]``, and for larger counts base-254 digits
  between two copies of the remainder (base 255 + double-0 terminator
  for remainder 0);
- queries walk the real structure: block offset -> occupieds rank ->
  runends select locates the run, then the run's counters are decoded.

Design difference from gqf (deliberate, batched-framework idiom): inserts
are buffered in a pending delta map and folded in by a *vectorized
canonical rebuild* (numpy) instead of per-key slot shifting. The RSQF
layout is canonical — runs in quotient order, remainders sorted, greedy
first-fit placement — so a rebuild reproduces byte-for-byte the layout
incremental insertion converges to, while batch inserts cost O(1)
amortized numpy work per key instead of a Python shifting loop.

On-disk format: byte-compatible with QFStorage::save/load
(src/oxli/storage.cc:919-1040): OXLI v4 header, type 8, ksize u8,
11 u64 metadata words, then ``nblocks`` packed 81-byte qfblocks.
Reference-written files load; files written here load in the reference.

One bookkeeping divergence: gqf's ``ndistinct_elts`` undercounts (the
insert1 path skips the increment when a new element's home slot is
occupied by an earlier run's spill), so the reference's
``n_unique_kmers()`` drifts low on dense filters. This module tracks
the true distinct-key count; when a reference-written file is loaded
and not modified, the loaded (buggy) header values are preserved so a
re-save stays byte-identical.
"""

import struct

import numpy as np

SLOTS_PER_BLOCK = 64
BITS_PER_SLOT = 8
BLOCK_BYTES = 1 + 8 + 8 + SLOTS_PER_BLOCK  # offset, occupieds, runends, slots


def _encode_counters(rems, counts):
    """gqf counter encoding, vectorized over (remainder, count) pairs.

    Returns (flat_bytes uint8[], lengths int64[]) — the slot bytes of
    every counter, concatenated in input order.
    """
    rems = np.asarray(rems, np.uint64).astype(np.int64)
    counts = np.asarray(counts, np.int64)
    n = len(rems)
    out = []
    lens = np.zeros(n, np.int64)

    # lengths first (so we can preallocate flat positions)
    c1 = counts == 1
    c2 = counts == 2
    c3 = counts == 3
    big = counts >= 4
    lens[c1] = 1
    lens[c2] = 2
    lens[c3] = 3
    if big.any():
        r = rems[big]
        c = counts[big]
        # digit count of (c - 3) in base 254 for r>0, (c - 4) base 255 r==0
        base = np.where(r > 0, 254, 255)
        val = np.where(r > 0, c - 3, c - 4)
        ndig = np.ones(len(val), np.int64)
        v = val // base
        while (v > 0).any():
            ndig += v > 0
            v //= base
        # leading r, optional 0 marker, digits, trailing r (+ extra 0 for r==0)
        # marker for r>0: msd-digit >= r; for r==0: always the extra 0.
        msd = val.copy()
        for _ in range(1, 64):
            nxt = msd // base
            if not (nxt > 0).any():
                break
            msd = np.where(nxt > 0, nxt, msd)
        msd_digit = msd % base + 1
        msd_digit = np.where((r > 0) & (msd_digit >= r), msd_digit + 1,
                             msd_digit)
        marker = np.where(r > 0, (msd_digit >= r).astype(np.int64), 1)
        lens[big] = 2 + marker + ndig

    total = int(lens.sum())
    flat = np.zeros(total, np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])

    # c == 1..3
    idx = starts[c1]
    flat[idx] = rems[c1]
    idx = starts[c2]
    flat[idx] = rems[c2]
    flat[idx + 1] = rems[c2]
    idx = starts[c3]
    r3 = rems[c3]
    flat[idx] = r3
    flat[idx + 1] = 0          # [r,0,r] for r>0; [0,0,0] for r==0
    flat[idx + 2] = r3

    if big.any():
        bidx = np.flatnonzero(big)
        for j in bidx:          # rare (counts >= 4); per-counter loop
            r = int(rems[j])
            c = int(counts[j])
            s = int(starts[j])
            L = int(lens[j])
            p = s + L
            buf = flat
            p -= 1
            buf[p] = r          # trailing remainder
            base = 254 if r > 0 else 255
            if r == 0:
                p -= 1
                buf[p] = 0      # extra terminator 0
                val = c - 4
            else:
                val = c - 3
            digit = 0
            while True:
                digit = val % base + 1
                if r > 0 and digit >= r:
                    digit += 1
                p -= 1
                buf[p] = digit
                val //= base
                if val == 0:
                    break
            if r > 0 and digit >= r:
                p -= 1
                buf[p] = 0      # leading-zero marker
            p -= 1
            buf[p] = r          # leading remainder
            assert p == s, (r, c, p, s, L)
    return flat, lens


def _decode_run(slots):
    """Decode one run's slot bytes -> list of (remainder, count).

    Inverse of _encode_counters for a full run (remainders ascending).
    """
    out = []
    i = 0
    n = len(slots)
    while i < n:
        r = int(slots[i])
        if r == 0:
            # zero-remainder counter: [0], [0,0], [0,0,0], [0,d..,0,0].
            # Remainders ascend within a run, so 0 is only legal as the
            # run's first counter.
            if i != 0:
                raise ValueError("corrupt run: interior zero remainder")
            # find the first 0 after the leading 0; the zero counter is
            # extended only if that 0 is followed by ANOTHER 0 (a lone
            # later 0 is the marker of some subsequent counter) —
            # mirrors the gqf insert1 zero-terminator scan.
            j = i + 1
            while j < n and slots[j] != 0:
                j += 1
            if j < n and j + 1 < n and slots[j + 1] == 0:
                if j == i + 1:
                    out.append((0, 3))      # [0,0,0]
                    i += 3
                else:
                    # digits between: [0, d.., 0, 0]
                    val = 0
                    for d in slots[i + 1:j]:
                        val = val * 255 + (int(d) - 1)
                    out.append((0, val + 4))
                    i = j + 2
            elif j < n and j == i + 1:
                out.append((0, 2))          # [0,0]
                i += 2
            else:
                out.append((0, 1))          # [0]
                i += 1
        else:
            if i + 1 >= n or slots[i + 1] > r:
                out.append((r, 1))          # [r]
                i += 1
            elif slots[i + 1] == r:
                out.append((r, 2))          # [r,r]
                i += 2
            else:
                # extended: [r, 0?, d.., r]
                j = i + 1
                while slots[j] != r:
                    j += 1
                    if j >= n:
                        raise ValueError("corrupt extended counter")
                digits = [int(d) for d in slots[i + 1:j]]
                if digits and digits[0] == 0:
                    digits = digits[1:]     # leading-zero marker
                if not digits:
                    out.append((r, 3))      # [r,0,r]
                else:
                    val = 0
                    for d in digits:
                        d = d - 2 if d > r else d - 1
                        val = val * 254 + d
                    out.append((r, val + 3))
                i = j + 1
    return out


def _bitrank(word, i):
    """popcount of bits [0, i] of a u64 word (gqf bitrank)."""
    mask = (np.uint64(2) << np.uint64(i)) - np.uint64(1) \
        if i < 63 else np.uint64(0xFFFFFFFFFFFFFFFF)
    return int(bin(int(word & mask)).count("1"))


def _bitselect(word, rank):
    """Position of the rank'th (0-based) set bit of a u64 word, or 64."""
    w = int(word)
    for pos in range(64):
        if w & 1:
            if rank == 0:
                return pos
            rank -= 1
        w >>= 1
    return 64


class QuotientFilter:
    """Rank-and-select counting quotient filter (see module docstring).

    ``size`` is the slot count (a power of two), matching QFStorage's
    ``qf_init(&cf, 1ULL << size_log2, size_log2 + 8, 0)``.
    """

    # rebuild when pending deltas exceed this fraction of nslots
    _PENDING_FRACTION = 0.25

    def __init__(self, size):
        size = int(size)
        if size & (size - 1) != 0 or size <= 0:
            raise ValueError("QF slot count must be a power of two")
        self.nslots = size
        self.qbits = size.bit_length() - 1
        self.key_bits = self.qbits + 8
        self.range = 1 << self.key_bits
        # gqf qf_init: xnslots = nslots + 10*sqrt(nslots)
        self.xnslots = int(self.nslots + 10 * (self.nslots ** 0.5))
        self.nblocks = (self.xnslots + SLOTS_PER_BLOCK - 1) \
            // SLOTS_PER_BLOCK
        nsl = self.nblocks * SLOTS_PER_BLOCK
        self.occupieds = np.zeros(self.nblocks, np.uint64)
        self.runends = np.zeros(self.nblocks, np.uint64)
        self.offsets = np.zeros(self.nblocks, np.uint8)
        self.slots = np.zeros(nsl, np.uint8)
        # authoritative sorted key/count arrays the structure encodes
        self._keys = np.zeros(0, np.uint64)
        self._counts = np.zeros(0, np.int64)
        self._pending = {}
        self.nelts = 0
        self.noccupied = 0
        # header passthrough for byte-identical re-save of loaded files
        self._loaded_header = None

    # -- public counting API ------------------------------------------------

    def insert(self, h, count=1):
        k = int(h) % self.range
        self._pending[k] = self._pending.get(k, 0) + int(count)
        self.nelts += int(count)
        self._loaded_header = None
        if len(self._pending) > self._PENDING_FRACTION * self.nslots:
            self._flush()

    def insert_many(self, hashes):
        """Vectorized bulk insert of an array of raw hashes."""
        keys = np.asarray(hashes, np.uint64) % np.uint64(self.range)
        keys, reps = np.unique(keys, return_counts=True)
        for k, c in zip(keys.tolist(), reps.tolist()):
            self._pending[k] = self._pending.get(k, 0) + c
        self.nelts += int(reps.sum())
        self._loaded_header = None
        if len(self._pending) > self._PENDING_FRACTION * self.nslots:
            self._flush()

    def count(self, h):
        k = int(h) % self.range
        c = self._query_structure(k)
        return c + self._pending.get(k, 0)

    def counts_many(self, hashes):
        """Vectorized counts for an array of raw hashes (uint32)."""
        if self._pending:
            self._flush()
        keys = np.asarray(hashes, np.uint64) % np.uint64(self.range)
        idx = np.searchsorted(self._keys, keys)
        idx = np.minimum(idx, max(len(self._keys) - 1, 0))
        if not len(self._keys):
            return np.zeros(len(keys), np.uint32)
        hit = self._keys[idx] == keys
        return np.where(hit, self._counts[idx], 0).astype(np.uint32)

    @property
    def n_unique(self):
        if self._pending:
            self._flush()
        return len(self._keys)

    @property
    def n_occupied(self):
        if self._pending:
            self._flush()
        return self.noccupied

    def items(self):
        """(key, count) pairs in key order."""
        if self._pending:
            self._flush()
        return zip(self._keys.tolist(), self._counts.tolist())

    # -- the real structure: canonical build + rank/select query ------------

    def _flush(self):
        if not self._pending:
            return
        pk = np.fromiter(self._pending.keys(), np.uint64,
                         len(self._pending))
        pc = np.fromiter(self._pending.values(), np.int64, len(pk))
        self._pending = {}
        keys = np.concatenate([self._keys, pk])
        counts = np.concatenate([self._counts, pc])
        order = np.argsort(keys, kind="stable")
        keys, counts = keys[order], counts[order]
        # merge duplicates (existing key also in pending)
        if len(keys):
            newgrp = np.concatenate([[True], keys[1:] != keys[:-1]])
            gid = np.cumsum(newgrp) - 1
            merged = np.zeros(gid[-1] + 1, np.int64)
            np.add.at(merged, gid, counts)
            keys = keys[newgrp]
            counts = merged
        self._keys, self._counts = keys, counts
        self._rebuild()

    def _rebuild(self):
        """Vectorized canonical RSQF build from the sorted key/count
        arrays. Greedy first-fit placement in quotient order is exactly
        the layout gqf's incremental insertion converges to."""
        keys, counts = self._keys, self._counts
        nsl = self.nblocks * SLOTS_PER_BLOCK
        self.occupieds = np.zeros(self.nblocks, np.uint64)
        self.runends = np.zeros(self.nblocks, np.uint64)
        self.offsets = np.zeros(self.nblocks, np.uint8)
        self.slots = np.zeros(nsl, np.uint8)
        if not len(keys):
            self.noccupied = 0
            return
        quot = (keys >> np.uint64(BITS_PER_SLOT)).astype(np.int64)
        rem = (keys & np.uint64(0xFF))
        flat, lens = _encode_counters(rem, counts)

        # group counters into runs per quotient (keys sorted => grouped)
        newrun = np.concatenate([[True], quot[1:] != quot[:-1]])
        run_q = quot[newrun]
        rid = np.cumsum(newrun) - 1
        run_len = np.zeros(len(run_q), np.int64)
        np.add.at(run_len, rid, lens)

        # greedy placement: end_i = max_j<=i (q_j - S_{j-1}) + S_i - 1
        S = np.cumsum(run_len)
        Sprev = S - run_len
        end = np.maximum.accumulate(run_q - Sprev) + S - 1
        start = end - run_len + 1
        if end[-1] >= nsl:
            raise OverflowError(
                "quotient filter overfull: run spills past xnslots "
                "(%d slots, need %d)" % (nsl, int(end[-1]) + 1))

        # slot bytes: flat positions = start of each counter's run slot
        cstart = np.repeat(start, np.diff(np.concatenate(
            [np.flatnonzero(newrun), [len(quot)]])))
        # offset of each counter inside its run
        within = np.cumsum(lens) - lens
        run_base = np.zeros(len(quot), np.int64)
        run_base[newrun] = within[newrun]
        run_base = np.maximum.accumulate(run_base)
        pos0 = cstart + (within - run_base)
        # expand: each counter writes lens[i] bytes starting at pos0[i]
        tot = int(lens.sum())
        step = np.ones(tot, np.int64)
        heads = np.cumsum(lens)[:-1]        # flat index of counters 1..
        step[0] = pos0[0]
        prev_last = pos0[:-1] + lens[:-1] - 1
        step[heads] = pos0[1:] - prev_last
        positions = np.cumsum(step)
        self.slots[positions] = flat

        # bitvectors
        occ_w = (run_q // 64).astype(np.int64)
        occ_b = (run_q % 64).astype(np.uint64)
        np.bitwise_or.at(self.occupieds, occ_w,
                         np.uint64(1) << occ_b)
        re_w = (end // 64).astype(np.int64)
        re_b = (end % 64).astype(np.uint64)
        np.bitwise_or.at(self.runends, re_w, np.uint64(1) << re_b)

        # offsets: offset[b] = max(0, run_end(64b-1) - (64b-1)) where
        # run_end(i) is the end of the last run with quotient <= i
        # (gqf block_offset invariant, gqf.c:332-341)
        bnd = np.arange(1, self.nblocks, dtype=np.int64) * 64 - 1
        j = np.searchsorted(run_q, bnd, side="right") - 1
        emax = np.maximum.accumulate(end)
        off = np.zeros(self.nblocks, np.int64)
        has = j >= 0
        off[1:][has] = np.maximum(0, emax[j[has]] - bnd[has])
        if (off > 255).any():
            raise OverflowError("qfblock offset exceeds the u8 field")
        self.offsets = off.astype(np.uint8)
        self.noccupied = tot

    # gqf-faithful structure walk (block offset -> rank -> select)

    def _run_end(self, idx):
        """End slot of the run covering slot ``idx`` (gqf run_end)."""
        b = idx // SLOTS_PER_BLOCK
        ib = idx % SLOTS_PER_BLOCK
        boff = int(self.offsets[b])
        rank = _bitrank(self.occupieds[b], ib)
        if rank == 0:
            if boff <= ib:
                return idx
            return SLOTS_PER_BLOCK * b + boff - 1
        reb = b + boff // SLOTS_PER_BLOCK
        ignore = boff % SLOTS_PER_BLOCK
        rank -= 1
        while True:
            w = int(self.runends[reb]) if reb < self.nblocks else 0
            w &= ~((1 << ignore) - 1)
            cnt = bin(w).count("1")
            if rank < cnt:
                pos = _bitselect(np.uint64(w), rank)
                runend = SLOTS_PER_BLOCK * reb + pos
                break
            rank -= cnt
            ignore = 0
            reb += 1
            if reb >= self.nblocks:
                return idx
        return max(runend, idx)

    def _query_structure(self, key):
        """Count of ``key`` by walking the packed structure."""
        q = key >> BITS_PER_SLOT
        r = key & 0xFF
        b = q // SLOTS_PER_BLOCK
        if not (int(self.occupieds[b]) >> (q % SLOTS_PER_BLOCK)) & 1:
            return 0
        runend = self._run_end(q)
        runstart = q if q == 0 else self._run_end(q - 1) + 1
        runstart = max(runstart, q)
        for rem, cnt in _decode_run(self.slots[runstart:runend + 1]):
            if rem == r:
                return cnt
            if rem > r:
                return 0
        return 0

    # -- OXLI SAVED_QFCOUNT persistence --------------------------------------

    def save(self, f, ksize):
        """SAVED_QFCOUNT body after the OXLI signature/version/type:
        ksize u8, 11 u64 metadata words, nblocks packed qfblocks
        (storage.cc:919-955)."""
        if self._pending:
            self._flush()
        if self._loaded_header is not None:
            nelts, ndistinct, noccupied = self._loaded_header
        else:
            nelts = int(self.nelts)
            ndistinct = len(self._keys)
            noccupied = int(self.noccupied)
        f.write(struct.pack("<B", ksize))
        f.write(struct.pack(
            "<11Q", self.nslots, self.xnslots, self.key_bits, 0,
            BITS_PER_SLOT, BITS_PER_SLOT, self.range, self.nblocks,
            nelts, ndistinct, noccupied))
        blocks = np.zeros(self.nblocks * BLOCK_BYTES, np.uint8)
        v = blocks.reshape(self.nblocks, BLOCK_BYTES)
        v[:, 0] = self.offsets
        v[:, 1:9] = self.occupieds.view(np.uint8).reshape(self.nblocks, 8)
        v[:, 9:17] = self.runends.view(np.uint8).reshape(self.nblocks, 8)
        v[:, 17:] = self.slots.reshape(self.nblocks, SLOTS_PER_BLOCK)
        f.write(blocks.tobytes())

    @classmethod
    def load(cls, f):
        """Read a SAVED_QFCOUNT body (reference- or library-written);
        returns (filter, ksize)."""
        def read_exact(n):
            data = f.read(n)
            if len(data) != n:
                raise OSError("Unexpected end of k-mer count file")
            return data

        (ksize,) = struct.unpack("<B", read_exact(1))
        fields = struct.unpack("<11Q", read_exact(88))
        (nslots, xnslots, key_bits, value_bits, krb, bps,
         range_, nblocks, nelts, ndistinct, nocc) = fields
        if bps != BITS_PER_SLOT or value_bits != 0:
            raise OSError("unsupported quotient filter layout "
                          "(bits_per_slot=%d value_bits=%d)"
                          % (bps, value_bits))
        qf = cls(int(nslots))
        if qf.range != range_ or qf.xnslots != xnslots \
                or qf.nblocks != nblocks:
            raise OSError("inconsistent quotient filter header")
        raw = np.frombuffer(read_exact(nblocks * BLOCK_BYTES),
                            np.uint8).reshape(nblocks, BLOCK_BYTES)
        qf.offsets = raw[:, 0].copy()
        qf.occupieds = raw[:, 1:9].copy().view(np.uint64).ravel()
        qf.runends = raw[:, 9:17].copy().view(np.uint64).ravel()
        qf.slots = raw[:, 17:].copy().ravel()
        qf._decode_all()
        qf.nelts = int(nelts)
        qf._loaded_header = (int(nelts), int(ndistinct), int(nocc))
        # keep the loaded noccupied (should equal the decoded total)
        qf.noccupied = int(nocc)
        return qf, ksize

    def _decode_all(self):
        """Populate the key/count arrays from the packed structure."""
        keys = []
        counts = []
        prev_end = -1
        occ_quots = []
        for b in range(self.nblocks):
            w = int(self.occupieds[b])
            while w:
                low = w & -w
                occ_quots.append(b * 64 + low.bit_length() - 1)
                w ^= low
        # runends as a flat bit array for fast "next runend >= i"
        re_bits = np.unpackbits(
            self.runends.view(np.uint8), bitorder="little")
        re_pos = np.flatnonzero(re_bits)
        for q in occ_quots:
            runstart = max(q, prev_end + 1)
            i = np.searchsorted(re_pos, runstart)
            if i >= len(re_pos):
                raise OSError("corrupt quotient filter: missing runend")
            runend = int(re_pos[i])
            for rem, cnt in _decode_run(self.slots[runstart:runend + 1]):
                keys.append((q << BITS_PER_SLOT) | rem)
                counts.append(cnt)
            prev_end = runend
        self._keys = np.asarray(keys, np.uint64)
        self._counts = np.asarray(counts, np.int64)
        self.noccupied = int(_encode_counters(
            self._keys & np.uint64(0xFF), self._counts)[1].sum()) \
            if len(keys) else 0
