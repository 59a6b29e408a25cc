"""Pure-Python oracle models of the reference storage semantics.

These reimplement include/oxli/storage.hh add/get sequentially, one
event at a time, to validate that the batched device pipelines are
sequential-equivalent (counts, n_unique, n_occupied, bigcount).

`twobit_hashes` and `blocked_model` are whole-stream numpy models of
the 2-bit canonical hash and of the blocked Count-Min layout
(core/blocked.py), sized for streams of 10^8 k-mers.
"""

import numpy as np

MAX_KCOUNT = 255
MAX_BIGCOUNT = 65535


class OracleByte:
    """ByteStorage (storage.hh:481-660)."""

    max_count = MAX_KCOUNT

    def __init__(self, primes, use_bigcount=False):
        self.primes = list(primes)
        self.tables = [dict() for _ in primes]
        self.n_unique = 0
        self.occupied = 0
        self.use_bigcount = use_bigcount
        self.bigcounts = {}

    def add(self, h):
        is_new = False
        n_full = 0
        for i, p in enumerate(self.primes):
            bin_ = h % p
            cur = self.tables[i].get(bin_, 0)
            if not is_new and cur == 0:
                is_new = True
                if i == 0:
                    self.occupied += 1
            if cur < self.max_count:
                self.tables[i][bin_] = cur + 1
            else:
                n_full += 1
        if n_full == len(self.primes) and self.use_bigcount:
            b = self.bigcounts.get(h, 0)
            if b == 0:
                self.bigcounts[h] = self.max_count + 1
            elif b < MAX_BIGCOUNT:
                self.bigcounts[h] = b + 1
        if is_new:
            self.n_unique += 1
        return is_new

    def get(self, h):
        mc = min(self.tables[i].get(h % p, 0)
                 for i, p in enumerate(self.primes))
        mc = min(mc, self.max_count)
        if mc == self.max_count and self.use_bigcount:
            return self.bigcounts.get(h, mc)
        return mc

    def table_array(self, i):
        import numpy as np

        arr = np.zeros(self.primes[i], dtype=np.uint8)
        for b, c in self.tables[i].items():
            arr[b] = c
        return arr


class OracleNibble(OracleByte):
    """NibbleStorage (storage.hh:245-405)."""

    max_count = 15

    def __init__(self, primes):
        super().__init__(primes, use_bigcount=False)

    def table_array(self, i):
        import numpy as np

        arr = np.zeros(self.primes[i] // 2 + 1, dtype=np.uint8)
        for b, c in self.tables[i].items():
            byte = b // 2
            if b % 2:
                arr[byte] |= c
            else:
                arr[byte] |= c << 4
        return arr


class OracleBit:
    """BitStorage (storage.hh:95-229)."""

    def __init__(self, primes):
        self.primes = list(primes)
        self.tables = [set() for _ in primes]
        self.n_unique = 0
        self.occupied = 0

    def add(self, h):
        is_new = False
        for i, p in enumerate(self.primes):
            bin_ = h % p
            if bin_ not in self.tables[i]:
                if i == 0:
                    self.occupied += 1
                is_new = True
                self.tables[i].add(bin_)
        if is_new:
            self.n_unique += 1
        return is_new

    def get(self, h):
        return int(all(h % p in self.tables[i]
                       for i, p in enumerate(self.primes)))

    def table_array(self, i):
        import numpy as np

        arr = np.zeros(self.primes[i] // 8 + 1, dtype=np.uint8)
        for b in self.tables[i]:
            arr[b // 8] |= 1 << (b % 8)
        return arr


def twobit_hashes(codes, k):
    """Canonical 2-bit k-mer hashes of equal-length reads, in stream order.

    codes: [n_reads, read_len] uint8 with A=0, T=1, C=2, G=3. Window i of
    a read packs its k bases forward (first base most significant) and,
    reverse-complemented, backward (complement = code ^ 1); the hash is
    the smaller of the two. Returns a flat uint64 array, read by read.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    w = codes.shape[1] - k + 1
    fwd = np.zeros((codes.shape[0], w), np.uint64)
    rev = np.zeros((codes.shape[0], w), np.uint64)
    for j in range(k):
        col = codes[:, j:j + w]
        fwd |= col << np.uint64(2 * (k - 1 - j))
        rev |= (col ^ np.uint64(1)) << np.uint64(2 * j)
    return np.minimum(fwd, rev).ravel()


def _mix64(x):
    """splitmix64 finalizer (wrapping uint64 arithmetic)."""
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def blocked_model(hashes, nblocks):
    """The blocked Count-Min layout over a whole stream, in numpy.

    A k-mer touches four lanes of the 128-lane block ``hash % nblocks``:
    lane ``32*t + ((mix64(hash) >> 5*t) & 31)`` for t in 0..3. A lane
    holds min(number of touches, 255), and a k-mer is new iff it is the
    first in the stream to touch one of its lanes. One sort of
    (lane << bits | event) keys gives both.

    Returns (table as a flat [nblocks * 128] uint8 array, n_unique).
    """
    h = np.asarray(hashes, dtype=np.uint64)
    n = h.size
    ebits = max(1, (n - 1).bit_length())
    if (int(nblocks) * 128) << ebits >= 1 << 63:
        raise ValueError("stream too long for 64-bit lane|event keys")
    mixed = _mix64(h)
    base = (h % np.uint64(nblocks)).astype(np.int64) * 128
    event = np.arange(n, dtype=np.int64)
    keys = np.empty((n, 4), np.int64)
    for t in range(4):
        off = ((mixed >> np.uint64(5 * t)) & np.uint64(31)).astype(np.int64)
        keys[:, t] = ((base + (32 * t) + off) << ebits) | event
    del mixed, base, event
    keys = keys.ravel()
    keys.sort()
    lanes = keys >> ebits
    head = np.empty(keys.size, bool)
    head[:1] = True
    np.not_equal(lanes[1:], lanes[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    del head
    touches = np.diff(np.append(starts, keys.size))
    table = np.zeros(int(nblocks) * 128, np.uint8)
    table[lanes[starts]] = np.minimum(touches, 255)
    new = np.zeros(n, bool)
    new[keys[starts] & ((1 << ebits) - 1)] = True
    return table, int(new.sum())
