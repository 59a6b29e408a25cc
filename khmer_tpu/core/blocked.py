"""Blocked Count-Min sketch — the one-block-per-k-mer counting layout.

The reference's Count-Min (ByteStorage, include/oxli/storage.hh:481)
spreads a k-mer's N counters over N independent prime-sized tables, so
every add/query costs N uncorrelated random memory touches. This
module keeps all of a k-mer's counters inside ONE 128-byte block, so a
k-mer costs one row scatter and one row gather:

    table[nblocks, 128] uint8
    block  = hash % nblocks          (nblocks prime)
    lane_t = 32*t + bits_t(mix(hash))   for t in 0..3

i.e. four independent sub-counters, one in each 32-lane quarter of the
block (a blocked Count-Min / blocked Bloom layout, cf. Putze et al.,
"Cache-, Hash- and Space-Efficient Bloom Filters"). One row-scatter
plus one row-gather replaces the reference layout's 8 element-ops per
event, with the usual slightly-higher collision rate of blocked sketches
(compensate with ~15% more memory when FP-rate-critical).

Counting semantics mirror ByteStorage::add exactly as *defined* for
this layout: saturating 8-bit counters, count() = min over the four
lanes, an add is a new k-mer iff some lane was zero at that moment
(sequential order, reproduced batch-exactly with the same machinery as
sketch_kernels.v2_update_core). No bigcount.

This is an extension sketch: files are OXLI-framed with private type
byte 127 so the reference (types 1-8) can never misparse them.
"""

import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np

from khmer_tpu.core import sketch_kernels as K
from khmer_tpu.core.sketch import _Sketch, _TwoBitMixin, _MurmurMixin
from khmer_tpu.core.graphmixin import HashgraphMixin

LANES = 128
SUB = 4          # sub-counters per block
QUART = LANES // SUB
SAVED_BLOCKED = 127  # private OXLI type byte (reference uses 1..8)

MAX_BLOCKS = (2**31 - 1) // LANES  # counter ids must stay i32


def mix64(x):
    """splitmix64 finalizer: spread hash entropy into the offset bits."""
    x = jnp.asarray(x, jnp.uint64)
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return x


def _offsets(uh):
    """Per-sub-counter lane offsets within the 32-lane quarter: [SUB, M]."""
    m = mix64(uh)
    return jnp.stack([
        ((m >> np.uint64(5 * t)) & np.uint64(QUART - 1)).astype(jnp.int32)
        for t in range(SUB)])


def _select_lanes(rows_q, offq):
    """rows_q [M, SUB, QUART] i32, offq [SUB, M] -> [SUB, M] values."""
    lane = jax.lax.broadcasted_iota(jnp.int32, rows_q.shape, 2)
    sel = lane == jnp.transpose(offq)[:, :, None]
    return jnp.transpose(jnp.sum(jnp.where(sel, rows_q, 0), axis=2))


IDX_FILL = 1 << 30  # scatter-min sentinel; events per batch must stay
                    # below (the packed (winner << 1 | zero) gather
                    # needs winner * 2 to fit int32)


def blocked_local_update(span, table, hashes, block, idx, mine):
    """Sort-free batch update of a [span, LANES] table slice.

    `block`/`mine` select which events this table slice owns — the
    whole table on one device, or a block-range shard under shard_map.
    `idx` is the event's position in the sequential stream order.

    Exactly reproduces sequential ByteStorage::add semantics
    (storage.hh:571-624, as defined for this layout) WITHOUT the
    sort/dedup pass:
      * counts: saturating +1 increments commute, so one row
        scatter-add of per-event one-hot rows followed by a clamp
        equals the sequential result;
      * new-k-mer credit: an event is new iff some of its lanes was
        zero when it was processed, i.e. iff it is the minimum-`idx`
        toucher of a lane whose pre-batch value is zero — ONE row
        scatter-min of event indices decides every lane's winner, and
        duplicates of a hash can never out-rank its first occurrence.

    Returns (new_table, new_flags [M] bool). ~3 row ops per batch; no
    collision-resolution budget, no overflow flag.
    """
    M = hashes.shape[0]
    if M >= IDX_FILL:
        raise ValueError("blocked batch too large: %d events (max %d)"
                         % (M, IDX_FILL - 1))
    safe_block = jnp.where(mine, block, jnp.int32(span))
    offq = _offsets(hashes)                                # [SUB, M]

    lane = jax.lax.broadcasted_iota(jnp.int32, (M, SUB, QUART), 2)
    onehot = lane == jnp.transpose(offq)[:, :, None]       # [M, SUB, QUART]

    # row scatter-add: per-lane batch totals
    one_rows = jnp.where(onehot, 1, 0).reshape(M, LANES)
    delta = jnp.zeros((span, LANES), jnp.int32).at[safe_block].add(
        one_rows, mode="drop")

    # row scatter-min: per-lane first-toucher event index
    idx_rows = jnp.where(onehot, idx[:, None, None],
                         jnp.int32(IDX_FILL)).reshape(M, LANES)
    winner = jnp.full((span, LANES), jnp.int32(IDX_FILL)).at[
        safe_block].min(idx_rows, mode="drop")

    old = table.astype(jnp.int32)
    new_table = jnp.minimum(old + delta, K.MAX_KCOUNT).astype(jnp.uint8)

    # ONE row-gather returns (lane winner | pre-batch-zero flag)
    packed = (winner << 1) | (old == 0)
    g = packed.at[safe_block].get(mode="fill", fill_value=0)
    gv = _select_lanes(g.reshape(M, SUB, QUART), offq)     # [SUB, M]
    fresh_won = (gv & 1).astype(bool) & ((gv >> 1) == idx[None, :])
    new_flags = mine & jnp.any(fresh_won, axis=0)
    return new_table, new_flags


def blocked_update_core(nblocks, tables, n_unique, overflow, hashes,
                        valid, with_event_new):
    """Batch update, sequential-order exact, sort-free.

    `overflow` is threaded through unchanged for pipeline API
    compatibility (the sort-free path has no overflow condition).
    """
    NB = int(nblocks)
    block = (hashes % np.uint64(NB)).astype(jnp.int32)
    idx = jnp.arange(hashes.shape[0], dtype=jnp.int32)
    new_table, new_flags = blocked_local_update(
        NB, tables[0], hashes, block, idx, valid)
    n_unique = n_unique + jnp.sum(
        jnp.where(new_flags, 1, 0)).astype(jnp.uint64)
    out = {}
    if with_event_new:
        out["event_new"] = new_flags
    return (new_table,), n_unique, overflow, out


def gather_counts(nblocks, tables, hashes):
    """Min-over-lanes counts for a hash array (any shape) -> uint16."""
    NB = int(nblocks)
    shape = hashes.shape
    flat = hashes.ravel()
    n = flat.shape[0]
    block = (flat % np.uint64(NB)).astype(jnp.int32)
    offq = _offsets(flat)
    g = tables[0].at[block].get(mode="clip").astype(jnp.int32)
    gv = _select_lanes(g.reshape(n, SUB, QUART), offq)
    return jnp.min(gv, axis=0).astype(jnp.uint16).reshape(shape)


@functools.lru_cache(maxsize=None)
def make_blocked_update(nblocks, with_event_new=False):
    @functools.partial(jax.jit, donate_argnums=(0,))
    def update(tables, n_unique, hashes, valid):
        tables, n_unique, overflow, out = blocked_update_core(
            nblocks, tables, n_unique, jnp.zeros((), bool), hashes,
            valid, with_event_new)
        out["n_unique"] = n_unique
        out["v2_overflow"] = overflow
        return tables, out

    return update


@functools.lru_cache(maxsize=None)
def make_blocked_get(nblocks):
    @jax.jit
    def get(tables, hashes):
        return gather_counts(nblocks, tables, hashes)

    return get


class _BlockedBase(_Sketch):
    """Shared implementation for the blocked sketch classes.

    Constructor signature matches Countgraph(k, starting_size,
    n_tables): total memory = starting_size * n_tables bytes, arranged
    as (a prime count of) 128-byte blocks instead of n_tables prime
    tables.
    """

    storage_kind = "blocked"
    supports_bigcount = False

    def __init__(self, ksize, starting_size, n_tables=SUB, primes=None):
        if primes is not None:
            nblocks = int(primes[0])
        else:
            want = max(int(starting_size) * max(int(n_tables), 1)
                       // LANES, 4)
            nblocks = K.get_n_primes_near_x(1, want + 1)[0]
        if nblocks > MAX_BLOCKS:
            raise ValueError("blocked sketch too large: %d blocks (max "
                             "%d)" % (nblocks, MAX_BLOCKS))
        super().__init__(ksize, 1, 0, primes=(nblocks,))

    @property
    def nblocks(self):
        return self._primes[0]

    def n_tables(self):
        return SUB

    def hashsizes(self):
        # four sub-tables of nblocks*32 counters each (so the FP-rate
        # guard computes (occupancy/subtable_size)**4 meaningfully)
        return [self._primes[0] * QUART] * SUB

    def _update_fn(self, with_event_new=False):
        return make_blocked_update(self.nblocks, with_event_new)

    def _get_fn(self):
        return make_blocked_get(self.nblocks)

    def _count_nonzero_t0(self):
        # occupancy proxy: nonzero counters of sub-table 0 (lanes 0..31)
        return int(_blocked_occupied(self.tables[0]))

    # -- persistence (OXLI-framed extension format) -----------------------

    def save(self, filename):
        from khmer_tpu.core import oxli_io

        raw = np.asarray(self.tables[0])
        with oxli_io._open_write(filename) as f:
            f.write(oxli_io.SAVED_SIGNATURE)
            f.write(bytes([oxli_io.SAVED_FORMAT_VERSION, SAVED_BLOCKED]))
            f.write(struct.pack("<IQQ", self.ksize(), self.nblocks,
                                self.n_occupied()))
            f.write(raw.tobytes())

    @classmethod
    def load(cls, filename):
        from khmer_tpu.core import oxli_io

        with oxli_io._open_read(filename) as f:
            oxli_io._check_header(f, SAVED_BLOCKED, filename,
                                  "blocked count sketch")
            ksize, nblocks, occupied = struct.unpack("<IQQ", f.read(20))
            data = f.read(nblocks * LANES)
            if len(data) != nblocks * LANES:
                raise OSError("Unexpected end of k-mer count file")
        obj = cls(ksize, 1, 1, primes=(nblocks,))
        obj.tables = (jnp.asarray(
            np.frombuffer(data, np.uint8).reshape(nblocks, LANES)),)
        obj._occupied_offset = occupied - obj._count_nonzero_t0()
        return obj


@jax.jit
def _blocked_occupied(table):
    return jnp.sum((table[:, :QUART] != 0).astype(jnp.uint64))


class BlockedCounttable(_MurmurMixin, _BlockedBase):
    """Blocked Count-Min with murmur hashing (blocked Counttable)."""


class BlockedCountgraph(HashgraphMixin, _TwoBitMixin, _BlockedBase):
    """Blocked Count-Min + de Bruijn graph ops (blocked Countgraph)."""

    def __init__(self, ksize, starting_size, n_tables=SUB, primes=None):
        _BlockedBase.__init__(self, ksize, starting_size, n_tables,
                              primes=primes)
        self._init_graph()
