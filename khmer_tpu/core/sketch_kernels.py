"""Jitted batch-update/query pipelines for the probabilistic sketches.

Device-side equivalents of the reference storage classes
(include/oxli/storage.hh): BitStorage (Bloom filter), ByteStorage
(Count-Min, 8-bit saturating + bigcount overflow), NibbleStorage (4-bit
Count-Min). The reference updates counters one k-mer at a time with atomic
ops; here a whole batch of hashes is committed at once through a
sort -> dedup -> gather -> modify -> scatter pipeline that is *exactly
equivalent to sequential order* of the batch:

- table contents: saturating counters are order-independent given per-bin
  totals (min(old + total, max)), so one deduplicated scatter per table is
  bit-exact.
- per-event "is new k-mer": the reference counts an add as new iff some
  table's bin was zero at that moment (storage.hh:571-624, :177-197).
  Within a batch only the *first* event to hit a given fresh bin gets
  credit; we reproduce this by sorting each table's bins and crediting
  only per-bin winners (ordered by original batch position).
- bigcount saturation info is returned compactly for the host-side
  overflow map (the reference keeps an unordered_map behind a spin lock).

Tables for one sketch are a tuple of 1-D uint8 device arrays (one per
prime-sized table). Batches are uint64 canonical hashes + validity mask.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_KCOUNT = 255      # reference: include/oxli/oxli.hh:81
MAX_BIGCOUNT = 65535  # reference: include/oxli/oxli.hh:82
NIBBLE_MAX = 15
# NOTE: np.uint64 for constants, not jnp.uint64: an eager jnp scalar is a
# device array, and a constant folded into a trace should stay on the host.
_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

# number of saturated-unique-hash slots returned per batch for host bigcount
SAT_SLOTS = 16384


def _u64(x):
    if isinstance(x, (int, np.integer)):
        return np.uint64(x)
    return jnp.asarray(x, dtype=jnp.uint64)


# --------------------------------------------------------------------------
# shared building blocks
# --------------------------------------------------------------------------


def _dedup_batch(hashes, valid, idx=None, with_slot_map=False):
    """Sort + dedup a batch of hashes preserving batch-order information.

    Returns dict with, per "unique slot" (M slots; inactive padded):
      uh       [M] u64   unique hash value
      ucnt     [M] i32   occurrences in batch (0 for inactive slots)
      ufirst   [M] i32   smallest batch index among occurrences
      uvalid   [M] bool  slot active
      slot_seg [M] i32   (with_slot_map) unique-slot id per ORIGINAL
                         batch position (M for invalid entries) — lets
                         callers project per-unique results back onto
                         per-event order without a second sort

    `idx` overrides the per-event order key (default: position in the
    batch) — the routed sharded consume passes GLOBAL stream indices so
    first-toucher credits stay sequential-exact after an all_to_all
    reshuffle (parallel/sharded.py).
    """
    M = hashes.shape[0]
    if idx is None:
        idx = jnp.arange(M, dtype=jnp.int32)
    inv = jnp.where(valid, jnp.uint8(0), jnp.uint8(1))
    if with_slot_map:
        pos = jnp.arange(M, dtype=jnp.int32)
        inv_s, h_s, idx_s, pos_s = jax.lax.sort(
            (inv, hashes, idx, pos), num_keys=2)
    else:
        inv_s, h_s, idx_s = jax.lax.sort((inv, hashes, idx), num_keys=2)
    v_s = inv_s == 0
    first = v_s & ((jnp.arange(M) == 0)
                   | (h_s != jnp.roll(h_s, 1))
                   | ~jnp.roll(v_s, 1))
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    seg = jnp.where(v_s, seg, M)  # invalid -> dropped by segment ops
    ones = jnp.where(v_s, jnp.int32(1), jnp.int32(0))
    ucnt = jax.ops.segment_sum(ones, seg, num_segments=M,
                               indices_are_sorted=True)
    ufirst = jax.ops.segment_min(idx_s, seg, num_segments=M,
                                 indices_are_sorted=True)
    uh = jax.ops.segment_max(h_s, seg, num_segments=M,
                             indices_are_sorted=True)
    uvalid = ucnt > 0
    out = {"uh": uh, "ucnt": ucnt, "ufirst": ufirst, "uvalid": uvalid}
    if with_slot_map:
        out["slot_seg"] = jnp.zeros(M, jnp.int32).at[pos_s].set(seg)
    return out


def _group_by_bin(bins, ufirst, active):
    """Sort unique-slot bins; group; mark per-bin winners (min ufirst).

    Returns (bins_s, perm, v_s, bwin, bseg): bin-sorted bins, permutation
    into unique-slot order, active flags, winner flags, segment ids
    (inactive rows get segment M, dropped by segment ops).
    """
    M = bins.shape[0]
    uidx = jnp.arange(M, dtype=jnp.int32)
    bins_m = jnp.where(active, bins, _U64_MAX)
    first_m = jnp.where(active, ufirst, jnp.int32(2**31 - 1))
    bins_s, _, perm = jax.lax.sort((bins_m, first_m, uidx), num_keys=2)
    v_s = jnp.take(active, perm)
    bfirst = v_s & ((jnp.arange(M) == 0)
                    | (bins_s != jnp.roll(bins_s, 1))
                    | ~jnp.roll(v_s, 1))
    bseg = jnp.cumsum(bfirst.astype(jnp.int32)) - 1
    bseg = jnp.where(v_s, bseg, M)
    return bins_s, perm, v_s, bfirst, bseg


def _scatter_set(table, idx, values, active):
    """Write values at idx where active; inactive writes are dropped."""
    safe_idx = jnp.where(active, idx, _u64(table.shape[0]))
    return table.at[safe_idx].set(values, mode="drop")


# --------------------------------------------------------------------------
# per-table update rules. Each returns (new_table, old_count_u, credit_u)
# in unique-slot order: the pre-batch count of the hash's bin and whether
# the hash is the first batch event to hit a fresh (zero) bin.
# --------------------------------------------------------------------------


def _byte_table_update(table, prime, d, lo=None, span=None):
    """ByteStorage: saturate at 255 (reference storage.hh:571-624).

    With lo/span, only bins in [lo, lo+span) are updated against a
    shard-local `table` of length span (bucket-range table sharding).
    """
    M = d["uh"].shape[0]
    bins = d["uh"] % _u64(prime)
    active = d["uvalid"]
    if lo is not None:
        active = active & (bins >= lo) & (bins < lo + _u64(span))
        bins = jnp.where(active, bins - lo, 0)
    bins_s, perm, v_s, bwin, bseg = _group_by_bin(bins, d["ufirst"],
                                                  active)
    cnt_s = jnp.take(d["ucnt"], perm)
    old_s = jnp.take(table, jnp.where(v_s, bins_s, _u64(0))).astype(jnp.int32)
    tot_per_bin = jax.ops.segment_sum(cnt_s, bseg, num_segments=M,
                                      indices_are_sorted=True)
    old_per_bin = jax.ops.segment_max(old_s, bseg, num_segments=M,
                                      indices_are_sorted=True)
    new_per_bin = jnp.minimum(old_per_bin + tot_per_bin, MAX_KCOUNT)
    new_s = jnp.take(new_per_bin, jnp.where(v_s, bseg, M - 1))
    table = _scatter_set(table, bins_s, new_s.astype(table.dtype), bwin)
    credit_s = bwin & (old_s == 0)
    old_u = jnp.full(M, jnp.int32(MAX_KCOUNT)).at[perm].set(
        jnp.where(v_s, old_s, MAX_KCOUNT))
    credit_u = jnp.zeros(M, bool).at[perm].set(credit_s)
    return table, old_u, credit_u


def _nibble_phase(table, prime, d, parity):
    """One parity class of NibbleStorage (even bins=high nibble).

    reference: include/oxli/storage.hh:245-405.
    """
    M = d["uh"].shape[0]
    bins = d["uh"] % _u64(prime)
    sel = d["uvalid"] & ((bins % _u64(2)).astype(jnp.int32) == parity)
    bins_s, perm, v_s, bwin, bseg = _group_by_bin(bins, d["ufirst"], sel)
    cnt_s = jnp.take(d["ucnt"], perm)
    bytes_idx = bins_s // _u64(2)
    byte_old = jnp.take(table, jnp.where(v_s, bytes_idx, _u64(0)))
    shift = 4 if parity == 0 else 0
    mask = 0xF0 if parity == 0 else 0x0F
    old_nib = ((byte_old.astype(jnp.int32) & mask) >> shift)
    tot_per_bin = jax.ops.segment_sum(cnt_s, bseg, num_segments=M,
                                      indices_are_sorted=True)
    old_per_bin = jax.ops.segment_max(old_nib, bseg, num_segments=M,
                                      indices_are_sorted=True)
    new_nib_bin = jnp.minimum(old_per_bin + tot_per_bin, NIBBLE_MAX)
    new_nib = jnp.take(new_nib_bin, jnp.where(v_s, bseg, M - 1))
    new_byte = ((byte_old.astype(jnp.int32) & (0xFF ^ mask))
                | (new_nib << shift)).astype(table.dtype)
    table = _scatter_set(table, bytes_idx, new_byte, bwin)
    credit_s = bwin & (old_nib == 0)
    old_u_phase = jnp.full(M, jnp.int32(NIBBLE_MAX)).at[perm].set(
        jnp.where(v_s, old_nib, NIBBLE_MAX))
    credit_u = jnp.zeros(M, bool).at[perm].set(credit_s)
    return table, old_u_phase, credit_u


def _nibble_table_update(table, prime, d):
    table, old_e, cred_e = _nibble_phase(table, prime, d, 0)
    table, old_o, cred_o = _nibble_phase(table, prime, d, 1)
    return table, jnp.minimum(old_e, old_o), cred_e | cred_o


def _bit_table_update(table, prime, d):
    """BitStorage Bloom filter (reference storage.hh:95-229)."""
    M = d["uh"].shape[0]
    bins = d["uh"] % _u64(prime)
    bins_s, perm, v_s, bwin, bseg = _group_by_bin(bins, d["ufirst"],
                                                  d["uvalid"])
    byte_idx = bins_s // _u64(8)
    bitval = (jnp.int32(1) << (bins_s % _u64(8)).astype(jnp.int32))
    old_byte = jnp.take(table, jnp.where(v_s, byte_idx, _u64(0))
                        ).astype(jnp.int32)
    old_bit = (old_byte & bitval) != 0
    # bins sorted implies bytes sorted; group bins by byte for the scatter
    byfirst = v_s & ((jnp.arange(M) == 0)
                     | (byte_idx != jnp.roll(byte_idx, 1))
                     | ~jnp.roll(v_s, 1))
    byseg = jnp.cumsum(byfirst.astype(jnp.int32)) - 1
    byseg = jnp.where(v_s, byseg, M)
    # OR of the winner bits in this byte == sum (bits are distinct powers)
    or_mask = jax.ops.segment_sum(jnp.where(bwin, bitval, 0), byseg,
                                  num_segments=M, indices_are_sorted=True)
    new_byte_per = jnp.take(or_mask, jnp.where(v_s, byseg, M - 1)) | old_byte
    table = _scatter_set(table, byte_idx, new_byte_per.astype(table.dtype),
                         byfirst)
    credit_s = bwin & ~old_bit
    credit_u = jnp.zeros(M, bool).at[perm].set(credit_s)
    old_u = jnp.ones(M, jnp.int32).at[perm].set(
        jnp.where(v_s & ~old_bit, 0, 1))
    return table, old_u, credit_u


_TABLE_UPDATE = {
    "byte": _byte_table_update,
    "nibble": _nibble_table_update,
    "bit": _bit_table_update,
}

# --------------------------------------------------------------------------
# sort-free "image" update for byte tables (the counting hot path).
#
# Instead of sort->dedup->segment ops, use two scratch images the size of
# the largest table:
#   delta  = scatter-add of ones        (per-bin batch totals)
#   minidx = scatter-min of batch index (per-bin first-hitter)
# then new_table = min(table + delta, 255) as one full-table vector op.
# Per-event statistics follow from gathers:
#   winner(e)  = minidx[bin(e)] == e     (first event to hit the bin)
#   credit(e)  = winner & old == 0       -> exact n_unique semantics
#   post(e)    = min(old + delta, 255)   -> bigcount candidates
# This is sequential-equivalent like the sort path (see _dedup_batch
# docs). Extra memory: 2 x 4 bytes per bucket of the largest table,
# reused across tables.
# --------------------------------------------------------------------------

# use the image path when the scratch images fit comfortably (2 int32
# images of max(prime) buckets)
IMAGE_PATH_MAX_PRIME = int(3e8)

_I32_MAX = np.int32(2**31 - 1)


def _byte_image_table_update(table, prime, hashes, valid, eidx,
                             img_size, with_post=True):
    M = hashes.shape[0]
    bins = hashes % _u64(prime)
    safe = jnp.where(valid, bins, _u64(img_size))
    delta = jnp.zeros(img_size, jnp.int32).at[safe].add(1, mode="drop")
    minidx = jnp.full(img_size, _I32_MAX, jnp.int32).at[safe].min(
        eidx, mode="drop")
    gidx = jnp.where(valid, bins, _u64(0))
    old_e = jnp.take(table, gidx).astype(jnp.int32)
    new_table = jnp.minimum(
        table.astype(jnp.int32) + delta[: table.shape[0]],
        MAX_KCOUNT).astype(jnp.uint8)
    winner_e = valid & (jnp.take(minidx, gidx) == eidx)
    credit_e = winner_e & (old_e == 0)
    if with_post:
        delta_e = jnp.take(delta, gidx)
        post_e = jnp.minimum(old_e + delta_e, MAX_KCOUNT)
        post_e = jnp.where(valid, post_e, 0)
    else:
        post_e = None
    old_e = jnp.where(valid, old_e, MAX_KCOUNT)
    return new_table, old_e, credit_e, post_e


def _apply_image_update(primes, tables, hashes, valid, with_post=True):
    """Image-path update of all byte tables.

    Returns (tables, any_credit_e, min_old_e, min_post_e) — per-event.
    """
    M = hashes.shape[0]
    img_size = max(int(p) for p in primes)
    eidx = jnp.arange(M, dtype=jnp.int32)
    any_credit = jnp.zeros(M, bool)
    min_old = jnp.full(M, jnp.int32(MAX_KCOUNT))
    min_post = jnp.full(M, jnp.int32(MAX_KCOUNT)) if with_post else None
    new_tables = []
    for t, p in enumerate(primes):
        tbl, old_e, credit_e, post_e = _byte_image_table_update(
            tables[t], p, hashes, valid, eidx, img_size, with_post)
        new_tables.append(tbl)
        any_credit = any_credit | credit_e
        min_old = jnp.minimum(min_old, old_e)
        if with_post:
            min_post = jnp.minimum(min_post, post_e)
    return tuple(new_tables), any_credit, min_old, min_post


def image_update_outputs(primes, tables, n_unique, hashes, valid,
                         with_bigcount, with_event_new):
    """Shared tail for image-path update functions."""
    M = hashes.shape[0]
    tables, any_credit, min_old, min_post = _apply_image_update(
        primes, tables, hashes, valid, with_post=with_bigcount)
    n_unique = n_unique + jnp.sum(
        jnp.where(any_credit, 1, 0)).astype(jnp.uint64)
    out = {}
    if with_event_new:
        out["event_new"] = any_credit
    if with_bigcount:
        # candidate events: every table bin saturated post-batch. The
        # host reconstructs exact per-hash trigger counts from the
        # compacted (hash, min_old) pairs (bigcount is rare).
        cand = valid & (min_post == MAX_KCOUNT)
        out["satev_total"] = jnp.sum(cand.astype(jnp.int32))
        slots = min(SAT_SLOTS, M)
        sat_idx = jnp.nonzero(cand, size=slots, fill_value=M - 1)[0]
        picked = jnp.take(cand, sat_idx)
        out["satev_hash"] = jnp.where(picked, jnp.take(hashes, sat_idx),
                                      _U64_MAX)
        out["satev_m"] = jnp.where(picked, jnp.take(min_old, sat_idx),
                                   -1)
        # full per-event views: only fetched by the host when the
        # compacted slots overflow (heavy saturation)
        out["satev_cand_full"] = cand
        out["satev_hash_full"] = hashes
        out["satev_m_full"] = min_old
    return tables, n_unique, out


def use_image_path(kind, primes):
    return (kind == "byte" and primes
            and max(int(p) for p in primes) <= IMAGE_PATH_MAX_PRIME)


# --------------------------------------------------------------------------
# v2 fused byte-table update: the counting speed-of-light path.
#
# The image path does 4 random ops per (event, table): scatter-add,
# scatter-min, gather-old, gather-minidx. v2 reduces it to ~2 random ops
# per (event, table) plus one sort per batch:
#
#   1. ONE stable sort of (invalid, hash, idx) dedups equal hashes;
#      per-run stats (count, first batch index) come from a reverse
#      associative scan — pure vector work, no hidden scatters.
#   2. ONE concatenated scatter-add of per-unique counts into a flat
#      [sum(primes)] delta image covers all tables in a single call.
#   3. ONE full-image vector pass packs (old_count << 23 | delta) and
#      writes the new saturated tables; ONE concatenated gather of the
#      packed word gives each (event, table) both its pre-batch count
#      and its bin's batch total.
#   4. n_unique credit: an add is "new" iff some table bin was zero at
#      that moment (storage.hh:577-592). A unique hash whose bin total
#      equals its own occurrence count is alone in that bin, so credit
#      is just (old == 0). The rare uniques sharing a bin (delta >
#      ucnt) are compacted into a fixed RES-slot buffer and resolved
#      exactly by a small sort (winner = smallest first-index). If a
#      batch ever exceeds RES collisions the step sets a sticky
#      overflow flag; callers check it once per stream and re-run via
#      the fallback path (never silently wrong).
#
# Sequential-equivalence argument is the same as the image path's (see
# module docstring); only the mechanics differ.
# --------------------------------------------------------------------------


def check_v2_overflow(overflow):
    """Raise if a v2 batch exceeded its collision-resolution budget.

    This is the exactness backstop for the fast consume path: it can
    only trip on data whose in-batch cross-hash bin collisions exceed
    1/4 of the batch, which requires tables far smaller than the v2
    gate permits. Setting KHMER_TPU_NO_V2=1 falls back to the always-
    safe image/sort paths.
    """
    if bool(overflow):
        raise RuntimeError(
            "k-mer batch exceeded the fast-path collision budget — the "
            "sketch is far too small for this stream. Increase the "
            "table size; for khmer-layout sketches KHMER_TPU_NO_V2=1 "
            "selects the always-safe fallback consume path")


def use_v2_path(kind, primes, m):
    """v2 needs bins >> batch so cross-hash bin sharing stays rare.

    Small batches (m <= 4096) always qualify: their resolution buffer
    covers every possible collision, so the path is unconditionally
    exact there.
    """
    import os

    if os.environ.get("KHMER_TPU_NO_V2"):
        return False
    if kind != "byte" or not primes:
        return False
    if m >= 1 << 23:
        return False  # per-bin batch total must fit the packed word
    primes = [int(p) for p in primes]
    if sum(primes) >= 2**31 - 1:
        return False  # flat image must be i32-indexable
    return min(primes) >= 16 * m or m <= 4096


def _run_stats(hashes, valid):
    """Sort + run-length dedup with scan-based per-run stats.

    Returns dict, all in hash-sorted order (invalid entries last):
      head   [M] bool  first entry of each equal-hash run (the unique)
      uh     [M] u64   hash value
      ucnt   [M] i32   run length (occurrences in batch; 0 off-head)
      ufirst [M] i32   smallest original batch index in the run
    """
    M = hashes.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)
    inv = jnp.where(valid, jnp.uint8(0), jnp.uint8(1))
    inv_s, h_s, idx_s = jax.lax.sort((inv, hashes, idx), num_keys=2)
    v_s = inv_s == 0
    head = v_s & ((idx == 0) | (h_s != jnp.roll(h_s, 1))
                  | ~jnp.roll(v_s, 1))
    nvalid = jnp.sum(v_s.astype(jnp.int32)).astype(jnp.int32)
    # next head position at-or-after i, scanned right-to-left
    nxt = jax.lax.associative_scan(
        jnp.minimum, jnp.where(head, idx, jnp.int32(M)), reverse=True)
    nxt_after = jnp.concatenate([nxt[1:], jnp.full(1, M, jnp.int32)])
    ucnt = jnp.where(head, jnp.minimum(nxt_after, nvalid) - idx, 0)
    return {"head": head, "uh": h_s, "ucnt": ucnt, "ufirst": idx_s}


def _sort_compact(flags, size):
    """Positions of set flags, ascending, via ONE stable pair sort.

    Drop-in for jnp.nonzero(flags, size=size, fill_value=n).
    Returns i32 positions; unset slots hold n (= len(flags)).
    """
    n = flags.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(flags, jnp.uint8(0), jnp.uint8(1))
    _, pos_s = jax.lax.sort((key, pos), num_keys=1)
    live = jnp.arange(size) < jnp.sum(flags.astype(jnp.int32))
    return jnp.where(live, pos_s[:size], jnp.int32(n))


def _resolve_collisions(collided, counter_id, id_bound, ufirst, old_te,
                        credit, overflow, res):
    """Exact winner-by-order credit for batch-shared counters.

    collided/counter_id/old_te are [T, M]; counter_id holds a globally
    unique i32 id per (table, bin) with id_bound (static int) marking
    inactive entries. The collided entries are compacted into `res` slots via a
    stable pair sort, grouped by counter id, and the smallest-ufirst
    entry of each fresh (old == 0) group earns the new-k-mer credit.
    Sets `overflow` if more than `res` entries collide (the caller
    raises rather than miscount).
    """
    T, M = collided.shape
    n_col = jnp.sum(collided.astype(jnp.int32))
    overflow = overflow | (n_col > res)
    pos = _sort_compact(collided.ravel(), res)
    live = pos < T * M
    bound = jnp.int32(id_bound)
    cbin = jnp.where(live, jnp.take(counter_id.ravel(), pos,
                                    fill_value=np.int32(id_bound),
                                    mode="fill"),
                     bound)
    corder = jnp.where(live, jnp.take(ufirst, pos % M), jnp.int32(M))
    cold = jnp.take(old_te.ravel(), pos, fill_value=1, mode="fill")
    cbin_s, corder_s, pos_s, cold_s = jax.lax.sort(
        (cbin, corder, pos, cold), num_keys=2)
    ridx = jnp.arange(res, dtype=jnp.int32)
    cwin = (cbin_s < bound) & ((ridx == 0)
                               | (cbin_s != jnp.roll(cbin_s, 1)))
    extra = cwin & (cold_s == 0)
    credit = credit.ravel().at[
        jnp.where(extra, pos_s, jnp.int32(T * M))].set(
        True, mode="drop").reshape(T, M)
    return credit, overflow


def v2_update_core(primes, tables, n_unique, overflow, hashes, valid,
                   with_bigcount, with_event_new):
    """Fused v2 update. Returns (tables, n_unique, overflow, out)."""
    M = hashes.shape[0]
    T = len(primes)
    offsets = np.cumsum([0] + [int(p) for p in primes])
    sum_p = int(offsets[-1])
    # collision-resolution slots: total coverage for small batches;
    # for large batches the v2 gate (bins >= 16x batch) bounds the
    # expected collided uniques near M/8, so M//4 has 2x headroom and
    # the sticky overflow flag guards the tail.
    res = T * M if M <= 4096 else max(M // 4, 4096)

    d = _run_stats(hashes, valid)
    head, uh, ucnt, ufirst = d["head"], d["uh"], d["ucnt"], d["ufirst"]

    # flat bin index per (table, unique): [T, M] i32
    gidx = jnp.stack([
        (uh % _u64(p) + _u64(offsets[t])).astype(jnp.int32)
        for t, p in enumerate(primes)])
    scatter_idx = jnp.where(head[None, :], gidx, jnp.int32(sum_p))

    # one scatter-add for all tables
    delta = jnp.zeros(sum_p, jnp.int32).at[scatter_idx.ravel()].add(
        jnp.broadcast_to(ucnt, (T, M)).ravel(), mode="drop")

    # full-image pass: pack (old << 8 | min(delta, 255)) into u16, so
    # one narrow packed gather replaces separate old/delta gathers —
    # and write the saturated tables
    old_concat = jnp.concatenate(
        [t.astype(jnp.int32) for t in tables])
    delta_c = jnp.minimum(delta, MAX_KCOUNT)
    packed = ((old_concat << 8) | delta_c).astype(jnp.uint16)
    new_tables = tuple(
        jnp.minimum(old_concat[offsets[t]:offsets[t + 1]]
                    + delta_c[offsets[t]:offsets[t + 1]],
                    MAX_KCOUNT).astype(jnp.uint8)
        for t in range(T))

    # one gather for all (event, table) pairs
    g = packed.at[scatter_idx].get(mode="fill", fill_value=0).astype(
        jnp.int32)
    old_te = g >> 8                        # [T, M]
    delta_te = g & 0xFF                    # batch bin total, clamped

    # a clamped total is ambiguous, so a saturated bin goes through the
    # exact resolution path (all its uniques are flagged, so the
    # winner-by-order rule still sees the complete bin)
    alone = (delta_te == ucnt[None, :]) & (delta_te < MAX_KCOUNT)
    credit = alone & (old_te == 0) & head[None, :]

    # rare cross-hash bin sharing: exact winner via compacted sort
    collided = head[None, :] & ~alone
    credit, overflow = _resolve_collisions(
        collided, scatter_idx, sum_p, ufirst, old_te,
        credit, overflow, res)

    new_u = jnp.any(credit, axis=0)
    n_unique = n_unique + jnp.sum(
        jnp.where(new_u, 1, 0)).astype(jnp.uint64)

    out = {}
    if with_event_new:
        out["event_new"] = jnp.zeros(M, bool).at[
            jnp.where(new_u, ufirst, jnp.int32(M))].set(True, mode="drop")
    if with_bigcount:
        min_old = jnp.min(jnp.where(head[None, :], old_te, MAX_KCOUNT),
                          axis=0)
        triggers = ucnt - jnp.maximum(MAX_KCOUNT - min_old, 0)
        sat = head & (triggers > 0)
        out["sat_total"] = jnp.sum(sat.astype(jnp.int32))
        slots = min(SAT_SLOTS, M)
        sat_idx = _sort_compact(sat, slots)
        picked = sat_idx < M
        out["sat_hash"] = jnp.where(
            picked, jnp.take(uh, sat_idx, mode="fill",
                             fill_value=_U64_MAX), _U64_MAX)
        out["sat_triggers"] = jnp.where(
            picked, jnp.take(triggers, sat_idx, mode="fill",
                             fill_value=0), 0)
    return new_tables, n_unique, overflow, out


def _apply_update(kind, primes, tables, d):
    """Update all tables; returns (tables, min_old_u, any_credit_u)."""
    M = d["uh"].shape[0]
    new_tables = []
    min_old = jnp.full(M, jnp.int32(MAX_KCOUNT))
    any_credit = jnp.zeros(M, bool)
    fn = _TABLE_UPDATE[kind]
    for t, p in enumerate(primes):
        tbl, old_u, credit_u = fn(tables[t], p, d)
        new_tables.append(tbl)
        min_old = jnp.minimum(min_old, old_u)
        any_credit = any_credit | credit_u
    return tuple(new_tables), min_old, any_credit


# --------------------------------------------------------------------------
# public factories
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def make_update(kind, primes, with_bigcount=False, with_event_new=False):
    """Batch-consume for a sketch.

    update(tables, n_unique, hashes[M] u64, valid[M] bool)
      -> (tables, out) with out.n_unique (+ bigcount report / event_new).
    """
    primes = tuple(int(p) for p in primes)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def update(tables, n_unique, hashes, valid):
        M = hashes.shape[0]
        if use_v2_path(kind, primes, M):
            tables, n_unique, overflow, out = v2_update_core(
                primes, tables, n_unique, jnp.zeros((), bool),
                hashes, valid, with_bigcount, with_event_new)
            out["n_unique"] = n_unique
            out["v2_overflow"] = overflow
            return tables, out
        if use_image_path(kind, primes):
            tables, n_unique, out = image_update_outputs(
                primes, tables, n_unique, hashes, valid, with_bigcount,
                with_event_new)
            out["n_unique"] = n_unique
            return tables, out
        d = _dedup_batch(hashes, valid)
        tables, min_old, any_credit = _apply_update(kind, primes, tables, d)
        new_u = d["uvalid"] & any_credit
        n_unique = n_unique + jnp.sum(
            jnp.where(new_u, 1, 0)).astype(jnp.uint64)
        out = {"n_unique": n_unique}
        if with_event_new:
            out["event_new"] = jnp.zeros(M, bool).at[
                jnp.where(new_u, d["ufirst"], M)].set(True, mode="drop")
        if with_bigcount:
            # occurrences beyond the point where every table bin is at max
            triggers = d["ucnt"] - jnp.maximum(MAX_KCOUNT - min_old, 0)
            sat = d["uvalid"] & (triggers > 0)
            out["sat_total"] = jnp.sum(sat.astype(jnp.int32))
            slots = min(SAT_SLOTS, M)
            sat_idx = jnp.nonzero(sat, size=slots, fill_value=M - 1)[0]
            out["sat_hash"] = jnp.take(d["uh"], sat_idx)
            out["sat_triggers"] = jnp.where(
                jnp.take(sat, sat_idx), jnp.take(triggers, sat_idx), 0)
        return tables, out

    return update


def _gather_counts(kind, primes, tables, hashes):
    if kind == "blocked":
        from khmer_tpu.core import blocked

        return blocked.gather_counts(primes[0], tables, hashes)
    if kind == "byte":
        counts = jnp.full(hashes.shape, jnp.uint16(MAX_KCOUNT))
        for t, p in enumerate(primes):
            c = jnp.take(tables[t], hashes % _u64(p)).astype(jnp.uint16)
            counts = jnp.minimum(counts, c)
        return counts
    elif kind == "nibble":
        counts = jnp.full(hashes.shape, jnp.uint16(NIBBLE_MAX))
        for t, p in enumerate(primes):
            bins = hashes % _u64(p)
            byte = jnp.take(tables[t], bins // _u64(2)).astype(jnp.uint16)
            odd = (bins % _u64(2)).astype(jnp.uint16)
            nib = jnp.where(odd == 1, byte & 0xF, byte >> 4)
            counts = jnp.minimum(counts, nib)
        return counts
    elif kind == "bit":
        present = jnp.ones(hashes.shape, bool)
        for t, p in enumerate(primes):
            bins = hashes % _u64(p)
            byte = jnp.take(tables[t], bins // _u64(8)).astype(jnp.int32)
            bit = (jnp.int32(1) << (bins % _u64(8)).astype(jnp.int32))
            present = present & ((byte & bit) != 0)
        return present.astype(jnp.uint16)
    raise ValueError(kind)


@functools.lru_cache(maxsize=None)
def make_pertable_get(kind, primes):
    """Per-table counts for a hash array: (tables, hashes[n]) -> [T, n]."""
    primes = tuple(int(p) for p in primes)

    @jax.jit
    def get(tables, hashes):
        per = []
        for t, p in enumerate(primes):
            bins = hashes % _u64(p)
            if kind == "byte":
                c = jnp.take(tables[t], bins).astype(jnp.uint16)
            elif kind == "nibble":
                byte = jnp.take(tables[t], bins // _u64(2)).astype(
                    jnp.uint16)
                odd = (bins % _u64(2)).astype(jnp.uint16)
                c = jnp.where(odd == 1, byte & 0xF, byte >> 4)
            else:
                byte = jnp.take(tables[t], bins // _u64(8)).astype(
                    jnp.int32)
                bit = (jnp.int32(1)
                       << (bins % _u64(8)).astype(jnp.int32))
                c = ((byte & bit) != 0).astype(jnp.uint16)
            per.append(c)
        return jnp.stack(per)

    return get


@functools.lru_cache(maxsize=None)
def make_get(kind, primes):
    """Batch count lookup: get(tables, hashes[...]) -> uint16 counts."""
    primes = tuple(int(p) for p in primes)

    @jax.jit
    def get(tables, hashes):
        return _gather_counts(kind, primes, tables, hashes)

    return get


@functools.lru_cache(maxsize=None)
def make_abund_dist(track_kind, track_primes, main_kind, main_primes):
    """Fused abundance-distribution step (reference hashtable.cc:451-502).

    Per event, in order: if tracking count is 0, add to tracking and
    histogram the main sketch's count. Returns updated tracking tables,
    histogram increment, and the saturated slots (count==MAX_KCOUNT) for
    host-side bigcount fixup.
    """
    track_primes = tuple(int(p) for p in track_primes)
    main_primes = tuple(int(p) for p in main_primes)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(track_tables, dist, main_tables, hashes, valid):
        M = hashes.shape[0]
        d = _dedup_batch(hashes, valid)
        track_tables, _, any_credit = _apply_update(
            track_kind, track_primes, track_tables, d)
        counted = d["uvalid"] & any_credit
        counts = _gather_counts(main_kind, main_primes, main_tables,
                                d["uh"]).astype(jnp.int32)
        # saturated counts defer to the host (bigcount map)
        is_sat = counted & (counts == MAX_KCOUNT)
        hist_idx = jnp.where(counted & ~is_sat, counts, MAX_BIGCOUNT + 1)
        dist = dist.at[hist_idx].add(1, mode="drop")
        n_sat = jnp.sum(is_sat.astype(jnp.int32))
        slots = min(SAT_SLOTS, M)
        sat_idx = jnp.nonzero(is_sat, size=slots, fill_value=M - 1)[0]
        sat_hash = jnp.where(jnp.take(is_sat, sat_idx),
                             jnp.take(d["uh"], sat_idx), _U64_MAX)
        return track_tables, dist, n_sat, sat_hash

    return step


# --------------------------------------------------------------------------
# occupancy reductions (n_occupied == nonzero bins of table 0; the
# reference tracks first-table 0->1 transitions: storage.hh:581-589)
# --------------------------------------------------------------------------


@jax.jit
def byte_occupied(table0):
    return jnp.sum((table0 != 0).astype(jnp.uint64))


@functools.lru_cache(maxsize=None)
def make_nibble_occupied(prime):
    @jax.jit
    def f(table0):
        hi = (table0 >> 4) != 0
        lo = (table0 & 0xF) != 0
        return (jnp.sum(hi.astype(jnp.uint64))
                + jnp.sum(lo.astype(jnp.uint64)))

    return f


@jax.jit
def bit_occupied(table0):
    return jnp.sum(jax.lax.population_count(table0).astype(jnp.uint64))


def _zeros_touched(shape):
    # np.zeros maps lazy pages; fill(0) touches them up front so the
    # first consume doesn't pay the fault storm (the reference's
    # constructors memset eagerly, storage.hh:138)
    a = np.empty(shape, dtype=np.uint8)
    a.fill(0)
    return a


def init_host_tables(kind, primes):
    """Zeroed host (numpy) tables matching the device layouts."""
    if kind == "blocked":
        from khmer_tpu.core import blocked

        return tuple(_zeros_touched((int(p), blocked.LANES))
                     for p in primes)
    arrays = []
    for p in primes:
        p = int(p)
        if kind == "byte":
            n = p
        elif kind == "nibble":
            n = p // 2 + 1
        elif kind == "bit":
            n = p // 8 + 1
        else:
            raise ValueError(kind)
        arrays.append(_zeros_touched(n))
    return tuple(arrays)


def host_occupied(kind, table0):
    """Host mirror of the occupied-bin counters above."""
    if kind == "byte":
        return int(np.count_nonzero(table0))
    if kind == "nibble":
        return int(np.count_nonzero(table0 >> 4)
                   + np.count_nonzero(table0 & 0xF))
    if kind == "bit":
        return int(np.count_nonzero(np.unpackbits(table0)))
    raise ValueError(kind)


def init_tables(kind, primes):
    """Allocate zeroed device tables for a storage kind."""
    if kind == "blocked":
        from khmer_tpu.core import blocked

        return tuple(jnp.zeros((int(p), blocked.LANES), dtype=jnp.uint8)
                     for p in primes)
    arrays = []
    for p in primes:
        p = int(p)
        if kind == "byte":
            n = p
        elif kind == "nibble":
            n = p // 2 + 1
        elif kind == "bit":
            n = p // 8 + 1
        else:
            raise ValueError(kind)
        arrays.append(jnp.zeros(n, dtype=jnp.uint8))
    return tuple(arrays)


def get_n_primes_near_x(n_tables: int, x: int):
    """Descending primes just below x.

    Reference: hashtable.hh:99-123 / khmer/__init__.py:56-83 (which
    accepts float x and raises RuntimeError when too few primes fit).
    """
    x = int(x)
    if x == 1 and n_tables == 1:
        return [1]

    def is_prime(num):
        if num < 2:
            return False
        if num == 2:
            return True
        if num % 2 == 0:
            return False
        i = 3
        while i * i <= num:
            if num % i == 0:
                return False
            i += 2
        return True

    primes = []
    i = x - 1
    if i % 2 == 0:
        i -= 1
    while len(primes) != n_tables and i > 0:
        if is_prime(i):
            primes.append(i)
        if i == 1:
            break
        i -= 2
    if len(primes) != n_tables:
        raise RuntimeError("unable to find %d prime numbers < %d"
                           % (n_tables, x))
    return primes
