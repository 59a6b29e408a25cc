"""Multi-chip sharded counting over a jax.sharding.Mesh.

Mesh replacement for khmer's shared-memory parallelism
(threads + atomics, reference src/oxli/read_parsers.cc:334,
storage.hh:183,600) and its hash-banding work decomposition
(src/oxli/kmer_hash.cc:261-275):

- the read stream (flat code chunk) is sharded across devices ("data
  parallel"); each device hashes its slice, with a k-1 halo fetched
  from the right neighbor via ppermute (sequence-sharding idiom);
- each sketch table is sharded by *bucket range* across devices
  (tensor-parallel analog of khmer's banding; bands compose exactly,
  reference tests/test_banding.py);
- hashes are all-gathered (or, routed, sent to their owner with one
  all_to_all); every device updates only the
  bucket range it owns, so the serial scatter work is split D ways;
- per-event new-k-mer credits are OR-reduced (psum on one-hot bools)
  so n_unique keeps the reference's exact sequential semantics.

Works identically on a virtual CPU mesh (tests / dry-run) and on
several GPUs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from khmer_tpu.core import sketch_kernels as K
from khmer_tpu.ops import hashing as H

AXIS = "shard"


def make_mesh(devices=None):
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (AXIS,))


def _pad_to(n, m):
    return ((n + m - 1) // m) * m


def _route_capacity(local, D, slack):
    """Per-destination route slots: ``slack * local/D`` with a
    statistical floor. Destination loads are ~Binomial(local, 1/D), so
    small batches need absolute headroom (8 sigma + 16), not just a
    multiplier — without the floor, tiny chunks overflow on ordinary
    hash variance and the overflow guard aborts the stream."""
    mean = local / max(D, 1)
    sigma = (mean * (1.0 - 1.0 / max(D, 1))) ** 0.5
    return max(-(-int(local * slack) // D),
               int(mean + 8.0 * sigma) + 16)


class ShardedCountgraph:
    """Countgraph with bucket-range-sharded tables over a device mesh.

    With ``route=True`` events travel to their per-table bucket-range
    owner over an ``all_to_all`` (one collective carrying all
    n_tables sub-streams), so each device sorts and scatters only
    ~n_tables/D of the stream instead of running the full-stream dedup
    replicated (SURVEY §2.9 "all-to-all route (hash->owner chip) then
    local scatter-add" — for the exact layout too, matching the
    reference's banding decomposition kmer_hash.cc:261-275). Route
    capacity is ``slack * local/D`` per (table, src, dst) triple with
    a Binomial statistical floor; an overflowed chunk is replayed on
    the gathered path and routing demotes — never an undercount,
    never an abort.
    """

    storage_kind = "byte"
    hash_family = "twobit"

    def __init__(self, ksize, starting_size, n_tables, mesh,
                 primes=None, route="auto", route_slack=1.15):
        self.mesh = mesh
        self.D = mesh.devices.size
        self._ksize = int(ksize)
        if primes is None:
            primes = K.get_n_primes_near_x(int(n_tables),
                                           int(starting_size))
        self._primes = tuple(int(p) for p in primes)
        # shard boundaries: table t device d owns [d*S_t, (d+1)*S_t)
        self._shard_sizes = tuple(_pad_to(p, self.D) // self.D
                                  for p in self._primes)
        if route == "auto":
            # routed from D=4 up, gathered below: the crossover was
            # chosen on a virtual CPU mesh and is not measured on GPUs
            # (ROADMAP Speed #5)
            route = self.D >= 4
        self.route = bool(route) and self.D > 1
        self.route_slack = float(route_slack)
        sharding = NamedSharding(mesh, P(AXIS))
        self.tables = tuple(
            jax.device_put(jnp.zeros(s * self.D, jnp.uint8), sharding)
            for s in self._shard_sizes)
        self._n_unique = jnp.zeros((), jnp.uint64)
        self._overflow = jnp.zeros((), bool)

    def ksize(self):
        return self._ksize

    def hashsizes(self):
        return list(self._primes)

    def n_unique_kmers(self):
        self._check_route_overflow()
        return int(self._n_unique)

    def _check_route_overflow(self):
        if self.route and bool(self._overflow):
            raise RuntimeError(
                "all_to_all route capacity overflow (skewed k-mer "
                "stream): rebuild with route=False or a larger "
                "route_slack")

    def consume_chunk(self, codes, starts, nfill):
        """Commit one flat chunk (see pipeline.FlatPacker) to the
        sharded tables.

        A chunk skewed enough to overflow the route capacity (one
        k-mer dominating a source slice — duplicates of a hash all
        target the same destination slots) is transparently REPLAYED
        on the always-exact gathered path and routing is demoted for
        the rest of the stream: never an undercount, never an abort.
        """
        sharding = NamedSharding(self.mesh, P(AXIS))
        codes = jax.device_put(jnp.asarray(codes), sharding)
        starts = jax.device_put(jnp.asarray(starts),
                                NamedSharding(self.mesh, P()))
        if self.route:
            fn = make_sharded_consume_routed(
                self._primes, self._shard_sizes, self._ksize,
                len(codes), self.mesh, self.route_slack)
            tables, n_unique, overflow, n_cons = fn(
                self.tables, self._n_unique, self._overflow,
                codes, starts, jnp.int32(nfill))
            if not bool(overflow):
                self.tables, self._n_unique, self._overflow = \
                    tables, n_unique, overflow
                return int(n_cons)
            del tables, n_unique, overflow
            self._demote_route()
        fn = make_sharded_consume(self._primes, self._shard_sizes,
                                  self._ksize, len(codes), self.mesh)
        self.tables, self._n_unique, n_cons = fn(
            self.tables, self._n_unique, codes, starts,
            jnp.int32(nfill))
        return int(n_cons)

    def _demote_route(self):
        import warnings

        warnings.warn(
            "all_to_all route capacity overflow (skewed k-mer "
            "stream): chunk replayed on the gathered path and routing "
            "disabled for the rest of this stream; raise route_slack "
            "to keep routing on such data", RuntimeWarning,
            stacklevel=3)
        self.route = False

    def get_counts(self, hashes):
        """Min-over-tables counts for an array of hashes."""
        fn = make_sharded_get(self._primes, self._shard_sizes, self.mesh,
                              int(hashes.shape[0]))
        return np.asarray(fn(self.tables, jnp.asarray(hashes)))

    def to_local_countgraph(self):
        """Gather shards into a single-device Countgraph (for OXLI
        save or comparison)."""
        from khmer_tpu.core.sketch import Countgraph

        g = Countgraph(self._ksize, 1, 0, primes=self._primes)
        tabs = []
        for t, p in enumerate(self._primes):
            full = np.asarray(self.tables[t])[:p]
            tabs.append(jnp.asarray(full))
        g.tables = tuple(tabs)
        g._n_unique = self._n_unique
        return g


@functools.lru_cache(maxsize=None)
def make_sharded_consume(primes, shard_sizes, k, chunk, mesh):
    """Fused sharded consume step over the mesh."""
    D = mesh.devices.size
    local = chunk // D
    W = chunk - k + 1

    def step(tables, n_unique, codes, starts, nfill):
        def body(tables, n_unique, codes_local, starts, nfill):
            d_idx = jax.lax.axis_index(AXIS)
            # halo: first k-1 bases of the right neighbor
            halo = jax.lax.ppermute(
                codes_local[: k - 1], AXIS,
                [(i, (i - 1) % D) for i in range(D)])
            ext = jnp.concatenate([codes_local, halo])
            _, f, r = H.rolling_hash_windows(ext[None, :], k)
            local_h = jnp.minimum(f, r)[0][:local]
            # gather the full hash stream (all-gather)
            hashes = jax.lax.all_gather(local_h, AXIS, tiled=True)[:W]
            # windows must stay within one read and inside the fill
            rid = jnp.zeros(chunk, jnp.int32).at[starts].add(
                1, mode="drop")
            rid = jnp.cumsum(rid)
            valid = (rid[:W] == rid[k - 1:]) & \
                (jnp.arange(W, dtype=jnp.int32) + (k - 1) < nfill)
            d = K._dedup_batch(hashes, valid)
            M = hashes.shape[0]
            any_credit = jnp.zeros(M, bool)
            new_tables = []
            for t, p in enumerate(primes):
                S = shard_sizes[t]
                lo = (d_idx * S).astype(jnp.uint64)
                tbl, old_u, credit_u = K._byte_table_update(
                    tables[t], p, d, lo=lo, span=S)
                new_tables.append(tbl)
                any_credit = any_credit | credit_u
            # ONE cross-device per-event join (the OR of zero-bin
            # credits; each (event, table) bin has a single owner)
            any_credit = jax.lax.psum(any_credit.astype(jnp.int32),
                                      AXIS) > 0
            new_u = d["uvalid"] & any_credit
            n_unique = n_unique + jnp.sum(
                jnp.where(new_u, 1, 0)).astype(jnp.uint64)
            n_cons = jnp.sum(valid).astype(jnp.uint64)
            return tuple(new_tables), n_unique, n_cons

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(tuple(P(AXIS) for _ in primes), P(), P(AXIS),
                      P(), P()),
            out_specs=(tuple(P(AXIS) for _ in primes), P(), P()),
            check_vma=False,
        )(tables, n_unique, codes, starts, nfill)

    return jax.jit(step, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def make_sharded_consume_routed(primes, shard_sizes, k, chunk, mesh,
                                slack):
    """all_to_all-routed exact-layout consume.

    Each device hashes its stream slice, then ships every event to the
    bucket-range owner of EACH prime table (n_tables sub-streams in
    one all_to_all). Owners dedup only what they receive — with the
    events' GLOBAL stream indices as the order key, so the per-bin
    first-toucher credit (reference ByteStorage::add zero-bin rule,
    storage.hh:571-624) is identical to the serial pass. Per-event
    credits are joined with the same W-length psum-OR as the gathered
    path.
    """
    D = mesh.devices.size
    T = len(primes)
    local = chunk // D
    W = chunk - k + 1
    C = _route_capacity(local, D, slack)  # per (table, src, dst)

    def step(tables, n_unique, overflow, codes, starts, nfill):
        def body(tables, n_unique, overflow, codes_local, starts, nfill):
            d_idx = jax.lax.axis_index(AXIS)
            halo = jax.lax.ppermute(
                codes_local[: k - 1], AXIS,
                [(i, (i - 1) % D) for i in range(D)])
            ext = jnp.concatenate([codes_local, halo])
            _, f, r = H.rolling_hash_windows(ext[None, :], k)
            local_h = jnp.minimum(f, r)[0][:local]

            gidx = d_idx * local + jnp.arange(local, dtype=jnp.int32)
            # no read start may fall in (gidx, gidx+k-1]; starts is
            # small and sorted, so two searchsorteds beat a
            # chunk-length cumsum (replicated per-device work that
            # cannot shrink with D)
            n_le_hi = jnp.searchsorted(starts, gidx + (k - 1),
                                       side="right")
            n_le_lo = jnp.searchsorted(starts, gidx, side="right")
            valid = (n_le_hi == n_le_lo) & (gidx < W) & \
                (gidx + (k - 1) < nfill)

            # one send buffer carrying all T sub-streams: slot layout
            # per destination row is [t0: C][t1: C]...[tT-1: C]
            send_h = jnp.zeros(D * T * C, jnp.uint64)
            send_i = jnp.full(D * T * C, jnp.int32(W))
            over_any = jnp.zeros((), bool)
            owner_slots = []
            for t, p in enumerate(primes):
                S = shard_sizes[t]
                bins = local_h % np.uint64(p)
                owner = jnp.where(
                    valid, (bins // np.uint64(S)).astype(jnp.int32),
                    jnp.int32(D))
                onehot = owner[:, None] == jnp.arange(D, dtype=jnp.int32)
                rank = jnp.sum(jnp.where(
                    onehot, jnp.cumsum(onehot.astype(jnp.int32),
                                       axis=0) - 1, 0), axis=1)
                over = valid & (rank >= C)
                over_any = over_any | jnp.any(over)
                slot = jnp.where(valid & ~over,
                                 owner * (T * C) + t * C + rank,
                                 jnp.int32(D * T * C))
                owner_slots.append(slot)
                send_h = send_h.at[slot].set(local_h, mode="drop")
                send_i = send_i.at[slot].set(gidx, mode="drop")
            overflow = overflow | (jax.lax.psum(
                over_any.astype(jnp.int32), AXIS) > 0)

            # ONE fused collective: [dst, T*C hashes | T*C idx-as-u64]
            got = jax.lax.all_to_all(
                jnp.concatenate(
                    [send_h.reshape(D, T * C),
                     send_i.astype(jnp.uint64).reshape(D, T * C)],
                    axis=1),
                AXIS, 0, 0, tiled=False)
            routed_h = got[:, :T * C].reshape(D, T, C)
            routed_i = got[:, T * C:].astype(jnp.int32).reshape(D, T, C)

            # per-slot credit verdicts ride BACK over one all_to_all to
            # their source events instead of psum-ORing a W-length vote
            # vector (O(W) collective per device, r04's scaling tax) —
            # an event is new iff any table credits its first toucher
            new_tables = []
            back_votes = []
            for t, p in enumerate(primes):
                S = shard_sizes[t]
                lo = (d_idx * S).astype(jnp.uint64)
                h_t = routed_h[:, t, :].reshape(D * C)
                i_t = routed_i[:, t, :].reshape(D * C)
                v_t = i_t < W
                d = K._dedup_batch(h_t, v_t, idx=i_t,
                                   with_slot_map=True)
                tbl, _old_u, credit_u = K._byte_table_update(
                    tables[t], p, d, lo=lo, span=S)
                new_tables.append(tbl)
                seg = d["slot_seg"]
                slot_credit = v_t & \
                    jnp.take(credit_u, seg, mode="clip") & \
                    (i_t == jnp.take(d["ufirst"], seg, mode="clip"))
                back_votes.append(slot_credit.astype(jnp.int8)
                                  .reshape(D, C))
            back = jax.lax.all_to_all(
                jnp.stack(back_votes, axis=1).reshape(D, T * C),
                AXIS, 0, 0, tiled=False).reshape(D * T * C)
            new_local = jnp.zeros(local, bool)
            for t in range(T):
                new_local = new_local | (back.at[owner_slots[t]].get(
                    mode="fill", fill_value=0) > 0)
            n_unique = n_unique + jax.lax.psum(
                jnp.sum(new_local.astype(jnp.uint32)), AXIS
            ).astype(jnp.uint64)
            n_cons = jax.lax.psum(
                jnp.sum(valid.astype(jnp.uint32)), AXIS
            ).astype(jnp.uint64)
            return tuple(new_tables), n_unique, overflow, n_cons

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(tuple(P(AXIS) for _ in primes), P(), P(),
                      P(AXIS), P(), P()),
            out_specs=(tuple(P(AXIS) for _ in primes), P(), P(), P()),
            check_vma=False,
        )(tables, n_unique, overflow, codes, starts, nfill)

    # NOT donated: the caller keeps the pre-step tables alive so an
    # overflowed chunk can be replayed on the gathered path
    return jax.jit(step)


class ShardedBlockedCountgraph:
    """Blocked Count-Min sharded by block range over a device mesh.

    The blocked layout (core/blocked.py) shards more cleanly than
    the reference's independent prime tables: all four sub-counters of
    a k-mer live in ONE 128-byte block, so exactly one device owns
    every event — per-event new-k-mer credit is computed entirely
    locally and devices join with a single scalar psum (the exact
    layout needs a per-event OR across devices instead).

    With ``route=True`` (default) events travel to their owner device
    over an ``all_to_all`` (SURVEY §2.9: hash->owner-device routing,
    the banding analog), so each device sorts/scatters only ~1/D of
    the stream — the per-device kernel work shrinks with the mesh. The
    fixed route capacity is ``slack * local/D`` per (src, dst) pair
    (with a Binomial statistical floor);
    pathological skew (one k-mer dominating a chunk, e.g. homopolymer
    runs) can overflow it, which sets a sticky flag checked at stream
    end (same contract as the v2 collision overflow): the consume
    RAISES rather than undercounts, and the caller can rebuild with
    ``route=False`` (all_gather fallback, always exact).
    """

    storage_kind = "blocked"
    hash_family = "twobit"

    def __init__(self, ksize, starting_size, n_tables, mesh,
                 route="auto", route_slack=1.15):
        from khmer_tpu.core import blocked as B
        from khmer_tpu.core.sketch_kernels import get_n_primes_near_x

        self.mesh = mesh
        self.D = mesh.devices.size
        self._ksize = int(ksize)
        if route == "auto":
            # routing compacts to valid events and splits the update
            # D ways; the threshold is not measured on GPUs (ROADMAP
            # Speed #5)
            route = True
        self.route = bool(route) and self.D > 1
        self.route_slack = float(route_slack)
        want = max(int(starting_size) * max(int(n_tables), 1)
                   // B.LANES, 4)
        self.nblocks = get_n_primes_near_x(1, want + 1)[0]
        self._shard = _pad_to(self.nblocks, self.D) // self.D
        sharding = NamedSharding(mesh, P(AXIS, None))
        self.tables = (jax.device_put(
            jnp.zeros((self._shard * self.D, B.LANES), jnp.uint8),
            sharding),)
        self._n_unique = jnp.zeros((), jnp.uint64)
        self._overflow = jnp.zeros((), bool)

    def ksize(self):
        return self._ksize

    def n_unique_kmers(self):
        self._check_route_overflow()
        K.check_v2_overflow(self._overflow)
        return int(self._n_unique)

    def _check_route_overflow(self):
        if self.route and bool(self._overflow):
            raise RuntimeError(
                "all_to_all route capacity overflow (skewed k-mer "
                "stream): rebuild with route=False or a larger "
                "route_slack")

    def consume_chunk(self, codes, starts, nfill):
        """Commit one flat chunk; overflowed routed chunks replay on
        the gathered path with routing demoted (see ShardedCountgraph
        .consume_chunk — never an undercount, never an abort)."""
        sharding = NamedSharding(self.mesh, P(AXIS))
        codes = jax.device_put(jnp.asarray(codes), sharding)
        starts = jax.device_put(jnp.asarray(starts),
                                NamedSharding(self.mesh, P()))
        if self.route:
            fn = make_sharded_blocked_consume_routed(
                self.nblocks, self._shard, self._ksize, len(codes),
                self.mesh, self.route_slack)
            tables, n_unique, overflow, n_cons = fn(
                self.tables, self._n_unique, self._overflow, codes,
                starts, jnp.int32(nfill))
            if not bool(overflow):
                self.tables, self._n_unique, self._overflow = \
                    tables, n_unique, overflow
                return int(n_cons)
            del tables, n_unique, overflow
            ShardedCountgraph._demote_route(self)
        fn = make_sharded_blocked_consume(
            self.nblocks, self._shard, self._ksize, len(codes),
            self.mesh)
        self.tables, self._n_unique, self._overflow, n_cons = fn(
            self.tables, self._n_unique, self._overflow, codes, starts,
            jnp.int32(nfill))
        return int(n_cons)

    def get_counts(self, hashes):
        fn = make_sharded_blocked_get(self.nblocks, self._shard,
                                      self.mesh)
        return np.asarray(fn(self.tables, jnp.asarray(hashes)))

    def to_local(self):
        """Gather shards into a single-device BlockedCountgraph."""
        from khmer_tpu.core.blocked import BlockedCountgraph

        self._check_route_overflow()

        g = BlockedCountgraph(self._ksize, 1, 1,
                              primes=(self.nblocks,))
        g.tables = (jnp.asarray(
            np.asarray(self.tables[0])[: self.nblocks]),)
        g._n_unique = self._n_unique
        g._overflow = self._overflow
        return g


@functools.lru_cache(maxsize=None)
def make_sharded_blocked_consume(nblocks, shard, k, chunk, mesh):
    from khmer_tpu.core import blocked as B

    D = mesh.devices.size
    NB = int(nblocks)
    local = chunk // D
    W = chunk - k + 1

    def step(tables, n_unique, overflow, codes, starts, nfill):
        def body(tables, n_unique, overflow, codes_local, starts, nfill):
            d_idx = jax.lax.axis_index(AXIS)
            table = tables[0]  # [shard, 128]
            halo = jax.lax.ppermute(
                codes_local[: k - 1], AXIS,
                [(i, (i - 1) % D) for i in range(D)])
            ext = jnp.concatenate([codes_local, halo])
            _, f, r = H.rolling_hash_windows(ext[None, :], k)
            local_h = jnp.minimum(f, r)[0][:local]
            hashes = jax.lax.all_gather(local_h, AXIS, tiled=True)[:W]
            rid = jnp.zeros(chunk, jnp.int32).at[starts].add(
                1, mode="drop")
            rid = jnp.cumsum(rid)
            valid = (rid[:W] == rid[k - 1:]) & \
                (jnp.arange(W, dtype=jnp.int32) + (k - 1) < nfill)

            block = (hashes % np.uint64(NB)).astype(jnp.int32)
            lo = (d_idx * shard).astype(jnp.int32)
            mine = valid & (block >= lo) & (block < lo + shard)
            idx = jnp.arange(W, dtype=jnp.int32)
            new_table, new_flags = B.blocked_local_update(
                shard, table, hashes, block - lo, idx, mine)
            # every event is owned by exactly one device: scalar join
            n_unique = n_unique + jax.lax.psum(
                jnp.sum(new_flags.astype(jnp.uint32)),
                AXIS).astype(jnp.uint64)
            n_cons = jnp.sum(valid).astype(jnp.uint64)
            return (new_table,), n_unique, overflow, n_cons

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=((P(AXIS, None),), P(), P(), P(AXIS), P(), P()),
            out_specs=((P(AXIS, None),), P(), P(), P()),
            check_vma=False,
        )(tables, n_unique, overflow, codes, starts, nfill)

    return jax.jit(step, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def make_sharded_blocked_consume_routed(nblocks, shard, k, chunk, mesh,
                                        slack):
    """all_to_all-routed sharded blocked consume.

    Each device hashes its slice, buckets events by owner device
    (owner = block // shard), and ships them with ONE
    all_to_all per chunk; the update then runs on ~1/D of the stream
    per device instead of a masked pass over the full stream
    (SURVEY §2.9 "all-to-all route (hash->owner chip) then local
    scatter-add"). Route capacity per (src, dst) pair is
    _route_capacity(local_W, D, slack); a chunk that exceeds it is
    REPLAYED by the caller on the gathered path with routing demoted
    (consume_chunk) — never an undercount.

    Sequential-exact n_unique: the global stream index rides along
    with each event, so the owner's scatter-min first-toucher credit
    is identical to the unrouted path.
    """
    from khmer_tpu.core import blocked as B

    D = mesh.devices.size
    NB = int(nblocks)
    local = chunk // D
    W = chunk - k + 1
    local_W = local  # device d owns windows [d*local, d*local+local)
    C = _route_capacity(local_W, D, slack)  # per (src, dst) pair
    IDX_FILL = B.IDX_FILL

    def step(tables, n_unique, overflow, codes, starts, nfill):
        def body(tables, n_unique, overflow, codes_local, starts, nfill):
            d_idx = jax.lax.axis_index(AXIS)
            table = tables[0]  # [shard, 128]
            halo = jax.lax.ppermute(
                codes_local[: k - 1], AXIS,
                [(i, (i - 1) % D) for i in range(D)])
            ext = jnp.concatenate([codes_local, halo])
            _, f, r = H.rolling_hash_windows(ext[None, :], k)
            local_h = jnp.minimum(f, r)[0][:local]

            # validity of my windows: read-boundary and fill masks are
            # global predicates; evaluate them for my index range
            gidx = d_idx * local + jnp.arange(local, dtype=jnp.int32)
            # rid from global starts (starts replicated, values global)
            # no read start may fall in (gidx, gidx+k-1]; starts is
            # small and sorted, so two searchsorteds beat a
            # chunk-length cumsum (replicated per-device work that
            # cannot shrink with D)
            n_le_hi = jnp.searchsorted(starts, gidx + (k - 1),
                                       side="right")
            n_le_lo = jnp.searchsorted(starts, gidx, side="right")
            valid = (n_le_hi == n_le_lo) & (gidx < W) & \
                (gidx + (k - 1) < nfill)

            block = (local_h % np.uint64(NB)).astype(jnp.int32)
            owner = jnp.where(valid, block // jnp.int32(shard),
                              jnp.int32(D))
            onehot = owner[:, None] == jnp.arange(D, dtype=jnp.int32)
            rank1 = jnp.cumsum(onehot.astype(jnp.int32), axis=0)
            rank = jnp.sum(jnp.where(onehot, rank1 - 1, 0), axis=1)
            over = valid & (rank >= C)
            overflow = overflow | (jax.lax.psum(
                jnp.any(over).astype(jnp.int32), AXIS) > 0)
            slot = jnp.where(valid & ~over, owner * C + rank,
                             jnp.int32(D * C))
            send_h = jnp.zeros(D * C, jnp.uint64).at[slot].set(
                local_h, mode="drop")
            send_i = jnp.full(D * C, jnp.int32(IDX_FILL)).at[slot].set(
                gidx, mode="drop")
            # ONE fused collective: [dst, C hashes | C indices-as-u64]
            got = jax.lax.all_to_all(
                jnp.concatenate([send_h.reshape(D, C),
                                 send_i.astype(jnp.uint64).reshape(D, C)],
                                axis=1),
                AXIS, 0, 0, tiled=False)
            routed_h = got[:, :C].reshape(D * C)
            routed_i = got[:, C:].astype(jnp.int32).reshape(D * C)
            mine = routed_i < IDX_FILL
            lo = (d_idx * shard).astype(jnp.int32)
            rblock = (routed_h % np.uint64(NB)).astype(jnp.int32) - lo
            new_table, new_flags = B.blocked_local_update(
                shard, table, routed_h, rblock, routed_i, mine)
            n_unique = n_unique + jax.lax.psum(
                jnp.sum(new_flags.astype(jnp.uint32)),
                AXIS).astype(jnp.uint64)
            n_cons = jax.lax.psum(
                jnp.sum(valid.astype(jnp.uint32)), AXIS
            ).astype(jnp.uint64)
            return (new_table,), n_unique, overflow, n_cons

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=((P(AXIS, None),), P(), P(), P(AXIS), P(), P()),
            out_specs=((P(AXIS, None),), P(), P(), P()),
            check_vma=False,
        )(tables, n_unique, overflow, codes, starts, nfill)

    # NOT donated: the caller keeps the pre-step tables alive so an
    # overflowed chunk can be replayed on the gathered path
    return jax.jit(step)


@functools.lru_cache(maxsize=None)
def make_sharded_blocked_get(nblocks, shard, mesh):
    from khmer_tpu.core import blocked as B

    NB = int(nblocks)

    def get(tables, hashes):
        def body(tables, hashes):
            d_idx = jax.lax.axis_index(AXIS)
            n = hashes.shape[0]
            block = (hashes % np.uint64(NB)).astype(jnp.int32)
            lo = (d_idx * shard).astype(jnp.int32)
            mine = (block >= lo) & (block < lo + shard)
            safe = jnp.where(mine, block - lo, 0)
            offq = B._offsets(hashes)
            g = tables[0].at[safe].get(mode="clip").astype(jnp.int32)
            gv = B._select_lanes(g.reshape(n, B.SUB, B.QUART), offq)
            c = jnp.min(gv, axis=0)
            c = jnp.where(mine, c, jnp.int32(K.MAX_KCOUNT))
            return jax.lax.pmin(c, AXIS).astype(jnp.uint16)

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=((P(AXIS, None),), P()),
            out_specs=P(),
            check_vma=False,
        )(tables, hashes)

    return jax.jit(get)


@functools.lru_cache(maxsize=None)
def make_sharded_get(primes, shard_sizes, mesh, n):
    D = mesh.devices.size

    def get(tables, hashes):
        def body(tables, hashes):
            d_idx = jax.lax.axis_index(AXIS)
            counts = jnp.full(hashes.shape, jnp.uint16(K.MAX_KCOUNT))
            for t, p in enumerate(primes):
                S = shard_sizes[t]
                lo = (d_idx * S).astype(jnp.uint64)
                bins = hashes % np.uint64(p)
                mine = (bins >= lo) & (bins < lo + np.uint64(S))
                c = jnp.take(tables[t],
                             jnp.where(mine, bins - lo, 0),
                             mode="clip").astype(jnp.uint16)
                c = jnp.where(mine, c, jnp.uint16(K.MAX_KCOUNT))
                # owner's value wins: min across devices
                c = jax.lax.pmin(c.astype(jnp.int32), AXIS)
                counts = jnp.minimum(counts, c.astype(jnp.uint16))
            return counts

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(tuple(P(AXIS) for _ in primes), P()),
            out_specs=P(),
            check_vma=False,
        )(tables, hashes)

    return jax.jit(get)
