"""Mesh-sharded de Bruijn graph membership for distributed partitioning.

The reference's flagship scale-out feature is subset partitioning
(src/oxli/subset.cc:501-553 do_partition, decomposed into tag ranges by
oxli/partition.py:22 and hashgraph.cc:349 divide_tags_into_subsets).
Its hot loop is the BFS neighbor probe: 8 Bloom membership tests per
frontier node (src/oxli/traversal.cc:100-133).

Mesh distribution: the Nodegraph's bit tables are sharded by
bucket range across the device mesh (the banding analog,
src/oxli/kmer_hash.cc:261); a frontier's 8N candidate neighbors are
broadcast to every device, every device ANDs the bits it owns, and a psum of
the per-device "missing" votes yields exact membership — i.e. frontier
k-mers are routed to their bucket owners and the membership verdicts
joined collectively, replacing the reference's shared-memory Bloom
reads. The union-find tag bookkeeping (host-side, cheap) is unchanged,
so partition IDs stay identical to the single-device path.

``ShardedNodegraph`` wraps a local Nodegraph: probes run on the mesh,
everything else (tags, stop tags, hashing, pmap IO) delegates to the
wrapped graph, so the whole partitioning machinery
(core/partition.py) works over the mesh unmodified.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from khmer_tpu.parallel.sharded import AXIS, _pad_to

__all__ = ["ShardedNodegraph"]


class ShardedNodegraph:
    """Nodegraph facade with bucket-range-sharded membership probes.

    Build the graph (consume + tag) on a local Nodegraph, then wrap:

        sg = ShardedNodegraph(nodegraph, mesh)
        subset = SubsetPartition(sg)
        subset.do_partition(...)      # BFS probes run on the mesh

    Partition IDs are identical to the local path (same traversal
    order, same union-find); only the membership lookups distribute.
    """

    storage_kind = "bit"
    hash_family = "twobit"

    def __init__(self, graph, mesh, route="auto", route_slack=2.0):
        if route == "auto":
            # a membership probe is one bit-test per element, so
            # routing's slot bookkeeping outweighed its savings on a
            # virtual CPU mesh; the crossover on NVLink is not measured
            # (ROADMAP Speed #5). route=True stays available where the
            # psum's O(n*D) traffic is the bottleneck
            route = False
        if graph.storage_kind != "bit":
            raise ValueError("ShardedNodegraph wraps a Nodegraph "
                             "(bit storage), got %r"
                             % (graph.storage_kind,))
        self.local = graph
        self.mesh = mesh
        self.route = bool(route) and mesh.devices.size > 1
        self.route_slack = float(route_slack)
        self.D = mesh.devices.size
        self._primes = tuple(int(p) for p in graph._primes)
        self._ksize = graph.ksize()
        # shard each bit table by BYTE range
        self._shard_bytes = tuple(
            _pad_to(len(np.asarray(t)), self.D) // self.D
            for t in graph.tables)
        sharding = NamedSharding(mesh, P(AXIS))
        self.tables = tuple(
            jax.device_put(
                jnp.concatenate([
                    jnp.asarray(t),
                    jnp.zeros(sb * self.D - len(np.asarray(t)),
                              jnp.uint8)]),
                sharding)
            for t, sb in zip(graph.tables, self._shard_bytes))

    # -- mesh probes -------------------------------------------------------

    def neighbors_batch(self, f_arr, r_arr):
        """(nf, nr, ncanon, present) with membership ANDed across the
        mesh (each device votes on the bucket ranges it owns).

        Routed mode builds the 8 candidate neighbors with host bit-ops
        and sends only each candidate to its bucket owner; broadcast
        mode ships the whole candidate array to every device.
        """
        if self.route:
            f = np.asarray(f_arr, dtype=np.uint64)[:, None]
            r = np.asarray(r_arr, dtype=np.uint64)[:, None]
            bitmask = np.uint64((1 << (2 * self._ksize)) - 1)
            shift = np.uint64(2 * self._ksize - 2)
            b = np.arange(4, dtype=np.uint64)[None, :]
            comp_b = b ^ np.uint64(1)
            rf = ((f << np.uint64(2)) | b) & bitmask
            rr = (r >> np.uint64(2)) | (comp_b << shift)
            lf = (f >> np.uint64(2)) | (b << shift)
            lr = ((r << np.uint64(2)) | comp_b) & bitmask
            nf = np.concatenate([rf, lf], axis=1)
            nr = np.concatenate([rr, lr], axis=1)
            ncanon = np.minimum(nf, nr)
            present = self.get_counts_for_hashes(
                ncanon.ravel()).reshape(ncanon.shape) > 0
            return nf, nr, ncanon, present
        fn = _make_sharded_neighbors(
            self._primes, self._shard_bytes, self._ksize, self.mesh,
            int(np.asarray(f_arr).shape[0]))
        return fn(self.tables,
                  jnp.asarray(f_arr, dtype=jnp.uint64),
                  jnp.asarray(r_arr, dtype=jnp.uint64))

    def get_counts_for_hashes(self, hashes):
        """Membership (0/1) for canonical hashes, mesh-joined.

        With route=True candidates are sharded across devices and
        travel to their bucket-range owners over two all_to_alls
        (query out, verdict back) — per-probe traffic O(n), not the
        O(n*D) of broadcasting the candidate array to every device.
        Falls back to the broadcast path when the fixed route capacity
        overflows (skewed candidate set) — exact either way.
        """
        hashes = np.asarray(hashes, dtype=np.uint64).ravel()
        n = hashes.shape[0]
        if self.route and n >= self.D:
            pad = _pad_to(n, self.D)
            hp = np.zeros(pad, np.uint64)
            hp[:n] = hashes
            fn = _make_sharded_contains_routed(
                self._primes, self._shard_bytes, self.mesh, pad,
                self.route_slack)
            present, over = fn(self.tables, jnp.asarray(hp))
            if not bool(over):
                return np.asarray(present)[:n]
        fn = _make_sharded_contains(
            self._primes, self._shard_bytes, self.mesh, n)
        return np.asarray(fn(self.tables, jnp.asarray(hashes)))

    def get(self, kmer):
        h = self.local._coerce_hashes(kmer)
        return int(self.get_counts_for_hashes(h)[0])

    # -- delegation to the wrapped local graph ----------------------------

    def ksize(self):
        return self._ksize

    def hashsizes(self):
        return list(self._primes)

    def __getattr__(self, name):
        # tags, stop tags, hash helpers, pmap IO, tag density, ...
        return getattr(self.local, name)


@functools.lru_cache(maxsize=None)
def _make_sharded_contains(primes, shard_bytes, mesh, n):
    D = mesh.devices.size

    def get(tables, hashes):
        def body(tables, hashes):
            d_idx = jax.lax.axis_index(AXIS)
            missing = jnp.zeros(hashes.shape, jnp.int32)
            for t, p in enumerate(primes):
                sb = shard_bytes[t]
                lo = (d_idx * sb).astype(jnp.uint64)
                bins = hashes % np.uint64(p)
                byte_ix = bins // np.uint64(8)
                mine = (byte_ix >= lo) & (byte_ix < lo + np.uint64(sb))
                byte = jnp.take(tables[t],
                                jnp.where(mine, byte_ix - lo, 0),
                                mode="clip").astype(jnp.int32)
                bit = jnp.int32(1) << (bins % np.uint64(8)).astype(
                    jnp.int32)
                absent = mine & ((byte & bit) == 0)
                missing = missing + absent.astype(jnp.int32)
            # membership = no owner voted absent (exactly one owner
            # per (hash, table); psum joins the verdicts)
            missing = jax.lax.psum(missing, AXIS)
            return (missing == 0).astype(jnp.uint16)

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(tuple(P(AXIS) for _ in primes), P()),
            out_specs=P(),
            check_vma=False,
        )(tables, hashes)

    return jax.jit(get)


@functools.lru_cache(maxsize=None)
def _make_sharded_contains_routed(primes, shard_bytes, mesh, n, slack):
    """Routed membership: candidates sharded P(AXIS); ONE pair of
    all_to_alls for ALL tables (query to owner, verdict back) — the
    send buffer's slot layout [dst: [t0: C][t1: C]...] tells the
    receiver each entry's table statically, so the T-fold collective
    latency of the per-table version is gone (r04's routed probes lost
    to broadcast at every D exactly because each probe paid 2*T
    all_to_alls). Returns (present u16 assembled, overflow bool)."""
    D = mesh.devices.size
    T = len(primes)
    nl = n // D                        # candidates per device
    from khmer_tpu.parallel.sharded import _route_capacity
    C = max(4, _route_capacity(nl, D, slack))  # per (table, src, dst)
    SENT = np.uint64(0xFFFFFFFFFFFFFFFF)

    def get(tables, hashes):
        def body(tables, hashes_local):
            d_idx = jax.lax.axis_index(AXIS)
            over_any = jnp.zeros((), bool)
            send = jnp.full(D * T * C, SENT)
            slots = []
            for t, p in enumerate(primes):
                sb = shard_bytes[t]
                bins = hashes_local % np.uint64(p)
                byte_ix = bins // np.uint64(8)
                owner = (byte_ix // np.uint64(sb)).astype(jnp.int32)
                onehot = owner[:, None] == jnp.arange(D, dtype=jnp.int32)
                rank = jnp.sum(jnp.where(
                    onehot, jnp.cumsum(onehot.astype(jnp.int32),
                                       axis=0) - 1, 0), axis=1)
                over = rank >= C
                over_any = over_any | jnp.any(over)
                slot = jnp.where(over, jnp.int32(D * T * C),
                                 owner * (T * C) + t * C + rank)
                send = send.at[slot].set(hashes_local, mode="drop")
                slots.append(slot)
            q = jax.lax.all_to_all(send.reshape(D, T * C), AXIS, 0, 0,
                                   tiled=False).reshape(D, T, C)
            votes = []
            for t, p in enumerate(primes):
                sb = shard_bytes[t]
                qt = q[:, t, :].reshape(D * C)
                qbins = qt % np.uint64(p)
                qbyte_ix = qbins // np.uint64(8)
                lo = (d_idx * sb).astype(jnp.uint64)
                real = qt != SENT
                byte = jnp.take(tables[t],
                                jnp.where(real, qbyte_ix - lo, 0),
                                mode="clip").astype(jnp.int32)
                bit = jnp.int32(1) << (qbins % np.uint64(8)).astype(
                    jnp.int32)
                votes.append((real & ((byte & bit) == 0)).astype(
                    jnp.int8).reshape(D, C))
            absent = jnp.stack(votes, axis=1)          # [D, T, C]
            back = jax.lax.all_to_all(
                absent.reshape(D, T * C), AXIS, 0, 0,
                tiled=False).reshape(D * T * C)
            missing = jnp.zeros(nl, jnp.int32)
            for t in range(T):
                missing = missing + back.at[slots[t]].get(
                    mode="fill", fill_value=0).astype(jnp.int32)
            overflow = jax.lax.psum(over_any.astype(jnp.int32),
                                    AXIS) > 0
            return (missing == 0).astype(jnp.uint16), overflow

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(tuple(P(AXIS) for _ in primes), P(AXIS)),
            out_specs=(P(AXIS), P()),
            check_vma=False,
        )(tables, hashes)

    return jax.jit(get)


@functools.lru_cache(maxsize=None)
def _make_sharded_neighbors(primes, shard_bytes, k, mesh, n):
    """Batch 8-neighbor probe over sharded bit tables (mesh version of
    graphmixin.make_neighbors_fn)."""
    bitmask = (1 << (2 * k)) - 1
    shift = 2 * k - 2
    contains = _make_sharded_contains(primes, shard_bytes, mesh, n * 8)

    def fn(tables, f, r):
        f = f[:, None]
        r = r[:, None]
        b = jnp.arange(4, dtype=jnp.uint64)[None, :]
        comp_b = b ^ np.uint64(1)
        rf = ((f << np.uint64(2)) | b) & np.uint64(bitmask)
        rr = (r >> np.uint64(2)) | (comp_b << np.uint64(shift))
        lf = (f >> np.uint64(2)) | (b << np.uint64(shift))
        lr = ((r << np.uint64(2)) | comp_b) & np.uint64(bitmask)
        nf = jnp.concatenate([rf, lf], axis=1)
        nr = jnp.concatenate([rr, lr], axis=1)
        ncanon = jnp.minimum(nf, nr)
        present = contains(tables, ncanon.ravel()).reshape(
            ncanon.shape) > 0
        return nf, nr, ncanon, present

    return jax.jit(fn)
