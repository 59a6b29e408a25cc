"""Mesh-sharded digital normalization — table-parallel exact scan.

Diginorm is inherently sequential (each kept read's k-mers change
later medians, scripts/normalize-by-median.py:155-179), so the stream
cannot be data-parallel. What CAN distribute is the countgraph itself:
the u32 shadow tables (core/diginorm_scan.py) shard by bucket range
across the device mesh — the banding analog — and the `lax.scan` runs
INSIDE ``shard_map``:

- per bundle, each device gathers the counts for the bins it owns;
  one ``psum`` joins them (exactly one owner per (table, bin), all
  others contribute zero), so every device sees the same counts and
  takes the same keep/discard decision;
- kept bundles scatter-add only into the local shard;
- the exact n_unique credit (first event to hit a zero bin) is a tiny
  replicated sort over the joined pre-bundle counts — identical on
  every device, so the carried scalar stays replicated.

Memory per device shrinks ~1/D (the u32 shadow of a production
countgraph is 4x its u8 size) and the per-bundle gather/scatter work
splits across the mesh, while outputs stay bit-identical to the
single-device scan (tests/test_parallel_more.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from khmer_tpu.core import diginorm_scan as DS
from khmer_tpu.core import pipeline
from khmer_tpu.ops import hashing as H
from khmer_tpu.parallel.sharded import AXIS, _pad_to

MAX_KCOUNT = DS.MAX_KCOUNT


@functools.lru_cache(maxsize=None)
def make_sharded_diginorm_window(primes, shard_sizes, k, hash_family,
                                 cutoff, nbundles, L, mesh):
    """Sharded twin of diginorm_scan.make_diginorm_window."""
    primes = tuple(int(p) for p in primes)
    shard_sizes = tuple(int(s) for s in shard_sizes)
    T = len(primes)
    W = L - k + 1
    C = int(cutoff)
    offsets = np.cumsum([0] + list(primes)).astype(np.int64)
    id_bound = np.int64(offsets[-1])

    def bundle_step_factory(d_idx):
        los = [(d_idx * s).astype(jnp.uint64) for s in shard_sizes]

        def bundle_step(carry, xs):
            tables, n_unique = carry
            h2, valid2, nvalid2, present2 = xs

            bins = jnp.stack([
                (h2 % np.uint64(p)).astype(jnp.int64) for p in primes])
            mine = jnp.stack([
                (bins[t] >= los[t].astype(jnp.int64))
                & (bins[t] < (los[t] + np.uint64(shard_sizes[t])
                              ).astype(jnp.int64))
                for t in range(T)])
            lbins = jnp.stack([
                jnp.where(mine[t],
                          bins[t] - los[t].astype(jnp.int64),
                          jnp.int64(shard_sizes[t])).astype(jnp.int32)
                for t in range(T)])
            old_local = jnp.stack([
                jnp.where(mine[t],
                          tables[t].at[lbins[t]].get(
                              mode="fill", fill_value=0
                          ).astype(jnp.int32), 0)
                for t in range(T)])
            # one owner per (table, bin): psum reassembles the counts
            old = jax.lax.psum(old_local, AXIS)
            counts = jnp.min(jnp.minimum(old, MAX_KCOUNT), axis=0)

            med_ok = DS._med_at_least(counts, valid2, nvalid2,
                                      present2, C)
            keep = ~jnp.all(med_ok)
            do = keep & valid2 & present2[:, None]

            # exact n_unique: replicated tiny sort over joined state
            W2 = do.size
            ids = jnp.where(do[None, :, :],
                            bins + offsets[:T, None, None],
                            id_bound).reshape(T, W2)
            order = jnp.broadcast_to(
                jnp.arange(W2, dtype=jnp.int32), (T, W2))
            oldf = old.reshape(T, W2)
            ids_s, ord_s, old_s = jax.lax.sort(
                (ids.ravel(), order.ravel(), oldf.ravel()), num_keys=2)
            first = (ids_s < id_bound) & \
                ((jnp.arange(T * W2) == 0)
                 | (ids_s != jnp.roll(ids_s, 1)))
            fresh_first = first & (old_s == 0)
            ev = jnp.zeros(W2 + 1, bool).at[
                jnp.where(fresh_first, ord_s, jnp.int32(W2))].set(
                True, mode="drop")
            n_unique = n_unique + jnp.sum(
                ev[:W2].astype(jnp.uint32)).astype(jnp.uint64)

            new_tables = tuple(
                tables[t].at[jnp.where(do & mine[t], lbins[t],
                                       jnp.int32(shard_sizes[t]))
                             ].add(1, mode="drop")
                for t in range(T))
            return (new_tables, n_unique), keep

        return bundle_step

    def window(tables, n_unique, codes, lengths):
        def body(tables, n_unique, codes, lengths):
            d_idx = jax.lax.axis_index(AXIS)
            hashes = H.hash_windows(codes, k, hash_family)
            win = jnp.arange(W, dtype=jnp.int32)[None, :]
            valid = win <= (lengths[:, None] - k)
            B = codes.shape[0] // 2
            xs = (hashes.reshape(B, 2, W),
                  valid.reshape(B, 2, W),
                  jnp.maximum(lengths - (k - 1), 0).reshape(B, 2),
                  (lengths >= k).reshape(B, 2))
            (tables, n_unique), keep = jax.lax.scan(
                bundle_step_factory(d_idx), (tables, n_unique), xs,
                unroll=8)
            return tables, n_unique, keep

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(tuple(P(AXIS) for _ in primes), P(), P(), P()),
            out_specs=(tuple(P(AXIS) for _ in primes), P(), P()),
            check_vma=False,
        )(tables, n_unique, codes, lengths)

    return jax.jit(window, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def make_sharded_med_ok(primes, shard_sizes, k, hash_family, cutoff, L,
                        mesh):
    """Sharded twin of diginorm_scan.make_med_ok (phase-A filter)."""
    primes = tuple(int(p) for p in primes)
    shard_sizes = tuple(int(s) for s in shard_sizes)
    C = int(cutoff)

    def med_ok(tables, codes, lengths):
        def body(tables, codes, lengths):
            d_idx = jax.lax.axis_index(AXIS)
            W = codes.shape[-1] - k + 1
            hashes = H.hash_windows(codes, k, hash_family)
            win = jnp.arange(W, dtype=jnp.int32)[None, :]
            valid = win <= (lengths[:, None] - k)
            acc = jnp.full(hashes.shape, jnp.int32(2**30))
            for t, p in enumerate(primes):
                s = shard_sizes[t]
                lo = (d_idx * s).astype(jnp.uint64)
                bins = hashes % np.uint64(p)
                mine = (bins >= lo) & (bins < lo + np.uint64(s))
                c = tables[t].at[
                    jnp.where(mine, (bins - lo).astype(jnp.int32), 0)
                ].get(mode="clip").astype(jnp.int32)
                c = jnp.where(mine, c, jnp.int32(2**30))
                acc = jnp.minimum(acc, c)
            counts = jnp.minimum(jax.lax.pmin(acc, AXIS), MAX_KCOUNT)
            ge = jnp.sum((valid & (counts >= C)).astype(jnp.int32),
                         axis=1)
            nvalid = jnp.maximum(lengths - (k - 1), 0)
            min_req = jnp.floor(0.5 + nvalid.astype(jnp.float32)
                                / 2.0).astype(jnp.int32)
            ok = (ge >= min_req) | (lengths < k)
            return jnp.all(ok.reshape(-1, 2), axis=1)

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(tuple(P(AXIS) for _ in primes), P(), P()),
            out_specs=P(),
            check_vma=False,
        )(tables, codes, lengths)

    return jax.jit(med_ok)


class ShardedScanNormalizer(DS.ScanNormalizer):
    """ScanNormalizer with the u32 shadow sharded over a device mesh.

    Drop-in: same process_window/finalize contract, same outputs; the
    shadow tables live range-sharded in per-device HBM.
    """

    def __init__(self, countgraph, desired_coverage, mesh, window=512):
        self.mesh = mesh
        self.D = mesh.devices.size
        self._shard_sizes = tuple(
            _pad_to(int(p), self.D) // self.D for p in countgraph._primes)
        super().__init__(countgraph, desired_coverage, window=window)

    def _phase_a(self, codes, lengths, L):
        fa = make_sharded_med_ok(
            self._primes, self._shard_sizes, self.k,
            self.graph.hash_family, self.C, L, self.mesh)
        return np.asarray(fa(self._tables, jnp.asarray(codes),
                             jnp.asarray(lengths)))

    def _scan_fn(self, CB, L):
        return make_sharded_diginorm_window(
            self._primes, self._shard_sizes, self.k,
            self.graph.hash_family, self.C, CB, L, self.mesh)

    def finalize(self):
        if not self._dirty:
            return
        # saturate to u8 on the shards; only u8 bytes leave the mesh
        self.graph.tables = tuple(
            jnp.asarray(np.asarray(
                jnp.minimum(t, MAX_KCOUNT).astype(jnp.uint8))[:p])
            for t, p in zip(self._tables, self._primes))
        self.graph._n_unique = self._n_unique
        self._dirty = False

    def _reseed_from_graph(self):
        # shard the u8 tables, then widen each shard to u32: no device
        # ever holds a whole table's u32 shadow
        sharding = NamedSharding(self.mesh, P(AXIS))
        self._tables = tuple(
            jax.device_put(
                jnp.pad(jnp.asarray(t), (0, s * self.D - len(t))),
                sharding).astype(jnp.uint32)
            for t, s in zip(self.graph.tables, self._shard_sizes))
        self._n_unique = self.graph._n_unique
