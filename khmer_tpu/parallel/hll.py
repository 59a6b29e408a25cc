"""Mesh-parallel HyperLogLog consume — the OpenMP fork-join analog.

The reference parallelizes unique-kmers with one HLL per OpenMP
thread, max-merged at the end (src/oxli/hllcounter.cc:344-417). The
Mesh equivalent: the flat code stream shards across the device
mesh (with a k-1 halo via ppermute, as in sharded counting), each
device scatter-maxes its windows into a LOCAL register array, and one
``pmax`` collective merges the registers — HLL merge is register-wise
max (hllcounter.cc:406-417), which commutes with any stream split.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from khmer_tpu.core import pipeline
from khmer_tpu.ops import hashing as H
from khmer_tpu.parallel.sharded import AXIS

__all__ = ["consume_seqfile_sharded"]


@functools.lru_cache(maxsize=None)
def _make_sharded_hll_step(p, k, chunk, mesh):
    nc = 1 << p
    D = mesh.devices.size
    local = chunk // D
    W = chunk - k + 1

    def step(counters, codes, starts, nfill):
        def body(counters, codes_local, starts, nfill):
            counters = counters[0]      # local block of the [D, nc] array
            d_idx = jax.lax.axis_index(AXIS)
            halo = jax.lax.ppermute(
                codes_local[: k - 1], AXIS,
                [(i, (i - 1) % D) for i in range(D)])
            ext = jnp.concatenate([codes_local, halo])
            local_h = H.murmur_hash_windows(ext[None, :], k)[0][:local]

            gidx = d_idx * local + jnp.arange(local, dtype=jnp.int32)
            rid_hit = jnp.zeros(chunk, jnp.int32).at[starts].add(
                1, mode="drop")
            rid = jnp.cumsum(rid_hit)
            rid_lo = rid.at[gidx].get(mode="fill", fill_value=0)
            rid_hi = rid.at[gidx + (k - 1)].get(mode="fill",
                                                fill_value=-1)
            valid = (rid_lo == rid_hi) & (gidx < W) & \
                (gidx + (k - 1) < nfill)

            index = (local_h & np.uint64(nc - 1)).astype(jnp.int32)
            to_count = local_h >> np.uint64(p)
            clz = jnp.where(to_count > 0,
                            jax.lax.clz(to_count).astype(jnp.int32), 64)
            rho = (clz - p + 1).astype(jnp.uint8)
            idx = jnp.where(valid, index, nc)
            counters = counters.at[idx].max(rho, mode="drop")
            n_cons = jax.lax.psum(
                jnp.sum(valid.astype(jnp.uint32)), AXIS
            ).astype(jnp.uint64)
            return counters[None, :], n_cons

        return jax.shard_map(
            body, mesh=mesh,
            # one private register array per device (mesh-sharded dim 0)
            in_specs=(P(AXIS, None), P(AXIS), P(), P()),
            out_specs=(P(AXIS, None), P()),
            check_vma=False,
        )(counters, codes, starts, nfill)

    return jax.jit(step, donate_argnums=(0,))


def consume_seqfile_sharded(hll, source, mesh):
    """Data-parallel consume into ``hll`` over the mesh.

    Returns (total_reads, n_consumed); afterwards hll's registers hold
    the pmax-merged result, identical to a single-device consume.
    """
    k = hll.ksize
    D = mesh.devices.size
    packer = pipeline.FlatPacker(k)
    chunk = packer.chunk
    step = _make_sharded_hll_step(hll.ncounters_log2, k, chunk, mesh)
    sharding = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    counters = jax.device_put(
        jnp.tile(hll.counters_dev[None, :], (D, 1)),
        NamedSharding(mesh, P(AXIS, None)))
    total_reads = 0
    n_consumed = 0

    def commit(chunks):
        nonlocal counters, n_consumed
        for codes, starts, nfill in chunks:
            if len(codes) != chunk:
                pad = np.zeros(chunk, np.uint8)
                pad[: len(codes)] = codes
                codes = pad
            counters, n_cons = step(
                counters,
                jax.device_put(jnp.asarray(codes), sharding),
                jax.device_put(jnp.asarray(starts), rep),
                jnp.int32(nfill))
            n_consumed += int(n_cons)

    for record in pipeline.records_from(source):
        seq = record.cleaned_seq
        total_reads += 1
        if len(seq) >= k:
            commit(packer.add(seq))
    commit(packer.flush_ladder())

    hll._touched = True
    hll.counters_dev = jnp.max(jnp.asarray(np.asarray(counters)),
                               axis=0)
    return total_reads, n_consumed
