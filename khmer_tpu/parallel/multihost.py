"""Multi-host execution: jax.distributed over DCN.

The reference scales across processes by file hand-off — partition
workers write ``.subset.N.pmap`` files that a merge step folds
(reference oxli/partition.py:22-45, src/oxli/subset.cc:884), and
sketches merge via ``update_from`` bitwise-OR (storage.hh:228) /
HLL register max (hllcounter.cc:406).  The equivalent here runs
one JAX process per host in multi-controller SPMD: a single
``jax.sharding.Mesh`` spans every host's devices, per-host input
shards enter through ``make_array_from_process_local_data``, and the
merges ride collectives (within and across hosts) instead
of the filesystem:

- ``global_consume``: the sharded counting step (parallel/sharded.py)
  over the global mesh — each host contributes its slice of the read
  stream; the kernel's psums/all_to_alls span hosts transparently.
- ``union_bit_tables``: Nodegraph union (bitwise-OR all_gather) — the
  ``update_from`` merge primitive.
- ``max_registers``: HLL merge.

Per-host FILE assignment (the reference's per-thread file split,
scripts/load-into-counting.py:148-158) maps to: process i consumes
``files[i::num_processes]``.

Validated by tests/test_multihost.py, which boots two real local
processes with ``jax.distributed.initialize`` on the CPU backend and
checks every merge against the single-process oracle.
"""

import numpy as np


def initialize(coordinator_address, num_processes, process_id,
               local_device_count=4):
    """Bootstrap one process of a multi-controller run.

    Call BEFORE any other JAX API.  On a GPU cluster, num_processes /
    process_id come from the deployment; on CPU (tests, dev boxes)
    this forces `local_device_count` virtual devices per process.
    """
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=%d"
            % local_device_count)
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return jax


def global_mesh():
    """One mesh over every device of every host."""
    from khmer_tpu.parallel import sharded

    import jax

    return sharded.make_mesh(jax.devices())


def files_for_process(files, process_id=None, num_processes=None):
    """The reference's per-worker file decomposition, per host."""
    import jax

    if process_id is None:
        process_id = jax.process_index()
    if num_processes is None:
        num_processes = jax.process_count()
    return list(files)[process_id::num_processes]


def host_shard_array(mesh, global_shape, local_np):
    """Wrap this host's slice of a P('shard')-sharded global array."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from khmer_tpu.parallel.sharded import AXIS

    sharding = NamedSharding(mesh, P(AXIS))
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_np), global_shape)


def replicated_array(mesh, value_np):
    """Replicate identical host data over the mesh (P() sharding)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P()), np.ascontiguousarray(value_np),
        value_np.shape)


def global_consume(graph, local_codes, global_starts, nfill):
    """One sharded consume step where each host supplies its slice.

    graph: ShardedCountgraph/ShardedBlockedCountgraph built on the
    global mesh.  local_codes: this host's contiguous slice of the
    global chunk (chunk/num_processes bases).  global_starts: read
    starts in GLOBAL coordinates (identical on every host — exchange
    with jax.experimental.multihost_utils.process_allgather first).
    """
    import jax

    from khmer_tpu.parallel import sharded

    chunk = len(local_codes) * jax.process_count()
    codes = host_shard_array(graph.mesh, (chunk,),
                             np.asarray(local_codes, np.uint8))
    starts = replicated_array(graph.mesh,
                              np.asarray(global_starts, np.int32))
    if graph.route:
        fn = sharded.make_sharded_consume_routed(
            graph._primes, graph._shard_sizes, graph._ksize, chunk,
            graph.mesh, graph.route_slack)
        (graph.tables, graph._n_unique, graph._overflow, n_cons) = fn(
            graph.tables, graph._n_unique, graph._overflow, codes,
            starts, np.int32(nfill))
    else:
        fn = sharded.make_sharded_consume(
            graph._primes, graph._shard_sizes, graph._ksize, chunk,
            graph.mesh)
        graph.tables, graph._n_unique, n_cons = fn(
            graph.tables, graph._n_unique, codes, starts,
            np.int32(nfill))
    return int(n_cons)


def union_bit_tables(mesh, local_tables):
    """Bitwise-OR union of per-host Nodegraph tables (the DCN analog
    of BitStorage::update_from, storage.hh:228). local_tables: numpy
    u8 arrays; every host passes its own. Returns merged numpy arrays
    (identical on every host)."""
    from jax.experimental import multihost_utils

    out = []
    for t in local_tables:
        allt = multihost_utils.process_allgather(
            np.asarray(t, np.uint8))            # [P, n] over DCN
        out.append(np.bitwise_or.reduce(np.asarray(allt), axis=0))
    return out


def max_registers(mesh, registers):
    """HLL merge across hosts (max of registers)."""
    import jax
    from jax.experimental import multihost_utils

    allregs = multihost_utils.process_allgather(
        np.asarray(registers, np.uint8))
    return np.max(np.asarray(allregs), axis=0).astype(np.uint8)
