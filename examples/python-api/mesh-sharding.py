#!/usr/bin/env python
"""Multi-device sharded counting over a jax.sharding.Mesh.

Runs on the devices JAX finds: every GPU of the host. To try it
without GPUs, split the CPU backend into 8 devices:

    JAX_PLATFORMS=cpu \
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/python-api/mesh-sharding.py

Tables shard by bucket range (the analog of khmer's hash-space
banding); the read stream shards with a k-1 halo exchanged over
ppermute; per-event statistics join with collectives.
"""

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

import jax
import numpy as np

from khmer_tpu.core import pipeline
from khmer_tpu.parallel import sharded

k = 21
mesh = sharded.make_mesh(jax.devices())
graph = sharded.ShardedCountgraph(k, 1 << 16, 4, mesh)

rng = np.random.default_rng(0)
reads = ["".join("ACGT"[b] for b in rng.integers(0, 4, 100))
         for _ in range(200)]

packer = pipeline.FlatPacker(k, chunk=1 << 14)
chunks = []
for seq in reads:
    chunks.extend(packer.add(seq))
tail = packer.flush()
if tail is not None:
    chunks.append(tail)

n = 0
for codes, starts, nfill in chunks:
    n += graph.consume_chunk(codes, starts, nfill)

print('consumed %d k-mers across %d devices; %d unique'
      % (n, mesh.devices.size, graph.n_unique_kmers()))
local = graph.to_local_countgraph()
print('gathered to a single-device Countgraph:',
      local.get(reads[0][:k]), 'count for the first k-mer')
