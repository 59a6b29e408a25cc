#!/usr/bin/env python
"""Benchmark: k-mer counting throughput on the current JAX device.

Replicates BASELINE.json config 1 — the load-into-counting hot path
(Countgraph build, k=20) over data/25k.fq.gz — via the dense-stream
pipeline on the blocked layout (`load-into-counting.py --tpu-layout
blocked`, core/blocked.py), reporting k-mers counted per second on the
GPU. Equal memory to the reference config (4 x 5e7 byte counters).

Pipeline split (mirrors production consume_seqfile): the host parses
reads and rolls canonical k-mer hashes (native hg_hash_dense, timed
separately below); the device commits dense hash chunks through the
blocked update. Stream order is preserved, so results are
bit-identical to the windowed path (tests/test_dense_consume.py).

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "layout": "..."}

Fails unless JAX's device is a GPU. Run with
KHMER_TPU_BENCH_LAYOUT=exact to bench the byte-exact reference layout
instead.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

DATA = os.path.join(REPO, "data", "25k.fq.gz")
K = 20


def main():
    import jax
    import jax.numpy as jnp

    from khmer_tpu.core import pipeline
    from khmer_tpu.io.fastx import FastxParser

    layout = os.environ.get("KHMER_TPU_BENCH_LAYOUT", "blocked")

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("bench.py: JAX's device is %s (%s), not a GPU"
                         % (dev.device_kind, dev.platform))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print("device: %s  card (name, power limit): %s  layout: %s  "
          "path: dense" % (dev.device_kind, card, layout),
          file=sys.stderr)

    # -- host: parse + hash all dense chunks up front (production path:
    # native parser blocks -> one hg_hash_dense_reads call per block) --
    from khmer_tpu.io import native

    def host_pass():
        hasher = pipeline.DenseHasher(K, "twobit")
        chunks = []
        n_reads = 0
        if native.available():
            for codes_blk, meta, _ in native.pack_blocks(DATA):
                n_reads += len(meta)
                chunks.extend(hasher.add_block(codes_blk, meta[:, 0],
                                               meta[:, 1]))
        else:
            for rec in FastxParser(DATA):
                n_reads += 1
                if len(rec.cleaned_seq) >= K:
                    chunks.extend(hasher.add(rec.cleaned_seq))
        chunks.extend(hasher.flush())
        return chunks, n_reads

    t0 = time.time()
    chunks, n_reads = host_pass()
    parse_s = time.time() - t0
    total_kmers = sum(n for _, n in chunks)
    total_slots = sum(len(h) for h, _ in chunks)

    if layout == "blocked":
        from khmer_tpu.core.blocked import BlockedCountgraph

        graph = BlockedCountgraph(K, 5e7, 4)
    else:
        from khmer_tpu.core.sketch import Countgraph

        graph = Countgraph(K, 5e7, 4)
    steps = {size: pipeline.make_dense_consume(
        graph.storage_kind, graph._primes, chunk=size)
        for size in sorted({len(h) for h, _ in chunks})}

    # re-measure the host parse+hash rate alone (second pass)
    t0 = time.time()
    host_pass()
    hash_s = time.time() - t0

    # stage inputs AND initial tables on the device once — the bench
    # measures the device's counting rate, not the one-time upload
    # (which a production pipeline overlaps with the stream)
    dev_chunks = [(jax.device_put(jnp.asarray(h), dev), jnp.int32(n))
                  for h, n in chunks]
    tables0 = jax.device_put(graph.tables, dev)

    def run_all(tables, n_unique, n_consumed, overflow):
        for hashes, nvalid in dev_chunks:
            tables, n_unique, n_consumed, overflow, _ = steps[
                len(hashes)](
                tables, n_unique, n_consumed, overflow, hashes, nvalid)
        return tables, n_unique, n_consumed, overflow

    # warmup: two passes compile both the fresh-state and the
    # steady-state (threaded-output) signatures
    t0 = time.time()
    state = run_all(tables0, jnp.uint64(0), jnp.zeros((), jnp.uint64),
                    jnp.zeros((), bool))
    state = run_all(*state)
    tables, n_unique, n_consumed, overflow = state
    assert int(n_consumed) // 2 == total_kmers  # host fetch = hard sync
    warm_s = time.time() - t0
    print("parsed %d reads, %d k-mers in %.2fs; host hash+pack pass: "
          "%.2fs (%.3g k-mers/s); %d chunks, %.1f%% slot pad; warmup "
          "(incl. compile): %.2fs"
          % (n_reads, total_kmers, parse_s, hash_s,
             total_kmers / hash_s, len(chunks),
             100.0 * (total_slots - total_kmers) / total_slots, warm_s),
          file=sys.stderr)

    reps = 50
    t0 = time.time()
    for _ in range(reps):
        tables, n_unique, n_consumed, overflow = run_all(
            tables, n_unique, n_consumed, overflow)
    jax.block_until_ready((tables, n_unique, n_consumed, overflow))
    dt = time.time() - t0
    rate = total_kmers * reps / dt

    print("unique k-mers: %d" % int(n_unique), file=sys.stderr)
    print("counting rate: %.3g k-mers/s (%.3fs for %d k-mers x%d)"
          % (rate, dt, total_kmers, reps), file=sys.stderr)

    print(json.dumps({
        "metric": "countgraph_kmers_per_sec",
        "value": round(rate, 1),
        "unit": "k-mers/s",
        "layout": layout,
    }))


if __name__ == "__main__":
    main()
