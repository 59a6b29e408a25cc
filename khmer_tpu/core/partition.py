"""Tag-graph partitioning — connected components over the sparse tag
graph (reference: src/oxli/subset.cc, include/oxli/subset.hh).

The reference's flagship scale-out feature: BFS from each tag through
the implicit de Bruijn graph until other tags are hit (bounded breadth
2*tag_density+1), then union-find merging of tag partitions; work is
decomposed into tag-range subsets whose partition maps (.pmap files)
merge afterwards.

Device design: the graph is read-only during partitioning, so BFS runs for
many start tags concurrently — each wave batches the 8-neighbor
membership probes of every active traversal into one device call, while
exact FIFO bookkeeping (visit order, breadth caps, big-traversal
cutoffs) stays on host. The union-find mirrors the reference's
pointer-aliasing structure (subset.cc:630-788) so partition IDs come
out identical.
"""

import struct

import numpy as np

from khmer_tpu.ops import hashing as H

BIG_TRAVERSALS_ARE = 200  # reference: subset.cc:54

import re as _re

_ATOI_RE = _re.compile(r"^\s*[+-]?\d+")


def _atoi_prefix(s):
    """C atoi(): parse the leading integer prefix, 0 if none — so
    '35 foo' and '35abc' give 35, matching the reference's partition-id
    parse (include/oxli/read_parsers.hh:210-233)."""
    m = _ATOI_RE.match(s)
    return int(m.group(0)) if m else 0
_range = range  # sweep_for_tags shadows the builtin with its kw-arg
DEFAULT_BFS_BATCH = 2048


class _Box:
    """A PartitionID 'pointer' (aliasable box)."""

    __slots__ = ("pid",)

    def __init__(self, pid):
        self.pid = pid

    def __repr__(self):
        return "<pid %d>" % self.pid


from collections import deque


class _Traversal:
    """Host state of one find_all_tags BFS (reference subset.cc:213).

    The pending queue always holds exactly one breadth level, as
    (f, r) arrays; the visited set is a sorted uint64 array so level
    decisions are pure vector ops.
    """

    __slots__ = ("level_f", "level_r", "breadth", "keeper_arr",
                 "tagged", "first", "done", "aborted")

    def __init__(self, f, r):
        self.level_f = np.array([f], dtype=np.uint64)
        self.level_r = np.array([r], dtype=np.uint64)
        self.breadth = 0
        self.keeper_arr = np.zeros(0, dtype=np.uint64)
        self.tagged = set()
        self.first = True
        self.done = False
        self.aborted = False


def _sorted_contains(sorted_arr, values):
    """Vectorized membership of `values` in a sorted unique array."""
    if sorted_arr.size == 0:
        return np.zeros(len(values), bool)
    idx = np.searchsorted(sorted_arr, values)
    idx[idx == len(sorted_arr)] = 0
    return sorted_arr[idx] == values


def _sorted_merge(sorted_arr, new_values):
    """Insert new (unique, not-present) values keeping sort order."""
    if new_values.size == 0:
        return sorted_arr
    new_sorted = np.sort(new_values)
    pos = np.searchsorted(sorted_arr, new_sorted)
    return np.insert(sorted_arr, pos, new_sorted)


def _walk_level(tv, all_tags_arr, stop_tags_arr, max_breadth,
                break_on_stop_tags, stop_big_traversals,
                count_filter=None):
    """Process one breadth level of one traversal, vectorized.

    Sequential-exact: within a level, a node's decision depends only
    on earlier pops' keeper inserts (never on probe results), so
    first-occurrence dedup + ordered masks reproduce the one-at-a-time
    reference. Returns (f, r) survivor arrays needing neighbor probes.

    count_filter (canon array -> bool mask), when given, drops nodes
    whose sketch count falls outside the wanted abundance range before
    the keeper insert — the truncate-on-abundance rule
    (subset.cc:453-456).
    """
    canon = np.minimum(tv.level_f, tv.level_r)
    # first-occurrence dedup within the level (later dups would be
    # keeper-skipped at pop time anyway)
    _, first_idx = np.unique(canon, return_index=True)
    order = np.sort(first_idx)
    canon_o = canon[order]
    process = ~_sorted_contains(tv.keeper_arr, canon_o)
    if break_on_stop_tags and stop_tags_arr.size:
        process &= ~_sorted_contains(stop_tags_arr, canon_o)
    if count_filter is not None:
        process &= count_filter(canon_o)
    if stop_big_traversals:
        # the reference aborts before any pop once keeper > cap; the
        # first insert crossing the cap truncates the rest of the walk
        grow = np.cumsum(process)
        before = len(tv.keeper_arr) + np.concatenate(([0], grow[:-1]))
        over = np.nonzero(before > BIG_TRAVERSALS_ARE)[0]
        if over.size:
            cut = over[0]
            tv.keeper_arr = _sorted_merge(
                tv.keeper_arr, canon_o[:cut][process[:cut]])
            tv.tagged.clear()
            tv.done = True
            tv.aborted = True
            return None, None
    tv.keeper_arr = _sorted_merge(tv.keeper_arr, canon_o[process])
    if all_tags_arr.size:
        is_tag = process & _sorted_contains(all_tags_arr, canon_o)
    else:
        is_tag = np.zeros(len(canon_o), bool)
    if tv.first:
        # the traversal's first processed node skips the tag check
        # (reference: `!first && set_contains(all_tags, node)`)
        idx = np.nonzero(process)[0]
        if idx.size:
            is_tag[idx[0]] = False
    if is_tag.any():
        tv.tagged.update(int(c) for c in canon_o[is_tag])
    survive = process & ~is_tag
    if tv.breadth >= max_breadth:
        return None, None
    f_o = tv.level_f[order]
    r_o = tv.level_r[order]
    return f_o[survive], r_o[survive]


def find_all_tags_batch(graph, starts, break_on_stop_tags=False,
                        stop_big_traversals=False, count_range=None):
    """Run find_all_tags for many start k-mers concurrently.

    starts: list of (f, r) tuples. Returns a list of tagged-k-mer sets
    identical to sequential reference runs. Each round walks one
    breadth level per traversal (host, vectorized) and batches every
    survivor's 8-neighbor probe into one device call.

    count_range=(min, max) switches to the truncate-on-abundance walk
    (SubsetPartition::find_all_tags_truncate_on_abundance,
    subset.cc:399-496): nodes with sketch count outside the closed
    range are not traversed.

    Dispatch: the native host engine (src/hostgraph.cc) runs the BFS
    against a host table mirror when available — one thread pool over
    start tags, zero device round trips; the per-level batched device
    path below is the JAX reference implementation and the fallback.
    """
    from khmer_tpu.core import hostengine

    if hostengine.use_host_for(graph, "graph"):
        canon = [min(int(f), int(r)) for f, r in starts]
        res = hostengine.find_all_tags_range(
            graph, canon, break_on_stop_tags, stop_big_traversals,
            count_range)
        return [set(int(t) for t in arr) for arr in res]

    max_breadth = 2 * graph._tag_density + 1
    count_filter = None
    if count_range is not None:
        cmin, cmax = count_range

        def count_filter(canon):
            counts = graph.get_counts_for_hashes(canon)
            return (counts >= cmin) & (counts <= cmax)
    all_tags_arr = np.fromiter(graph.all_tags, np.uint64,
                               len(graph.all_tags))
    all_tags_arr.sort()
    stop_tags_arr = np.fromiter(graph.stop_tags, np.uint64,
                                len(graph.stop_tags))
    stop_tags_arr.sort()

    travs = [_Traversal(np.uint64(f), np.uint64(r)) for f, r in starts]
    active = list(range(len(travs)))

    while active:
        probe_slices = []  # (ti, start, end) into the flat probe batch
        probe_f = []
        probe_r = []
        pos = 0
        for ti in active:
            tv = travs[ti]
            fs, rs = _walk_level(tv, all_tags_arr, stop_tags_arr,
                                 max_breadth, break_on_stop_tags,
                                 stop_big_traversals, count_filter)
            if fs is None or len(fs) == 0:
                tv.level_f = np.zeros(0, np.uint64)
                tv.level_r = np.zeros(0, np.uint64)
                continue
            tv.first = False
            probe_slices.append((ti, pos, pos + len(fs)))
            probe_f.append(fs)
            probe_r.append(rs)
            pos += len(fs)

        if not probe_slices:
            break
        nf, nr, nc, present = _probe(graph,
                                     np.concatenate(probe_f),
                                     np.concatenate(probe_r))
        for ti, s, e in probe_slices:
            tv = travs[ti]
            pres = present[s:e]
            # no per-child keeper filter: pop-time dedup next level is
            # authoritative (and vectorized)
            tv.level_f = nf[s:e][pres]
            tv.level_r = nr[s:e][pres]
            tv.breadth += 1
        active = [ti for ti in active
                  if not travs[ti].done and len(travs[ti].level_f)]

    return [tv.tagged for tv in travs]


def _probe(graph, fs, rs):
    from khmer_tpu.core import hostengine

    if hostengine.use_host_for(graph, "graph"):
        # zero-dispatch neighbor probe off the host table mirror
        return hostengine.host_neighbors_batch(graph, fs, rs)
    n = len(fs)
    pad = 256
    while pad < n:
        pad *= 2
    pf = np.zeros(pad, np.uint64)
    pr = np.zeros(pad, np.uint64)
    pf[:n] = fs
    pr[:n] = rs
    nf, nr, nc, present = graph.neighbors_batch(pf, pr)
    return (np.asarray(nf)[:n], np.asarray(nr)[:n],
            np.asarray(nc)[:n], np.asarray(present)[:n])


def find_all_tags(graph, f, r, break_on_stop_tags=False,
                  stop_big_traversals=False):
    return find_all_tags_batch(graph, [(f, r)], break_on_stop_tags,
                               stop_big_traversals)[0]


def find_all_tags_truncate_on_abundance(graph, f, r, min_count, max_count,
                                        break_on_stop_tags=False,
                                        stop_big_traversals=False):
    """Abundance-truncated tag BFS (subset.cc:399-496)."""
    return find_all_tags_batch(
        graph, [(f, r)], break_on_stop_tags, stop_big_traversals,
        count_range=(min_count, max_count))[0]


def sweep_for_tags(graph, seq, range=0, break_on_stop_tags=False,
                   stop_big_traversals=False):
    """BFS around a sequence's perimeter collecting nearby tags.

    Returns (tagged set, n_traversed). Mirrors
    SubsetPartition::sweep_for_tags (subset.cc:305-394), including the
    seed-at-breadth-0 FIFO and early-return past max_breadth.  Runs on
    the native host tier when available (zero dispatches, one C call
    per sweep); this Python engine is the reference implementation.
    """
    from khmer_tpu.core import hostengine

    if hostengine.use_host_for(graph, "graph"):
        return hostengine.sweep_for_tags(graph, seq, range,
                                         break_on_stop_tags,
                                         stop_big_traversals)

    k = graph.ksize()
    all_tags = graph.all_tags
    stop_tags = graph.stop_tags
    max_breadth = range
    tagged = set()
    traversed = set()

    # queue up all the sequence's k-mers at breadth zero
    codes = H.encode_dna(seq)
    queue = deque()
    for i in _range(len(seq) - k + 1):
        sub = H.decode_dna(codes[i:i + k])
        _, f, r = H._hash_scalar(sub, k)
        traversed.add(min(f, r))
        queue.append((np.uint64(f), np.uint64(r), 0))

    seq_length = len(queue) // 2
    big_perimeter = BIG_TRAVERSALS_ARE * seq_length
    total = 0

    while queue:
        if stop_big_traversals and len(traversed) > big_perimeter:
            tagged.clear()
            break
        # walk until a node needs a probe
        node = None
        while queue:
            f, r, breadth = queue[0]
            c = int(min(f, r))
            if break_on_stop_tags and c in stop_tags:
                queue.popleft()
                continue
            traversed.add(c)
            total += 1
            if c in all_tags:
                tagged.add(c)
                queue.popleft()
                continue
            if breadth == max_breadth:
                queue.popleft()
                continue
            elif breadth > max_breadth:
                return tagged, total
            node = queue.popleft()
            break
        if node is None:
            break
        f, r, breadth = node
        nf, nr, nc, present = _probe(graph, [f], [r])
        for j in _range(8):
            if present[0, j] and int(nc[0, j]) not in traversed:
                queue.append((nf[0, j], nr[0, j], breadth + 1))

    return tagged, total


class SubsetPartition:
    """Union-find partition map over tags (reference subset.hh:59)."""

    def __init__(self, graph):
        self.graph = graph
        self.next_partition_id = 2  # reference: subset.cc:85
        self.partition_map = {}     # tag -> _Box or None
        self.reverse_pmap = {}      # pid -> set of _Box (id-keyed)

    # -- core union-find (mirrors subset.cc:630-788) ----------------------

    def set_partition_id(self, kmer, pid):
        if isinstance(kmer, str):
            kmer = self.graph.hash(kmer)
        s = self.reverse_pmap.get(pid)
        if s is None:
            pp = _Box(pid)
            self.reverse_pmap[pid] = {pp}
        else:
            pp = next(iter(s))
        self.partition_map[int(kmer)] = pp
        if self.next_partition_id <= pid:
            self.next_partition_id = pid + 1

    def assign_partition_id(self, kmer, tagged_kmers):
        if len(tagged_kmers):
            pp = self._join_partitions_by_tags(tagged_kmers, kmer)
            return pp.pid
        else:
            self.partition_map.pop(kmer, None)
            return 0

    def _join_partitions_by_tags(self, tagged_kmers, kmer):
        # iterate in sorted order: the reference's SeenSet is an
        # ordered std::set, and the first ASSIGNED tag found decides
        # which partition ID survives the joins (subset.cc:680-689)
        tagged_kmers = sorted(int(t) for t in tagged_kmers)
        this_pp = None
        for t in tagged_kmers:
            this_pp = self.partition_map.get(t)
            if this_pp is not None:
                break

        if this_pp is None:
            this_pp = _Box(self.next_partition_id)
            self.next_partition_id += 1
            self.reverse_pmap[this_pp.pid] = {this_pp}

        for t in tagged_kmers:
            if t not in self.partition_map:
                self.partition_map[t] = this_pp
            else:
                pp_id = self.partition_map[t]
                if pp_id is None:
                    self.partition_map[t] = this_pp
                elif pp_id.pid != this_pp.pid:
                    this_pp = self._merge_two_partitions(this_pp, pp_id)

        self.partition_map[kmer] = this_pp
        return this_pp

    def _merge_two_partitions(self, the_pp, merge_pp):
        s = self.reverse_pmap[the_pp.pid]
        t = self.reverse_pmap[merge_pp.pid]
        if len(s) < len(t):
            s, t = t, s
            the_pp, merge_pp = merge_pp, the_pp
        del self.reverse_pmap[merge_pp.pid]
        for box in t:
            box.pid = the_pp.pid
            s.add(box)
        return the_pp

    def join_partitions(self, orig, join):
        if orig == join:
            return orig
        if orig == 0 or join == 0:
            return 0
        if orig not in self.reverse_pmap or join not in self.reverse_pmap:
            return 0
        orig_pp = next(iter(self.reverse_pmap[orig]))
        join_pp = next(iter(self.reverse_pmap[join]))
        self._merge_two_partitions(orig_pp, join_pp)
        return orig

    def get_partition_id(self, kmer):
        if isinstance(kmer, str):
            kmer = self.graph.hash(kmer)
        pp = self.partition_map.get(int(kmer))
        return pp.pid if pp is not None else 0

    def get_new_partition(self):
        pp = _Box(self.next_partition_id)
        self.next_partition_id += 1
        return pp

    # -- partitioning driver ----------------------------------------------

    def do_partition(self, first_kmer=0, last_kmer=0,
                     break_on_stop_tags=False, stop_big_traversals=False,
                     batch=DEFAULT_BFS_BATCH, count_range=None):
        """BFS + merge over a sorted tag range (subset.cc:501-553)."""
        tags = sorted(self.graph.all_tags)
        lo = tags.index(first_kmer) if first_kmer else 0
        hi = tags.index(last_kmer) if last_kmer else len(tags)
        span = tags[lo:hi]
        k = self.graph.ksize()

        from khmer_tpu.core import hostengine

        native = hostengine.use_host_for(self.graph, "graph")
        for start in range(0, len(span), batch):
            chunk = span[start:start + batch]
            if native:
                # canonical tag hashes go straight to the native BFS
                tagged_sets = hostengine.find_all_tags_range(
                    self.graph, chunk, break_on_stop_tags,
                    stop_big_traversals, count_range)
            else:
                starts = []
                for tag in chunk:
                    s = H.reverse_hash(tag, k)
                    _, f, r = H._hash_scalar(s, k)
                    starts.append((f, r))
                tagged_sets = find_all_tags_batch(
                    self.graph, starts, break_on_stop_tags,
                    stop_big_traversals, count_range=count_range)
            for tag, tagged in zip(chunk, tagged_sets):
                self.assign_partition_id(tag, tagged)

    def do_partition_with_abundance(self, first_kmer=0, last_kmer=0,
                                    min_count=0, max_count=0,
                                    break_on_stop_tags=False,
                                    stop_big_traversals=False,
                                    batch=DEFAULT_BFS_BATCH):
        """Partition restricted to an abundance band
        (SubsetPartition::do_partition_with_abundance,
        subset.cc:557-613)."""
        self.do_partition(first_kmer, last_kmer, break_on_stop_tags,
                          stop_big_traversals, batch=batch,
                          count_range=(min_count, max_count))

    # -- reporting --------------------------------------------------------

    def count_partitions(self):
        """(n_partitions, n_unassigned) — subset.cc:89-113.

        Iterates the graph's tag set (not the map): tags never assigned
        count as unassigned. The reference's operator[] lookup inserts
        a NULL map entry for such tags as a side effect, which later
        partition_sizes calls then see; reproduced for parity.
        """
        partitions = set()
        n_unassigned = 0
        for tag in self.graph.all_tags:
            pp = self.partition_map.setdefault(int(tag), None)
            if pp is not None:
                partitions.add(pp.pid)
            else:
                n_unassigned += 1
        return len(partitions), n_unassigned

    def partition_sizes(self, min_size=0):
        counts = {}
        n_unassigned = 0
        for tag, pp in self.partition_map.items():
            if pp is not None:
                counts[pp.pid] = counts.get(pp.pid, 0) + 1
            else:
                n_unassigned += 1
        return ([(pid, n) for pid, n in sorted(counts.items())
                 if n >= min_size], n_unassigned)

    def partition_size_distribution(self):
        counts = {}
        n_unassigned = 0
        for tag, pp in self.partition_map.items():
            if pp is not None:
                counts[pp.pid] = counts.get(pp.pid, 0) + 1
            else:
                n_unassigned += 1
        dist = {}
        for n in counts.values():
            dist[n] = dist.get(n, 0) + 1
        return sorted(dist.items()), n_unassigned

    # -- merging ----------------------------------------------------------

    def merge(self, other):
        if self is other:
            return
        diskp_to_pp = {}
        for tag in sorted(other.partition_map):
            pp = other.partition_map[tag]
            if pp is not None:
                self._merge_other(tag, pp.pid, diskp_to_pp)

    def _merge_other(self, tag, other_partition, diskp_to_pp):
        """subset.cc:832-880."""
        if tag in self.graph.stop_tags:
            return
        pp_0 = self.partition_map.get(tag)
        if pp_0 is None:
            existing = diskp_to_pp.get(other_partition)
            if existing is not None:
                self.partition_map[tag] = existing
            else:
                pp_0 = self.get_new_partition()
                self.reverse_pmap[pp_0.pid] = {pp_0}
                self.partition_map[tag] = pp_0
                diskp_to_pp[other_partition] = pp_0
        else:
            existing = diskp_to_pp.get(other_partition)
            if existing is not None:
                if pp_0.pid != existing.pid:
                    pp_0 = self._merge_two_partitions(pp_0, existing)
                    diskp_to_pp[other_partition] = pp_0
            else:
                diskp_to_pp[other_partition] = pp_0

    def merge_from_disk(self, filename):
        """Fold a saved .pmap file into this partition
        (subset.cc:884-1034)."""
        from khmer_tpu.core.oxli_io import (SAVED_FORMAT_VERSION,
                                            SAVED_SIGNATURE, SAVED_SUBSET,
                                            _open_read)

        with _open_read(filename) as f:
            sig = f.read(4)
            if sig != SAVED_SIGNATURE:
                raise OSError(
                    "Incorrect file signature 0x%s while reading subset "
                    "pmap from %s; should be OXLI" % (sig.hex(), filename))
            version = f.read(1)[0]
            if version != SAVED_FORMAT_VERSION:
                raise OSError(
                    "Incorrect file format version %d while reading "
                    "subset pmap from %s" % (version, filename))
            ht_type = f.read(1)[0]
            if ht_type != SAVED_SUBSET:
                raise OSError(
                    "Incorrect file format type %d while reading subset "
                    "pmap from %s" % (ht_type, filename))
            (ksize,) = struct.unpack("<I", f.read(4))
            if ksize != self.graph.ksize():
                raise OSError(
                    "Incorrect k-mer size %d while reading subset pmap "
                    "from %s" % (ksize, filename))
            f.read(8)  # pmap_size header (includes null entries)
            diskp_to_pp = {}
            data = f.read()
            n = len(data) // 12
            for i in range(n):
                tag, pid = struct.unpack_from("<QI", data, i * 12)
                self._merge_other(tag, pid, diskp_to_pp)

    def save_partitionmap(self, filename):
        """subset.cc:1036-1097 (tags in sorted order)."""
        from khmer_tpu.core.oxli_io import (SAVED_FORMAT_VERSION,
                                            SAVED_SIGNATURE, SAVED_SUBSET)

        with open(filename, "wb") as f:
            f.write(SAVED_SIGNATURE)
            f.write(bytes([SAVED_FORMAT_VERSION, SAVED_SUBSET]))
            f.write(struct.pack("<IQ", self.graph.ksize(),
                                len(self.partition_map)))
            for tag in sorted(self.partition_map):
                pp = self.partition_map[tag]
                if pp is not None:
                    f.write(struct.pack("<QI", tag, pp.pid))

    def load_partitionmap(self, filename):
        self.merge_from_disk(filename)

    # -- knot detection ---------------------------------------------------

    @classmethod
    def load(cls, filename, graph):
        subset = cls(graph)
        subset.merge_from_disk(filename)
        return subset

    def _clear_partition(self, the_partition):
        """Remove a partition; returns its tags (subset.cc:1398-1424)."""
        partition_tags = set()
        for tag, pp in self.partition_map.items():
            if pp is not None and pp.pid == the_partition:
                partition_tags.add(tag)
        for tag in partition_tags:
            del self.partition_map[tag]
        self.reverse_pmap.pop(the_partition, None)
        return partition_tags

    def repartition_largest_partition(self, distance, threshold,
                                      frequency, counting):
        """Find highly-connected k-mers in the largest partition and
        turn them into stop tags, then re-partition
        (subset.cc:1218-1359). Returns the next-largest partition size.
        """
        from khmer_tpu.core import traversal as T

        cm = {}
        for tag, pp in self.partition_map.items():
            if pp is not None:
                cm[pp.pid] = cm.get(pp.pid, 0) + 1
        if not cm:
            raise RuntimeError("no partitions to repartition")
        biggest_size = max(cm.values())
        biggest_p = 0
        for pid, size in cm.items():
            if size == biggest_size:
                biggest_p = pid
        sizes = sorted(set(cm.values()))
        next_largest = sizes[-2] if len(sizes) > 1 else 0

        bigtags = self._clear_partition(biggest_p)
        graph = self.graph
        if not hasattr(graph, "repart_small_tags"):
            graph.repart_small_tags = set()

        # evaluate counting sequentially: per keeper, gather per-table
        # base counts in one batch (host mirror when available, device
        # otherwise), then walk with a (table, bin) delta map so
        # FP-level interactions match the reference
        from khmer_tpu.core import hostengine
        from khmer_tpu.core import sketch_kernels as K

        import jax.numpy as jnp

        primes = tuple(counting._primes)
        host_counting = hostengine.use_host_for(counting, "trim")
        pertable = None if host_counting else \
            K.make_pertable_get(counting.storage_kind, primes)

        for tag in sorted(bigtags):
            if tag in graph.repart_small_tags:
                continue
            keeper = set()
            count = T.traverse_from_kmer(graph, tag, distance,
                                         keeper=keeper)
            if count >= threshold:
                kms = np.array(sorted(keeper), dtype=np.uint64)
                if host_counting:
                    base = hostengine.per_table_counts(counting, kms)
                else:
                    pad = max(((len(kms) + 255) // 256) * 256, 256)
                    kb = np.zeros(pad, np.uint64)
                    kb[: len(kms)] = kms
                    base = np.asarray(pertable(
                        counting.tables, jnp.asarray(kb)))[:, : len(kms)]
                delta = {}
                pending = []
                for i, km in enumerate(kms):
                    km = int(km)
                    cur = min(
                        int(base[t, i]) + delta.get(
                            ((km % primes[t]) + (t << 60)), 0)
                        for t in _range(len(primes)))
                    if cur > frequency:
                        graph.stop_tags.add(km)
                    else:
                        pending.append(km)
                        for t, p in enumerate(primes):
                            key = (km % p) + (t << 60)
                            delta[key] = delta.get(key, 0) + 1
                if pending:
                    arr = np.array(pending, dtype=np.uint64)
                    if host_counting:
                        hostengine.add_hashes(counting, arr)
                    else:
                        counting._commit_hashes(arr)
            else:
                graph.repart_small_tags.add(tag)

        self.repartition_a_partition(bigtags)
        return next_largest

    def repartition_a_partition(self, partition_tags):
        """Re-run find_all_tags over a tag set, honoring stop tags
        (subset.cc:1361-1392)."""
        from khmer_tpu.ops import hashing as Hh

        k = self.graph.ksize()
        tags = sorted(partition_tags)
        for start in _range(0, len(tags), DEFAULT_BFS_BATCH):
            chunk = tags[start:start + DEFAULT_BFS_BATCH]
            starts = []
            for tag in chunk:
                s = Hh.reverse_hash(tag, k)
                _, f, r = Hh._hash_scalar(s, k)
                starts.append((f, r))
            tagged_sets = find_all_tags_batch(self.graph, starts,
                                              break_on_stop_tags=True,
                                              stop_big_traversals=False)
            for tag, tagged in zip(chunk, tagged_sets):
                tagged = set(t for t in tagged if t in partition_tags)
                self.assign_partition_id(tag, tagged)

    # -- annotation -------------------------------------------------------

    def output_partitioned_file(self, infilename, outputfile,
                                output_unassigned=False):
        """Annotate reads with partition IDs (subset.cc:115-208).

        Reads are hashed in device batches; the first-mapped-tag scan
        per read is a vectorized membership test against the sorted
        tag set (one device call + numpy per batch, not per read).
        """
        import jax.numpy as jnp

        from khmer_tpu.core import hostengine, pipeline
        from khmer_tpu.ops import hashing as H

        if hostengine.use_host_for(self.graph, "graph"):
            return self._output_partitioned_host(infilename, outputfile,
                                                 output_unassigned)

        n_singletons = 0
        partitions = set()
        outfile = open(outputfile, "w")
        k = self.graph.ksize()
        tags_sorted = np.fromiter(self.partition_map.keys(), np.uint64,
                                  len(self.partition_map))
        tags_sorted.sort()
        hash_fn = pipeline.make_hash_batch(k, self.graph.hash_family)
        batcher = pipeline.Batcher(k)
        pending = []

        def emit(read, partition_id):
            nonlocal n_singletons
            seq = read.cleaned_seq
            if partition_id > 0 or output_unassigned:
                if read.quality:
                    outfile.write("@%s\t%d\n%s\n+\n%s\n" % (
                        read.name, partition_id, seq, read.quality))
                else:
                    outfile.write(">%s\t%d\n%s\n" % (
                        read.name, partition_id, seq))

        def flush(batch):
            nonlocal n_singletons
            if batch is None:
                return
            if isinstance(batch, list):
                for b in batch:
                    flush(b)
                return
            codes, lengths = batch
            hashes, valid = hash_fn(jnp.asarray(codes),
                                    jnp.asarray(lengths))
            hashes = np.asarray(hashes)
            valid = np.asarray(valid)
            ismap = valid & _sorted_contains(tags_sorted,
                                             hashes.ravel()
                                             ).reshape(hashes.shape)
            for i, read in enumerate(pending):
                partition_id = 0
                hit = np.nonzero(ismap[i])[0]
                if hit.size:
                    pp = self.partition_map[int(hashes[i, hit[0]])]
                    if pp is None:
                        n_singletons += 1
                    else:
                        partition_id = pp.pid
                        partitions.add(partition_id)
                emit(read, partition_id)
            pending.clear()

        for read in pipeline.records_from(infilename):
            seq = read.cleaned_seq
            if len(seq) < k:
                flush(batcher.flush())  # keep output in stream order
                emit(read, 0)
                continue
            if len(seq) > pipeline.MAX_ROW_LEN:
                flush(batcher.flush())
                # long reads: scalar path, same first-mapped-tag rule
                partition_id = 0
                for h in self.graph._hashes_for_sequence(seq):
                    if int(h) in self.partition_map:
                        pp = self.partition_map[int(h)]
                        if pp is None:
                            n_singletons += 1
                        else:
                            partition_id = pp.pid
                            partitions.add(partition_id)
                        break
                emit(read, partition_id)
                continue
            pending.append(read)
            flush(batcher.add(seq))
        flush(batcher.flush())
        outfile.close()
        return len(partitions) + n_singletons


    def _output_partitioned_host(self, infilename, outputfile,
                                 output_unassigned=False):
        """Host-tier annotate: per-read zero-dispatch hashing + a
        sorted-array scan for the first mapped tag (subset.cc:115-208
        semantics, no device round trips)."""
        from khmer_tpu.core import hostengine, pipeline
        from khmer_tpu.ops import hashing as Hh

        n_singletons = 0
        partitions = set()
        k = self.graph.ksize()
        tags_sorted = np.fromiter(self.partition_map.keys(), np.uint64,
                                  len(self.partition_map))
        tags_sorted.sort()

        def window_batches(records, size=16384):
            batch = []
            for rec in records:
                batch.append(rec)
                if len(batch) >= size:
                    yield batch
                    batch = []
            if batch:
                yield batch

        with open(outputfile, "w") as outfile:
            for window in window_batches(
                    pipeline.records_from(infilename)):
                # one flat hash pass for the whole window: reads are
                # contiguous in the packed codes, so read i's windows
                # are flat_hashes[starts[i] : ends[i]-k+1]
                codes, starts, ends, _ = hostengine.pack_records(window)
                flat = Hh.host_hash_windows(codes, k)
                ismap = _sorted_contains(tags_sorted, flat) \
                    if flat.size else np.zeros(0, bool)
                for i, read in enumerate(window):
                    seq = read.cleaned_seq
                    partition_id = 0
                    lo = starts[i]
                    hi = ends[i] - k + 1
                    if hi > lo:
                        hit = np.nonzero(ismap[lo:hi])[0]
                        if hit.size:
                            pp = self.partition_map[
                                int(flat[lo + hit[0]])]
                            if pp is None:
                                n_singletons += 1
                            else:
                                partition_id = pp.pid
                                partitions.add(partition_id)
                    if partition_id > 0 or output_unassigned:
                        if read.quality:
                            outfile.write("@%s\t%d\n%s\n+\n%s\n" % (
                                read.name, partition_id, seq,
                                read.quality))
                        else:
                            outfile.write(">%s\t%d\n%s\n" % (
                                read.name, partition_id, seq))
        return len(partitions) + n_singletons


def consume_partitioned_fasta(graph, filename):
    """Load a partition-annotated FASTA; tag each read's first k-mer and
    record its partition (reference hashgraph.cc:368-418).

    Counting goes through the batched stream pipeline (one fused device
    dispatch per chunk); the tag/partition bookkeeping is host-only.
    """
    from khmer_tpu.core import pipeline

    subset = SubsetPartition(graph)
    total_reads = 0
    if isinstance(filename, str):
        records, second_pass = pipeline.records_from(filename), filename
    else:
        records = list(pipeline.records_from(filename))
        second_pass = records
    for record in records:
        seq = record.cleaned_seq
        name = record.name
        # partition id comes from a '\tN' name suffix and is mandatory
        # (reference read_parsers.hh:210-233 throws without the tab)
        parts = name.rsplit("\t", 1)
        if len(parts) != 2:
            raise ValueError(
                "consume_partitioned_fasta cannot find partition ID "
                "for read " + name)
        pid = _atoi_prefix(parts[1])  # C atoi(): leading-digit prefix
        total_reads += 1
        if len(seq) < graph.ksize():
            continue
        tag = graph.hash(seq[: graph.ksize()])
        graph.all_tags.add(tag)
        subset.set_partition_id(tag, pid)
    _, n_consumed = pipeline.consume_seqfile(graph, second_pass)
    return total_reads, n_consumed, subset
