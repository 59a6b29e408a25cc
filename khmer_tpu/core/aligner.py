"""Graph-guided HMM read alignment/correction.

A faithful re-implementation of the reference ReadAligner
(src/oxli/read_aligner.cc, include/oxli/read_aligner.hh): A* search over
{MATCH, INSERT_READ, INSERT_GRAPH} x {trusted, untrusted} states with the
trained log2-probability transition matrix, seeded at the
highest-coverage k-mer and extended in both directions.

Includes the reference's closed-set quirk (std::map keyed by the
f_score comparator) for behavioral parity.
"""

import heapq
import math

from khmer_tpu.ops import hashing as H

# states
MATCH, INSERT_READ, INSERT_GRAPH = 0, 1, 2
MATCH_UNTRUSTED, INSERT_READ_UNTRUSTED, INSERT_GRAPH_UNTRUSTED = 3, 4, 5

# transitions (reference read_aligner.hh enum Transition order)
(MM, MIr, MIg, MMu, MIru, MIgu,
 IrM, IrIr, IrMu, IrIru,
 IgM, IgIg, IgMu, IgIgu,
 MuM, MuIr, MuIg, MuMu, MuIru, MuIgu,
 IruM, IruIr, IruMu, IruIru,
 IguM, IguIg, IguMu, IguIgu,
 DISALLOWED) = range(29)


def _log2(x):
    return math.log2(x)


# trained transition log-probabilities (read_aligner.hh trans_default)
TRANS_DEFAULT = [
    _log2(0.9848843), _log2(0.0000735), _log2(0.0000334),
    _log2(0.0150068), _log2(0.0000017), _log2(0.0000003),   # M_t
    _log2(0.5196194), _log2(0.4647955), _log2(0.0059060),
    _log2(0.0096792),                                       # Ir_t
    _log2(0.7611255), _log2(0.2294619), _log2(0.0072673),
    _log2(0.0021453),                                       # Ig_t
    _log2(0.0799009), _log2(0.0000262), _log2(0.0001836),
    _log2(0.9161349), _log2(0.0033370), _log2(0.0004173),   # M_u
    _log2(0.1434529), _log2(0.0036995), _log2(0.2642928),
    _log2(0.5885548),                                       # Ir_u
    _log2(0.1384551), _log2(0.0431328), _log2(0.6362921),
    _log2(0.1821200),                                       # Ig_u
]

FREQ_DEFAULT = [_log2(0.955), _log2(0.04), _log2(0.004), _log2(0.001)]

_NUCL = "ACGT"
_CODE = {"A": 0, "C": 2, "G": 3, "T": 1}  # 2-bit codes
BACKGROUND_PROB = 0.0

_TRANS_TABLE = {}


def _init_trans_table():
    """get_trans (read_aligner.cc:113-186)."""
    t = _TRANS_TABLE
    t[(MATCH, MATCH)] = MM
    t[(MATCH, INSERT_GRAPH)] = MIg
    t[(MATCH, INSERT_READ)] = MIr
    t[(MATCH, MATCH_UNTRUSTED)] = MMu
    t[(MATCH, INSERT_GRAPH_UNTRUSTED)] = MIgu
    t[(MATCH, INSERT_READ_UNTRUSTED)] = MIru
    t[(INSERT_GRAPH, MATCH)] = IgM
    t[(INSERT_GRAPH, INSERT_GRAPH)] = IgIg
    t[(INSERT_GRAPH, MATCH_UNTRUSTED)] = IgMu
    t[(INSERT_GRAPH, INSERT_GRAPH_UNTRUSTED)] = IgIgu
    t[(INSERT_READ, MATCH)] = IrM
    t[(INSERT_READ, INSERT_READ)] = IrIr
    t[(INSERT_READ, MATCH_UNTRUSTED)] = IrMu
    t[(INSERT_READ, INSERT_READ_UNTRUSTED)] = IrIru
    t[(MATCH_UNTRUSTED, MATCH)] = MuM
    t[(MATCH_UNTRUSTED, INSERT_GRAPH)] = MuIg
    t[(MATCH_UNTRUSTED, INSERT_READ)] = MuIr
    t[(MATCH_UNTRUSTED, MATCH_UNTRUSTED)] = MuMu
    t[(MATCH_UNTRUSTED, INSERT_GRAPH_UNTRUSTED)] = MuIgu
    t[(MATCH_UNTRUSTED, INSERT_READ_UNTRUSTED)] = MuIru
    t[(INSERT_GRAPH_UNTRUSTED, MATCH)] = IguM
    t[(INSERT_GRAPH_UNTRUSTED, INSERT_GRAPH)] = IguIg
    t[(INSERT_GRAPH_UNTRUSTED, MATCH_UNTRUSTED)] = IguMu
    t[(INSERT_GRAPH_UNTRUSTED, INSERT_GRAPH_UNTRUSTED)] = IguIgu
    t[(INSERT_READ_UNTRUSTED, MATCH)] = IruM
    t[(INSERT_READ_UNTRUSTED, INSERT_READ)] = IruIr
    t[(INSERT_READ_UNTRUSTED, MATCH_UNTRUSTED)] = IruMu
    t[(INSERT_READ_UNTRUSTED, INSERT_READ_UNTRUSTED)] = IruIru


_init_trans_table()


def get_trans(s1, s2):
    return _TRANS_TABLE.get((s1, s2), DISALLOWED)


def get_null(length):
    """Null model log-odds for a length (read_aligner.cc:103-106)."""
    return _log2(0.25) * length + _log2(1.0 / (length + 1))


class _Node:
    __slots__ = ("prev", "base", "seq_idx", "state", "trans", "fwd",
                 "rc", "score", "f_score", "h_score", "trusted", "cov",
                 "num_indels", "length")

    def __init__(self, prev, base, seq_idx, state, trans, fwd, rc,
                 length):
        self.prev = prev
        self.base = base
        self.seq_idx = seq_idx
        self.state = state
        self.trans = trans
        self.fwd = fwd
        self.rc = rc
        self.score = 0.0
        self.f_score = 0.0
        self.h_score = 0.0
        self.trusted = False
        self.cov = 0
        self.num_indels = 0
        self.length = length


class Alignment:
    def __init__(self):
        self.graph_alignment = ""
        self.read_alignment = ""
        self.trusted = ""
        self.covs = []
        self.score = 0.0
        self.truncated = True


def _empty_alignment():
    ret = Alignment()
    ret.score = float("-inf")
    return ret


class ReadAligner:
    """khmer-compatible ReadAligner over a Countgraph."""

    def __init__(self, countgraph, trusted_cutoff=None, bits_theta=None,
                 scoring_matrix=None, transitions=None,
                 trusted_cov_cutoff=None, **kwargs):
        if trusted_cov_cutoff is not None:
            trusted_cutoff = trusted_cov_cutoff
        if bits_theta is None:
            bits_theta = kwargs.pop("bits_theta", 0)
        if trusted_cutoff is None:
            trusted_cutoff = 0
        self._init(countgraph, trusted_cutoff, bits_theta,
                   scoring_matrix, transitions)

    def _init(self, countgraph, trusted_cutoff, bits_theta,
              scoring_matrix=None, transitions=None):
        self.graph = countgraph
        k = countgraph.ksize()
        self._k = k
        self._bitmask = (1 << (2 * k)) - 1
        self._rc_shift = 2 * k - 2
        self.trusted_cutoff = int(trusted_cutoff)
        self.bits_theta = float(bits_theta)
        if scoring_matrix is None:
            scoring_matrix = FREQ_DEFAULT
        if transitions is None:
            transitions = TRANS_DEFAULT
        (self.trusted_match, self.trusted_mismatch,
         self.untrusted_match, self.untrusted_mismatch) = scoring_matrix
        self.tsc = list(transitions)
        # host-side count memo: the A* revisits k-mers constantly and a
        # per-node device .get() costs a full dispatch round-trip; the
        # aligner treats the graph as read-only during a search
        self._count_cache = {}
        self._host_tabs = None   # lazy host table mirror (see
        #                          _host_gather); False = unsupported
        self._trans66 = None     # native-engine transition table cache

    # -- neighbor hash math (2-bit next/prev, hashgraph.hh:67-71) --------

    def _next(self, fwd, rc, nucl):
        code = _CODE[nucl]
        nf = ((fwd << 2) | code) & self._bitmask
        nr = (rc >> 2) | ((code ^ 1) << self._rc_shift)
        return nf, nr

    def _prev(self, fwd, rc, nucl):
        code = _CODE[nucl]
        nf = (fwd >> 2) | (code << self._rc_shift)
        nr = ((rc << 2) | (code ^ 1)) & self._bitmask
        return nf, nr

    def _host_gather(self, canons):
        """Counts straight off the host table mirror — the A* expands
        one node at a time, and a per-node device round trip would
        dominate the alignment.
        Returns None when the storage kind has no host gather."""
        if self._host_tabs is False:
            return None
        if self._host_tabs is None:
            g = self.graph
            if getattr(g, "storage_kind", None) not in ("byte", "nibble"):
                self._host_tabs = False
                return None
            self._host_tabs = (g.host_view(), tuple(g._primes),
                               g.storage_kind)
        tabs, primes, kind = self._host_tabs
        out = []
        for c in canons:
            m = 255 if kind == "byte" else 15
            for t, p in zip(tabs, primes):
                bin_ = c % p
                if kind == "byte":
                    v = int(t[bin_])
                else:
                    byte = int(t[bin_ >> 1])
                    v = (byte & 0x0F) if (bin_ & 1) else (byte >> 4)
                if v < m:
                    m = v
            if m == 255 and getattr(self.graph, "_use_bigcount", False):
                m = self.graph._bigcounts.get(c, m)
            out.append(m)
        return out

    def _count(self, fwd, rc):
        c = min(fwd, rc)
        v = self._count_cache.get(c)
        if v is None:
            host = self._host_gather([c])
            v = host[0] if host is not None else int(self.graph.get(c))
            self._count_cache[c] = v
        return v

    def _counts4(self, pairs):
        """Counts for the four candidate neighbors — host-mirror gather
        when available, else ONE device call (cache misses batched)."""
        import numpy as np

        canons = [min(f, r) for f, r in pairs]
        missing = sorted({c for c in canons
                          if c not in self._count_cache})
        if missing:
            vals = self._host_gather(missing)
            if vals is None:
                vals = self.graph.get_counts_for_hashes(
                    np.asarray(missing, dtype=np.uint64))
            for c, v in zip(missing, vals):
                self._count_cache[c] = int(v)
        return [self._count_cache[c] for c in canons]

    # -- A* search --------------------------------------------------------

    def _enumerate(self, open_heap, counter, curr, forward, seq):
        if forward:
            next_seq_idx = curr.seq_idx + 1
            if next_seq_idx >= len(seq):
                return
            remaining = len(seq) - next_seq_idx
        else:
            next_seq_idx = curr.seq_idx - 1
            remaining = next_seq_idx

        if forward:
            cand = [self._next(curr.fwd, curr.rc, n) for n in _NUCL]
        else:
            cand = [self._prev(curr.fwd, curr.rc, n) for n in _NUCL]
        covs = self._counts4(cand)

        for i, nucl in enumerate(_NUCL):
            nf, nr = cand[i]
            cov = covs[i]
            if cov == 0:
                continue
            elif cov < self.trusted_cutoff:
                start_state = MATCH_UNTRUSTED
                end_state = INSERT_GRAPH_UNTRUSTED
                match_sc = self.trusted_match
                mismatch_sc = self.trusted_mismatch
            else:
                start_state = MATCH
                end_state = INSERT_GRAPH
                match_sc = self.trusted_match
                mismatch_sc = self.trusted_mismatch

            for next_state in range(start_state, end_state + 1):
                trans = get_trans(curr.state, next_state)
                hcost = self.tsc[get_trans(next_state, MATCH)] + \
                    (self.tsc[MM] + self.trusted_match) * \
                    (0 if remaining == 0 else remaining - 1)
                if trans == DISALLOWED:
                    continue

                if next_state in (MATCH, MATCH_UNTRUSTED):
                    if nucl == seq[next_seq_idx]:
                        sc = match_sc
                    else:
                        sc = mismatch_sc
                else:
                    sc = BACKGROUND_PROB

                if next_state in (MATCH, MATCH_UNTRUSTED):
                    node = _Node(curr, i, next_seq_idx, next_state,
                                 trans, nf, nr, curr.length + 1)
                    node.num_indels = curr.num_indels
                elif next_state in (INSERT_READ,
                                    INSERT_READ_UNTRUSTED):
                    node = _Node(curr, i, next_seq_idx, next_state,
                                 trans, curr.fwd, curr.rc,
                                 curr.length + 1)
                    node.num_indels = curr.num_indels + 1
                else:  # INSERT_GRAPH(_UNTRUSTED)
                    node = _Node(curr, i, curr.seq_idx, next_state,
                                 trans, nf, nr, curr.length)
                    node.num_indels = curr.num_indels + 1

                node.score = curr.score + sc + self.tsc[trans]
                node.trusted = cov >= self.trusted_cutoff
                node.cov = cov
                node.h_score = hcost
                node.f_score = node.score + node.h_score

                if node.num_indels < 3 and \
                        node.score - get_null(node.length) > \
                        node.length * self.bits_theta:
                    counter[0] += 1
                    heapq.heappush(open_heap,
                                   (-node.f_score, counter[0], node))

    def _native_subalign(self, start_node, seq_len, forward, seq):
        """The A* sub-search on the native host tier (hg_subalign in
        src/hostgraph.cc) — identical scores/tie-breaking, ~100x the
        node throughput of the Python engine. Returns None when the
        native library or storage kind can't serve it."""
        from khmer_tpu.core import hostengine

        g = self.graph
        if not hostengine.available():
            return None
        if getattr(g, "storage_kind", None) not in ("byte", "nibble"):
            return None
        if getattr(g, "_use_bigcount", False):
            return None  # covs above 255 need the host-Python fixup
        import ctypes

        import numpy as np

        lib = hostengine._load()
        tabs, ptrs, primes_p, _keep = hostengine._view_args(g)
        kind = hostengine.KIND[g.storage_kind]
        if self._trans66 is None:
            t66 = np.full(36, DISALLOWED, dtype=np.int8)
            for (s1, s2), tr in _TRANS_TABLE.items():
                t66[s1 * 6 + s2] = tr
            self._trans66 = t66
            self._tsc29 = np.zeros(29, dtype=np.float64)
            self._tsc29[: len(self.tsc)] = self.tsc
            self._sc4 = np.asarray(
                [self.trusted_match, self.trusted_mismatch,
                 self.untrusted_match, self.untrusted_mismatch],
                dtype=np.float64)
        codes = np.asarray([_CODE.get(ch, 255) for ch in seq],
                           dtype=np.uint8)
        cap = 4096
        while True:
            st = np.empty(cap, np.uint8)
            ba = np.empty(cap, np.uint8)
            si = np.empty(cap, np.int32)
            tr = np.empty(cap, np.uint8)
            cv = np.empty(cap, np.uint16)
            best_score = ctypes.c_double(0.0)
            trunc = ctypes.c_int(1)
            n = lib.hg_subalign(
                kind, ptrs, primes_p, len(tabs),
                self._k, self.trusted_cutoff,
                float(self.bits_theta),
                self._tsc29.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_double)),
                self._sc4.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_double)),
                self._trans66.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int8)),
                codes.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8)),
                len(seq),
                int(start_node.fwd), int(start_node.rc),
                int(start_node.seq_idx), float(start_node.score),
                1 if forward else 0,
                st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                si.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                tr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                cv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                cap, ctypes.byref(best_score), ctypes.byref(trunc))
            if n >= 0:
                break
            cap *= 4
        # assemble the Alignment exactly like _extract_alignment
        ret = Alignment()
        ret.score = best_score.value
        ret.truncated = bool(trunc.value)
        graph_alignment = []
        read_alignment = []
        trusted = []
        covs = []
        for i in range(int(n)):     # chain order: best -> root
            state = int(st[i])
            if state in (MATCH, MATCH_UNTRUSTED):
                graph_base = _NUCL[ba[i]]
                read_base = seq[si[i]]
            elif state in (INSERT_READ, INSERT_READ_UNTRUSTED):
                graph_base = "-"
                read_base = seq[si[i]].lower()
            else:
                graph_base = _NUCL[ba[i]].lower()
                read_base = "-"
            if forward:
                graph_alignment.insert(0, graph_base)
                read_alignment.insert(0, read_base)
                trusted.insert(0, "T" if tr[i] else "F")
                covs.insert(0, int(cv[i]))
            else:
                graph_alignment.append(graph_base)
                read_alignment.append(read_base)
                trusted.append("T" if tr[i] else "F")
        ret.graph_alignment = "".join(graph_alignment)
        ret.read_alignment = "".join(read_alignment)
        ret.trusted = "".join(trusted)
        ret.covs = covs
        return ret

    def _subalign(self, start_node, seq_len, forward, seq):
        native = self._native_subalign(start_node, seq_len, forward,
                                       seq)
        if native is not None:
            return native
        open_heap = []
        counter = [0]
        heapq.heappush(open_heap, (-start_node.f_score, 0, start_node))
        # closed-set quirk: the reference std::map is keyed by the
        # f_score comparator, so nodes with equal f_score collide
        closed = {}
        best = None

        while open_heap:
            _, _, curr = heapq.heappop(open_heap)

            if best is None or (best.score - get_null(best.length)
                                < curr.score - get_null(curr.length)):
                best = curr
            if curr.seq_idx == seq_len - 1 or curr.seq_idx == 0:
                best = curr
                break

            key = curr.f_score
            entry = closed.get(key)
            if entry is None:
                times_closed = 0
            elif entry[0] >= curr.score:
                times_closed = entry[1]
                del closed[key]
            else:
                continue
            if times_closed > 200:
                continue
            closed[key] = (curr.score, times_closed + 1)

            self._enumerate(open_heap, counter, curr, forward, seq)

        return self._extract_alignment(best, forward, seq)

    def _extract_alignment(self, node, forward, read):
        ret = Alignment()
        if node is None:
            ret.score = 0
            return ret
        if not node.seq_idx < len(read):
            raise RuntimeError("alignment extraction out of bounds")
        read_alignment = []
        graph_alignment = []
        trusted = []
        covs = []
        ret.score = node.score
        ret.truncated = (node.seq_idx != 0) and \
            (node.seq_idx != len(read) - 1)

        while node is not None and node.prev is not None:
            if node.state in (MATCH, MATCH_UNTRUSTED):
                graph_base = _NUCL[node.base]
                read_base = read[node.seq_idx]
            elif node.state in (INSERT_READ, INSERT_READ_UNTRUSTED):
                graph_base = "-"
                read_base = read[node.seq_idx].lower()
            elif node.state in (INSERT_GRAPH, INSERT_GRAPH_UNTRUSTED):
                graph_base = _NUCL[node.base].lower()
                read_base = "-"
            else:
                graph_base = "?"
                read_base = "?"

            if forward:
                graph_alignment.insert(0, graph_base)
                read_alignment.insert(0, read_base)
                trusted.insert(0, "T" if node.trusted else "F")
                covs.insert(0, node.cov)
            else:
                graph_alignment.append(graph_base)
                read_alignment.append(read_base)
                trusted.append("T" if node.trusted else "F")
            last = node
            node = node.prev

        ret.graph_alignment = "".join(graph_alignment)
        ret.read_alignment = "".join(read_alignment)
        ret.trusted = "".join(trusted)
        ret.covs = covs

        if ret.truncated:
            farthest = last.seq_idx if False else None
            # reference: forward pads with the unaligned read suffix,
            # reverse pads with the prefix up to the root's seq_idx
            if forward:
                # farthest_seq_idx recorded before walking: use the end
                # node's seq_idx
                pass
        return ret

    # -- public API -------------------------------------------------------

    def align(self, read):
        """Returns (score, graph_alignment, read_alignment, truncated)."""
        a = self._align(read)
        return (a.score, a.graph_alignment.upper(),
                a.read_alignment.upper(), a.truncated)

    def align_forward(self, read):
        a = self._align_forward(read)
        return (a.score, a.graph_alignment.upper(),
                a.read_alignment.upper(), a.truncated, a.covs)

    def _align(self, read):
        k = self._k
        if len(read) < k:
            return _empty_alignment()
        num_kmers = len(read) - k + 1

        # seed = first highest-coverage k-mer; ONE bulk count gather
        # (host mirror when available) instead of a device call per
        # window (read_aligner.cc:558-570)
        import numpy as np

        hashes = self.graph._hashes_for_sequence(read)
        covs = self._host_gather([int(h) for h in hashes])
        if covs is None:
            covs = [int(c) for c in
                    self.graph.get_counts_for_hashes(hashes)]
        best_idx = int(np.argmax(covs)) if covs else 0
        best_cov = covs[best_idx] if covs else 0
        if best_cov == 0:
            return _empty_alignment()
        best_kmer = read[best_idx:best_idx + k]

        _, fhash, rhash = H._hash_scalar(best_kmer, k)

        e = _NUCL.index(best_kmer[k - 1]) if best_kmer[k - 1] in _NUCL \
            else 0
        start = _Node(None, e, best_idx + k - 1, MATCH, MM, fhash,
                      rhash, k)
        if best_cov >= self.trusted_cutoff:
            start.score = k * self.trusted_match + k * self.tsc[MM]
        else:
            start.score = k * self.untrusted_match + k * self.tsc[MM]

        forward = self._subalign(start, len(read), True, read)
        final_length = len(forward.read_alignment) + k

        start2 = _Node(None, e, best_idx, MATCH, MM, fhash, rhash, k)
        start2.score = start.score
        reverse = self._subalign(start2, len(read), False, read)
        final_length += len(reverse.read_alignment)

        ret = Alignment()
        ret.score = reverse.score + forward.score - start.score
        ret.read_alignment = (reverse.read_alignment + best_kmer
                              + forward.read_alignment)
        ret.graph_alignment = (reverse.graph_alignment + best_kmer
                               + forward.graph_alignment)
        ret.score = ret.score - get_null(final_length)
        ret.truncated = forward.truncated or reverse.truncated
        return ret

    def _align_forward(self, read):
        k = self._k
        if len(read) < k:
            return _empty_alignment()
        kmer = read[:k]
        cov = self.graph.get(kmer)
        if cov == 0:
            return _empty_alignment()
        _, fhash, rhash = H._hash_scalar(kmer, k)
        e = _NUCL.index(kmer[k - 1]) if kmer[k - 1] in _NUCL else 0
        start = _Node(None, e, k - 1, MATCH, MM, fhash, rhash, k)
        if cov >= self.trusted_cutoff:
            start.score = k * self.trusted_match + k * self.tsc[MM]
        else:
            start.score = k * self.untrusted_match + k * self.tsc[MM]

        forward = self._subalign(start, len(read), True, read)
        final_length = len(forward.read_alignment) + k

        ret = Alignment()
        ret.score = forward.score
        ret.read_alignment = kmer + forward.read_alignment
        ret.graph_alignment = kmer + forward.graph_alignment
        ret.score = ret.score - get_null(final_length)
        ret.truncated = forward.truncated
        ret.covs = [cov] + forward.covs + [0] * (k - 1)
        return ret

    # -- introspection (readaligner.pyx parity) ---------------------------

    @staticmethod
    def _default_transition_probabilities():
        return list(TRANS_DEFAULT)

    @staticmethod
    def _default_scoring_matrix():
        return list(FREQ_DEFAULT)

    def get_scoring_matrix(self):
        return [self.trusted_match, self.trusted_mismatch,
                self.untrusted_match, self.untrusted_mismatch]

    def get_transition_probabilities(self):
        return list(self.tsc)
