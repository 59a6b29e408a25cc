// hostgraph.cc — native host engine for latency-bound sequential paths.
//
// The device is the throughput tier (bulk counting via the device kernels
// in khmer_tpu/core/sketch_kernels.py + core/blocked.py, sharded via
// parallel/*).  But several of the reference's flagship workloads are
// *latency*-bound sequential state machines over tiny streams:
// tag-spacing during consume (reference src/oxli/hashgraph.cc:200-271),
// digital normalization (scripts/normalize-by-median.py:155-179), the
// partition BFS (src/oxli/subset.cc:213-300), HLL ingestion
// (src/oxli/hllcounter.cc:250-310).  Dispatching one device call per
// BFS level or per read bundle costs ~95 ms of interconnect latency per
// round trip; no batching schedule beats a host loop for streams this
// small.  So — exactly like XLA routes small ops to the VPU instead of
// the MXU — the runtime routes sub-threshold sequential work to this
// native engine, operating on host-resident table mirrors (see the
// residency manager in khmer_tpu/core/sketch.py).  Semantics are
// bit-identical to the device kernels (cross-engine equivalence is
// enforced by tests/test_hostengine.py).
//
// Build: make -C src   (produces libkhmer_tpu_host.so)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// storage kinds (mirrors khmer_tpu.core.sketch_kernels layouts)
enum Kind { KIND_BIT = 0, KIND_BYTE = 1, KIND_NIBBLE = 2 };

constexpr int MAX_KCOUNT = 255;    // reference include/oxli/oxli.hh:81
constexpr int NIBBLE_MAX = 15;
constexpr uint64_t BIG_TRAVERSALS_ARE = 200;  // subset.cc:54

struct Tables {
    int kind;
    int n_tables;
    uint8_t** ptr;
    const uint64_t* primes;
};

// min-over-tables count (reference storage.hh get_count for each kind;
// bigcount fixup stays host-Python — callers guarantee cutoffs <= 255)
inline uint32_t table_count(const Tables& T, uint64_t h) {
    uint32_t m = (T.kind == KIND_NIBBLE) ? NIBBLE_MAX : MAX_KCOUNT;
    for (int i = 0; i < T.n_tables; i++) {
        uint64_t bin = h % T.primes[i];
        uint32_t c;
        if (T.kind == KIND_BYTE) {
            c = T.ptr[i][bin];
        } else if (T.kind == KIND_BIT) {
            if (!((T.ptr[i][bin >> 3] >> (bin & 7)) & 1)) return 0;
            c = 1;
        } else {  // nibble: even bin = high nibble
            uint8_t byte = T.ptr[i][bin >> 1];
            c = (bin & 1) ? (byte & 0x0F) : (byte >> 4);
        }
        if (c < m) m = c;
    }
    return m;
}

inline bool graph_has(const Tables& T, uint64_t h) {
    for (int i = 0; i < T.n_tables; i++) {
        uint64_t bin = h % T.primes[i];
        if (T.kind == KIND_BIT) {
            if (!((T.ptr[i][bin >> 3] >> (bin & 7)) & 1)) return false;
        } else if (T.kind == KIND_BYTE) {
            if (!T.ptr[i][bin]) return false;
        } else {
            uint8_t byte = T.ptr[i][bin >> 1];
            if (!((bin & 1) ? (byte & 0x0F) : (byte >> 4))) return false;
        }
    }
    return true;
}

// one add with the reference's exact new/occupied accounting
// (storage.hh:180-198 bit, :570-624 byte; nibble mirrors byte at 15)
struct AddStats {
    uint64_t n_unique = 0;
    uint64_t n_occupied = 0;
    std::vector<uint64_t> saturated;  // byte adds with all tables full
    bool track_saturation = false;
};

inline bool add_kmer(const Tables& T, uint64_t h, AddStats& st) {
    bool is_new = false;
    if (T.kind == KIND_BIT) {
        for (int i = 0; i < T.n_tables; i++) {
            uint64_t bin = h % T.primes[i];
            uint8_t bit = (uint8_t)(1u << (bin & 7));
            uint8_t& byte = T.ptr[i][bin >> 3];
            if (!(byte & bit)) {
                byte |= bit;
                if (i == 0) st.n_occupied++;
                is_new = true;
            }
        }
    } else if (T.kind == KIND_BYTE) {
        int n_full = 0;
        for (int i = 0; i < T.n_tables; i++) {
            uint64_t bin = h % T.primes[i];
            uint8_t cur = T.ptr[i][bin];
            if (!is_new && cur == 0) {
                is_new = true;
                if (i == 0) st.n_occupied++;
            }
            if (cur < MAX_KCOUNT) T.ptr[i][bin] = cur + 1;
            else n_full++;
        }
        if (n_full == T.n_tables && st.track_saturation)
            st.saturated.push_back(h);
    } else {
        for (int i = 0; i < T.n_tables; i++) {
            uint64_t bin = h % T.primes[i];
            uint8_t& byte = T.ptr[i][bin >> 1];
            uint8_t cur = (bin & 1) ? (byte & 0x0F) : (byte >> 4);
            if (!is_new && cur == 0) {
                is_new = true;
                if (i == 0) st.n_occupied++;
            }
            if (cur < NIBBLE_MAX) {
                uint8_t nxt = cur + 1;
                byte = (bin & 1) ? ((byte & 0xF0) | nxt)
                                 : ((byte & 0x0F) | (nxt << 4));
            }
        }
    }
    if (is_new) st.n_unique++;
    return is_new;
}

// ---------------------------------------------------------------------
// 2-bit rolling hash (reference src/oxli/kmer_hash.cc:65-150; codes are
// A=0,T=1,C=2,G=3 as produced by src/fastx_io.cc)
struct Roller {
    uint64_t mask;
    int shift;
    int k;
    explicit Roller(int k_) : k(k_) {
        mask = (k_ >= 32) ? ~0ULL : ((1ULL << (2 * k_)) - 1);
        shift = 2 * k_ - 2;
    }
    inline void seed(const uint8_t* c, uint64_t& f, uint64_t& r) const {
        f = 0; r = 0;
        for (int i = 0; i < k; i++) {
            f = (f << 2) | c[i];
            r |= (uint64_t)(c[i] ^ 1) << (2 * i);
        }
    }
    inline void step(uint8_t c, uint64_t& f, uint64_t& r) const {
        f = ((f << 2) | c) & mask;
        r = (r >> 2) | ((uint64_t)(c ^ 1) << shift);
    }
};

inline uint64_t revcomp_bits(uint64_t f, int k) {
    uint64_t r = 0;
    for (int i = 0; i < k; i++) {
        r = (r << 2) | ((f & 3) ^ 1);
        f >>= 2;
    }
    return r;
}

// ---------------------------------------------------------------------
// open-addressing u64 hash set (tag set / visited set)
struct U64Set {
    std::vector<uint64_t> keys;
    std::vector<uint8_t> used;
    size_t n = 0, cap = 0, mask = 0;

    explicit U64Set(size_t hint = 64) { rehash(next_pow2(hint * 2 + 16)); }

    static size_t next_pow2(size_t x) {
        size_t p = 16;
        while (p < x) p <<= 1;
        return p;
    }
    static inline size_t mix(uint64_t h) {
        h ^= h >> 33; h *= 0xff51afd7ed558ccdULL;
        h ^= h >> 33; h *= 0xc4ceb9fe1a85ec53ULL;
        h ^= h >> 33;
        return (size_t)h;
    }
    void rehash(size_t ncap) {
        std::vector<uint64_t> ok = std::move(keys);
        std::vector<uint8_t> ou = std::move(used);
        keys.assign(ncap, 0);
        used.assign(ncap, 0);
        cap = ncap; mask = ncap - 1;
        size_t on = n; n = 0;
        (void)on;
        for (size_t i = 0; i < ok.size(); i++)
            if (ou[i]) insert(ok[i]);
    }
    inline bool contains(uint64_t v) const {
        size_t i = mix(v) & mask;
        while (used[i]) {
            if (keys[i] == v) return true;
            i = (i + 1) & mask;
        }
        return false;
    }
    // returns true if newly inserted
    inline bool insert(uint64_t v) {
        if ((n + 1) * 10 >= cap * 7) rehash(cap * 2);
        size_t i = mix(v) & mask;
        while (used[i]) {
            if (keys[i] == v) return false;
            i = (i + 1) & mask;
        }
        used[i] = 1; keys[i] = v; n++;
        return true;
    }
    void clear() {
        std::fill(used.begin(), used.end(), 0);
        n = 0;
    }
};

inline bool in_sorted(const uint64_t* a, int64_t n, uint64_t v) {
    return std::binary_search(a, a + n, v);
}

// ---------------------------------------------------------------------
// MurmurHash3 x64_128 (public algorithm; only 64 low bits used, matching
// the reference's smhasher build — reference src/oxli/kmer_hash.cc:168)
inline uint64_t rotl64(uint64_t x, int8_t r) {
    return (x << r) | (x >> (64 - r));
}
inline uint64_t fmix64(uint64_t k) {
    k ^= k >> 33; k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33; k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    return k;
}

uint64_t murmur128_lo(const uint8_t* data, int len) {
    const int nblocks = len / 16;
    uint64_t h1 = 0, h2 = 0;
    const uint64_t c1 = 0x87c37b91114253d5ULL;
    const uint64_t c2 = 0x4cf5ad432745937fULL;
    for (int i = 0; i < nblocks; i++) {
        uint64_t k1, k2;
        std::memcpy(&k1, data + 16 * i, 8);
        std::memcpy(&k2, data + 16 * i + 8, 8);
        k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
        h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
        k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
        h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
    }
    const uint8_t* tail = data + nblocks * 16;
    uint64_t k1 = 0, k2 = 0;
    switch (len & 15) {
        case 15: k2 ^= (uint64_t)tail[14] << 48; [[fallthrough]];
        case 14: k2 ^= (uint64_t)tail[13] << 40; [[fallthrough]];
        case 13: k2 ^= (uint64_t)tail[12] << 32; [[fallthrough]];
        case 12: k2 ^= (uint64_t)tail[11] << 24; [[fallthrough]];
        case 11: k2 ^= (uint64_t)tail[10] << 16; [[fallthrough]];
        case 10: k2 ^= (uint64_t)tail[9] << 8;  [[fallthrough]];
        case 9:  k2 ^= (uint64_t)tail[8];
                 k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
                 [[fallthrough]];
        case 8:  k1 ^= (uint64_t)tail[7] << 56; [[fallthrough]];
        case 7:  k1 ^= (uint64_t)tail[6] << 48; [[fallthrough]];
        case 6:  k1 ^= (uint64_t)tail[5] << 40; [[fallthrough]];
        case 5:  k1 ^= (uint64_t)tail[4] << 32; [[fallthrough]];
        case 4:  k1 ^= (uint64_t)tail[3] << 24; [[fallthrough]];
        case 3:  k1 ^= (uint64_t)tail[2] << 16; [[fallthrough]];
        case 2:  k1 ^= (uint64_t)tail[1] << 8;  [[fallthrough]];
        case 1:  k1 ^= (uint64_t)tail[0];
                 k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    }
    h1 ^= (uint64_t)len; h2 ^= (uint64_t)len;
    h1 += h2; h2 += h1;
    h1 = fmix64(h1); h2 = fmix64(h2);
    h1 += h2;
    return h1;
}

// canonical murmur of a 2-bit-coded window (reference kmer_hash.cc:177-198:
// XOR of forward and revcomp string hashes; self-complement -> forward)
static const char kBase[4] = {'A', 'T', 'C', 'G'};

inline uint64_t murmur_canonical(const uint8_t* codes, int k,
                                 char* fwd, char* rev) {
    bool selfc = true;
    for (int i = 0; i < k; i++) {
        fwd[i] = kBase[codes[i]];
        uint8_t rc = codes[k - 1 - i] ^ 1;
        rev[i] = kBase[rc];
        if (rc != codes[i]) selfc = false;
    }
    uint64_t h = murmur128_lo((const uint8_t*)fwd, k);
    if (selfc) return h;
    return h ^ murmur128_lo((const uint8_t*)rev, k);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// tag set handles
void* hg_set_create(long long hint) {
    return new U64Set((size_t)(hint > 0 ? hint : 64));
}
void hg_set_add(void* s, const uint64_t* v, long long n) {
    U64Set* set = (U64Set*)s;
    for (long long i = 0; i < n; i++) set->insert(v[i]);
}
long long hg_set_size(void* s) { return (long long)((U64Set*)s)->n; }
long long hg_set_export(void* s, uint64_t* out, long long cap) {
    U64Set* set = (U64Set*)s;
    if ((long long)set->n > cap) return -(long long)set->n;
    long long j = 0;
    for (size_t i = 0; i < set->cap; i++)
        if (set->used[i]) out[j++] = set->keys[i];
    return j;
}
void hg_set_clear(void* s) { ((U64Set*)s)->clear(); }
void hg_set_free(void* s) { delete (U64Set*)s; }

// ---------------------------------------------------------------------
// consume a packed block of reads, optionally with tag spacing.
// codes: concatenated 2-bit codes; read i spans starts[i]..ends[i].
// mode: 0 = plain consume (n_consumed = all k-mers),
//       1 = consume+tag   (n_consumed = new k-mers; reference
//           hashgraph.cc:200-271 spacing rules, tagset mutated in place)
// found_tags (may be null): set receiving tags seen/placed (labels path).
// Returns n_consumed; accumulates unique/occupied into the io pointers.
long long hg_consume_block(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    int k, const uint8_t* codes, const int64_t* starts,
    const int64_t* ends, long long n_reads,
    int mode, int density, void* tagset, void* found_tags,
    int track_saturation, uint64_t* sat_out, long long sat_cap,
    long long* sat_n, uint64_t* n_unique_io, uint64_t* n_occupied_io) {
    Tables T{kind, n_tables, tables, primes};
    Roller R(k);
    AddStats st;
    st.track_saturation = track_saturation != 0;
    U64Set* tags = (U64Set*)tagset;
    U64Set* found = (U64Set*)found_tags;
    long long n_consumed = 0;

    for (long long ri = 0; ri < n_reads; ri++) {
        int64_t s = starts[ri], e = ends[ri];
        if (e - s < k) continue;
        uint64_t f, r;
        R.seed(codes + s, f, r);
        int since = density / 2 + 1;
        uint64_t canon = f < r ? f : r;
        int64_t pos = s + k;
        for (;;) {
            bool is_new = add_kmer(T, canon, st);
            if (mode == 0) {
                n_consumed++;
            } else {
                if (is_new) {
                    n_consumed++;
                    since++;
                } else if (tags->contains(canon)) {
                    since = 1;
                    if (found) found->insert(canon);
                } else {
                    since++;
                }
                if (since >= density) {
                    tags->insert(canon);
                    if (found) found->insert(canon);
                    since = 1;
                }
            }
            if (pos >= e) break;
            R.step(codes[pos++], f, r);
            canon = f < r ? f : r;
        }
        if (mode != 0 && since >= density / 2 - 1) {
            tags->insert(canon);
            if (found) found->insert(canon);
        }
    }
    *n_unique_io += st.n_unique;
    *n_occupied_io += st.n_occupied;
    if (st.track_saturation) {
        long long m = (long long)st.saturated.size();
        *sat_n = m;
        if (m > sat_cap) return -1;
        std::memcpy(sat_out, st.saturated.data(), m * sizeof(uint64_t));
    }
    return n_consumed;
}

// murmur-family consume for Counttable/Nodetable/SmallCounttable
// (no tagging; those types have no graph ops)
long long hg_consume_block_murmur(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    int k, const uint8_t* codes, const int64_t* starts,
    const int64_t* ends, long long n_reads,
    int track_saturation, uint64_t* sat_out, long long sat_cap,
    long long* sat_n, uint64_t* n_unique_io, uint64_t* n_occupied_io) {
    Tables T{kind, n_tables, tables, primes};
    AddStats st;
    st.track_saturation = track_saturation != 0;
    long long n_consumed = 0;
    std::vector<char> fwd(k), rev(k);
    for (long long ri = 0; ri < n_reads; ri++) {
        int64_t s = starts[ri], e = ends[ri];
        if (e - s < k) continue;
        for (int64_t i = s; i + k <= e; i++) {
            uint64_t h = murmur_canonical(codes + i, k, fwd.data(),
                                          rev.data());
            add_kmer(T, h, st);
            n_consumed++;
        }
    }
    *n_unique_io += st.n_unique;
    *n_occupied_io += st.n_occupied;
    if (st.track_saturation) {
        long long m = (long long)st.saturated.size();
        *sat_n = m;
        if (m > sat_cap) return -1;
        std::memcpy(sat_out, st.saturated.data(), m * sizeof(uint64_t));
    }
    return n_consumed;
}

// ---------------------------------------------------------------------
// digital normalization over bundles (reference Normalizer,
// scripts/normalize-by-median.py:155-179 + hashtable.cc:333-364):
// keep bundle unless EVERY read has median count >= cutoff; kept reads
// are consumed immediately (stream order — decisions feed back).
// bundle_offsets[j]..bundle_offsets[j+1] index into the reads arrays.
long long hg_diginorm(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    int k, const uint8_t* codes, const int64_t* starts,
    const int64_t* ends, const int64_t* bundle_offsets, long long n_bundles, int cutoff,
    uint8_t* keep_out, uint64_t* n_unique_io, uint64_t* n_occupied_io) {
    Tables T{kind, n_tables, tables, primes};
    Roller R(k);
    AddStats st;
    long long kept_reads = 0;
    std::vector<uint64_t> hbuf;

    for (long long b = 0; b < n_bundles; b++) {
        bool all_at_least = true;
        for (int64_t ri = bundle_offsets[b]; ri < bundle_offsets[b + 1];
             ri++) {
            int64_t s = starts[ri], e = ends[ri];
            int64_t n_kmers = e - s - k + 1;
            if (n_kmers < 1) continue;  // absent/short reads pass
            // median_at_least (hashtable.cc:333): >= half the k-mers at
            // cutoff.  The scan is read-only, so early exit at min_req
            // hits is output-identical to the reference's 2-phase loop.
            unsigned min_req =
                (unsigned)(0.5f + (float)n_kmers / 2.0f);
            unsigned hits = 0;
            uint64_t f, r;
            R.seed(codes + s, f, r);
            uint64_t canon = f < r ? f : r;
            int64_t pos = s + k;
            bool at_least = false;
            for (;;) {
                if (table_count(T, canon) >= (uint32_t)cutoff) {
                    if (++hits >= min_req) { at_least = true; break; }
                }
                if (pos >= e) break;
                R.step(codes[pos++], f, r);
                canon = f < r ? f : r;
            }
            if (!at_least) { all_at_least = false; break; }
        }
        if (all_at_least) { keep_out[b] = 0; continue; }
        keep_out[b] = 1;
        for (int64_t ri = bundle_offsets[b]; ri < bundle_offsets[b + 1];
             ri++) {
            int64_t s = starts[ri], e = ends[ri];
            if (e - s < k) { kept_reads++; continue; }
            uint64_t f, r;
            R.seed(codes + s, f, r);
            uint64_t canon = f < r ? f : r;
            int64_t pos = s + k;
            for (;;) {
                add_kmer(T, canon, st);
                if (pos >= e) break;
                R.step(codes[pos++], f, r);
                canon = f < r ? f : r;
            }
            kept_reads++;
        }
    }
    *n_unique_io += st.n_unique;
    *n_occupied_io += st.n_occupied;
    return kept_reads;
}

// ---------------------------------------------------------------------
// trim-low-abund pass 1 (reference scripts/trim-low-abund.py:190-238)
// branch per bundle: 0 = drop (--diginorm & coverage >= digi_cov),
// 1 = trim now (coverage >= trim_cov), 2 = consume + defer to pass 2.
// trim_at per read: reference Hashtable::trim_on_abundance
// (hashtable.cc:504-533).
long long hg_trim1(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    int k, const uint8_t* codes, const int64_t* starts,
    const int64_t* ends, const int64_t* bundle_offsets, long long n_bundles,
    int cutoff, int trim_cov, int digi_cov /* <0: disabled */,
    int32_t* branch_out, int32_t* trim_at_out,
    uint64_t* n_unique_io, uint64_t* n_occupied_io) {
    Tables T{kind, n_tables, tables, primes};
    Roller R(k);
    AddStats st;

    for (long long b = 0; b < n_bundles; b++) {
        // gather per-read counts once; reads are short on this path
        int64_t r0 = bundle_offsets[b], r1 = bundle_offsets[b + 1];
        bool ge_trim = true, ge_digi = true;
        for (int64_t ri = r0; ri < r1; ri++) {
            int64_t s = starts[ri], e = ends[ri];
            int64_t n_kmers = e - s - k + 1;
            if (n_kmers < 1) continue;
            unsigned min_req = (unsigned)(0.5f + (float)n_kmers / 2.0f);
            unsigned hits_t = 0, hits_d = 0;
            uint64_t f, r;
            R.seed(codes + s, f, r);
            uint64_t canon = f < r ? f : r;
            int64_t pos = s + k;
            for (;;) {
                uint32_t c = table_count(T, canon);
                if (c >= (uint32_t)trim_cov) hits_t++;
                if (digi_cov >= 0 && c >= (uint32_t)digi_cov) hits_d++;
                if (pos >= e) break;
                R.step(codes[pos++], f, r);
                canon = f < r ? f : r;
            }
            if (hits_t < min_req) ge_trim = false;
            if (hits_d < min_req) ge_digi = false;
        }
        int32_t branch = (digi_cov >= 0 && ge_digi) ? 0
                         : (ge_trim ? 1 : 2);
        branch_out[b] = branch;
        // trim positions come from the PRE-consume counts for every
        // read of the bundle (the device engine gathers once per
        // bundle), so compute them all before any branch-2 consume
        for (int64_t ri = r0; ri < r1; ri++) {
            int64_t s = starts[ri], e = ends[ri];
            int64_t seqlen = e - s;
            if (seqlen < k) { trim_at_out[ri] = 0; continue; }
            uint64_t f, r;
            R.seed(codes + s, f, r);
            uint64_t canon = f < r ? f : r;
            // trim_on_abundance (hashtable.cc:504-533)
            if (table_count(T, canon) < (uint32_t)cutoff) {
                trim_at_out[ri] = 0;
                continue;
            }
            int64_t pos = s + k;
            if (pos >= e) { trim_at_out[ri] = 0; continue; }
            int32_t at = (int32_t)seqlen;
            long i = k;
            while (pos < e) {
                R.step(codes[pos++], f, r);
                canon = f < r ? f : r;
                if (table_count(T, canon) < (uint32_t)cutoff) {
                    at = (int32_t)i;
                    break;
                }
                i++;
            }
            trim_at_out[ri] = at;
        }
        if (branch == 2) {
            for (int64_t ri = r0; ri < r1; ri++) {
                int64_t s = starts[ri], e = ends[ri];
                if (e - s < k) continue;
                uint64_t f, r;
                R.seed(codes + s, f, r);
                uint64_t canon = f < r ? f : r;
                int64_t pos = s + k;
                for (;;) {
                    add_kmer(T, canon, st);
                    if (pos >= e) break;
                    R.step(codes[pos++], f, r);
                    canon = f < r ? f : r;
                }
            }
        }
    }
    *n_unique_io += st.n_unique;
    *n_occupied_io += st.n_occupied;
    return 0;
}

// read-only trim positions for filter-abund-style passes.
// variable_coverage: only trim reads whose median >= normalize_to.
void hg_trim_filter(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    int k, const uint8_t* codes, const int64_t* starts,
    const int64_t* ends, long long n_reads,
    int cutoff, int variable_coverage, int normalize_to,
    int32_t* trim_at_out) {
    Tables T{kind, n_tables, tables, primes};
    Roller R(k);
    for (long long ri = 0; ri < n_reads; ri++) {
        int64_t s = starts[ri], e = ends[ri];
        int64_t seqlen = e - s;
        if (seqlen < k) { trim_at_out[ri] = -1; continue; }
        uint64_t f, r;
        R.seed(codes + s, f, r);
        uint64_t canon = f < r ? f : r;
        if (variable_coverage) {
            // median_at_least(normalize_to)
            int64_t n_kmers = seqlen - k + 1;
            unsigned min_req = (unsigned)(0.5f + (float)n_kmers / 2.0f);
            unsigned hits = 0;
            uint64_t f2 = f, r2 = r, c2 = canon;
            int64_t pos = s + k;
            for (;;) {
                if (table_count(T, c2) >= (uint32_t)normalize_to) hits++;
                if (pos >= e) break;
                R.step(codes[pos++], f2, r2);
                c2 = f2 < r2 ? f2 : r2;
            }
            if (hits < min_req) { trim_at_out[ri] = (int32_t)seqlen;
                                  continue; }
        }
        if (table_count(T, canon) < (uint32_t)cutoff) {
            trim_at_out[ri] = 0;
            continue;
        }
        int64_t pos = s + k;
        int32_t at = (int32_t)seqlen;
        long i = k;
        while (pos < e) {
            R.step(codes[pos++], f, r);
            canon = f < r ? f : r;
            if (table_count(T, canon) < (uint32_t)cutoff) {
                at = (int32_t)i;
                break;
            }
            i++;
        }
        trim_at_out[ri] = at;
    }
}

// ---------------------------------------------------------------------
// HLL ingestion (reference src/oxli/hllcounter.cc:250-310): canonical
// murmur per window, register index from the low p bits, value =
// clz(hash >> p) - p + 1 (64 - p + 1 when the shifted hash is zero).
long long hg_hll_consume(
    int k, int p, uint8_t* registers, const uint8_t* codes,
    const int64_t* starts, const int64_t* ends, long long n_reads) {
    long long n_consumed = 0;
    std::vector<char> fwd(k), rev(k);
    uint64_t idx_mask = (1ULL << p) - 1;
    for (long long ri = 0; ri < n_reads; ri++) {
        int64_t s = starts[ri], e = ends[ri];
        if (e - s < k) continue;
        for (int64_t i = s; i + k <= e; i++) {
            uint64_t h = murmur_canonical(codes + i, k, fwd.data(),
                                          rev.data());
            uint64_t index = h & idx_mask;
            uint64_t rest = h >> p;
            int v = rest ? __builtin_clzll(rest) : 64;
            v = v - p + 1;
            if ((uint8_t)v > registers[index])
                registers[index] = (uint8_t)v;
            n_consumed++;
        }
    }
    return n_consumed;
}

// ---------------------------------------------------------------------
// partition BFS: find_all_tags for a range of start tags (reference
// SubsetPartition::find_all_tags, src/oxli/subset.cc:213-300, with the
// truncate-on-abundance variant of subset.cc:399-496).  The graph is
// read-only during partitioning, so start tags fan out over threads;
// the union-find joins stay in Python (khmer_tpu/core/partition.py)
// where the reference's pointer-aliasing ID assignment is mirrored.
namespace {

struct BfsScratch {
    U64Set visited;
    std::vector<uint64_t> qf, qr;
    std::vector<uint32_t> qb;
};

void find_all_tags_one(
    const Tables& T, const Tables* CT, int k,
    const uint64_t* tags, int64_t n_tags,
    const uint64_t* stops, int64_t n_stops,
    bool break_on_stop, bool stop_big,
    uint32_t max_breadth,
    bool use_range, uint32_t cmin, uint32_t cmax,
    uint64_t start, BfsScratch& S, std::vector<uint64_t>& out) {
    S.visited.clear();
    S.qf.clear(); S.qr.clear(); S.qb.clear();
    uint64_t f0 = start, r0 = revcomp_bits(start, k);
    S.qf.push_back(f0); S.qr.push_back(r0); S.qb.push_back(0);
    size_t head = 0;
    bool first = true;
    uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    int shift = 2 * k - 2;

    while (head < S.qf.size()) {
        if (stop_big && S.visited.n > BIG_TRAVERSALS_ARE) {
            out.clear();
            return;
        }
        uint64_t f = S.qf[head], r = S.qr[head];
        uint32_t b = S.qb[head];
        head++;
        uint64_t canon = f < r ? f : r;
        if (S.visited.contains(canon)) continue;
        if (break_on_stop && in_sorted(stops, n_stops, canon)) continue;
        if (use_range) {
            uint32_t c = table_count(*CT, canon);
            if (c < cmin || c > cmax) continue;
        }
        S.visited.insert(canon);
        if (!first && in_sorted(tags, n_tags, canon)) {
            out.push_back(canon);
            continue;
        }
        if (b >= max_breadth) continue;
        // push order matches the reference traverser: right then left,
        // bases in "ACGT" = 2-bit codes {0,2,3,1}
        // (src/oxli/traversal.cc:122, alphabets.cc:45)
        static const uint8_t kOrder[4] = {0, 2, 3, 1};
        for (int d = 0; d < 2; d++) {
            for (int bi = 0; bi < 4; bi++) {
                uint64_t c2 = kOrder[bi];
                uint64_t nf, nr;
                if (d == 0) {
                    nf = ((f << 2) | c2) & mask;
                    nr = (r >> 2) | ((c2 ^ 1) << shift);
                } else {
                    nf = (f >> 2) | (c2 << shift);
                    nr = ((r << 2) | (c2 ^ 1)) & mask;
                }
                uint64_t nc = nf < nr ? nf : nr;
                if (graph_has(T, nc) && !S.visited.contains(nc)) {
                    S.qf.push_back(nf);
                    S.qr.push_back(nr);
                    S.qb.push_back(b + 1);
                }
            }
        }
        first = false;
    }
    std::sort(out.begin(), out.end());
}

}  // namespace

// Abundance histogram with tracking-table dedup (reference
// Hashtable::abundance_distribution, hashtable.cc:451-502): per k-mer
// in stream order, if the tracking table says unseen, track it and
// histogram the main count.  dist has MAX_BIGCOUNT+1 (65536) slots;
// first-seen k-mers whose clamped count is 255 also land in sat_out
// (unique, order of first encounter) so host Python can re-bin them
// with the bigcount map.  Returns n sat (or -1 if sat_cap too small).
long long hg_abund_dist(
    int main_kind, uint8_t** main_tables, const uint64_t* main_primes,
    int main_n_tables,
    int track_kind, uint8_t** track_tables,
    const uint64_t* track_primes, int track_n_tables,
    int k, const uint8_t* codes, const int64_t* starts,
    const int64_t* ends, long long n_reads,
    uint64_t* dist, uint64_t* sat_out, long long sat_cap) {
    Tables M{main_kind, main_n_tables, main_tables, main_primes};
    Tables TR{track_kind, track_n_tables, track_tables, track_primes};
    Roller R(k);
    AddStats st;
    long long n_sat = 0;

    for (long long ri = 0; ri < n_reads; ri++) {
        int64_t s = starts[ri], e = ends[ri];
        if (e - s < k) continue;
        uint64_t f, r;
        R.seed(codes + s, f, r);
        uint64_t canon = f < r ? f : r;
        int64_t pos = s + k;
        for (;;) {
            if (table_count(TR, canon) == 0) {
                add_kmer(TR, canon, st);
                uint32_t c = table_count(M, canon);
                dist[c]++;
                if (c == MAX_KCOUNT) {
                    if (n_sat >= sat_cap) return -1;
                    sat_out[n_sat++] = canon;
                }
            }
            if (pos >= e) break;
            R.step(codes[pos++], f, r);
            canon = f < r ? f : r;
        }
    }
    return n_sat;
}

// Min-over-tables counts for pre-hashed canonical k-mers (reference
// storage.hh get_count semantics for each kind).
void hg_get_counts(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    const uint64_t* hashes, long long n, uint32_t* out) {
    Tables T{kind, n_tables, tables, primes};
    for (long long i = 0; i < n; i++) out[i] = table_count(T, hashes[i]);
}

// Commit an array of pre-hashed canonical k-mers (one sequential add
// each, reference Storage::add semantics).  Returns n_new.
long long hg_add_hashes(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    const uint64_t* hashes, long long n,
    uint64_t* n_unique_io, uint64_t* n_occupied_io,
    int track_saturation, uint64_t* sat_out, long long sat_cap,
    long long* sat_n) {
    Tables T{kind, n_tables, tables, primes};
    AddStats st;
    st.track_saturation = track_saturation != 0;
    long long n_new = 0;
    for (long long i = 0; i < n; i++)
        if (add_kmer(T, hashes[i], st)) n_new++;
    *n_unique_io += st.n_unique;
    *n_occupied_io += st.n_occupied;
    if (st.track_saturation) {
        long long m = (long long)st.saturated.size();
        *sat_n = m;
        if (m > sat_cap) return -1;
        std::memcpy(sat_out, st.saturated.data(), m * sizeof(uint64_t));
    }
    return n_new;
}

// Perimeter sweep (reference SubsetPartition::sweep_for_tags,
// subset.cc:305-394): every window of the query sequence seeds the
// queue at breadth 0 (and pre-marks traversed), then BFS collects
// nearby tags within `range`.  Control flow mirrors the Python engine
// in core/partition.py:sweep_for_tags, including the stop-big check
// once per PROBED node and the early return past max_breadth.
// Returns n tagged (sorted into out_tags), or -(needed) if cap small;
// *total_out = nodes processed.
long long hg_sweep_for_tags(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    int k, const uint8_t* codes, long long seq_len,
    long long max_breadth, int break_on_stop, int stop_big,
    const uint64_t* tags_sorted, int64_t n_tags,
    const uint64_t* stops_sorted, int64_t n_stops,
    uint64_t* out_tags, long long out_cap, long long* total_out) {
    Tables T{kind, n_tables, tables, primes};
    Roller R(k);
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int shift = 2 * k - 2;
    static const uint8_t kOrder[4] = {0, 2, 3, 1};

    U64Set traversed(256);
    std::vector<uint64_t> tagged;
    std::vector<uint64_t> qf, qr;
    std::vector<int64_t> qb;
    if (seq_len >= k) {
        uint64_t f, r;
        R.seed(codes, f, r);
        for (long long i = 0;;) {
            traversed.insert(f < r ? f : r);
            qf.push_back(f); qr.push_back(r); qb.push_back(0);
            if (++i > seq_len - k) break;
            R.step(codes[i + k - 1], f, r);
        }
    }
    long long big_perimeter =
        BIG_TRAVERSALS_ARE * ((long long)qf.size() / 2);
    long long total = 0;
    size_t head = 0;
    bool early_return = false;

    for (;;) {
        if (stop_big && (long long)traversed.n > big_perimeter) {
            tagged.clear();
            break;
        }
        // walk until a node needs a probe
        bool have = false;
        uint64_t f = 0, r = 0;
        int64_t b = 0;
        while (head < qf.size()) {
            f = qf[head]; r = qr[head]; b = qb[head];
            uint64_t c = f < r ? f : r;
            if (break_on_stop && in_sorted(stops_sorted, n_stops, c)) {
                head++;
                continue;
            }
            traversed.insert(c);
            total++;
            if (in_sorted(tags_sorted, n_tags, c)) {
                tagged.push_back(c);
                head++;
                continue;
            }
            if (b == max_breadth) {
                head++;
                continue;
            }
            if (b > max_breadth) {
                early_return = true;
                break;
            }
            head++;
            have = true;
            break;
        }
        if (early_return || !have) break;
        for (int d = 0; d < 2; d++) {
            for (int bi = 0; bi < 4; bi++) {
                uint64_t c2 = kOrder[bi];
                uint64_t nf, nr;
                if (d == 0) {
                    nf = ((f << 2) | c2) & mask;
                    nr = (r >> 2) | ((c2 ^ 1) << shift);
                } else {
                    nf = (f >> 2) | (c2 << shift);
                    nr = ((r << 2) | (c2 ^ 1)) & mask;
                }
                uint64_t nc = nf < nr ? nf : nr;
                if (graph_has(T, nc) && !traversed.contains(nc)) {
                    qf.push_back(nf);
                    qr.push_back(nr);
                    qb.push_back(b + 1);
                }
            }
        }
    }
    *total_out = total;
    std::sort(tagged.begin(), tagged.end());
    tagged.erase(std::unique(tagged.begin(), tagged.end()),
                 tagged.end());
    if ((long long)tagged.size() > out_cap)
        return -(long long)tagged.size();
    std::memcpy(out_tags, tagged.data(),
                tagged.size() * sizeof(uint64_t));
    return (long long)tagged.size();
}

// Bounded-radius BFS (reference Hashgraph::traverse_from_kmer,
// hashgraph.cc:503-570) with the optional early-exit `threshold` of
// calc_connected_graph_size (hashgraph.cc:420-471).  Visited canonical
// hashes land in out_keeper; returns the count, or -(needed) when
// out_cap is too small.
long long hg_traverse_from_kmer(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    int k, uint64_t start, long long radius, long long max_count,
    long long threshold,
    const uint64_t* stops_sorted, int64_t n_stops,
    uint64_t* out_keeper, long long out_cap) {
    Tables T{kind, n_tables, tables, primes};
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int shift = 2 * k - 2;
    static const uint8_t kOrder[4] = {0, 2, 3, 1};

    U64Set keeper(256);
    std::vector<uint64_t> qf, qr;
    std::vector<int64_t> qb;
    qf.push_back(start);
    qr.push_back(revcomp_bits(start, k));
    qb.push_back(0);
    size_t head = 0;
    long long total = 0;

    while (head < qf.size()) {
        uint64_t f = qf[head], r = qr[head];
        int64_t b = qb[head];
        head++;
        if (radius >= 0 && b > radius) break;
        if (max_count && total > max_count) break;
        uint64_t canon = f < r ? f : r;
        if (keeper.contains(canon)) continue;
        if (in_sorted(stops_sorted, n_stops, canon)) continue;
        keeper.insert(canon);
        total++;
        if (threshold && total >= threshold) break;
        for (int d = 0; d < 2; d++) {
            for (int bi = 0; bi < 4; bi++) {
                uint64_t c2 = kOrder[bi];
                uint64_t nf, nr;
                if (d == 0) {
                    nf = ((f << 2) | c2) & mask;
                    nr = (r >> 2) | ((c2 ^ 1) << shift);
                } else {
                    nf = (f >> 2) | (c2 << shift);
                    nr = ((r << 2) | (c2 ^ 1)) & mask;
                }
                uint64_t nc = nf < nr ? nf : nr;
                if (graph_has(T, nc) && !keeper.contains(nc)) {
                    qf.push_back(nf);
                    qr.push_back(nr);
                    qb.push_back(b + 1);
                }
            }
        }
    }
    if ((long long)keeper.n > out_cap) return -(long long)keeper.n;
    long long j = 0;
    for (size_t i = 0; i < keeper.cap; i++)
        if (keeper.used[i]) out_keeper[j++] = keeper.keys[i];
    return total;
}

// Returns total tags written, or -(needed) when out_cap is too small.
// out_offsets has n_starts+1 entries.
long long hg_find_all_tags_range(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    int count_kind, uint8_t** count_tables, const uint64_t* count_primes,
    int count_n_tables,
    int k, const uint64_t* tags_sorted, int64_t n_tags,
    const uint64_t* stops_sorted, int64_t n_stops,
    const uint64_t* starts, long long n_starts,
    int break_on_stop, int stop_big, int tag_density,
    int use_range, int cmin, int cmax, int n_threads,
    uint64_t* out_tags, long long out_cap, int64_t* out_offsets) {
    Tables T{kind, n_tables, tables, primes};
    Tables CT{count_kind, count_n_tables, count_tables, count_primes};
    uint32_t max_breadth = 2 * (uint32_t)tag_density + 1;

    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    std::vector<std::vector<std::vector<uint64_t>>> results(n_threads);
    std::atomic<long long> next{0};
    const long long CHUNK = 64;

    auto work = [&](int t) {
        BfsScratch S;
        results[t].resize(n_starts);
        std::vector<uint64_t> out;
        for (;;) {
            long long lo = next.fetch_add(CHUNK);
            if (lo >= n_starts) break;
            long long hi = std::min(lo + CHUNK, (long long)n_starts);
            for (long long i = lo; i < hi; i++) {
                out.clear();
                find_all_tags_one(T, use_range ? &CT : nullptr, k,
                                  tags_sorted, n_tags, stops_sorted,
                                  n_stops, break_on_stop != 0,
                                  stop_big != 0, max_breadth,
                                  use_range != 0, (uint32_t)cmin,
                                  (uint32_t)cmax, starts[i], S, out);
                results[t][i] = out;
            }
        }
    };
    if (n_threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; t++) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }

    long long total = 0;
    for (long long i = 0; i < n_starts; i++)
        for (int t = 0; t < n_threads; t++)
            total += (long long)results[t][i].size();
    if (total > out_cap) return -total;
    long long pos = 0;
    for (long long i = 0; i < n_starts; i++) {
        out_offsets[i] = pos;
        for (int t = 0; t < n_threads; t++) {
            if (!results[t][i].empty()) {
                std::memcpy(out_tags + pos, results[t][i].data(),
                            results[t][i].size() * sizeof(uint64_t));
                pos += (long long)results[t][i].size();
            }
        }
    }
    out_offsets[n_starts] = pos;
    return pos;
}

// ---------------------------------------------------------------------
// graph-guided HMM read alignment: the A* sub-search of the reference
// ReadAligner (src/oxli/read_aligner.cc:60-257), one node expansion at
// a time against the host table mirror.  Scores, tie-breaking (FIFO on
// equal f-scores) and the closed-set-by-f-score quirk replicate the
// Python engine in khmer_tpu/core/aligner.py bit for bit — Python
// passes its own transition constants in, and both sides accumulate
// doubles in the same order.
}  // extern "C"

namespace {

constexpr int A_MATCH = 0, A_INS_READ = 1, A_INS_GRAPH = 2;
constexpr int A_MATCH_U = 3, A_INS_READ_U = 4, A_INS_GRAPH_U = 5;
constexpr int A_DISALLOWED = 28;

struct ANode {
    int prev;
    int seq_idx;
    int length;
    int num_indels;
    uint64_t fwd, rc;
    double score, f_score;
    uint16_t cov;
    uint8_t base, state, trusted;
};

struct HeapEnt {
    double f;
    long long counter;
    int node;
};
struct HeapLess {
    bool operator()(const HeapEnt& a, const HeapEnt& b) const {
        if (a.f != b.f) return a.f < b.f;         // pop max f first
        return a.counter > b.counter;             // ties: FIFO
    }
};

struct AlignScratch {
    std::vector<ANode> arena;
    std::priority_queue<HeapEnt, std::vector<HeapEnt>, HeapLess> heap;
    std::map<double, std::pair<double, int>> closed;
};

inline double a_null(int length) {
    return std::log2(0.25) * length + std::log2(1.0 / (length + 1));
}

}  // namespace

extern "C" {

// Runs one sub-alignment.  trans6x6: 36 int8 transition codes
// (state,state)->tsc index or 28=disallowed.  tsc: 29 doubles.
// scoring: [trusted_match, trusted_mismatch, untrusted_match,
// untrusted_mismatch].  seq_codes: 2-bit codes of the read.
// Path out (best -> root, root excluded): state/base/seq_idx/trusted/
// cov arrays of capacity path_cap.  Returns path length (>=0), or -1
// if path_cap too small.  best_score/truncated via pointers.
long long hg_subalign(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    int k, int trusted_cutoff, double bits_theta,
    const double* tsc, const double* scoring, const int8_t* trans6x6,
    const uint8_t* seq_codes, long long seq_len,
    uint64_t start_f, uint64_t start_r, long long start_seq_idx,
    double start_score, int forward,
    uint8_t* out_state, uint8_t* out_base, int32_t* out_seq_idx,
    uint8_t* out_trusted, uint16_t* out_cov, long long path_cap,
    double* best_score, int* truncated_out) {
    Tables T{kind, n_tables, tables, primes};
    const double trusted_match = scoring[0];
    const double trusted_mismatch = scoring[1];
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int shift = 2 * k - 2;
    static const uint8_t kCode[4] = {0, 2, 3, 1};  // ACGT -> 2-bit

    AlignScratch S;
    S.arena.reserve(1024);
    ANode root{};
    root.prev = -1;
    root.seq_idx = (int)start_seq_idx;
    root.length = k;
    root.fwd = start_f;
    root.rc = start_r;
    root.score = start_score;
    root.f_score = 0.0;
    root.state = A_MATCH;
    S.arena.push_back(root);
    S.heap.push({0.0, 0, 0});
    long long counter = 0;
    int best = -1;

    const double mm_step = tsc[0] /*MM*/ + trusted_match;

    while (!S.heap.empty()) {
        HeapEnt top = S.heap.top();
        S.heap.pop();
        int ci = top.node;
        double c_score = S.arena[ci].score;
        int c_len = S.arena[ci].length;
        int c_seq = S.arena[ci].seq_idx;

        if (best < 0 ||
            S.arena[best].score - a_null(S.arena[best].length) <
                c_score - a_null(c_len)) {
            best = ci;
        }
        if (c_seq == (int)seq_len - 1 || c_seq == 0) {
            best = ci;
            break;
        }

        double key = S.arena[ci].f_score;
        auto it = S.closed.find(key);
        int times_closed = 0;
        if (it != S.closed.end()) {
            if (it->second.first >= c_score) {
                times_closed = it->second.second;
                S.closed.erase(it);
            } else {
                continue;
            }
        }
        if (times_closed > 200) continue;
        S.closed[key] = {c_score, times_closed + 1};

        // ---- enumerate neighbors ---------------------------------
        int next_seq_idx, remaining;
        if (forward) {
            next_seq_idx = c_seq + 1;
            if (next_seq_idx >= (int)seq_len) continue;
            remaining = (int)seq_len - next_seq_idx;
        } else {
            next_seq_idx = c_seq - 1;
            remaining = next_seq_idx;
        }
        uint64_t cf = S.arena[ci].fwd, cr = S.arena[ci].rc;
        uint8_t c_state = S.arena[ci].state;
        int c_indels = S.arena[ci].num_indels;

        for (int i = 0; i < 4; i++) {
            uint64_t code = kCode[i];
            uint64_t nf, nr;
            if (forward) {
                nf = ((cf << 2) | code) & mask;
                nr = (cr >> 2) | ((code ^ 1) << shift);
            } else {
                nf = (cf >> 2) | (code << shift);
                nr = ((cr << 2) | (code ^ 1)) & mask;
            }
            uint32_t cov = table_count(T, nf < nr ? nf : nr);
            if (cov == 0) continue;
            int s0 = (cov < (uint32_t)trusted_cutoff) ? A_MATCH_U
                                                      : A_MATCH;
            int s1 = (cov < (uint32_t)trusted_cutoff) ? A_INS_GRAPH_U
                                                      : A_INS_GRAPH;
            for (int ns = s0; ns <= s1; ns++) {
                int trans = trans6x6[c_state * 6 + ns];
                double hcost = tsc[trans6x6[ns * 6 + A_MATCH]] +
                    mm_step * (remaining == 0 ? 0 : remaining - 1);
                if (trans == A_DISALLOWED) continue;

                double sc;
                if (ns == A_MATCH || ns == A_MATCH_U) {
                    sc = (code == seq_codes[next_seq_idx])
                             ? trusted_match : trusted_mismatch;
                } else {
                    sc = 0.0;  // BACKGROUND_PROB
                }

                ANode n{};
                n.prev = ci;
                n.base = (uint8_t)i;
                if (ns == A_MATCH || ns == A_MATCH_U) {
                    n.seq_idx = next_seq_idx;
                    n.fwd = nf; n.rc = nr;
                    n.length = c_len + 1;
                    n.num_indels = c_indels;
                } else if (ns == A_INS_READ || ns == A_INS_READ_U) {
                    n.seq_idx = next_seq_idx;
                    n.fwd = cf; n.rc = cr;
                    n.length = c_len + 1;
                    n.num_indels = c_indels + 1;
                } else {
                    n.seq_idx = c_seq;
                    n.fwd = nf; n.rc = nr;
                    n.length = c_len;
                    n.num_indels = c_indels + 1;
                }
                n.state = (uint8_t)ns;
                n.score = c_score + sc + tsc[trans];
                n.trusted = cov >= (uint32_t)trusted_cutoff;
                n.cov = (uint16_t)cov;
                n.f_score = n.score + hcost;

                if (n.num_indels < 3 &&
                    n.score - a_null(n.length) >
                        n.length * bits_theta) {
                    counter++;
                    S.arena.push_back(n);
                    S.heap.push({n.f_score, counter,
                                 (int)S.arena.size() - 1});
                }
            }
        }
    }

    if (best < 0) {
        *best_score = 0.0;
        *truncated_out = 1;
        return 0;
    }
    *best_score = S.arena[best].score;
    int bseq = S.arena[best].seq_idx;
    *truncated_out = (bseq != 0 && bseq != (int)seq_len - 1) ? 1 : 0;
    long long nsteps = 0;
    for (int ni = best; ni >= 0 && S.arena[ni].prev >= 0;
         ni = S.arena[ni].prev) {
        if (nsteps >= path_cap) return -1;
        const ANode& nd = S.arena[ni];
        out_state[nsteps] = nd.state;
        out_base[nsteps] = nd.base;
        out_seq_idx[nsteps] = nd.seq_idx;
        out_trusted[nsteps] = nd.trusted;
        out_cov[nsteps] = nd.cov;
        nsteps++;
    }
    return nsteps;
}

// ---------------------------------------------------------------------
// per-read median/average/stddev (reference hashtable.cc:299-328) for
// count-median and coverage-slicing paths.
void hg_median_counts(
    int kind, uint8_t** tables, const uint64_t* primes, int n_tables,
    int k, const uint8_t* codes, const int64_t* starts,
    const int64_t* ends, long long n_reads,
    int32_t* median_out, float* avg_out, float* std_out) {
    Tables T{kind, n_tables, tables, primes};
    Roller R(k);
    std::vector<uint32_t> counts;
    for (long long ri = 0; ri < n_reads; ri++) {
        int64_t s = starts[ri], e = ends[ri];
        if (e - s < k) {
            median_out[ri] = -1;
            avg_out[ri] = 0; std_out[ri] = 0;
            continue;
        }
        counts.clear();
        uint64_t f, r;
        R.seed(codes + s, f, r);
        uint64_t canon = f < r ? f : r;
        int64_t pos = s + k;
        for (;;) {
            counts.push_back(table_count(T, canon));
            if (pos >= e) break;
            R.step(codes[pos++], f, r);
            canon = f < r ? f : r;
        }
        // float32 accumulation like the reference (hashtable.cc:299-328)
        // so printed digits match bit for bit
        float avg = 0;
        for (uint32_t c : counts) avg += (float)c;
        avg /= (float)counts.size();
        float var = 0;
        for (uint32_t c : counts)
            var += ((float)c - avg) * ((float)c - avg);
        var /= (float)counts.size();
        std::sort(counts.begin(), counts.end());
        median_out[ri] = (int32_t)counts[counts.size() / 2];
        avg_out[ri] = avg;
        std_out[ri] = std::sqrt(var);
    }
}

// ---------------------------------------------------------------------
// Dense canonical window hashes of a flat packed chunk (family 0 =
// 2-bit rolling, 1 = murmur; reference src/oxli/kmer_hash.cc:65-208).
// `starts` are the ascending read-start offsets within `codes` (pad
// entries >= nfill are ignored); windows never span a read boundary.
// Feeds the device tier's dense consume path: every emitted hash is a
// real k-mer, so the device-side row ops pay zero padding tax.  Writes
// hashes in stream order; returns the count.
long long hg_hash_dense(
    const uint8_t* codes, long long nfill,
    const int32_t* starts, long long nstarts,
    int k, int family, uint64_t* out) {
    long long w = 0;
    Roller R(k);
    char fwd[64], rev[64];
    long long si = 0;
    long long seg = 0;
    while (seg < nfill) {
        while (si < nstarts && (long long)starts[si] <= seg) si++;
        long long end = (si < nstarts && (long long)starts[si] < nfill)
                            ? (long long)starts[si]
                            : nfill;
        if (end - seg >= k) {
            if (family == 0) {
                uint64_t f, r;
                R.seed(codes + seg, f, r);
                out[w++] = f < r ? f : r;
                for (long long i = seg + k; i < end; i++) {
                    R.step(codes[i], f, r);
                    out[w++] = f < r ? f : r;
                }
            } else {
                for (long long i = seg; i + k <= end; i++)
                    out[w++] = murmur_canonical(codes + i, k, fwd, rev);
            }
        }
        seg = end;
    }
    return w;
}

// Same contract, over a native-parser block: one C call hashes every
// read of a pack_blocks() batch (offs/lens rows of the block meta), so
// the host side of the dense pipeline has no per-read Python cost.
long long hg_hash_dense_reads(
    const uint8_t* codes, const int64_t* offs, const int64_t* lens,
    long long n_reads, int k, int family, uint64_t* out) {
    long long w = 0;
    Roller R(k);
    char fwd[64], rev[64];
    for (long long ri = 0; ri < n_reads; ri++) {
        const uint8_t* c = codes + offs[ri];
        long long len = lens[ri];
        if (len < k) continue;
        if (family == 0) {
            uint64_t f, r;
            R.seed(c, f, r);
            out[w++] = f < r ? f : r;
            for (long long i = k; i < len; i++) {
                R.step(c[i], f, r);
                out[w++] = f < r ? f : r;
            }
        } else {
            for (long long i = 0; i + k <= len; i++)
                out[w++] = murmur_canonical(c + i, k, fwd, rev);
        }
    }
    return w;
}

}  // extern "C"
