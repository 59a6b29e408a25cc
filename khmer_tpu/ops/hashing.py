"""K-mer hashing ops: 2-bit reversible rolling hash + MurmurHash3_x64_128.

Batched design: the batched functions operate on [B, L] tensors of 2-bit
DNA codes entirely with 64-bit vector ops, producing one canonical
hash per sliding window. Bit-exact with the reference semantics:

- 2-bit codec A=0, T=1, C=2, G=3; complement = code ^ 1
  (reference: include/oxli/kmer_hash.hh:62-96)
- reversible hash: forward packs MSB-first, reverse packs the complement
  LSB-first; canonical = min(f, r) (reference: src/oxli/kmer_hash.cc:65-150)
- MurmurHash3_x64_128 (seed 0) of the ASCII k-mer and of its reverse
  complement; canonical = h ^ r, except palindromes where it is h
  (reference: src/oxli/kmer_hash.cc:168-208)
- hash-space banding for sharding
  (reference: src/oxli/kmer_hash.cc:261-275)

Scalar helpers (forward_hash, hash_murmur3, ...) are pure Python, mirroring
the khmer module-level API (reference: src/khmer/_cpy_khmer.cc:63-200); they
also serve as oracles for the batched device code in tests.
"""

import functools

import jax.numpy as jnp
import numpy as np

KSIZE_MAX = 32  # reference: include/oxli/oxli.hh:116
U64_MAX = 0xFFFFFFFFFFFFFFFF

# --- 2-bit DNA codec (A=0, T=1, C=2, G=3) -------------------------------

_CODE = {"A": 0, "T": 1, "C": 2, "G": 3}
_CHAR = "ATCG"
_CHAR_ASCII = np.frombuffer(b"ATCG", dtype=np.uint8)

# ASCII -> 2-bit code with cleaning: acgt -> upper, everything else -> A.
# (reference _to_valid_dna: src/oxli/read_parsers.cc:53-69)
ASCII_TO_CODE = np.zeros(256, dtype=np.uint8)
for _c, _v in _CODE.items():
    ASCII_TO_CODE[ord(_c)] = _v
    ASCII_TO_CODE[ord(_c.lower())] = _v

# Mask of ASCII bytes that are valid DNA post-cleaning (for is_valid checks)
ASCII_IS_ACGT = np.zeros(256, dtype=bool)
for _c in "ACGTacgt":
    ASCII_IS_ACGT[ord(_c)] = True

# IUPAC-aware reverse complement table (reference: src/oxli/kmer_hash.cc:53-56)
_RC_TBL = (
    "                                                                "
    " TVGH FCD  M KN   YSAABW R       TVGH FCD  M KN   YSAABW R"
)
RC_ASCII = np.zeros(256, dtype=np.uint8)
for _i in range(256):
    RC_ASCII[_i] = ord(_RC_TBL[_i]) if _i < len(_RC_TBL) else 0


def encode_dna(seq):
    """ASCII bytes/str -> cleaned 2-bit codes (uint8 numpy array).

    Applies `_to_valid_dna` semantics: lowercase acgt accepted, any other
    character becomes A (code 0).
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    return ASCII_TO_CODE[arr]


def decode_dna(codes):
    """2-bit codes -> DNA string."""
    return _CHAR_ASCII[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def reverse_complement(seq: str) -> str:
    """IUPAC-aware reverse complement, matching oxli::_revcomp."""
    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return RC_ASCII[arr[::-1]].tobytes().decode()


# --- scalar (pure Python) reference implementations ---------------------


def _hash_scalar(kmer: str, k: int):
    """Return (canonical, f, r) for the reversible 2-bit hash."""
    if k > KSIZE_MAX:
        raise ValueError("k-mer size must be <= %d" % KSIZE_MAX)
    if len(kmer) < k:
        raise ValueError("k-mer is too short to hash.")
    h = 0
    r = 0
    for i in range(k):
        h = (h << 2) | _CODE.get(kmer[i], 3)  # non-ACGT: C++ maps to G (3)
        r = (r << 2) | (_CODE.get(kmer[k - 1 - i], 3) ^ 1)
    return min(h, r), h, r


def forward_hash(kmer: str, ksize: int) -> int:
    """Canonical (min of fwd/rc) reversible 2-bit hash of a k-mer."""
    if ksize > KSIZE_MAX:
        raise ValueError("k-mer size must be <= %d" % KSIZE_MAX)
    if len(kmer) != ksize:
        raise ValueError("k-mer size different from ksize")
    return _hash_scalar(kmer, ksize)[0]


def forward_hash_no_rc(kmer: str, ksize: int) -> int:
    """Forward-strand-only reversible 2-bit hash."""
    if ksize > KSIZE_MAX:
        raise ValueError("k-mer size must be <= %d" % KSIZE_MAX)
    if len(kmer) != ksize:
        raise ValueError("k-mer length must equal the k-size")
    return _hash_scalar(kmer, ksize)[1]


def reverse_hash(hashval: int, ksize: int) -> str:
    """Invert the forward 2-bit hash back into a k-mer string."""
    if ksize > KSIZE_MAX:
        raise ValueError("k-mer size must be <= %d" % KSIZE_MAX)
    s = []
    for _ in range(ksize):
        s.append(_CHAR[hashval & 3])
        hashval >>= 2
    return "".join(reversed(s))


def _murmur3_x64_128(data: bytes, seed: int = 0):
    """Pure-Python MurmurHash3_x64_128 -> (h1, h2). Oracle for device code."""
    M = U64_MAX
    c1 = 0x87C37B91114253D5
    c2 = 0x4CF5AD432745937F
    length = len(data)
    h1 = h2 = seed
    nblocks = length // 16

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def fmix(kk):
        kk ^= kk >> 33
        kk = (kk * 0xFF51AFD7ED558CCD) & M
        kk ^= kk >> 33
        kk = (kk * 0xC4CEB9FE1A85EC53) & M
        kk ^= kk >> 33
        return kk

    for b in range(nblocks):
        k1 = int.from_bytes(data[b * 16:b * 16 + 8], "little")
        k2 = int.from_bytes(data[b * 16 + 8:b * 16 + 16], "little")
        k1 = (k1 * c1) & M
        k1 = rotl(k1, 31)
        k1 = (k1 * c2) & M
        h1 ^= k1
        h1 = rotl(h1, 27)
        h1 = (h1 + h2) & M
        h1 = (h1 * 5 + 0x52DCE729) & M
        k2 = (k2 * c2) & M
        k2 = rotl(k2, 33)
        k2 = (k2 * c1) & M
        h2 ^= k2
        h2 = rotl(h2, 31)
        h2 = (h2 + h1) & M
        h2 = (h2 * 5 + 0x38495AB5) & M

    tail = data[nblocks * 16:]
    k1 = k2 = 0
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:].ljust(8, b"\0"), "little")
        k2 = (k2 * c2) & M
        k2 = rotl(k2, 33)
        k2 = (k2 * c1) & M
        h2 ^= k2
    if len(tail) > 0:
        k1 = int.from_bytes(tail[:8].ljust(8, b"\0"), "little")
        k1 = (k1 * c1) & M
        k1 = rotl(k1, 31)
        k1 = (k1 * c2) & M
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    return h1, h2


def _hash_murmur_scalar(kmer: str):
    """Return (canonical, h, r) for the murmur hash of a k-mer string."""
    h = _murmur3_x64_128(kmer.encode("ascii"))[0]
    rev = reverse_complement(kmer)
    if rev == kmer:
        return h, h, h
    r = _murmur3_x64_128(rev.encode("ascii"))[0]
    return h ^ r, h, r


def hash_murmur3(kmer: str) -> int:
    """Canonical murmur hash (h ^ r, or h for palindromes)."""
    return _hash_murmur_scalar(kmer)[0]


def hash_no_rc_murmur3(kmer: str) -> int:
    """Forward-strand-only murmur hash."""
    return _murmur3_x64_128(kmer.encode("ascii"))[0]


# --- batched device (jnp) implementations -------------------------------


def _u64(x):
    return jnp.asarray(x, dtype=jnp.uint64)


def host_hash_windows(codes, k):
    """Canonical 2-bit window hashes on the host (numpy).

    The same closed form as the device rolling hash — window i packs
    codes[i..i+k-1] forward and complement-reversed — computed with k
    shifted vector ORs, bit-identical to _hash_scalar (tested in
    tests/test_hashing.py).  This is the zero-dispatch hash for the
    host tier's per-sequence paths (annotate, tag queries)."""
    codes = np.asarray(codes, dtype=np.uint64)
    W = codes.shape[0] - k + 1
    if W <= 0:
        return np.zeros(0, dtype=np.uint64)
    f = np.zeros(W, dtype=np.uint64)
    r = np.zeros(W, dtype=np.uint64)
    for j in range(k):
        f |= codes[j:j + W] << np.uint64(2 * (k - 1 - j))
        r |= (codes[j:j + W] ^ np.uint64(1)) << np.uint64(2 * j)
    return np.minimum(f, r)


def host_murmur_hash_windows(codes, k):
    """Canonical murmur window hashes on the host (numpy).

    Same word-packing + vectorized MurmurHash3_x64_128 as the device
    implementation below, in numpy u64 (wrapping) arithmetic — bit-
    identical to _hash_murmur_scalar. Fallback dense hasher for the
    murmur family when the native library is unavailable.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    W = codes.shape[0] - k + 1
    if W <= 0:
        return np.zeros(0, dtype=np.uint64)
    chars_f = _CHAR_ASCII[codes].astype(np.uint64)
    chars_r = _CHAR_ASCII[codes ^ 1].astype(np.uint64)
    nwords = (k + 7) // 8

    def words(chars, rc):
        out = []
        for m in range(nwords):
            w = np.zeros(W, dtype=np.uint64)
            for b in range(8):
                t = m * 8 + b
                if t >= k:
                    break
                pos = (k - 1 - t) if rc else t
                w |= chars[pos:pos + W] << np.uint64(8 * b)
            out.append(w)
        return out

    def murmur(ws):
        c1 = np.uint64(0x87C37B91114253D5)
        c2 = np.uint64(0x4CF5AD432745937F)
        h1 = np.zeros(W, dtype=np.uint64)
        h2 = np.zeros(W, dtype=np.uint64)

        def rotl(x, r):
            return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

        def fmix(kk):
            kk = kk ^ (kk >> np.uint64(33))
            kk = kk * np.uint64(0xFF51AFD7ED558CCD)
            kk = kk ^ (kk >> np.uint64(33))
            kk = kk * np.uint64(0xC4CEB9FE1A85EC53)
            return kk ^ (kk >> np.uint64(33))

        nblocks = k // 16
        for b in range(nblocks):
            k1 = ws[2 * b] * c1
            k1 = rotl(k1, 31) * c2
            h1 = h1 ^ k1
            h1 = rotl(h1, 27) + h2
            h1 = h1 * np.uint64(5) + np.uint64(0x52DCE729)
            k2 = ws[2 * b + 1] * c2
            k2 = rotl(k2, 33) * c1
            h2 = h2 ^ k2
            h2 = rotl(h2, 31) + h1
            h2 = h2 * np.uint64(5) + np.uint64(0x38495AB5)
        taillen = k % 16
        if taillen > 8:
            k2 = ws[2 * nblocks + 1] * c2
            h2 = h2 ^ (rotl(k2, 33) * c1)
        if taillen > 0:
            k1 = ws[2 * nblocks] * c1
            h1 = h1 ^ (rotl(k1, 31) * c2)
        h1 = h1 ^ np.uint64(k)
        h2 = h2 ^ np.uint64(k)
        h1 = h1 + h2
        h2 = h2 + h1
        h1 = fmix(h1)
        h2 = fmix(h2)
        return h1 + h2

    h = murmur(words(chars_f, rc=False))
    r = murmur(words(chars_r, rc=True))
    # palindrome <=> 2-bit forward == 2-bit reverse encoding
    c64 = codes.astype(np.uint64)
    f2 = np.zeros(W, dtype=np.uint64)
    r2 = np.zeros(W, dtype=np.uint64)
    for j in range(k):
        f2 |= c64[j:j + W] << np.uint64(2 * (k - 1 - j))
        r2 |= (c64[j:j + W] ^ np.uint64(1)) << np.uint64(2 * j)
    return np.where(f2 == r2, h, h ^ r)


def rolling_hash_windows(codes, k: int):
    """Compute (canonical, f, r) 2-bit hashes for every k-window.

    codes: [..., L] uint8 2-bit codes. Returns three [..., L-k+1] uint64
    arrays. Pure VPU work: k shifted-or steps over the window axis.
    """
    L = codes.shape[-1]
    W = L - k + 1
    if W <= 0:
        raise ValueError("sequence shorter than k")
    c = codes.astype(jnp.uint64)
    f = jnp.zeros(codes.shape[:-1] + (W,), dtype=jnp.uint64)
    r = jnp.zeros_like(f)
    for j in range(k):
        f = (f << _u64(2)) | c[..., j:j + W]
        r = (r << _u64(2)) | (c[..., k - 1 - j:k - 1 - j + W] ^ _u64(1))
    return jnp.minimum(f, r), f, r


def _window_bytes_words(codes, k: int, rc: bool):
    """Pack each k-window's ASCII bytes into ceil(k/8) little-endian u64 words.

    If rc, the bytes are the reverse complement of the window.
    codes: [..., L] uint8. Returns list of [..., W] uint64 arrays.
    """
    L = codes.shape[-1]
    W = L - k + 1
    chars = jnp.take(jnp.asarray(_CHAR_ASCII), codes.astype(jnp.int32))
    if rc:
        # complement char = char of (code ^ 1)
        chars = jnp.take(jnp.asarray(_CHAR_ASCII), (codes ^ 1).astype(jnp.int32))
    chars = chars.astype(jnp.uint64)
    nwords = (k + 7) // 8
    words = []
    for m in range(nwords):
        w = jnp.zeros(codes.shape[:-1] + (W,), dtype=jnp.uint64)
        for b in range(8):
            t = m * 8 + b  # byte index within the k-mer
            if t >= k:
                break
            # forward: byte t is window position t
            # rc: byte t is complement of window position k-1-t
            pos = (k - 1 - t) if rc else t
            w = w | (chars[..., pos:pos + W] << _u64(8 * b))
        words.append(w)
    return words


def _murmur3_x64_128_words(words, length: int):
    """Vectorized MurmurHash3_x64_128 over u64-word lists; returns h1.

    words: list of ceil(length/8) [..., W] uint64 arrays (little-endian
    packed bytes, zero-padded past `length`). `length` is static.
    """
    M64 = _u64(U64_MAX)  # noqa: F841  (ops wrap mod 2^64 natively)
    c1 = _u64(0x87C37B91114253D5)
    c2 = _u64(0x4CF5AD432745937F)
    shape = words[0].shape
    h1 = jnp.zeros(shape, dtype=jnp.uint64)
    h2 = jnp.zeros(shape, dtype=jnp.uint64)

    def rotl(x, r):
        return (x << _u64(r)) | (x >> _u64(64 - r))

    def fmix(kk):
        kk = kk ^ (kk >> _u64(33))
        kk = kk * _u64(0xFF51AFD7ED558CCD)
        kk = kk ^ (kk >> _u64(33))
        kk = kk * _u64(0xC4CEB9FE1A85EC53)
        kk = kk ^ (kk >> _u64(33))
        return kk

    nblocks = length // 16
    for b in range(nblocks):
        k1 = words[2 * b]
        k2 = words[2 * b + 1]
        k1 = k1 * c1
        k1 = rotl(k1, 31)
        k1 = k1 * c2
        h1 = h1 ^ k1
        h1 = rotl(h1, 27)
        h1 = h1 + h2
        h1 = h1 * _u64(5) + _u64(0x52DCE729)
        k2 = k2 * c2
        k2 = rotl(k2, 33)
        k2 = k2 * c1
        h2 = h2 ^ k2
        h2 = rotl(h2, 31)
        h2 = h2 + h1
        h2 = h2 * _u64(5) + _u64(0x38495AB5)

    taillen = length % 16
    if taillen > 8:
        k2 = words[2 * nblocks + 1]
        k2 = k2 * c2
        k2 = rotl(k2, 33)
        k2 = k2 * c1
        h2 = h2 ^ k2
    if taillen > 0:
        k1 = words[2 * nblocks]
        k1 = k1 * c1
        k1 = rotl(k1, 31)
        k1 = k1 * c2
        h1 = h1 ^ k1

    h1 = h1 ^ _u64(length)
    h2 = h2 ^ _u64(length)
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = h1 + h2
    return h1


def murmur_hash_windows(codes, k: int):
    """Canonical murmur hashes for every k-window of a code tensor.

    Returns (canonical, h, r): [..., L-k+1] uint64. Palindromic windows
    (window == its revcomp) canonicalize to h, matching the reference
    self-complement special case (src/oxli/kmer_hash.cc:186-193).
    """
    fwd_words = _window_bytes_words(codes, k, rc=False)
    rc_words = _window_bytes_words(codes, k, rc=True)
    h = _murmur3_x64_128_words(fwd_words, k)
    r = _murmur3_x64_128_words(rc_words, k)
    # palindrome <=> 2-bit forward == 2-bit reverse encoding
    _, f2, r2 = rolling_hash_windows(codes, k)
    canonical = jnp.where(f2 == r2, h, h ^ r)
    return canonical, h, r


def hash_windows(codes, k: int, hash_family: str):
    """Dispatch: canonical hashes per window for the given hash family."""
    if hash_family == "twobit":
        return rolling_hash_windows(codes, k)[0]
    elif hash_family == "murmur":
        return murmur_hash_windows(codes, k)[0]
    else:
        raise ValueError("unknown hash family %r" % hash_family)


def compute_band_interval(num_bands: int, band: int):
    """Split uint64 hash space into equal bands (sharding primitive).

    Mirrors oxli::compute_band_interval (src/oxli/kmer_hash.cc:261-275).
    """
    if band >= num_bands:
        raise ValueError(
            "'band' must be in the interval [0, 'num_bands')"
            ", %d not in [0, %d)" % (band, num_bands))
    band_size = U64_MAX // num_bands
    return band_size * band, band_size * (band + 1)


@functools.lru_cache(maxsize=None)
def _kmer_hash_fn(k: int, hash_family: str):
    """A jitted scalar-batch hasher: [n, k] codes -> [n] canonical hashes."""
    import jax

    @jax.jit
    def fn(codes):
        return hash_windows(codes, k, hash_family)[..., 0]

    return fn
