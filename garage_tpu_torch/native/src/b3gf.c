/* Native host kernels for the block data path: BLAKE3 hashing and
 * GF(2^8) matrix application (Reed-Solomon encode/decode).
 *
 * Role: the CPU-side twin of the TPU data plane (ops/treehash.py,
 * ops/gf256.py). The TPU path batches whole stripes through XLA; this
 * library serves the host-resident cases — single-block hashing on the
 * PUT path when no accelerator is attached, shard checksum verification,
 * and RS fallback math — at native speed instead of pure Python.
 *
 * BLAKE3 is implemented from the public spec (portable, no SIMD
 * intrinsics; gcc auto-vectorizes the compression rounds well enough
 * for a host fallback). Only the default 32-byte hash mode is needed.
 *
 * The reference stores hash blocks with sequential blake2
 * (src/util/data.rs:124-132); this framework's content hash is BLAKE3
 * so device and host agree on one tree-structured function.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define GT_X86 1
static int cpu_sse42 = -1;
static int cpu_avx2 = -1;
#endif

/* ================= BLAKE3 ================= */

static const uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

static const uint8_t MSG_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13,
                                     1, 11, 12, 5, 9, 14, 15, 8};

enum {
    CHUNK_START = 1 << 0,
    CHUNK_END = 1 << 1,
    PARENT = 1 << 2,
    ROOT = 1 << 3,
};

#define CHUNK_LEN 1024
#define BLOCK_LEN 64

static inline uint32_t rotr32(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

static inline void gmix(uint32_t *v, int a, int b, int c, int d,
                        uint32_t mx, uint32_t my) {
    v[a] = v[a] + v[b] + mx;
    v[d] = rotr32(v[d] ^ v[a], 16);
    v[c] = v[c] + v[d];
    v[b] = rotr32(v[b] ^ v[c], 12);
    v[a] = v[a] + v[b] + my;
    v[d] = rotr32(v[d] ^ v[a], 8);
    v[c] = v[c] + v[d];
    v[b] = rotr32(v[b] ^ v[c], 7);
}

static void compress(const uint32_t cv[8], const uint32_t block[16],
                     uint64_t counter, uint32_t block_len, uint32_t flags,
                     uint32_t out[8]) {
    uint32_t v[16];
    uint32_t m[16], t[16];
    memcpy(v, cv, 32);
    v[8] = IV[0];
    v[9] = IV[1];
    v[10] = IV[2];
    v[11] = IV[3];
    v[12] = (uint32_t)counter;
    v[13] = (uint32_t)(counter >> 32);
    v[14] = block_len;
    v[15] = flags;
    memcpy(m, block, 64);
    for (int r = 0;; r++) {
        gmix(v, 0, 4, 8, 12, m[0], m[1]);
        gmix(v, 1, 5, 9, 13, m[2], m[3]);
        gmix(v, 2, 6, 10, 14, m[4], m[5]);
        gmix(v, 3, 7, 11, 15, m[6], m[7]);
        gmix(v, 0, 5, 10, 15, m[8], m[9]);
        gmix(v, 1, 6, 11, 12, m[10], m[11]);
        gmix(v, 2, 7, 8, 13, m[12], m[13]);
        gmix(v, 3, 4, 9, 14, m[14], m[15]);
        if (r == 6)
            break;
        for (int i = 0; i < 16; i++)
            t[i] = m[MSG_PERM[i]];
        memcpy(m, t, 64);
    }
    for (int i = 0; i < 8; i++)
        out[i] = v[i] ^ v[i + 8];
}

static void load_words(const uint8_t *p, size_t len, uint32_t out[16]) {
    uint8_t buf[BLOCK_LEN];
    if (len < BLOCK_LEN) {
        memset(buf, 0, BLOCK_LEN);
        memcpy(buf, p, len);
        p = buf;
    }
    for (int i = 0; i < 16; i++)
        out[i] = (uint32_t)p[4 * i] | ((uint32_t)p[4 * i + 1] << 8) |
                 ((uint32_t)p[4 * i + 2] << 16) | ((uint32_t)p[4 * i + 3] << 24);
}

static void chunk_cv(const uint8_t *chunk, size_t len, uint64_t counter,
                     int root, uint32_t cv[8]) {
    size_t nblocks = len == 0 ? 1 : (len + BLOCK_LEN - 1) / BLOCK_LEN;
    memcpy(cv, IV, 32);
    for (size_t b = 0; b < nblocks; b++) {
        size_t blen = (b == nblocks - 1) ? len - BLOCK_LEN * b : BLOCK_LEN;
        uint32_t m[16];
        load_words(chunk + BLOCK_LEN * b, blen, m);
        uint32_t flags = 0;
        if (b == 0)
            flags |= CHUNK_START;
        if (b == nblocks - 1) {
            flags |= CHUNK_END;
            if (root)
                flags |= ROOT;
        }
        compress(cv, m, counter, (uint32_t)blen, flags, cv);
    }
}

static void parent_cv(const uint32_t l[8], const uint32_t r[8], int root,
                      uint32_t out[8]) {
    uint32_t m[16];
    memcpy(m, l, 32);
    memcpy(m + 8, r, 32);
    compress(IV, m, 0, BLOCK_LEN, PARENT | (root ? ROOT : 0), out);
}

/* ============ AVX2 8-way: vectorize ACROSS chunks/parents ============
 * The standard BLAKE3 SIMD formulation from the public spec: eight
 * independent compressions run in lockstep, one 32-bit word per lane.
 * Used for full non-root chunks (identical flags across lanes) and for
 * batches of parent nodes; everything else takes the portable path. */

#ifdef GT_X86

#define ROTR8(v, n) _mm256_or_si256(_mm256_srli_epi32(v, n), \
                                    _mm256_slli_epi32(v, 32 - (n)))

__attribute__((target("avx2")))
static inline void g8(__m256i v[16], int a, int b, int c, int d,
                      __m256i mx, __m256i my) {
    v[a] = _mm256_add_epi32(_mm256_add_epi32(v[a], v[b]), mx);
    v[d] = ROTR8(_mm256_xor_si256(v[d], v[a]), 16);
    v[c] = _mm256_add_epi32(v[c], v[d]);
    v[b] = ROTR8(_mm256_xor_si256(v[b], v[c]), 12);
    v[a] = _mm256_add_epi32(_mm256_add_epi32(v[a], v[b]), my);
    v[d] = ROTR8(_mm256_xor_si256(v[d], v[a]), 8);
    v[c] = _mm256_add_epi32(v[c], v[d]);
    v[b] = ROTR8(_mm256_xor_si256(v[b], v[c]), 7);
}

/* one compression over 8 lanes; m = 16 message-word vectors (mutated:
 * physically permuted between rounds — an indexed schedule was tried
 * and measured SLOWER, it forces m into memory instead of registers) */
__attribute__((target("avx2")))
static void compress8(__m256i cv[8], __m256i m[16], __m256i t0,
                      uint32_t block_len, uint32_t flags,
                      __m256i out[8]) {
    __m256i v[16];
    for (int i = 0; i < 8; i++)
        v[i] = cv[i];
    v[8] = _mm256_set1_epi32((int)IV[0]);
    v[9] = _mm256_set1_epi32((int)IV[1]);
    v[10] = _mm256_set1_epi32((int)IV[2]);
    v[11] = _mm256_set1_epi32((int)IV[3]);
    v[12] = t0;
    v[13] = _mm256_setzero_si256(); /* chunk counters < 2^32 */
    v[14] = _mm256_set1_epi32((int)block_len);
    v[15] = _mm256_set1_epi32((int)flags);
    __m256i t[16];
    for (int r = 0;; r++) {
        g8(v, 0, 4, 8, 12, m[0], m[1]);
        g8(v, 1, 5, 9, 13, m[2], m[3]);
        g8(v, 2, 6, 10, 14, m[4], m[5]);
        g8(v, 3, 7, 11, 15, m[6], m[7]);
        g8(v, 0, 5, 10, 15, m[8], m[9]);
        g8(v, 1, 6, 11, 12, m[10], m[11]);
        g8(v, 2, 7, 8, 13, m[12], m[13]);
        g8(v, 3, 4, 9, 14, m[14], m[15]);
        if (r == 6)
            break;
        for (int i = 0; i < 16; i++)
            t[i] = m[MSG_PERM[i]];
        for (int i = 0; i < 16; i++)
            m[i] = t[i];
    }
    for (int i = 0; i < 8; i++)
        out[i] = _mm256_xor_si256(v[i], v[i + 8]);
}

/* little-endian word load without alignment/aliasing UB (compiles to
 * one mov on x86) */
static inline uint32_t ldw(const uint8_t *p) {
    uint32_t w;
    memcpy(&w, p, 4);
    return w;
}

/* transpose: load word j of one 64-byte block from 8 streams */
__attribute__((target("avx2")))
static inline void load_words8(const uint8_t *const p[8], size_t off,
                               __m256i m[16]) {
    for (int j = 0; j < 16; j++)
        m[j] = _mm256_set_epi32(
            (int)ldw(p[7] + off + 4 * j), (int)ldw(p[6] + off + 4 * j),
            (int)ldw(p[5] + off + 4 * j), (int)ldw(p[4] + off + 4 * j),
            (int)ldw(p[3] + off + 4 * j), (int)ldw(p[2] + off + 4 * j),
            (int)ldw(p[1] + off + 4 * j), (int)ldw(p[0] + off + 4 * j));
}

/* 8 FULL non-root chunks -> 8 CVs (row-major: out[lane][word]) */
__attribute__((target("avx2")))
static void chunks8_cv(const uint8_t *const p[8], uint64_t counter0,
                       uint32_t out[8][8]) {
    __m256i cv[8], m[16];
    for (int i = 0; i < 8; i++)
        cv[i] = _mm256_set1_epi32((int)IV[i]);
    __m256i t0 = _mm256_set_epi32(
        (int)(uint32_t)(counter0 + 7), (int)(uint32_t)(counter0 + 6),
        (int)(uint32_t)(counter0 + 5), (int)(uint32_t)(counter0 + 4),
        (int)(uint32_t)(counter0 + 3), (int)(uint32_t)(counter0 + 2),
        (int)(uint32_t)(counter0 + 1), (int)(uint32_t)(counter0));
    for (int b = 0; b < CHUNK_LEN / BLOCK_LEN; b++) {
        uint32_t flags = 0;
        if (b == 0)
            flags |= CHUNK_START;
        if (b == CHUNK_LEN / BLOCK_LEN - 1)
            flags |= CHUNK_END;
        load_words8(p, (size_t)b * BLOCK_LEN, m);
        compress8(cv, m, t0, BLOCK_LEN, flags, cv);
    }
    uint32_t tmp[8][8]; /* tmp[word][lane] */
    for (int i = 0; i < 8; i++)
        _mm256_storeu_si256((__m256i *)tmp[i], cv[i]);
    for (int l = 0; l < 8; l++)
        for (int i = 0; i < 8; i++)
            out[l][i] = tmp[i][l];
}

/* 8 non-root parents: cvs[2*i], cvs[2*i+1] -> out[i] (row-major) */
__attribute__((target("avx2")))
static void parents8_cv(const uint32_t cvs[16][8], uint32_t out[8][8]) {
    __m256i cv[8], m[16];
    for (int i = 0; i < 8; i++)
        cv[i] = _mm256_set1_epi32((int)IV[i]);
    for (int j = 0; j < 8; j++) {
        m[j] = _mm256_set_epi32(
            (int)cvs[14][j], (int)cvs[12][j], (int)cvs[10][j],
            (int)cvs[8][j], (int)cvs[6][j], (int)cvs[4][j],
            (int)cvs[2][j], (int)cvs[0][j]);
        m[8 + j] = _mm256_set_epi32(
            (int)cvs[15][j], (int)cvs[13][j], (int)cvs[11][j],
            (int)cvs[9][j], (int)cvs[7][j], (int)cvs[5][j],
            (int)cvs[3][j], (int)cvs[1][j]);
    }
    __m256i o[8];
    compress8(cv, m, _mm256_setzero_si256(), BLOCK_LEN, PARENT, o);
    uint32_t tmp[8][8];
    for (int i = 0; i < 8; i++)
        _mm256_storeu_si256((__m256i *)tmp[i], o[i]);
    for (int l = 0; l < 8; l++)
        for (int i = 0; i < 8; i++)
            out[l][i] = tmp[i][l];
}

#endif /* GT_X86 */

/* Spec tree: left subtree = largest power of two of chunks strictly
 * less than the total. Recursion depth <= 54 for 64-bit lengths. */
static void subtree_cv(const uint8_t *data, uint64_t len, uint64_t counter0,
                       int root, uint32_t cv[8]);

#ifdef GT_X86
/* Whole-subtree CVs for a run of FULL chunks, 8-way where possible.
 * `nchunks` must be a power of two >= 8 and the subtree non-root;
 * returns the subtree's CV. */
__attribute__((target("avx2")))
static void subtree_cv_avx2(const uint8_t *data, uint64_t nchunks,
                            uint64_t counter0, uint32_t cv[8]) {
    /* hash all chunks 8 at a time. CV scratch is up to 128 KiB — heap,
     * not alloca: worker threads on some libcs get ~128 KiB stacks. */
    uint32_t (*cvs)[8] = malloc(sizeof(uint32_t[8]) * (size_t)nchunks);
    if (!cvs) { /* fallback: caller's scalar path via recursion */
        uint64_t half = nchunks / 2;
        uint32_t l[8], r[8];
        subtree_cv(data, half * CHUNK_LEN, counter0, 0, l);
        subtree_cv(data + half * CHUNK_LEN, half * CHUNK_LEN,
                   counter0 + half, 0, r);
        parent_cv(l, r, 0, cv);
        return;
    }
    for (uint64_t c = 0; c < nchunks; c += 8) {
        const uint8_t *p[8];
        for (int l = 0; l < 8; l++)
            p[l] = data + (size_t)(c + l) * CHUNK_LEN;
        chunks8_cv(p, counter0 + c, &cvs[c]);
    }
    /* pairwise parent reduction, 8 parents at a time */
    uint64_t n = nchunks;
    while (n > 1) {
        uint64_t half = n / 2;
        uint64_t i = 0;
        for (; i + 8 <= half; i += 8)
            parents8_cv((const uint32_t(*)[8]) & cvs[2 * i], &cvs[i]);
        for (; i < half; i++)
            parent_cv(cvs[2 * i], cvs[2 * i + 1], 0, cvs[i]);
        n = half;
    }
    memcpy(cv, cvs[0], 32);
    free(cvs);
}
#endif

static void subtree_cv(const uint8_t *data, uint64_t len, uint64_t counter0,
                       int root, uint32_t cv[8]) {
    uint64_t nchunks = len == 0 ? 1 : (len + CHUNK_LEN - 1) / CHUNK_LEN;
    if (nchunks == 1) {
        chunk_cv(data, (size_t)len, counter0, root, cv);
        return;
    }
#ifdef GT_X86
    if (cpu_avx2 < 0)
        cpu_avx2 = __builtin_cpu_supports("avx2") ? 1 : 0;
    /* power-of-two run of full chunks, non-root: whole subtree 8-way.
     * cap at 2^12 chunks (4 MiB data, 128 KiB heap CV scratch);
     * bigger subtrees recurse first. */
    if (cpu_avx2 && !root && nchunks >= 8 && nchunks <= (1u << 12) &&
        (nchunks & (nchunks - 1)) == 0 &&
        len == nchunks * (uint64_t)CHUNK_LEN &&
        counter0 + nchunks <= 0xFFFFFFFFu /* compress8 pins t1=0 */) {
        subtree_cv_avx2(data, nchunks, counter0, cv);
        return;
    }
#endif
    uint64_t left = 1;
    while (left * 2 < nchunks)
        left *= 2;
    uint32_t l[8], r[8];
    subtree_cv(data, left * CHUNK_LEN, counter0, 0, l);
    subtree_cv(data + left * CHUNK_LEN, len - left * CHUNK_LEN,
               counter0 + left, 0, r);
    parent_cv(l, r, root, cv);
}

void b3_hash(const uint8_t *data, uint64_t len, uint8_t out[32]) {
    uint32_t cv[8];
    subtree_cv(data, len, 0, 1, cv);
    for (int i = 0; i < 8; i++) {
        out[4 * i] = (uint8_t)cv[i];
        out[4 * i + 1] = (uint8_t)(cv[i] >> 8);
        out[4 * i + 2] = (uint8_t)(cv[i] >> 16);
        out[4 * i + 3] = (uint8_t)(cv[i] >> 24);
    }
}

/* n messages at data + offs[i], length lens[i]; digests to out + 32*i. */
void b3_hash_many(const uint8_t *data, int64_t n, const int64_t *offs,
                  const int64_t *lens, uint8_t *out) {
    for (int64_t i = 0; i < n; i++)
        b3_hash(data + offs[i], (uint64_t)lens[i], out + 32 * i);
}

/* ================= MD5 (RFC 1321) ================= */
/* S3 ETags are MD5, so the PUT path pays a serial MD5 over every byte
 * on top of the BLAKE3 content hash. gt_b3_md5_block below runs both
 * digests in ONE interleaved pass (r5: the two separate walks over a
 * 1 MiB block were the single largest CPU cost on the S3 PUT path of
 * a one-core node). Streaming state lives in a caller-owned struct so
 * the chain threads across blocks of the object. */

typedef struct {
    uint32_t h[4];
    uint64_t nbytes;
    uint32_t buflen;
    uint8_t buf[64];
} gt_md5;

static const uint32_t MD5K[64] = {
    0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu,
    0xf57c0fafu, 0x4787c62au, 0xa8304613u, 0xfd469501u,
    0x698098d8u, 0x8b44f7afu, 0xffff5bb1u, 0x895cd7beu,
    0x6b901122u, 0xfd987193u, 0xa679438eu, 0x49b40821u,
    0xf61e2562u, 0xc040b340u, 0x265e5a51u, 0xe9b6c7aau,
    0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u,
    0x21e1cde6u, 0xc33707d6u, 0xf4d50d87u, 0x455a14edu,
    0xa9e3e905u, 0xfcefa3f8u, 0x676f02d9u, 0x8d2a4c8au,
    0xfffa3942u, 0x8771f681u, 0x6d9d6122u, 0xfde5380cu,
    0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u,
    0x289b7ec6u, 0xeaa127fau, 0xd4ef3085u, 0x04881d05u,
    0xd9d4d039u, 0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u,
    0xf4292244u, 0x432aff97u, 0xab9423a7u, 0xfc93a039u,
    0x655b59c3u, 0x8f0ccc92u, 0xffeff47du, 0x85845dd1u,
    0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,
    0xf7537e82u, 0xbd3af235u, 0x2ad7d2bbu, 0xeb86d391u};

static const uint8_t MD5R[64] = {
    7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
    5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20,
    4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
    6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};

static inline uint32_t rotl32(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

static void md5_compress(uint32_t h[4], const uint8_t p[64]) {
    uint32_t M[16];
    for (int i = 0; i < 16; i++)
        M[i] = (uint32_t)p[4 * i] | ((uint32_t)p[4 * i + 1] << 8) |
               ((uint32_t)p[4 * i + 2] << 16) |
               ((uint32_t)p[4 * i + 3] << 24);
    uint32_t A = h[0], B = h[1], C = h[2], D = h[3];
    /* four unrolled 16-step rounds (the i/16 branch per step costs
     * ~15% when left to the compiler) */
    int i = 0;
    for (; i < 16; i++) {
        uint32_t F = (B & C) | (~B & D);
        F += A + MD5K[i] + M[i];
        A = D; D = C; C = B;
        B += rotl32(F, MD5R[i]);
    }
    for (; i < 32; i++) {
        uint32_t F = (D & B) | (~D & C);
        F += A + MD5K[i] + M[(5 * i + 1) & 15];
        A = D; D = C; C = B;
        B += rotl32(F, MD5R[i]);
    }
    for (; i < 48; i++) {
        uint32_t F = B ^ C ^ D;
        F += A + MD5K[i] + M[(3 * i + 5) & 15];
        A = D; D = C; C = B;
        B += rotl32(F, MD5R[i]);
    }
    for (; i < 64; i++) {
        uint32_t F = C ^ (B | ~D);
        F += A + MD5K[i] + M[(7 * i) & 15];
        A = D; D = C; C = B;
        B += rotl32(F, MD5R[i]);
    }
    h[0] += A; h[1] += B; h[2] += C; h[3] += D;
}

int gt_md5_state_size(void) { return (int)sizeof(gt_md5); }

void gt_md5_init(gt_md5 *m) {
    m->h[0] = 0x67452301u; m->h[1] = 0xefcdab89u;
    m->h[2] = 0x98badcfeu; m->h[3] = 0x10325476u;
    m->nbytes = 0;
    m->buflen = 0;
}

void gt_md5_update(gt_md5 *m, const uint8_t *p, uint64_t n) {
    m->nbytes += n;
    if (m->buflen) {
        uint32_t take = 64 - m->buflen;
        if (take > n) take = (uint32_t)n;
        memcpy(m->buf + m->buflen, p, take);
        m->buflen += take;
        p += take; n -= take;
        if (m->buflen == 64) {
            md5_compress(m->h, m->buf);
            m->buflen = 0;
        }
    }
    while (n >= 64) {
        md5_compress(m->h, p);
        p += 64; n -= 64;
    }
    if (n) {
        memcpy(m->buf, p, n);
        m->buflen = (uint32_t)n;
    }
}

/* Finalize WITHOUT mutating the stream state (hexdigest() mid-stream,
 * like hashlib's). */
void gt_md5_final_copy(const gt_md5 *src, uint8_t out[16]) {
    gt_md5 m = *src;
    uint64_t bits = m.nbytes * 8;
    uint8_t pad = 0x80;
    gt_md5_update(&m, &pad, 1);
    static const uint8_t zeros[64] = {0};
    while (m.buflen != 56)
        gt_md5_update(&m, zeros, m.buflen < 56 ? 56 - m.buflen
                                               : 64 - m.buflen + 56);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++)
        lenb[i] = (uint8_t)(bits >> (8 * i));
    gt_md5_update(&m, lenb, 8);
    for (int i = 0; i < 4; i++) {
        out[4 * i] = (uint8_t)m.h[i];
        out[4 * i + 1] = (uint8_t)(m.h[i] >> 8);
        out[4 * i + 2] = (uint8_t)(m.h[i] >> 16);
        out[4 * i + 3] = (uint8_t)(m.h[i] >> 24);
    }
}

/* ---- 8-way multi-buffer MD5 (AVX2) ----
 * MD5 is a strict serial chain WITHIN one object, but concurrent PUT
 * requests are independent chains: running 8 of them in lockstep, one
 * 32-bit word per lane (same formulation as compress8 above), turns
 * the ETag MD5 from ~0.55 GB/s into a batched multi-GB/s op whenever
 * the feeder queue holds blocks from several requests. */

#ifdef GT_X86

#define ROTL8V(v, n) _mm256_or_si256(_mm256_slli_epi32(v, n), \
                                     _mm256_srli_epi32(v, 32 - (n)))

__attribute__((target("avx2")))
static void md5_compress8(__m256i h[4], const uint8_t *const p[8],
                          size_t off) {
    __m256i M[16];
    for (int j = 0; j < 16; j++)
        M[j] = _mm256_set_epi32(
            (int)ldw(p[7] + off + 4 * j), (int)ldw(p[6] + off + 4 * j),
            (int)ldw(p[5] + off + 4 * j), (int)ldw(p[4] + off + 4 * j),
            (int)ldw(p[3] + off + 4 * j), (int)ldw(p[2] + off + 4 * j),
            (int)ldw(p[1] + off + 4 * j), (int)ldw(p[0] + off + 4 * j));
    __m256i A = h[0], B = h[1], C = h[2], D = h[3];
    int i = 0;
#define MD5STEP8(Fexpr, g, r)                                         \
    do {                                                              \
        __m256i F = Fexpr;                                            \
        F = _mm256_add_epi32(F, _mm256_add_epi32(A,                   \
                _mm256_add_epi32(_mm256_set1_epi32((int)MD5K[i]),     \
                                 M[g])));                             \
        A = D; D = C; C = B;                                          \
        B = _mm256_add_epi32(B, ROTL8V(F, r));                        \
        i++;                                                          \
    } while (0)
    for (int q = 0; q < 4; q++) {
        MD5STEP8(_mm256_or_si256(_mm256_and_si256(B, C),
                                 _mm256_andnot_si256(B, D)), i, 7);
        MD5STEP8(_mm256_or_si256(_mm256_and_si256(B, C),
                                 _mm256_andnot_si256(B, D)), i, 12);
        MD5STEP8(_mm256_or_si256(_mm256_and_si256(B, C),
                                 _mm256_andnot_si256(B, D)), i, 17);
        MD5STEP8(_mm256_or_si256(_mm256_and_si256(B, C),
                                 _mm256_andnot_si256(B, D)), i, 22);
    }
    for (int q = 0; q < 4; q++) {
        MD5STEP8(_mm256_or_si256(_mm256_and_si256(D, B),
                                 _mm256_andnot_si256(D, C)),
                 (5 * i + 1) & 15, 5);
        MD5STEP8(_mm256_or_si256(_mm256_and_si256(D, B),
                                 _mm256_andnot_si256(D, C)),
                 (5 * i + 1) & 15, 9);
        MD5STEP8(_mm256_or_si256(_mm256_and_si256(D, B),
                                 _mm256_andnot_si256(D, C)),
                 (5 * i + 1) & 15, 14);
        MD5STEP8(_mm256_or_si256(_mm256_and_si256(D, B),
                                 _mm256_andnot_si256(D, C)),
                 (5 * i + 1) & 15, 20);
    }
    for (int q = 0; q < 4; q++) {
        MD5STEP8(_mm256_xor_si256(_mm256_xor_si256(B, C), D),
                 (3 * i + 5) & 15, 4);
        MD5STEP8(_mm256_xor_si256(_mm256_xor_si256(B, C), D),
                 (3 * i + 5) & 15, 11);
        MD5STEP8(_mm256_xor_si256(_mm256_xor_si256(B, C), D),
                 (3 * i + 5) & 15, 16);
        MD5STEP8(_mm256_xor_si256(_mm256_xor_si256(B, C), D),
                 (3 * i + 5) & 15, 23);
    }
    __m256i ones = _mm256_set1_epi32(-1);
    for (int q = 0; q < 4; q++) {
        MD5STEP8(_mm256_xor_si256(C, _mm256_or_si256(B,
                     _mm256_xor_si256(D, ones))), (7 * i) & 15, 6);
        MD5STEP8(_mm256_xor_si256(C, _mm256_or_si256(B,
                     _mm256_xor_si256(D, ones))), (7 * i) & 15, 10);
        MD5STEP8(_mm256_xor_si256(C, _mm256_or_si256(B,
                     _mm256_xor_si256(D, ones))), (7 * i) & 15, 15);
        MD5STEP8(_mm256_xor_si256(C, _mm256_or_si256(B,
                     _mm256_xor_si256(D, ones))), (7 * i) & 15, 21);
    }
#undef MD5STEP8
    h[0] = _mm256_add_epi32(h[0], A);
    h[1] = _mm256_add_epi32(h[1], B);
    h[2] = _mm256_add_epi32(h[2], C);
    h[3] = _mm256_add_epi32(h[3], D);
}

/* advance 8 lane states by `nblocks` sequential 64-byte blocks each
 * (lane l reads p[l] + 64*k). Does NOT touch nbytes/buf — callers
 * account for consumed bytes. */
__attribute__((target("avx2")))
static void md5_blocks8(gt_md5 *const st[8], const uint8_t *const p[8],
                        uint64_t nblocks) {
    __m256i h[4];
    for (int w = 0; w < 4; w++)
        h[w] = _mm256_set_epi32(
            (int)st[7]->h[w], (int)st[6]->h[w], (int)st[5]->h[w],
            (int)st[4]->h[w], (int)st[3]->h[w], (int)st[2]->h[w],
            (int)st[1]->h[w], (int)st[0]->h[w]);
    for (uint64_t b = 0; b < nblocks; b++)
        md5_compress8(h, p, (size_t)(64 * b));
    uint32_t tmp[4][8];
    for (int w = 0; w < 4; w++)
        _mm256_storeu_si256((__m256i *)tmp[w], h[w]);
    for (int l = 0; l < 8; l++)
        for (int w = 0; w < 4; w++)
            st[l]->h[w] = tmp[w][l];
}

#endif /* GT_X86 */

/* Advance n independent MD5 states, 8 lanes in lockstep where
 * possible. Items with a partial buffered block or <64 bytes take the
 * scalar path; padding lanes replay lane 0 into a scratch state. */
void gt_md5_update_many(int64_t n, const uint8_t **ps,
                        const int64_t *lens, gt_md5 **sts) {
#ifdef GT_X86
    if (cpu_avx2 < 0)
        cpu_avx2 = __builtin_cpu_supports("avx2") ? 1 : 0;
    if (cpu_avx2 > 0) {
        int64_t i = 0;
        while (i < n) {
            int g = 0;
            int64_t gi[8];
            while (i < n && g < 8) {
                if (sts[i]->buflen == 0 && lens[i] >= 64)
                    gi[g++] = i;
                else
                    gt_md5_update(sts[i], ps[i], (uint64_t)lens[i]);
                i++;
            }
            if (g >= 2) {
                uint64_t minblocks = (uint64_t)lens[gi[0]] / 64;
                for (int j = 1; j < g; j++) {
                    uint64_t nb = (uint64_t)lens[gi[j]] / 64;
                    if (nb < minblocks)
                        minblocks = nb;
                }
                gt_md5 dummy;
                gt_md5_init(&dummy);
                gt_md5 *s8[8];
                const uint8_t *p8[8];
                for (int j = 0; j < 8; j++) {
                    s8[j] = j < g ? sts[gi[j]] : &dummy;
                    p8[j] = ps[gi[j < g ? j : 0]];
                }
                md5_blocks8(s8, p8, minblocks);
                for (int j = 0; j < g; j++) {
                    gt_md5 *st = sts[gi[j]];
                    st->nbytes += 64 * minblocks;
                    uint64_t rem = (uint64_t)lens[gi[j]] - 64 * minblocks;
                    if (rem)
                        gt_md5_update(st, ps[gi[j]] + 64 * minblocks, rem);
                }
            } else if (g == 1) {
                gt_md5_update(sts[gi[0]], ps[gi[0]],
                              (uint64_t)lens[gi[0]]);
            }
        }
        return;
    }
#endif
    for (int64_t i = 0; i < n; i++)
        gt_md5_update(sts[i], ps[i], (uint64_t)lens[i]);
}

/* Batched fused op for the feeder: advance each md5 state (8-way
 * across items) and write blake3(item) to outs + 32*i. */
void gt_b3_md5_many(int64_t n, const uint8_t **ps, const int64_t *lens,
                    gt_md5 **sts, uint8_t *outs) {
    gt_md5_update_many(n, ps, lens, sts);
    for (int64_t i = 0; i < n; i++)
        b3_hash(ps[i], (uint64_t)lens[i], outs + 32 * i);
}

/* ---- fused BLAKE3 + MD5, one pass over the block ---- */

/* Spec-tree reduction over an array of chunk CVs (left subtree = the
 * largest power of two strictly below n). Segments are disjoint, so
 * the 8-way level loop may reduce power-of-two runs in place. */
static void cv_tree_reduce(uint32_t (*cvs)[8], uint64_t n, int root,
                           uint32_t out[8]) {
    if (n == 1) {
        memcpy(out, cvs[0], 32);
        return;
    }
#ifdef GT_X86
    if (cpu_avx2 > 0 && !root && n >= 16 && (n & (n - 1)) == 0) {
        uint64_t w = n;
        while (w > 1) {
            uint64_t half = w / 2, i = 0;
            for (; i + 8 <= half; i += 8)
                parents8_cv((const uint32_t(*)[8]) & cvs[2 * i], &cvs[i]);
            for (; i < half; i++)
                parent_cv(cvs[2 * i], cvs[2 * i + 1], 0, cvs[i]);
            w = half;
        }
        memcpy(out, cvs[0], 32);
        return;
    }
#endif
    uint64_t left = 1;
    while (left * 2 < n)
        left *= 2;
    uint32_t l[8], r[8];
    cv_tree_reduce(cvs, left, 0, l);
    cv_tree_reduce(cvs + left, n - left, 0, r);
    parent_cv(l, r, root, out);
}

/* BLAKE3 digest of data[0..len) AND md5-advance `st` by the same
 * bytes, interleaved in 16 KiB windows so both digests read each
 * window while it is cache-resident: one RAM traversal instead of
 * two. Returns the blake3 digest in out32. */
void gt_b3_md5_block(const uint8_t *data, uint64_t len, gt_md5 *st,
                     uint8_t out32[32]) {
    uint64_t nchunks = len == 0 ? 1 : (len + CHUNK_LEN - 1) / CHUNK_LEN;
    if (nchunks == 1) {
        gt_md5_update(st, data, len);
        uint32_t cv[8];
        chunk_cv(data, (size_t)len, 0, 1, cv);
        for (int i = 0; i < 8; i++) {
            out32[4 * i] = (uint8_t)cv[i];
            out32[4 * i + 1] = (uint8_t)(cv[i] >> 8);
            out32[4 * i + 2] = (uint8_t)(cv[i] >> 16);
            out32[4 * i + 3] = (uint8_t)(cv[i] >> 24);
        }
        return;
    }
    uint32_t (*cvs)[8] = malloc(sizeof(uint32_t[8]) * (size_t)nchunks);
    if (!cvs) { /* degraded two-pass path */
        gt_md5_update(st, data, len);
        b3_hash(data, len, out32);
        return;
    }
#ifdef GT_X86
    if (cpu_avx2 < 0)
        cpu_avx2 = __builtin_cpu_supports("avx2") ? 1 : 0;
#endif
    uint64_t full = len / CHUNK_LEN;       /* # full 1 KiB chunks */
    uint64_t c = 0;
    const uint64_t WIN = 16;               /* chunks per window, 16 KiB */
    while (c < full) {
        uint64_t end = c + WIN < full ? c + WIN : full;
        gt_md5_update(st, data + c * CHUNK_LEN, (end - c) * CHUNK_LEN);
        uint64_t i = c;
#ifdef GT_X86
        if (cpu_avx2 > 0)
            for (; i + 8 <= end && i + 8 <= 0xFFFFFFFFu; i += 8) {
                const uint8_t *p[8];
                for (int l8 = 0; l8 < 8; l8++)
                    p[l8] = data + (size_t)(i + l8) * CHUNK_LEN;
                chunks8_cv(p, i, &cvs[i]);
            }
#endif
        for (; i < end; i++)
            chunk_cv(data + (size_t)i * CHUNK_LEN, CHUNK_LEN, i, 0,
                     cvs[i]);
        c = end;
    }
    if (nchunks > full) {                  /* partial tail chunk */
        gt_md5_update(st, data + full * CHUNK_LEN, len - full * CHUNK_LEN);
        chunk_cv(data + (size_t)full * CHUNK_LEN,
                 (size_t)(len - full * CHUNK_LEN), full, 0, cvs[full]);
    }
    uint32_t cv[8];
    cv_tree_reduce(cvs, nchunks, 1, cv);
    free(cvs);
    for (int i = 0; i < 8; i++) {
        out32[4 * i] = (uint8_t)cv[i];
        out32[4 * i + 1] = (uint8_t)(cv[i] >> 8);
        out32[4 * i + 2] = (uint8_t)(cv[i] >> 16);
        out32[4 * i + 3] = (uint8_t)(cv[i] >> 24);
    }
}

/* ================= GF(2^8), poly 0x11D ================= */

static uint8_t GFMUL[256][256];
static int gf_ready = 0;

static void gf_init(void) {
    uint8_t exp[512];
    int log[256];
    int x = 1;
    for (int i = 0; i < 255; i++) {
        exp[i] = (uint8_t)x;
        log[x] = i;
        x <<= 1;
        if (x & 0x100)
            x ^= 0x11D;
    }
    for (int i = 255; i < 512; i++)
        exp[i] = exp[i - 255];
    for (int a = 0; a < 256; a++) {
        GFMUL[0][a] = 0;
        GFMUL[a][0] = 0;
    }
    for (int a = 1; a < 256; a++)
        for (int b = 1; b < 256; b++)
            GFMUL[a][b] = exp[log[a] + log[b]];
    gf_ready = 1;
}

/* ================= reflected CRCs (slice-by-8) =================
 * crc32c (Castagnoli, poly 0x82F63B78 reflected) and CRC-64/NVME
 * (poly 0x9A6C9329AC4BC9B5 reflected) for the S3 x-amz-checksum-*
 * framework (ref: src/api/common/signature/checksum.rs). */

static uint32_t C32C_T[8][256];
static uint64_t C64_T[8][256];
static int crc_ready = 0;

static void crc_init(void) {
    for (int i = 0; i < 256; i++) {
        uint32_t c = (uint32_t)i;
        uint64_t d = (uint64_t)i;
        for (int k = 0; k < 8; k++) {
            c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
            d = (d & 1) ? (d >> 1) ^ 0x9A6C9329AC4BC9B5ull : d >> 1;
        }
        C32C_T[0][i] = c;
        C64_T[0][i] = d;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t c = C32C_T[0][i];
        uint64_t d = C64_T[0][i];
        for (int s = 1; s < 8; s++) {
            c = C32C_T[0][c & 0xFF] ^ (c >> 8);
            d = C64_T[0][d & 0xFF] ^ (d >> 8);
            C32C_T[s][i] = c;
            C64_T[s][i] = d;
        }
    }
    crc_ready = 1;
}

#ifdef GT_X86
/* SSE4.2 CRC32C: the crc32 instruction computes the Castagnoli
 * polynomial directly, ~20x the slice-by-8 table walk. */
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(uint32_t crc, const uint8_t *p, uint64_t len) {
    uint64_t c = ~crc;
    while (len >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        c = _mm_crc32_u64(c, w);
        p += 8;
        len -= 8;
    }
    uint32_t c32 = (uint32_t)c;
    while (len--)
        c32 = _mm_crc32_u8(c32, *p++);
    return ~c32;
}

#endif

uint32_t crc32c_update(uint32_t crc, const uint8_t *p, uint64_t len) {
#ifdef GT_X86
    if (cpu_sse42 < 0)
        cpu_sse42 = __builtin_cpu_supports("sse4.2") ? 1 : 0;
    if (cpu_sse42)
        return crc32c_hw(crc, p, len);
#endif
    if (!crc_ready)
        crc_init();
    crc = ~crc;
    while (len >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        w ^= crc; /* little-endian host assumed (x86/arm) */
        crc = C32C_T[7][w & 0xFF] ^ C32C_T[6][(w >> 8) & 0xFF] ^
              C32C_T[5][(w >> 16) & 0xFF] ^ C32C_T[4][(w >> 24) & 0xFF] ^
              C32C_T[3][(w >> 32) & 0xFF] ^ C32C_T[2][(w >> 40) & 0xFF] ^
              C32C_T[1][(w >> 48) & 0xFF] ^ C32C_T[0][(w >> 56) & 0xFF];
        p += 8;
        len -= 8;
    }
    while (len--)
        crc = C32C_T[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

uint64_t crc64nvme_update(uint64_t crc, const uint8_t *p, uint64_t len) {
    if (!crc_ready)
        crc_init();
    crc = ~crc;
    while (len >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        w ^= crc;
        crc = C64_T[7][w & 0xFF] ^ C64_T[6][(w >> 8) & 0xFF] ^
              C64_T[5][(w >> 16) & 0xFF] ^ C64_T[4][(w >> 24) & 0xFF] ^
              C64_T[3][(w >> 32) & 0xFF] ^ C64_T[2][(w >> 40) & 0xFF] ^
              C64_T[1][(w >> 48) & 0xFF] ^ C64_T[0][(w >> 56) & 0xFF];
        p += 8;
        len -= 8;
    }
    while (len--)
        crc = C64_T[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

/* Nibble tables for the PSHUFB formulation (ISA-L style): for each
 * coefficient c, NIB[c] holds two 16-byte tables L, H with
 * c*v = L[v & 0xF] ^ H[v >> 4]. 8 KiB total, built with GFMUL. */
static uint8_t NIB[256][32];
static int nib_ready = 0;

static void nib_init(void) {
    if (!gf_ready)
        gf_init();
    for (int c = 0; c < 256; c++) {
        for (int v = 0; v < 16; v++) {
            NIB[c][v] = GFMUL[c][v];
            NIB[c][16 + v] = GFMUL[c][v << 4];
        }
    }
    nib_ready = 1;
}

static void gf_axpy_scalar(uint8_t c, const uint8_t *x, uint8_t *o,
                           int64_t n) {
    const uint8_t *tab = GFMUL[c];
    if (c == 1) {
        for (int64_t t = 0; t < n; t++)
            o[t] ^= x[t];
    } else {
        for (int64_t t = 0; t < n; t++)
            o[t] ^= tab[x[t]];
    }
}

#ifdef GT_X86
/* o[0..n) ^= c * x[0..n) over GF(2^8), 32 bytes per step. */
__attribute__((target("avx2")))
static void gf_axpy_avx2(uint8_t c, const uint8_t *x, uint8_t *o,
                         int64_t n) {
    __m256i lo = _mm256_broadcastsi128_si256(
        _mm_loadu_si128((const __m128i *)NIB[c]));
    __m256i hi = _mm256_broadcastsi128_si256(
        _mm_loadu_si128((const __m128i *)(NIB[c] + 16)));
    __m256i mask = _mm256_set1_epi8(0x0F);
    int64_t t = 0;
    for (; t + 32 <= n; t += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i *)(x + t));
        __m256i vl = _mm256_and_si256(v, mask);
        __m256i vh = _mm256_and_si256(_mm256_srli_epi64(v, 4), mask);
        __m256i p = _mm256_xor_si256(_mm256_shuffle_epi8(lo, vl),
                                     _mm256_shuffle_epi8(hi, vh));
        __m256i acc = _mm256_loadu_si256((const __m256i *)(o + t));
        _mm256_storeu_si256((__m256i *)(o + t), _mm256_xor_si256(acc, p));
    }
    if (t < n)
        gf_axpy_scalar(c, x + t, o + t, n - t);
}
#endif

static void gf_axpy(uint8_t c, const uint8_t *x, uint8_t *o, int64_t n) {
    if (c == 0)
        return;
#ifdef GT_X86
    if (cpu_avx2 < 0)
        cpu_avx2 = __builtin_cpu_supports("avx2") ? 1 : 0;
    if (cpu_avx2 && c != 1 && n >= 64) {
        gf_axpy_avx2(c, x, o, n);
        return;
    }
#endif
    gf_axpy_scalar(c, x, o, n);
}

/* Tiled r x s GF(2^8) matmul over strided rows. Column tiles sized so
 * the r output tiles stay cache-resident while each input tile is read
 * once from memory (the naive row-major loop re-streams every input row
 * per output row: ~3*r*s*n bytes of traffic vs ~(s+r)*n here). Inner
 * loop order is j-then-i so a just-loaded input tile feeds all r
 * outputs from L1. */
#define GF_TILE 16384
#define GF_MAXROWS 256
static void gf_matmul_tiled(const uint8_t *mat, int64_t r, int64_t s,
                            const uint8_t *const *xrows,
                            uint8_t *const *orows, int64_t n) {
    for (int64_t t0 = 0; t0 < n; t0 += GF_TILE) {
        int64_t tn = n - t0 < GF_TILE ? n - t0 : GF_TILE;
        for (int64_t i = 0; i < r; i++)
            memset(orows[i] + t0, 0, (size_t)tn);
        for (int64_t j = 0; j < s; j++)
            for (int64_t i = 0; i < r; i++)
                gf_axpy(mat[i * s + j], xrows[j] + t0, orows[i] + t0, tn);
    }
}

/* out (r, n) = mat (r, s) @ x (s, n) over GF(2^8); rows contiguous. */
void gf256_matmul(const uint8_t *mat, int64_t r, int64_t s,
                  const uint8_t *x, int64_t n, uint8_t *out) {
    if (!nib_ready)
        nib_init();
    if (r <= GF_MAXROWS && s <= GF_MAXROWS && r > 1) {
        const uint8_t *xr[GF_MAXROWS];
        uint8_t *or_[GF_MAXROWS];
        for (int64_t j = 0; j < s; j++)
            xr[j] = x + j * n;
        for (int64_t i = 0; i < r; i++)
            or_[i] = out + i * n;
        gf_matmul_tiled(mat, r, s, xr, or_, n);
        return;
    }
    for (int64_t i = 0; i < r; i++) {
        uint8_t *o = out + i * n;
        memset(o, 0, (size_t)n);
        for (int64_t j = 0; j < s; j++)
            gf_axpy(mat[i * s + j], x + j * n, o, n);
    }
}

/* ================= one-call packed RS encode =================
 * The PUT hot path: split `block` (block_len bytes) into k shards of
 * shard_len (zero-padded tail), compute m parity shards with pmat
 * (m x k, row-major), and emit k+m ready-to-send shard payloads at
 * out + i*(16 + shard_len), each framed as the block store's shard
 * file format (block/manager.py pack_shard, crc32c flavor):
 *   [magic "GTS2"][block_len u64 BE][crc32c u32 BE][shard bytes]
 * One GIL-released call replaces split_stripe + gf_matmul + per-shard
 * pack_shard/crc (VERDICT r3 task 1: the kernel<->system gap). */
void rs_encode_block_packed(const uint8_t *pfx, int64_t pfx_len,
                            const uint8_t *block, int64_t data_len,
                            int64_t k, int64_t m, const uint8_t *pmat,
                            int64_t shard_len, uint8_t *out) {
    const int64_t stride = 16 + shard_len;
    const int64_t block_len = pfx_len + data_len;
    /* data shards: copy straight from the logical stream pfx||block,
     * zero-padding the tail (pfx is the 1-byte DataBlock header — taking
     * it separately saves the caller a full-block concat copy) */
    for (int64_t i = 0; i < k; i++) {
        uint8_t *dst = out + i * stride + 16;
        int64_t off = i * shard_len;
        int64_t want = shard_len;
        if (off < pfx_len) {
            int64_t n = pfx_len - off < want ? pfx_len - off : want;
            memcpy(dst, pfx + off, (size_t)n);
            dst += n;
            off += n;
            want -= n;
        }
        if (want > 0) {
            int64_t doff = off - pfx_len;
            int64_t have = data_len - doff;
            if (have > want)
                have = want;
            if (have > 0) {
                memcpy(dst, block + doff, (size_t)have);
                dst += have;
                want -= have;
            }
            if (want > 0)
                memset(dst, 0, (size_t)want);
        }
    }
    /* parity shards from the in-place data shards (tiled: each data
     * tile read once, all m parity tiles cache-resident) */
    if (!nib_ready)
        nib_init();
    if (k <= GF_MAXROWS && m <= GF_MAXROWS) {
        const uint8_t *xr[GF_MAXROWS];
        uint8_t *or_[GF_MAXROWS];
        for (int64_t j = 0; j < k; j++)
            xr[j] = out + j * stride + 16;
        for (int64_t i = 0; i < m; i++)
            or_[i] = out + (k + i) * stride + 16;
        gf_matmul_tiled(pmat, m, k, xr, or_, shard_len);
    } else {
        for (int64_t i = 0; i < m; i++) {
            uint8_t *o = out + (k + i) * stride + 16;
            memset(o, 0, (size_t)shard_len);
            for (int64_t j = 0; j < k; j++)
                gf_axpy(pmat[i * k + j], out + j * stride + 16, o,
                        shard_len);
        }
    }
    /* headers */
    for (int64_t i = 0; i < k + m; i++) {
        uint8_t *h = out + i * stride;
        h[0] = 'G'; h[1] = 'T'; h[2] = 'S'; h[3] = '2';
        uint64_t bl = (uint64_t)block_len;
        for (int b = 0; b < 8; b++)
            h[4 + b] = (uint8_t)(bl >> (56 - 8 * b));
        uint32_t ck = crc32c_update(0, h + 16, (uint64_t)shard_len);
        h[12] = (uint8_t)(ck >> 24); h[13] = (uint8_t)(ck >> 16);
        h[14] = (uint8_t)(ck >> 8); h[15] = (uint8_t)ck;
    }
}
