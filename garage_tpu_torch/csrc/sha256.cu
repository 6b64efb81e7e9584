// Batched SHA-256 on Hopper: kernel S2 (sha256_rows) of the S3 front
// end's SigV4 aws-chunked verifier.
//
// Replaces: garage_tpu/ops/sha256.py:hash_rows (jitted by hash_fn), the
// XLA program that hashes the chunks of STREAMING-AWS4-HMAC-SHA256-
// PAYLOAD bodies so their chunk signatures can be checked.
//
// What bounds it: latency, not bytes. SHA-256 cannot be split inside a
// message: a 64 KiB chunk is 1,025 compressions in sequence, each 64
// dependent rounds whose critical path through `e` is about four
// dependent integer instructions. One message therefore takes ~1 M
// cycles whatever the batch, while the batch's bytes (read once) and
// its ~1,400 instructions per compression are far below the card's
// rates at the path's batch (8-256 rows).
//
// Design: one thread per message. The 16-word schedule ring and the 8
// state words sit in registers (the 64 rounds are fully unrolled, so
// every ring index is a constant); K sits in __constant__ and is read
// at a constant index per round; each 64-byte block is four 16-byte
// vector loads, byte-swapped with __byte_perm; rotates are
// __funnelshift_r. The block count is runtime data (one build serves
// every chunk size); the host writes the SHA padding (0x80, zeros,
// 64-bit big-endian bit length) at the true end, and the kernel reads
// only the row's active blocks. The digest is written as its 32 bytes.
//
// C ABI (loaded with ctypes): the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

__constant__ uint32_t K256[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u,
    0x3956C25Bu, 0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u,
    0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u,
    0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u,
    0xC6E00BF3u, 0xD5A79147u, 0x06CA6351u, 0x14292967u,
    0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u,
    0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u,
    0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu, 0x682E6FF3u,
    0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
    return __funnelshift_r(x, x, n);
}

// big-endian <-> little-endian word
__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
    return __byte_perm(x, 0, 0x0123);
}

__global__ void __launch_bounds__(128)
sha256_rows(const uint8_t *__restrict__ msgs, long long width,
            const int *__restrict__ nblocks, int B,
            uint8_t *__restrict__ out) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= B) return;
    const uint4 *p = reinterpret_cast<const uint4 *>(msgs + (long long)row * width);
    long long nb = nblocks[row];
    const long long cap = width / 64;
    if (nb > cap) nb = cap;  // never read past the row

    uint32_t h0 = 0x6A09E667u, h1 = 0xBB67AE85u, h2 = 0x3C6EF372u,
             h3 = 0xA54FF53Au, h4 = 0x510E527Fu, h5 = 0x9B05688Cu,
             h6 = 0x1F83D9ABu, h7 = 0x5BE0CD19u;

    for (long long blk = 0; blk < nb; ++blk) {
        uint32_t w[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint4 v = __ldg(p + blk * 4 + q);
            w[4 * q + 0] = bswap32(v.x);
            w[4 * q + 1] = bswap32(v.y);
            w[4 * q + 2] = bswap32(v.z);
            w[4 * q + 3] = bswap32(v.w);
        }
        uint32_t a = h0, b = h1, c = h2, d = h3,
                 e = h4, f = h5, g = h6, h = h7;
#pragma unroll
        for (int t = 0; t < 64; ++t) {
            uint32_t wt;
            if (t < 16) {
                wt = w[t];
            } else {
                const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
                const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
                const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
                wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
                w[t & 15] = wt;
            }
            const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
            const uint32_t ch = (e & f) ^ (~e & g);
            const uint32_t t1 = h + S1 + ch + K256[t] + wt;
            const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
            const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            h = g;
            g = f;
            f = e;
            e = d + t1;
            d = c;
            c = b;
            b = a;
            a = t1 + S0 + maj;
        }
        h0 += a; h1 += b; h2 += c; h3 += d;
        h4 += e; h5 += f; h6 += g; h7 += h;
    }
    uint4 *o = reinterpret_cast<uint4 *>(out + (long long)row * 32);
    o[0] = make_uint4(bswap32(h0), bswap32(h1), bswap32(h2), bswap32(h3));
    o[1] = make_uint4(bswap32(h4), bswap32(h5), bswap32(h6), bswap32(h7));
}

// msgs: (B, width) u8, width a multiple of 64, rows 16-byte aligned;
// nblocks: (B,) i32; out: (B, 32) u8.
extern "C" int gt_sha256_rows(const void *msgs, long long width,
                              const void *nblocks, int B, void *out,
                              void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    sha256_rows<<<(unsigned)((B + 127) / 128), 128, 0, s>>>(
        (const uint8_t *)msgs, width, (const int *)nblocks, B,
        (uint8_t *)out);
    return (int)cudaGetLastError();
}
