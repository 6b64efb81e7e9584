// Batched BLAKE3-256 on Hopper: kernel B3 (blake3_rows) of the block
// data path.
//
// Replaces: garage_tpu/ops/treehash.py:hash_rows (with _compress_lanes
// and the jitted hash_fn), the XLA program that hashes every block on
// PUT and on scrub.
//
// What bounds it: the integer ALU. A 1 MiB row is 1024 chunks of 16
// compressions plus 1023 parent compressions, ~17.4 k compressions of
// ~800 32-bit adds, XORs and rotates each; the bytes (the row read
// once) take less time than that at 3.35 TB/s.
//
// Design, two passes:
//  1. blake3_chunks: one thread per 1 KiB chunk. The thread keeps its
//     16-word message block and 16-word state in registers through the
//     chunk's (up to) 16 compressions of 7 fully unrolled rounds, with
//     CHUNK_START, CHUNK_END (and ROOT when the row is a single chunk)
//     and the chunk index as counter; bytes past the row's length are
//     masked to zero. It writes (B, C, 8) u32 chaining values.
//  2. blake3_tree: one block per row merges the parent tree level by
//     level — pairs left to right, the odd tail carried up unchanged —
//     exactly as treehash.py does, ping-ponging between the chaining
//     values and a scratch buffer; PARENT on every merge, ROOT on the
//     last. It works for any chunk count C >= 1.
//
// C ABI (loaded with ctypes): the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK_START 1u
#define CHUNK_END 2u
#define PARENT 4u
#define ROOT 8u

#define IV0 0x6A09E667u
#define IV1 0xBB67AE85u
#define IV2 0x3C6EF372u
#define IV3 0xA54FF53Au
#define IV4 0x510E527Fu
#define IV5 0x9B05688Cu
#define IV6 0x1F83D9ABu
#define IV7 0x5BE0CD19u

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
    return __funnelshift_r(x, x, n);
}

#define G(a, b, c, d, mx, my)                 \
    do {                                      \
        v[a] = v[a] + v[b] + (mx);            \
        v[d] = rotr32(v[d] ^ v[a], 16);       \
        v[c] = v[c] + v[d];                   \
        v[b] = rotr32(v[b] ^ v[c], 12);       \
        v[a] = v[a] + v[b] + (my);            \
        v[d] = rotr32(v[d] ^ v[a], 8);        \
        v[c] = v[c] + v[d];                   \
        v[b] = rotr32(v[b] ^ v[c], 7);        \
    } while (0)

// cv <- compress(cv, m, counter, block_len, flags), the 8-word output.
__device__ __forceinline__ void compress(uint32_t cv[8], const uint32_t msg[16],
                                         uint32_t counter, uint32_t block_len,
                                         uint32_t flags) {
    uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                      IV0, IV1, IV2, IV3, counter, 0u, block_len, flags};
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 16; i++)
        m[i] = msg[i];
#pragma unroll
    for (int round = 0; round < 7; round++) {
        G(0, 4, 8, 12, m[0], m[1]);
        G(1, 5, 9, 13, m[2], m[3]);
        G(2, 6, 10, 14, m[4], m[5]);
        G(3, 7, 11, 15, m[6], m[7]);
        G(0, 5, 10, 15, m[8], m[9]);
        G(1, 6, 11, 12, m[10], m[11]);
        G(2, 7, 8, 13, m[12], m[13]);
        G(3, 4, 9, 14, m[14], m[15]);
        // message permutation (2,6,3,10,7,0,4,13,1,11,12,5,9,14,15,8)
        uint32_t t[16] = {m[2], m[6], m[3], m[10], m[7], m[0], m[4], m[13],
                          m[1], m[11], m[12], m[5], m[9], m[14], m[15], m[8]};
#pragma unroll
        for (int i = 0; i < 16; i++)
            m[i] = t[i];
    }
#pragma unroll
    for (int i = 0; i < 8; i++)
        cv[i] = v[i] ^ v[i + 8];
}

__device__ __forceinline__ void set_iv(uint32_t cv[8]) {
    cv[0] = IV0; cv[1] = IV1; cv[2] = IV2; cv[3] = IV3;
    cv[4] = IV4; cv[5] = IV5; cv[6] = IV6; cv[7] = IV7;
}

// Pass 1: cvs[b][c] = chaining value of chunk c of row b.
__global__ void __launch_bounds__(128)
blake3_chunks(const uint8_t *msgs, long long row_stride, const int *lengths,
              int B, int C, uint32_t *cvs) {
    long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (gid >= (long long)B * C)
        return;
    const int b = (int)(gid / C);
    const int c = (int)(gid % C);
    long long chunk_len = (long long)lengths[b] - (long long)c * 1024;
    chunk_len = chunk_len < 0 ? 0 : (chunk_len > 1024 ? 1024 : chunk_len);
    const int n_blocks = chunk_len == 0 ? 1 : (int)((chunk_len + 63) / 64);
    const uint8_t *p = msgs + (long long)b * row_stride + (long long)c * 1024;
    uint32_t cv[8];
    set_iv(cv);
#pragma unroll 1
    for (int blk = 0; blk < n_blocks; blk++) {
        uint32_t m[16];
        const uint4 *q = reinterpret_cast<const uint4 *>(p + blk * 64);
#pragma unroll
        for (int i = 0; i < 4; i++) {
            uint4 w = q[i];
            m[4 * i] = w.x; m[4 * i + 1] = w.y; m[4 * i + 2] = w.z; m[4 * i + 3] = w.w;
        }
        int blen = (int)(chunk_len - blk * 64);
        blen = blen > 64 ? 64 : blen;
        if (blen < 64) {  // zero the bytes past the message end
#pragma unroll
            for (int i = 0; i < 16; i++) {
                int nb = blen - 4 * i;
                if (nb <= 0)
                    m[i] = 0u;
                else if (nb < 4)
                    m[i] &= (1u << (8 * nb)) - 1u;
            }
        }
        uint32_t flags = (blk == 0 ? CHUNK_START : 0u)
                       | (blk == n_blocks - 1 ? (CHUNK_END | (C == 1 ? ROOT : 0u)) : 0u);
        compress(cv, m, (uint32_t)c, (uint32_t)blen, flags);
    }
    uint32_t *o = cvs + gid * 8;
#pragma unroll
    for (int i = 0; i < 8; i++)
        o[i] = cv[i];
}

// Pass 2: merge row b's C chaining values into its root -> out[b][0..8).
__global__ void __launch_bounds__(256)
blake3_tree(uint32_t *cvs, uint32_t *scratch, int C, uint32_t *out) {
    const int b = blockIdx.x;
    uint32_t *src = cvs + (long long)b * C * 8;
    uint32_t *dst = scratch + (long long)b * ((C + 1) / 2) * 8;
    if (C == 1) {  // pass 1 already applied ROOT
        for (int i = threadIdx.x; i < 8; i += blockDim.x)
            out[b * 8 + i] = src[i];
        return;
    }
    int n = C;
    while (n > 2) {
        const int pairs = n / 2;
        for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
            uint32_t m[16], cv[8];
#pragma unroll
            for (int i = 0; i < 16; i++)
                m[i] = src[p * 16 + i];
            set_iv(cv);
            compress(cv, m, 0u, 64u, PARENT);
#pragma unroll
            for (int i = 0; i < 8; i++)
                dst[p * 8 + i] = cv[i];
        }
        if (n & 1)  // odd tail carried up
            for (int i = threadIdx.x; i < 8; i += blockDim.x)
                dst[pairs * 8 + i] = src[(n - 1) * 8 + i];
        __syncthreads();
        n = pairs + (n & 1);
        uint32_t *t = src;
        src = dst;
        dst = t;
    }
    if (threadIdx.x == 0) {
        uint32_t m[16], cv[8];
#pragma unroll
        for (int i = 0; i < 16; i++)
            m[i] = src[i];
        set_iv(cv);
        compress(cv, m, 0u, 64u, PARENT | ROOT);
#pragma unroll
        for (int i = 0; i < 8; i++)
            out[b * 8 + i] = cv[i];
    }
}

// msgs (B, row_stride) u8 with row_stride >= C*1024 and a multiple of 16,
// lengths (B,) i32 with ceil(len/1024) == C (pad rows: len = C*1024);
// cvs (B*C*8) and scratch (B*ceil(C/2)*8) u32 workspace; out (B, 8) u32.
extern "C" int gt_blake3_rows(const void *msgs, long long row_stride,
                              const void *lengths, int B, int C, void *cvs,
                              void *scratch, void *out, void *stream) {
    if (B < 0 || C < 1 || row_stride < (long long)C * 1024 || row_stride % 16)
        return (int)cudaErrorInvalidValue;
    if (B == 0)
        return 0;
    cudaStream_t s = (cudaStream_t)stream;
    long long lanes = (long long)B * C;
    blake3_chunks<<<(unsigned)((lanes + 127) / 128), 128, 0, s>>>(
        (const uint8_t *)msgs, row_stride, (const int *)lengths, B, C,
        (uint32_t *)cvs);
    int err = (int)cudaGetLastError();
    if (err)
        return err;
    blake3_tree<<<(unsigned)B, 256, 0, s>>>((uint32_t *)cvs, (uint32_t *)scratch,
                                            C, (uint32_t *)out);
    return (int)cudaGetLastError();
}
