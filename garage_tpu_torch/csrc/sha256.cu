// Batched SHA-256 on Hopper: kernel S2 (sha256_rows) of the S3 front
// end's SigV4 aws-chunked verifier.
//
// Replaces: garage_tpu/ops/sha256.py:hash_rows (jitted by hash_fn), the
// XLA program that hashes the chunks of STREAMING-AWS4-HMAC-SHA256-
// PAYLOAD bodies so their chunk signatures can be checked.
//
// What bounds it: the dependent chain, not bytes. SHA-256 cannot be
// split inside a message: a 64 KiB chunk is 1,025 compressions in
// sequence, each 64 dependent rounds. Through `e` a round is at best one
// funnel-shift rotate -> one LOP3 (Sigma1 of the three rotates, with ch
// beside it) -> one IADD3 (d + h + K + W folded in ahead); 6, 11 and 25
// are not byte rotations, so no shorter chain exists on sm_90. So a
// message takes at least blocks x 64 x (that chain's cycles) whatever
// the batch; `gt_sha256_chain_cycles` times the chain on the card
// (one thread, clock64) so the bound comes from a measurement. The
// batch's bytes and its all-lanes instruction count sit far below that
// floor at the path's batch (8-256 rows).
//
// Design: warp-specialised, 64 threads per CTA, up to 32 messages per
// CTA (one lane each; a message never spans CTAs).
// - Producer, warp 1 (another scheduler than the consumer): lane L
//   brings message L's blocks into a shared-memory staging ring with
//   cp.async (16-byte copies, SHA_AHEAD blocks in flight per lane, each
//   lane waits on its own commit groups), byte-swaps the 16 words,
//   computes the 48 schedule steps and writes K[t] + W[t] for the 64
//   rounds into a slot of the K+W ring, laid out [slot][t / 4][lane][4]
//   so that 4 rounds' words are one conflict-free 16-byte store or load.
// - Consumer, warp 0: keeps the 8 state words in registers and runs only
//   the rounds: it loads a block's 64 words at once (16 vector LDS, so
//   no round waits on shared memory), then per round the folded h + KW,
//   d + h + KW and maj - d off the chain on the FMA pipe (IMAD), and the
//   rotate -> LOP3 -> IADD3 chain through e. Rotates, LOP3s and IADD3s
//   share the integer ALU pipe, which issues a warp instruction every
//   other clock: 12 of them a round put the consumer's issue floor near
//   24 cycles a round, above the measured chain.
// - Full and empty mbarriers (32 arrivals each, one per lane) guard each
//   of the SHA_SLOTS ring slots; the producer runs up to SHA_SLOTS blocks
//   ahead of the consumer.
// - Ragged rows: block counts are runtime data (one build serves every
//   chunk size). Both warps run to the CTA's longest message; a lane
//   whose message has ended copies nothing and leaves its state alone,
//   so no row is read past its own blocks. CTA c's lane L hashes row
//   32 c + L. The host writes the SHA padding; the digest is written as
//   its 32 big-endian bytes.
// - ptxas (sm_90a, CUDA 12.8): sha256_rows 40 registers, no spills,
//   SHA_SMEM = 49,216 B of dynamic shared memory per CTA.
//
// C ABI (loaded with ctypes): every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define SHA_LANES 32   // messages per CTA: one consumer lane each
#define SHA_SLOTS 4    // K+W ring slots (one block of 32 messages each)
#define SHA_AHEAD 8    // raw blocks in flight per producer lane
#define SHA_KW_BYTES (SHA_SLOTS * 64 * SHA_LANES * 4)    // 32 KiB
#define SHA_RAW_BYTES (SHA_AHEAD * 4 * SHA_LANES * 16)   // 16 KiB
#define SHA_SMEM (SHA_KW_BYTES + SHA_RAW_BYTES + 2 * SHA_SLOTS * 8)

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

// a * one + b on the FMA pipe (IMAD), `one` being 1 at run time: the
// integer ALU pipe, which runs the rotates, LOP3s and IADD3s, issues a
// warp instruction only every other clock (16 lanes per scheduler), so
// adds that the chain can spare go to the other pipe
__device__ __forceinline__ uint32_t fma_add(uint32_t a, uint32_t one,
                                            uint32_t b) {
    return a * one + b;
}

// big-endian <-> little-endian word
__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
    return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t *bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t *bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity) {
    asm volatile(
        "{\n\t"
        ".reg .pred P1;\n\t"
        "LAB_WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
        "@P1 bra DONE;\n\t"
        "bra LAB_WAIT;\n\t"
        "DONE:\n\t"
        "}\n"
        :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void cp_async16(void *dst, const void *src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Producer lane: stage block `blk` of its message (if it has one) into
// raw stage blk % SHA_AHEAD, as one commit group (empty past the end).
__device__ __forceinline__ void stage_block(uint4 *raw, const uint4 *src,
                                            int blk, int nb, int lane) {
    if (blk < nb) {
        uint4 *dst = raw + (blk % SHA_AHEAD) * 4 * SHA_LANES + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q)
            cp_async16(dst + q * SHA_LANES, src + (long long)blk * 4 + q);
    }
    cp_async_commit();
}

__device__ void sha_producer(uint32_t *kw, uint4 *raw, uint64_t *full,
                             uint64_t *empty, const uint4 *src, int nb,
                             int nmax, int lane, uint32_t one) {
    for (int p = 0; p < SHA_AHEAD; ++p)
        stage_block(raw, src, p, nb, lane);
    for (int blk = 0; blk < nmax; ++blk) {
        // groups committed: SHA_AHEAD + blk; block blk's is the oldest
        cp_async_wait<SHA_AHEAD - 1>();
        const uint4 *in = raw + (blk % SHA_AHEAD) * 4 * SHA_LANES + lane;
        uint32_t w[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint4 v = in[q * SHA_LANES];
            w[4 * q + 0] = bswap32(v.x);
            w[4 * q + 1] = bswap32(v.y);
            w[4 * q + 2] = bswap32(v.z);
            w[4 * q + 3] = bswap32(v.w);
        }
        const int slot = blk % SHA_SLOTS;
        mbar_wait(empty + slot, ((blk / SHA_SLOTS) & 1) ^ 1);
        uint4 *out = reinterpret_cast<uint4 *>(kw + slot * 64 * SHA_LANES) + lane;
        uint32_t k4[4];
#pragma unroll
        for (int t = 0; t < 64; ++t) {
            if (t >= 16) {
                const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
                const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
                const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
                w[t & 15] = fma_add(w[(t - 7) & 15], one, w[t & 15]) + s0 + s1;
            }
            k4[t & 3] = fma_add(w[t & 15], one, K256[t]);
            if ((t & 3) == 3)
                out[(t >> 2) * SHA_LANES] = make_uint4(k4[0], k4[1], k4[2], k4[3]);
        }
        mbar_arrive(full + slot);
        // the words of this stage are consumed: refill it
        stage_block(raw, src, blk + SHA_AHEAD, nb, lane);
    }
    cp_async_wait<0>();
}

__device__ void sha_consumer(const uint32_t *kw, uint64_t *full,
                             uint64_t *empty, int nb, int nmax,
                             int lane, uint8_t *dst, uint32_t one) {
    const uint32_t minus_one = 0u - one;
    uint32_t h0 = 0x6A09E667u, h1 = 0xBB67AE85u, h2 = 0x3C6EF372u,
             h3 = 0xA54FF53Au, h4 = 0x510E527Fu, h5 = 0x9B05688Cu,
             h6 = 0x1F83D9ABu, h7 = 0x5BE0CD19u;
    for (int blk = 0; blk < nmax; ++blk) {
        const int slot = blk % SHA_SLOTS;
        mbar_wait(full + slot, (blk / SHA_SLOTS) & 1);
        // the block's 64 K+W words in 16 vector loads, all in flight
        // before the first round
        const uint4 *in = reinterpret_cast<const uint4 *>(kw + slot * 64 * SHA_LANES) + lane;
        uint32_t kwt[64];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
            const uint4 v = in[q * SHA_LANES];
            kwt[4 * q] = v.x;
            kwt[4 * q + 1] = v.y;
            kwt[4 * q + 2] = v.z;
            kwt[4 * q + 3] = v.w;
        }
        uint32_t a = h0, b = h1, c = h2, d = h3,
                 e = h4, f = h5, g = h6, h = h7;
#pragma unroll
        for (int t = 0; t < 64; ++t) {
            // off the chain, on the FMA pipe: h and d are known rounds
            // ahead; a' = h + KW + S1 + ch + S0 + maj = e' + S0 + (maj - d)
            const uint32_t hk = fma_add(kwt[t], one, h);
            const uint32_t dhk = fma_add(d, one, hk);
            const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
            const uint32_t ch = (e & f) ^ (~e & g);
            const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
            const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            const uint32_t majd = fma_add(d, minus_one, maj);
            h = g;
            g = f;
            f = e;
            e = dhk + S1 + ch;
            d = c;
            c = b;
            b = a;
            a = e + S0 + majd;
        }
        mbar_arrive(empty + slot);
        if (blk < nb) {
            h0 += a; h1 += b; h2 += c; h3 += d;
            h4 += e; h5 += f; h6 += g; h7 += h;
        }
    }
    if (dst != nullptr) {
        uint4 *o = reinterpret_cast<uint4 *>(dst);
        o[0] = make_uint4(bswap32(h0), bswap32(h1), bswap32(h2), bswap32(h3));
        o[1] = make_uint4(bswap32(h4), bswap32(h5), bswap32(h6), bswap32(h7));
    }
}

__global__ void __launch_bounds__(2 * SHA_LANES)
sha256_rows(const uint8_t *__restrict__ msgs, long long width,
            const int *__restrict__ nblocks, int B,
            uint8_t *__restrict__ out, uint32_t one) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint32_t *kw = reinterpret_cast<uint32_t *>(smem);
    uint4 *raw = reinterpret_cast<uint4 *>(smem + SHA_KW_BYTES);
    uint64_t *full = reinterpret_cast<uint64_t *>(smem + SHA_KW_BYTES + SHA_RAW_BYTES);
    uint64_t *empty = full + SHA_SLOTS;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long row = (long long)blockIdx.x * SHA_LANES + lane;
    int nb = 0;
    if (row < B) {
        long long n = nblocks[row];
        const long long cap = width / 64;
        if (n > cap) n = cap;  // never read past the row
        nb = n > 0 ? (int)n : 0;
    }
    const int nmax = __reduce_max_sync(0xffffffffu, (unsigned)nb);
    if (threadIdx.x == 0) {
        for (int s = 0; s < SHA_SLOTS; ++s) {
            mbar_init(full + s, SHA_LANES);
            mbar_init(empty + s, SHA_LANES);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == 1) {
        const uint4 *src = row < B
            ? reinterpret_cast<const uint4 *>(msgs + row * width) : nullptr;
        sha_producer(kw, raw, full, empty, src, nb, nmax, lane, one);
    } else {
        sha_consumer(kw, full, empty, nb, nmax, lane,
                     row < B ? out + row * 32 : nullptr, one);
    }
}

// One thread times a dependent chain of the round's critical path,
// rotate (SHF) -> LOP3 -> IADD3, `steps` times: out[0] = clock64 cycles,
// out[1] = the chain's value (kept so nothing is optimised away).
__global__ void sha256_chain_cycles(long long *out, int steps, uint32_t seed) {
    uint32_t e = seed, f = seed * 2654435761u, g = seed ^ 0x5BD1E995u;
    const uint32_t fg = f + g;
    const long long t0 = clock64();
#pragma unroll 16
    for (int i = 0; i < steps; ++i) {
        uint32_t s, l;
        asm volatile("shf.r.wrap.b32 %0, %1, %1, 6;" : "=r"(s) : "r"(e));
        asm volatile("lop3.b32 %0, %1, %2, %3, 0x96;"
                     : "=r"(l) : "r"(s), "r"(f), "r"(g));
        asm volatile("add.u32 %0, %1, %2;" : "=r"(e) : "r"(l), "r"(fg));
    }
    const long long t1 = clock64();
    out[0] = t1 - t0;
    out[1] = e;
}

// msgs: (B, width) u8, width a multiple of 64, rows 16-byte aligned;
// nblocks: (B,) i32; out: (B, 32) u8.
extern "C" int gt_sha256_rows(const void *msgs, long long width,
                              const void *nblocks, int B, void *out,
                              void *stream) {
    if (B < 0 || width <= 0 || width % 64)
        return (int)cudaErrorInvalidValue;
    if (B == 0)
        return 0;
    int err = (int)cudaFuncSetAttribute(
        sha256_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, SHA_SMEM);
    if (err)
        return err;
    sha256_rows<<<(unsigned)((B + SHA_LANES - 1) / SHA_LANES), 2 * SHA_LANES,
                  SHA_SMEM, (cudaStream_t)stream>>>(
        (const uint8_t *)msgs, width, (const int *)nblocks, B,
        (uint8_t *)out, 1u);
    return (int)cudaGetLastError();
}

// out: 2 int64 on the device (see sha256_chain_cycles).
extern "C" int gt_sha256_chain_cycles(void *out, int steps, void *stream) {
    sha256_chain_cycles<<<1, 1, 0, (cudaStream_t)stream>>>(
        (long long *)out, steps, 0x9E3779B9u);
    return (int)cudaGetLastError();
}
