// Batched BLAKE3-256 on Hopper: kernel B3 (blake3_rows) of the block
// data path.
//
// Replaces: garage_tpu/ops/treehash.py:hash_rows (with _compress_lanes
// and the jitted hash_fn), the XLA program that hashes every block on
// PUT and on scrub.
//
// What bounds it. A 1 MiB row is 1024 chunks of 16 compressions plus
// 1023 parent compressions, each 7 rounds of 8 G steps of 12 integer
// instructions. Two floors:
// - At the PUT batch (8 rows) the dependent chain: a row's digest needs
//   16 + ceil(log2 C) compressions in series (a chunk's 16 blocks, then
//   one parent per tree level), and each is 14 G steps of 4 dependent
//   add -> xor -> rotate triples. `gt_blake3_chain_cycles` times one G
//   column's chain on the card (one thread, clock64) in the forms the
//   kernel compiles to, so the bound comes from a measurement.
// - At 256 rows the issue rate: the integer ALU pipe takes a warp
//   instruction only every other clock. There (more warps than the
//   SMs' schedulers) a G step's 4 adds go to the FMA pipe as IMAD
//   (fma_add, `one` = 1 at run time; a + m off the chain), leaving 8 on
//   the ALU pipe (4 LOP3, 2 PRMT for the rotates by 16 and 8, 2 SHF for
//   12 and 7) against 10 with the three-input adds as IADD3. The SMALL
//   instance (a warp per scheduler at most: each warp is latency-bound,
//   one compression ~1,370 cycles in one warp on an H100) keeps IADD3,
//   the shorter chain. SASS (sm_90a, CUDA 12.8) per compression, IMAD
//   form: 236 LOP3, 118 SHF, 112 PRMT on the ALU pipe, 379 IMAD (the
//   adds and register moves). Measured on an H100 (PERF.md): the IMAD
//   form 11 % faster at 256 rows, 5 % slower at 8.
//   The bytes (the row read once) take far less time than either.
//
// Design: one launch per call, the tree fused.
// - A CTA of W warps (1, 2 or 4) owns a block of 32 W consecutive
//   chunks of one row; thread i hashes chunk 32 W j + i. Its 16 message
//   words and 16 state words stay in registers through the chunk's 16
//   compressions. SMALL loads the next 64-byte block into a register
//   double buffer while the current one compresses, so no block waits a
//   full memory latency; the other instance loads each block when
//   needed and, 20 registers lighter (56), fits 9 CTAs an SM whose
//   warps hide the loads. Bytes past the row's length are masked to
//   zero; CHUNK_START, CHUNK_END (and ROOT when the row is one chunk)
//   and the chunk index as counter.
// - The CTA merges its chaining values level by level in shared memory
//   (aligned pairs, the odd tail carried up unchanged, one
//   __syncthreads a level): thread t makes parent t, so a level of p
//   pairs costs ceil(p / 32) warp-compressions, 8 for a block of 128
//   chunks. A first version merged each warp's 32 chunks by shuffles:
//   every warp then issues 5 full compressions for 31 parents, 20 per
//   128 chunks, and read slower than the two-kernel B3 at 256 rows. W
//   is a power of two, so a block starts on a subtree boundary and its
//   level-by-level merge is the global one: a full block yields the root
//   of its subtree, a partial last block the node the global tree
//   carries. When one block holds the row, its root is the row's root
//   (ROOT on the merge of the last two nodes).
// - Otherwise thread 0 writes the block root to a workspace of B x
//   blocks x 8 words, fences (__threadfence) and takes a ticket from the
//   row's counter (atomicAdd). The CTA that draws the last ticket
//   fences again; its warp 0 reads the row's block roots from L2
//   (ld.global.cg), merges them (by shuffles, in place in the workspace
//   while more than 32 remain), writes the digest with ROOT on the
//   final parent, and sets the counter back to 0, so the counters hold
//   no state between launches. No second kernel, no ping-pong through
//   device memory.
// - Geometry (gt_b3_plan): W is the power of two at or above B x
//   ceil(C / 32) / SMs, at most 4, and SMALL while B x ceil(C / 32) <= 4
//   x SMs: the PUT batch of 8 rows of 1 MiB runs 128 SMALL CTAs of 2
//   warps on 128 SMs, one row 32 of 1 warp, 256 rows 2,048 CTAs of 4
//   warps. ptxas registers: PERF.md.
//
// C ABI (loaded with ctypes): every entry returns cudaGetLastError().

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

#define B3_MAX_WARPS 4   // warps per CTA

// Rotates right: by 16 and 8 a byte permute (PRMT), by 12 and 7 a
// funnel shift (SHF).
__device__ __forceinline__ uint32_t rotr16(uint32_t x) {
    return __byte_perm(x, x, 0x1032);
}
__device__ __forceinline__ uint32_t rotr8(uint32_t x) {
    return __byte_perm(x, x, 0x0321);
}
__device__ __forceinline__ uint32_t rotr12(uint32_t x) {
    return __funnelshift_r(x, x, 12);
}
__device__ __forceinline__ uint32_t rotr7(uint32_t x) {
    return __funnelshift_r(x, x, 7);
}

// a * one + b on the FMA pipe (IMAD), `one` being 1 at run time: the
// integer ALU pipe, which runs the IADD3s, LOP3s, PRMTs and SHFs,
// issues a warp instruction only every other clock
__device__ __forceinline__ uint32_t fma_add(uint32_t a, uint32_t one,
                                            uint32_t b) {
    return a * one + b;
}

// a + b + m: one IADD3 on the ALU pipe (SMALL: the shorter chain), or
// two IMADs on the FMA pipe, a + m off the chain (the ALU pipe's issue
// rate bounds a full card)
template <bool SMALL>
__device__ __forceinline__ uint32_t add3(uint32_t a, uint32_t b, uint32_t m,
                                         uint32_t one) {
    return SMALL ? a + b + m : fma_add(b, one, fma_add(m, one, a));
}

// One G step; c += d on the FMA pipe
#define G(a, b, c, d, mx, my)                                   \
    do {                                                        \
        v[a] = add3<SMALL>(v[a], v[b], (mx), one);              \
        v[d] = rotr16(v[d] ^ v[a]);                             \
        v[c] = fma_add(v[d], one, v[c]);                        \
        v[b] = rotr12(v[b] ^ v[c]);                             \
        v[a] = add3<SMALL>(v[a], v[b], (my), one);              \
        v[d] = rotr8(v[d] ^ v[a]);                              \
        v[c] = fma_add(v[d], one, v[c]);                        \
        v[b] = rotr7(v[b] ^ v[c]);                              \
    } while (0)

// cv <- compress(cv, m, counter, block_len, flags), the 8-word output.
template <bool SMALL>
__device__ __forceinline__ void compress(uint32_t cv[8], const uint32_t msg[16],
                                         uint32_t counter, uint32_t block_len,
                                         uint32_t flags, uint32_t one) {
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

// The parent of two chaining values.
template <bool SMALL>
__device__ __forceinline__ void parent(uint32_t cv[8], const uint32_t right[8],
                                       uint32_t flags, uint32_t one) {
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 8; i++) {
        m[i] = cv[i];
        m[8 + i] = right[i];
    }
    set_iv(cv);
    compress<SMALL>(cv, m, 0u, 64u, PARENT | flags, one);
}

// The chaining value of chunk c of a row (chunk_len bytes of it live, at
// p). SMALL: each block is loaded into registers one ahead of its
// compression (a warp alone on its scheduler has no other warp to hide
// the load behind); else loaded when needed, 20 registers fewer, so
// that more CTAs share an SM.
template <bool SMALL>
__device__ __forceinline__ void chunk_cv(uint32_t cv[8], const uint8_t *p,
                                        int chunk_len, uint32_t c,
                                        uint32_t root, uint32_t one) {
    const int n_blocks = chunk_len == 0 ? 1 : (chunk_len + 63) / 64;
    const uint4 *q = reinterpret_cast<const uint4 *>(p);
    uint4 nx[4];
    if (SMALL) {
#pragma unroll
        for (int i = 0; i < 4; i++)
            nx[i] = q[i];
    }
    set_iv(cv);
#pragma unroll 1
    for (int blk = 0; blk < n_blocks; blk++) {
        uint32_t m[16];
#pragma unroll
        for (int i = 0; i < 4; i++) {
            const uint4 w = SMALL ? nx[i] : q[4 * blk + i];
            m[4 * i] = w.x; m[4 * i + 1] = w.y;
            m[4 * i + 2] = w.z; m[4 * i + 3] = w.w;
        }
        if (SMALL && blk + 1 < n_blocks) {  // the next block in flight
#pragma unroll
            for (int i = 0; i < 4; i++)
                nx[i] = q[4 * (blk + 1) + i];
        }
        int blen = chunk_len - blk * 64;
        blen = blen > 64 ? 64 : blen;
        if (blen < 64) {  // zero the bytes past the message end
#pragma unroll
            for (int i = 0; i < 16; i++) {
                const int nb = blen - 4 * i;
                if (nb <= 0)
                    m[i] = 0u;
                else if (nb < 4)
                    m[i] &= (1u << (8 * nb)) - 1u;
            }
        }
        const uint32_t flags = (blk == 0 ? CHUNK_START : 0u)
                             | (blk == n_blocks - 1 ? (CHUNK_END | root) : 0u);
        compress<SMALL>(cv, m, c, (uint32_t)blen, flags, one);
    }
}

// Merge `cnt` (<= 32) nodes of one tree level, node i in lane i, level by
// level: aligned pairs, the odd tail carried up. Lane 0 ends with the
// last node; `root`: the merge of the last two nodes carries ROOT.
template <bool SMALL>
__device__ __forceinline__ void warp_merge(uint32_t cv[8], int cnt, bool root,
                                           int lane, uint32_t one) {
#pragma unroll 1
    for (int step = 1; cnt > 1; step <<= 1) {
        uint32_t right[8];
#pragma unroll
        for (int i = 0; i < 8; i++)
            right[i] = __shfl_down_sync(0xffffffffu, cv[i], step);
        // node lane / step of this level; its right neighbour exists
        if ((lane & (2 * step - 1)) == 0 && lane / step + 1 < cnt)
            parent<SMALL>(cv, right, root && cnt == 2 ? ROOT : 0u, one);
        cnt = (cnt + 1) >> 1;
    }
}

__device__ __forceinline__ void load8(uint32_t cv[8], const uint32_t *src) {
    const uint4 a = reinterpret_cast<const uint4 *>(src)[0];
    const uint4 b = reinterpret_cast<const uint4 *>(src)[1];
    cv[0] = a.x; cv[1] = a.y; cv[2] = a.z; cv[3] = a.w;
    cv[4] = b.x; cv[5] = b.y; cv[6] = b.z; cv[7] = b.w;
}

__device__ __forceinline__ void store8(uint32_t *dst, const uint32_t cv[8]) {
    reinterpret_cast<uint4 *>(dst)[0] = make_uint4(cv[0], cv[1], cv[2], cv[3]);
    reinterpret_cast<uint4 *>(dst)[1] = make_uint4(cv[4], cv[5], cv[6], cv[7]);
}

__device__ __forceinline__ void load_cg(uint32_t cv[8], const uint32_t *src) {
    const uint4 *s = reinterpret_cast<const uint4 *>(src);
    const uint4 a = __ldcg(s), b = __ldcg(s + 1);
    cv[0] = a.x; cv[1] = a.y; cv[2] = a.z; cv[3] = a.w;
    cv[4] = b.x; cv[5] = b.y; cv[6] = b.z; cv[7] = b.w;
}

__device__ __forceinline__ void store_cg(uint32_t *dst, const uint32_t cv[8]) {
    uint4 *d = reinterpret_cast<uint4 *>(dst);
    __stcg(d, make_uint4(cv[0], cv[1], cv[2], cv[3]));
    __stcg(d + 1, make_uint4(cv[4], cv[5], cv[6], cv[7]));
}

// Merge the CTA's `cnt` nodes (thread t holds node t in cv) level by
// level in shared memory, ping-ponging between two buffers of
// blockDim.x nodes: thread t < pairs makes parent t, the thread after
// the last pair carries an odd tail up. Thread 0 ends with the last
// node in cv; `root`: the merge of the last two nodes carries ROOT.
template <bool SMALL>
__device__ void cta_merge(uint32_t cv[8], int cnt, bool root, uint32_t *nodes,
                          uint32_t one) {
    const int t = threadIdx.x;
    uint32_t *cur = nodes, *nxt = nodes + blockDim.x * 8;
    if (t < cnt)
        store8(cur + 8 * t, cv);
    __syncthreads();
#pragma unroll 1
    while (cnt > 1) {
        const int pairs = cnt >> 1;
        if (t < pairs) {
            uint32_t right[8];
            load8(cv, cur + 16 * t);
            load8(right, cur + 16 * t + 8);
            parent<SMALL>(cv, right, root && cnt == 2 ? ROOT : 0u, one);
            store8(nxt + 8 * t, cv);
        } else if (t == pairs && (cnt & 1)) {
            load8(cv, cur + 8 * (cnt - 1));
            store8(nxt + 8 * t, cv);
        }
        __syncthreads();
        uint32_t *tmp = cur;
        cur = nxt;
        nxt = tmp;
        cnt = pairs + (cnt & 1);
    }
    if (t == 0)
        load8(cv, cur);
}

// Warp 0 of a row's last CTA: merge the row's `cnt` block roots (in the
// workspace) into the digest. While more than 32 remain, a level is
// merged in place in the workspace, 32 pairs per pass (pass j writes
// nodes 32 j .. 32 j + 31, which passes up to j have read); the last 32
// or fewer merge by shuffles.
template <bool SMALL>
__device__ void row_root(uint32_t *level, int cnt, int lane, uint32_t *out,
                         uint32_t one) {
    uint32_t cv[8];
    set_iv(cv);
#pragma unroll 1
    while (cnt > 32) {
        const int pairs = cnt >> 1;
#pragma unroll 1
        for (int p0 = 0; p0 < pairs; p0 += 32) {
            const int p = p0 + lane;
            uint32_t right[8];
            if (p < pairs) {
                load_cg(cv, level + 16 * p);
                load_cg(right, level + 16 * p + 8);
            }
            __syncwarp();
            if (p < pairs) {
                parent<SMALL>(cv, right, 0u, one);
                store_cg(level + 8 * p, cv);
            }
            __syncwarp();
        }
        if (cnt & 1) {  // the odd tail carried up
            if (lane < 8)
                __stcg(level + 8 * pairs + lane,
                       __ldcg(level + 8 * (cnt - 1) + lane));
            __syncwarp();
        }
        cnt = pairs + (cnt & 1);
    }
    if (lane < cnt)
        load_cg(cv, level + 8 * lane);
    warp_merge<SMALL>(cv, cnt, true, lane, one);
    if (lane == 0)
        store8(out, cv);
}

// One CTA per (row b, block j of blockDim.x chunks); see the note at the
// top. Dynamic shared memory: 2 * blockDim.x nodes of 8 words.
template <bool SMALL>
__global__ void __launch_bounds__(B3_MAX_WARPS * 32)
blake3_rows(const uint8_t *__restrict__ msgs, long long row_stride,
            const int *__restrict__ lengths, int B, int C, int blocks,
            uint32_t *roots, unsigned *tickets, uint32_t *out, uint32_t one) {
    extern __shared__ __align__(16) uint32_t nodes[];
    __shared__ unsigned ticket;
    const int per = blockDim.x;  // chunks per block
    const int b = blockIdx.x / blocks, j = blockIdx.x % blocks;
    const int n = min(per, C - j * per);  // chunks in the block
    const int c = j * per + threadIdx.x;
    uint32_t cv[8];
    set_iv(cv);  // threads past the row's chunks hold a node no one reads
    if (threadIdx.x < n) {
        long long len = (long long)lengths[b] - (long long)c * 1024;
        len = len < 0 ? 0 : (len > 1024 ? 1024 : len);
        chunk_cv<SMALL>(cv, msgs + (long long)b * row_stride + (long long)c * 1024,
                 (int)len, (uint32_t)c, C == 1 ? ROOT : 0u, one);
    }
    cta_merge<SMALL>(cv, n, blocks == 1, nodes, one);
    uint32_t *dst = out + (long long)b * 8;
    if (blocks == 1) {
        if (threadIdx.x == 0)
            store8(dst, cv);
        return;
    }
    uint32_t *level = roots + (long long)b * blocks * 8;
    if (threadIdx.x == 0) {
        store_cg(level + 8 * j, cv);
        __threadfence();  // the root is visible before the ticket
        ticket = atomicAdd(tickets + b, 1u);
    }
    __syncthreads();
    if (ticket != (unsigned)blocks - 1 || threadIdx.x >= 32)
        return;
    __threadfence();  // every other block's root is visible now
    row_root<SMALL>(level, blocks, threadIdx.x, dst, one);
    if (threadIdx.x == 0)
        tickets[b] = 0u;  // ready for the next launch
}

// One thread times `steps` G steps of one column, each step dependent on
// the last through all four words, in the forms the kernel compiles to
// at small batches (SMALL: the latency-bound case the chain bounds):
// out[0] = clock64 cycles, out[1] = the state (kept so nothing is
// optimised away).
__global__ void blake3_chain_cycles(long long *out, int steps, uint32_t seed,
                                    uint32_t mx, uint32_t my, uint32_t one) {
    constexpr bool SMALL = true;
    uint32_t v[16];
    v[0] = seed;
    v[4] = seed * 2654435761u;
    v[8] = seed ^ 0x5BD1E995u;
    v[12] = seed + 0x27D4EB2Fu;
    const long long t0 = clock64();
#pragma unroll 8
    for (int i = 0; i < steps; ++i)
        G(0, 4, 8, 12, mx, my);
    const long long t1 = clock64();
    out[0] = t1 - t0;
    out[1] = v[0] ^ v[4] ^ v[8] ^ v[12];
}

// B3's launch geometry for B rows of C chunks on the current device:
// plan[0] warps per CTA W, the power of two (1, 2 or 4) at or above
// B * ceil(C / 32) / SMs, so that the card's SMs are covered before a
// CTA grows; plan[1] CTAs; plan[2] blocks per row (a block: 32 W
// chunks, one CTA; a power of two, so blocks start on subtree
// boundaries); plan[3] 1 for the SMALL kernel, when the warps fit one a
// scheduler (4 an SM) so that each is latency-bound. plan: 4 int32 on
// the host.
extern "C" int gt_b3_plan(int B, int C, int *plan) {
    if (B < 0 || C < 1)
        return (int)cudaErrorInvalidValue;
    int dev, n_sm;
    int err = (int)cudaGetDevice(&dev);
    if (!err)
        err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                          dev);
    if (err)
        return err;
    const long long warps = (long long)B * ((C + 31) / 32);
    long long wpc = 1;
    while (wpc < B3_MAX_WARPS && wpc * n_sm < warps)
        wpc *= 2;
    const long long blocks = (C + 32 * wpc - 1) / (32 * wpc);
    if ((long long)B * blocks > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    plan[0] = (int)wpc;
    plan[1] = (int)(B * blocks);
    plan[2] = (int)blocks;
    plan[3] = warps <= 4LL * n_sm;
    return 0;
}

// msgs (B, row_stride) u8, 16-byte aligned, row_stride >= C*1024 and a
// multiple of 16; lengths (B,) i32 with ceil(len/1024) == C (pad rows:
// len = C*1024); roots: B * blocks * 8 u32 workspace (unused when one
// block holds the row); tickets: B u32 counters, zero before the launch
// and zero after it; out (B, 8) u32; wpc and small from gt_b3_plan.
extern "C" int gt_blake3_rows(const void *msgs, long long row_stride,
                              const void *lengths, int B, int C, void *roots,
                              void *tickets, void *out, int wpc, int small,
                              void *stream) {
    if (B < 0 || C < 1 || row_stride < (long long)C * 1024 || row_stride % 16
        || wpc < 1 || wpc > B3_MAX_WARPS || (wpc & (wpc - 1)))
        return (int)cudaErrorInvalidValue;
    const int per = 32 * wpc;
    const long long blocks = (C + per - 1) / per;
    if ((long long)B * blocks > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    if (B == 0)
        return 0;
    auto kernel = small ? blake3_rows<true> : blake3_rows<false>;
    kernel<<<(unsigned)(B * blocks), per, 2 * per * 32, (cudaStream_t)stream>>>(
        (const uint8_t *)msgs, row_stride, (const int *)lengths, B, C,
        (int)blocks, (uint32_t *)roots, (unsigned *)tickets, (uint32_t *)out,
        1u);
    return (int)cudaGetLastError();
}

// out: 2 int64 on the device (see blake3_chain_cycles).
extern "C" int gt_blake3_chain_cycles(void *out, int steps, void *stream) {
    blake3_chain_cycles<<<1, 1, 0, (cudaStream_t)stream>>>(
        (long long *)out, steps, 0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u, 1u);
    return (int)cudaGetLastError();
}
