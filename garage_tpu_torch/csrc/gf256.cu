// GF(2^8) matrix application on Hopper: kernels G1 (gf_apply) and G2
// (gf_check) of the block data path.
//
// Replaces: the Pallas kernel garage_tpu/ops/pallas_gf.py:_kernel (one
// fused unpack -> MXU bit-matmul -> pack per (k, T) tile) and its XLA
// twins garage_tpu/ops/gf256.py:bit_matmul_apply /
// bit_matmul_apply_batched (G1), and garage_tpu/ops/rs.py:
// _jit_parity_check (G2).
//
// What bounds it: memory. out[b] = A_b . x[b] over GF(2^8) reads the k
// input rows once and writes the r output rows once, (k + r) * S bytes
// per item, at 3.35 TB/s. The arithmetic must stay below that line:
// as r * k byte lookups per position (the kernel before this one) it did
// not — 1.07 G shared-memory byte loads for an encode of 256 stripes,
// on one shared-memory pipe per SM, with bank conflicts.
//
// G1 design: the product on the tensor cores, as the TPU kernel put it
// on the MXU. Out-bit-planes (8r x T) = M (8r x 8k, 0/1) . in-bit-
// planes (8k x T), computed transposed with mma.sync m16n8k32 u8 -> s32:
// positions on the MMA's M side, output bits on its N side (so a byte's
// bits land in one quad of lanes), 32 input bits (4 input rows) per
// k-step, 8k padded to a multiple of 32. A sum's low bit is the output
// bit. While a row's sum stays below 2^7 (k <= 12, at most 96 input
// bits) each B column carries two output rows, one at bit 0 and one at
// bit 7 of its byte, so the sum is S0 + 128 S1 and one mma serves two
// rows: RS(10,4) encode is 2 x 3 mmas per 16 positions, decode 5 x 3.
// - Staging: a work unit is one (item, S-tile); the tile comes from the
//   launch shape (gt_g1_plan: enough units to fill the card at the PUT
//   batch of 8 stripes, few enough to stay long at 256, and no more
//   shared memory than lets the registers' CTAs share an SM, as the
//   occupancy calculator reports for this device). A
//   persistent grid gives each CTA a contiguous run of units; thread 0
//   stages all k rows of the next unit with cp.async.bulk (1-D TMA) on
//   an mbarrier while the CTA computes the current one (G1_STAGES = 2;
//   three or four stages measured no faster). Rows sit 32 bytes apart
//   past the tile, so a quad's four rows fall in different banks.
// - Operands: input bytes unpack to 0/1 u8 straight into the A
//   fragment's K order, a nibble at a time ((n * 0x00204081) &
//   0x01010101). M stays a runtime operand: each CTA builds the B
//   fragments from the item's (r, k) coefficients in shared memory
//   (column 8j + b of row block i is the bit vector of A[i][j] * 2^b),
//   per item or once for a broadcast matrix (stride 0). The only
//   template parameter is the number of k-steps, a shape: one build
//   serves every erasure pattern.
// - Maps wider than one launch: a launch takes at most G1_MAX_KS
//   k-steps (16 input rows, the A fragments live in registers) and
//   GF_MAX_ROWS output rows. The wrapper tiles a larger (r, k) map
//   (decode of erasure(20,4) is 20 x 20) into launches over 16-row
//   slices of x and of out (x_stride, out_stride: bytes between
//   items); along k each launch after the first XORs its product into
//   `out` (the ACC instances): GF(2^8) sums are XORs, so the slices'
//   products add up to A . x.
// - Epilogue: bits 0 and 7 of the sums, the quad ORs its lanes' bit
//   pairs into 8 output bytes per row (two shuffles per word), one
//   8-byte store per quad and row.
// - What it reaches (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py; times
//   in PERF.md): above its bytes bound. The integer ALU pipe takes a
//   warp instruction only every other clock and the nibble unpack and
//   the epilogue are ALU work; mma.sync is not Hopper's full tensor
//   rate (wgmma is); one warp issues in order, so the two overlap only
//   across the 20 warps an SM holds.
// - ptxas (sm_90a, CUDA 12.8): gf_apply_mma<1..4, store> 63 / 77 / 95 /
//   112 registers, <1..4, ACC> 71 / 80 / 95 / 124; dynamic shared memory
//   g1_smem (43,152 B for RS(10,4) encode at 2 KiB tiles).
//   gf_check_kernel 99 registers.

// G2 (the table-lookup body of the kernel before G1's redesign) runs
// the lookups for the m parity rows of a (k + m)-row stripe and compares
// them with the stored rows in registers: parity never goes to device
// memory; a mismatch sets the item's int32 flag with atomicOr. It copies
// its item's r * k product tables (256 bytes each, rows of the full
// 64 KiB multiplication table the caller keeps on the device) into
// shared memory, then XORs table lookups over 16 byte positions per
// step.
//
// C ABI (loaded with ctypes): every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define GF_THREADS 256
#define GF_VEC 16                                  // bytes per thread per step
#define GF_STEPS 4                                 // steps per thread per block
#define GF_TILE (GF_THREADS * GF_VEC * GF_STEPS)   // 16 KiB of each row per block
#define GF_MAX_ROWS 16

// One byte of each 32-bit word looked up in a 256-entry table.
__device__ __forceinline__ uint32_t lookup4(const uint8_t *t, uint32_t w) {
    return (uint32_t)t[w & 0xff]
         | ((uint32_t)t[(w >> 8) & 0xff] << 8)
         | ((uint32_t)t[(w >> 16) & 0xff] << 16)
         | ((uint32_t)t[w >> 24] << 24);
}

// Copy the r*k product tables of one item into shared memory:
// tab[(i*k + j)*256 + v] = A[i][j] * v.
__device__ __forceinline__ void load_tables(uint32_t *tab32,
                                            const uint32_t *mul32,
                                            const uint8_t *mat, int rk) {
    for (int idx = threadIdx.x; idx < rk * 64; idx += blockDim.x) {
        int e = idx >> 6;
        tab32[idx] = mul32[(uint32_t)mat[e] * 64 + (idx & 63)];
    }
    __syncthreads();
}

// acc[i] = XOR_j A[i][j] * x[j][pos .. pos+16) for i < r.
__device__ __forceinline__ void gf_rows(const uint8_t *tab,
                                        const uint8_t *xb, long long S,
                                        long long pos, int k, int r,
                                        uint4 acc[GF_MAX_ROWS]) {
#pragma unroll
    for (int i = 0; i < GF_MAX_ROWS; i++)
        acc[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int j = 0; j < k; j++) {
        uint4 v = *reinterpret_cast<const uint4 *>(xb + (long long)j * S + pos);
#pragma unroll
        for (int i = 0; i < GF_MAX_ROWS; i++) {
            if (i < r) {
                const uint8_t *t = tab + (i * k + j) * 256;
                acc[i].x ^= lookup4(t, v.x);
                acc[i].y ^= lookup4(t, v.y);
                acc[i].z ^= lookup4(t, v.z);
                acc[i].w ^= lookup4(t, v.w);
            }
        }
    }
}

// G2: flags[b] |= 1 when rows k..k+m of stripes[b] differ from A_b . rows 0..k.
__global__ void __launch_bounds__(GF_THREADS)
gf_check_kernel(const uint8_t *mul, const uint8_t *mats, long long mat_stride,
                const uint8_t *stripes, int *flags, int k, int m, long long S) {
    extern __shared__ uint32_t tab32[];
    const int b = blockIdx.y;
    load_tables(tab32, reinterpret_cast<const uint32_t *>(mul),
                mats + (long long)b * mat_stride, m * k);
    const uint8_t *tab = reinterpret_cast<const uint8_t *>(tab32);
    const uint8_t *xb = stripes + (long long)b * (k + m) * S;
    const uint8_t *pb = xb + (long long)k * S;
    uint32_t diff = 0;
    for (int step = 0; step < GF_STEPS; step++) {
        long long pos = (long long)blockIdx.x * GF_TILE
                      + (long long)step * GF_THREADS * GF_VEC
                      + (long long)threadIdx.x * GF_VEC;
        if (pos >= S)
            break;
        uint4 acc[GF_MAX_ROWS];
        gf_rows(tab, xb, S, pos, k, m, acc);
#pragma unroll
        for (int i = 0; i < GF_MAX_ROWS; i++) {
            if (i < m) {
                uint4 s = *reinterpret_cast<const uint4 *>(pb + (long long)i * S + pos);
                diff |= (acc[i].x ^ s.x) | (acc[i].y ^ s.y)
                      | (acc[i].z ^ s.z) | (acc[i].w ^ s.w);
            }
        }
    }
    if (diff)
        atomicOr(flags + b, 1);
}

// ---------------------------------------------------------------------------
// G1: out[b] (r, S) = A_b (r, k) . x[b] (k, S) on the tensor cores
// ---------------------------------------------------------------------------

#define G1_WARPS 4
#define G1_THREADS (G1_WARPS * 32)
#define G1_PASS 64      // positions per warp pass: 4 m-tiles of 16
#define G1_ROW_PAD 32   // bytes between staged rows past the tile (no bank conflicts)
#define G1_STAGES 2     // staged units per CTA: the current one and the next
#define G1_MAX_KS 4     // k-steps of 32 input bits (4 input rows) per launch
// CTAs per SM the registers allow (the planner sizes tiles to match)
#define G1_CTAS_PER_SM(KS) ((KS) < 4 ? 5 : 4)

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t *bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
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
        :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The 4 bits of nibble n (0..15) as u8 0/1, bit b in byte b (the four
// shifted copies of n do not overlap, so no carry crosses a byte).
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
    return (n * 0x00204081u) & 0x01010101u;
}

// c (16 x 8 s32) += a (16 x 32 u8, row) . b (32 x 8 u8, col)
__device__ __forceinline__ void mma_u8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Output rows per B fragment: two while a sum of one row stays below
// 2^7 (8k <= 96 input bits, k <= 12), else one.
#define G1_ROWS_PER_FRAG(KS) ((KS) < 4 ? 2 : 1)

// The bit matrix as mma B fragments, built from the item's coefficients:
// bfrag[(ip * KS + ks) * 32 + lane] for output rows i = RB ip .. RB ip +
// RB - 1 (RB = G1_ROWS_PER_FRAG), lane = 4 g + t, input row j = 4 ks +
// t: byte bb of .x holds bit g of A[i][j] * 2^bb, byte bb of .y bit g of
// A[i][j] * 2^(4 + bb) (output bit g of row i against input bit bb or
// 4 + bb of row j; zero for the padded rows j >= k), row RB ip at bit 0
// and row RB ip + 1 (if any) at bit 7 of the byte. A sum against such a
// column is S0 + 128 S1 with S0 < 128: bit 0 and bit 7 are the two
// rows' output bits, so one mma serves two output rows.
template <int KS>
__device__ void g1_build_bfrag(uint2 *bfrag, const uint8_t *A, int k, int r) {
    constexpr int RB = G1_ROWS_PER_FRAG(KS);
    const int nfrag = (r + RB - 1) / RB;
    for (int idx = threadIdx.x; idx < nfrag * KS * 32; idx += G1_THREADS) {
        const int lane = idx & 31, ks = (idx >> 5) % KS, ip = (idx >> 5) / KS;
        const int g = lane >> 2, j = ks * 4 + (lane & 3);
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int h = 0; h < RB; ++h) {
            const int i = RB * ip + h;
            uint32_t p = (j < k && i < r) ? A[i * k + j] : 0u;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                const uint32_t bit = ((p >> g) & 1u) << (7 * h);
                if (b < 4)
                    lo |= bit << (8 * b);
                else
                    hi |= bit << (8 * (b - 4));
                p = ((p << 1) ^ ((p & 0x80u) ? 0x11Du : 0u)) & 0xFFu;  // p * 2
            }
        }
        bfrag[idx] = make_uint2(lo, hi);
    }
}

// Thread 0: stage the k input rows of unit u (item b, S-tile s0) into
// `st`, one bulk copy per row, all completing on `bar`.
__device__ void g1_issue(uint8_t *st, uint64_t *bar, const uint8_t *x,
                         long long x_stride, long long u, long long ntiles,
                         int k, long long S, int tile, int pitch) {
    const long long b = u / ntiles, s0 = (u % ntiles) * tile;
    const uint32_t len = (uint32_t)min((long long)tile, S - s0);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(len * (uint32_t)k) : "memory");
    const uint8_t *src = x + b * x_stride + s0;
    for (int j = 0; j < k; ++j)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            :: "r"(smem_u32(st + j * pitch)), "l"(src + j * S), "r"(len),
               "r"(smem_u32(bar))
            : "memory");
}

// The low bytes of four sums in one word: a0, a1, b0, b1 -> bytes 0-3.
__device__ __forceinline__ uint32_t g1_low_bytes(int a0, int a1, int b0,
                                                 int b1) {
    return __byte_perm(__byte_perm(a0, a1, 0x0040), __byte_perm(b0, b1, 0x4000),
                       0x7610);
}

// Output bits 2t (from sums e = 0) and 2t + 1 (e = 1) of positions
// 8g + 4h .. 8g + 4h + 3 (m-tiles 2h, 2h + 1) as this lane's share of
// their 4 output bytes; sh = 1 << 2t. The shifts are multiplies (IMAD,
// the FMA pipe), as the bits are disjoint: the integer ALU pipe, which
// runs the PRMTs and LOPs, issues only every other clock.
__device__ __forceinline__ uint32_t g1_pack(uint32_t x, uint32_t y,
                                            uint32_t sh) {
    return (y & 0x01010101u) * (2 * sh) + (x & 0x01010101u) * sh;
}

// Quad OR of the lanes' shares, then lane t == 0 stores 8 bytes (XORed
// into what `dst` holds for ACC).
template <bool ACC>
__device__ __forceinline__ void g1_store(uint32_t lo, uint32_t hi, uint8_t *dst,
                                         bool store) {
    lo |= __shfl_xor_sync(0xffffffffu, lo, 1);
    hi |= __shfl_xor_sync(0xffffffffu, hi, 1);
    lo |= __shfl_xor_sync(0xffffffffu, lo, 2);
    hi |= __shfl_xor_sync(0xffffffffu, hi, 2);
    if (store) {
        uint2 *d = reinterpret_cast<uint2 *>(dst);
        if (ACC) {
            const uint2 o = *d;
            lo ^= o.x;
            hi ^= o.y;
        }
        *d = make_uint2(lo, hi);
    }
}

// One staged tile: each warp takes tile / G1_WARPS positions, 64 per
// pass. In a pass, m-tile mt row g is position 8g + 2mt and row g + 8 is
// 8g + 2mt + 1, so lane (g, t) reads 8 consecutive bytes of input row
// 4 ks + t and the quad of lanes g ends up with the output bytes of
// positions 8g .. 8g + 7.
template <int KS, bool ACC>
__device__ __forceinline__ void g1_tile(const uint8_t *st, int pitch,
                                        const uint2 *bfrag, uint8_t *ob,
                                        long long S, int k, int r, int len,
                                        int tile, int warp, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const uint32_t sh = 1u << (2 * t);
    const int per_warp = tile / G1_WARPS;
    const int end = min(len, (warp + 1) * per_warp);
    for (int p0 = warp * per_warp; p0 < end; p0 += G1_PASS) {
        // A fragments: input bits of the pass, unpacked to 0/1 int8 in
        // the mma's K order (K = 4t + bb: bit bb of row 4ks + t; K = 16 +
        // 4t + bb: bit 4 + bb)
        uint32_t a[KS][16];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            const int j = ks * 4 + t;
            uint2 v = make_uint2(0u, 0u);
            if (j < k)
                v = *reinterpret_cast<const uint2 *>(st + j * pitch + p0 + 8 * g);
            // low and high nibbles of the 8 bytes; one PRMT picks a byte
            const uint32_t nib[4] = {v.x & 0x0F0F0F0Fu, (v.x >> 4) & 0x0F0F0F0Fu,
                                     v.y & 0x0F0F0F0Fu, (v.y >> 4) & 0x0F0F0F0Fu};
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const uint32_t lo = nib[2 * (mt >> 1)], hi = nib[2 * (mt >> 1) + 1];
                const uint32_t q = 2 * (mt & 1);
                a[ks][4 * mt + 0] = spread4(__byte_perm(lo, 0, 0x4440 + q));
                a[ks][4 * mt + 1] = spread4(__byte_perm(lo, 0, 0x4441 + q));
                a[ks][4 * mt + 2] = spread4(__byte_perm(hi, 0, 0x4440 + q));
                a[ks][4 * mt + 3] = spread4(__byte_perm(hi, 0, 0x4441 + q));
            }
        }
        constexpr int RB = G1_ROWS_PER_FRAG(KS);
        const bool store = t == 0 && p0 + 8 * g < len;
        for (int i = 0; i < r; i += RB) {
            int c[4][4];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
                c[mt][0] = c[mt][1] = c[mt][2] = c[mt][3] = 0;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                const uint2 bb = bfrag[((i / RB) * KS + ks) * 32 + lane];
#pragma unroll
                for (int mt = 0; mt < 4; ++mt)
                    mma_u8(c[mt], a[ks] + 4 * mt, bb.x, bb.y);
            }
            // epilogue: bit 0 (row i) and bit 7 (row i + 1) of each sum
            // are output bits; lane t holds bits 2t, 2t+1 of 8 bytes of a
            // row, and the quad ORs them together
            const uint32_t x0 = g1_low_bytes(c[0][0], c[0][2], c[1][0], c[1][2]);
            const uint32_t y0 = g1_low_bytes(c[0][1], c[0][3], c[1][1], c[1][3]);
            const uint32_t x1 = g1_low_bytes(c[2][0], c[2][2], c[3][0], c[3][2]);
            const uint32_t y1 = g1_low_bytes(c[2][1], c[2][3], c[3][1], c[3][3]);
            uint8_t *dst = ob + i * S + p0 + 8 * g;
            g1_store<ACC>(g1_pack(x0, y0, sh), g1_pack(x1, y1, sh), dst, store);
            if (RB == 2 && i + 1 < r)
                g1_store<ACC>(g1_pack(x0 >> 7, y0 >> 7, sh),
                              g1_pack(x1 >> 7, y1 >> 7, sh), dst + S, store);
        }
    }
}

// Persistent grid over the units (item, S-tile), unit u = b * ntiles +
// tile index, each CTA a contiguous range of them (so a per-item matrix
// changes rarely inside a CTA); G1_STAGES stages, the next units' rows
// in flight while this one computes. The B fragments are rebuilt when the
// matrix changes (per item, or once for a broadcast matrix, stride 0).
// ACC: XOR the product into `out` (a later 16-row slice of a wider
// code), a template flag so that a plain store carries no branch.
template <int KS, bool ACC>
__global__ void __launch_bounds__(G1_THREADS, G1_CTAS_PER_SM(KS))
gf_apply_mma(const uint8_t *__restrict__ mats, long long mat_stride,
             const uint8_t *__restrict__ x, long long x_stride,
             uint8_t *__restrict__ out, long long out_stride, int B, int k,
             int r, long long S, int tile) {
    extern __shared__ __align__(128) uint8_t smem[];
    const int pitch = tile + G1_ROW_PAD;
    const long long ntiles = (S + tile - 1) / tile;
    const long long units = (long long)B * ntiles;
    uint2 *bfrag = reinterpret_cast<uint2 *>(smem + G1_STAGES * k * pitch);
    constexpr int RB = G1_ROWS_PER_FRAG(KS);
    uint64_t *bar = reinterpret_cast<uint64_t *>(bfrag + (r + RB - 1) / RB * KS * 32);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < G1_STAGES; ++s)
            mbar_init(bar + s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const long long u0 = units * blockIdx.x / gridDim.x;
    const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
    if (threadIdx.x == 0)
        for (int s = 0; s < G1_STAGES - 1 && u0 + s < u_end; ++s)
            g1_issue(smem + s * k * pitch, bar + s, x, x_stride, u0 + s, ntiles,
                     k, S, tile, pitch);
    long long mat_item = -1;
    for (int it = 0; u0 + it < u_end; ++it) {
        const long long u = u0 + it;
        const int s = it % G1_STAGES;
        // the stage of unit u + G1_STAGES - 1 was last read in the
        // previous unit, before its closing __syncthreads
        if (threadIdx.x == 0 && u + G1_STAGES - 1 < u_end) {
            const int sn = (it + G1_STAGES - 1) % G1_STAGES;
            g1_issue(smem + sn * k * pitch, bar + sn, x, x_stride,
                     u + G1_STAGES - 1, ntiles, k, S, tile, pitch);
        }
        const long long b = u / ntiles, s0 = (u % ntiles) * tile;
        const long long mi = mat_stride ? b : 0;
        if (mi != mat_item) {
            g1_build_bfrag<KS>(bfrag, mats + mi * mat_stride, k, r);
            __syncthreads();
            mat_item = mi;
        }
        mbar_wait(bar + s, (it / G1_STAGES) & 1);
        g1_tile<KS, ACC>(smem + s * k * pitch, pitch, bfrag, out + b * out_stride + s0,
                         S, k, r, (int)min((long long)tile, S - s0), tile, warp,
                         lane);
        __syncthreads();
    }
}

static int check_shape(int B, int k, int r, long long S) {
    if (B < 0 || B > 65535 || k < 1 || r < 1 || r > GF_MAX_ROWS || S < 0
        || S % GF_VEC || (size_t)r * k * 256 > 200 * 1024)
        return (int)cudaErrorInvalidValue;
    return 0;
}

static int set_smem(const void *fn, size_t smem) {
    if (smem > 48 * 1024)
        return (int)cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return 0;
}

static size_t g1_smem(int k, int r, int tile) {
    const int ks = (k + 3) / 4;
    const int nfrag = ks < 4 ? (r + 1) / 2 : r;  // G1_ROWS_PER_FRAG
    return (size_t)G1_STAGES * k * (tile + G1_ROW_PAD) + (size_t)nfrag * ks * 32 * 8
           + 8 * G1_STAGES;
}

// Let gf_apply_mma<KS> take all the shared memory a CTA may have on the
// current device, with the SM's unified memory carved out for shared
// memory (G1 reads its rows through it, not through L1), once per
// process (idempotent, so a race is harmless).
template <int KS, bool ACC>
static int g1_configure(int *optin) {
    static int smem_optin = 0;
    if (!smem_optin) {
        const void *fn = (const void *)gf_apply_mma<KS, ACC>;
        int dev, v;
        int err = (int)cudaGetDevice(&dev);
        if (!err)
            err = (int)cudaDeviceGetAttribute(
                &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (!err)
            err = (int)cudaFuncSetAttribute(
                fn, cudaFuncAttributeMaxDynamicSharedMemorySize, v);
        if (!err)
            err = (int)cudaFuncSetAttribute(
                fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                cudaSharedmemCarveoutMaxShared);
        if (err)
            return err;
        smem_optin = v;
    }
    *optin = smem_optin;
    return 0;
}

// G1's tiles, largest first: multiples of G1_WARPS * G1_PASS.
static const int G1_TILES[] = {4096, 2048, 1024, 512, 256};

// The tile is the largest of G1_TILES that still gives two work units
// per SM and lets G1_CTAS_PER_SM(KS) CTAs (what the registers allow)
// share an SM, else the smallest: the PUT batch of 8 stripes of 104,864
// B gets 2 KiB tiles (416 units on 132 SMs), 256 stripes the same tile
// and 32 times the units. The grid is persistent: as many CTAs as the
// occupancy calculator fits on the card at once, at most one a unit.
template <int KS>
static int g1_plan_ks(int B, int k, int r, long long S, int *plan) {
    int optin, dev, n_sm, err = g1_configure<KS, false>(&optin);
    if (!err)
        err = (int)cudaGetDevice(&dev);
    if (!err)
        err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                          dev);
    if (err)
        return err;
    const int n_tiles = (int)(sizeof(G1_TILES) / sizeof(G1_TILES[0]));
    int tile = 0, per_sm = 0;
    for (int i = 0; i < n_tiles; ++i) {
        const int t = G1_TILES[i];
        const size_t smem = g1_smem(k, r, t);
        if (smem > (size_t)optin)
            continue;
        int occ = 0;
        err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, (const void *)gf_apply_mma<KS, false>, G1_THREADS, smem);
        if (err)
            return err;
        tile = t;
        per_sm = occ;
        if ((long long)B * ((S + t - 1) / t) >= 2LL * n_sm
            && occ >= G1_CTAS_PER_SM(KS))
            break;
    }
    if (per_sm < 1)
        return (int)cudaErrorInvalidValue;  // k rows do not fit on an SM
    const long long units = (long long)B * ((S + tile - 1) / tile);
    const long long fit = (long long)n_sm * per_sm;
    plan[0] = tile;
    plan[1] = (int)(units < fit ? units : fit);
    plan[2] = (int)(units < INT32_MAX ? units : INT32_MAX);
    plan[3] = (int)g1_smem(k, r, tile);
    return 0;
}

static int g1_check(int B, int k, int r, long long S) {
    int err = check_shape(B, k, r, S);
    if (!err && k > 4 * G1_MAX_KS)
        err = (int)cudaErrorInvalidValue;
    return err;
}

// G1's launch geometry for B items of (k <= 16, S) -> (r <= 16, S) on the
// current device: plan[0] the tile (S-bytes per unit), plan[1] the
// persistent grid's CTAs, plan[2] the units, plan[3] the dynamic shared
// memory of a CTA in bytes. plan: 4 int32 on the host.
extern "C" int gt_g1_plan(int B, int k, int r, long long S, int *plan) {
    int err = g1_check(B, k, r, S);
    if (err)
        return err;
    switch ((k + 3) / 4) {
    case 1: return g1_plan_ks<1>(B, k, r, S, plan);
    case 2: return g1_plan_ks<2>(B, k, r, S, plan);
    case 3: return g1_plan_ks<3>(B, k, r, S, plan);
    default: return g1_plan_ks<4>(B, k, r, S, plan);
    }
}

template <int KS, bool ACC>
static int g1_launch(const void *mats, long long mat_stride, const void *x,
                     long long x_stride, void *out, long long out_stride,
                     int B, int k, int r, long long S, int tile, int grid,
                     cudaStream_t stream) {
    int optin, err = g1_configure<KS, ACC>(&optin);
    const size_t smem = g1_smem(k, r, tile);
    if (err)
        return err;
    if (smem > (size_t)optin)
        return (int)cudaErrorInvalidValue;
    gf_apply_mma<KS, ACC><<<grid, G1_THREADS, smem, stream>>>(
        (const uint8_t *)mats, mat_stride, (const uint8_t *)x, x_stride,
        (uint8_t *)out, out_stride, B, k, r, S, tile);
    return (int)cudaGetLastError();
}

template <int KS>
static int g1_launch_ks(const void *mats, long long mat_stride, const void *x,
                        long long x_stride, void *out, long long out_stride,
                        int B, int k, int r, long long S, int tile, int grid,
                        int acc, cudaStream_t stream) {
    return acc ? g1_launch<KS, true>(mats, mat_stride, x, x_stride, out,
                                     out_stride, B, k, r, S, tile, grid, stream)
               : g1_launch<KS, false>(mats, mat_stride, x, x_stride, out,
                                      out_stride, B, k, r, S, tile, grid, stream);
}

// G1. mats: (B or 1, r, k) u8, mat_stride r * k or 0 (broadcast); x: B
// items of k rows of S bytes, x_stride bytes apart, and out: B items of
// r rows, out_stride bytes apart (k * S and r * S, or more for slices
// of taller arrays), both 16-byte aligned; acc: XOR the product into
// out instead of storing it; tile and grid from gt_g1_plan.
extern "C" int gt_gf_apply(const void *mats, long long mat_stride,
                           const void *x, long long x_stride, void *out,
                           long long out_stride, int B, int k, int r,
                           long long S, int tile, int grid, int acc,
                           void *stream) {
    int err = g1_check(B, k, r, S);
    if (err)
        return err;
    if (tile <= 0 || tile % (G1_WARPS * G1_PASS) || grid <= 0
        || x_stride < (long long)k * S || x_stride % GF_VEC
        || out_stride < (long long)r * S || out_stride % GF_VEC)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || S == 0)
        return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch ((k + 3) / 4) {
    case 1: return g1_launch_ks<1>(mats, mat_stride, x, x_stride, out,
                                   out_stride, B, k, r, S, tile, grid, acc, s);
    case 2: return g1_launch_ks<2>(mats, mat_stride, x, x_stride, out,
                                   out_stride, B, k, r, S, tile, grid, acc, s);
    case 3: return g1_launch_ks<3>(mats, mat_stride, x, x_stride, out,
                                   out_stride, B, k, r, S, tile, grid, acc, s);
    default: return g1_launch_ks<4>(mats, mat_stride, x, x_stride, out,
                                    out_stride, B, k, r, S, tile, grid, acc, s);
    }
}

extern "C" int gt_gf_check(const void *mul, const void *mats,
                           long long mat_stride, const void *stripes,
                           void *flags, int B, int k, int m, long long S,
                           void *stream) {
    int err = check_shape(B, k, m, S);
    if (err)
        return err;
    if (B == 0 || S == 0)
        return 0;
    size_t smem = (size_t)m * k * 256;
    err = set_smem((const void *)gf_check_kernel, smem);
    if (err)
        return err;
    dim3 grid((unsigned)((S + GF_TILE - 1) / GF_TILE), (unsigned)B);
    gf_check_kernel<<<grid, GF_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint8_t *)mul, (const uint8_t *)mats, mat_stride,
        (const uint8_t *)stripes, (int *)flags, k, m, S);
    return (int)cudaGetLastError();
}
