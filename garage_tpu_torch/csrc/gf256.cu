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
//
// G2 design: the scrub's syndrome on the tensor cores. Stripe b is
// intact if and only if H_b . stripe_b = 0 over GF(2^8), H = [A | I_m]
// (m x (k + m)): exact, the same test as "stored parity == A . data".
// G2 is G1's product with all k + m rows of a stripe staged (parity rows
// beside the data rows) and H's bit matrix as the B operand, built per
// CTA from the runtime coefficients of A and the identity beside it
// (gf_build_bfrag, shared with G1). The saving is the epilogue: a
// stripe is intact iff every output bit is 0, so each lane ORs its
// sums (bit 0, and bit 7 where one column carries two rows) into one
// word, and a warp does one __any_sync and, for a corrupt stripe only,
// one byte store (the stripe's "intact" byte to 0, which the entry set
// to 1 with a memset) per staged unit. No pack, no shuffles, no atomics,
// and no other kernel around it.
// - RS(10,4): 8 (k + m) = 112 <= 127 input bits, so one B column still
//   carries two syndrome rows; 14 rows unpacked (4 k-steps, 16 rows
//   padded), 2 x 4 mmas per 16 positions.
// - Every code the JAX package takes (k + m <= 256): past 16 staged rows
//   the kernel loops over 16-row slices (4 k-steps each), accumulating
//   G2_F row fragments in the same s32 registers across the slices (one
//   row per column there: the low bit of the total is the XOR), G2_F at
//   a time. A launch takes r syndrome rows with the data rows and the r
//   parity rows they check, and only their B fragments sit in shared
//   memory; where all m do not fit one launch, the wrapper runs a few
//   launches over groups of rows (`off`: the group's first parity row),
//   clearing the same bytes. The planner (gt_g1_plan, check = 1)
//   picks the rows per launch and the tile.
// - Staged positions past a tile's length (stale bytes of an earlier
//   unit) unpack as zeros, so they add nothing to the syndrome.
// - What it reaches (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 256
//   stripes of RS(10,4) in ~0.33 ms, above the 0.112 ms bytes bound for
//   G1's reason: per
//   64 positions a warp issues ~290 unpack instructions (64 PRMT, 85
//   LOP3, 88 IMAD for 16 staged rows) against 32 IMMA and 16 LOP3 of
//   epilogue. Testing each sum against the stored parity bits in the
//   accumulator's layout (k rows unpacked, 24 IMMA) was not built: its
//   compare needs the same ~60 ALU instructions a pass that the 4 extra
//   unpacked rows cost. ptxas registers: PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#define GF_VEC 16      // rows are multiples of 16 bytes (bulk copies)
#define GF_MAX_ROWS 16 // output rows of one G1 launch

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
// bfrag[(ip * kt + ks) * 32 + lane] for output rows i = rb ip .. rb ip +
// rb - 1, lane = 4 g + t, input row j = 4 ks + t: byte bb of .x holds
// bit g of H[i][j] * 2^bb, byte bb of .y bit g of H[i][j] * 2^(4 + bb)
// (output bit g of row i against input bit bb or 4 + bb of row j), row
// rb ip at bit 0 and row rb ip + 1 (rb = 2) at bit 7 of the byte. A sum
// against such a column is S0 + 128 S1 with S0 < 128: bit 0 and bit 7
// are the two rows' output bits, so one mma serves two output rows.
// H[i][j] = A[i][j] (A row-major, k columns) for j < k; G2 (n = k + r)
// puts the identity beside it, H[i][k + i] = 1; zero for i >= r, j >= n.
__device__ void gf_build_bfrag(uint2 *bfrag, const uint8_t *A, int k, int n,
                               int r, int kt, int rb) {
    const int nfrag = (r + rb - 1) / rb;
    for (int idx = threadIdx.x; idx < nfrag * kt * 32; idx += G1_THREADS) {
        const int lane = idx & 31, ks = (idx >> 5) % kt, ip = (idx >> 5) / kt;
        const int g = lane >> 2, j = ks * 4 + (lane & 3);
        uint32_t lo = 0, hi = 0;
        for (int h = 0; h < rb; ++h) {
            const int i = rb * ip + h;
            uint32_t p = 0;
            if (i < r && j < n)
                p = j < k ? A[i * k + j] : (uint32_t)(j - k == i);
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

// Thread 0: stage the n rows of unit u (item b, S-tile s0) into `st`,
// one bulk copy per row, all completing on `bar`. Rows j < k are rows j
// of the item, rows j >= k its rows j + off (G2's group of parity rows).
__device__ void gf_issue(uint8_t *st, uint64_t *bar, const uint8_t *x,
                         long long x_stride, long long u, long long ntiles,
                         int n, int k, int off, long long S, int tile,
                         int pitch) {
    const long long b = u / ntiles, s0 = (u % ntiles) * tile;
    const uint32_t len = (uint32_t)min((long long)tile, S - s0);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(len * (uint32_t)n) : "memory");
    const uint8_t *src = x + b * x_stride + s0;
    for (int j = 0; j < n; ++j)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            :: "r"(smem_u32(st + j * pitch)),
               "l"(src + (long long)(j < k ? j : j + off) * S), "r"(len),
               "r"(smem_u32(bar))
            : "memory");
}

// A fragments of KS k-steps: input rows j0 + 4 ks + t (zero from row n
// on, or everywhere when !live), the 8 bytes at `pos` of each, unpacked
// to 0/1 u8 in the mma's K order (K = 4t + bb: bit bb of the row; K = 16
// + 4t + bb: bit 4 + bb), m-tile mt taking bytes 2 mt and 2 mt + 1.
template <int KS>
__device__ __forceinline__ void gf_unpack(uint32_t a[KS][16], const uint8_t *st,
                                          int pitch, int j0, int n, int pos,
                                          int t, bool live) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        const int j = j0 + ks * 4 + t;
        uint2 v = make_uint2(0u, 0u);
        if (live && j < n)
            v = *reinterpret_cast<const uint2 *>(st + j * pitch + pos);
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
        uint32_t a[KS][16];
        gf_unpack<KS>(a, st, pitch, 0, k, p0 + 8 * g, t, true);
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
            gf_issue(smem + s * k * pitch, bar + s, x, x_stride, u0 + s, ntiles,
                     k, k, 0, S, tile, pitch);
    long long mat_item = -1;
    for (int it = 0; u0 + it < u_end; ++it) {
        const long long u = u0 + it;
        const int s = it % G1_STAGES;
        // the stage of unit u + G1_STAGES - 1 was last read in the
        // previous unit, before its closing __syncthreads
        if (threadIdx.x == 0 && u + G1_STAGES - 1 < u_end) {
            const int sn = (it + G1_STAGES - 1) % G1_STAGES;
            gf_issue(smem + sn * k * pitch, bar + sn, x, x_stride,
                     u + G1_STAGES - 1, ntiles, k, k, 0, S, tile, pitch);
        }
        const long long b = u / ntiles, s0 = (u % ntiles) * tile;
        const long long mi = mat_stride ? b : 0;
        if (mi != mat_item) {
            gf_build_bfrag(bfrag, mats + mi * mat_stride, k, k, r, KS, RB);
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

// ---------------------------------------------------------------------------
// G2: ok[b] = 0 where H_b . stripe_b != 0, H = [A | I] (tensor cores)
// ---------------------------------------------------------------------------

#define G2_F 2             // row fragments accumulated at once
// CTAs per SM the planner aims for (and the launch bounds allow): one
// slice 3, so that RS(10,4)'s 14 staged rows take 2 KiB tiles (4 CTAs
// of 1 KiB tiles measured 2 % slower); sliced (two fragment sets of
// accumulators live) 2
#define G2_CTAS_PER_SM(SLICED) ((SLICED) ? 2 : 3)

// G2's shape for k data rows and r syndrome rows of a launch: n staged
// rows, ks k-steps per 16-row slice, kt k-steps in all, rb rows per B
// column (two while 8n <= 120 input bits keep a row's sum below 2^7),
// nfrag B columns of 8 output bits.
struct G2Shape {
    int n, ks, kt, rb, nfrag;
};

__host__ __device__ __forceinline__ G2Shape g2_shape(int k, int r) {
    G2Shape s;
    s.n = k + r;
    s.ks = s.n <= 16 ? (s.n + 3) / 4 : 4;
    s.kt = s.n <= 16 ? s.ks : 4 * ((s.n + 15) / 16);
    s.rb = s.n <= 15 ? 2 : 1;
    s.nfrag = (r + s.rb - 1) / s.rb;
    return s;
}

// One staged tile of G2: the OR of the sums of this warp's positions
// (tile / G1_WARPS, 64 per pass, laid out as in g1_tile). SLICED = false
// (n <= 16 staged rows, one slice): the A fragments are unpacked once a
// pass and each row fragment's sums OR'd in turn, as G1 stores them.
// SLICED (KS = 4): every 16-row slice of the n rows is unpacked in turn,
// G2_F row fragments accumulating across the slices at a time.
template <int KS, bool SLICED>
__device__ __forceinline__ uint32_t g2_tile(const uint8_t *st, int pitch,
                                            const uint2 *bfrag, G2Shape sh,
                                            int len, int tile, int warp,
                                            int lane) {
    constexpr int F = SLICED ? G2_F : 1;
    const int g = lane >> 2, t = lane & 3;
    const int nsl = SLICED ? sh.kt / KS : 1;
    const int per_warp = tile / G1_WARPS;
    const int end = min(len, (warp + 1) * per_warp);
    uint32_t bits = 0;
    for (int p0 = warp * per_warp; p0 < end; p0 += G1_PASS) {
        // the lane's 8 positions (len is a multiple of 16)
        const bool live = p0 + 8 * g < len;
        uint32_t a[KS][16];
        if (!SLICED)
            gf_unpack<KS>(a, st, pitch, 0, sh.n, p0 + 8 * g, t, live);
        for (int fg = 0; fg < sh.nfrag; fg += F) {
            int c[F][4][4];
#pragma unroll
            for (int f = 0; f < F; ++f)
#pragma unroll
                for (int mt = 0; mt < 4; ++mt)
                    c[f][mt][0] = c[f][mt][1] = c[f][mt][2] = c[f][mt][3] = 0;
            for (int sl = 0; sl < nsl; ++sl) {
                if (SLICED)
                    gf_unpack<KS>(a, st, pitch, 16 * sl, sh.n, p0 + 8 * g, t,
                                  live);
#pragma unroll
                for (int f = 0; f < F; ++f) {
                    if (fg + f >= sh.nfrag)
                        break;
#pragma unroll
                    for (int ks = 0; ks < KS; ++ks) {
                        const uint2 bb =
                            bfrag[((fg + f) * sh.kt + sl * KS + ks) * 32 + lane];
#pragma unroll
                        for (int mt = 0; mt < 4; ++mt)
                            mma_u8(c[f][mt], a[ks] + 4 * mt, bb.x, bb.y);
                    }
                }
            }
#pragma unroll
            for (int f = 0; f < F; ++f)
#pragma unroll
                for (int mt = 0; mt < 4; ++mt)
                    bits |= (uint32_t)(c[f][mt][0] | c[f][mt][1] | c[f][mt][2]
                                       | c[f][mt][3]);
        }
    }
    return bits;
}

// G2 over a persistent grid of (item, S-tile) units, as gf_apply_mma:
// the n = k + r rows of the next unit staged while this one computes
// (data rows 0..k of the item, then its parity rows k + off .. k + off +
// r), H's B fragments rebuilt when the matrix changes. A warp that sees
// a nonzero syndrome bit clears the item's byte of `ok`.
template <int KS, bool SLICED>
__global__ void __launch_bounds__(G1_THREADS, G2_CTAS_PER_SM(SLICED))
gf_check_mma(const uint8_t *__restrict__ mats, long long mat_stride,
             const uint8_t *__restrict__ x, long long x_stride,
             uint8_t *__restrict__ ok, int B, int k, int r, int off,
             long long S, int tile) {
    extern __shared__ __align__(128) uint8_t smem[];
    const G2Shape sh = g2_shape(k, r);
    const int n = sh.n;
    const int pitch = tile + G1_ROW_PAD;
    const long long ntiles = (S + tile - 1) / tile;
    const long long units = (long long)B * ntiles;
    uint2 *bfrag = reinterpret_cast<uint2 *>(smem + G1_STAGES * n * pitch);
    uint64_t *bar = reinterpret_cast<uint64_t *>(bfrag + sh.nfrag * sh.kt * 32);
    const uint32_t mask = sh.rb == 2 ? 0x81u : 0x01u;  // the output bits
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
            gf_issue(smem + s * n * pitch, bar + s, x, x_stride, u0 + s, ntiles,
                     n, k, off, S, tile, pitch);
    long long mat_item = -1;
    for (int it = 0; u0 + it < u_end; ++it) {
        const long long u = u0 + it;
        const int s = it % G1_STAGES;
        if (threadIdx.x == 0 && u + G1_STAGES - 1 < u_end) {
            const int sn = (it + G1_STAGES - 1) % G1_STAGES;
            gf_issue(smem + sn * n * pitch, bar + sn, x, x_stride,
                     u + G1_STAGES - 1, ntiles, n, k, off, S, tile, pitch);
        }
        const long long b = u / ntiles, s0 = (u % ntiles) * tile;
        const long long mi = mat_stride ? b : 0;
        if (mi != mat_item) {
            gf_build_bfrag(bfrag, mats + mi * mat_stride, k, n, r, sh.kt, sh.rb);
            __syncthreads();
            mat_item = mi;
        }
        mbar_wait(bar + s, (it / G1_STAGES) & 1);
        const uint32_t bits = g2_tile<KS, SLICED>(
            smem + s * n * pitch, pitch, bfrag, sh,
            (int)min((long long)tile, S - s0), tile, warp, lane);
        if (__any_sync(0xffffffffu, (bits & mask) != 0u) && lane == 0)
            ok[b] = 0;
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// Host side: shapes, the planner, launches
// ---------------------------------------------------------------------------

static size_t g1_smem(int k, int r, int tile) {
    const int ks = (k + 3) / 4;
    const int nfrag = ks < 4 ? (r + 1) / 2 : r;  // G1_ROWS_PER_FRAG
    return (size_t)G1_STAGES * k * (tile + G1_ROW_PAD) + (size_t)nfrag * ks * 32 * 8
           + 8 * G1_STAGES;
}

static size_t g2_smem(int k, int r, int tile) {
    const G2Shape s = g2_shape(k, r);
    return (size_t)G1_STAGES * s.n * (tile + G1_ROW_PAD)
           + (size_t)s.nfrag * s.kt * 32 * 8 + 8 * G1_STAGES;
}

// The kernels the planner and the launches configure: G1 with a plain
// store (KIND 0) or XOR into the output (1), and G2 on one slice (2) or
// on 16-row slices (3).
template <int KS, int KIND>
static const void *gf_fn() {
    if constexpr (KIND >= 2)
        return (const void *)gf_check_mma<KS, KIND == 3>;
    else
        return (const void *)gf_apply_mma<KS, KIND == 1>;
}

// Let a kernel take all the shared memory a CTA may have on the current
// device, with the SM's unified memory carved out for shared memory (the
// rows are read through it, not through L1), once per process
// (idempotent, so a race is harmless).
template <int KS, int KIND>
static int gf_configure(int *optin) {
    static int smem_optin = 0;
    if (!smem_optin) {
        const void *fn = gf_fn<KS, KIND>();
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

// The tiles, largest first: multiples of G1_WARPS * G1_PASS.
static const int G1_TILES[] = {4096, 2048, 1024, 512, 256};
#define G1_MIN_TILE 256

// The tile is the largest of G1_TILES that still gives two work units
// per SM and lets as many CTAs as the registers allow
// (G1_CTAS_PER_SM, G2_CTAS_PER_SM) share an SM, else the smallest
// that fits: for G1 the PUT batch of 8 stripes of 104,864 B gets 2 KiB
// tiles (416 units on 132 SMs), 256 stripes the same tile and 32 times
// the units. The grid is persistent: as many CTAs as the occupancy
// calculator fits on the card at once, at most one a unit.
template <int KS, int KIND>
static int gf_plan_ks(int B, int k, int r, long long S, int *plan) {
    int optin, dev, n_sm, err = gf_configure<KS, KIND>(&optin);
    if (!err)
        err = (int)cudaGetDevice(&dev);
    if (!err)
        err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                          dev);
    if (err)
        return err;
    const int want = KIND >= 2 ? G2_CTAS_PER_SM(KIND == 3) : G1_CTAS_PER_SM(KS);
    const int n_tiles = (int)(sizeof(G1_TILES) / sizeof(G1_TILES[0]));
    int tile = 0, per_sm = 0;
    size_t tile_smem = 0;
    for (int i = 0; i < n_tiles; ++i) {
        const int t = G1_TILES[i];
        const size_t smem = KIND >= 2 ? g2_smem(k, r, t) : g1_smem(k, r, t);
        if (smem > (size_t)optin)
            continue;
        int occ = 0;
        err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, gf_fn<KS, KIND>(), G1_THREADS, smem);
        if (err)
            return err;
        tile = t;
        per_sm = occ;
        tile_smem = smem;
        if ((long long)B * ((S + t - 1) / t) >= 2LL * n_sm && occ >= want)
            break;
    }
    if (per_sm < 1)
        return (int)cudaErrorInvalidValue;  // the rows do not fit on an SM
    const long long units = (long long)B * ((S + tile - 1) / tile);
    const long long fit = (long long)n_sm * per_sm;
    plan[0] = tile;
    plan[1] = (int)(units < fit ? units : fit);
    plan[2] = (int)(units < INT32_MAX ? units : INT32_MAX);
    plan[3] = (int)tile_smem;
    plan[4] = r;
    return 0;
}

static int g1_check(int B, int k, int r, long long S) {
    if (B < 0 || B > 65535 || k < 1 || k > 4 * G1_MAX_KS || r < 1
        || r > GF_MAX_ROWS || S < 0 || S % GF_VEC)
        return (int)cudaErrorInvalidValue;
    return 0;
}

static int g2_check(int B, int k, int r, long long S) {
    if (B < 0 || k < 1 || r < 1 || S < 0 || S % GF_VEC)
        return (int)cudaErrorInvalidValue;
    return 0;
}

// The launch geometry of G1 (check = 0: B items of (k <= 16, S) -> (r <=
// 16, S)) or of G2 (check = 1: B stripes of k data rows, r syndrome rows)
// on the current device: plan[0] the tile (S-bytes per unit), plan[1]
// the persistent grid's CTAs, plan[2] the units, plan[3] the dynamic
// shared memory of a CTA in bytes, plan[4] the output rows of one launch
// (r for G1; for G2 the most of r whose staged rows and B fragments fit
// a CTA at the smallest tile, the plan being that launch's). plan: 5
// int32 on the host.
extern "C" int gt_g1_plan(int B, int k, int r, long long S, int check,
                          int *plan) {
    if (!check) {
        const int err = g1_check(B, k, r, S);
        if (err)
            return err;
        switch ((k + 3) / 4) {
        case 1: return gf_plan_ks<1, 0>(B, k, r, S, plan);
        case 2: return gf_plan_ks<2, 0>(B, k, r, S, plan);
        case 3: return gf_plan_ks<3, 0>(B, k, r, S, plan);
        default: return gf_plan_ks<4, 0>(B, k, r, S, plan);
        }
    }
    int dev, optin, err = g2_check(B, k, r, S);
    if (!err)
        err = (int)cudaGetDevice(&dev);
    if (!err)
        err = (int)cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err)
        return err;
    int rows = r;
    while (rows > 1 && g2_smem(k, rows, G1_MIN_TILE) > (size_t)optin)
        --rows;
    if (g2_smem(k, rows, G1_MIN_TILE) > (size_t)optin)
        return (int)cudaErrorInvalidValue;  // k rows do not fit on an SM
    if (g2_shape(k, rows).n > 16)
        return gf_plan_ks<4, 3>(B, k, rows, S, plan);
    switch (g2_shape(k, rows).ks) {
    case 1: return gf_plan_ks<1, 2>(B, k, rows, S, plan);
    case 2: return gf_plan_ks<2, 2>(B, k, rows, S, plan);
    case 3: return gf_plan_ks<3, 2>(B, k, rows, S, plan);
    default: return gf_plan_ks<4, 2>(B, k, rows, S, plan);
    }
}

template <int KS, bool ACC>
static int g1_launch(const void *mats, long long mat_stride, const void *x,
                     long long x_stride, void *out, long long out_stride,
                     int B, int k, int r, long long S, int tile, int grid,
                     cudaStream_t stream) {
    int optin, err = gf_configure<KS, ACC ? 1 : 0>(&optin);
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

template <int KS, bool SLICED>
static int g2_launch(const void *mats, long long mat_stride, const void *x,
                     long long x_stride, void *ok, int B, int k, int r,
                     int off, long long S, int tile, int grid,
                     cudaStream_t stream) {
    int optin, err = gf_configure<KS, SLICED ? 3 : 2>(&optin);
    const size_t smem = g2_smem(k, r, tile);
    if (err)
        return err;
    if (smem > (size_t)optin)
        return (int)cudaErrorInvalidValue;
    gf_check_mma<KS, SLICED><<<grid, G1_THREADS, smem, stream>>>(
        (const uint8_t *)mats, mat_stride, (const uint8_t *)x, x_stride,
        (uint8_t *)ok, B, k, r, off, S, tile);
    return (int)cudaGetLastError();
}

// G2. mats: the launch's r rows of the (B or 1, m, k) u8 parity
// matrices (pointer at row off), mat_stride m * k or 0 (broadcast);
// stripes: B items of k + m rows of S bytes, x_stride bytes apart,
// 16-byte aligned; ok: (B,) u8, set to 1 first when `init`, and 0 where
// rows k + off .. k + off + r of a stripe differ from their rows of A .
// rows 0..k; tile and grid from gt_g1_plan(check = 1) for (B, k, r, S).
extern "C" int gt_gf_check(const void *mats, long long mat_stride,
                           const void *stripes, long long x_stride, void *ok,
                           int init, int B, int k, int r, int off,
                           long long S, int tile, int grid, void *stream) {
    int err = g2_check(B, k, r, S);
    if (err || off < 0 || x_stride < (long long)(k + off + r) * S
        || x_stride % GF_VEC)
        return err ? err : (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (init && B > 0)
        err = (int)cudaMemsetAsync(ok, 1, (size_t)B, s);
    if (err || B == 0 || S == 0)  // nothing to check: every stripe intact
        return err;
    if (tile <= 0 || tile % (G1_WARPS * G1_PASS) || grid <= 0)
        return (int)cudaErrorInvalidValue;
    if (g2_shape(k, r).n > 16)
        return g2_launch<4, true>(mats, mat_stride, stripes, x_stride, ok, B,
                                  k, r, off, S, tile, grid, s);
    switch (g2_shape(k, r).ks) {
    case 1: return g2_launch<1, false>(mats, mat_stride, stripes, x_stride,
                                       ok, B, k, r, off, S, tile, grid, s);
    case 2: return g2_launch<2, false>(mats, mat_stride, stripes, x_stride,
                                       ok, B, k, r, off, S, tile, grid, s);
    case 3: return g2_launch<3, false>(mats, mat_stride, stripes, x_stride,
                                       ok, B, k, r, off, S, tile, grid, s);
    default: return g2_launch<4, false>(mats, mat_stride, stripes, x_stride,
                                        ok, B, k, r, off, S, tile, grid, s);
    }
}
