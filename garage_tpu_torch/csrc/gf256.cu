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
// per item, at 3.35 TB/s; the arithmetic (r * k table lookups and XORs
// per byte position) stays below that line when the lookups hit shared
// memory.
//
// Design: the TPU kernel turned the product into a 0/1 matrix product
// because the MXU is the TPU's only fast unit and gathers are slow
// there. A GPU does byte lookups from shared memory cheaply, so this
// kernel keeps the bytes: one block per (item, S-tile) copies that
// item's r * k product tables (256 bytes each, row c of the full
// 64 KiB multiplication table, which the caller keeps on the device)
// into shared memory, and each thread then XORs table lookups over 16
// consecutive byte positions per step, with 16-byte loads and stores.
// The coefficient matrix is a runtime operand — per item, or one
// matrix broadcast with stride 0 — so one build serves every erasure
// pattern; no pattern is ever a template parameter.
//
// G2 runs G1's body for the m parity rows of a (k + m)-row stripe and
// compares them with the stored rows in registers: parity never goes to
// device memory; a mismatch sets the item's int32 flag with atomicOr.
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

// G1: out[b] (r, S) = A_b (r, k) . x[b] (k, S); A_b = mats + b*mat_stride.
__global__ void __launch_bounds__(GF_THREADS)
gf_apply_kernel(const uint8_t *mul, const uint8_t *mats, long long mat_stride,
                const uint8_t *x, uint8_t *out, int k, int r, long long S) {
    extern __shared__ uint32_t tab32[];
    const int b = blockIdx.y;
    load_tables(tab32, reinterpret_cast<const uint32_t *>(mul),
                mats + (long long)b * mat_stride, r * k);
    const uint8_t *tab = reinterpret_cast<const uint8_t *>(tab32);
    const uint8_t *xb = x + (long long)b * k * S;
    uint8_t *ob = out + (long long)b * r * S;
    for (int step = 0; step < GF_STEPS; step++) {
        long long pos = (long long)blockIdx.x * GF_TILE
                      + (long long)step * GF_THREADS * GF_VEC
                      + (long long)threadIdx.x * GF_VEC;
        if (pos >= S)
            break;
        uint4 acc[GF_MAX_ROWS];
        gf_rows(tab, xb, S, pos, k, r, acc);
#pragma unroll
        for (int i = 0; i < GF_MAX_ROWS; i++)
            if (i < r)
                *reinterpret_cast<uint4 *>(ob + (long long)i * S + pos) = acc[i];
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

extern "C" int gt_gf_apply(const void *mul, const void *mats,
                           long long mat_stride, const void *x, void *out,
                           int B, int k, int r, long long S, void *stream) {
    int err = check_shape(B, k, r, S);
    if (err)
        return err;
    if (B == 0 || S == 0)
        return 0;
    size_t smem = (size_t)r * k * 256;
    err = set_smem((const void *)gf_apply_kernel, smem);
    if (err)
        return err;
    dim3 grid((unsigned)((S + GF_TILE - 1) / GF_TILE), (unsigned)B);
    gf_apply_kernel<<<grid, GF_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint8_t *)mul, (const uint8_t *)mats, mat_stride,
        (const uint8_t *)x, (uint8_t *)out, k, r, S);
    return (int)cudaGetLastError();
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
