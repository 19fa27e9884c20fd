// B5  ssd_scan -- the Mamba-2 chunked SSD scan for NVIDIA Hopper (sm_90a).
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (see ../_build.py). No -fmad=false: the kernels promise
// agreement with their plain version within a stated tolerance, not the
// same bits.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (_kernel,
// entry ssd_scan_p, wrapper ops.ssd_scan), which the JAX model computes as
// blocks._ssd_chunk_scan at every prefill of an SSD layer. Per chunk of Q
// positions, in float32:
//   cum  = cumsum(dt * A)                          (in-chunk decay logs)
//   L    = exp(where(i >= j, cum_i - cum_j, -1e30)) (masked BEFORE exp)
//   y    = (C B^T o L) (dt x) + (C o exp(cum)) h^T
//   h   <- exp(cum_last) h + (dt x o exp(cum_last - cum))^T B
// and returns y (float32) and the final state h (P, N) in float32.
//
// Layout at the C interface is the model's own, through element strides,
// the last dim contiguous, nothing repeated:
//   x    (B, S, H, P)   bf16 or float32, strides {batch, seq, head}
//   dt   (B, S, H)      float32 (after softplus), strides {batch, seq, head}
//   A    (B, H)         float32, strides {batch, head} (the model passes its
//                       (H,) vector with batch stride 0)
//   B, C (B, S, G, N)   x's type, strides {batch, seq, group}, NOT repeated
//                       to heads: head h reads group h / (H / G), the order
//                       of jnp.repeat in the JAX model
//   y    (B, S, H, P)   float32, contiguous
//   state(B, H, P, N)   float32, strides {batch, head, p}, n contiguous (the
//                       model passes its cache's layer slice)
// Any S: the last chunk may be ragged; its rows past S are loaded as
// dt = 0, x = B = C = 0, which adds nothing to y or to the state. Where the
// Pallas kernel asserts S % chunk == 0, these do not need it. Q = 64 is the
// kernels' own chunk; the result does not depend on Q except by rounding.
//
// Bound at the serving path's prefill (mamba2-780m: B=4, S=2048, H=48, P=64,
// N=128, G=1; bf16 x/B/C, float32 dt and y): bytes moved once are x 50.3 MB,
// y 100.7 MB, the state 6.3 MB, B/C/dt 5.8 MB -- 163 MB, 0.049 ms at
// 3.35 TB/s; the sequential form's 4*P*N operations per token and head are
// 12.9 GFLOP, 0.013 ms at 989 TFLOP/s. So the bound is bytes: 0.049 ms per
// layer.
//
// Both routes run one block per (head, batch) -- 192 blocks at the serving
// shape -- whose loop walks the chunks in order: it takes the place of the
// Pallas kernel's sequential chunk grid axis, since blocks on Hopper run in
// no order and share nothing, and the state stays on the chip from the
// first chunk to the last (the Pallas kernel's point). The in-chunk cumsum
// is a fixed-order warp scan and every other sum a fixed-order loop or
// mma chain: a result is the same from run to run.
//
// bf16 (ssd_chunk_cb_kernel, then ssd_scan_bf16_kernel): Mamba-2's chunked
// algorithm (arXiv:2405.21060, section 6) on the tensor cores, mma.sync
// m16n8k16 bf16 -> float32 with ldmatrix (mma_bf16.cuh).
//  * C B^T once per (batch, chunk, group): the first kernel writes it in
//    float32, (B, n_chunks, G, Q, Q), 2 MB at the serving shape, which stays
//    in L2; the 48 heads of a group read it in place of recomputing it
//    (~18 % of the float32 route's FMAs).
//  * Four warps; warp w owns rows p of 16 w .. 16 w + 15 of the head. Its
//    part of the state h (16 x N float32) lives in registers in the
//    accumulator layout of the state product, from the first chunk to the
//    last, and is never stored between chunks. The products are taken
//    transposed, with p as the rows, so that layout is also the A operand
//    of y_inter^T = h C^T (B3's register trick: C layout packed to bf16 is
//    the A layout):
//      y^T   = ecum o (h C^T) + x^T S^T,  S = (C B^T o L) * dt_j
//      h     = exp(cum_last) h + (x o dt w)^T B,  w = exp(cum_last - cum)
//    One block computes S (Q x Q) per chunk, each warp a quarter of its
//    rows, into shared memory; key blocks above the diagonal are never
//    read. dt is folded into S, so x enters y_intra as it is.
//  * Precision: an mma operand that is an input's own bf16 value (x, B, C)
//    goes in as it is. A float32 operand (h, S, x o dt w) goes in as a
//    bf16 hi / lo pair, v = hi + lo to ~2^-16 relative, two mmas into one
//    float32 sum: the state's rounding would otherwise compound over the
//    chunks.
//  * A ring of two stages over the chunks: x (64 x 64), B and C (64 x N)
//    come by TMA (4-D tensor maps over the model's strides, rows past S
//    zero-filled, 128-byte swizzle) onto one mbarrier per stage, so chunk
//    k+1 lands while chunk k computes. dt (4 bytes a row for one head) and
//    the C B^T tile (whose values each thread consumes once) come by plain
//    loads into registers, issued one chunk ahead.
//  * Occupancy: 128 threads and 97 KB of shared memory a block at N = 128
//    (two ring stages of 40 KB, S as hi and lo 16 KB, 1 KB of alignment),
//    238 registers a thread (ptxas, no spills): two blocks per SM, so the
//    192 blocks of the serving shape are resident in one wave on the
//    H100's 132 SMs. P is not split over blocks: a third block per SM
//    would need at most 75 KB of shared memory a block.
//
// float32 (ssd_scan_kernel): 256 threads, the products on the CUDA cores
// in float32; per block, padded
// by 4 floats a row (conflict-free float4 reads),
//   C and B chunks   2 * Q * (N + 4) * 4 B = 67.6 KB at N = 128
//   x chunk          Q * (P + 4) * 4 B     = 17.4 KB at P = 64
//   the Q x Q tile   Q * (Q + 4) * 4 B     = 17.4 KB
//   the state h^T    N * (P + 4) * 4 B     = 34.8 KB
//   per-row vectors  4 * Q * 4 B           =  1.0 KB
// = 138.3 KB (one block per SM). Each thread owns a 4 x 4 block of the
// Q x Q score tile, 4 rows x P/16 columns of y, and N/16 x P/16 entries
// of the state; score blocks above the diagonal are neither computed nor
// read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "mma_bf16.cuh"

#define SSD_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }

__device__ __forceinline__ float lane4(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// CP consecutive floats from shared memory (16- / 8-byte aligned for 4 / 2)
template <int CP> __device__ __forceinline__ void ld_vec(const float* p, float* out) {
    if constexpr (CP == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else if constexpr (CP == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        out[0] = v.x; out[1] = v.y;
    } else {
        out[0] = p[0];
    }
}

namespace ssd {
constexpr int Q = 64, THREADS = 256;
template <int P, int N> __host__ __device__ constexpr size_t smem_floats() {
    return (size_t)2 * Q * (N + 4) + (size_t)Q * (P + 4) + (size_t)Q * (Q + 4)
           + (size_t)N * (P + 4) + 4 * Q + 4;
}
}  // namespace ssd

template <typename T, int P, int N>
__global__ void __launch_bounds__(ssd::THREADS, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ state, int S, int H, int G,
                int64_t xsb, int64_t xss, int64_t xsh,
                int64_t dsb, int64_t dss, int64_t dsh,
                int64_t asb, int64_t ash,
                int64_t bsb, int64_t bss, int64_t bsg,
                int64_t csb, int64_t css, int64_t csg,
                int64_t hsb, int64_t hsh, int64_t hsp)
{
    using namespace ssd;
    constexpr int LDN = N + 4, LDP = P + 4, LDQ = Q + 4;
    constexpr int CP = P / 16;   // columns p of y and of the state per thread
    constexpr int NR = N / 16;   // rows n of the state per thread
    extern __shared__ __align__(16) float smem[];
    float* Cs = smem;              // Q x LDN, the C chunk
    float* Bs = Cs + Q * LDN;      // Q x LDN, the B chunk
    float* Xs = Bs + Q * LDN;      // Q x LDP, the x chunk (not yet times dt)
    float* Ls = Xs + Q * LDP;      // Q x LDQ, (C B^T o L)[i][j] * dt_j, j <= i
    float* Hs = Ls + Q * LDQ;      // N x LDP, the state, transposed: h[p][n] at Hs[n][p]
    float* ecum = Hs + N * LDP;    // exp(cum_i)
    float* cum = ecum + Q;         // cum_i
    float* dw = cum + Q;           // dt_j * exp(cum_last - cum_j)
    float* dts = dw + Q;           // dt_j
    float* misc = dts + Q;         // [0]: exp(cum_last)

    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int h = blockIdx.x, b = blockIdx.y;
    const int g = h / (H / G);
    const float a = A[b * asb + h * ash];
    const T* xb = x + b * xsb + h * xsh;
    const float* db = dt + b * dsb + h * dsh;
    const T* bb = Bm + b * bsb + g * bsg;
    const T* cb = Cm + b * csb + g * csg;

    for (int i = tid; i < N * LDP; i += THREADS) Hs[i] = 0.f;

    const int n_chunks = (S + Q - 1) / Q;
    for (int ck = 0; ck < n_chunks; ++ck) {
        const int s0 = ck * Q;
        const int valid = min(Q, S - s0);
        __syncthreads();  // the previous chunk is done with every buffer

        // ---- load the chunk; rows past S are zeros ----------------------
        for (int i = tid; i < Q * P; i += THREADS) {
            const int r = i / P, c = i % P;
            Xs[r * LDP + c] = r < valid ? to_f(xb[(int64_t)(s0 + r) * xss + c]) : 0.f;
        }
        for (int i = tid; i < Q * N; i += THREADS) {
            const int r = i / N, c = i % N;
            const bool ok = r < valid;
            Bs[r * LDN + c] = ok ? to_f(bb[(int64_t)(s0 + r) * bss + c]) : 0.f;
            Cs[r * LDN + c] = ok ? to_f(cb[(int64_t)(s0 + r) * css + c]) : 0.f;
        }
        if (tid < 32) {
            // cum = cumsum(dt * A): lane l holds rows 2l and 2l+1, an
            // inclusive warp scan of the pair sums in a fixed order
            const int r0 = 2 * tid, r1 = r0 + 1;
            const float d0 = r0 < valid ? db[(int64_t)(s0 + r0) * dss] : 0.f;
            const float d1 = r1 < valid ? db[(int64_t)(s0 + r1) * dss] : 0.f;
            const float a0 = d0 * a, a1 = d1 * a;
            float incl = a0 + a1;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float v = __shfl_up_sync(0xffffffffu, incl, off);
                if (tid >= off) incl += v;
            }
            float excl = __shfl_up_sync(0xffffffffu, incl, 1);
            if (tid == 0) excl = 0.f;
            const float c0 = excl + a0, c1 = incl;
            // cum_last is the last valid row's own value, not lane 31's
            // tree sum: in a ragged chunk the two are summed in another
            // order, and at |cum| ~ 1e4 an ulp of difference would put
            // exp(1e-3) on the last row's weight in the state
            const int lr = (valid - 1) >> 1;
            const float l0 = __shfl_sync(0xffffffffu, c0, lr);
            const float l1 = __shfl_sync(0xffffffffu, c1, lr);
            const float last = ((valid - 1) & 1) ? l1 : l0;
            cum[r0] = c0; cum[r1] = c1;
            ecum[r0] = expf(c0); ecum[r1] = expf(c1);
            dw[r0] = d0 * expf(last - c0); dw[r1] = d1 * expf(last - c1);
            dts[r0] = d0; dts[r1] = d1;
            if (tid == 0) misc[0] = expf(last);
        }
        __syncthreads();

        // ---- scores: rows i = ty + 16 ia, keys j = tx + 16 jb, jb <= ia ---
        {
            float acc[4][4];
#pragma unroll
            for (int ia = 0; ia < 4; ++ia)
#pragma unroll
                for (int jb = 0; jb < 4; ++jb) acc[ia][jb] = 0.f;
#pragma unroll 2
            for (int n = 0; n < N; n += 4) {
                float4 cv[4], bv[4];
#pragma unroll
                for (int ia = 0; ia < 4; ++ia)
                    cv[ia] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * ia) * LDN + n]);
#pragma unroll
                for (int jb = 0; jb < 4; ++jb)
                    bv[jb] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * jb) * LDN + n]);
#pragma unroll
                for (int ia = 0; ia < 4; ++ia)
#pragma unroll
                    for (int jb = 0; jb < 4; ++jb) {
                        if (jb > ia) continue;
                        float s = acc[ia][jb];
                        s = fmaf(cv[ia].x, bv[jb].x, s);
                        s = fmaf(cv[ia].y, bv[jb].y, s);
                        s = fmaf(cv[ia].z, bv[jb].z, s);
                        s = fmaf(cv[ia].w, bv[jb].w, s);
                        acc[ia][jb] = s;
                    }
            }
#pragma unroll
            for (int ia = 0; ia < 4; ++ia)
#pragma unroll
                for (int jb = 0; jb < 4; ++jb) {
                    if (jb > ia) continue;
                    const int i = ty + 16 * ia, j = tx + 16 * jb;
                    // the mask goes on the log, before exp: cum_i - cum_j > 0
                    // above the diagonal and would overflow
                    const float l = expf(i >= j ? cum[i] - cum[j] : SSD_NEG_INF);
                    Ls[i * LDQ + j] = acc[ia][jb] * l * dts[j];
                }
        }
        __syncthreads();

        // ---- y: rows i = ty + 16 ia, columns p = tx * CP + c ---------------
        {
            float yi[4][CP], yo[4][CP];
#pragma unroll
            for (int ia = 0; ia < 4; ++ia)
#pragma unroll
                for (int c = 0; c < CP; ++c) { yi[ia][c] = 0.f; yo[ia][c] = 0.f; }
            // intra-chunk: row block ia reads key blocks kb <= ia only
#pragma unroll
            for (int kb = 0; kb < 4; ++kb) {
#pragma unroll 2
                for (int jj = 0; jj < 16; jj += 4) {
                    const int j = 16 * kb + jj;
                    float4 lv[4];
#pragma unroll
                    for (int ia = 0; ia < 4; ++ia)
                        if (ia >= kb)
                            lv[ia] = *reinterpret_cast<const float4*>(&Ls[(ty + 16 * ia) * LDQ + j]);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        float xv[CP];
                        ld_vec<CP>(&Xs[(j + e) * LDP + tx * CP], xv);
#pragma unroll
                        for (int ia = 0; ia < 4; ++ia) {
                            if (ia < kb) continue;
                            const float l = lane4(lv[ia], e);
#pragma unroll
                            for (int c = 0; c < CP; ++c) yi[ia][c] = fmaf(l, xv[c], yi[ia][c]);
                        }
                    }
                }
            }
            // inter-chunk: the state carried in from earlier chunks
#pragma unroll 2
            for (int n = 0; n < N; n += 4) {
                float4 cv[4];
#pragma unroll
                for (int ia = 0; ia < 4; ++ia)
                    cv[ia] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * ia) * LDN + n]);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float hv[CP];
                    ld_vec<CP>(&Hs[(n + e) * LDP + tx * CP], hv);
#pragma unroll
                    for (int ia = 0; ia < 4; ++ia) {
                        const float cc = lane4(cv[ia], e);
#pragma unroll
                        for (int c = 0; c < CP; ++c) yo[ia][c] = fmaf(cc, hv[c], yo[ia][c]);
                    }
                }
            }
#pragma unroll
            for (int ia = 0; ia < 4; ++ia) {
                const int i = ty + 16 * ia;
                if (i >= valid) continue;
                const float ec = ecum[i];
                float* yrow = y + (((int64_t)b * S + s0 + i) * H + h) * P + tx * CP;
#pragma unroll
                for (int c = 0; c < CP; ++c) yrow[c] = yi[ia][c] + yo[ia][c] * ec;
            }
        }
        __syncthreads();  // every read of the old state is done

        // ---- state: h^T[n][p] = exp(cum_last) h^T[n][p] + sum_j B[j][n] dx_j[p] w_j
        {
            const float decay = misc[0];
            float acc[NR][CP];
#pragma unroll
            for (int r = 0; r < NR; ++r)
#pragma unroll
                for (int c = 0; c < CP; ++c) acc[r][c] = 0.f;
#pragma unroll 4
            for (int j = 0; j < valid; ++j) {
                float xv[CP];
                ld_vec<CP>(&Xs[j * LDP + tx * CP], xv);
                const float w = dw[j];
#pragma unroll
                for (int c = 0; c < CP; ++c) xv[c] *= w;
#pragma unroll
                for (int r = 0; r < NR; ++r) {
                    const float bv = Bs[j * LDN + ty + 16 * r];
#pragma unroll
                    for (int c = 0; c < CP; ++c) acc[r][c] = fmaf(bv, xv[c], acc[r][c]);
                }
            }
#pragma unroll
            for (int r = 0; r < NR; ++r)
#pragma unroll
                for (int c = 0; c < CP; ++c) {
                    float* hp = &Hs[(ty + 16 * r) * LDP + tx * CP + c];
                    *hp = *hp * decay + acc[r][c];
                }
        }
    }

    __syncthreads();
    float* hb = state + b * hsb + h * hsh;
    for (int i = tid; i < P * N; i += THREADS) {
        const int p = i / N, n = i % N;
        hb[p * hsp + n] = Hs[n * LDP + p];
    }
}

template <typename T, int P, int N>
static int ssd_scan_run(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* state,
                        int Bz, int S, int H, int G, const int64_t* xst,
                        const int64_t* dst, const int64_t* ast,
                        const int64_t* bst, const int64_t* cst,
                        const int64_t* hst, cudaStream_t stream)
{
    const size_t smem = ssd::smem_floats<P, N>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)H, (unsigned)Bz);
    ssd_scan_kernel<T, P, N><<<grid, ssd::THREADS, smem, stream>>>(
        (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
        (const T*)Cm, (float*)y, (float*)state, S, H, G,
        xst[0], xst[1], xst[2], dst[0], dst[1], dst[2], ast[0], ast[1],
        bst[0], bst[1], bst[2], cst[0], cst[1], cst[2], hst[0], hst[1], hst[2]);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores, a TMA ring over the chunks, C B^T once per group
// ---------------------------------------------------------------------------
namespace ssdt {
constexpr int Q = 64, WARPS = 4, THREADS = 32 * WARPS, STAGES = 2;
// one TMA box: 64 rows x 64 bf16 (128 bytes a row, 128-byte swizzle)
constexpr int TILE = 64 * 128;
template <int N> __host__ __device__ constexpr int boxes() { return N > 64 ? N / 64 : 1; }
// a ring stage: the x tile, then the B and the C tile (columns past P or N
// zero-filled by the TMA unit)
template <int N> __host__ __device__ constexpr int stage_bytes() {
    return TILE + 2 * boxes<N>() * TILE;
}
// + 1024: the ring's start is rounded up to the swizzle's alignment
template <int N> constexpr size_t scan_smem_bytes() {
    return (size_t)STAGES * stage_bytes<N>() + 2 * TILE + 1024;
}
template <int N> constexpr size_t cb_smem_bytes() {
    return (size_t)2 * boxes<N>() * TILE + 1024;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p)
{
    return reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// the 16 bytes at (row, col) of a tile, col a multiple of 8
__device__ __forceinline__ const unsigned char* at(const unsigned char* tile,
                                                   int row, int col)
{
    return tile + (col / 64) * TILE + sw128(row, (col % 64) / 8);
}

// a float pair as bf16 hi and lo pairs: v = hi + lo to ~2^-16 relative
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t& hi,
                                             uint32_t& lo)
{
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16x2(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t r)
{
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// chunk rows [s0, s0 + 64) of tensor map m's (batch b, head or group hg),
// in boxes of 64 columns, onto bar
template <int NB>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* m,
                                          int hg, int s0, int b, uint64_t* bar)
{
#pragma unroll
    for (int bx = 0; bx < NB; ++bx)
        tma_load_4d(dst + bx * TILE, m, bx * 64, hg, s0, b, bar);
}

// thread 0 fills a ring stage with chunk rows [s0, s0 + Q): x of head h,
// B and C of group grp
template <int N>
__device__ __forceinline__ void load_chunk(unsigned char* st, uint64_t* bar,
                                           const CUtensorMap* tx,
                                           const CUtensorMap* tb,
                                           const CUtensorMap* tc, int h,
                                           int grp, int s0, int b)
{
    constexpr int NB = boxes<N>();
    mbar_expect_tx(bar, stage_bytes<N>());
    load_rows<1>(st, tx, h, s0, b, bar);
    load_rows<NB>(st + TILE, tb, grp, s0, b, bar);
    load_rows<NB>(st + (1 + NB) * TILE, tc, grp, s0, b, bar);
}
}  // namespace ssdt

// C B^T of one (chunk, group, batch), float32, into cb (B, n_chunks, G, Q,
// Q): warp w computes rows i of 16 w .. 16 w + 15, every key j. Rows past
// S are zero-filled by the TMA unit, so their entries are 0.
template <int N>
__global__ void __launch_bounds__(ssdt::THREADS)
ssd_chunk_cb_kernel(const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tc,
                    float* __restrict__ cb)
{
    using namespace ssdt;
    constexpr int NB = boxes<N>(), KN = N / 16, NJ = Q / 8;
    extern __shared__ __align__(16) unsigned char cb_smem[];
    unsigned char* Bt = align1024(cb_smem);
    unsigned char* Ct = Bt + NB * TILE;
    __shared__ __align__(8) uint64_t bar;

    const int k = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    if (threadIdx.x == 0) {
        mbar_init(&bar, 1);
        mbar_fence_init();
        mbar_expect_tx(&bar, 2 * NB * TILE);
        load_rows<NB>(Bt, &tb, grp, k * Q, b, &bar);
        load_rows<NB>(Ct, &tc, grp, k * Q, b, &bar);
    }
    __syncthreads();  // the barrier is initialised before anyone waits
    mbar_wait(&bar, 0);

    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kn = 0; kn < KN; ++kn) {
        uint32_t af[4];  // C rows of this warp, n in k-step kn
        ldmatrix_x4(af, at(Ct, warp * 16 + lane % 16, kn * 16 + (lane / 16) * 8));
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
            // matrices: keys 8j.. x n (lo, hi 8), keys 8j+8.. x n (lo, hi)
            uint32_t r[4];
            ldmatrix_x4(r, at(Bt, j * 8 + (lane / 16) * 8 + lane % 8,
                              kn * 16 + ((lane / 8) % 2) * 8));
            mma_bf16(acc[j], af, r);
            mma_bf16(acc[j + 1], af, r + 2);
        }
    }
    float* out = cb + (((int64_t)b * gridDim.x + k) * gridDim.y + grp) * Q * Q;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(out + (warp * 16 + g + 8 * r) * Q + j * 8 + 2 * t)
                = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
}

// The scan of one (head, batch) over its chunks. Lane l of every warp holds
// chunk rows 2l and 2l+1 of the per-row vectors (cum, dt, ...), the layout
// of the float32 kernel's warp scan; a fragment's value for another row
// comes by __shfl_sync from the lane that holds it.
template <int P, int N>
__global__ void __launch_bounds__(ssdt::THREADS, 2)
ssd_scan_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc,
                     const float* __restrict__ cb, const float* __restrict__ dt,
                     const float* __restrict__ A, float* __restrict__ y,
                     float* __restrict__ state, int S, int H, int G,
                     int64_t dsb, int64_t dss, int64_t dsh,
                     int64_t asb, int64_t ash,
                     int64_t hsb, int64_t hsh, int64_t hsp)
{
    using namespace ssdt;
    constexpr int NB = boxes<N>(), SB = stage_bytes<N>();
    constexpr int NT = N / 8;         // n8 tiles of the state
    constexpr int KN = N / 16;        // k16 steps over n
    constexpr int NI = Q / 8;         // n8 tiles of y^T (rows i of the chunk)
    constexpr int KJ = Q / 16;        // k16 steps over the chunk's keys j
    constexpr int RW = Q / WARPS;     // rows of S each warp computes
    constexpr unsigned FULL = 0xffffffffu;
    extern __shared__ __align__(16) unsigned char ssd_smem[];
    unsigned char* ring = align1024(ssd_smem);
    unsigned char* Shi = ring + STAGES * SB;   // S (Q x Q) as bf16 hi, then lo
    unsigned char* Slo = Shi + TILE;
    __shared__ __align__(8) uint64_t full[STAGES];

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    const int h = blockIdx.x, b = blockIdx.y;
    const int grp = h / (H / G);
    const int nc = (S + Q - 1) / Q;
    const float a = A[b * asb + h * ash];
    const float* db = dt + b * dsb + h * dsh;
    // C B^T of chunk k of this (batch, group): cbg + k * G * Q * Q
    const float* cbg = cb + ((int64_t)b * nc * G + grp) * Q * Q;

    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
        mbar_fence_init();
        for (int s = 0; s < STAGES && s < nc; ++s)
            load_chunk<N>(ring + s * SB, &full[s], &tx, &tb, &tc, h, grp, s * Q, b);
    }
    __syncthreads();  // the barriers are initialised before anyone waits

    // chunk k's C B^T rows warp + WARPS r at keys 2 lane, 2 lane + 1, and
    // its dt at rows 2 lane, 2 lane + 1 (0 past S): loaded a chunk ahead
    float2 cbv[RW];
    float d0, d1;
    auto fetch = [&](int k) {
        const float* c = cbg + (int64_t)k * G * Q * Q + 2 * lane;
#pragma unroll
        for (int r = 0; r < RW; ++r)
            cbv[r] = *reinterpret_cast<const float2*>(c + (warp + WARPS * r) * Q);
        const int r0 = k * Q + 2 * lane;
        d0 = r0 < S ? db[(int64_t)r0 * dss] : 0.f;
        d1 = r0 + 1 < S ? db[(int64_t)(r0 + 1) * dss] : 0.f;
    };
    fetch(0);

    // this thread's part of the state h (P x N): in the accumulator layout
    // of an m16n8 tile, rows p = 16 warp + g (+ 8), columns n = 8 nt + 2t (+1)
    float hs[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[n][e] = 0.f;

    for (int k = 0; k < nc; ++k) {
        const int s0 = k * Q;
        const int valid = min(Q, S - s0);

        // ---- cum = cumsum(dt * A): an inclusive warp scan of the pair
        // sums in a fixed order, as in the float32 kernel --------------------
        const float a0 = d0 * a, a1 = d1 * a;
        float incl = a0 + a1;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float v = __shfl_up_sync(FULL, incl, off);
            if (lane >= off) incl += v;
        }
        float excl = __shfl_up_sync(FULL, incl, 1);
        if (lane == 0) excl = 0.f;
        const float c0 = excl + a0, c1 = incl;
        // cum_last is the last valid row's own value (see the float32 kernel)
        const int lr = (valid - 1) >> 1;
        const float l0 = __shfl_sync(FULL, c0, lr);
        const float l1 = __shfl_sync(FULL, c1, lr);
        const float last = ((valid - 1) & 1) ? l1 : l0;

        // ---- S[i][j] = (C B^T)[i][j] exp(cum_i - cum_j) dt_j, the mask on
        // the log before exp; rows warp + WARPS r, keys 2 lane, 2 lane + 1 ---
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int i = warp + WARPS * r, j = 2 * lane;
            const float ci0 = __shfl_sync(FULL, c0, i >> 1);
            const float ci1 = __shfl_sync(FULL, c1, i >> 1);
            const float ci = (i & 1) ? ci1 : ci0;
            const float v0 = cbv[r].x * expf(i >= j ? ci - c0 : SSD_NEG_INF) * d0;
            const float v1 = cbv[r].y * expf(i >= j + 1 ? ci - c1 : SSD_NEG_INF) * d1;
            uint32_t hi, lo;
            split_bf16x2(v0, v1, hi, lo);
            const int off = sw128(i, lane / 4) + (lane % 4) * 4;
            *reinterpret_cast<uint32_t*>(Shi + off) = hi;
            *reinterpret_cast<uint32_t*>(Slo + off) = lo;
        }
        const float ec0 = expf(c0), ec1 = expf(c1);             // exp(cum_i)
        const float dw0 = d0 * expf(last - c0), dw1 = d1 * expf(last - c1);
        const float decay = expf(last);
        if (k + 1 < nc) fetch(k + 1);

        mbar_wait(&full[k % STAGES], (k / STAGES) & 1);
        __syncthreads();  // S is whole; chunk k's tiles have landed
        const unsigned char* Xt = ring + (k % STAGES) * SB;
        const unsigned char* Bt = Xt + TILE;
        const unsigned char* Ct = Bt + NB * TILE;

        if (warp < P / 16) {
            // x^T of this warp's 16 rows p: A fragments of k-step kj over j
            // (x's rows j are the k dim), by ldmatrix.trans
            uint32_t xf[KJ][4];
#pragma unroll
            for (int kj = 0; kj < KJ; ++kj)
                ldmatrix_x4_trans(xf[kj], at(Xt, kj * 16 + lane % 8 + (lane / 16) * 8,
                                             warp * 16 + ((lane / 8) % 2) * 8));

            // y_inter^T = h C^T: h from registers as hi + lo; C's rows i
            // are the n8 tiles, its columns n the k dim
            float yacc[NI][4];
#pragma unroll
            for (int it = 0; it < NI; ++it)
#pragma unroll
                for (int e = 0; e < 4; ++e) yacc[it][e] = 0.f;
#pragma unroll
            for (int kn = 0; kn < KN; ++kn) {
                uint32_t ahi[4], alo[4];
                split_bf16x2(hs[2 * kn][0], hs[2 * kn][1], ahi[0], alo[0]);
                split_bf16x2(hs[2 * kn][2], hs[2 * kn][3], ahi[1], alo[1]);
                split_bf16x2(hs[2 * kn + 1][0], hs[2 * kn + 1][1], ahi[2], alo[2]);
                split_bf16x2(hs[2 * kn + 1][2], hs[2 * kn + 1][3], ahi[3], alo[3]);
#pragma unroll
                for (int it = 0; it < NI; it += 2) {
                    uint32_t r[4];
                    ldmatrix_x4(r, at(Ct, it * 8 + (lane / 16) * 8 + lane % 8,
                                      kn * 16 + ((lane / 8) % 2) * 8));
                    mma_bf16(yacc[it], ahi, r);
                    mma_bf16(yacc[it], alo, r);
                    mma_bf16(yacc[it + 1], ahi, r + 2);
                    mma_bf16(yacc[it + 1], alo, r + 2);
                }
            }
            // times exp(cum_i), column i = 8 it + 2t (+1): rows of lane 4 it + t
#pragma unroll
            for (int it = 0; it < NI; ++it) {
                const float e0 = __shfl_sync(FULL, ec0, 4 * it + t);
                const float e1 = __shfl_sync(FULL, ec1, 4 * it + t);
                yacc[it][0] *= e0; yacc[it][1] *= e1;
                yacc[it][2] *= e0; yacc[it][3] *= e1;
            }
            // y_intra^T = x^T S^T: S's rows i are the n8 tiles, its keys j
            // the k dim; key blocks above row block ib are never read
#pragma unroll
            for (int ib = 0; ib < KJ; ++ib)
#pragma unroll
                for (int kj = 0; kj <= ib; ++kj) {
                    uint32_t rh[4], rl[4];
                    const int row = ib * 16 + (lane / 16) * 8 + lane % 8;
                    const int col = kj * 16 + ((lane / 8) % 2) * 8;
                    ldmatrix_x4(rh, at(Shi, row, col));
                    ldmatrix_x4(rl, at(Slo, row, col));
                    mma_bf16(yacc[2 * ib], xf[kj], rh);
                    mma_bf16(yacc[2 * ib], xf[kj], rl);
                    mma_bf16(yacc[2 * ib + 1], xf[kj], rh + 2);
                    mma_bf16(yacc[2 * ib + 1], xf[kj], rl + 2);
                }
            // y[b, s0 + i, h, p]: rows p = 16 warp + g (+ 8), i = 8 it + 2t (+1)
            float* yb = y + ((int64_t)b * S + s0) * H * P + (int64_t)h * P
                        + warp * 16 + g;
#pragma unroll
            for (int it = 0; it < NI; ++it)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = it * 8 + 2 * t + (e & 1);
                    if (i < valid)
                        yb[(int64_t)i * H * P + (e >> 1) * 8] = yacc[it][e];
                }

            // h = exp(cum_last) h + (x o dt w)^T B: the A fragments are x's,
            // times dt_j w_j of their columns j = 16 kj + 2t (+1) (+ 8), as
            // hi + lo; B's rows j are the k dim, read by ldmatrix.trans
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) hs[n][e] *= decay;
#pragma unroll
            for (int kj = 0; kj < KJ; ++kj) {
                const float w0 = __shfl_sync(FULL, dw0, 8 * kj + t);
                const float w1 = __shfl_sync(FULL, dw1, 8 * kj + t);
                const float w2 = __shfl_sync(FULL, dw0, 8 * kj + 4 + t);
                const float w3 = __shfl_sync(FULL, dw1, 8 * kj + 4 + t);
                const float2 x0 = unpack_bf16x2(xf[kj][0]);  // row g,     j
                const float2 x1 = unpack_bf16x2(xf[kj][1]);  // row g + 8, j
                const float2 x2 = unpack_bf16x2(xf[kj][2]);  // row g,     j + 8
                const float2 x3 = unpack_bf16x2(xf[kj][3]);  // row g + 8, j + 8
                uint32_t ahi[4], alo[4];
                split_bf16x2(x0.x * w0, x0.y * w1, ahi[0], alo[0]);
                split_bf16x2(x1.x * w0, x1.y * w1, ahi[1], alo[1]);
                split_bf16x2(x2.x * w2, x2.y * w3, ahi[2], alo[2]);
                split_bf16x2(x3.x * w2, x3.y * w3, ahi[3], alo[3]);
#pragma unroll
                for (int n = 0; n < NT; n += 2) {
                    // matrices: keys (lo, hi 8) x n 8n.., keys (lo, hi) x n 8n+8..
                    uint32_t r[4];
                    ldmatrix_x4_trans(r, at(Bt, kj * 16 + lane % 16, n * 8 + (lane / 16) * 8));
                    mma_bf16(hs[n], ahi, r);
                    mma_bf16(hs[n], alo, r);
                    mma_bf16(hs[n + 1], ahi, r + 2);
                    mma_bf16(hs[n + 1], alo, r + 2);
                }
            }
        }
        __syncthreads();  // every warp is done with this stage and with S
        if (threadIdx.x == 0 && k + STAGES < nc)
            load_chunk<N>(ring + (k % STAGES) * SB, &full[k % STAGES], &tx, &tb,
                          &tc, h, grp, (k + STAGES) * Q, b);
    }

    if (warp < P / 16) {
        float* hb = state + b * hsb + h * hsh;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                hb[(int64_t)(warp * 16 + g + (e >> 1) * 8) * hsp + n * 8 + 2 * t + (e & 1)]
                    = hs[n][e];
    }
}

// x (B, S, H, P) or B/C (B, S, G, N) through its element strides {batch,
// seq, head or group}, as a 4-D bf16 tensor map (inner, heads, S, B) read
// in boxes of 64 rows of one head or group
static bool ssd_map(CUtensorMap* map, const void* base, int Bz, int S,
                    int heads, int inner, const int64_t* st)
{
    const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)heads,
                                (cuuint64_t)S, (cuuint64_t)Bz};
    const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                   (cuuint64_t)st[0] * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)ssdt::Q, 1};
    return bf16_box_map(map, base, 4, dims, strides, box);
}

template <int P, int N>
static int ssd_scan_bf16_run(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, void* y,
                             void* state, void* cb, int Bz, int S, int H,
                             int G, const int64_t* xst, const int64_t* dst,
                             const int64_t* ast, const int64_t* bst,
                             const int64_t* cst, const int64_t* hst,
                             cudaStream_t stream)
{
    CUtensorMap tx, tb, tc;
    if (!ssd_map(&tx, x, Bz, S, H, P, xst) || !ssd_map(&tb, Bm, Bz, S, G, N, bst)
        || !ssd_map(&tc, Cm, Bz, S, G, N, cst))
        return (int)cudaErrorInvalidValue;
    const int nc = (S + ssdt::Q - 1) / ssdt::Q;
    size_t smem = ssdt::cb_smem_bytes<N>();
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_cb_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_cb_kernel<N><<<dim3((unsigned)nc, (unsigned)G, (unsigned)Bz),
                             ssdt::THREADS, smem, stream>>>(tb, tc, (float*)cb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    smem = ssdt::scan_smem_bytes<N>();
    err = cudaFuncSetAttribute(ssd_scan_bf16_kernel<P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd_scan_bf16_kernel<P, N><<<dim3((unsigned)H, (unsigned)Bz), ssdt::THREADS,
                                 smem, stream>>>(
        tx, tb, tc, (const float*)cb, (const float*)dt, (const float*)A,
        (float*)y, (float*)state, S, H, G, dst[0], dst[1], dst[2], ast[0],
        ast[1], hst[0], hst[1], hst[2]);
    return (int)cudaGetLastError();
}

// the scan kernel's residency on this device: blocks per SM, registers a
// thread, static and dynamic shared memory a block (bytes)
template <int P, int N>
static int ssd_scan_bf16_occupancy_of(int* out)
{
    const size_t smem = ssdt::scan_smem_bytes<N>();
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_bf16_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, ssd_scan_bf16_kernel<P, N>);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ssd_scan_bf16_kernel<P, N>, ssdt::THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    out[0] = blocks;
    out[1] = attr.numRegs;
    out[2] = (int)attr.sharedSizeBytes;
    out[3] = (int)smem;
    return 0;
}

// f(P, N) with P and N as compile-time constants (std::integral_constant),
// for the sizes the kernels are built for (HEAD_DIMS x STATE_DIMS of the
// wrapper); any other size is cudaErrorInvalidValue
template <typename F>
static int with_sizes(int P, int N, F&& f)
{
    auto over_n = [&](auto p) -> int {
        switch (N) {
        case 16:  return f(p, std::integral_constant<int, 16>{});
        case 32:  return f(p, std::integral_constant<int, 32>{});
        case 64:  return f(p, std::integral_constant<int, 64>{});
        case 128: return f(p, std::integral_constant<int, 128>{});
        default:  return (int)cudaErrorInvalidValue;
        }
    };
    switch (P) {
    case 16: return over_n(std::integral_constant<int, 16>{});
    case 32: return over_n(std::integral_constant<int, 32>{});
    case 64: return over_n(std::integral_constant<int, 64>{});
    default: return (int)cudaErrorInvalidValue;
    }
}

// The float32 route (x, B, C float32). Strides in elements: x, dt {batch,
// seq, head}; A {batch, head}; B, C {batch, seq, group}; state {batch, head,
// p}. y is (B, S, H, P) float32, contiguous.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, int Bz, int S, int H, int G, int P,
    int N, const int64_t* x_strides, const int64_t* dt_strides,
    const int64_t* a_strides, const int64_t* b_strides,
    const int64_t* c_strides, const int64_t* state_strides, void* stream)
{
    return with_sizes(P, N, [&](auto p, auto n) {
        return ssd_scan_run<float, decltype(p)::value, decltype(n)::value>(
            x, dt, A, B, C, y, state, Bz, S, H, G, x_strides, dt_strides,
            a_strides, b_strides, c_strides, state_strides,
            (cudaStream_t)stream);
    });
}

// The bf16 route (x, B, C bf16): the same layout, every row of x, B and C
// 16-byte aligned (TMA); cb is a float32 workspace of (B, ceil(S / 64), G,
// 64, 64) that receives C B^T. Launches ssd_chunk_cb_kernel, then
// ssd_scan_bf16_kernel, on the stream.
extern "C" int ssd_scan_bf16_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, void* cb, int Bz, int S, int H,
    int G, int P, int N, const int64_t* x_strides, const int64_t* dt_strides,
    const int64_t* a_strides, const int64_t* b_strides,
    const int64_t* c_strides, const int64_t* state_strides, void* stream)
{
    return with_sizes(P, N, [&](auto p, auto n) {
        return ssd_scan_bf16_run<decltype(p)::value, decltype(n)::value>(
            x, dt, A, B, C, y, state, cb, Bz, S, H, G, x_strides, dt_strides,
            a_strides, b_strides, c_strides, state_strides,
            (cudaStream_t)stream);
    });
}

// out[4]: ssd_scan_bf16_kernel<P, N>'s blocks per SM on the current
// device, its registers a thread, its static and dynamic shared memory
extern "C" int ssd_scan_bf16_occupancy(int P, int N, int* out)
{
    return with_sizes(P, N, [&](auto p, auto n) {
        return ssd_scan_bf16_occupancy_of<decltype(p)::value, decltype(n)::value>(out);
    });
}
