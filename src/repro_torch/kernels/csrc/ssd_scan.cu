// B5  ssd_scan -- the Mamba-2 chunked SSD scan for NVIDIA Hopper (sm_90a).
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (see ../_build.py). No -fmad=false: the kernel promises
// agreement with its plain version within a stated tolerance, not the
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
// the last dim contiguous, nothing copied or repeated:
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
// Pallas kernel asserts S % chunk == 0, this one does not need it.
//
// Bound at the serving path's prefill (mamba2-780m: B=4, S=2048, H=48, P=64,
// N=128, G=1; bf16 x/B/C, float32 dt and y): bytes moved once are x 50.3 MB,
// y 100.7 MB, the state 6.3 MB, B/C/dt 5.8 MB -- 163 MB, 0.049 ms at
// 3.35 TB/s; the sequential form's 4*P*N operations per token and head are
// 12.9 GFLOP, 0.013 ms at 989 TFLOP/s. So the bound is bytes: 0.049 ms per
// layer.
//
// Design. One block of 256 threads per (head, batch): 192 blocks at the
// serving shape on 132 SMs. A loop inside the block walks the chunks in
// order -- it takes the place of the Pallas kernel's sequential chunk grid
// axis, since blocks on Hopper run in no order and share nothing -- and the
// (P, N) state stays in shared memory from the first chunk to the last; it
// never goes to device memory between chunks, which is the Pallas kernel's
// point, kept. Q = 64 is this kernel's own chunk, chosen for shared memory:
// per block, float32, rows padded by 4 floats (conflict-free float4 reads),
//   C and B chunks   2 * Q * (N + 4) * 4 B = 67.6 KB at N = 128
//   x chunk          Q * (P + 4) * 4 B     = 17.4 KB at P = 64
//   the Q x Q tile   Q * (Q + 4) * 4 B     = 17.4 KB
//   the state h^T    N * (P + 4) * 4 B     = 34.8 KB
//   per-row vectors  4 * Q * 4 B           =  1.0 KB
// = 138.3 KB at the serving shape (above 48 KB, so the launcher raises the
// block's limit with cudaFuncSetAttribute; one block per SM). The result
// does not depend on Q except by rounding. Each thread owns a 4 x 4 block of
// the Q x Q score tile, 4 rows x P/16 columns of y, and N/16 x P/16 entries
// of the state; score blocks above the diagonal (j-block > i-block) are
// neither computed nor read. The in-chunk cumsum is a fixed-order warp scan,
// every other sum a fixed-order loop: a result is the same from run to run.
// The products run on the CUDA cores in float32 (18.9 GFLOP of FMAs at the
// serving shape, 1.5 times the sequential form's): simple and right first.
// Tensor cores (mma.sync, then wgmma on the Q x Q and Q x N products),
// splitting a head's P over more blocks, and sharing C B^T across the heads
// of a group are the later work that would approach the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SSD_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T, int P>
static int ssd_scan_dispatch_n(int N, const void* x, const void* dt,
                               const void* A, const void* Bm, const void* Cm,
                               void* y, void* state, int Bz, int S, int H,
                               int G, const int64_t* xst, const int64_t* dst,
                               const int64_t* ast, const int64_t* bst,
                               const int64_t* cst, const int64_t* hst,
                               cudaStream_t s)
{
    switch (N) {
    case 16:  return ssd_scan_run<T, P, 16>(x, dt, A, Bm, Cm, y, state, Bz, S, H, G, xst, dst, ast, bst, cst, hst, s);
    case 32:  return ssd_scan_run<T, P, 32>(x, dt, A, Bm, Cm, y, state, Bz, S, H, G, xst, dst, ast, bst, cst, hst, s);
    case 64:  return ssd_scan_run<T, P, 64>(x, dt, A, Bm, Cm, y, state, Bz, S, H, G, xst, dst, ast, bst, cst, hst, s);
    case 128: return ssd_scan_run<T, P, 128>(x, dt, A, Bm, Cm, y, state, Bz, S, H, G, xst, dst, ast, bst, cst, hst, s);
    default:  return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
static int ssd_scan_dispatch(int P, int N, const void* x, const void* dt,
                             const void* A, const void* Bm, const void* Cm,
                             void* y, void* state, int Bz, int S, int H, int G,
                             const int64_t* xst, const int64_t* dst,
                             const int64_t* ast, const int64_t* bst,
                             const int64_t* cst, const int64_t* hst,
                             cudaStream_t s)
{
    switch (P) {
    case 16: return ssd_scan_dispatch_n<T, 16>(N, x, dt, A, Bm, Cm, y, state, Bz, S, H, G, xst, dst, ast, bst, cst, hst, s);
    case 32: return ssd_scan_dispatch_n<T, 32>(N, x, dt, A, Bm, Cm, y, state, Bz, S, H, G, xst, dst, ast, bst, cst, hst, s);
    case 64: return ssd_scan_dispatch_n<T, 64>(N, x, dt, A, Bm, Cm, y, state, Bz, S, H, G, xst, dst, ast, bst, cst, hst, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// is_bf16: 1 when x, B and C are bf16, 0 when float32. Strides in
// elements: x, dt {batch, seq, head}; A {batch, head}; B, C {batch, seq,
// group}; state {batch, head, p}. y is (B, S, H, P) float32, contiguous.
extern "C" int ssd_scan_launch(
    int is_bf16, const void* x, const void* dt, const void* A,
    const void* B, const void* C, void* y, void* state,
    int Bz, int S, int H, int G, int P, int N,
    const int64_t* x_strides, const int64_t* dt_strides,
    const int64_t* a_strides, const int64_t* b_strides,
    const int64_t* c_strides, const int64_t* state_strides, void* stream)
{
    if (is_bf16)
        return ssd_scan_dispatch<__nv_bfloat16>(
            P, N, x, dt, A, B, C, y, state, Bz, S, H, G, x_strides, dt_strides,
            a_strides, b_strides, c_strides, state_strides, (cudaStream_t)stream);
    return ssd_scan_dispatch<float>(
        P, N, x, dt, A, B, C, y, state, Bz, S, H, G, x_strides, dt_strides,
        a_strides, b_strides, c_strides, state_strides, (cudaStream_t)stream);
}
