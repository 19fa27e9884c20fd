// The backward of causal GQA attention for NVIDIA Hopper (sm_90a): kernel B9.
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (see ../_build.py). No -fmad=false: B9 promises agreement with
// its plain version within a stated tolerance, and the same bits from run to
// run -- not the plain version's bits.
//
// Replaces no Pallas kernel: the JAX package trains through jax.vjp of its
// attention (src/repro/models/common.py:281-300, autodiff of plain_attention
// / flash_attention_jax). The port's forward on the card is kernel B3
// (attention.cu), which keeps no (S, S) probabilities, so the backward is a
// kernel of its own: given q, k, v, the output o, B3's row log-sum-exp lse
// and the output's gradient do, it returns dq, dk, dv.
//
// Layout: q, o, do, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, Hkv, D), all
// dense; query head h reads KV head h / (H / Hkv), as B3. lse and the
// pre-pass's Delta are float32 (B, H, Sq). s = scale * q.k over live keys
// (causal: key j <= query i, and j < Sk); P = exp(s - lse);
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),  Delta = rowsum(dO o O),
//   dQ = scale dS K,  dK = scale dS^T Q.
//
// Bound: 5 matmuls of the live (causal) half -- q k^T, dO V^T, P^T dO,
// dS^T Q, dS K -- 5 B H S^2 D operations at S = Sq = Sk against reading the
// six inputs and writing three outputs once; at the training path's shape
// (B 1, S 2048, H 16, Hkv 2, D 128) that is 43 GFLOP against 21 MB in bf16,
// thousands of operations per byte: bound by operations.
//
// Design (this PR's; a tensor-core redesign is queued as R6): simple, right
// and deterministic. Every sum is taken in a fixed order and no float atomic
// is used anywhere, so a result is the same from run to run -- the training
// loop's bit-exact resume rests on it. The work runs on the CUDA cores in
// float32 (bf16 inputs are widened as they are loaded), with the tiles in
// shared memory and each thread a 4 x 4 block of a 64 x 64 score tile, the
// float32 forward's (B3's flash_attention_kernel) layout. Four kernels, in
// stream order:
//   attention_bwd_delta_kernel: Delta, a warp per (batch, row, head), the
//     row's D products summed by a fixed butterfly.
//   attention_bwd_dkdv_kernel: one block per (key tile of 64, query head,
//     batch), the key tiles the grid's slowest axis so the longest (the
//     first: they meet every query tile below them) start first. It holds
//     its K and V tiles and walks the query tiles on or below the diagonal
//     in order; S and dP are recomputed per tile, P and dS go through
//     shared memory, and dK, dV accumulate in registers. Tiles above the
//     diagonal are never loaded. A block per query head -- not per KV head,
//     looping over the group's heads -- because at the training shape that
//     would be 64 blocks for 132 SMs; the per-head partials go to a float32
//     workspace (B, Sk, H, D) each.
//   attention_bwd_reduce_kernel: dK and dV of each KV head as the sum of its
//     group's partials in head order, rounded once to the output's type.
//   attention_bwd_dq_kernel: one block per (query tile, head, batch), the
//     longest (the last tiles) first, over the key tiles up to the diagonal,
//     dQ in registers.
// Every launcher runs on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace fb {
constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr int SLD = BK + 4;  // padded P / dS row
template <int D> __host__ __device__ constexpr int ld() { return D + 4; }  // padded q/k/v row
// the output column of a thread's j-th accumulator (B3's float32 layout)
template <int D> __device__ __forceinline__ int out_col(int tx, int j) {
    if constexpr (D % 64 == 0) return (j / 4) * 64 + 4 * tx + (j % 4);
    else return tx + 16 * j;
}
// dK/dV: K, V, Q, dO tiles, P and dS, lse and Delta of the query tile
template <int D> constexpr size_t dkdv_smem() {
    return sizeof(float) * (size_t)(4 * 64 * ld<D>() + 2 * BQ * SLD + 2 * BQ);
}
// dQ: Q, dO, K, V tiles, dS, lse and Delta of the query tile
template <int D> constexpr size_t dq_smem() {
    return sizeof(float) * (size_t)(4 * 64 * ld<D>() + BQ * SLD + 2 * BQ);
}
}  // namespace fb

__device__ __forceinline__ float bw_f(float x) { return x; }
__device__ __forceinline__ float bw_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T bw_from(float x);
template <> __device__ __forceinline__ float bw_from<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 bw_from<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// rows [r0, r0 + 64) of head h of a dense (B, S, heads, D) tensor into a
// 64 x ld<D> float tile; rows past S are zeros
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int r0, int h, int S, int heads)
{
    constexpr int LD = fb::ld<D>();
    for (int i = threadIdx.x; i < 64 * D; i += fb::THREADS) {
        const int r = i / D, c = i % D, s = r0 + r;
        dst[r * LD + c] = s < S ? bw_f(src[(((int64_t)b * S + s) * heads + h) * D + c]) : 0.f;
    }
}

// acc[i][j] += rows (ty + 16 i) of A . rows (tx + 16 j) of Bt over D: a 64 x 64
// tile of A Bt^T, each thread its 4 x 4, the products in d order
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* Bt, int ty, int tx)
{
    constexpr int LD = fb::ld<D>();
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
        float4 a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            bb[j] = *reinterpret_cast<const float4*>(&Bt[(tx + 16 * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float s = acc[i][j];
                s = fmaf(a[i].x, bb[j].x, s);
                s = fmaf(a[i].y, bb[j].y, s);
                s = fmaf(a[i].z, bb[j].z, s);
                s = fmaf(a[i].w, bb[j].w, s);
                acc[i][j] = s;
            }
    }
}

// acc[i][j] += sum over the 64 rows r, in order, of W[r][ty + 16 i] * X[r][out_col(tx, j)]
// (transposed: W is read down its columns) -- P^T dO, dS^T Q -- or, with
// W_ROWS, of W[ty + 16 i][r] * X[r][...] -- dS K
template <int D, bool W_ROWS>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16], const float* W,
                                         const float* X, int ty, int tx)
{
    constexpr int LD = fb::ld<D>();
    constexpr int NC = D / 16;
#pragma unroll 4
    for (int r = 0; r < 64; ++r) {
        float w[4], x[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            w[i] = W_ROWS ? W[(ty + 16 * i) * fb::SLD + r] : W[r * fb::SLD + ty + 16 * i];
        if constexpr (D % 64 == 0) {
#pragma unroll
            for (int j = 0; j < NC; j += 4) {
                const float4 f = *reinterpret_cast<const float4*>(
                    &X[r * LD + fb::out_col<D>(tx, j)]);
                x[j] = f.x; x[j + 1] = f.y; x[j + 2] = f.z; x[j + 3] = f.w;
            }
        } else {
#pragma unroll
            for (int j = 0; j < NC; ++j) x[j] = X[r * LD + fb::out_col<D>(tx, j)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(w[i], x[j], acc[i][j]);
    }
}

// P and dS of one (query tile q0, key tile k0) pair, thread (ty, tx)'s 4 x 4:
// s and dp hold q.k and dO.v; lse_s / dl_s the query tile's lse and Delta
__device__ __forceinline__ void p_and_ds(float (&s)[4][4], float (&dp)[4][4],
                                         const float* lse_s, const float* dl_s,
                                         int q0, int k0, int Sq, int Sk, int causal,
                                         float scale, int ty, int tx)
{
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int kpos = k0 + tx + 16 * j;
            const bool ok = qpos < Sq && kpos < Sk && (!causal || kpos <= qpos);
            const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
            s[i][j] = p;
            dp[i][j] = p * (dp[i][j] - dl_s[r]);
        }
    }
}

// Delta = rowsum(dO o O) per (batch, row, head): a warp a row, lanes over D
template <typename T, int D>
__global__ void __launch_bounds__(256)
attention_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int B, int H, int Sq)
{
    const int lane = threadIdx.x % 32;
    const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;  // (b, s, h)
    if (row >= (int64_t)B * Sq * H) return;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
        acc = fmaf(bw_f(o[row * D + d]), bw_f(dout[row * D + d]), acc);
#pragma unroll
    for (int off = 16; off >= 1; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
        const int h = (int)(row % H);
        const int64_t bs = row / H;
        const int s = (int)(bs % Sq), b = (int)(bs / Sq);
        delta[((int64_t)b * H + h) * Sq + s] = acc;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(fb::THREADS, 1)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk_ws, float* __restrict__ dv_ws,
                          int H, int Hkv, int Sq, int Sk, float scale, int causal)
{
    using namespace fb;
    constexpr int LD = ld<D>();
    constexpr int NC = D / 16;
    extern __shared__ float smem[];
    float* Ks = smem;               // 64 x LD
    float* Vs = Ks + 64 * LD;
    float* Qs = Vs + 64 * LD;
    float* dOs = Qs + 64 * LD;
    float* Ps = dOs + 64 * LD;      // BQ x SLD, P[q][k]
    float* dSs = Ps + BQ * SLD;     // BQ x SLD, dS[q][k]
    float* lse_s = dSs + BQ * SLD;  // BQ
    float* dl_s = lse_s + BQ;       // BQ

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int k0 = kt * BK;
    const int n_qt = (Sq + BQ - 1) / BQ;
    // query tiles that can see key k0: those holding a row >= k0
    const int qt0 = causal ? k0 / BQ : 0;

    load_rows<T, D>(Ks, k, b, k0, hk, Sk, Hkv);
    load_rows<T, D>(Vs, v, b, k0, hk, Sk, Hkv);

    float dk[4][NC], dv[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) { dk[i][j] = 0.f; dv[i][j] = 0.f; }

    for (int qt = qt0; qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();  // the previous tile is done with Qs, dOs, Ps, dSs
        load_rows<T, D>(Qs, q, b, q0, h, Sq, H);
        load_rows<T, D>(dOs, dout, b, q0, h, Sq, H);
        if (tid < BQ) {
            const bool in = q0 + tid < Sq;
            const int64_t at = ((int64_t)b * H + h) * Sq + q0 + tid;
            lse_s[tid] = in ? lse[at] : 0.f;
            dl_s[tid] = in ? delta[at] : 0.f;
        }
        __syncthreads();

        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
        tile_dot<D>(s, Qs, Ks, ty, tx);
        tile_dot<D>(dp, dOs, Vs, ty, tx);
        p_and_ds(s, dp, lse_s, dl_s, q0, k0, Sq, Sk, causal, scale, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                Ps[(ty + 16 * i) * SLD + tx + 16 * j] = s[i][j];
                dSs[(ty + 16 * i) * SLD + tx + 16 * j] = dp[i][j];
            }
        __syncthreads();

        // this thread's key rows ty + 16 i: dV += P^T dO, dK += dS^T Q
        tile_acc<D, false>(dv, Ps, dOs, ty, tx);
        tile_acc<D, false>(dk, dSs, Qs, ty, tx);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s_ = k0 + ty + 16 * i;
        if (s_ >= Sk) continue;
        const int64_t row = (((int64_t)b * Sk + s_) * H + h) * D;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            dk_ws[row + out_col<D>(tx, j)] = dk[i][j] * scale;
            dv_ws[row + out_col<D>(tx, j)] = dv[i][j];
        }
    }
}

// dK / dV of KV head hk: its group's per-head partials summed in head order
template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_reduce_kernel(const float* __restrict__ dk_ws, const float* __restrict__ dv_ws,
                            T* __restrict__ dk, T* __restrict__ dv,
                            int64_t n, int H, int Hkv, int D)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;  // (b, s, hk, d)
    if (i >= n) return;
    const int G = H / Hkv;
    const int d = (int)(i % D);
    const int64_t bsh = i / D;
    const int hk = (int)(bsh % Hkv);
    const int64_t bs = bsh / Hkv;
    const int64_t base = (bs * H + (int64_t)hk * G) * D + d;
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < G; ++g) {
        sk += dk_ws[base + (int64_t)g * D];
        sv += dv_ws[base + (int64_t)g * D];
    }
    dk[i] = bw_from<T>(sk);
    dv[i] = bw_from<T>(sv);
}

template <typename T, int D>
__global__ void __launch_bounds__(fb::THREADS, 1)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int H, int Hkv, int Sq, int Sk,
                        float scale, int causal)
{
    using namespace fb;
    constexpr int LD = ld<D>();
    constexpr int NC = D / 16;
    extern __shared__ float smem[];
    float* Qs = smem;
    float* dOs = Qs + 64 * LD;
    float* Ks = dOs + 64 * LD;
    float* Vs = Ks + 64 * LD;
    float* dSs = Vs + 64 * LD;      // BQ x SLD, dS[q][k]
    float* lse_s = dSs + BQ * SLD;
    float* dl_s = lse_s + BQ;

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int h = blockIdx.x, b = blockIdx.y;
    const int n_qt = (int)gridDim.z, qt = n_qt - 1 - (int)blockIdx.z;
    const int hk = h / (H / Hkv);
    const int q0 = qt * BQ;

    load_rows<T, D>(Qs, q, b, q0, h, Sq, H);
    load_rows<T, D>(dOs, dout, b, q0, h, Sq, H);
    if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        const int64_t at = ((int64_t)b * H + h) * Sq + q0 + tid;
        lse_s[tid] = in ? lse[at] : 0.f;
        dl_s[tid] = in ? delta[at] : 0.f;
    }

    // keys [0, k_end) can be live for some row of this tile; later tiles
    // are never loaded
    const int q_last = min(q0 + BQ, Sq) - 1;
    const int k_end = causal ? min(q_last + 1, Sk) : Sk;
    const int n_tiles = (k_end + BK - 1) / BK;

    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();  // the previous tile is done with Ks, Vs, dSs
        load_rows<T, D>(Ks, k, b, k0, hk, Sk, Hkv);
        load_rows<T, D>(Vs, v, b, k0, hk, Sk, Hkv);
        __syncthreads();

        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
        tile_dot<D>(s, Qs, Ks, ty, tx);
        tile_dot<D>(dp, dOs, Vs, ty, tx);
        p_and_ds(s, dp, lse_s, dl_s, q0, k0, Sq, Sk, causal, scale, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * SLD + tx + 16 * j] = dp[i][j];
        __syncthreads();

        // this thread's query rows ty + 16 i: dQ += dS K
        tile_acc<D, true>(acc, dSs, Ks, ty, tx);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s_ = q0 + ty + 16 * i;
        if (s_ >= Sq) continue;
        T* row = dq + (((int64_t)b * Sq + s_) * H + h) * D;
#pragma unroll
        for (int j = 0; j < NC; ++j) row[out_col<D>(tx, j)] = bw_from<T>(acc[i][j] * scale);
    }
}

template <typename T, int D>
static int attention_bwd_run(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta,
                             float* dk_ws, float* dv_ws, void* dq, void* dk, void* dv,
                             int B, int H, int Hkv, int Sq, int Sk, float scale,
                             int causal, cudaStream_t stream)
{
    const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v,
            *to = (const T*)o, *tdo = (const T*)dout;
    const int64_t rows = (int64_t)B * Sq * H;
    attention_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
        to, tdo, delta, B, H, Sq);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const size_t s1 = fb::dkdv_smem<D>();
    err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
    if (err != cudaSuccess) return (int)err;
    dim3 g1((unsigned)H, (unsigned)B, (unsigned)((Sk + fb::BK - 1) / fb::BK));
    attention_bwd_dkdv_kernel<T, D><<<g1, fb::THREADS, s1, stream>>>(
        tq, tk, tv, tdo, lse, delta, dk_ws, dv_ws, H, Hkv, Sq, Sk, scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int64_t n = (int64_t)B * Sk * Hkv * D;
    attention_bwd_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        dk_ws, dv_ws, (T*)dk, (T*)dv, n, H, Hkv, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const size_t s2 = fb::dq_smem<D>();
    err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
    if (err != cudaSuccess) return (int)err;
    dim3 g2((unsigned)H, (unsigned)B, (unsigned)((Sq + fb::BQ - 1) / fb::BQ));
    attention_bwd_dq_kernel<T, D><<<g2, fb::THREADS, s2, stream>>>(
        tq, tk, tv, tdo, lse, delta, (T*)dq, H, Hkv, Sq, Sk, scale, causal);
    return (int)cudaGetLastError();
}

template <typename T>
static int attention_bwd_dispatch(int D, const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const float* lse,
                                  float* delta, float* dk_ws, float* dv_ws, void* dq,
                                  void* dk, void* dv, int B, int H, int Hkv, int Sq,
                                  int Sk, float scale, int causal, cudaStream_t s)
{
    switch (D) {
    case 16:  return attention_bwd_run<T, 16>(q, k, v, o, dout, lse, delta, dk_ws, dv_ws, dq, dk, dv, B, H, Hkv, Sq, Sk, scale, causal, s);
    case 32:  return attention_bwd_run<T, 32>(q, k, v, o, dout, lse, delta, dk_ws, dv_ws, dq, dk, dv, B, H, Hkv, Sq, Sk, scale, causal, s);
    case 64:  return attention_bwd_run<T, 64>(q, k, v, o, dout, lse, delta, dk_ws, dv_ws, dq, dk, dv, B, H, Hkv, Sq, Sk, scale, causal, s);
    case 128: return attention_bwd_run<T, 128>(q, k, v, o, dout, lse, delta, dk_ws, dv_ws, dq, dk, dv, B, H, Hkv, Sq, Sk, scale, causal, s);
    default:  return (int)cudaErrorInvalidValue;
    }
}

// is_bf16: 1 for bf16 tensors, 0 for float32. Every tensor dense: q, o, dout,
// dq (B, Sq, H, D); k, v, dk, dv (B, Sk, Hkv, D); lse and delta (B, H, Sq)
// float32 (delta is written: the pre-pass's rowsum(dout o o)); dk_ws and
// dv_ws (B, Sk, H, D) float32 workspaces, written before they are read.
extern "C" int flash_attention_bwd_launch(
    int is_bf16, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dk_ws, float* dv_ws,
    void* dq, void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int D,
    float scale, int causal, void* stream)
{
    if (is_bf16)
        return attention_bwd_dispatch<__nv_bfloat16>(
            D, q, k, v, o, dout, lse, delta, dk_ws, dv_ws, dq, dk, dv, B, H, Hkv,
            Sq, Sk, scale, causal, (cudaStream_t)stream);
    return attention_bwd_dispatch<float>(
        D, q, k, v, o, dout, lse, delta, dk_ws, dv_ws, dq, dk, dv, B, H, Hkv, Sq,
        Sk, scale, causal, (cudaStream_t)stream);
}
