// The backward of GQA attention under B3's masks for NVIDIA Hopper (sm_90a):
// kernel B9.
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
// Layout: q, dq (B, Sq, H, D); o, do (B, Sq, H, DV); k, dk (B, Sk, Hkv, D);
// v, dv (B, Sk, Hkv, DV), all dense; query head h reads KV head h / (H /
// Hkv), as B3. lse and the pre-pass's Delta are float32 (B, H, Sq). s =
// scale * q.k over live keys -- B3's mask (attention_mask.cuh: key_live):
// causal order or none, a sliding window, a prefix OR-ed in after it, and
// j < Sk -- P = exp(s - lse);
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),  Delta = rowsum(dO o O),
//   dQ = scale dS K,  dK = scale dS^T Q.
//
// Masks and the tiles visited: dQ walks the key tiles of its query tile as
// B3 does (key_tiles: the prefix's tiles, then the band from the window's
// first key to the diagonal); dK / dV walks the transposed set, the query
// tiles that hold a live pair for its key tile (query_tiles: [k0, k_last +
// window - 1] under a window, every query tile for a tile holding a prefix
// key). So a windowed layer does O(window) work a row, and the per-element
// mask runs only in a tile pair that is not all live (tile_all_live). With
// no window or prefix both walks are the causal loop bounds they were, and
// the old head dims give the same bits (chip_attention_bits.py).
//
// Query offset: query row i sits at position q_off + i (B3's, see
// attention.cu; attention_mask.cuh adds it to every row it is given), so the
// key tiles dQ walks, the query tiles dK / dV walks and the per-element mask
// are those of the offset rows; q_off = 0 adds nothing.
//
// Head dims (D, DV) = (d, d) for d in 16, 32, 64, 80, 128, 256, (32, 16) --
// the reduced DeepSeek-V2's (24, 16) with q / k zero-padded to 32 columns by
// the wrapper, whose dq and dk columns past 24 are exact zeros and are
// dropped -- and multi-head latent attention's (192, 128): S = Q K^T, dK = dS^T Q and dQ =
// dS K run over D, dP = dO V^T, dV = P^T dO and the pre-pass's Delta over
// DV; the kernels are templated on the pair, and (d, d) is the code it was
// before DV (chip_attention_bits.py). D 80 rides tile64's boxes (two of 64
// columns, zeros past 80) on the bf16 route and a stride of 16 columns on
// the float32 one. D 256: on the bf16 route one 64-key tile's dK and dV
// accumulators would take 256 registers a thread (at D 128 the kernel
// already runs at 255), so each of dK/dV and dQ splits its output columns
// over two blocks, each recomputing the full-width S and dP for its 128
// columns -- twice the score products for D 128's register use; the
// tiles (six of 32 KB, 193 KB a block) still fit. At (192, 128) dK/dV's 320
// columns (160 floats a thread) would not fit one warp's registers either;
// there one block of eight warps holds a key tile, two warps to each 16-key
// slab (attention_bwd_dkdv_pair_bf16_kernel): each computes S^T and dP^T
// over half of a query tile and shares its bf16 P^T and dS^T through 16 KB
// of shared memory, then accumulates half of dK's and dV's columns (96 + 64,
// 80 floats a thread) -- S and dP once, where two blocks of four warps, each
// a half of the columns, computed them twice (and loaded K, V, Q and dO
// twice), and eight warps an SM where that split ran one block of four: its
// tiles, K and Q of 24 KB and V and dO of 16 KB with Q / dO double-buffered,
// take 121 KB. dQ's 192 columns (96 floats) fit one warp; there a block
// holds two 64-row query tiles, eight warps sharing each K / V tile it
// loads (161 KB: one block an SM, eight warps, and half the K / V loads a
// query row). Both keep every output element's sum in the order of the
// four-warp kernels', so the same bits (chip_attention_bits.py). On the
// float32 route four 64-row tiles of 256 floats
// would take 266 KB of shared memory, so there tiles are 32 rows (each
// thread a 2 x 2 block of the score tile), and at (192, 128) too.
//
// Bound: 5 matmuls of the live (causal) half -- q k^T, dO V^T, P^T dO,
// dS^T Q, dS K -- 5 B H S^2 D operations at S = Sq = Sk against reading the
// six inputs and writing three outputs once; at the training path's shape
// (B 1, S 2048, H 16, Hkv 2, D 128) that is 43 GFLOP against 21 MB in bf16,
// thousands of operations per byte: bound by operations, 0.043 ms on the
// tensor cores' 989 TFLOP/s (float32: 0.64 ms on the CUDA cores' 67). At
// (192, 128) three of them run over D and two over DV, B H (3 D + 2 DV)
// S^2 operations: deepseek-v2's training microbatch (B 1, S 2048, H = Hkv
// = 128) is 447 GFLOP, 0.452 ms.
//
// Both routes are deterministic: every sum is taken in a fixed order and no
// float atomic is used anywhere, so a result is the same from run to run --
// the training loop's bit-exact resume rests on it. Four kernels, in stream
// order, each route its own dK/dV and dQ kernels:
//   attention_bwd_delta_kernel: Delta, a warp per (batch, row, head), the
//     row's D products summed by a fixed butterfly.
//   dK/dV: one block per (key tile of 64, query head, batch), the first key
//     tile of a (batch, head) -- the longest: it meets every query tile
//     below it -- first. It holds its K and V tiles and walks the query
//     tiles on or below the diagonal in order, recomputing S and dP per
//     tile; dK, dV accumulate in registers. Tiles above the diagonal are
//     never loaded. A block per query head -- not per KV head, looping over
//     the group's heads -- because at the training shape that would be 64
//     blocks for 132 SMs (this way 512); the per-head partials go to float32
//     workspaces (B, Sk, H, D) and (B, Sk, H, DV). On the bf16 route a group
//     of one head (H == Hkv: multi-head latent attention, hubert's encoder)
//     has no workspace and no reduce: the kernel rounds its dK and dV to
//     bf16 and writes them, the one rounding the reduce gives one partial.
//   attention_bwd_reduce_kernel: dK and dV of each KV head as the sum of its
//     group's partials in head order, rounded once to the output's type,
//     each at its own width.
//   dQ: one block per (query tile, head, batch), the longest (the last
//     tiles) first, over the key tiles up to the diagonal in order, dQ in
//     registers. It recomputes S and dP: 7 products where the bound counts
//     5, the price of a fixed add order without atomics on dQ.
// At (192, 128) the bf16 route's blocks run in block_work's order
// (attention_mask.cuh): where the tiles a call walks -- Q / dO for dK/dV,
// K / V for dQ -- exceed half of L2, the (batch, head) pairs run in groups
// that keep them in L2. At deepseek-v2's training microbatch (1, 2048, 128
// heads), whose every head walks 1.3 MB of its own, the heads-fastest order
// re-read some 2.7 GB a kernel from HBM.
//
// bf16 (attention_bwd_dkdv_bf16_kernel, attention_bwd_dq_bf16_kernel):
// FlashAttention-2's backward on the tensor cores, from B3's building blocks
// (mma_bf16.cuh). Four warps a block, each 16 rows of the block's tile.
// dK/dV computes S^T = K Q^T and dP^T = V dO^T with mma.sync m16n8k16 (bf16
// in, float32 sums), K and V fragments by ldmatrix and Q, dO as the B
// operand (a row of Q is a column of Q^T), so the keys are the M dimension:
// each thread's P^T = exp2(scale s log2 e - lse log2 e) and dS^T land in the
// A-fragment layout of P^T dO and dS^T Q, whose B operands dO and Q are read
// by ldmatrix.trans. P and dS never leave registers. dQ mirrors it: S = Q K^T
// and dP = dO V^T, dS packed as the A operand of dS K with K by
// ldmatrix.trans. The scale multiplies the float32 scores (q is not rounded
// after scaling); lse is a natural log, so the exponent is scaled by log2(e)
// in float32; the mask applies only in tiles that cross the diagonal or an
// edge. Tiles arrive by TMA (one thread issues the box copies through a 4-D
// tensor map per tensor with the dense strides, rows past the sequence
// zero-filled, 128-byte swizzle so each 8-row ldmatrix phase hits 32 banks):
// dK/dV holds K and V and double-buffers Q and dO on two mbarriers, dQ holds
// Q and dO and double-buffers K and V, so tile j+1 is in flight under tile
// j's products, one __syncthreads a tile. dK/dV's lse and Delta are read per
// column (per query): each thread loads one of the next tile's 128 values
// under this tile's products and stages it in shared memory; dQ keeps its
// two rows' in registers. Where bf16 rounding happens: P is rounded to bf16
// in registers (as B3 rounds p for P V, and as the reference's bf16 autodiff
// multiplies p in v's type); dS = P (dP - Delta) is taken from that P in
// float32 and rounded to bf16; every product sums in float32, the dK and dV
// partials stay float32 to the reduce, dQ is rounded once at the end. So
// the kernel reads as the plain version with P and dS rounded to 7 mantissa
// bits: on the H100 at the training shape 3.2e-3 relative L2 to the float32
// plain version (dq, dk), 2.5e-3 (dv), and chip_smoke.py holds it to 8e-3
// with the control (3 bits) at 2.7e-2 to 3.8e-2. ptxas (chip_smoke.py's
// build phase prints it; CUDA 12.8): dK/dV 255 registers at D = 128 with
// 20 bytes of spill stores and loads (32 in its DIRECT instance; 68 / 88
// at D = 256), dQ 201 and none; D 16 / 32 / 64 / 80: dK/dV 103 / 148 / 205
// / 230 (DIRECT 3 to 5 more), dQ 82 / 109 / 165 / 169, none; (192, 128):
// the paired dK/dV 255 and the two-tile dQ 239, none. 97 KB of dynamic
// shared memory a block at
// D = 128 (six 16 KB tiles and the swizzle's alignment) and 1 KB static, so
// both kernels run two blocks an SM there. What holds it back:
// mma.sync on 16-row warp tiles (not wgmma's 64-row warpgroups), with every
// operand fragment from shared memory -- 0.56 ldmatrix.x4 a mma, so shared
// memory's bandwidth, not the tensor cores, is the first wall; the 7
// products; the float32 workspace's round trip (34 MB at the training
// shape).
//
// float32 (attention_bwd_dkdv_kernel, attention_bwd_dq_kernel): simple,
// right and deterministic, on the CUDA cores (true float32 FMAs, so it holds
// 1e-4 against the plain version), with the tiles in shared memory and each
// thread a 4 x 4 block of a 64 x 64 score tile, the float32 forward's (B3's
// flash_attention_kernel) layout; P and dS go through shared memory.
//
// Every launcher runs on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "mma_bf16.cuh"
#include "attention_mask.cuh"

namespace fb {
constexpr int THREADS = 256;
// A tile is 16 R rows of q, do, k or v and each thread holds an R x R block
// of a score tile: R = 4 (64-row tiles) up to D = 128; at D = 256 four
// 64-row float32 tiles would take 266 KB of shared memory, past the 227 KB a
// block may have, so there R = 2 (32-row tiles, 142 KB for dK / dV). D is
// q's head dim, never below v's, so (192, 128) takes 32-row tiles too.
template <int D> __host__ __device__ constexpr int rows() { return D > 128 ? 2 : 4; }
template <int D> __host__ __device__ constexpr int tile() { return 16 * rows<D>(); }
template <int D> __host__ __device__ constexpr int sld() { return tile<D>() + 4; }  // padded P / dS row
template <int D> __host__ __device__ constexpr int ld() { return D + 4; }  // padded q/k/v row
// the output column of a thread's j-th accumulator (B3's float32 layout)
template <int D> __device__ __forceinline__ int out_col(int tx, int j) {
    if constexpr (D % 64 == 0) return (j / 4) * 64 + 4 * tx + (j % 4);
    else return tx + 16 * j;
}
// dK/dV: K, Q tiles of D columns, V, dO tiles of DV, P and dS, lse and Delta
// of the query tile
template <int D, int DV> constexpr size_t dkdv_smem() {
    return sizeof(float) * (size_t)(2 * tile<D>() * (ld<D>() + ld<DV>())
                                    + 2 * tile<D>() * sld<D>() + 2 * tile<D>());
}
// dQ: Q, K tiles of D columns, dO, V tiles of DV, dS, lse and Delta of the
// query tile
template <int D, int DV> constexpr size_t dq_smem() {
    return sizeof(float) * (size_t)(2 * tile<D>() * (ld<D>() + ld<DV>())
                                    + tile<D>() * sld<D>() + 2 * tile<D>());
}
}  // namespace fb

__device__ __forceinline__ float bw_f(float x) { return x; }
__device__ __forceinline__ float bw_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T bw_from(float x);
template <> __device__ __forceinline__ float bw_from<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 bw_from<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// rows [r0, r0 + ROWS) of head h of a dense (B, S, heads, D) tensor into a
// ROWS x ld<D> float tile; rows past S are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int r0, int h, int S, int heads)
{
    constexpr int LD = fb::ld<D>();
    for (int i = threadIdx.x; i < ROWS * D; i += fb::THREADS) {
        const int r = i / D, c = i % D, s = r0 + r;
        dst[r * LD + c] = s < S ? bw_f(src[(((int64_t)b * S + s) * heads + h) * D + c]) : 0.f;
    }
}

// acc[i][j] += rows (ty + 16 i) of A . rows (tx + 16 j) of Bt over D: a tile
// x tile block of A Bt^T (16 R rows), each thread its R x R, the products in d
// order
template <int D, int R>
__device__ __forceinline__ void tile_dot(float (&acc)[R][R], const float* A,
                                         const float* Bt, int ty, int tx)
{
    constexpr int LD = fb::ld<D>();
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
        float4 a[R], bb[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
            a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + d]);
#pragma unroll
        for (int j = 0; j < R; ++j)
            bb[j] = *reinterpret_cast<const float4*>(&Bt[(tx + 16 * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) {
                float s = acc[i][j];
                s = fmaf(a[i].x, bb[j].x, s);
                s = fmaf(a[i].y, bb[j].y, s);
                s = fmaf(a[i].z, bb[j].z, s);
                s = fmaf(a[i].w, bb[j].w, s);
                acc[i][j] = s;
            }
    }
}

// acc[i][j] += sum over the tile's 16 R rows r, in order, of W[r][ty + 16 i]
// * X[r][out_col(tx, j)] (transposed: W is read down its columns) -- P^T dO,
// dS^T Q -- or, with W_ROWS, of W[ty + 16 i][r] * X[r][...] -- dS K; X has D
// columns, W is a 16 R x (16 R + 4) P / dS tile
template <int D, bool W_ROWS, int R>
__device__ __forceinline__ void tile_acc(float (&acc)[R][D / 16], const float* W,
                                         const float* X, int ty, int tx)
{
    constexpr int LD = fb::ld<D>();
    constexpr int NC = D / 16;
    constexpr int SLD = 16 * R + 4;
#pragma unroll 4
    for (int r = 0; r < 16 * R; ++r) {
        float w[R], x[NC];
#pragma unroll
        for (int i = 0; i < R; ++i)
            w[i] = W_ROWS ? W[(ty + 16 * i) * SLD + r] : W[r * SLD + ty + 16 * i];
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
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(w[i], x[j], acc[i][j]);
    }
}

// P and dS of one (query tile q0, key tile k0) pair, thread (ty, tx)'s R x R:
// s and dp hold q.k and dO.v; lse_s / dl_s the query tile's lse and Delta
template <int R>
__device__ __forceinline__ void p_and_ds(float (&s)[R][R], float (&dp)[R][R],
                                         const float* lse_s, const float* dl_s,
                                         int q0, int k0, int Sq, int Sk, int causal,
                                         int window, int prefix, int q_off, float scale, int ty, int tx)
{
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int kpos = k0 + tx + 16 * j;
            const bool ok = qpos < Sq && key_live(qpos, kpos, Sk, causal, window, prefix, q_off);
            const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
            s[i][j] = p;
            dp[i][j] = p * (dp[i][j] - dl_s[r]);
        }
    }
}

// Delta = rowsum(dO o O) per (batch, row, head): a warp a row, lanes over
// the D (v's head dim) columns of o and dO
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

template <typename T, int D, int DV>
__global__ void __launch_bounds__(fb::THREADS, 1)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk_ws, float* __restrict__ dv_ws,
                          int H, int Hkv, int Sq, int Sk, float scale, int causal,
                          int window, int prefix, int q_off)
{
    using namespace fb;
    constexpr int LD = ld<D>(), LDV = ld<DV>();
    constexpr int NC = D / 16, NCV = DV / 16;
    constexpr int R = rows<D>(), BQ = tile<D>(), BK = tile<D>(), SLD = sld<D>();
    extern __shared__ float smem[];
    float* Ks = smem;               // BK x LD
    float* Vs = Ks + BK * LD;       // BK x LDV
    float* Qs = Vs + BK * LDV;      // BQ x LD
    float* dOs = Qs + BQ * LD;      // BQ x LDV
    float* Ps = dOs + BQ * LDV;     // BQ x SLD, P[q][k]
    float* dSs = Ps + BQ * SLD;     // BQ x SLD, dS[q][k]
    float* lse_s = dSs + BQ * SLD;  // BQ
    float* dl_s = lse_s + BQ;       // BQ

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int k0 = kt * BK;
    // the query tiles that hold a live pair for these keys
    const QueryTiles qr = query_tiles(k0, min(k0 + BK, Sk) - 1, Sq, causal, window,
                                      prefix, BQ, q_off);

    load_rows<T, D, BK>(Ks, k, b, k0, hk, Sk, Hkv);
    load_rows<T, DV, BK>(Vs, v, b, k0, hk, Sk, Hkv);

    float dk[R][NC], dv[R][NCV];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < NC; ++j) dk[i][j] = 0.f;
#pragma unroll
        for (int j = 0; j < NCV; ++j) dv[i][j] = 0.f;
    }

    for (int qt = qr.lo; qt < qr.hi; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();  // the previous tile is done with Qs, dOs, Ps, dSs
        load_rows<T, D, BQ>(Qs, q, b, q0, h, Sq, H);
        load_rows<T, DV, BQ>(dOs, dout, b, q0, h, Sq, H);
        if (tid < BQ) {
            const bool in = q0 + tid < Sq;
            const int64_t at = ((int64_t)b * H + h) * Sq + q0 + tid;
            lse_s[tid] = in ? lse[at] : 0.f;
            dl_s[tid] = in ? delta[at] : 0.f;
        }
        __syncthreads();

        float s[R][R], dp[R][R];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
        tile_dot<D, R>(s, Qs, Ks, ty, tx);
        tile_dot<DV, R>(dp, dOs, Vs, ty, tx);
        p_and_ds<R>(s, dp, lse_s, dl_s, q0, k0, Sq, Sk, causal, window, prefix, q_off, scale,
                    ty, tx);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) {
                Ps[(ty + 16 * i) * SLD + tx + 16 * j] = s[i][j];
                dSs[(ty + 16 * i) * SLD + tx + 16 * j] = dp[i][j];
            }
        __syncthreads();

        // this thread's key rows ty + 16 i: dV += P^T dO, dK += dS^T Q
        tile_acc<DV, false, R>(dv, Ps, dOs, ty, tx);
        tile_acc<D, false, R>(dk, dSs, Qs, ty, tx);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int s_ = k0 + ty + 16 * i;
        if (s_ >= Sk) continue;
        const int64_t row = ((int64_t)b * Sk + s_) * H + h;
#pragma unroll
        for (int j = 0; j < NC; ++j) dk_ws[row * D + out_col<D>(tx, j)] = dk[i][j] * scale;
#pragma unroll
        for (int j = 0; j < NCV; ++j) dv_ws[row * DV + out_col<DV>(tx, j)] = dv[i][j];
    }
}

// dK / dV of KV head hk: its group's per-head partials summed in head order;
// a thread per (b, s, hk, d) for d below the wider of D (dK's columns) and DV
// (dV's)
template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_reduce_kernel(const float* __restrict__ dk_ws, const float* __restrict__ dv_ws,
                            T* __restrict__ dk, T* __restrict__ dv,
                            int64_t n, int H, int Hkv, int D, int DV)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;  // (b, s, hk, d)
    if (i >= n) return;
    const int G = H / Hkv;
    const int W = D > DV ? D : DV;
    const int d = (int)(i % W);
    const int64_t bsh = i / W;
    const int hk = (int)(bsh % Hkv);
    const int64_t bs = bsh / Hkv;
    const int64_t h0 = bs * H + (int64_t)hk * G;  // the group's first (b, s, h)
    if (d < D) {
        float sk = 0.f;
        for (int g = 0; g < G; ++g) sk += dk_ws[(h0 + g) * D + d];
        dk[bsh * D + d] = bw_from<T>(sk);
    }
    if (d < DV) {
        float sv = 0.f;
        for (int g = 0; g < G; ++g) sv += dv_ws[(h0 + g) * DV + d];
        dv[bsh * DV + d] = bw_from<T>(sv);
    }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(fb::THREADS, 1)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int H, int Hkv, int Sq, int Sk,
                        float scale, int causal, int window, int prefix, int q_off)
{
    using namespace fb;
    constexpr int LD = ld<D>(), LDV = ld<DV>();
    constexpr int NC = D / 16;
    constexpr int R = rows<D>(), BQ = tile<D>(), BK = tile<D>(), SLD = sld<D>();
    extern __shared__ float smem[];
    float* Qs = smem;               // BQ x LD
    float* dOs = Qs + BQ * LD;      // BQ x LDV
    float* Ks = dOs + BQ * LDV;     // BK x LD
    float* Vs = Ks + BK * LD;       // BK x LDV
    float* dSs = Vs + BK * LDV;     // BQ x SLD, dS[q][k]
    float* lse_s = dSs + BQ * SLD;
    float* dl_s = lse_s + BQ;

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int h = blockIdx.x, b = blockIdx.y;
    const int n_qt = (int)gridDim.z, qt = n_qt - 1 - (int)blockIdx.z;
    const int hk = h / (H / Hkv);
    const int q0 = qt * BQ;

    load_rows<T, D, BQ>(Qs, q, b, q0, h, Sq, H);
    load_rows<T, DV, BQ>(dOs, dout, b, q0, h, Sq, H);
    if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        const int64_t at = ((int64_t)b * H + h) * Sq + q0 + tid;
        lse_s[tid] = in ? lse[at] : 0.f;
        dl_s[tid] = in ? delta[at] : 0.f;
    }

    // the key tiles that hold a live pair for some row of this tile (B3's
    // walk); the others are never loaded
    const KeyTiles kts = key_tiles(q0, min(q0 + BQ, Sq) - 1, Sk, causal, window, prefix,
                                   BK, q_off);

    float acc[R][NC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

    for (int it = 0; it < kts.n; ++it) {
        const int k0 = key_tile(kts, it) * BK;
        __syncthreads();  // the previous tile is done with Ks, Vs, dSs
        load_rows<T, D, BK>(Ks, k, b, k0, hk, Sk, Hkv);
        load_rows<T, DV, BK>(Vs, v, b, k0, hk, Sk, Hkv);
        __syncthreads();

        float s[R][R], dp[R][R];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
        tile_dot<D, R>(s, Qs, Ks, ty, tx);
        tile_dot<DV, R>(dp, dOs, Vs, ty, tx);
        p_and_ds<R>(s, dp, lse_s, dl_s, q0, k0, Sq, Sk, causal, window, prefix, q_off, scale,
                    ty, tx);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) dSs[(ty + 16 * i) * SLD + tx + 16 * j] = dp[i][j];
        __syncthreads();

        // this thread's query rows ty + 16 i: dQ += dS K
        tile_acc<D, true, R>(acc, dSs, Ks, ty, tx);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int s_ = q0 + ty + 16 * i;
        if (s_ >= Sq) continue;
        T* row = dq + (((int64_t)b * Sq + s_) * H + h) * D;
#pragma unroll
        for (int j = 0; j < NC; ++j) row[out_col<D>(tx, j)] = bw_from<T>(acc[i][j] * scale);
    }
}

// ---- the bf16 route: FlashAttention-2's backward on the tensor cores -----
namespace fb2 {
constexpr int BQ = 64, BK = 64, WARPS = 4, THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == BK, "a tile is 64 rows of q, do, k or v");

// Output columns a block accumulates. dK/dV: every column of both while they
// are at most 256 together (D = DV <= 128). At D = 256 one 64-row tile's dK
// and dV accumulators alone would take 256 registers a thread (the 255 a
// thread may have; at D = 128 the kernel already runs at 255), so there the
// columns are split over two blocks, each recomputing the full-width S (over
// D) and dP (over DV) for its half of dK's columns and its half of dV's. At
// (192, 128) (160 floats) the paired kernel splits them over the two warps
// of a slab instead (pair_kernels). dQ: every column up to 192 (96 floats a
// thread at (192, 128)), two blocks of 128 at D 256.
template <int D, int DV> __host__ __device__ constexpr int kv_splits() {
    return D + DV > 256 ? 2 : 1;
}
template <int D, int DV> __host__ __device__ constexpr int dk_cols() { return D / kv_splits<D, DV>(); }
template <int D, int DV> __host__ __device__ constexpr int dv_cols() { return DV / kv_splits<D, DV>(); }
template <int D> __host__ __device__ constexpr int q_splits() { return D > 192 ? 2 : 1; }
template <int D> __host__ __device__ constexpr int dq_cols() { return D / q_splits<D>(); }

// A block holds a tile of D and one of DV columns (K and V; Q and dO) and two
// stages of the other two.
using namespace tile64;
template <int D, int DV> constexpr size_t smem_bytes() {
    // + 1024: the tiles' start is rounded up to the swizzle's alignment
    return 3 * ((size_t)tile_bytes<D>() + (size_t)tile_bytes<DV>()) + 1024;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p)
{
    return reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// the two bf16 of a packed register as floats, lo first
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// S = 16 x 64 (rows x cols) of A B^T over D for this warp: A's 16 rows from
// tile A at row a0, B's 64 rows from tile Bt, both by ldmatrix (a B row is a
// column of B^T); n8 tile j = B rows 8j..
template <int D>
__device__ __forceinline__ void tile_abt(float (&s)[BK / 8][4], const unsigned char* A,
                                         int a0, const unsigned char* Bt, int lane)
{
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t a[4];
        ldmatrix_x4(a, at(A, a0 + lane % 16, kd * 16 + (lane / 16) * 8));
#pragma unroll
        for (int j = 0; j < BK / 8; j += 2) {
            // matrices: rows 8j.. x d (lo, hi 8), rows 8j+8.. x d (lo, hi)
            uint32_t r[4];
            ldmatrix_x4(r, at(Bt, j * 8 + (lane / 16) * 8 + lane % 8,
                              kd * 16 + ((lane / 8) % 2) * 8));
            mma_bf16(s[j], a, r);
            mma_bf16(s[j + 1], a, r + 2);
        }
    }
}

// acc (16 x DO) += W X: W the 16 x 64 bf16 A fragments of the four k16
// steps, X's 64 rows (the k dimension) from tile X read transposed, its
// columns [c0, c0 + DO)
template <int DO>
__device__ __forceinline__ void tile_acc_wx(float (&acc)[DO / 8][4], const uint32_t (&w)[BK / 16][4],
                                            const unsigned char* X, int c0, int lane)
{
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int n = 0; n < DO / 8; n += 2) {
            // matrices: rows (lo, hi 8) x d 8n.., rows (lo, hi) x d 8n+8..
            uint32_t r[4];
            ldmatrix_x4_trans(r, at(X, kk * 16 + lane % 16, c0 + n * 8 + (lane / 16) * 8));
            mma_bf16(acc[n], w[kk], r);
            mma_bf16(acc[n + 1], w[kk], r + 2);
        }
}
// Multi-head latent attention's (192, 128) runs kernels of its own:
// attention_bwd_dkdv_pair_bf16_kernel (eight warps a key tile, two to each
// 16-key slab, each warp half of dK's and dV's columns: 96 + 64, 80 floats
// a thread) and attention_bwd_dq_pair_bf16_kernel (two query tiles a
// block, eight warps sharing each K / V tile), both in block_work's order.
// Every other pair keeps the four-warp kernels as they were, with their
// (head, batch, tile) grids -- one group, the same order -- and their
// code: a four-warp dQ kernel that took the two-tile code at one tile read
// slower at every other pair in a probe on the H100.
template <int D, int DV> __host__ __device__ constexpr bool pair_kernels() {
    return D == 192 && DV == 128;
}
constexpr int PAIR_THREADS = 2 * THREADS;
// P^T or dS^T of a tile pair: 64 keys x 64 queries of bf16, one box
constexpr int PT_BYTES = 64 * 128;
// dK/dV: the four-warp kernel's tiles, then P^T and dS^T; dQ: two tiles of
// Q and of dO and two stages of K and V
template <int D, int DV> constexpr size_t pair_dkdv_smem_bytes() {
    return smem_bytes<D, DV>() + 2 * PT_BYTES;
}
template <int D, int DV> constexpr size_t pair_dq_smem_bytes() {
    return smem_bytes<D, DV>() + (size_t)tile_bytes<D>() + (size_t)tile_bytes<DV>();
}

// S = 16 x 8 NJ (rows x cols) of A B^T over D for this warp: A's 16 rows from
// tile A at row a0, B's 8 NJ rows from tile Bt at row b0 (tile_abt's
// products over a part of B's rows). Every fragment comes from shared
// memory: the paired dK/dV kernel with K's (48 registers) or K's and V's
// (80) held in registers over its query tiles, beside its 80 accumulators,
// read slower in probes on the H100
template <int D, int NJ>
__device__ __forceinline__ void tile_abt_rows(float (&s)[NJ][4], const unsigned char* A,
                                              int a0, const unsigned char* Bt, int b0,
                                              int lane)
{
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t a[4];
        ldmatrix_x4(a, at(A, a0 + lane % 16, kd * 16 + (lane / 16) * 8));
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
            uint32_t r[4];
            ldmatrix_x4(r, at(Bt, b0 + j * 8 + (lane / 16) * 8 + lane % 8,
                              kd * 16 + ((lane / 8) % 2) * 8));
            mma_bf16(s[j], a, r);
            mma_bf16(s[j + 1], a, r + 2);
        }
    }
}

// one register of packed bf16 into a 64-column tile at (row, col), col even
__device__ __forceinline__ void st_b32(unsigned char* tile, int row, int col, uint32_t v)
{
    *reinterpret_cast<uint32_t*>(tile + sw128(row, col / 8) + (col % 8) * 2) = v;
}
}  // namespace fb2


// dK and dV of a group of one head, rounded to bf16 from a warp's float32
// accumulators: this thread's keys key0, key0 + 8 (rows of KV head hk),
// columns c0k + 8n + 2t, c0v + 8n + 2t; dK scaled as the workspace's
// partials are
template <int NOK, int NOV>
__device__ __forceinline__ void write_dkdv_bf16(__nv_bfloat16* dk, __nv_bfloat16* dv,
                                                const float (&ak)[NOK][4],
                                                const float (&av)[NOV][4], int b, int key0,
                                                int hk, int Sk, int Hkv, int D, int DV,
                                                int c0k, int c0v, int t, float scale)
{
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= Sk) continue;
        const int64_t row = ((int64_t)b * Sk + key) * Hkv + hk;
        __nv_bfloat16* krow = dk + row * D + c0k + 2 * t;
        __nv_bfloat16* vrow = dv + row * DV + c0v + 2 * t;
#pragma unroll
        for (int n = 0; n < NOK; ++n)
            *reinterpret_cast<__nv_bfloat162*>(krow + n * 8) =
                __floats2bfloat162_rn(ak[n][2 * r] * scale, ak[n][2 * r + 1] * scale);
#pragma unroll
        for (int n = 0; n < NOV; ++n)
            *reinterpret_cast<__nv_bfloat162*>(vrow + n * 8) =
                __floats2bfloat162_rn(av[n][2 * r], av[n][2 * r + 1]);
    }
}

// dK / dV per (key tile, query head, batch), bf16 on the tensor cores: each
// warp 16 keys; S^T = K Q^T and dP^T = V dO^T put the keys on the M
// dimension, so P^T and dS^T land in the A-fragment layout of P^T dO and
// dS^T Q and never leave registers. DIRECT (H == Hkv, a group of one head):
// dK and dV rounded to bf16 and written here, the one rounding the reduce
// would give the one partial; else the float32 partials to the workspaces
template <int D, int DV, bool DIRECT>
__global__ void __launch_bounds__(fb2::THREADS, 2)
attention_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dk_ws, float* __restrict__ dv_ws,
                               __nv_bfloat16* __restrict__ dk_out,
                               __nv_bfloat16* __restrict__ dv_out,
                               int H, int Hkv, int Sq, int Sk, float scale, int causal,
                               int window, int prefix, int q_off)
{
    using namespace fb2;
    constexpr int TB = tile_bytes<D>(), TBV = tile_bytes<DV>();
    constexpr int DOK = dk_cols<D, DV>(), DOV = dv_cols<D, DV>();
    constexpr int NSPLIT = kv_splits<D, DV>();
    static_assert(NSPLIT * DOK == D && NSPLIT * DOV == DV && DOK % 16 == 0
                  && DOV % 16 == 0, "the blocks of a head cover dK's and dV's columns");
    constexpr int NOK = DOK / 8, NOV = DOV / 8;  // n8 tiles of this block's dK, dV
    constexpr int NS = BQ / 8;   // n8 tiles of S^T: queries
    extern __shared__ __align__(16) unsigned char fb2_smem[];
    unsigned char* Ks = align1024(fb2_smem);
    unsigned char* Vs = Ks + TB;
    // stage s: the Q tile at s (TB + TBV), the dO tile next
    unsigned char* QD = Vs + TBV;
    __shared__ __align__(8) uint64_t full[2];
    // stage s: lse log2(e) of the tile's queries, then their Delta
    __shared__ float stat[2][2 * BQ];

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int h = (int)blockIdx.x / NSPLIT, b = blockIdx.y;
    // this block's output columns: dK's from c0k, dV's from c0v
    const int c0k = ((int)blockIdx.x % NSPLIT) * DOK, c0v = ((int)blockIdx.x % NSPLIT) * DOV;
    const int hk = h / (H / Hkv);
    const int k0 = (int)blockIdx.z * BK;
    // the query tiles that hold a live pair for these keys
    const QueryTiles qr = query_tiles(k0, min(k0 + BK, Sk) - 1, Sq, causal, window,
                                      prefix, BQ, q_off);
    const int qt0 = qr.lo;
    const int n_it = qr.hi - qr.lo;  // 0: no query sees these keys
    const int64_t srow = ((int64_t)b * H + h) * Sq;
    // thread tid's share of a query tile's row statistics
    auto row_stat = [&](int q0) {
        const int q = q0 + tid % BQ;
        if (q >= Sq) return 0.f;
        return tid < BQ ? lse[srow + q] * LOG2E : delta[srow + q];
    };

    if (tid == 0) {
        mbar_init(&full[0], 1);
        mbar_init(&full[1], 1);
        mbar_fence_init();
        if (n_it > 0) {
            mbar_expect_tx(&full[0], 2 * (TB + TBV));
            load_tile<D>(Ks, &tk, hk, k0, b, &full[0]);
            load_tile<DV>(Vs, &tv, hk, k0, b, &full[0]);
            load_tile<D>(QD, &tq, h, qt0 * BQ, b, &full[0]);
            load_tile<DV>(QD + TB, &tdo, h, qt0 * BQ, b, &full[0]);
        }
    }
    if (n_it > 0) stat[0][tid] = row_stat(qt0 * BQ);
    __syncthreads();  // the barriers are initialised before anyone waits

    // this thread's keys: rows g and g + 8 of the warp's 16
    const int key0 = k0 + warp * 16 + g;
    float dk[NOK][4], dv[NOV][4];
#pragma unroll
    for (int n = 0; n < NOK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NOV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;

    for (int it = 0; it < n_it; ++it) {
        const int st = it % 2, q0 = (qt0 + it) * BQ;
        const bool more = it + 1 < n_it;
        const float next = more ? row_stat(q0 + BQ) : 0.f;  // in flight under the products
        mbar_wait(&full[st], (it / 2) & 1);
        // tile it has landed, and every warp is done with tile it - 1,
        // whose stage the next load overwrites
        __syncthreads();
        if (tid == 0 && more) {
            unsigned char* nx = QD + (1 - st) * (TB + TBV);
            mbar_expect_tx(&full[1 - st], TB + TBV);
            load_tile<D>(nx, &tq, h, q0 + BQ, b, &full[1 - st]);
            load_tile<DV>(nx + TB, &tdo, h, q0 + BQ, b, &full[1 - st]);
        }
        const unsigned char* Qt = QD + st * (TB + TBV);
        const unsigned char* dOt = Qt + TB;
        const float* ls = stat[st];
        const float* dl = stat[st] + BQ;

        // P^T = exp(scale K Q^T - lse), rounded to bf16 in registers: the A
        // fragments of the k16 steps over queries (query n8 tile j is step
        // j / 2, its low or high 8 columns). The scale multiplies the float32
        // scores; the mask applies only where a tile crosses the diagonal or
        // an edge
        uint32_t pf[BQ / 16][4];
        {
            float s[NS][4];
            tile_abt<D>(s, Ks, warp * 16, Qt, lane);
            const bool masked = !tile_all_live(q0, k0, BQ, BK, Sq, Sk, causal, window, q_off);
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float p[2];
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const int col = j * 8 + 2 * t + c, qpos = q0 + col, kpos = key0 + 8 * r;
                        p[c] = exp2f(fmaf(s[j][2 * r + c] * scale, LOG2E, -ls[col]));
                        if (masked && (qpos >= Sq
                                       || !key_live(qpos, kpos, Sk, causal, window, prefix, q_off)))
                            p[c] = 0.f;
                    }
                    pf[j / 2][(j % 2) * 2 + r] = pack_bf16x2(p[0], p[1]);
                }
        }
        // dV += P^T dO
        tile_acc_wx<DOV>(dv, pf, dOt, c0v, lane);

        // dS^T = P^T o (dP^T - Delta), dP^T = V dO^T, rounded to bf16
        uint32_t df[BQ / 16][4];
        {
            float dp[NS][4];
            tile_abt<DV>(dp, Vs, warp * 16, dOt, lane);
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const uint32_t p = pf[j / 2][(j % 2) * 2 + r];
                    const int col = j * 8 + 2 * t;
                    df[j / 2][(j % 2) * 2 + r] = pack_bf16x2(
                        bf_lo(p) * (dp[j][2 * r] - dl[col]),
                        bf_hi(p) * (dp[j][2 * r + 1] - dl[col + 1]));
                }
        }
        // dK += dS^T Q (scaled once, at the end)
        tile_acc_wx<DOK>(dk, df, Qt, c0k, lane);

        // the next tile's statistics: that stage was last read in tile it - 1
        if (more) stat[1 - st][tid] = next;
    }

    if constexpr (DIRECT) {
        write_dkdv_bf16<NOK, NOV>(dk_out, dv_out, dk, dv, b, key0, hk, Sk, Hkv, D, DV,
                                  c0k, c0v, t, scale);
        return;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= Sk) continue;
        const int64_t row = ((int64_t)b * Sk + key) * H + h;
        float* krow = dk_ws + row * D + c0k + 2 * t;
        float* vrow = dv_ws + row * DV + c0v + 2 * t;
#pragma unroll
        for (int n = 0; n < NOK; ++n)
            *reinterpret_cast<float2*>(krow + n * 8) =
                make_float2(dk[n][2 * r] * scale, dk[n][2 * r + 1] * scale);
#pragma unroll
        for (int n = 0; n < NOV; ++n)
            *reinterpret_cast<float2*>(vrow + n * 8) =
                make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
}


// dK / dV at (192, 128) per (key tile, query head, batch): eight warps, two
// to each 16-key slab. Warp `half` of a slab computes S^T and dP^T over its
// half of the tile's 64 queries (32 columns), rounds P^T and dS^T to bf16 as
// the four-warp kernel does and puts them in shared memory; after a barrier
// of the two, each accumulates half of dK's and dV's columns (96 + 64, 80
// floats a thread) from the slab's whole P^T and dS^T. So S and dP are
// computed once for all 320 output columns, where the four-warp kernel's two
// column blocks computed them twice, and K, V, Q and dO are loaded once.
// Every output element sums the same products in the same order (query
// tiles in order, k16 steps in order) as the four-warp kernel's split.
template <int D, int DV>
__global__ void __launch_bounds__(fb2::PAIR_THREADS, 1)
attention_bwd_dkdv_pair_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const __grid_constant__ CUtensorMap tdo,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    float* __restrict__ dk_ws, float* __restrict__ dv_ws,
                                    __nv_bfloat16* __restrict__ dk_out,
                                    __nv_bfloat16* __restrict__ dv_out,
                                    int B, int H, int Hkv, int Sq, int Sk, float scale,
                                    int causal, int window, int prefix, int q_off,
                                    int group)
{
    using namespace fb2;
    constexpr int TB = tile_bytes<D>(), TBV = tile_bytes<DV>();
    constexpr int DOK = D / 2, DOV = DV / 2;
    static_assert(DOK % 16 == 0 && DOV % 16 == 0, "a warp's columns are whole k16 pairs");
    constexpr int NOK = DOK / 8, NOV = DOV / 8;  // n8 tiles of this warp's dK, dV
    constexpr int NH = BQ / 16;  // n8 tiles of a warp's 32 queries
    extern __shared__ __align__(16) unsigned char fb2_smem[];
    unsigned char* Ks = align1024(fb2_smem);
    unsigned char* Vs = Ks + TB;
    // stage s: the Q tile at s (TB + TBV), the dO tile next
    unsigned char* QD = Vs + TBV;
    unsigned char* PT = QD + 2 * (TB + TBV);  // P^T: keys x queries
    unsigned char* DT = PT + PT_BYTES;        // dS^T
    __shared__ __align__(8) uint64_t full[2];
    // stage s: lse log2(e) of the tile's queries, then their Delta
    __shared__ float stat[2][2 * BQ];

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int slab = warp % WARPS, half = warp / WARPS;
    const BlockWork bw = block_work((int)blockIdx.x, (Sk + BK - 1) / BK, H, B, group);
    const int h = bw.pair, b = bw.b;
    const int hk = h / (H / Hkv);
    const int k0 = bw.rank * BK;
    const QueryTiles qr = query_tiles(k0, min(k0 + BK, Sk) - 1, Sq, causal, window,
                                      prefix, BQ, q_off);
    const int qt0 = qr.lo;
    const int n_it = qr.hi - qr.lo;
    const int64_t srow = ((int64_t)b * H + h) * Sq;
    const bool stats = tid < 2 * BQ;  // the threads that stage the row statistics
    auto row_stat = [&](int q0) {
        const int q = q0 + tid % BQ;
        if (!stats || q >= Sq) return 0.f;
        return tid < BQ ? lse[srow + q] * LOG2E : delta[srow + q];
    };

    if (tid == 0) {
        mbar_init(&full[0], 1);
        mbar_init(&full[1], 1);
        mbar_fence_init();
        if (n_it > 0) {
            mbar_expect_tx(&full[0], 2 * (TB + TBV));
            load_tile<D>(Ks, &tk, hk, k0, b, &full[0]);
            load_tile<DV>(Vs, &tv, hk, k0, b, &full[0]);
            load_tile<D>(QD, &tq, h, qt0 * BQ, b, &full[0]);
            load_tile<DV>(QD + TB, &tdo, h, qt0 * BQ, b, &full[0]);
        }
    }
    if (n_it > 0 && stats) stat[0][tid] = row_stat(qt0 * BQ);
    __syncthreads();

    const int srow0 = slab * 16;             // the slab's rows of the key tile
    const int key0 = k0 + srow0 + g;         // this thread's keys: key0, key0 + 8
    const int qc0 = half * (BQ / 2);         // this warp's queries of a tile
    float dk[NOK][4], dv[NOV][4];
#pragma unroll
    for (int n = 0; n < NOK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NOV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;

    for (int it = 0; it < n_it; ++it) {
        const int st = it % 2, q0 = (qt0 + it) * BQ;
        const bool more = it + 1 < n_it;
        const float next = more ? row_stat(q0 + BQ) : 0.f;
        mbar_wait(&full[st], (it / 2) & 1);
        // tile it has landed; every warp is done with tile it - 1's stage
        // and with its P^T and dS^T
        __syncthreads();
        if (tid == 0 && more) {
            unsigned char* nx = QD + (1 - st) * (TB + TBV);
            mbar_expect_tx(&full[1 - st], TB + TBV);
            load_tile<D>(nx, &tq, h, q0 + BQ, b, &full[1 - st]);
            load_tile<DV>(nx + TB, &tdo, h, q0 + BQ, b, &full[1 - st]);
        }
        const unsigned char* Qt = QD + st * (TB + TBV);
        const unsigned char* dOt = Qt + TB;
        const float* ls = stat[st];
        const float* dl = stat[st] + BQ;

        // P^T over this warp's queries, as the four-warp kernel computes it
        uint32_t pf[NH / 2][4];
        {
            float s[NH][4];
            tile_abt_rows<D, NH>(s, Ks, srow0, Qt, qc0, lane);
            const bool masked = !tile_all_live(q0, k0, BQ, BK, Sq, Sk, causal, window, q_off);
#pragma unroll
            for (int j = 0; j < NH; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float p[2];
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const int col = qc0 + j * 8 + 2 * t + c, qpos = q0 + col;
                        const int kpos = key0 + 8 * r;
                        p[c] = exp2f(fmaf(s[j][2 * r + c] * scale, LOG2E, -ls[col]));
                        if (masked && (qpos >= Sq
                                       || !key_live(qpos, kpos, Sk, causal, window, prefix, q_off)))
                            p[c] = 0.f;
                    }
                    pf[j / 2][(j % 2) * 2 + r] = pack_bf16x2(p[0], p[1]);
                    st_b32(PT, srow0 + g + 8 * r, qc0 + j * 8 + 2 * t,
                           pf[j / 2][(j % 2) * 2 + r]);
                }
        }
        // dS^T = P^T o (dP^T - Delta), dP^T = V dO^T over the same queries
        {
            float dp[NH][4];
            tile_abt_rows<DV, NH>(dp, Vs, srow0, dOt, qc0, lane);
#pragma unroll
            for (int j = 0; j < NH; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const uint32_t p = pf[j / 2][(j % 2) * 2 + r];
                    const int col = qc0 + j * 8 + 2 * t;
                    st_b32(DT, srow0 + g + 8 * r, col, pack_bf16x2(
                        bf_lo(p) * (dp[j][2 * r] - dl[col]),
                        bf_hi(p) * (dp[j][2 * r + 1] - dl[col + 1])));
                }
        }
        named_sync(1 + slab, 64);  // the slab's P^T and dS^T are whole

        // dV += P^T dO and dK += dS^T Q over the tile's 64 queries, this
        // warp's half of the columns
        uint32_t w[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
            ldmatrix_x4(w[kk], at(PT, srow0 + lane % 16, kk * 16 + (lane / 16) * 8));
        tile_acc_wx<DOV>(dv, w, dOt, half * DOV, lane);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
            ldmatrix_x4(w[kk], at(DT, srow0 + lane % 16, kk * 16 + (lane / 16) * 8));
        tile_acc_wx<DOK>(dk, w, Qt, half * DOK, lane);

        if (more && stats) stat[1 - st][tid] = next;
    }

    if (H == Hkv) {
        write_dkdv_bf16<NOK, NOV>(dk_out, dv_out, dk, dv, b, key0, hk, Sk, Hkv, D, DV,
                                  half * DOK, half * DOV, t, scale);
        return;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= Sk) continue;
        const int64_t row = ((int64_t)b * Sk + key) * H + h;
        float* krow = dk_ws + row * D + half * DOK + 2 * t;
        float* vrow = dv_ws + row * DV + half * DOV + 2 * t;
#pragma unroll
        for (int n = 0; n < NOK; ++n)
            *reinterpret_cast<float2*>(krow + n * 8) =
                make_float2(dk[n][2 * r] * scale, dk[n][2 * r + 1] * scale);
#pragma unroll
        for (int n = 0; n < NOV; ++n)
            *reinterpret_cast<float2*>(vrow + n * 8) =
                make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
}

// dQ per (query tile, head, batch), bf16 on the tensor cores: each warp 16
// queries; S = Q K^T and dP = dO V^T recomputed per key tile, dS packed to
// bf16 as the A fragments of dS K, dQ in registers over the key tiles in order
template <int D, int DV>
__global__ void __launch_bounds__(fb2::THREADS, 2)
attention_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq,
                             int H, int Hkv, int Sq, int Sk, float scale, int causal,
                             int window, int prefix, int q_off)
{
    using namespace fb2;
    constexpr int TB = tile_bytes<D>(), TBV = tile_bytes<DV>();
    constexpr int DO = dq_cols<D>(), NSPLIT = q_splits<D>();
    static_assert(NSPLIT * DO == D && DO % 16 == 0, "the blocks of a head cover dQ's columns");
    constexpr int NO = DO / 8;   // n8 tiles of this block's dQ columns
    constexpr int NS = BK / 8;   // n8 tiles of S: keys
    extern __shared__ __align__(16) unsigned char fb2_smem[];
    unsigned char* Qs = align1024(fb2_smem);
    unsigned char* dOs = Qs + TB;
    // stage s: the K tile at s (TB + TBV), the V tile next
    unsigned char* KV = dOs + TBV;
    __shared__ __align__(8) uint64_t full[2];

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    const int h = (int)blockIdx.x / NSPLIT, b = blockIdx.y;
    const int c0 = ((int)blockIdx.x % NSPLIT) * DO;  // this block's output columns
    const int n_qt = (int)gridDim.z, qt = n_qt - 1 - (int)blockIdx.z;
    const int hk = h / (H / Hkv);
    const int q0 = qt * BQ;

    // the key tiles that hold a live pair for some row of this tile (B3's
    // walk); the others are never loaded
    const KeyTiles kts = key_tiles(q0, min(q0 + BQ, Sq) - 1, Sk, causal, window, prefix,
                                   BK, q_off);
    const int n_tiles = kts.n;
    if (threadIdx.x == 0) {
        mbar_init(&full[0], 1);
        mbar_init(&full[1], 1);
        mbar_fence_init();
        mbar_expect_tx(&full[0], 2 * (TB + TBV));
        load_tile<D>(Qs, &tq, h, q0, b, &full[0]);
        load_tile<DV>(dOs, &tdo, h, q0, b, &full[0]);
        load_tile<D>(KV, &tk, hk, key_tile(kts, 0) * BK, b, &full[0]);
        load_tile<DV>(KV + TB, &tv, hk, key_tile(kts, 0) * BK, b, &full[0]);
    }
    // this thread's rows g and g + 8 of the warp's 16: lse log2(e), Delta
    const int row0 = q0 + warp * 16 + g;
    float ls[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        const int64_t at_ = ((int64_t)b * H + h) * Sq + qpos;
        ls[r] = qpos < Sq ? lse[at_] * LOG2E : 0.f;
        dl[r] = qpos < Sq ? delta[at_] : 0.f;
    }
    __syncthreads();  // the barriers are initialised before anyone waits

    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = key_tile(kts, kt) * BK;
        mbar_wait(&full[kt % 2], (kt / 2) & 1);
        // tile kt has landed, and every warp is done with tile kt - 1,
        // whose stage the next load overwrites
        __syncthreads();
        if (threadIdx.x == 0 && kt + 1 < n_tiles) {
            unsigned char* nx = KV + ((kt + 1) % 2) * (TB + TBV);
            uint64_t* bar = &full[(kt + 1) % 2];
            const int k1 = key_tile(kts, kt + 1) * BK;
            mbar_expect_tx(bar, TB + TBV);
            load_tile<D>(nx, &tk, hk, k1, b, bar);
            load_tile<DV>(nx + TB, &tv, hk, k1, b, bar);
        }
        const unsigned char* Kt = KV + (kt % 2) * (TB + TBV);
        const unsigned char* Vt = Kt + TB;

        // P = exp(scale Q K^T - lse), rounded to bf16 as in the dK/dV kernel
        uint32_t pf[BK / 16][4];
        {
            float s[NS][4];
            tile_abt<D>(s, Qs, warp * 16, Kt, lane);
            const bool masked = !tile_all_live(q0, k0, BQ, BK, Sq, Sk, causal, window, q_off);
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float p[2];
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const int kpos = k0 + j * 8 + 2 * t + c, qpos = row0 + 8 * r;
                        p[c] = exp2f(fmaf(s[j][2 * r + c] * scale, LOG2E, -ls[r]));
                        if (masked && (qpos >= Sq
                                       || !key_live(qpos, kpos, Sk, causal, window, prefix, q_off)))
                            p[c] = 0.f;
                    }
                    pf[j / 2][(j % 2) * 2 + r] = pack_bf16x2(p[0], p[1]);
                }
        }
        // dS = P o (dP - Delta), dP = dO V^T, rounded to bf16: the A
        // fragments of dS K over the keys
        uint32_t df[BK / 16][4];
        {
            float dp[NS][4];
            tile_abt<DV>(dp, dOs, warp * 16, Vt, lane);
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const uint32_t p = pf[j / 2][(j % 2) * 2 + r];
                    df[j / 2][(j % 2) * 2 + r] = pack_bf16x2(
                        bf_lo(p) * (dp[j][2 * r] - dl[r]),
                        bf_hi(p) * (dp[j][2 * r + 1] - dl[r]));
                }
        }
        // dQ += dS K: K's rows are the k dimension, read transposed
        tile_acc_wx<DO>(acc, df, Kt, c0, lane);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        if (qpos >= Sq) continue;
        __nv_bfloat16* orow = dq + (((int64_t)b * Sq + qpos) * H + h) * D + c0 + 2 * t;
#pragma unroll
        for (int n = 0; n < NO; ++n)
            *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
                __floats2bfloat162_rn(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
}


// dQ at (192, 128) per (two query tiles of 64 rows, head, batch): eight
// warps, four to each tile, sharing every K / V tile the block loads (half
// the K / V traffic a query row of the four-warp kernel's, and eight warps
// an SM where its 121 KB left one block of four). The block walks the union
// of its two tiles' key tiles (key_tiles over all 128 rows, in order), and
// a tile's warps skip a key tile its own walk leaves out, so every row sums
// the same key tiles in the same order as in the four-warp kernel: the same
// bits.
template <int D, int DV>
__global__ void __launch_bounds__(fb2::PAIR_THREADS, 1)
attention_bwd_dq_pair_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  __nv_bfloat16* __restrict__ dq,
                                  int B, int H, int Hkv, int Sq, int Sk, float scale,
                                  int causal, int window, int prefix, int q_off, int group)
{
    using namespace fb2;
    constexpr int TB = tile_bytes<D>(), TBV = tile_bytes<DV>();
    static_assert(q_splits<D>() == 1, "one block covers dQ's columns");
    constexpr int NO = D / 8;    // n8 tiles of dQ's columns
    constexpr int NS = BK / 8;   // n8 tiles of S: keys
    extern __shared__ __align__(16) unsigned char fb2_smem[];
    unsigned char* Qs = align1024(fb2_smem);  // the two Q tiles
    unsigned char* dOs = Qs + 2 * TB;         // the two dO tiles
    // stage s: the K tile at s (TB + TBV), the V tile next
    unsigned char* KV = dOs + 2 * TBV;
    __shared__ __align__(8) uint64_t full[2];

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    const int half = warp / WARPS, wrow = (warp % WARPS) * 16;
    // the longest walk (the last query tiles) of a (batch, head) first
    const int n_qt = (Sq + 2 * BQ - 1) / (2 * BQ);
    const BlockWork bw = block_work((int)blockIdx.x, n_qt, H, B, group);
    const int h = bw.pair, b = bw.b;
    const int hk = h / (H / Hkv);
    const int q0 = (n_qt - 1 - bw.rank) * 2 * BQ;
    const int hq0 = q0 + half * BQ;  // this warp's tile: none past Sq
    const bool rows = hq0 < Sq;

    const KeyTiles kts = key_tiles(q0, min(q0 + 2 * BQ, Sq) - 1, Sk, causal, window,
                                   prefix, BK, q_off);
    const KeyTiles own = key_tiles(hq0, min(hq0 + BQ, Sq) - 1, Sk, causal, window,
                                   prefix, BK, q_off);
    const int n_tiles = kts.n;
    if (threadIdx.x == 0) {
        const int nq = q0 + BQ < Sq ? 2 : 1;
        mbar_init(&full[0], 1);
        mbar_init(&full[1], 1);
        mbar_fence_init();
        mbar_expect_tx(&full[0], (nq + 1) * (TB + TBV));
        for (int i = 0; i < nq; ++i) {
            load_tile<D>(Qs + i * TB, &tq, h, q0 + i * BQ, b, &full[0]);
            load_tile<DV>(dOs + i * TBV, &tdo, h, q0 + i * BQ, b, &full[0]);
        }
        load_tile<D>(KV, &tk, hk, key_tile(kts, 0) * BK, b, &full[0]);
        load_tile<DV>(KV + TB, &tv, hk, key_tile(kts, 0) * BK, b, &full[0]);
    }
    const unsigned char* Qt = Qs + half * TB;
    const unsigned char* dOt = dOs + half * TBV;
    // this thread's rows g and g + 8 of the warp's 16: lse log2(e), Delta
    const int row0 = hq0 + wrow + g;
    float ls[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        const int64_t at_ = ((int64_t)b * H + h) * Sq + qpos;
        ls[r] = qpos < Sq ? lse[at_] * LOG2E : 0.f;
        dl[r] = qpos < Sq ? delta[at_] : 0.f;
    }
    __syncthreads();  // the barriers are initialised before anyone waits

    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = key_tile(kts, kt) * BK;
        mbar_wait(&full[kt % 2], (kt / 2) & 1);
        // tile kt has landed, and every warp is done with tile kt - 1,
        // whose stage the next load overwrites
        __syncthreads();
        if (threadIdx.x == 0 && kt + 1 < n_tiles) {
            unsigned char* nx = KV + ((kt + 1) % 2) * (TB + TBV);
            uint64_t* bar = &full[(kt + 1) % 2];
            const int k1 = key_tile(kts, kt + 1) * BK;
            mbar_expect_tx(bar, TB + TBV);
            load_tile<D>(nx, &tk, hk, k1, b, bar);
            load_tile<DV>(nx + TB, &tv, hk, k1, b, bar);
        }
        if (!rows || !walks(own, k0 / BK)) continue;
        const unsigned char* Kt = KV + (kt % 2) * (TB + TBV);
        const unsigned char* Vt = Kt + TB;

        // P = exp(scale Q K^T - lse), rounded to bf16 as in the dK/dV kernel
        uint32_t pf[BK / 16][4];
        {
            float s[NS][4];
            tile_abt<D>(s, Qt, wrow, Kt, lane);
            const bool masked = !tile_all_live(hq0, k0, BQ, BK, Sq, Sk, causal, window, q_off);
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float p[2];
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const int kpos = k0 + j * 8 + 2 * t + c, qpos = row0 + 8 * r;
                        p[c] = exp2f(fmaf(s[j][2 * r + c] * scale, LOG2E, -ls[r]));
                        if (masked && (qpos >= Sq
                                       || !key_live(qpos, kpos, Sk, causal, window, prefix, q_off)))
                            p[c] = 0.f;
                    }
                    pf[j / 2][(j % 2) * 2 + r] = pack_bf16x2(p[0], p[1]);
                }
        }
        // dS = P o (dP - Delta), dP = dO V^T, rounded to bf16: the A
        // fragments of dS K over the keys
        uint32_t df[BK / 16][4];
        {
            float dp[NS][4];
            tile_abt<DV>(dp, dOt, wrow, Vt, lane);
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const uint32_t p = pf[j / 2][(j % 2) * 2 + r];
                    df[j / 2][(j % 2) * 2 + r] = pack_bf16x2(
                        bf_lo(p) * (dp[j][2 * r] - dl[r]),
                        bf_hi(p) * (dp[j][2 * r + 1] - dl[r]));
                }
        }
        // dQ += dS K: K's rows are the k dimension, read transposed
        tile_acc_wx<D>(acc, df, Kt, 0, lane);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        if (qpos >= Sq) continue;
        __nv_bfloat16* orow = dq + (((int64_t)b * Sq + qpos) * H + h) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < NO; ++n)
            *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
                __floats2bfloat162_rn(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
}

// q, k, v or do, dense (B, S, heads, D), as a 4-D tensor map (D, heads, S,
// B) read in boxes of 64 rows of one head; the strides are the dense ones
// whatever the length of a dim
template <int D>
static bool bwd_map(CUtensorMap* map, const void* base, int B, int S, int heads)
{
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                                (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                   (cuuint64_t)S * heads * D * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)fb2::BQ, 1};
    return bf16_box_map(map, base, 4, dims, strides, box);
}

template <int D, int DV>
static int attention_bwd_bf16_run(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  float* dk_ws, float* dv_ws, void* dq, void* dk, void* dv,
                                  int B, int H, int Hkv, int Sq, int Sk, float scale,
                                  int causal, int window, int prefix, int q_off, cudaStream_t stream)
{
    using namespace fb2;
    // q and k of D columns, v and do of DV
    CUtensorMap tq, tk, tv, tdo;
    if (!bwd_map<D>(&tq, q, B, Sq, H) || !bwd_map<D>(&tk, k, B, Sk, Hkv)
        || !bwd_map<DV>(&tv, v, B, Sk, Hkv) || !bwd_map<DV>(&tdo, dout, B, Sq, H))
        return (int)cudaErrorInvalidValue;
    __nv_bfloat16 *dkb = (__nv_bfloat16*)dk, *dvb = (__nv_bfloat16*)dv;
    const unsigned n_kt = (unsigned)((Sk + BK - 1) / BK);
    cudaError_t err;
    if constexpr (pair_kernels<D, DV>()) {
        // a head's Q / dO tiles, walked by the dK/dV blocks of its key tiles
        const size_t smem = pair_dkdv_smem_bytes<D, DV>();
        err = cudaFuncSetAttribute(attention_bwd_dkdv_pair_bf16_kernel<D, DV>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        attention_bwd_dkdv_pair_bf16_kernel<D, DV>
            <<<(unsigned)(B * H) * n_kt, PAIR_THREADS, smem, stream>>>(
                tq, tk, tv, tdo, lse, delta, dk_ws, dv_ws, dkb, dvb, B, H, Hkv, Sq, Sk,
                scale, causal, window, prefix, q_off,
                order_group(B * H, 1, 2.0 * Sq * (D + DV)));
    } else {
        const size_t smem = smem_bytes<D, DV>();
        auto kernel = H == Hkv ? attention_bwd_dkdv_bf16_kernel<D, DV, true>
                               : attention_bwd_dkdv_bf16_kernel<D, DV, false>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        dim3 g1((unsigned)(H * kv_splits<D, DV>()), (unsigned)B, n_kt);
        kernel<<<g1, THREADS, smem, stream>>>(
            tq, tk, tv, tdo, lse, delta, dk_ws, dv_ws, dkb, dvb, H, Hkv, Sq, Sk, scale,
            causal, window, prefix, q_off);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    if (H != Hkv) {  // the group's partials, summed in head order
        const int64_t n = (int64_t)B * Sk * Hkv * (D > DV ? D : DV);
        attention_bwd_reduce_kernel<__nv_bfloat16><<<(unsigned)((n + 255) / 256), 256, 0,
                                                     stream>>>(
            dk_ws, dv_ws, dkb, dvb, n, H, Hkv, D, DV);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }

    if constexpr (pair_kernels<D, DV>()) {
        // a KV head's K / V tiles, walked by the dQ blocks of its query heads
        const size_t smem = pair_dq_smem_bytes<D, DV>();
        err = cudaFuncSetAttribute(attention_bwd_dq_pair_bf16_kernel<D, DV>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        const unsigned n_qt2 = (unsigned)((Sq + 2 * BQ - 1) / (2 * BQ));
        attention_bwd_dq_pair_bf16_kernel<D, DV>
            <<<(unsigned)(B * H) * n_qt2, PAIR_THREADS, smem, stream>>>(
                tq, tk, tv, tdo, lse, delta, (__nv_bfloat16*)dq, B, H, Hkv, Sq, Sk, scale,
                causal, window, prefix, q_off,
                order_group(B * H, H / Hkv, 2.0 * Sk * (D + DV)));
    } else {
        const size_t smem = smem_bytes<D, DV>();
        err = cudaFuncSetAttribute(attention_bwd_dq_bf16_kernel<D, DV>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        dim3 g2((unsigned)(H * q_splits<D>()), (unsigned)B,
                (unsigned)((Sq + BQ - 1) / BQ));
        attention_bwd_dq_bf16_kernel<D, DV><<<g2, THREADS, smem, stream>>>(
            tq, tk, tv, tdo, lse, delta, (__nv_bfloat16*)dq, H, Hkv, Sq, Sk, scale, causal,
            window, prefix, q_off);
    }
    return (int)cudaGetLastError();
}

template <typename T, int D, int DV>
static int attention_bwd_run(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta,
                             float* dk_ws, float* dv_ws, void* dq, void* dk, void* dv,
                             int B, int H, int Hkv, int Sq, int Sk, float scale,
                             int causal, int window, int prefix, int q_off, cudaStream_t stream)
{
    const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v,
            *to = (const T*)o, *tdo = (const T*)dout;
    const int64_t rows = (int64_t)B * Sq * H;
    attention_bwd_delta_kernel<T, DV><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
        to, tdo, delta, B, H, Sq);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        return attention_bwd_bf16_run<D, DV>(q, k, v, dout, lse, delta, dk_ws, dv_ws, dq,
                                             dk, dv, B, H, Hkv, Sq, Sk, scale, causal,
                                             window, prefix, q_off, stream);
    } else {
        constexpr int TILE = fb::tile<D>();
        const size_t s1 = fb::dkdv_smem<D, DV>();
        err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<T, D, DV>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
        if (err != cudaSuccess) return (int)err;
        dim3 g1((unsigned)H, (unsigned)B, (unsigned)((Sk + TILE - 1) / TILE));
        attention_bwd_dkdv_kernel<T, D, DV><<<g1, fb::THREADS, s1, stream>>>(
            tq, tk, tv, tdo, lse, delta, dk_ws, dv_ws, H, Hkv, Sq, Sk, scale, causal,
            window, prefix, q_off);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;

        const int64_t n = (int64_t)B * Sk * Hkv * (D > DV ? D : DV);
        attention_bwd_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
            dk_ws, dv_ws, (T*)dk, (T*)dv, n, H, Hkv, D, DV);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;

        const size_t s2 = fb::dq_smem<D, DV>();
        err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, D, DV>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
        if (err != cudaSuccess) return (int)err;
        dim3 g2((unsigned)H, (unsigned)B, (unsigned)((Sq + TILE - 1) / TILE));
        attention_bwd_dq_kernel<T, D, DV><<<g2, fb::THREADS, s2, stream>>>(
            tq, tk, tv, tdo, lse, delta, (T*)dq, H, Hkv, Sq, Sk, scale, causal, window,
            prefix, q_off);
        return (int)cudaGetLastError();
    }
}

template <typename T>
static int attention_bwd_dispatch(int D, int DV, const void* q, const void* k,
                                  const void* v, const void* o, const void* dout,
                                  const float* lse, float* delta, float* dk_ws,
                                  float* dv_ws, void* dq, void* dk, void* dv, int B, int H,
                                  int Hkv, int Sq, int Sk, float scale, int causal,
                                  int window, int prefix, int q_off, cudaStream_t s)
{
#define BW_RUN(DD, DDV) attention_bwd_run<T, DD, DDV>(q, k, v, o, dout, lse, delta, dk_ws,    \
                                                      dv_ws, dq, dk, dv, B, H, Hkv, Sq, Sk, \
                                                      scale, causal, window, prefix, q_off, s)
    if (D == 192 && DV == 128) return BW_RUN(192, 128);  // multi-head latent attention
    if (D == 32 && DV == 16) return BW_RUN(32, 16);  // the reduced MLA's (24, 16), padded
    if (DV != D) return (int)cudaErrorInvalidValue;
    switch (D) {
    case 16:  return BW_RUN(16, 16);
    case 32:  return BW_RUN(32, 32);
    case 64:  return BW_RUN(64, 64);
    case 80:  return BW_RUN(80, 80);
    case 128: return BW_RUN(128, 128);
    case 256: return BW_RUN(256, 256);
    default:  return (int)cudaErrorInvalidValue;
    }
#undef BW_RUN
}

// is_bf16: 1 for bf16 tensors, 0 for float32. Every tensor dense: q, dq (B,
// Sq, H, D); o, dout (B, Sq, H, DV); k, dk (B, Sk, Hkv, D); v, dv (B, Sk,
// Hkv, DV); lse and delta (B, H, Sq) float32 (delta is written: the
// pre-pass's rowsum(dout o o)); dk_ws (B, Sk, H, D) and dv_ws (B, Sk, H, DV)
// float32 workspaces, written before they are read -- unused (null) on the
// bf16 route when H == Hkv. (D, DV): (d, d) for d in
// 16, 32, 64, 80, 128, 256, (192, 128) or (32, 16). The mask is B3's
// (attention_mask.cuh): causal, a window (<= 0: none) and a prefix (0: none),
// query row i at position q_off + i.
extern "C" int flash_attention_bwd_launch(
    int is_bf16, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dk_ws, float* dv_ws,
    void* dq, void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int D,
    int DV, float scale, int causal, int window, int prefix, int q_off, void* stream)
{
    if (is_bf16)
        return attention_bwd_dispatch<__nv_bfloat16>(
            D, DV, q, k, v, o, dout, lse, delta, dk_ws, dv_ws, dq, dk, dv, B, H, Hkv,
            Sq, Sk, scale, causal, window, prefix, q_off, (cudaStream_t)stream);
    return attention_bwd_dispatch<float>(
        D, DV, q, k, v, o, dout, lse, delta, dk_ws, dv_ws, dq, dk, dv, B, H, Hkv, Sq,
        Sk, scale, causal, window, prefix, q_off, (cudaStream_t)stream);
}
