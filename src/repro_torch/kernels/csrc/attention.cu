// Attention kernels for NVIDIA Hopper (sm_90a): bf16 or float32 in, float32
// softmax and accumulation, output in the input type. Built by nvcc into a
// shared library with a plain C interface and loaded with ctypes (see
// ../_build.py). No -fmad=false here: these kernels promise agreement with
// their plain versions within a stated tolerance, not the same bits.
//
// Layout at the C interface is the model's own: q (B, S, H, D), k/v
// (B, S, Hkv, D), addressed through the (batch, seq, head) strides the
// wrapper passes in elements, the head dim contiguous. Nothing is
// transposed or repeated: query head h reads KV head h / (H / Hkv), the
// order of jnp.repeat / the (Hkv, groups) reshape in the JAX model.
//
// Every launcher runs on the stream it is given, allocates nothing, does
// not synchronise, and returns cudaGetLastError() for the wrapper to check.
// The sums over keys are taken in a fixed order (no atomics), so a result
// is the same from run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "mma_bf16.cuh"
#include "attention_mask.cuh"

#define ATTN_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// B3  flash_attention  (prefill: causal self-attention over the prompt)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (entry flash_attention_p, wrapper ops.flash_attention): blocked
// online-softmax attention with causal block skipping, key mask
// k_pos < Sk, masked scores -1e30, and the output divided by max(l, 1e-30).
//
// Bound: at the serving path's prefill (B=4, S=2048, H=16, Hkv=2, D=128,
// bf16) the causal half of 4*B*H*S*S*D is 69 GFLOP per layer against
// 8.9 MB of q, k, v and output -- some 7 700 operations per byte, far above
// the card's ~295, so the bound is the tensor cores' 989 TFLOP/s (0.07 ms);
// the float32 route is bound by the CUDA cores' 67 TFLOP/s.
//
// Both routes, for training, write each query row's log-sum-exp of its
// scaled live scores (m + log l, float32 (B, H, Sq)) when the launcher gets
// an lse pointer -- what the backward kernel B9 (attention_bwd.cu)
// recomputes P from. Serving passes a null pointer: one predicated store
// per row at the end of a block, nothing in the key loop.
//
// Both routes: one block per (q-tile of 64 rows, head, batch). The key loop
// runs over tiles of 64 and stops at the diagonal (and at Sk), so a tile
// that the causal mask would zero is never loaded -- the point of the
// Pallas kernel, which the plain chunked XLA path
// (models/common.py::flash_attention_jax) does not do. tiles_loaded
// receives each block's count of key tiles.
//
// Masks beyond the Pallas kernel's, those of the JAX model path
// (src/repro/models/common.py: _window_ok, plain_attention,
// flash_attention_jax): a sliding window (key j live for query i only if
// j > i - window; window <= 0 is none) on top of causal order, and a
// prefix (keys j < prefix live for every query, OR-ed in after the window,
// as the reference does). key_tiles() lists the key tiles that hold a live
// pair for some row of a query tile -- the prefix's tiles, then the band
// from the window's first key to the diagonal -- and the loop visits those
// alone, so a windowed layer loads O(window) keys a row, not O(S). The
// per-element rule is key_live(). A row can now meet a visited tile with no
// live key of its own before its first live one (the top rows of a window's
// first tile); its running max is still -1e30 there. The float32 route then
// sums exp(0) = 1 per key, and the rescale exp(-1e30 - m) = 0 at its first
// live key drops that exactly; the bf16 route takes p = 0 for such a row
// (its exp2 of a fused multiply-add would be that of a rounding error of
// 1e30 * log2(e), 0 or inf). Rows with a live key are untouched by either.
//
// bf16 (flash_attention_bf16_kernel): FlashAttention-2 on the tensor cores.
// The blocks run in block_work's order (attention_mask.cuh), the q-tiles
// reversed, so the longest causal rows start first and the short ones fill
// the tail. Where a call's K / V exceed half of L2 the (batch, head) pairs
// run in groups whose K / V stay in L2 (order_group): multi-head latent
// attention's prefill, whose every head has K and V of its own (671 MB at
// deepseek-v2's (4, 2048, 128)), otherwise re-read each query tile's causal
// prefix from HBM, some 10.8 GB a call in the one-group order. Of the
// serving paths' other shapes only hubert's encoder (31 MB) forms groups;
// qwen's, hymba's, paligemma's, granite's, the reduced MLA's and the
// chunked prefill keep the one-group order, the grid's before block_work,
// and none reads slower (PERF.md). The order changes no block's
// arithmetic, so no output bit and no tiles_loaded count depends on it.
// Four warps, each
// owning 16 query rows; q's fragments are loaded once by ldmatrix and stay
// in registers for the whole key loop up to D = 128 (at D = 256 they would
// take 64 registers beside the output accumulator's 128, past the 255 a
// thread may have, so there they are read again from the q tile, which
// stays in shared memory, at every k16 step). S = q k^T is mma.sync m16n8k16
// bf16 -> float32 with K fragments by ldmatrix (a K row is a column of
// k^T). The scale multiplies the float32 scores (q is not rounded after
// scaling); the mask is applied only in tiles that cross the diagonal or
// Sk. The online softmax stays in registers: each thread holds 2 rows x 16
// keys of a tile, row maxima are combined over the 4 threads of a quad by
// __shfl_xor_sync (1 then 2: a fixed order), p = exp2 of the scaled
// difference times log2(e), and the row sum l is summed per thread from the
// float32 p and combined over the quad once, at the end. P is rounded to
// bf16 in registers and used as the A fragment of P.V, with V by
// ldmatrix.trans -- unlike the plain version and the Pallas kernel, which
// multiply p in float32. That rounding (relative 2^-9 per weight, and the
// weights sum to 1) moves each output by a few 1e-3 of its size, inside the
// 2e-2 that a bf16 output's own rounding already needs: at the serving
// prefill the output's relative L2 to the plain version is 2.1e-3 on the
// H100, that of the plain version with p rounded to bf16, and chip_smoke.py
// holds it to 6e-3 (p rounded to 3 mantissa bits reads 2.0e-2). The q tile and the
// K and V tiles come by TMA (one thread issues the box copies; a 4-D tensor
// map per tensor takes the (B, S, heads, D) strides; rows past the sequence
// are zero-filled), K and V double-buffered on two mbarriers, so tile j+1
// is in flight under tile j's products: one __syncthreads per tile. The
// 128-byte swizzle keeps each 8-row ldmatrix phase on 32 distinct banks. On
// the H100 a draft that staged the same tiles by per-thread cp.async copies
// was slower at the serving shape.
//
// Value head dim. v and the output may have a head dim DV of their own, apart
// from q and k's D: multi-head latent attention's prefill (DeepSeek-V2) has q
// and k of 128 + 64 = 192 columns and v of 128. Both routes are templates on
// (D, DV): q, K and the scores take D, V, the accumulator and the output DV.
// The bf16 route's V tile is DV / 64 TMA boxes (two at 128, where K takes
// three at 192), its stage D + DV wide, so (192, 128) uses 105 KB and two
// blocks fit an SM; q's 12 k16 fragments stay in registers there beside the
// 64-register accumulator. The built pairs are (d, d) for d in 16, 32, 64,
// 80, 128, 256, (192, 128) and (32, 16); (d, d) compiles to the code it had
// before DV existed. (32, 16) is the reduced DeepSeek-V2's MLA, q / k of 16 +
// 8 = 24 columns and v of 16: 24 is not a multiple of mma.sync's k-step of
// 16, so the wrapper zero-pads q and k to 32 columns (and passes the scale of
// 24 columns); the padded columns add exact zeros to every score.
//
// Query offset. Query row i may sit at position q_off + i (chunked prefill:
// Sq new queries behind q_off keys already in k / v). The masks take the
// position (attention_mask.cuh), so key_tiles() walks the tiles of the
// offset rows' band and the bf16 route's "tile needs the mask" test adds
// the offset to q0; q_off = 0 adds nothing, and the kernels' bits at 0 are
// those they had before the offset (chip_attention_bits.py).
//
// float32 (flash_attention_kernel): true float32 FMAs on the CUDA cores (no
// TF32, so it holds 2e-5 against the plain version): 256 threads, q scaled
// in float32 and staged with the K and V tiles in shared memory, each
// thread a 4x4 block of the score tile and a 4 x D/16 block of the output,
// row statistics four threads to a row (fixed-order combine).
// ---------------------------------------------------------------------------
namespace fa {
constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr int SLD = BK + 4;  // padded score row: conflict-free row-stat reads

template <int D> __host__ __device__ constexpr int ld() { return D + 4; }  // padded q/k/v row
// the K/V buffer holds the K tile (rows of ld<D>) and then the V tile (rows
// of ld<DV>): the wider of the two
template <int D, int DV> __host__ __device__ constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t)(BQ * ld<D>() + BK * ld<(D > DV ? D : DV)>()
                                    + BQ * SLD + 2 * THREADS + 3 * BQ);
}
// the output column of a thread's j-th accumulator: float4-friendly runs
// of four when D is a multiple of 64, a stride of 16 otherwise
template <int D> __device__ __forceinline__ int out_col(int tx, int j) {
    if constexpr (D % 64 == 0) return (j / 4) * 64 + 4 * tx + (j % 4);
    else return tx + 16 * j;
}
}  // namespace fa

// at D = 192 and 256 the block's shared memory (121 / ~150 KB) leaves room
// for one block an SM, so the register cap is lifted to the hardware's with it
template <typename T, int D, int DV>
__global__ void __launch_bounds__(fa::THREADS, D > 128 ? 1 : 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int H, int Hkv, int Sq, int Sk,
                       int64_t qsb, int64_t qss, int64_t qsh,
                       int64_t ksb, int64_t kss, int64_t ksh,
                       int64_t vsb, int64_t vss, int64_t vsh,
                       float scale, int causal, int window, int prefix, int q_off,
                       int* __restrict__ tiles_loaded, float* __restrict__ lse)
{
    using namespace fa;
    constexpr int LD = ld<D>(), LDV = ld<DV>();
    constexpr int NC = DV / 16;  // output columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;                   // BQ x LD, scaled q
    float* KVs = Qs + BQ * LD;          // the K tile (BK x LD), then the V tile (BK x LDV)
    float* Ss = KVs + BK * (LD > LDV ? LD : LDV);  // BQ x SLD, scores, then p
    float* red_m = Ss + BQ * SLD;       // THREADS partial row maxima
    float* red_s = red_m + THREADS;     // THREADS partial row sums
    float* row_m = red_s + THREADS;     // BQ running max
    float* row_l = row_m + BQ;          // BQ running sum
    float* row_a = row_l + BQ;          // BQ rescale of this tile

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;   // 4x4 score block / output rows
    const int sr = tid / 4, sp = tid % 4;     // row statistics: 4 threads a row
    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int q0 = qt * BQ;

    const T* qb = q + b * qsb + h * qsh;
    const T* kb = k + b * ksb + hk * ksh;
    const T* vb = v + b * vsb + hk * vsh;

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D, c = i % D, s = q0 + r;
        Qs[r * LD + c] = s < Sq ? to_f(qb[(int64_t)s * qss + c]) * scale : 0.f;
    }
    if (tid < BQ) { row_m[tid] = ATTN_NEG_INF; row_l[tid] = 0.f; }

    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

    // only the key tiles that hold a live pair for some row of this tile
    // are loaded (key_tiles)
    const KeyTiles kts = key_tiles(q0, min(q0 + BQ, Sq) - 1, Sk, causal, window,
                                   prefix, BK, q_off);
    const int n_tiles = kts.n;
    if (tiles_loaded != nullptr && tid == 0)
        tiles_loaded[((int64_t)b * H + h) * gridDim.x + qt] = n_tiles;

    for (int it = 0; it < n_tiles; ++it) {
        const int k0 = key_tile(kts, it) * BK;
        __syncthreads();  // the previous tile is done with KVs and Ss
        for (int i = tid; i < BK * D; i += THREADS) {
            const int r = i / D, c = i % D, s = k0 + r;
            KVs[r * LD + c] = s < Sk ? to_f(kb[(int64_t)s * kss + c]) : 0.f;
        }
        __syncthreads();

        // scores: rows ty + 16 i, keys tx + 16 j
        float sacc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            float4 a[4], kk[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                a[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                kk[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * LD + d]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float s = sacc[i][j];
                    s = fmaf(a[i].x, kk[j].x, s);
                    s = fmaf(a[i].y, kk[j].y, s);
                    s = fmaf(a[i].z, kk[j].z, s);
                    s = fmaf(a[i].w, kk[j].w, s);
                    sacc[i][j] = s;
                }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = ty + 16 * i, c = tx + 16 * j;
                const bool ok = key_live(q0 + r, k0 + c, Sk, causal, window, prefix,
                                         q_off);
                Ss[r * SLD + c] = ok ? sacc[i][j] : ATTN_NEG_INF;
            }
        __syncthreads();  // K tile consumed, scores written

        // the V tile replaces the K tile; row maxima meanwhile
        for (int i = tid; i < BK * DV; i += THREADS) {
            const int r = i / DV, c = i % DV, s = k0 + r;
            KVs[r * LDV + c] = s < Sk ? to_f(vb[(int64_t)s * vss + c]) : 0.f;
        }
        float mloc = ATTN_NEG_INF;
#pragma unroll
        for (int e = 0; e < BK / 4; ++e) mloc = fmaxf(mloc, Ss[sr * SLD + sp + 4 * e]);
        red_m[tid] = mloc;
        __syncthreads();
        const float m_prev = row_m[sr];
        const float m_new = fmaxf(fmaxf(m_prev, fmaxf(red_m[4 * sr], red_m[4 * sr + 1])),
                                  fmaxf(red_m[4 * sr + 2], red_m[4 * sr + 3]));
        float sloc = 0.f;
#pragma unroll
        for (int e = 0; e < BK / 4; ++e) {
            const int c = sp + 4 * e;
            const float p = expf(Ss[sr * SLD + c] - m_new);
            Ss[sr * SLD + c] = p;
            sloc += p;
        }
        red_s[tid] = sloc;
        __syncthreads();
        if (sp == 0) {
            const float alpha = expf(m_prev - m_new);
            const float tile_sum = ((red_s[4 * sr] + red_s[4 * sr + 1])
                                    + red_s[4 * sr + 2]) + red_s[4 * sr + 3];
            row_l[sr] = row_l[sr] * alpha + tile_sum;
            row_m[sr] = m_new;
            row_a[sr] = alpha;
        }
        __syncthreads();

        // acc = acc * alpha + P V
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float al = row_a[ty + 16 * i];
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[i][j] *= al;
        }
#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            float p[4], vv[NC];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * SLD + c];
            if constexpr (DV % 64 == 0) {
#pragma unroll
                for (int j = 0; j < NC; j += 4) {
                    const float4 f = *reinterpret_cast<const float4*>(
                        &KVs[c * LDV + fa::out_col<DV>(tx, j)]);
                    vv[j] = f.x; vv[j + 1] = f.y; vv[j + 2] = f.z; vv[j + 3] = f.w;
                }
            } else {
#pragma unroll
                for (int j = 0; j < NC; ++j) vv[j] = KVs[c * LDV + fa::out_col<DV>(tx, j)];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
        }
    }

    // row_l is final: its last write came before the loop's last barrier
    __syncthreads();
    if (lse != nullptr && tid < BQ && q0 + tid < Sq)
        lse[((int64_t)b * H + h) * Sq + q0 + tid] =
            row_m[tid] + logf(fmaxf(row_l[tid], 1e-30f));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, s = q0 + r;
        if (s >= Sq) continue;
        const float l = fmaxf(row_l[r], 1e-30f);
        T* orow = o + (((int64_t)b * Sq + s) * H + h) * DV;
#pragma unroll
        for (int j = 0; j < NC; ++j) orow[fa::out_col<DV>(tx, j)] = from_f<T>(acc[i][j] / l);
    }
}

namespace fa2 {
constexpr int BQ = 64, BK = 64, WARPS = 4, THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// The q tile, then two stages of (K tile, V tile), each a tile64 tile: q
// and K of D columns, V of DV.
using namespace tile64;
template <int D, int DV> constexpr size_t smem_bytes() {
    // + 1024: the tiles' start is rounded up to the swizzle's alignment
    return 3 * (size_t)tile_bytes<D>() + 2 * (size_t)tile_bytes<DV>() + 1024;
}
}  // namespace fa2

template <int D, int DV>
__global__ void __launch_bounds__(fa2::THREADS, 2)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o,
                            int B, int H, int Hkv, int Sq, int Sk,
                            float scale, int causal, int window, int prefix, int q_off,
                            int group, int* __restrict__ tiles_loaded,
                            float* __restrict__ lse)
{
    using namespace fa2;
    constexpr int TB = tile_bytes<D>(), TBV = tile_bytes<DV>();
    constexpr int KD = D / 16;   // k16 steps of q k^T
    constexpr int NO = DV / 8;   // n8 tiles of the output
    constexpr int NS = BK / 8;   // n8 tiles of the scores
    // q's fragments (4 KD registers) stay in registers beside the output
    // accumulator (4 NO) up to 112 of them: D <= 128 with DV = D, and
    // (192, 128); at D = 256 they are re-read from shared memory
    constexpr bool Q_IN_REGS = KD + NO <= 28;
    extern __shared__ __align__(16) unsigned char fa2_smem[];
    unsigned char* Qs = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(fa2_smem) + 1023) & ~(uintptr_t)1023);
    // stage s: the K tile at s (TB + TBV), the V tile after it
    unsigned char* KV = Qs + TB;
    __shared__ __align__(8) uint64_t full[2];

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    // the longest query tile of a (batch, head) first (block_work's rank 0)
    const int n_qt = (Sq + BQ - 1) / BQ;
    const BlockWork bw = block_work((int)blockIdx.x, n_qt, H, B, group);
    const int h = bw.pair, b = bw.b, qt = n_qt - 1 - bw.rank;
    const int hk = h / (H / Hkv);
    const int q0 = qt * BQ;

    // only the key tiles that hold a live pair for some row of this tile
    // are loaded (key_tiles)
    const KeyTiles kts = key_tiles(q0, min(q0 + BQ, Sq) - 1, Sk, causal, window,
                                   prefix, BK, q_off);
    const int n_tiles = kts.n;
    if (threadIdx.x == 0) {
        if (tiles_loaded != nullptr)
            tiles_loaded[((int64_t)b * H + h) * n_qt + qt] = n_tiles;
        mbar_init(&full[0], 1);
        mbar_init(&full[1], 1);
        mbar_fence_init();
        mbar_expect_tx(&full[0], 2 * TB + TBV);
        const int k_first = key_tile(kts, 0) * BK;
        load_tile<D>(Qs, &tq, h, q0, b, &full[0]);
        load_tile<D>(KV, &tk, hk, k_first, b, &full[0]);
        load_tile<DV>(KV + TB, &tv, hk, k_first, b, &full[0]);
    }
    __syncthreads();  // the barriers are initialised before anyone waits

    // this thread's rows of the warp's 16: g and g + 8
    const int row0 = q0 + warp * 16 + g;
    uint32_t qf[Q_IN_REGS ? KD : 1][4];
    float oacc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
    float m[2] = {ATTN_NEG_INF, ATTN_NEG_INF};  // running row max (scaled)
    float l[2] = {0.f, 0.f};  // this thread's part of the running row sum

    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = key_tile(kts, kt) * BK;
        mbar_wait(&full[kt % 2], (kt / 2) & 1);
        // tile kt has landed, and every warp is done with tile kt - 1,
        // whose stage the next load overwrites
        __syncthreads();
        if constexpr (Q_IN_REGS) {
            if (kt == 0) {
#pragma unroll
                for (int kd = 0; kd < KD; ++kd)
                    ldmatrix_x4(qf[kd], at(Qs, warp * 16 + lane % 16,
                                           kd * 16 + (lane / 16) * 8));
            }
        }
        if (threadIdx.x == 0 && kt + 1 < n_tiles) {
            unsigned char* st = KV + ((kt + 1) % 2) * (TB + TBV);
            uint64_t* bar = &full[(kt + 1) % 2];
            const int k_next = key_tile(kts, kt + 1) * BK;
            mbar_expect_tx(bar, TB + TBV);
            load_tile<D>(st, &tk, hk, k_next, b, bar);
            load_tile<DV>(st + TB, &tv, hk, k_next, b, bar);
        }
        const unsigned char* Kt = KV + (kt % 2) * (TB + TBV);
        const unsigned char* Vt = Kt + TB;

        // S = q k^T: this warp's 16 rows x 64 keys, n8 tile j = keys 8j..
        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
            uint32_t qr[4];
            const uint32_t* qa = qr;
            if constexpr (Q_IN_REGS)
                qa = qf[kd];
            else
                ldmatrix_x4(qr, at(Qs, warp * 16 + lane % 16,
                                   kd * 16 + (lane / 16) * 8));
#pragma unroll
            for (int j = 0; j < NS; j += 2) {
                // matrices: keys 8j.. x d (lo, hi 8), keys 8j+8.. x d (lo, hi)
                uint32_t r[4];
                ldmatrix_x4(r, at(Kt, j * 8 + (lane / 16) * 8 + lane % 8,
                                  kd * 16 + ((lane / 8) % 2) * 8));
                mma_bf16(s[j], qa, r);
                mma_bf16(s[j + 1], qa, r + 2);
            }
        }

        // scale in float32; mask only where a tile crosses the diagonal,
        // the window's lower edge or Sk
        const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + q_off)
                            || (window > 0 && k0 <= q0 + q_off + BQ - 1 - window);
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[j][e] * scale;
                if (masked) {
                    const int kpos = k0 + j * 8 + 2 * t + (e % 2);
                    const int qpos = row0 + (e / 2) * 8;
                    if (!key_live(qpos, kpos, Sk, causal, window, prefix, q_off))
                        x = ATTN_NEG_INF;
                }
                s[j][e] = x;
            }

        // online softmax, rows g (r = 0) and g + 8 (r = 1)
        float alpha[2], mb[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float mx = m[r];
#pragma unroll
            for (int j = 0; j < NS; ++j)
                mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            alpha[r] = exp2f((m[r] - mx) * LOG2E);
            m[r] = mx;
            // no live key of this row yet: p = exp2(-1e30 log2(e)) = 0
            mb[r] = mx == ATTN_NEG_INF ? 0.f : mx * LOG2E;
        }
        uint32_t pf[BK / 16][4];  // P as the A fragments of the k16 steps
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const float p0 = exp2f(fmaf(s[j][0], LOG2E, -mb[0]));
            const float p1 = exp2f(fmaf(s[j][1], LOG2E, -mb[0]));
            const float p2 = exp2f(fmaf(s[j][2], LOG2E, -mb[1]));
            const float p3 = exp2f(fmaf(s[j][3], LOG2E, -mb[1]));
            rs[0] += p0 + p1;
            rs[1] += p2 + p3;
            // keys 8j.. are k-step j/2, its low (j even) or high 8 columns
            pf[j / 2][(j % 2) * 2] = pack_bf16x2(p0, p1);
            pf[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(p2, p3);
        }
        l[0] = l[0] * alpha[0] + rs[0];
        l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            oacc[n][0] *= alpha[0]; oacc[n][1] *= alpha[0];
            oacc[n][2] *= alpha[1]; oacc[n][3] *= alpha[1];
        }

        // O += P V: V's rows are the k dimension, read transposed
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int n = 0; n < NO; n += 2) {
                // matrices: keys (lo, hi 8) x d 8n.., keys (lo, hi) x d 8n+8..
                uint32_t r[4];
                ldmatrix_x4_trans(r, at(Vt, kk * 16 + lane % 16,
                                        n * 8 + (lane / 16) * 8));
                mma_bf16(oacc[n], pf[kk], r);
                mma_bf16(oacc[n + 1], pf[kk], r + 2);
            }
    }

    // the quad's four parts of each row sum, in a fixed order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-30f);
    }
    if (lse != nullptr && t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int qpos = row0 + 8 * r;
            if (qpos < Sq) lse[((int64_t)b * H + h) * Sq + qpos] = m[r] + logf(l[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        if (qpos >= Sq) continue;
        __nv_bfloat16* orow = o + (((int64_t)b * Sq + qpos) * H + h) * DV;
#pragma unroll
        for (int n = 0; n < NO; ++n)
            *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
                __floats2bfloat162_rn(oacc[n][2 * r] / l[r],
                                      oacc[n][2 * r + 1] / l[r]);
    }
}

// q, k or v, (B, S, heads, D) through its element strides {batch, seq,
// head}, as a 4-D tensor map (D, heads, S, B) read in boxes of 64 rows of
// one head
template <int D>
static bool attention_map(CUtensorMap* map, const void* base, int B, int S,
                          int heads, const int64_t* st)
{
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                                (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                   (cuuint64_t)st[0] * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)fa2::BK, 1};
    return bf16_box_map(map, base, 4, dims, strides, box);
}

template <int D, int DV>
static int flash_attention_bf16_run(const void* q, const void* k, const void* v,
                                    void* o, int B, int H, int Hkv, int Sq, int Sk,
                                    const int64_t* qst, const int64_t* kst,
                                    const int64_t* vst, float scale, int causal,
                                    int window, int prefix, int q_off, int* tiles_loaded,
                                    float* lse, cudaStream_t stream)
{
    CUtensorMap tq, tk, tv;
    if (!attention_map<D>(&tq, q, B, Sq, H, qst)
        || !attention_map<D>(&tk, k, B, Sk, Hkv, kst)
        || !attention_map<DV>(&tv, v, B, Sk, Hkv, vst))
        return (int)cudaErrorInvalidValue;
    const size_t smem = fa2::smem_bytes<D, DV>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    // a KV head's K / V tiles, walked by its H / Hkv query heads
    const int n_qt = (Sq + fa2::BQ - 1) / fa2::BQ;
    const int group = order_group(B * H, H / Hkv, 2.0 * Sk * (D + DV));
    flash_attention_bf16_kernel<D, DV><<<(unsigned)(B * H * n_qt), fa2::THREADS, smem,
                                         stream>>>(
        tq, tk, tv, (__nv_bfloat16*)o, B, H, Hkv, Sq, Sk, scale, causal, window, prefix,
        q_off, group, tiles_loaded, lse);
    return (int)cudaGetLastError();
}

template <typename T, int D, int DV>
static int flash_attention_run(const void* q, const void* k, const void* v, void* o,
                               int B, int H, int Hkv, int Sq, int Sk,
                               const int64_t* qst, const int64_t* kst,
                               const int64_t* vst, float scale, int causal,
                               int window, int prefix, int q_off, int* tiles_loaded,
                               float* lse, cudaStream_t stream)
{
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        return flash_attention_bf16_run<D, DV>(q, k, v, o, B, H, Hkv, Sq, Sk, qst, kst,
                                               vst, scale, causal, window, prefix,
                                               q_off, tiles_loaded, lse, stream);
    } else {
        const size_t smem = fa::smem_bytes<D, DV>();
        cudaError_t err = cudaFuncSetAttribute(
            flash_attention_kernel<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        dim3 grid((unsigned)((Sq + fa::BQ - 1) / fa::BQ), (unsigned)H, (unsigned)B);
        flash_attention_kernel<T, D, DV><<<grid, fa::THREADS, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (T*)o, H, Hkv, Sq, Sk,
            qst[0], qst[1], qst[2], kst[0], kst[1], kst[2], vst[0], vst[1], vst[2],
            scale, causal, window, prefix, q_off, tiles_loaded, lse);
        return (int)cudaGetLastError();
    }
}

template <typename T>
static int flash_attention_dispatch(int D, int Dv, const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Hkv, int Sq, int Sk, const int64_t* qst,
                                    const int64_t* kst, const int64_t* vst,
                                    float scale, int causal, int w, int p, int qo,
                                    int* tiles, float* lse, cudaStream_t s)
{
    if (D == 192 && Dv == 128)  // multi-head latent attention's prefill
        return flash_attention_run<T, 192, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, qst, kst, vst, scale, causal, w, p, qo, tiles, lse, s);
    if (D == 32 && Dv == 16)  // the reduced MLA's (24, 16), q / k zero-padded to 32
        return flash_attention_run<T, 32, 16>(q, k, v, o, B, H, Hkv, Sq, Sk, qst, kst, vst, scale, causal, w, p, qo, tiles, lse, s);
    if (Dv != D) return (int)cudaErrorInvalidValue;
    switch (D) {
    case 16:  return flash_attention_run<T, 16, 16>(q, k, v, o, B, H, Hkv, Sq, Sk, qst, kst, vst, scale, causal, w, p, qo, tiles, lse, s);
    case 32:  return flash_attention_run<T, 32, 32>(q, k, v, o, B, H, Hkv, Sq, Sk, qst, kst, vst, scale, causal, w, p, qo, tiles, lse, s);
    case 64:  return flash_attention_run<T, 64, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, qst, kst, vst, scale, causal, w, p, qo, tiles, lse, s);
    case 80:  return flash_attention_run<T, 80, 80>(q, k, v, o, B, H, Hkv, Sq, Sk, qst, kst, vst, scale, causal, w, p, qo, tiles, lse, s);
    case 128: return flash_attention_run<T, 128, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, qst, kst, vst, scale, causal, w, p, qo, tiles, lse, s);
    case 256: return flash_attention_run<T, 256, 256>(q, k, v, o, B, H, Hkv, Sq, Sk, qst, kst, vst, scale, causal, w, p, qo, tiles, lse, s);
    default:  return (int)cudaErrorInvalidValue;
    }
}

// is_bf16: 1 for bf16 tensors, 0 for float32. Strides are in elements:
// {batch, seq, head}; for bf16 every row starts on a 16-byte boundary (the
// base addresses and the strides are multiples of 16 bytes: TMA; the
// wrapper gives a length-1 dim a dense stride, as its index is always 0).
// tiles_loaded: nullptr, or B*H*ceil(Sq/64) ints that receive the number of
// key tiles each block loaded. lse: nullptr (serving), or B*H*Sq floats,
// dense (B, H, Sq), that receive each query row's log-sum-exp of its scaled
// live scores, m + log(l), for the backward kernel B9 (attention_bwd.cu).
// window: the sliding window's width (key j live for query i only if j > i
// - window), <= 0 for none; prefix: keys j < prefix live for every query
// (prefix-LM), 0 for none (key_live). q_offset: query row i sits at position
// q_offset + i (>= 0; 0 is self-attention's alignment). D: q and k's head
// dim; Dv: v's and the output's, D, or (D, Dv) = (192, 128) or (32, 16);
// another pair is refused.
extern "C" int flash_attention_launch(
    int is_bf16, const void* q, const void* k, const void* v, void* o,
    int B, int H, int Hkv, int Sq, int Sk, int D, int Dv,
    const int64_t* q_strides, const int64_t* k_strides, const int64_t* v_strides,
    float scale, int causal, int window, int prefix, int q_offset, int* tiles_loaded,
    float* lse, void* stream)
{
    if (is_bf16)
        return flash_attention_dispatch<__nv_bfloat16>(
            D, Dv, q, k, v, o, B, H, Hkv, Sq, Sk, q_strides, k_strides, v_strides,
            scale, causal, window, prefix, q_offset, tiles_loaded, lse,
            (cudaStream_t)stream);
    return flash_attention_dispatch<float>(
        D, Dv, q, k, v, o, B, H, Hkv, Sq, Sk, q_strides, k_strides, v_strides,
        scale, causal, window, prefix, q_offset, tiles_loaded, lse, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// B4  decode_attention  (one new token against the KV cache)
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::_kernel
// (entry decode_attention_p): one query per head against the caches over
// slots [0, cache_len] inclusive; slots past cache_len are never read;
// cache_len is a launch argument. Beyond the Pallas kernel, the JAX model
// path's sliding window and prefix (src/repro/models/common.py::
// decode_attention): the live slots are then [0, n_pre) and [first,
// cache_len], first = cache_len - window + 1, n_pre = min(prefix, first);
// the kernel walks n_live logical slots, logical u at slot u < n_pre ? u :
// first + u - n_pre, so the splits cover the live slots alone and a slot
// outside them is never read. With no window it is the identity map.
//
// Bound: bytes. Each step reads the live part of the K and V caches once,
// 2 * B * (cache_len+1) * Hkv * D elements, against 4 * B * H *
// (cache_len+1) * D operations -- 2 * H/Hkv = 16 operations per bf16
// element at qwen2.5-3b's 8 query heads per KV head, far below the ~295
// at which the card stops being bound by its 3.35 TB/s. So the CUDA cores
// are enough for q.k and p.v; what matters is reading the cache at the
// memory's rate, which takes many blocks and many loads in flight.
//
// Design (flash-decoding, two kernels):
// decode_attention_kernel: the grid is (split, KV head, batch). A split is
// a run of split_len <= 64 live slots (the wrapper's decode_splits: it
// depends on the live slots alone -- their count and the window's first
// slot --, never on the card, so the bits are the same run to run and
// card to card; no split lies wholly past cache_len). At
// the serving shape (B 4, Hkv 2, ~2 080 live slots, split_len 64) that is
// 264 blocks, two an SM, where one block per (KV head, batch) gave 8. A
// block serves all H/Hkv query heads of its KV head, so each cache row is
// read once per step, not once per query head. Its threads lie across D:
// a cache row is D/EPV lanes of one 16-byte load each, so a warp's loads
// cover whole rows. Every load of the block -- its K and V rows and q --
// is issued before the first use and held raw in registers, so a split
// costs one trip to memory (V does not wait for the softmax). A lane holds
// E = max(16 bytes, D / 32) elements of a row, so a row never spans more
// than a warp: at D = 256 in float32 that is two 16-byte loads a lane, and
// there V's loads wait for the softmax, which keeps the raw rows to 64
// registers. The per-warp p.v partials live in dynamic shared memory
// (NW * 8 * D floats: 64 KB at D = 256, past the 48 KB of static). q.k is
// summed over the row's lanes by a fixed reduce-scatter of the heads'
// sums (8 shuffles a row for 8 heads where a butterfly per head takes 32);
// the split's scores stay in shared memory, so its max and sum are exact
// over the split, with no rescaling inside it. p.v is summed per lane over
// its rows, then over the warp's rows by the same reduce-scatter, then
// over the warps in warp order. The split writes its unnormalised
// (m, l, o[G][D]) in float32 to the wrapper's workspace.
// decode_attention_combine_kernel: one block per (head, batch), a thread
// per d, merges the splits in split-index order -- whatever order the
// blocks finished in -- as o = sum_s o_s e^(m_s - M) / sum_s l_s e^(m_s - M),
// reading each split's (m, l) straight from the workspace. No atomics and
// no limit on the number of splits: the result is the same from run to
// run, and with one split it equals the single-pass o / l.
// ---------------------------------------------------------------------------
namespace da {
constexpr int THREADS = 256, NW = THREADS / 32, MAXG = 8;
constexpr int SPLIT_MAX = 64;   // slots of one split, all in registers
constexpr unsigned FULL = 0xffffffffu;
// the per-warp p.v partials' shared memory
template <int D> constexpr size_t smem_bytes() { return sizeof(float) * NW * MAXG * D; }
}

// logical live slot u of a decode step -> its cache slot
__device__ __forceinline__ int64_t live_slot(int u, int n_pre, int first)
{
    return u < n_pre ? u : (int64_t)first + u - n_pre;
}

// 16 raw bytes of cache row and their widening to float
__device__ __forceinline__ uint4 ld16(const void* p)
{
    return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void widen(const uint4& u, float* out, __nv_bfloat16)
{
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}
__device__ __forceinline__ void widen(const uint4& u, float* out, float)
{
    out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
}

// Sum N values of each lane over the lanes that differ in the bits
// LO, 2 LO, ..., < HI of the lane index, leaving each lane the complete
// sums of N >> rounds of them: a reduce-scatter (each round a lane keeps
// one half of its values, adds its partner's copy of that half and sends
// the other) that takes N/2 + N/4 + ... shuffles, not N a round. Which
// half a lane keeps follows its bits, so first() (returned) is the index
// of its first complete sum. The tree is fixed: the same bits every run.
template <int N, int LO, int HI>
__device__ __forceinline__ int reduce_scatter(float* v, int lane)
{
    int first = 0;
    int c = N;
#pragma unroll
    for (int off = HI / 2; off >= LO; off /= 2) {
        if (c > 1) {
            const int h = c / 2;
            const bool hi = (lane & off) != 0;
#pragma unroll
            for (int i = 0; i < N / 2; ++i) {
                if (i < h) {
                    const float send = hi ? v[i] : v[i + h];
                    const float keep = hi ? v[i + h] : v[i];
                    v[i] = keep + __shfl_xor_sync(da::FULL, send, off);
                }
            }
            if (hi) first += h;
            c = h;
        } else {
            v[0] += __shfl_xor_sync(da::FULL, v[0], off);
        }
    }
    return first;
}

template <typename T, int D>
__global__ void __launch_bounds__(da::THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, float* __restrict__ ws_o,
                        float* __restrict__ ws_ml, int H, int Hkv,
                        int n_live, int n_pre, int first, int split_len,
                        int64_t qsb, int64_t qsh,
                        int64_t ksb, int64_t kss, int64_t ksh,
                        int64_t vsb, int64_t vss, int64_t vsh, float scale)
{
    using namespace da;
    constexpr int EPV = 16 / sizeof(T);   // elements per 16-byte load
    constexpr int E = EPV > D / 32 ? EPV : D / 32;  // elements a lane holds
    constexpr int LPL = E / EPV;          // 16-byte loads a lane, a row
    constexpr int LPR = D / E;            // lanes per cache row
    constexpr int RPW = 32 / LPR;         // rows a warp covers per load
    constexpr int RB = NW * RPW;          // rows the block covers per load
    constexpr int ROWS = (SPLIT_MAX + RB - 1) / RB;  // rows a lane holds
    constexpr bool V_EARLY = ROWS * LPL <= 8;  // V loaded with K
    constexpr int NV = MAXG * E;          // a lane's p.v sums, (g, e)
    // what a lane holds after the reduce-scatters: scores of QS heads,
    // shared by the SAME lanes of its row; p.v sums of NV / RPW (g, e)
    constexpr int QS = LPR >= MAXG ? 1 : MAXG / LPR;
    constexpr int SAME = LPR >= MAXG ? LPR / MAXG : 1;
    constexpr int PVS = NV / RPW;
    __shared__ float ps[MAXG][SPLIT_MAX];
    extern __shared__ float part[];       // [w][(g E + e) LPR + lane]
    __shared__ float stat_m[MAXG], stat_l[MAXG];

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
    const int n_split = gridDim.x;
    const int G = H / Hkv, h0 = hk * G;
    const int j0 = split * split_len;
    const int nrows = min(split_len, n_live - j0);
    const int col = lane % LPR;           // this lane's E elements of a row
    const int c0 = col * E;
    const int rl = warp * RPW + lane / LPR;  // its first row of the split

    // every load of the block at once: this lane's K (and V) rows and its
    // columns of q, raw, so the split costs one trip to memory
    const T* kb = kc + b * ksb + hk * ksh + c0;
    const T* vb = vc + b * vsb + hk * vsh + c0;
    uint4 kraw[ROWS][LPL], vraw[V_EARLY ? ROWS : 1][LPL], qraw[MAXG][LPL];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
        const int r = rl + u * RB;
        if (r < nrows) {
            const int64_t slot = live_slot(j0 + r, n_pre, first);
#pragma unroll
            for (int l = 0; l < LPL; ++l) {
                kraw[u][l] = ld16(kb + slot * kss + l * EPV);
                if constexpr (V_EARLY) vraw[u][l] = ld16(vb + slot * vss + l * EPV);
            }
        }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
        if (g < G)
#pragma unroll
            for (int l = 0; l < LPL; ++l)
                qraw[g][l] = ld16(q + b * qsb + (int64_t)(h0 + g) * qsh + c0 + l * EPV);
    float qr[MAXG][E];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
        if (g < G)
#pragma unroll
            for (int l = 0; l < LPL; ++l) widen(qraw[g][l], qr[g] + l * EPV, T());
#pragma unroll
        for (int e = 0; e < E; ++e) qr[g][e] = g < G ? qr[g][e] * scale : 0.f;
    }

    // scores: ps[g][r] = q_g . k_r
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
        const int r = rl + u * RB;
        if (u * RB >= nrows) break;       // uniform: no row of the block left
        float kv[E];
        if (r < nrows) {
#pragma unroll
            for (int l = 0; l < LPL; ++l) widen(kraw[u][l], kv + l * EPV, T());
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) kv[e] = 0.f;
        }
        float sc[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
            float a = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) a = fmaf(qr[g][e], kv[e], a);
            sc[g] = a;
        }
        const int first_h = reduce_scatter<MAXG, 1, LPR>(sc, lane);
        if (r < nrows && col % SAME == 0)
#pragma unroll
            for (int i = 0; i < QS; ++i)
                if (first_h + i < G) ps[first_h + i][r] = sc[i];
    }
    if constexpr (!V_EARLY) {
        // V's rows now, into the registers K's rows held
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
            const int r = rl + u * RB;
            if (r < nrows) {
                const int64_t slot = live_slot(j0 + r, n_pre, first);
#pragma unroll
                for (int l = 0; l < LPL; ++l) kraw[u][l] = ld16(vb + slot * vss + l * EPV);
            }
        }
    }
    __syncthreads();

    // the split's softmax statistics, a warp per head
    if (warp < G) {
        float m = ATTN_NEG_INF;
        for (int j = lane; j < nrows; j += 32) m = fmaxf(m, ps[warp][j]);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
            m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
        float l = 0.f;
        for (int j = lane; j < nrows; j += 32) {
            const float p = expf(ps[warp][j] - m);
            ps[warp][j] = p;
            l += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
            l += __shfl_xor_sync(FULL, l, off);
        if (lane == 0) { stat_m[warp] = m; stat_l[warp] = l; }
    }
    __syncthreads();

    // p.v: each lane sums its rows, then the warp's rows (reduce-scatter
    // over the row groups), then the warps in warp order
    float acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.f;
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
        const int r = rl + u * RB;
        if (r < nrows) {
            float vv[E];
#pragma unroll
            for (int l = 0; l < LPL; ++l) {
                if constexpr (V_EARLY) widen(vraw[u][l], vv + l * EPV, T());
                else widen(kraw[u][l], vv + l * EPV, T());
            }
#pragma unroll
            for (int g = 0; g < MAXG; ++g) {
                if (g < G) {
                    const float p = ps[g][r];
#pragma unroll
                    for (int e = 0; e < E; ++e)
                        acc[g * E + e] = fmaf(p, vv[e], acc[g * E + e]);
                }
            }
        }
    }
    const int first_pv = reduce_scatter<NV, LPR, 32>(acc, lane);
#pragma unroll
    for (int i = 0; i < PVS; ++i)
        part[warp * (MAXG * D) + (first_pv + i) * LPR + col] = acc[i];
    __syncthreads();

    // the split's partial: o (unnormalised), m, l per (batch, head, split)
    for (int i = tid; i < G * D; i += THREADS) {
        const int g = i / D, j = i % D;
        const int d = (j % LPR) * E + j / LPR;
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) o += part[w * (MAXG * D) + i];
        const int64_t row = ((int64_t)b * H + h0 + g) * n_split + split;
        ws_o[row * D + d] = o;
    }
    if (tid < G) {
        const int64_t row = ((int64_t)b * H + h0 + tid) * n_split + split;
        ws_ml[2 * row] = stat_m[tid];
        ws_ml[2 * row + 1] = stat_l[tid];
    }
}

// one block per (head, batch), a thread per d (at least a warp of them).
// Each warp takes M, the largest of the splits' maxima, over strided
// shares of them and a shuffle (a max is exact in any order); then, 32
// splits at a time, lane i forms split s0+i's weight w = e^(m_s - M) and
// l_s w, and every thread adds both, broadcast by shuffles, in split
// order. (m, l) come straight from the workspace and a thread's partials
// 32 at a time, the first 32 issued before M is known. No shared memory,
// so the number of splits has no limit; one exp per split and lane.
template <typename T>
__global__ void decode_attention_combine_kernel(
    const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
    T* __restrict__ o, int D, int n_split)
{
    using da::FULL;
    constexpr int CH = 32;                // splits a round: one a lane
    const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
    const int d = threadIdx.x, lane = d % 32;
    const bool own = d < D;               // D = 16: half the warp owns a d
    const int64_t row0 = ((int64_t)b * H + h) * n_split;
    const float* ml = ws_ml + 2 * row0;
    const float* os = ws_o + row0 * D + d;
    float ov[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i)
        ov[i] = own && i < n_split ? os[(int64_t)i * D] : 0.f;
    float m = ATTN_NEG_INF;
    for (int s = lane; s < n_split; s += 32) m = fmaxf(m, ml[2 * s]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    float l = 0.f, acc = 0.f;
    for (int s0 = 0; s0 < n_split; s0 += CH) {
        float w = 0.f, lw = 0.f;
        if (s0 + lane < n_split) {
            w = expf(ml[2 * (s0 + lane)] - m);
            lw = ml[2 * (s0 + lane) + 1] * w;
        }
        if (s0 > 0)
#pragma unroll
            for (int i = 0; i < CH; ++i)
                ov[i] = own && s0 + i < n_split ? os[(int64_t)(s0 + i) * D] : 0.f;
#pragma unroll
        for (int i = 0; i < CH; ++i) {    // in split order, always
            const float wi = __shfl_sync(FULL, w, i);
            const float lwi = __shfl_sync(FULL, lw, i);
            if (s0 + i < n_split) {
                l = l + lwi;
                acc = acc + ov[i] * wi;
            }
        }
    }
    if (own) o[((int64_t)b * H + h) * D + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int D>
static int decode_attention_run(const void* q, const void* kc, const void* vc,
                                void* o, float* ws, int B, int H, int Hkv,
                                int n_live, int n_pre, int first, int split_len,
                                int n_split, const int64_t* qst, const int64_t* kst,
                                const int64_t* vst, float scale, cudaStream_t stream)
{
    float* ws_o = ws;
    float* ws_ml = ws + (int64_t)B * H * n_split * D;
    const size_t smem = da::smem_bytes<D>();
    cudaError_t err0 = cudaFuncSetAttribute(
        decode_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err0 != cudaSuccess) return (int)err0;
    dim3 grid((unsigned)n_split, (unsigned)Hkv, (unsigned)B);
    decode_attention_kernel<T, D><<<grid, da::THREADS, smem, stream>>>(
        (const T*)q, (const T*)kc, (const T*)vc, ws_o, ws_ml, H, Hkv, n_live,
        n_pre, first, split_len, qst[0], qst[1], kst[0], kst[1], kst[2], vst[0],
        vst[1], vst[2], scale);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    decode_attention_combine_kernel<T><<<dim3((unsigned)H, (unsigned)B),
                                         D < 32 ? 32 : D, 0, stream>>>(
        ws_o, ws_ml, (T*)o, D, n_split);
    return (int)cudaGetLastError();
}

template <typename T>
static int decode_attention_dispatch(int D, const void* q, const void* kc,
                                     const void* vc, void* o, float* ws, int B,
                                     int H, int Hkv, int n_live, int n_pre,
                                     int first, int split_len, int n_split,
                                     const int64_t* qst, const int64_t* kst,
                                     const int64_t* vst, float scale, cudaStream_t s)
{
    switch (D) {
    case 16:  return decode_attention_run<T, 16>(q, kc, vc, o, ws, B, H, Hkv, n_live, n_pre, first, split_len, n_split, qst, kst, vst, scale, s);
    case 32:  return decode_attention_run<T, 32>(q, kc, vc, o, ws, B, H, Hkv, n_live, n_pre, first, split_len, n_split, qst, kst, vst, scale, s);
    case 64:  return decode_attention_run<T, 64>(q, kc, vc, o, ws, B, H, Hkv, n_live, n_pre, first, split_len, n_split, qst, kst, vst, scale, s);
    case 128: return decode_attention_run<T, 128>(q, kc, vc, o, ws, B, H, Hkv, n_live, n_pre, first, split_len, n_split, qst, kst, vst, scale, s);
    case 256: return decode_attention_run<T, 256>(q, kc, vc, o, ws, B, H, Hkv, n_live, n_pre, first, split_len, n_split, qst, kst, vst, scale, s);
    default:  return (int)cudaErrorInvalidValue;
    }
}

// q strides {batch, head}; cache strides {batch, slot, head}; in elements.
// The output is (B, 1, H, D) contiguous. workspace: B*H*n_split*(D+2)
// floats. The live slots: n_live of them, [0, n_pre) then [first, first +
// n_live - n_pre) (no window: n_pre = first = 0, n_live = cache_len + 1);
// n_split splits of split_len <= 64 of them cover them exactly.
extern "C" int decode_attention_launch(
    int is_bf16, const void* q, const void* k_cache, const void* v_cache,
    void* o, void* workspace, int B, int H, int Hkv, int D, int n_live,
    int n_pre, int first, int split_len, int n_split,
    const int64_t* q_strides, const int64_t* k_strides, const int64_t* v_strides,
    float scale, void* stream)
{
    if (split_len < 1 || split_len > da::SPLIT_MAX || n_split < 1
        || n_pre < 0 || first < n_pre || n_live <= n_pre
        || (int64_t)(n_split - 1) * split_len >= n_live
        || (int64_t)n_split * split_len < n_live || H % Hkv != 0
        || H / Hkv > da::MAXG)
        return (int)cudaErrorInvalidValue;
    float* ws = (float*)workspace;
    if (is_bf16)
        return decode_attention_dispatch<__nv_bfloat16>(
            D, q, k_cache, v_cache, o, ws, B, H, Hkv, n_live, n_pre, first,
            split_len, n_split, q_strides, k_strides, v_strides, scale,
            (cudaStream_t)stream);
    return decode_attention_dispatch<float>(
        D, q, k_cache, v_cache, o, ws, B, H, Hkv, n_live, n_pre, first, split_len,
        n_split, q_strides, k_strides, v_strides, scale, (cudaStream_t)stream);
}
