// B10  ssd_scan_bwd -- the backward of the Mamba-2 chunked SSD scan (B5) for
// NVIDIA Hopper (sm_90a). Built by nvcc into a shared library with a plain C
// interface and loaded with ctypes (see ../_build.py). No -fmad=false: B10
// promises agreement with its plain version within a stated tolerance, and
// the same bits from run to run -- not the plain version's bits.
//
// Replaces no Pallas kernel: the JAX package trains its SSD layers through
// jax.vjp of blocks._ssd_chunk_scan (src/repro/models/blocks.py:510), whose
// forward the Pallas kernel ssd_scan_p computes for serving. On the card the
// port's forward is B5 (ssd_scan.cu), which keeps nothing for a backward;
// B10 takes its inputs x, dt, A, B, C and the output gradients dy (and,
// when given, the final state's gradient dh) and returns dx, ddt, dA, dB, dC.
//
// Layout at the C interface is B5's: x (B, S, H, P) in x's type, dt (B, S, H)
// and A (B, H) float32, B and C (B, S, G, N) in x's type, NOT repeated to
// heads (head h reads group h / (H / G)), all through element strides with
// the last dim contiguous; dy (B, S, H, P) float32, dense; dh (B, H, P, N)
// float32, dense, or null (no gradient on the final state). Outputs, dense:
// dx (B, S, H, P) in x's type, ddt (B, S, H) and dA (B, H) float32, dB and
// dC (B, S, G, N) in x's type -- a group's heads summed.
//
// The math, per (batch, head) and chunk c of Q = 64 positions (B5's chunk;
// rows past S are dt = x = B = C = dy = 0 and add nothing), with u = dt x,
// cum the in-chunk cumsum of dt A, e = cum[Q-1], h the state entering the
// chunk and dH the gradient of the state leaving it:
//   G[t,s] = C_t.B_s, W[t,s] = dy_t.u_s, L[t,s] = exp(cum_t - cum_s), s <= t
//   du_s   = sum_t G L [t,s] dy_t + exp(e - cum_s) dH B_s
//   dC_t   = sum_s (W L)[t,s] B_s + exp(cum_t) h^T dy_t
//   dB_s   = sum_t (W L)[t,s] C_t + exp(e - cum_s) dH^T u_s
//   dcum_t = sum_s R[t,s] - sum_s R[s,t] + exp(cum_t) C_t.(h^T dy_t) - z_t,
//            R = G W L, z_s = exp(e - cum_s) u_s.(dH B_s);
//   dcum[Q-1] += sum_s z_s + exp(e) <dH, h>
//   da_s   = sum_{t >= s} dcum_t (a = dt A),  ddt_s = A da_s + x_s.du_s,
//   dx_s = dt_s du_s,  dA = sum over chunks of sum_s dt_s da_s
// Only h and dH cross chunks, and both are linear recurrences with P x N
// elementwise updates:
//   h_0 = 0,             h_{c+1}  = exp(e_c) h_c  + s_c,
//                        s_c = sum_s exp(e_c - cum_s) dt_s x_s B_s^T
//   dH_{nc-1} = dh (0),  dH_{c-1} = exp(e_c) dH_c + d_c,
//                        d_c = sum_t exp(cum_t) dy_t C_t^T
// so everything else is local to a chunk once h_c and dH_c are known
// (Mamba-2's chunked algorithm, arXiv:2405.21060, section 6).
//
// Design: four kernels on the caller's stream, each launched once a call.
//  1. ssd_bwd_chunk_kernel, grid (chunk, head, batch), 128 threads: the
//     in-chunk cumsum (one thread, sequential, each product rounded before
//     its add -- B5's rule: a parallel float32 cumsum drifts in the
//     strong-decay case) into a (B, H, nc Q) float32 workspace that every
//     later kernel reads, so all of them see the same bits; s_c and d_c
//     into two (B, H, nc, P, N) float32 workspaces.
//  2. ssd_bwd_walk_kernel, grid (2 P N / 128, head, batch), a thread an
//     element and a direction: the forward walk writes h_c over s_c, the
//     reverse walk dH_c over d_c, nc dependent fmas a thread, coalesced,
//     16 chunks' loads in flight at once -- the only serial part left.
//  3. ssd_bwd_grad_kernel, grid (chunk, head, batch): everything above for
//     one chunk, with h_c and dH_c read from the workspaces (prefetched to
//     L2 while the tiles load); dB and dC per head into (B, S, H, N)
//     float32 workspaces, the chunk's sum dt da into a (B, H, nc) one.
//     Each warp computes the causal part of C B^T on its own rows; W's
//     epilogue writes W o L dt, turns G into G o L in place and takes R's
//     row and column partial sums in the same pass.
//  4. ssd_bwd_group_kernel: dB and dC summed over a group's heads in head
//     order and rounded once to x's type (as B9 sums a GQA group's dK / dV),
//     dA summed over the chunks in chunk order.
// In kernels 1 and 3 warp w owns rows 16 (w % 4) .. + 15 of every product
// (position rows in 3, rows of the state in 1); kernel 3 at N >= 64 runs 8
// warps, the second 4 taking the other half of every product's columns.
// So every row and column sum is a fixed butterfly of shuffles inside a
// warp, then the halves (row blocks) added in order through shared
// memory; the z and <dH, h> sums are fixed trees. A chunk's x, B, C and dy
// tiles come into shared memory as 16-byte vectors (element by element
// only where a stride is not a multiple of 16 bytes). No atomics, every
// sum in a fixed order: two calls give the same bits.
//
// The products, bf16 route: mma.sync m16n8k16 bf16 -> float32 (one warp a
// 16 x 8 tile, mma_bf16.cuh), with B5's precision rule (ssd_scan.cu): an
// operand that is an input's own bf16 value (x, B, C) goes in as it is; a
// float32 operand (dy, h, dH, G o L, W o L dt, x o dt w, dy o exp(cum))
// goes in as a bf16 hi / lo pair, v = hi + lo to ~2^-16 relative: two mmas
// a product, three (hi.hi, hi.lo, lo.hi) where both operands are float32.
// chip_smoke.py's kernels.b10 holds ddt and dA of this route to the
// float32 route's bars (PERF.md). Fragments are gathered by each lane from
// shared memory (for h and dH, from device memory) as bf16 or float pairs
// where the pair is contiguous. float32 route: the same products on the
// CUDA cores in float32, a lane owning a 4-row x NC/8-column micro-tile of
// its warp's 16 rows, each shared-memory value loaded once for 4 or NC/8
// FMAs.
//
// Resources at N = 128, P = 64 (ptxas, -Xptxas -v): kernel 3 holds x, B, C
// in x's type and dy, G o L and W o L in float32, rows padded by 8
// elements: 102 KB and 128 registers a thread at 256 threads in bf16, two
// blocks (16 warps) an SM; 145 KB in float32, one. At N = 16 (hymba) 74 KB
// and 130 registers at 128 threads, three blocks an SM. Kernel 1: 62 KB,
// 93 registers in bf16 (three blocks); 105 KB in float32 (two).
//
// What the design does about the kernel's first form's walls (one block
// per (head, batch) walking every chunk): 48 / 50 blocks for 132 SMs
// become 1 536 / 3 200; the serial forward recompute of the entering
// states becomes kernel 1 plus a walk of nc fmas a thread; the products
// leave the CUDA cores for mma.sync; loads go as 16-byte vectors, not
// element by element with a divide each; the 256-entry and per-row sums
// leave thread 0 for shuffles. Device us a
// call on an H100, each kernel's and in all, at mamba2-780m's and
// hymba-1.5b's training shapes: chip_smoke.py's kernels.b10 (PERF.md),
// about 0.5 ms and 0.3 ms against the first form's 4.3 and 2.3.
//
// Bound at mamba2-780m's shape: the chunked form's products are ~3.7 M
// FMAs a chunk and head, 11.3 GFLOP a call against 53 MB of inputs and
// outputs: 0.016 ms by bytes (0.011 ms of operations at the tensor cores'
// rate). The workspaces are what this design adds: s / h and d / dH are
// 2 x 50 MB, written by kernel 1, read and rewritten by kernel 2, read by
// kernel 3, and dB / dC per head 2 x 50 MB written and read -- ~0.6 GB,
// ~0.17 ms at 3.35 TB/s less what L2 keeps. What holds it back next:
// kernel 3 (56 % of the call) is latency-bound -- fragments gathered by
// scalar shared-memory loads where ldmatrix would take one instruction for
// four 8 x 8 tiles, and the four row-block warps of a column half each read
// the same h / dH slice from L2; then the workspace bytes (the state walks
// could be fused into kernels 1 and 3 with a chunk-ordered handoff).
//
// Every launcher runs on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "mma_bf16.cuh"

namespace sb {
constexpr int Q = 64, THREADS = 128;  // kernel 1's threads
// the widest column block of a warp's product: kernel 1's, kernel 3's
constexpr int NCH = 64, NG = 32;
// kernel 3 splits every product's columns into this many halves, a group
// of 4 warps each: two at N >= 64, where the products are wide enough to
// feed 8 warps, one below (measured on the H100, PERF.md)
template <int N> __host__ __device__ constexpr int halves() { return N >= 64 ? 2 : 1; }
template <int N> constexpr int grad_threads = 128 * halves<N>();
constexpr int WALK = 128, WB = 16;  // threads a block of the state walks;
                                    // chunks a thread loads at once
// a tile's row stride in elements: 8 more than its width (16-byte rows,
// and pair loads from neighbouring rows fall in distinct banks)
template <int W> __host__ __device__ constexpr int ld() { return W + 8; }
template <typename T, int P, int N> __host__ __device__ constexpr size_t tiles_bytes()
{
    return (size_t)Q * ld<P>() * sizeof(T) + (size_t)2 * Q * ld<N>() * sizeof(T)
           + (size_t)Q * ld<P>() * 4;
}
// kernel 1: x, B, C, dy and 4 Q-vectors of floats; kernel 3 also G o L
// and W o L, 20 Q-vectors and 8 floats
template <typename T, int P, int N> __host__ __device__ constexpr size_t smem_chunk()
{
    return tiles_bytes<T, P, N>() + (size_t)4 * Q * 4;
}
template <typename T, int P, int N> __host__ __device__ constexpr size_t smem_grad()
{
    return tiles_bytes<T, P, N>() + (size_t)2 * Q * ld<Q>() * 4 + (size_t)20 * Q * 4
           + 8 * 4;
}
}  // namespace sb

__device__ __forceinline__ float sb_f(float v) { return v; }
__device__ __forceinline__ float sb_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T sb_to(float v);
template <> __device__ __forceinline__ float sb_to<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 sb_to<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// (p[0], p[1]) as floats; p 8-byte (float) / 4-byte (bf16) aligned
__device__ __forceinline__ float2 sb_pair(const float* p)
{
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 sb_pair(const __nv_bfloat16* p)
{
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// (p[0], p[stride]) as floats
template <typename T>
__device__ __forceinline__ float2 sb_pair(const T* p, int stride)
{
    return make_float2(sb_f(p[0]), sb_f(p[stride]));
}

// rows [c0, c0 + Q) of a (B, S, ., W) tensor's slice starting at src (row
// stride s_seq elements) into a Q x ld<W>() tile; rows past S are zeros.
// 16-byte vectors where the slice allows them, else element by element.
template <typename T, int W, int NT>
__device__ __forceinline__ void sb_rows(T* dst, const T* __restrict__ src, int64_t s_seq,
                                        int c0, int S)
{
    using namespace sb;
    constexpr int V = 16 / (int)sizeof(T), VR = W / V, LD = ld<W>();
    static_assert(W % V == 0, "a row must be whole 16-byte vectors");
    const bool vec = ((reinterpret_cast<uintptr_t>(src) & 15) == 0)
                     && ((s_seq * (int64_t)sizeof(T)) % 16 == 0);
    if (vec) {
        for (int i = threadIdx.x; i < Q * VR; i += NT) {
            const int r = i / VR, v = i % VR, s = c0 + r;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (s < S) val = *reinterpret_cast<const uint4*>(src + (int64_t)s * s_seq + v * V);
            *reinterpret_cast<uint4*>(dst + r * LD + v * V) = val;
        }
    } else {
        for (int i = threadIdx.x; i < Q * W; i += NT) {
            const int r = i / W, c = i % W, s = c0 + r;
            dst[r * LD + c] = s < S ? src[(int64_t)s * s_seq + c] : sb_to<T>(0.f);
        }
    }
}

// ---- a warp's product: acc (16 rows x NC columns) += A . B --------------
//
// fa(r, k) gives (A[r][k], A[r][k+1]) for r in [0, 16) of the warp's rows;
// fb(k, c) gives (B[k][c], B[k+1][c]) for c in [0, NC). k runs over
// [k0, k1) (multiples of 16); column blocks j >= nt_end (columns 8 j ..
// 8 j + 7) are skipped -- they are known to be zero or unused.
// visit(f) calls f(lr, r, c, v) for every element this lane holds: lr its
// local row index (< LR), r the row in the warp's 16, c the column;
// visit2 the same over two accumulators of one shape.
// row_sum(v) adds v over the lanes holding the same rows, in a fixed
// butterfly (every such lane gets the same bits); col_sum(v) the same over
// the lanes holding the same columns, a lane's column c in its slot(c).

// the tensor cores: lane 4 g + t holds rows g (lr 0) and g + 8 (lr 1),
// columns 8 j + 2 t, + 1
struct MmaEng {
    static constexpr int LR = 2;
    template <int NC> struct Acc { float c[NC / 8][4]; };

    template <int NC> __device__ __forceinline__ static void zero(Acc<NC>& a)
    {
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) a.c[j][e] = 0.f;
    }

    // v as bf16 hi and (with SPLIT) lo = v - hi
    template <bool SPLIT>
    __device__ __forceinline__ static void split(float2 v, uint32_t& hi, uint32_t& lo)
    {
        hi = pack_bf16x2(v.x, v.y);
        if constexpr (SPLIT) {
            const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
            const float2 hf = __bfloat1622float2(h);
            lo = pack_bf16x2(v.x - hf.x, v.y - hf.y);
        }
    }

    template <bool SA, bool SB, int NC, class FA, class FB>
    __device__ __forceinline__ static void run(Acc<NC>& acc, int k0, int k1, int nt_end,
                                               FA fa, FB fb)
    {
        const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
        for (int k = k0; k < k1; k += 16) {
            uint32_t ah[4], al[4];
            split<SA>(fa(g, k + 2 * t), ah[0], al[0]);
            split<SA>(fa(g + 8, k + 2 * t), ah[1], al[1]);
            split<SA>(fa(g, k + 2 * t + 8), ah[2], al[2]);
            split<SA>(fa(g + 8, k + 2 * t + 8), ah[3], al[3]);
#pragma unroll
            for (int j = 0; j < NC / 8; ++j) {
                if (j < nt_end) {
                    uint32_t bh[2], bl[2];
                    split<SB>(fb(k + 2 * t, 8 * j + g), bh[0], bl[0]);
                    split<SB>(fb(k + 2 * t + 8, 8 * j + g), bh[1], bl[1]);
                    mma_bf16(acc.c[j], ah, bh);
                    if constexpr (SB) mma_bf16(acc.c[j], ah, bl);
                    if constexpr (SA) mma_bf16(acc.c[j], al, bh);
                }
            }
        }
    }

    template <int NC, class F> __device__ __forceinline__ static void visit(Acc<NC>& a, F f)
    {
        const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
            f(0, g, 8 * j + 2 * t, a.c[j][0]);
            f(0, g, 8 * j + 2 * t + 1, a.c[j][1]);
            f(1, g + 8, 8 * j + 2 * t, a.c[j][2]);
            f(1, g + 8, 8 * j + 2 * t + 1, a.c[j][3]);
        }
    }

    // the same over two accumulators of one shape: f(lr, r, c, va, vb)
    template <int NC, class F>
    __device__ __forceinline__ static void visit2(Acc<NC>& a, Acc<NC>& b, F f)
    {
        const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                f(e >> 1, g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1), a.c[j][e], b.c[j][e]);
    }

    __device__ __forceinline__ static int row(int lr) { return ((threadIdx.x & 31) >> 2) + 8 * lr; }
    __device__ __forceinline__ static bool row_leader() { return (threadIdx.x & 3) == 0; }
    __device__ __forceinline__ static float row_sum(float v)
    {
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        return v;
    }

    // column slots: a lane holds NC / 4 columns, slot 2 j + e for column
    // 8 j + 2 t + e
    template <int NC> __host__ __device__ static constexpr int slots() { return NC / 4; }
    __device__ __forceinline__ static int slot(int c) { return (c >> 3) * 2 + (c & 1); }
    __device__ __forceinline__ static int slot_col(int k)
    {
        return 8 * (k >> 1) + 2 * (threadIdx.x & 3) + (k & 1);
    }
    __device__ __forceinline__ static bool col_leader() { return (threadIdx.x & 31) < 4; }
    __device__ __forceinline__ static float col_sum(float v)
    {
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        return v;
    }
};

// the CUDA cores, float32: lane 8 rg + cg holds rows 4 rg .. 4 rg + 3 (lr
// 0..3), columns 8 j + cg
struct CoreEng {
    static constexpr int LR = 4;
    template <int NC> struct Acc { float c[4][NC / 8]; };

    template <int NC> __device__ __forceinline__ static void zero(Acc<NC>& a)
    {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NC / 8; ++j) a.c[i][j] = 0.f;
    }

    template <bool SA, bool SB, int NC, class FA, class FB>
    __device__ __forceinline__ static void run(Acc<NC>& acc, int k0, int k1, int nt_end,
                                               FA fa, FB fb)
    {
        const int lane = threadIdx.x & 31, rg = lane >> 3, cg = lane & 7;
        for (int k = k0; k < k1; k += 2) {
            float2 a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = fa(4 * rg + i, k);
#pragma unroll
            for (int j = 0; j < NC / 8; ++j) {
                if (j < nt_end) {
                    const float2 b = fb(k, 8 * j + cg);
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc.c[i][j] = fmaf(a[i].y, b.y, fmaf(a[i].x, b.x, acc.c[i][j]));
                }
            }
        }
    }

    template <int NC, class F> __device__ __forceinline__ static void visit(Acc<NC>& a, F f)
    {
        const int lane = threadIdx.x & 31, rg = lane >> 3, cg = lane & 7;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NC / 8; ++j) f(i, 4 * rg + i, 8 * j + cg, a.c[i][j]);
    }

    template <int NC, class F>
    __device__ __forceinline__ static void visit2(Acc<NC>& a, Acc<NC>& b, F f)
    {
        const int lane = threadIdx.x & 31, rg = lane >> 3, cg = lane & 7;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NC / 8; ++j)
                f(i, 4 * rg + i, 8 * j + cg, a.c[i][j], b.c[i][j]);
    }

    __device__ __forceinline__ static int row(int lr) { return 4 * ((threadIdx.x & 31) >> 3) + lr; }
    __device__ __forceinline__ static bool row_leader() { return (threadIdx.x & 7) == 0; }
    __device__ __forceinline__ static float row_sum(float v)
    {
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        return v;
    }

    // column slots: a lane holds NC / 8 columns, slot j for column 8 j + cg
    template <int NC> __host__ __device__ static constexpr int slots() { return NC / 8; }
    __device__ __forceinline__ static int slot(int c) { return c >> 3; }
    __device__ __forceinline__ static int slot_col(int k) { return 8 * k + (threadIdx.x & 7); }
    __device__ __forceinline__ static bool col_leader() { return (threadIdx.x & 31) < 8; }
    __device__ __forceinline__ static float col_sum(float v)
    {
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        return v;
    }
};

template <typename T>
using sb_eng = std::conditional_t<std::is_same<T, __nv_bfloat16>::value, MmaEng, CoreEng>;

// a fixed butterfly over the warp: every lane gets the same bits
__device__ __forceinline__ float sb_warp_sum(float v)
{
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

struct SbArgs {
    const void* x; const float* dt; const float* A; const void* Bm; const void* Cm;
    const float* dy; const float* dstate; void* dx; float* ddt; float* dA;
    void* dB; void* dC; float* dB_ws; float* dC_ws; float* sws; float* dws;
    float* cumws; float* daws;
    int Bz, S, H, G, nc;
    int64_t xsb, xss, xsh, dsb, dss, dsh, asb, ash, bsb, bss, bsg, csb, css, csg;
};

// the chunk's tiles and its dt into shared memory (kernels 1 and 3), by NT
// threads
template <typename T, int P, int N, int NT>
__device__ __forceinline__ void sb_load_chunk(const SbArgs& a, T* Xs, T* Bs, T* Cs,
                                              float* DYs, float* dtv, int b, int h,
                                              int c0)
{
    const int g = h / (a.H / a.G);
    sb_rows<T, P, NT>(Xs, (const T*)a.x + (int64_t)b * a.xsb + (int64_t)h * a.xsh, a.xss, c0, a.S);
    sb_rows<T, N, NT>(Bs, (const T*)a.Bm + (int64_t)b * a.bsb + (int64_t)g * a.bsg, a.bss, c0, a.S);
    sb_rows<T, N, NT>(Cs, (const T*)a.Cm + (int64_t)b * a.csb + (int64_t)g * a.csg, a.css, c0, a.S);
    sb_rows<float, P, NT>(DYs, a.dy + ((int64_t)b * a.S * a.H + h) * P, (int64_t)a.H * P, c0, a.S);
    if (threadIdx.x < sb::Q) {
        const int s = c0 + threadIdx.x;
        dtv[threadIdx.x] = s < a.S ? a.dt[(int64_t)b * a.dsb + (int64_t)s * a.dss
                                          + (int64_t)h * a.dsh] : 0.f;
    }
}

// ---- kernel 1: the in-chunk cumsum, s_c and d_c ---------------------------
template <typename T, int P, int N>
__global__ void __launch_bounds__(sb::THREADS, 2)
ssd_bwd_chunk_kernel(const SbArgs a)
{
    using namespace sb;
    using Eng = sb_eng<T>;
    constexpr int LP = ld<P>(), LN = ld<N>();
    constexpr int NC = (N < NCH ? N : NCH), RT = P / 16, CT = N / NC;
    extern __shared__ __align__(16) unsigned char sb_smem[];
    T* Xs = reinterpret_cast<T*>(sb_smem);
    T* Bs = Xs + Q * LP;
    T* Cs = Bs + Q * LN;
    float* DYs = reinterpret_cast<float*>(Cs + Q * LN);
    float* dtv = DYs + Q * LP;
    float* cum = dtv + Q;
    float* wv = cum + Q;    // exp(e - cum_s) dt_s
    float* ecum = wv + Q;   // exp(cum_t)

    const int tid = threadIdx.x, c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int c0 = c * Q;
    const float Ah = a.A[(int64_t)b * a.asb + (int64_t)h * a.ash];
    sb_load_chunk<T, P, N, THREADS>(a, Xs, Bs, Cs, DYs, dtv, b, h, c0);
    __syncthreads();
    // sequential in float32, each product rounded before its add (no
    // contraction into an FMA), as the plain version's torch.cumsum of
    // dt * A rounds it
    if (tid == 0) {
        float run = 0.f;
        for (int s0 = 0; s0 < Q; s0 += 8) {
            float d[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) d[i] = dtv[s0 + i];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                run = __fadd_rn(run, __fmul_rn(d[i], Ah));
                cum[s0 + i] = run;
            }
        }
    }
    __syncthreads();
    if (tid < Q) {
        a.cumws[((int64_t)b * a.H + h) * a.nc * Q + c0 + tid] = cum[tid];
        wv[tid] = expf(cum[Q - 1] - cum[tid]) * dtv[tid];
        ecum[tid] = expf(cum[tid]);
    }
    __syncthreads();

    const int64_t ws = (((int64_t)b * a.H + h) * a.nc + c) * (int64_t)(P * N);
    const int w = tid >> 5;
    // s_c[p][n] = sum_s (x o wv)[s][p] B[s][n]; d_c[p][n] = sum_t
    // (dy o ecum)[t][p] C[t][n]: tiles of 16 rows p x NC columns n
    for (int tile = w; tile < 2 * RT * CT; tile += THREADS / 32) {
        const bool is_d = tile >= RT * CT;
        const int tt = is_d ? tile - RT * CT : tile;
        const int p0 = 16 * (tt % RT), n0 = NC * (tt / RT);
        typename Eng::template Acc<NC> acc;
        Eng::zero(acc);
        if (!is_d) {
            Eng::template run<true, false, NC>(
                acc, 0, Q, NC / 8,
                [&](int r, int k) {
                    const float2 v = sb_pair(Xs + k * LP + p0 + r, LP);
                    return make_float2(v.x * wv[k], v.y * wv[k + 1]);
                },
                [&](int k, int cc) { return sb_pair(Bs + k * LN + n0 + cc, LN); });
        } else {
            Eng::template run<true, false, NC>(
                acc, 0, Q, NC / 8,
                [&](int r, int k) {
                    const float2 v = sb_pair(DYs + k * LP + p0 + r, LP);
                    return make_float2(v.x * ecum[k], v.y * ecum[k + 1]);
                },
                [&](int k, int cc) { return sb_pair(Cs + k * LN + n0 + cc, LN); });
        }
        float* out = (is_d ? a.dws : a.sws) + ws;
        Eng::visit(acc, [&](int, int r, int cc, float v) {
            out[(p0 + r) * N + n0 + cc] = v;
        });
    }
}

// ---- kernel 2: the state walks, a thread an element of P x N and one
// direction: blocks [0, nb) walk h forward, [nb, 2 nb) dH in reverse ------
__global__ void __launch_bounds__(sb::WALK)
ssd_bwd_walk_kernel(float* __restrict__ sws, float* __restrict__ dws,
                    const float* __restrict__ cumws, const float* __restrict__ dstate,
                    int nc, int H, int PN)
{
    using namespace sb;
    const int nb = (PN + WALK - 1) / WALK;
    const bool rev = (int)blockIdx.x >= nb;
    const int e = (rev ? blockIdx.x - nb : blockIdx.x) * WALK + threadIdx.x;
    if (e >= PN) return;
    const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
    float* v = (rev ? dws : sws) + bh * nc * PN + e;
    const float* cum = cumws + bh * nc * Q + (Q - 1);
    float run = rev && dstate != nullptr ? dstate[bh * PN + e] : 0.f;
    // WB chunks' s_c (d_c) loaded before any is overwritten: the loads of a
    // batch are in flight together, and only the fmas chain
    for (int i0 = 0; i0 < nc; i0 += WB) {
        float buf[WB];
#pragma unroll
        for (int j = 0; j < WB; ++j) {
            const int i = i0 + j, c = rev ? nc - 1 - i : i;
            if (i < nc) buf[j] = v[(int64_t)c * PN];
        }
#pragma unroll
        for (int j = 0; j < WB; ++j) {
            const int i = i0 + j, c = rev ? nc - 1 - i : i;
            if (i < nc) {
                v[(int64_t)c * PN] = run;
                run = fmaf(expf(cum[c * Q]), run, buf[j]);
            }
        }
    }
}

// ---- kernel 3: the chunk's gradients ---------------------------------------
// 128 threads a column half: warp w owns rows 16 (w % 4) .. + 15 and half
// w / 4 of every product's columns; a row sum adds its halves' partials,
// half 0 first.
template <typename T, int P, int N>
__global__ void __launch_bounds__(sb::grad_threads<N>, 2)
ssd_bwd_grad_kernel(const SbArgs a)
{
    using namespace sb;
    using Eng = sb_eng<T>;
    constexpr int HV = halves<N>(), NT = grad_threads<N>, NW = NT / 32;
    constexpr int LP = ld<P>(), LN = ld<N>(), LQ = ld<Q>();
    constexpr int QH = Q / HV, PH = P / HV, NH = N / HV, LR = Eng::LR;
    constexpr int NC = (NH < NG ? NH : NG);  // dC / dB columns a pass
    using Acc = typename Eng::template Acc<NC>;
    using AccQ = typename Eng::template Acc<QH>;
    using AccP = typename Eng::template Acc<PH>;
    extern __shared__ __align__(16) unsigned char sb_smem[];
    T* Xs = reinterpret_cast<T*>(sb_smem);
    T* Bs = Xs + Q * LP;
    T* Cs = Bs + Q * LN;
    float* DYs = reinterpret_cast<float*>(Cs + Q * LN);
    float* GL = DYs + Q * LP;    // (G o L)[t][s], s <= t, else 0
    float* Ms = GL + Q * LQ;     // (W o L)[t][s] dt_s, s <= t, else 0
    float* dtv = Ms + Q * LQ;    // Q-vectors
    float* cum = dtv + Q;
    float* ecum = cum + Q;       // exp(cum_t)
    float* eend = ecum + Q;      // exp(e - cum_s)
    float* rowp = eend + Q;      // per half: sum_s R[t][s]
    float* colp = rowp + 2 * Q;  // per row block: sum_t R[t][s]
    float* ceh = colp + 4 * Q;   // per half: C_t.(h^T dy_t)
    float* zh = ceh + 2 * Q;     // per half: x_s.(dH B_s)
    float* xh = zh + 2 * Q;      // per half: x_s.du_s
    float* zv = xh + 2 * Q;
    float* xdu = zv + Q;
    float* dcum = xdu + Q;
    float* runv = dcum + Q;      // the reverse cumsum of dcum
    float* red = runv + Q;       // NW floats: <dH, h> per warp

    const int tid = threadIdx.x, c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int c0 = c * Q, w = tid >> 5, r0 = 16 * (w % 4), half = HV == 1 ? 0 : w / 4;
    const float Ah = a.A[(int64_t)b * a.asb + (int64_t)h * a.ash];
    const int64_t ws = (((int64_t)b * a.H + h) * a.nc + c) * (int64_t)(P * N);
    const float* __restrict__ hc = a.sws + ws;   // h_c
    const float* __restrict__ dHc = a.dws + ws;  // dH_c
    // h_c and dH_c on their way to L2 while the tiles load, 128-byte lines
    for (int i = 32 * tid; i < P * N; i += 32 * NT) {
        prefetch_l2(hc + i);
        prefetch_l2(dHc + i);
    }
    sb_load_chunk<T, P, N, NT>(a, Xs, Bs, Cs, DYs, dtv, b, h, c0);
    if (tid < Q) cum[tid] = a.cumws[((int64_t)b * a.H + h) * a.nc * Q + c0 + tid];
    __syncthreads();
    if (tid < Q) {
        ecum[tid] = expf(cum[tid]);
        eend[tid] = expf(cum[Q - 1] - cum[tid]);
    }

    // G = C B^T and W = dy x^T on the causal half of the warp's rows and
    // columns [s0, s0 + QH) (columns from lim on are zeros, and no later
    // product reads them). G goes to GL masked to s <= t, each element by
    // the lane that reads it back below; W's epilogue writes W o L dt, turns
    // G into G o L in place, and takes R = G o W o L dt's partial row and
    // column sums, each in a fixed order
    {
        const int lim = r0 + 16, s0 = QH * half;
        const int nt = (lim - s0) / 8 < 0 ? 0 : (lim - s0) / 8 > QH / 8 ? QH / 8 : (lim - s0) / 8;
        AccQ acc;
        Eng::zero(acc);
        if (nt > 0) {
            Eng::template run<false, false, QH>(
                acc, 0, N, nt,
                [&](int r, int k) { return sb_pair(Cs + (r0 + r) * LN + k); },
                [&](int k, int s) { return sb_pair(Bs + (s0 + s) * LN + k); });
            Eng::visit(acc, [&](int, int r, int sc, float v) {
                const int t = r0 + r, s = s0 + sc;
                if (s < lim) GL[t * LQ + s] = s <= t ? v : 0.f;
            });
            Eng::zero(acc);
            Eng::template run<true, false, QH>(
                acc, 0, P, nt,
                [&](int r, int k) { return sb_pair(DYs + (r0 + r) * LP + k); },
                [&](int k, int s) { return sb_pair(Xs + (s0 + s) * LP + k); });
        }
        constexpr int CS = Eng::template slots<QH>();
        float rp[LR], cp[CS];
#pragma unroll
        for (int i = 0; i < LR; ++i) rp[i] = 0.f;
#pragma unroll
        for (int k = 0; k < CS; ++k) cp[k] = 0.f;
        Eng::visit(acc, [&](int lr, int r, int sc, float v) {
            const int t = r0 + r, s = s0 + sc;
            if (s < lim) {
                float m = 0.f, rr = 0.f;
                if (s <= t) {
                    const float L = expf(cum[t] - cum[s]);
                    const float g = GL[t * LQ + s];
                    m = v * dtv[s] * L;
                    GL[t * LQ + s] = g * L;
                    rr = g * m;
                }
                Ms[t * LQ + s] = m;
                rp[lr] += rr;
                cp[Eng::slot(sc)] += rr;
            }
        });
        const int z0 = lim > s0 ? lim : s0, nz = s0 + QH - z0;
        for (int i = tid & 31; i < 16 * nz; i += 32)
            Ms[(r0 + i % 16) * LQ + z0 + i / 16] = 0.f;
#pragma unroll
        for (int i = 0; i < LR; ++i) {
            const float v = Eng::row_sum(rp[i]);
            if (Eng::row_leader()) rowp[half * Q + r0 + Eng::row(i)] = v;
        }
#pragma unroll
        for (int k = 0; k < CS; ++k) {
            const float v = Eng::col_sum(cp[k]);
            if (Eng::col_leader()) colp[(w % 4) * Q + s0 + Eng::slot_col(k)] = v;
        }
    }
    __syncthreads();

    float part[LR];
    // dC[t] = (W o L dt) B + exp(cum_t) h^T dy_t, and C_t.(h^T dy_t)
#pragma unroll
    for (int i = 0; i < LR; ++i) part[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NH / NC; ++j) {
        const int n0 = NH * half + NC * j;
        Acc mb, hy;
        Eng::zero(mb);
        Eng::zero(hy);
        Eng::template run<true, false, NC>(
            mb, 0, r0 + 16, NC / 8,
            [&](int r, int k) { return sb_pair(Ms + (r0 + r) * LQ + k); },
            [&](int k, int n) { return sb_pair(Bs + k * LN + n0 + n, LN); });
        Eng::template run<true, true, NC>(
            hy, 0, P, NC / 8,
            [&](int r, int k) { return sb_pair(DYs + (r0 + r) * LP + k); },
            [&](int k, int n) { return sb_pair(hc + k * N + n0 + n, N); });
        Eng::visit2(mb, hy, [&](int lr, int r, int n, float v, float yv) {
            const int t = r0 + r;
            part[lr] = fmaf(sb_f(Cs[t * LN + n0 + n]), yv, part[lr]);
            if (c0 + t < a.S)
                a.dC_ws[(((int64_t)b * a.S + c0 + t) * a.H + h) * N + n0 + n] =
                    fmaf(ecum[t], yv, v);
        });
    }
#pragma unroll
    for (int i = 0; i < LR; ++i) {
        const float v = Eng::row_sum(part[i]);
        if (Eng::row_leader()) ceh[half * Q + r0 + Eng::row(i)] = v;
    }

    // dB[s] = (W o L dt)^T C + exp(e - cum_s) dt_s dH^T x_s
#pragma unroll
    for (int j = 0; j < NH / NC; ++j) {
        const int n0 = NH * half + NC * j;
        Acc mc, kx;
        Eng::zero(mc);
        Eng::zero(kx);
        Eng::template run<true, false, NC>(
            mc, r0, Q, NC / 8,
            [&](int r, int k) { return sb_pair(Ms + k * LQ + r0 + r, LQ); },
            [&](int k, int n) { return sb_pair(Cs + k * LN + n0 + n, LN); });
        Eng::template run<false, true, NC>(
            kx, 0, P, NC / 8,
            [&](int r, int k) { return sb_pair(Xs + (r0 + r) * LP + k); },
            [&](int k, int n) { return sb_pair(dHc + k * N + n0 + n, N); });
        Eng::visit2(mc, kx, [&](int, int r, int n, float v, float kv) {
            const int s = r0 + r;
            if (c0 + s < a.S)
                a.dB_ws[(((int64_t)b * a.S + c0 + s) * a.H + h) * N + n0 + n] =
                    fmaf(eend[s] * dtv[s], kv, v);
        });
    }

    // du[s] = (G o L)^T dy + exp(e - cum_s) dH B_s on columns [p0, p0 + PH);
    // dx = dt du, x.du and x.(dH B_s)
    {
        const int p0 = PH * half;
        AccP gd, f;
        Eng::zero(gd);
        Eng::zero(f);
        Eng::template run<true, true, PH>(
            gd, r0, Q, PH / 8,
            [&](int r, int k) { return sb_pair(GL + k * LQ + r0 + r, LQ); },
            [&](int k, int p) { return sb_pair(DYs + k * LP + p0 + p, LP); });
        Eng::template run<false, true, PH>(
            f, 0, N, PH / 8,
            [&](int r, int k) { return sb_pair(Bs + (r0 + r) * LN + k); },
            [&](int k, int p) { return sb_pair(dHc + (p0 + p) * N + k); });
        float zp[LR], xp[LR];
#pragma unroll
        for (int i = 0; i < LR; ++i) { zp[i] = 0.f; xp[i] = 0.f; }
        T* dx = (T*)a.dx;
        Eng::visit2(gd, f, [&](int lr, int r, int p, float v, float fv) {
            const int s = r0 + r;
            p += p0;
            const float du = fmaf(eend[s], fv, v);
            const float xv = sb_f(Xs[s * LP + p]);
            zp[lr] = fmaf(xv, fv, zp[lr]);
            xp[lr] = fmaf(xv, du, xp[lr]);
            if (c0 + s < a.S)
                dx[(((int64_t)b * a.S + c0 + s) * a.H + h) * P + p] = sb_to<T>(dtv[s] * du);
        });
#pragma unroll
        for (int i = 0; i < LR; ++i) {
            const float z = Eng::row_sum(zp[i]), xd = Eng::row_sum(xp[i]);
            if (Eng::row_leader()) {
                zh[half * Q + r0 + Eng::row(i)] = z;
                xh[half * Q + r0 + Eng::row(i)] = xd;
            }
        }
    }

    // <dH_c, h_c>: each thread its strided entries, then the warps in order
    {
        float acc = 0.f;
        for (int i = tid; i < P * N; i += NT) acc = fmaf(dHc[i], hc[i], acc);
        acc = sb_warp_sum(acc);
        if ((tid & 31) == 0) red[w] = acc;
    }
    __syncthreads();
    if (tid < Q) {
        const int s = tid;
        float zs = zh[s], xd = xh[s], ce = ceh[s], rr = rowp[s];
        if (HV == 2) {
            zs += zh[Q + s];
            xd += xh[Q + s];
            ce += ceh[Q + s];
            rr += rowp[Q + s];
        }
        const float cl = ((colp[s] + colp[Q + s]) + colp[2 * Q + s]) + colp[3 * Q + s];
        const float z = eend[s] * dtv[s] * zs;
        zv[s] = z;
        xdu[s] = xd;
        dcum[s] = rr - cl + ecum[s] * ce - z;
    }
    __syncthreads();
    // the chunk's end (sum_s z_s by a fixed tree of shuffles in warp 0) and
    // the in-chunk reverse cumsum: one thread, in order
    if (w == 0) {
        const float zsum = sb_warp_sum(zv[tid] + zv[tid + 32]);
        if (tid == 0) {
            float hd = 0.f;
            for (int k = 0; k < NW; ++k) hd += red[k];
            dcum[Q - 1] += zsum + expf(cum[Q - 1]) * hd;
            float run = 0.f, da = 0.f;
            for (int s0 = Q - 8; s0 >= 0; s0 -= 8) {
                float d[8], t[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) { d[i] = dcum[s0 + i]; t[i] = dtv[s0 + i]; }
#pragma unroll
                for (int i = 7; i >= 0; --i) {
                    run += d[i];
                    runv[s0 + i] = run;
                    da = fmaf(t[i], run, da);
                }
            }
            a.daws[((int64_t)b * a.H + h) * a.nc + c] = da;
        }
    }
    __syncthreads();
    if (tid < Q && c0 + tid < a.S)
        a.ddt[((int64_t)b * a.S + c0 + tid) * a.H + h] = fmaf(Ah, runv[tid], xdu[tid]);
}

// ---- kernel 4: dB and dC over a group's heads in head order, dA over the
// chunks in chunk order -------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_group_kernel(const float* __restrict__ dB_ws, const float* __restrict__ dC_ws,
                     T* __restrict__ dB, T* __restrict__ dC,
                     const float* __restrict__ daws, float* __restrict__ dA, int64_t n,
                     int BH, int nc, int H, int G, int N)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;  // (b, s, g, n)
    if (i < BH) {
        float s = 0.f;
        for (int c = 0; c < nc; ++c) s += daws[i * nc + c];
        dA[i] = s;
    }
    if (i >= n) return;
    const int rep = H / G;
    const int nn = (int)(i % N);
    const int64_t bsg = i / N;
    const int g = (int)(bsg % G);
    const int64_t bs = bsg / G;
    const int64_t base = (bs * H + (int64_t)g * rep) * N + nn;
    float sB = 0.f, sC = 0.f;
    for (int k = 0; k < rep; ++k) {
        sB += dB_ws[base + (int64_t)k * N];
        sC += dC_ws[base + (int64_t)k * N];
    }
    dB[i] = sb_to<T>(sB);
    dC[i] = sb_to<T>(sC);
}

template <typename T, int P, int N>
static int ssd_bwd_run(const SbArgs& a, cudaStream_t stream)
{
    using namespace sb;
    const size_t sm1 = smem_chunk<T, P, N>(), sm3 = smem_grad<T, P, N>();
    cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, P, N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)sm1);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_bwd_grad_kernel<T, P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm3);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)a.nc, (unsigned)a.H, (unsigned)a.Bz);
    ssd_bwd_chunk_kernel<T, P, N><<<grid, THREADS, sm1, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int PN = P * N;
    const dim3 wgrid((unsigned)(2 * ((PN + WALK - 1) / WALK)), (unsigned)a.H,
                     (unsigned)a.Bz);
    ssd_bwd_walk_kernel<<<wgrid, WALK, 0, stream>>>(a.sws, a.dws, a.cumws, a.dstate, a.nc,
                                                    a.H, PN);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_grad_kernel<T, P, N><<<grid, grad_threads<N>, sm3, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t n = (int64_t)a.Bz * a.S * a.G * N, BH = (int64_t)a.Bz * a.H;
    const int64_t m = n > BH ? n : BH;
    ssd_bwd_group_kernel<T><<<(unsigned)((m + 255) / 256), 256, 0, stream>>>(
        a.dB_ws, a.dC_ws, (T*)a.dB, (T*)a.dC, a.daws, a.dA, n, (int)BH, a.nc, a.H, a.G, N);
    return (int)cudaGetLastError();
}

template <typename T, int P>
static int ssd_bwd_n(int N, const SbArgs& a, cudaStream_t st)
{
    switch (N) {
    case 16:  return ssd_bwd_run<T, P, 16>(a, st);
    case 32:  return ssd_bwd_run<T, P, 32>(a, st);
    case 64:  return ssd_bwd_run<T, P, 64>(a, st);
    case 128: return ssd_bwd_run<T, P, 128>(a, st);
    default:  return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
static int ssd_bwd_dispatch(int P, int N, const SbArgs& a, cudaStream_t st)
{
    switch (P) {
    case 16: return ssd_bwd_n<T, 16>(N, a, st);
    case 32: return ssd_bwd_n<T, 32>(N, a, st);
    case 64: return ssd_bwd_n<T, 64>(N, a, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

// is_bf16: 1 for bf16 x / B / C (and dx / dB / dC), 0 for float32. Strides
// in elements: xs, dts {batch, seq, head}; as {batch, head}; bs, cs {batch,
// seq, group}. dstate may be null. Float32 workspaces, each written before
// it is read: dB_ws, dC_ws (B, S, H, N); sws, dws (B, H, ceil(S / 64), P,
// N); cumws (B, H, ceil(S / 64) * 64); daws (B, H, ceil(S / 64)).
extern "C" int ssd_scan_bwd_launch(
    int is_bf16, const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* dy, const float* dstate, void* dx, float* ddt, float* dA,
    void* dB, void* dC, float* dB_ws, float* dC_ws, float* sws, float* dws, float* cumws,
    float* daws, int Bz, int S, int H, int G, int P, int N, const int64_t* xs,
    const int64_t* dts, const int64_t* as, const int64_t* bs, const int64_t* cs,
    void* stream)
{
    const SbArgs a{x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA, dB, dC, dB_ws, dC_ws, sws,
                   dws, cumws, daws, Bz, S, H, G, (S + sb::Q - 1) / sb::Q,
                   xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], as[0], as[1],
                   bs[0], bs[1], bs[2], cs[0], cs[1], cs[2]};
    if (is_bf16)
        return ssd_bwd_dispatch<__nv_bfloat16>(P, N, a, (cudaStream_t)stream);
    return ssd_bwd_dispatch<float>(P, N, a, (cudaStream_t)stream);
}
