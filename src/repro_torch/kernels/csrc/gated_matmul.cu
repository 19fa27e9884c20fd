// Gated matmul for NVIDIA Hopper (sm_90a): float32 or bf16 in, float32
// accumulation, output in x's type. Built by nvcc into a shared library with
// a plain C interface and loaded with ctypes (see ../_build.py). No
// -fmad=false here: the kernel promises agreement with its plain version
// within a stated tolerance, not the same bits.
//
// The launcher runs on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// B2  gated_matmul  ([M,K] x [K,N], all-zero weight tiles skipped)
//
// Replaces the Pallas TPU kernel src/repro/kernels/gated_matmul.py::_kernel
// (entry gated_matmul_p, wrapper ops.gated_matmul): the TPU-native analogue
// of the paper's spatial SA gating. A (K/bk, N/bn) int32 bitmap marks the
// weight tiles that hold a nonzero; a tile whose bit is 0 takes no MAC.
// The Pallas kernel predicates only the dot (its BlockSpecs still bring the
// x and w blocks into VMEM); here a zero bit also skips the loads of that
// x/w tile pair, so an N- or K-underutilized weight (paper Fig 10 cases 2
// and 3) costs neither the operations nor the bytes of its padded tiles.
//
// Bound: at the path's full width (x 8192 x 2048, w 2048 x 11008, bf16,
// 128-tiles) the live tiles need 2 M bk bn per (ki, ni) tile -- 369 GFLOP
// dense -- against 0.21 GB of x, live w and output: some 1 700 operations
// per byte, above the card's ~295, so the bound is the tensor cores'
// 989 TFLOP/s (bf16) or the CUDA cores' 67 TFLOP/s (float32), scaled by the
// share of live tiles.
//
// Design: one block of 256 threads per (bm, bn) output tile, blockIdx.x
// over the N tiles (neighbouring blocks share x rows in L2), blockIdx.y over
// the M tiles. The block walks the K tiles of bk rows in order; it reads
// bitmap[ki, ni] -- one address for all its threads, so the branch is
// uniform -- and on a 0 moves on without a load. On a 1, thread 0 adds one
// to the int64 counter tiles_run (integer adds commute: the count is exact
// and the same from run to run) and the block stages the tile pair through
// shared memory in sub-steps of KS rows of K, accumulating in float32
// registers. The output tile is written once, in x's type (bf16 rounded to
// nearest even); a block whose bits are all 0 writes zeros.
//   float32: true float32 FMAs on the CUDA cores (no TF32), each thread a
//     (bm/16) x (bn/16) block of the tile, float4 shared-memory reads.
//   bf16: mma.sync m16n8k16 bf16 x bf16 -> float32 on the tensor cores;
//     8 warps as 2 (M) x 4 (N), each a (bm/2) x (bn/4) warp tile, fragments
//     by ldmatrix (.trans for the row-major w tile), rows padded by 16 bytes
//     so the ldmatrix phases are free of bank conflicts.
// Loads are synchronous and single-buffered: simple and right first; a
// cp.async / TMA pipeline and wgmma are later work and are what would close
// the gap to the bound.
// ---------------------------------------------------------------------------
namespace gm {
constexpr int THREADS = 256;

__device__ __forceinline__ bool tile_live(const int* __restrict__ bitmap,
                                          int ki, int n_tiles_n, int ni,
                                          unsigned long long* tiles_run)
{
    if (bitmap[(long long)ki * n_tiles_n + ni] == 0) return false;
    if (threadIdx.x == 0) atomicAdd(tiles_run, 1ULL);
    return true;
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
gated_matmul_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const int* __restrict__ bitmap,
                        float* __restrict__ out,
                        unsigned long long* __restrict__ tiles_run,
                        int N, int K)
{
    constexpr int KS = 16;                     // K rows per staged step
    constexpr int TM = BM / 16, TN = BN / 16;  // outputs per thread
    constexpr int LDA = BM + 4;                // x sub-tile, stored [k][m]
    __shared__ __align__(16) float As[KS][LDA];
    __shared__ __align__(16) float Bs[KS][BN];

    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int ni = blockIdx.x, n_tiles_n = N / BN;
    const long long m0 = (long long)blockIdx.y * BM, n0 = (long long)ni * BN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int ki = 0; ki < K / BK; ++ki) {
        if (!tile_live(bitmap, ki, n_tiles_n, ni, tiles_run)) continue;
        for (int kk = 0; kk < BK; kk += KS) {
            const long long k0 = (long long)ki * BK + kk;
            for (int i = tid; i < BM * KS / 4; i += THREADS) {
                const int r = i / (KS / 4), c = (i % (KS / 4)) * 4;
                const float4 v = *reinterpret_cast<const float4*>(
                    x + (m0 + r) * K + k0 + c);
                As[c][r] = v.x;
                As[c + 1][r] = v.y;
                As[c + 2][r] = v.z;
                As[c + 3][r] = v.w;
            }
            for (int i = tid; i < KS * BN / 4; i += THREADS) {
                const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
                *reinterpret_cast<float4*>(&Bs[r][c]) =
                    *reinterpret_cast<const float4*>(w + (k0 + r) * N + n0 + c);
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < KS; ++k) {
                float a[TM], b[TN];
#pragma unroll
                for (int i = 0; i < TM; i += 4) {
                    const float4 v =
                        *reinterpret_cast<const float4*>(&As[k][ty * TM + i]);
                    a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
                }
#pragma unroll
                for (int j = 0; j < TN; j += 4) {
                    const float4 v =
                        *reinterpret_cast<const float4*>(&Bs[k][tx * TN + j]);
                    b[j] = v.x; b[j + 1] = v.y; b[j + 2] = v.z; b[j + 3] = v.w;
                }
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
            __syncthreads();
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        float* row = out + (m0 + ty * TM + i) * N + n0 + tx * TN;
#pragma unroll
        for (int j = 0; j < TN; j += 4)
            *reinterpret_cast<float4*>(row + j) =
                make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                            acc[i][j + 3]);
    }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p)
{
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p)
{
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), float32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
gated_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const int* __restrict__ bitmap,
                         __nv_bfloat16* __restrict__ out,
                         unsigned long long* __restrict__ tiles_run,
                         int N, int K)
{
    constexpr int KS = 32;                      // K rows per staged step
    constexpr int LDA = KS + 8, LDB = BN + 8;   // +16 bytes a row
    constexpr int WM = BM / 2, WN = BN / 4;     // warp tile
    constexpr int MI = WM / 16, NI = WN / 8;    // mma tiles per warp
    static_assert(NI % 2 == 0, "B fragments are loaded two n8 tiles at once");
    __shared__ __align__(16) __nv_bfloat16 As[BM][LDA];
    __shared__ __align__(16) __nv_bfloat16 Bs[KS][LDB];

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int wm = warp / 4, wn = warp % 4;
    const int ni = blockIdx.x, n_tiles_n = N / BN;
    const long long m0 = (long long)blockIdx.y * BM, n0 = (long long)ni * BN;
    float acc[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    for (int ki = 0; ki < K / BK; ++ki) {
        if (!tile_live(bitmap, ki, n_tiles_n, ni, tiles_run)) continue;
        for (int kk = 0; kk < BK; kk += KS) {
            const long long k0 = (long long)ki * BK + kk;
            for (int i = tid; i < BM * KS / 8; i += THREADS) {
                const int r = i / (KS / 8), c = (i % (KS / 8)) * 8;
                *reinterpret_cast<uint4*>(&As[r][c]) =
                    *reinterpret_cast<const uint4*>(x + (m0 + r) * K + k0 + c);
            }
            for (int i = tid; i < KS * BN / 8; i += THREADS) {
                const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
                *reinterpret_cast<uint4*>(&Bs[r][c]) =
                    *reinterpret_cast<const uint4*>(w + (k0 + r) * N + n0 + c);
            }
            __syncthreads();
#pragma unroll
            for (int ks = 0; ks < KS; ks += 16) {
                uint32_t a[MI][4], b[NI][2];
#pragma unroll
                for (int i = 0; i < MI; ++i)
                    ldmatrix_x4(a[i], &As[wm * WM + i * 16 + lane % 16]
                                         [ks + (lane / 16) * 8]);
#pragma unroll
                for (int j = 0; j < NI; j += 2) {
                    uint32_t r[4];
                    ldmatrix_x4_trans(r, &Bs[ks + lane % 16]
                                            [wn * WN + j * 8 + (lane / 16) * 8]);
                    b[j][0] = r[0]; b[j][1] = r[1];
                    b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
                }
#pragma unroll
                for (int i = 0; i < MI; ++i)
#pragma unroll
                    for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], b[j]);
            }
            __syncthreads();
        }
    }
    // accumulator (i, j): rows g and g + 8 of the 16, columns 2q and 2q + 1
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
            const long long r = m0 + wm * WM + i * 16 + g;
            const long long c = n0 + wn * WN + j * 8 + 2 * q;
            *reinterpret_cast<__nv_bfloat162*>(out + r * N + c) =
                __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
            *reinterpret_cast<__nv_bfloat162*>(out + (r + 8) * N + c) =
                __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
        }
}
}  // namespace gm

// bf16 != 0: x, w and out are bf16, else float32. M, N, K are multiples of
// bm, bn, bk (each 64 or 128); bitmap is (K/bk, N/bn) int32, row-major;
// tiles_run one int64 that receives +1 per executed (mi, ni, ki) tile.
extern "C" int gated_matmul_launch(
    int bf16, const void* x, const void* w, const int* bitmap, void* out,
    int64_t* tiles_run, int M, int N, int K, int bm, int bn, int bk,
    void* stream)
{
    const dim3 grid((unsigned)(N / bn), (unsigned)(M / bm));
    const cudaStream_t s = (cudaStream_t)stream;
    unsigned long long* cnt = reinterpret_cast<unsigned long long*>(tiles_run);
#define GM_CASE(BM_, BN_, BK_)                                                 \
    if (bm == BM_ && bn == BN_ && bk == BK_) {                                 \
        if (bf16)                                                              \
            gm::gated_matmul_bf16_kernel<BM_, BN_, BK_>                        \
                <<<grid, gm::THREADS, 0, s>>>(                                 \
                    (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, bitmap,  \
                    (__nv_bfloat16*)out, cnt, N, K);                           \
        else                                                                   \
            gm::gated_matmul_f32_kernel<BM_, BN_, BK_>                         \
                <<<grid, gm::THREADS, 0, s>>>(                                 \
                    (const float*)x, (const float*)w, bitmap, (float*)out,     \
                    cnt, N, K);                                                \
        return (int)cudaGetLastError();                                        \
    }
    GM_CASE(64, 64, 64)
    GM_CASE(64, 64, 128)
    GM_CASE(64, 128, 64)
    GM_CASE(64, 128, 128)
    GM_CASE(128, 64, 64)
    GM_CASE(128, 64, 128)
    GM_CASE(128, 128, 64)
    GM_CASE(128, 128, 128)
#undef GM_CASE
    return (int)cudaErrorInvalidValue;
}
