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

#include "mma_bf16.cuh"

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
// Both routes: one block per (bm, bn) output tile, blockIdx.x over the N
// tiles (neighbouring blocks share x rows in L2), blockIdx.y over the M
// tiles; the block walks the K tiles of bk rows in order and a tile whose
// bit is 0 issues no load and no MAC. tiles_run, an int64 counter, receives
// one add per block of the number of live tiles it ran (integer adds
// commute: the count is exact and the same from run to run). The output
// tile is written once, in x's type (bf16 rounded to nearest even); a block
// whose bits are all 0 writes zeros.
//   float32 (gated_matmul_f32_kernel): true float32 FMAs on the CUDA cores
//     (no TF32), 256 threads, each a (bm/16) x (bn/16) block of the tile;
//     it reads bitmap[ki, ni] -- one address for all threads, a uniform
//     branch -- and stages a live tile pair through shared memory in
//     synchronous sub-steps of 16 rows of K, float4 shared-memory reads.
//   bf16 (gated_matmul_bf16_kernel): mma.sync m16n8k16 bf16 x bf16 ->
//     float32 on the tensor cores, fed by an asynchronous ring over the live
//     tiles only. At block start warp 0 compacts the block's bitmap column
//     bitmap[:, ni] into a list of live K tiles in shared memory (a ballot
//     per 32 tiles, in order). The loop then runs over sub-steps of 64 rows
//     of K of the listed tiles: a 3-stage ring of (x, w) sub-tiles, each
//     filled by Hopper's tensor memory accelerator (TMA: one thread issues
//     the 2-D box copies of a stage, which complete on the stage's mbarrier,
//     with the 128-byte swizzle so the ldmatrix phases are free of bank
//     conflicts), keeps the next two live sub-steps in flight under the
//     current products, with one __syncthreads per sub-step. 4 warps as
//     2 (M) x 2 (N), each a (bm/2) x (bn/2) warp tile -- 64 x 64 at the
//     128-tiles, a quarter of an ldmatrix per mma -- with A by ldmatrix and
//     the row-major w sub-tile by ldmatrix.trans. The ring (97 KB at the
//     128-tiles) is dynamic shared memory, two blocks to an SM. On the H100
//     a draft that filled the same ring by per-thread cp.async copies was
//     bound by the copies (it ran as slowly with its products removed);
//     with TMA the mma.sync and ldmatrix stream sets the pace.
// wgmma, which reads its B operand straight from shared memory, is what
// would close the rest of the gap to the bound.
// ---------------------------------------------------------------------------
namespace gm {
constexpr int THREADS = 256;                       // float32 route
constexpr int TC_THREADS = 128, TC_KS = 64, STAGES = 3;  // bf16 route

__device__ __forceinline__ bool tile_live(const int* __restrict__ bitmap,
                                          int ki, int n_tiles_n, int ni)
{
    return bitmap[(long long)ki * n_tiles_n + ni] != 0;
}

// the block's one add to the executed-tile count
__device__ __forceinline__ void count_tiles(unsigned long long* tiles_run,
                                            int n)
{
    if (n > 0) atomicAdd(tiles_run, (unsigned long long)n);
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

    int n_live = 0;
    for (int ki = 0; ki < K / BK; ++ki) {
        if (!tile_live(bitmap, ki, n_tiles_n, ni)) continue;
        ++n_live;
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
    if (tid == 0) count_tiles(tiles_run, n_live);
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

// bf16 route. A ring stage holds one sub-step of TC_KS = 64 rows of K: the
// x box (BM rows of 128 bytes) and the w box(es) (BN / 64 boxes of 64 rows
// of 128 bytes), all with the 128-byte swizzle.
template <int BM, int BN> __host__ __device__ constexpr int stage_bytes() {
    return (BM + BN) * 128;
}
template <int BM, int BN, int BK> constexpr size_t smem_bytes(int K) {
    // + 1024: the ring's start is rounded up to the swizzle's alignment
    return (size_t)STAGES * stage_bytes<BM, BN>() + 1024 + sizeof(int) * (size_t)(K / BK);
}

// thread 0 fills stage `step % STAGES` with live sub-step `step`: the x box
// (k0, m0) and the w boxes (n0 + 64 h, k0), their bytes announced first
template <int BM, int BN, int BK>
__device__ __forceinline__ void load_stage(unsigned char* ring, uint64_t* full,
                                           const int* live, int step,
                                           const CUtensorMap* tmx,
                                           const CUtensorMap* tmw, int m0, int n0)
{
    constexpr int SB = stage_bytes<BM, BN>();
    unsigned char* st = ring + (step % STAGES) * SB;
    uint64_t* bar = &full[step % STAGES];
    const int k0 = live[step / (BK / TC_KS)] * BK + (step % (BK / TC_KS)) * TC_KS;
    mbar_expect_tx(bar, SB);
    tma_load_2d(st, tmx, k0, m0, bar);
#pragma unroll
    for (int h = 0; h < BN / 64; ++h)
        tma_load_2d(st + BM * 128 + h * 64 * 128, tmw, n0 + h * 64, k0, bar);
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(TC_THREADS, 2)
gated_matmul_bf16_kernel(const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmw,
                         const int* __restrict__ bitmap,
                         __nv_bfloat16* __restrict__ out,
                         unsigned long long* __restrict__ tiles_run,
                         int N, int K)
{
    constexpr int WM = BM / 2, WN = BN / 2;     // warp tile: 2 (M) x 2 (N)
    constexpr int MI = WM / 16, NI = WN / 8;    // mma tiles per warp
    constexpr int SPT = BK / TC_KS;             // ring sub-steps per tile
    constexpr int SB = stage_bytes<BM, BN>();
    static_assert(NI % 2 == 0, "B fragments are loaded two n8 tiles at once");
    extern __shared__ __align__(16) unsigned char gm_smem[];
    unsigned char* ring = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(gm_smem) + 1023) & ~(uintptr_t)1023);
    int* live = reinterpret_cast<int*>(ring + STAGES * SB);  // K/BK ints
    __shared__ __align__(8) uint64_t full[STAGES];
    __shared__ int n_live;

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 2, wn = warp % 2;
    const int ni = blockIdx.x, n_tiles_n = N / BN, n_tiles_k = K / BK;
    const int m0 = blockIdx.y * BM, n0 = ni * BN;

    if (threadIdx.x == 32) {
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
        mbar_fence_init();
    }
    // the live K tiles of this column, in order: warp 0, 32 bits a ballot
    if (warp == 0) {
        int cnt = 0;
        for (int base = 0; base < n_tiles_k; base += 32) {
            const int ki = base + lane;
            const bool on = ki < n_tiles_k && tile_live(bitmap, ki, n_tiles_n, ni);
            const unsigned bal = __ballot_sync(0xffffffffu, on);
            if (on) live[cnt + __popc(bal & ((1u << lane) - 1u))] = ki;
            cnt += __popc(bal);
        }
        if (lane == 0) {
            n_live = cnt;
            count_tiles(tiles_run, cnt);
        }
    }
    __syncthreads();
    const int n_steps = n_live * SPT;

    float acc[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    if (threadIdx.x == 0)
        for (int s = 0; s < STAGES - 1 && s < n_steps; ++s)
            load_stage<BM, BN, BK>(ring, full, live, s, &tmx, &tmw, m0, n0);
    for (int step = 0; step < n_steps; ++step) {
        mbar_wait(&full[step % STAGES], (step / STAGES) & 1);
        // sub-step `step` has landed, and every warp is done with sub-step
        // step - 1, whose stage the next load overwrites
        __syncthreads();
        if (threadIdx.x == 0 && step + STAGES - 1 < n_steps)
            load_stage<BM, BN, BK>(ring, full, live, step + STAGES - 1, &tmx,
                                   &tmw, m0, n0);
        const unsigned char* As = ring + (step % STAGES) * SB;
        const unsigned char* Bs = As + BM * 128;
#pragma unroll
        for (int ks = 0; ks < TC_KS; ks += 16) {
            uint32_t a[MI][4], b[NI][2];
#pragma unroll
            for (int i = 0; i < MI; ++i)
                ldmatrix_x4(a[i], As + sw128(wm * WM + i * 16 + lane % 16,
                                             ks / 8 + lane / 16));
#pragma unroll
            for (int j = 0; j < NI; j += 2) {
                // n: this lane's 8 columns of the w sub-tile, in box n / 64
                const int n = wn * WN + j * 8 + (lane / 16) * 8;
                uint32_t r[4];
                ldmatrix_x4_trans(r, Bs + (n / 64) * 64 * 128
                                        + sw128(ks + lane % 16, (n % 64) / 8));
                b[j][0] = r[0]; b[j][1] = r[1];
                b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
            }
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
                for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], b[j]);
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

// a row-major bf16 matrix (rows x cols) read in boxes of box_rows x 64
// columns
static bool matrix_map(CUtensorMap* map, const void* base, int rows, int cols,
                       int box_rows)
{
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(__nv_bfloat16)};
    const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
    return bf16_box_map(map, base, 2, dims, strides, box);
}

template <int BM, int BN, int BK>
static int gated_matmul_bf16_run(const void* x, const void* w,
                                 const int* bitmap, void* out,
                                 unsigned long long* cnt, int M, int N, int K,
                                 cudaStream_t s)
{
    CUtensorMap tmx, tmw;
    if (!matrix_map(&tmx, x, M, K, BM) || !matrix_map(&tmw, w, K, N, TC_KS))
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes<BM, BN, BK>(K);
    const cudaError_t err = cudaFuncSetAttribute(
        gated_matmul_bf16_kernel<BM, BN, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(N / BN), (unsigned)(M / BM));
    gated_matmul_bf16_kernel<BM, BN, BK><<<grid, TC_THREADS, smem, s>>>(
        tmx, tmw, bitmap, (__nv_bfloat16*)out, cnt, N, K);
    return (int)cudaGetLastError();
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
            return gm::gated_matmul_bf16_run<BM_, BN_, BK_>(                   \
                x, w, bitmap, out, cnt, M, N, K, s);                           \
        gm::gated_matmul_f32_kernel<BM_, BN_, BK_>                             \
            <<<grid, gm::THREADS, 0, s>>>(                                     \
                (const float*)x, (const float*)w, bitmap, (float*)out, cnt,    \
                N, K);                                                         \
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
