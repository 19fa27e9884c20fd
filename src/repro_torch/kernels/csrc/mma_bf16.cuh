// Tensor-core and asynchronous-copy building blocks shared by the bf16
// kernels (attention.cu, attention_bwd.cu, gated_matmul.cu, ssd_scan.cu,
// ssd_scan_bwd.cu): ldmatrix, mma.sync m16n8k16 bf16 -> float32, an L2
// prefetch, a named barrier, TMA tile loads into shared
// memory with their mbarriers, and the host call that encodes a TMA tensor
// map; the 1-D bulk copy of program_plane.cu's event ring; and the
// attention kernels' shared-memory tile layout (tile64). Nothing here
// launches or allocates; every PTX helper is one instruction issued by the
// calling thread (ldmatrix and mma by the whole warp).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for
// lane = 4 g + t:
//   A (16 x 16, row-major), 4 registers of 2 bf16 each:
//     a0 (row g,     cols 2t, 2t+1)   a1 (row g + 8, cols 2t, 2t+1)
//     a2 (row g,     cols 2t+8, +9)   a3 (row g + 8, cols 2t+8, +9)
//   B (16 x 8, "col": k contiguous per column n), 2 registers:
//     b0 (k 2t, 2t+1, col g)          b1 (k 2t+8, 2t+9, col g)
//   C/D (16 x 8, float32), 4 registers:
//     c0, c1 (row g, cols 2t, 2t+1)   c2, c3 (row g + 8, cols 2t, 2t+1)
// The C layout of two neighbouring n8 tiles, packed to bf16, is the A layout
// of a k16 step of the next product: attention's P.V reuses the scores'
// registers without a trip through shared memory.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i .. 8i+7 give the
// row addresses of matrix i, and register i of lane 4g + t receives row g,
// cols 2t, 2t+1 of matrix i (with .trans: row 2t and 2t+1, col g).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// two floats rounded to bf16 (nearest even), lo in the low half: one
// register of an A fragment
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi)
{
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// the 128-byte line at p on its way into L2 (no register, no wait)
__device__ __forceinline__ void prefetch_l2(const void* p)
{
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// a barrier of `threads` threads of the block (a multiple of 32: whole
// warps) on named barrier `id` (1..15; 0 is __syncthreads'), shared memory
// written before it visible to them after it
__device__ __forceinline__ void named_sync(int id, int threads)
{
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- Hopper's tensor memory accelerator (TMA) and its mbarriers ----------
//
// A TMA load copies a 2-D box of a tensor map (encoded on the host, passed
// as a __grid_constant__ kernel parameter) into shared memory and reports
// its bytes to an mbarrier; one thread issues it, no thread spends
// registers or instructions on the copy. With the 128-byte swizzle each box
// row is 128 bytes and its 16-byte chunk c lands at chunk c ^ (row % 8) of
// the row (the destination 1024-byte aligned), so the 8 rows of an
// ldmatrix phase hit 32 distinct banks: sw128() is that address.

__device__ __forceinline__ int sw128(int row, int chunk)
{
    return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// the initialised barriers, visible to the TMA unit (the async proxy)
__device__ __forceinline__ void mbar_fence_init()
{
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival, announcing `bytes` more to come by TMA
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity)
{
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "MBAR_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra MBAR_WAIT;\n"
        "}\n"
        :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` contiguous bytes from device memory into shared memory by the
// TMA unit, with no tensor map; they complete on bar. Source, destination
// and size must be multiples of 16 bytes.
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src,
                                             unsigned bytes, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// box (c0, c1) -- c0 the inner (contiguous) coordinate -- of the tensor map
// at `map` into shared memory at dst; its bytes complete on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            int c0, int c1, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1),
           "r"(smem_addr(bar))
        : "memory");
}

// the same for a 4-D tensor map, coordinates innermost first
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, int c0,
                                            int c1, int c2, int c3,
                                            uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
           "r"(smem_addr(bar))
        : "memory");
}

// ---- a tile of 64 rows x D bf16 in shared memory, as TMA lands it -------
//
// The attention kernels' q / k / v / do tiles (attention.cu, B3;
// attention_bwd.cu, B9): ceil(D / 64) boxes of 64 rows x 64 columns of a
// 4-D (D, heads, S, B) tensor map, 128 bytes a row (columns past D and rows
// past the sequence zero-filled: at D = 80 the second box holds columns
// 64..79 and zeros), 128-byte swizzle.
namespace tile64 {
template <int D> __host__ __device__ constexpr int boxes() { return (D + 63) / 64; }
template <int D> __host__ __device__ constexpr int tile_bytes() { return boxes<D>() * 64 * 128; }

// the 16 bytes at (row, col) of a tile, col a multiple of 8
__device__ __forceinline__ const unsigned char* at(const unsigned char* tile,
                                                   int row, int col)
{
    return tile + (col / 64) * (64 * 128) + sw128(row, (col % 64) / 8);
}

// rows [row0, row0 + 64) of head `head` of batch b, completing on bar
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          int head, int row0, int b, uint64_t* bar)
{
#pragma unroll
    for (int bx = 0; bx < boxes<D>(); ++bx)
        tma_load_4d(dst + bx * 64 * 128, map, bx * 64, head, row0, b, bar);
}
}  // namespace tile64

// Host: a bf16 tensor map of `rank` dims (sizes innermost first, strides in
// bytes of dims 1..rank-1), read in boxes whose inner dim is 64 elements
// (128 bytes; past the tensor's edge zero-filled), 128-byte swizzle.
// cuTensorMapEncodeTiled comes from the driver through the runtime, so the
// library does not link against libcuda. False if the driver refuses it.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static bool bf16_box_map(CUtensorMap* map, const void* base, int rank,
                         const cuuint64_t* dims, const cuuint64_t* strides,
                         const cuuint32_t* box)
{
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &q) != cudaSuccess
            || q != cudaDriverEntryPointSuccess)
            return false;
        fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
              const_cast<void*>(base), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
