// Power-plane kernels for NVIDIA Hopper (sm_90a): float64 / int64, built by
// nvcc into a shared library with a plain C interface and loaded with
// ctypes (see ../_build.py). Compile with -fmad=false: both kernels promise
// the same bits as their plain PyTorch versions, and a fused multiply-add
// rounds once where the plain version rounds twice.
//
// Every launcher runs on the stream it is given, allocates nothing, does
// not synchronise, and returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// K1  sa_occupancy
//
// Replaces the Pallas TPU kernel src/repro/kernels/sa_occupancy.py::_kernel
// (entry sa_occupancy_p): per matmul op (M, K, N) and systolic-array width
// saw, the closed-form ragged-tile PE occupancy of
// core/sa_gating.py::gating_stats_batch_xp ->
//   duration_cycles, frac_on, frac_w_on, frac_off, wake_events.
//
// Bound: 3 reads + 5 writes of 8 bytes per (width, op) element. At the
// sweep's real size (11 191 ops x 5 widths) that is 3.6 MB — a microsecond
// of HBM traffic — so the floor is the launch latency, not bandwidth or
// arithmetic. The design therefore spends nothing on tiling: one thread
// per (width, op) element, the op axis on grid x and the unique-width axis
// on grid y, so the whole (S, n) occupancy pass is ONE launch where the TPU
// version was vmapped per width and padded to 512-blocks. The ragged tail
// is masked, nothing is padded.
//
// Exactness: every intermediate (tile counts, PE-cycle totals) is an exact
// integer below 2^53 and the three divisions are IEEE fp64, evaluated in
// the operand order of the plain version, so the results equal it bit for
// bit.
// ---------------------------------------------------------------------------
__global__ void sa_occupancy_kernel(
    const double* __restrict__ mm_m, const double* __restrict__ mm_k,
    const double* __restrict__ mm_n, const double* __restrict__ saw_v,
    double wlc_raw, int64_t n, int64_t n_saw,
    double* __restrict__ dur_o, double* __restrict__ on_o,
    double* __restrict__ won_o, double* __restrict__ off_o,
    double* __restrict__ wake_o)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const double M = mm_m[i], K = mm_k[i], N = mm_n[i];
    for (int64_t s = blockIdx.y; s < n_saw; s += gridDim.y) {
        const double saw = saw_v[s];
        const double wlc = wlc_raw < 0.0 ? saw : wlc_raw;  // -1 -> saw
        const double kt = floor((K + saw - 1.0) / saw);
        const double nt = floor((N + saw - 1.0) / saw);
        const double k_last = K - (kt - 1.0) * saw;
        const double n_last = N - (nt - 1.0) * saw;
        const double cyc = (M + 2.0 * saw - 1.0) + wlc;
        const double on_per_live = fmin(M, cyc);
        const double won_per_live = fmax(0.0, cyc - M);
        const double live_total = ((kt - 1.0) * (nt - 1.0) * saw * saw
                                   + (kt - 1.0) * saw * n_last
                                   + (nt - 1.0) * k_last * saw
                                   + k_last * n_last);
        const double n_tiles = kt * nt;
        const double on = live_total * on_per_live;
        const double w_on = live_total * won_per_live;
        const double duration = n_tiles * cyc;
        const double total = saw * saw * duration;
        const double off = total - on - w_on;
        const double denom = fmax(total, 1.0);
        const int64_t o = s * n + i;
        dur_o[o] = duration;
        on_o[o] = on / denom;
        won_o[o] = w_on / denom;
        off_o[o] = off / denom;
        wake_o[o] = n_tiles;
    }
}

extern "C" int sa_occupancy_launch(
    const double* mm_m, const double* mm_k, const double* mm_n,
    const double* saw_v, double wlc_raw, int64_t n, int64_t n_saw,
    double* dur_o, double* on_o, double* won_o, double* off_o,
    double* wake_o, void* stream)
{
    const int threads = 256;
    dim3 grid((unsigned)((n + threads - 1) / threads),
              (unsigned)(n_saw < 65535 ? n_saw : 65535));
    sa_occupancy_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        mm_m, mm_k, mm_n, saw_v, wlc_raw, n, n_saw,
        dur_o, on_o, won_o, off_o, wake_o);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2  segment_sum  (sorted ids, fixed add order)
//
// Replaces jax.ops.segment_sum(..., indices_are_sorted=True) as the JAX
// package calls it from core/backend.py::JaxBackend.segment_sum, which XLA
// compiled into the one jitted sweep program; the reference's oracle is
// np.bincount (NumpyBackend.segment_sum).
//
// data is (B, n) row-major, the ids are sorted, so segment s of every row
// is the contiguous range [starts[s], starts[s+1]) (the wrapper derives
// starts with a searchsorted on the device). Each segment is summed by one
// thread, from 0.0, left to right -- the order np.bincount uses -- so the
// result has the same bits as the CPU plain version and the same bits from
// run to run. An atomic scatter-add (index_add_ on CUDA) gives neither, nor
// would a tree or a warp-shuffle reduction (deterministic, but another
// order, so other bits); the simulator's checkpoint/resume promise of
// bit-identical records needs both.
//
// Bound: each input read once and each output written once,
// 8 B x B x (n + num_segments) (+ the starts); the sweep's main shape
// (72 rows x 11 191 ops into 17 workload segments) is 6.4 MB, 2 us at
// 3.35 TB/s. What the fixed order costs is the chain of dependent float64
// adds of the longest segment (2 523 ops there), which no order-keeping
// design can shorten: on an H100 the main shape takes 21.7 us, at most
// 8.6 ns an add of that chain (PERF.md). Without the staging, a thread
// that reads 8 or 32 values ahead of its adds straight from device memory
// (and with L2 prefetches ahead of that) takes 25.9-36 us there
// (chip_k2_readahead.py).
//
// Design: a block of THREADS threads owns one row and a run of THREADS
// consecutive segments, one owner thread each. It stages the run's span of
// the row through shared memory in windows of cap_subs sub-tiles of SUB
// elements: every thread issues its 16-byte cp.async copies of a window
// (8-byte ones at an unaligned edge), sub-tile by sub-tile, each sub-tile
// completing on an mbarrier of its own; an owner waits only for the
// sub-tile it is about to read, so its adds run while the later sub-tiles
// are still on their way, and no owner waits for another's adds; it reads
// the next 8 values while it adds the current 8, so the chain waits on
// the adds alone. The
// running sum is carried across sub-tiles and windows, so a segment longer
// than a window keeps its order. Only between windows does the block
// synchronise, before a window's buffer is refilled. The wrapper picks
// cap_subs from n and the segment count (about twice a run's mean span), so
// a row of the main shape is one window; no tree, no shuffles, no atomics.
// When a block's run spans at most DIRECT_SPAN elements on average (the
// idle-gap chunks of one or two ops), the launcher takes the kernel's
// direct instance instead: each owner adds straight from device memory,
// in the same order, since there a load is one trip either way and the
// barriers would cost more than they hide. Two instances, not a branch
// in one, so that the staged one is compiled as if alone (a runtime
// branch cost the long shapes 0.7 us on an H100, PERF.md).
// ---------------------------------------------------------------------------
namespace k2 {
constexpr int THREADS = 128;   // segments per block, one owner each
constexpr int SUB = 1024;      // elements per sub-tile: one mbarrier
constexpr int MAX_SUBS = 12;   // sub-tiles per window: 96 KB of stage
constexpr int DIRECT_SPAN = 2 * THREADS;  // mean run read without staging
}

__device__ __forceinline__ int64_t k2_min(int64_t x, int64_t y) { return x < y ? x : y; }
__device__ __forceinline__ int64_t k2_max(int64_t x, int64_t y) { return x > y ? x : y; }

__device__ __forceinline__ uint32_t k2_smem(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void k2_copy16(void* dst, const void* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(k2_smem(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void k2_copy8(void* dst, const void* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(k2_smem(dst)), "l"(src) : "memory");
}

// the barrier's phase completes once every thread's copies issued so far
// have landed (count = THREADS arrivals, one per thread, none counted up)
__device__ __forceinline__ void k2_arrive_on_copies(uint64_t* bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(k2_smem(bar)) : "memory");
}

__device__ __forceinline__ void k2_bar_init(uint64_t* bar, unsigned count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(k2_smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void k2_bar_wait(uint64_t* bar, unsigned parity)
{
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT_%=;\n"
        "}\n" :: "r"(k2_smem(bar)), "r"(parity) : "memory");
}

// acc + x[0] + x[1] + ... + x[len-1], in that order, with the next 8
// values read while the current 8 are added: the chain waits on the adds
__device__ __forceinline__ double k2_add_in_order(double acc, const double* x,
                                                  int len)
{
    int i = 0;
    if (len >= 8) {
        double v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = x[u];
        for (i = 8; i + 8 <= len; i += 8) {
            double w[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) w[u] = x[i + u];
#pragma unroll
            for (int u = 0; u < 8; ++u) acc += v[u];
#pragma unroll
            for (int u = 0; u < 8; ++u) v[u] = w[u];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc += v[u];
    }
    for (; i < len; ++i) acc += x[i];
    return acc;
}

template <bool STAGED>
__global__ void __launch_bounds__(k2::THREADS)
segment_sum_kernel(const double* __restrict__ data,
                   const int64_t* __restrict__ starts, int64_t n,
                   int64_t num_segments, int64_t batch, int cap_subs,
                   double* __restrict__ out)
{
    using namespace k2;
    const int tid = threadIdx.x;
    const int64_t s0 = (int64_t)blockIdx.x * THREADS;
    const int64_t s = s0 + tid;
    if (!STAGED) {  // each owner straight from device memory
        if (s >= num_segments) return;
        const int64_t a = starts[s], e = starts[s + 1];
        for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
            const double* row = data + b * n;
            double acc = 0.0;
            for (int64_t j = a; j < e; ++j) acc += row[j];
            out[b * num_segments + s] = acc;
        }
        return;
    }
    extern __shared__ __align__(16) double stage[];
    __shared__ __align__(8) uint64_t bars[MAX_SUBS];
    const int64_t s_end = k2_min(s0 + THREADS, num_segments);
    const bool own = s < s_end;
    const int64_t lo = starts[s0], hi = starts[s_end];  // the run's span
    const int64_t a = own ? starts[s] : 0, e = own ? starts[s + 1] : 0;
    const int64_t cap = (int64_t)cap_subs * SUB;
    if (tid == 0) {
        for (int k = 0; k < cap_subs; ++k) k2_bar_init(&bars[k], THREADS);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    unsigned window = 0;  // windows so far: the mbarriers' phase
    for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
        const int64_t g_lo = b * n + lo, g_hi = b * n + hi;
        double acc = 0.0;
        // windows start on an even element: 16-byte copies line up
        for (int64_t base = g_lo & ~(int64_t)1; base < g_hi;
             base += cap, ++window) {
            const int64_t w_end = k2_min(base + cap, g_hi);
            const int nsub = (int)((w_end - base + SUB - 1) / SUB);
            for (int k = 0; k < nsub; ++k) {
                const int64_t k_end = k2_min(base + (int64_t)(k + 1) * SUB, w_end);
                for (int64_t p = base + (int64_t)k * SUB + 2 * tid; p < k_end;
                     p += 2 * THREADS) {
                    double* dst = stage + (p - base);
                    if (p >= g_lo && p + 1 < k_end) {
                        k2_copy16(dst, data + p);
                    } else {
                        if (p >= g_lo) k2_copy8(dst, data + p);
                        if (p + 1 < k_end && p + 1 >= g_lo)
                            k2_copy8(dst + 1, data + p + 1);
                    }
                }
                k2_arrive_on_copies(&bars[k]);
            }
            // every barrier completes one phase a window, used or not
            for (int k = nsub; k < cap_subs; ++k) k2_arrive_on_copies(&bars[k]);
            // this thread's segment within the window, left to right
            int64_t j = k2_max(b * n + a, base);
            const int64_t j_end = k2_min(b * n + e, w_end);
            while (j < j_end) {
                const int k = (int)((j - base) / SUB);
                k2_bar_wait(&bars[k], window & 1u);
                const int64_t k_end = k2_min(base + (int64_t)(k + 1) * SUB, j_end);
                acc = k2_add_in_order(acc, stage + (j - base), (int)(k_end - j));
                j = k_end;
            }
            __syncthreads();  // every owner is done before the refill
        }
        if (own) out[b * num_segments + s] = acc;
    }
}

extern "C" int segment_sum_launch(
    const double* data, const int64_t* starts, int64_t n,
    int64_t num_segments, int64_t batch, int cap_subs, double* out,
    void* stream)
{
    if (cap_subs < 1 || cap_subs > k2::MAX_SUBS || ((uintptr_t)data & 15))
        return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((num_segments + k2::THREADS - 1) / k2::THREADS),
              (unsigned)(batch < 65535 ? batch : 65535));
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t run = num_segments < k2::THREADS ? num_segments : k2::THREADS;
    if (n * run <= (int64_t)k2::DIRECT_SPAN * num_segments) {  // mean run
        segment_sum_kernel<false><<<grid, k2::THREADS, 0, st>>>(
            data, starts, n, num_segments, batch, cap_subs, out);
        return (int)cudaGetLastError();
    }
    const int smem = cap_subs * k2::SUB * (int)sizeof(double);
    // above 48 KB a block's dynamic shared memory needs the attribute;
    // set it once per device at the largest size asked so far
    static int smem_allowed[64];
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    if (device >= 64) return (int)cudaErrorInvalidValue;
    if (smem > smem_allowed[device]) {
        err = cudaFuncSetAttribute(segment_sum_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return (int)err;
        smem_allowed[device] = smem;
    }
    segment_sum_kernel<true><<<grid, k2::THREADS, smem, st>>>(
        data, starts, n, num_segments, batch, cap_subs, out);
    return (int)cudaGetLastError();
}
