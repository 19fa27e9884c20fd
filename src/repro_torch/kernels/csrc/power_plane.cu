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
// starts with a searchsorted on the device). One thread per (row, segment)
// starts from 0.0 and adds its range left to right — the order np.bincount
// uses — so the result has the same bits as the CPU plain version and the
// same bits from run to run. An atomic scatter-add (index_add_ on CUDA)
// gives neither, and the simulator's checkpoint/resume promise of
// bit-identical records needs both.
//
// Bound: each input read once and each output written once,
// 8 B x B x (n + num_segments) (+ the starts). The price of the fixed
// order: a thread walks its segment serially, so the sweep's long-segment
// case (17 workload segments of ~660 ops) is far from that bound; the
// short-segment case (thousands of idle-gap chunks of one or two ops) has
// neighbouring threads on neighbouring addresses and is close to it. A
// warp per segment with a fixed-shape tree would keep the determinism and
// recover the long case.
// ---------------------------------------------------------------------------
__global__ void segment_sum_kernel(
    const double* __restrict__ data, const int64_t* __restrict__ starts,
    int64_t n, int64_t num_segments, int64_t batch,
    double* __restrict__ out)
{
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= num_segments) return;
    const int64_t lo = starts[s], hi = starts[s + 1];
    for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
        const double* row = data + b * n;
        double acc = 0.0;
        for (int64_t j = lo; j < hi; ++j) acc += row[j];
        out[b * num_segments + s] = acc;
    }
}

extern "C" int segment_sum_launch(
    const double* data, const int64_t* starts, int64_t n,
    int64_t num_segments, int64_t batch, double* out, void* stream)
{
    const int threads = 128;
    dim3 grid((unsigned)((num_segments + threads - 1) / threads),
              (unsigned)(batch < 65535 ? batch : 65535));
    segment_sum_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        data, starts, n, num_segments, batch, out);
    return (int)cudaGetLastError();
}
