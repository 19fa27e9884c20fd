// The program plane's event executor for NVIDIA Hopper (sm_90a), int64
// throughout, built by nvcc into a shared library with a plain C interface
// and loaded with ctypes (see ../_build.py).
//
// The launcher runs on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// B7  program_exec  (lock-step event executor)
//
// Replaces the carry-only lax.scan over the event axis that the JAX package
// runs through src/repro/core/backend.py:218 (JaxBackend.scan), with the
// body of src/repro/core/program_plane.py:182-278: _kernel_body's closed-form
// gap_account and bundle step, and _full_body's tail gap to the horizon and
// drain. XLA compiled that scan into one device program; in eager PyTorch it
// would be some 60 small launches an event.
//
// Layout (the reference's _pack_dense): cycle (E, R), lat (E, R, U) int64,
// pm (E, R, U) int8; delay, window, mode0 (R, U) and horizon (R,) int64.
// cycle == -1 marks a padded event: it changes no state. Mode codes are
// 0 AUTO / 1 ON / 2 OFF; setpm effect codes 1 ON / 2 OFF / 3 AUTO.
//
// Bound: the rows are independent, but inside a row every event depends on
// the state the last one left (machine time, each unit's power, ready, busy
// and idle cycles), so the time is the longest row's chain of dependent
// steps. The bytes are small beside it: 44 bytes an event (cycle, four
// latencies, four setpm codes), ~0.1 GB for the paper suite at every NPU and
// knob, tens of microseconds of device memory traffic.
//
// Design: one thread per row, its whole U-unit state in registers (the unit
// loops are unrolled), walking its events in order; the event's data is
// loaded one event ahead, so a load's latency overlaps the step before it.
// Consecutive rows are consecutive threads and the event axis is outermost,
// so a warp's reads of one event index are contiguous (8 bytes a thread of
// cycle, 32 of lat, 4 of pm). A row stops at its own last real event
// (extent, computed by the wrapper): past it every event is padding. 32
// threads a block, so a stack of ~1 500 rows spreads its warps over as many
// SMs as it can. No floating point, no atomics: the results equal the plain
// version's exactly.
// ---------------------------------------------------------------------------
namespace b7 {
constexpr int U = 4;         // sa0, vu0, dma0, ici0 (KERNEL_UNITS)
constexpr int THREADS = 32;

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b)
{
    return a > b ? a : b;
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b)
{
    return a < b ? a : b;
}

struct Event {
    int64_t cycle;
    longlong2 lat01, lat23;
    char4 pm;
};

__device__ __forceinline__ Event load_event(const int64_t* cycle,
                                            const int64_t* lat,
                                            const int8_t* pm, int64_t i)
{
    Event ev;
    ev.cycle = cycle[i];
    ev.lat01 = reinterpret_cast<const longlong2*>(lat)[2 * i];
    ev.lat23 = reinterpret_cast<const longlong2*>(lat)[2 * i + 1];
    ev.pm = reinterpret_cast<const char4*>(pm)[i];
    return ev;
}

struct Machine {
    int64_t t, prev, stalls, nsetpm;
    int64_t delay[U], window[U], mode[U];
    int64_t ready[U], busy[U], idle[U], on[U], gated[U], wakes[U];
    bool powered[U];

    // EventTimeline._gap(n, t) in closed form: a powered AUTO unit crosses
    // its idle-detection window at max(idle + window, busy) and counts
    // gated from there (on_gap clipped into [0, n])
    __device__ __forceinline__ void gap(int64_t n)
    {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const bool autom = mode[u] == 0;
            const int64_t g = imax(idle[u] + window[u], busy[u]);
            const int64_t on_gap = imin(imax(g - t - 1, (int64_t)0), n);
            const int64_t on_add = powered[u] ? (autom ? on_gap : n) : 0;
            const int64_t gate_add = n - on_add;
            if (autom && powered[u] && gate_add > 0) powered[u] = false;
            on[u] += on_add;
            gated[u] += gate_add;
        }
        t += n;
    }

    __device__ __forceinline__ void step(const Event& ev)
    {
        gap(imax(ev.cycle - prev - 1, (int64_t)0));
        const int64_t t1 = t;
        const int64_t lat[U] = {ev.lat01.x, ev.lat01.y, ev.lat23.x,
                                ev.lat23.y};
        const int pm[U] = {ev.pm.x, ev.pm.y, ev.pm.z, ev.pm.w};
        // 1) the misc-slot setpm, before the dispatch of the same event
        bool any_pm = false;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (pm[u] == 1 && !powered[u]) {
                ready[u] = t1 + delay[u];
                ++wakes[u];
                powered[u] = true;
            }
            if (pm[u] == 2) powered[u] = false;
            mode[u] = pm[u] == 1 ? 1 : pm[u] == 2 ? 2 : pm[u] == 3 ? 0
                                                                : mode[u];
            any_pm |= pm[u] > 0;
        }
        // 2) structural hazards: a dispatch wakes a gated unit; the bundle
        //    starts when every unit it uses is ready and free (units it
        //    does not use need nothing): the cross-unit coupling
        int64_t start = t1;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (lat[u] <= 0) continue;
            if (!powered[u]) {
                ready[u] = imax(t1, busy[u]) + delay[u];
                ++wakes[u];
                powered[u] = true;
            }
            start = imax(start, imax(ready[u], busy[u]));
        }
        // 3) issue
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (lat[u] > 0) {
                busy[u] = start + lat[u];
                idle[u] = busy[u];
            }
        }
        const int64_t t2 = start + 1;
        // 4) hardware idle detection at the post-issue cycle, then 5) the
        //    cycle's accounting
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (powered[u] && mode[u] == 0 && t2 - idle[u] >= window[u]
                    && busy[u] <= t2)
                powered[u] = false;
            on[u] += powered[u] ? 1 : 0;
            gated[u] += powered[u] ? 0 : 1;
        }
        stalls += start - t1;
        nsetpm += any_pm ? 1 : 0;
        t = t2;
        prev = ev.cycle;
    }
};
}  // namespace b7

__global__ void __launch_bounds__(b7::THREADS) program_exec_kernel(
    const int64_t* __restrict__ cycle, const int64_t* __restrict__ lat,
    const int8_t* __restrict__ pm, const int64_t* __restrict__ delay,
    const int64_t* __restrict__ window, const int64_t* __restrict__ mode0,
    const int64_t* __restrict__ horizon, const int64_t* __restrict__ extent,
    int64_t R, int64_t* __restrict__ cycles_o,
    int64_t* __restrict__ stalls_o, int64_t* __restrict__ on_o,
    int64_t* __restrict__ gated_o, int64_t* __restrict__ wakes_o,
    int64_t* __restrict__ nsetpm_o)
{
    using namespace b7;
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    Machine m;
    m.t = 0;
    m.prev = -1;
    m.stalls = 0;
    m.nsetpm = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
        m.delay[u] = delay[r * U + u];
        m.window[u] = window[r * U + u];
        m.mode[u] = mode0[r * U + u];
        m.ready[u] = m.busy[u] = m.idle[u] = 0;
        m.on[u] = m.gated[u] = m.wakes[u] = 0;
        m.powered[u] = true;
    }
    const int64_t n = extent[r];
    Event next;
    if (n > 0) next = load_event(cycle, lat, pm, r);
    for (int64_t e = 0; e < n; ++e) {
        const Event ev = next;
        if (e + 1 < n) next = load_event(cycle, lat, pm, (e + 1) * R + r);
        if (ev.cycle >= 0) m.step(ev);
    }
    // run()'s tail gap to the horizon, then _finish's drain
    m.gap(imax(horizon[r] - m.prev - 1, (int64_t)0));
    int64_t end = m.t;
#pragma unroll
    for (int u = 0; u < U; ++u) end = imax(end, m.busy[u]);
    const int64_t extra = end - m.t;
    cycles_o[r] = end;
    stalls_o[r] = m.stalls;
    nsetpm_o[r] = m.nsetpm;
#pragma unroll
    for (int u = 0; u < U; ++u) {
        on_o[r * U + u] = m.on[u] + (m.powered[u] ? extra : 0);
        gated_o[r * U + u] = m.gated[u] + (m.powered[u] ? 0 : extra);
        wakes_o[r * U + u] = m.wakes[u];
    }
}

extern "C" int program_exec_launch(
    const int64_t* cycle, const int64_t* lat, const int8_t* pm,
    const int64_t* delay, const int64_t* window, const int64_t* mode0,
    const int64_t* horizon, const int64_t* extent, int64_t R,
    int64_t* cycles_o, int64_t* stalls_o, int64_t* on_o, int64_t* gated_o,
    int64_t* wakes_o, int64_t* nsetpm_o, void* stream)
{
    if (R <= 0 || ((uintptr_t)lat & 15) || ((uintptr_t)pm & 3))
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = (R + b7::THREADS - 1) / b7::THREADS;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    program_exec_kernel<<<(unsigned)blocks, b7::THREADS, 0,
                          (cudaStream_t)stream>>>(
        cycle, lat, pm, delay, window, mode0, horizon, extent, R, cycles_o,
        stalls_o, on_o, gated_o, wakes_o, nsetpm_o);
    return (int)cudaGetLastError();
}
