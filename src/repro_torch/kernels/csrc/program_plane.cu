// The program plane's event executor for NVIDIA Hopper (sm_90a), integers
// throughout, built by nvcc into a shared library with a plain C interface
// and loaded with ctypes (see ../_build.py).
//
// The launcher runs on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
// Layout: the ragged event streams as they come (the ProgramArrays columns),
// cycle (N,), lat (N, U) int64 and pm (N, U) int8, N a multiple of 4, and
// per task (one task per stream that rows run) its events [ev_lo, ev_hi) and
// its rows row_order[task_rows[task] : task_rows[task + 1]]; per row delay,
// window, mode0 (R, U) and horizon (R,) int64. cycle == -1 marks a padded
// event: it changes no state. Mode codes are 0 AUTO / 1 ON / 2 OFF; setpm
// effect codes 1 ON / 2 OFF / 3 AUTO.
//
// Bound: the rows are independent, but inside a row every event depends on
// the state the last one left (machine time, each unit's power, ready, busy
// and idle cycles), so the time is the longest row's chain of dependent
// steps. The bytes are small beside it: 44 bytes an event (cycle, four
// latencies, four setpm codes), each stream read once per task. A task's
// warp issues alone on its scheduler, so a step costs the sum of its
// instructions' stalls: the state and the step below are cut to few
// instructions and no branch on a lane's data.
//
// Design:
// * Rows that share a stream (the same program and delay scale at several
//   detection windows) form one task, one warp: the stream is read once
//   for all of them. A task of more rows than a warp holds loops over its
//   rows a warp-full at a time, reading the stream once a pass.
// * The stream reaches shared memory through a ring of STAGES stages of D
//   events, each stage filled by three 1-D bulk TMA copies (cycle, lat, pm)
//   that complete on the stage's mbarrier. Lane 0 refills a stage as soon
//   as the warp has stepped through it, so STAGES - 1 chunks are in flight
//   while the warp steps: no step waits on device memory, only the first
//   chunk of a pass does. Bulk copies need 16-byte aligned sources and
//   sizes: the kernel aligns each chunk's start down to a multiple of 4
//   events (the first chunk then holds up to 3 events of the stream before,
//   which the loop skips), a chunk's length to a multiple of 4 events, and
//   the wrapper pads the columns to a multiple of 4 events so that the last
//   chunk's copy stays inside them.
// * A lane per unit (UT = 1 unit a thread, GW = 4 lanes a row, 8 rows a
//   warp): each lane keeps its unit's ready / busy / on / wakes / mode /
//   powered, and every lane of the row the row's t, prev, stalls and
//   nsetpm, identically. The coupling, the bundle's start, is a max over
//   the row's 4 lanes by two __shfl_xor_sync rounds. The code is written
//   for UT units a thread: chip_b7_variants.py builds copies of this
//   source with UT = 4 (one thread a row, its four units in registers)
//   and with other D, and times them against this build (PERF.md).
// * Lanes past a task's rows step the same events on zero parameters and
//   write nothing, so the warp never diverges and every shuffle is full.
// No floating point, no atomics: the results equal the plain version's
// exactly.
// ---------------------------------------------------------------------------
namespace b7 {
constexpr int U = 4;         // sa0, vu0, dma0, ici0 (KERNEL_UNITS)
constexpr int WARP = 32;
constexpr int UT = 1;        // units a thread: a lane a unit
constexpr int D = 128;       // events a ring stage
constexpr int STAGES = 3;
static_assert(D % 4 == 0, "a stage holds whole groups of 4 events");
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b)
{
    return a > b ? a : b;
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b)
{
    return a < b ? a : b;
}

// one ring stage: D events of the three columns, each 16-byte aligned,
// an event's four setpm codes as one 32-bit word; each column has room
// for one event more, so that the read of the next event past a
// chunk's last one stays inside the stage
struct Stage {
    int64_t cycle[D + 2];
    int64_t lat[(D + 1) * U];
    uint32_t pm[D + 4];
};
static_assert(sizeof(Stage) % 16 == 0 && (8 * (D + 2)) % 16 == 0
              && (8 * (D + 2) + 32 * (D + 1)) % 16 == 0, "bulk copies");

// UT units a thread, GW = U / UT threads a row, ROWS rows a warp.
//
// The state is the reference's, less what two of its invariants give for
// free, so that a step issues fewer instructions (the step is the whole
// chain): a unit's idle cycle is set only where its busy cycle is, to
// the same value, so idle == busy always and the detection window ends
// at gend = busy + max(window, 0) (the reference's max(idle + window,
// busy), and its "t2 - idle >= window && busy <= t2" is t2 >= gend); and
// a unit's on + gated cycles grow by each gap's n and by 1 a step while
// t grows by n and by 1 + the step's stall, so gated = t - stalls - on,
// formed once at the drain. A step's one cycle of on time, the wakes and
// the setpm events are counted in 32 bits (at most one a step, and no
// card holds 2^31 events), and whether an event holds a setpm is a
// property of the stream, read off its four codes in every lane. The
// step has no branch on a lane's data: the warp never splits.
struct Machine {
    static constexpr int GW = U / UT;
    static constexpr int ROWS = WARP / GW;

    int64_t t, prev, stalls;           // the row's, in each of its lanes
    int nsetpm;
    int64_t delay[UT], wpos[UT];       // wpos = max(window, 0)
    int64_t ready[UT], busy[UT], gend[UT], on[UT];
    int on1[UT], wakes[UT], mode[UT];
    bool powered[UT];

    // the largest x over the row's GW lanes, in each of them
    static __device__ __forceinline__ int64_t row_max(int64_t x)
    {
#pragma unroll
        for (int m = 1; m < GW; m <<= 1)
            x = imax(x, (int64_t)__shfl_xor_sync(FULL, (long long)x, m));
        return x;
    }

    // EventTimeline._gap(n, t) in closed form: a powered AUTO unit crosses
    // its idle-detection window at gend and counts gated from there
    // (on_gap clipped into [0, n])
    __device__ __forceinline__ void gap(int64_t n)
    {
#pragma unroll
        for (int j = 0; j < UT; ++j) {
            const bool autom = mode[j] == 0;
            const int64_t on_gap = imin(imax(gend[j] - t - 1, (int64_t)0),
                                        n);
            const int64_t on_add = powered[j] ? (autom ? on_gap : n) : 0;
            powered[j] = powered[j] && !(autom && on_add < n);
            on[j] += on_add;
        }
        t += n;
    }

    // one event: its cycle, this thread's units' latencies and the
    // event's four setpm codes (byte u is unit u's), this thread's units
    // from unit u0 on
    __device__ __forceinline__ void step(int64_t cycle, const int64_t* lat,
                                         uint32_t pmw, int u0)
    {
        gap(imax(cycle - prev - 1, (int64_t)0));
        const int64_t t1 = t;
        // 1) the misc-slot setpm, before the dispatch of the same event
#pragma unroll
        for (int j = 0; j < UT; ++j) {
            const int p = (int)(int8_t)(pmw >> (8 * (u0 + j)));
            const bool wake = p == 1 && !powered[j];
            ready[j] = wake ? t1 + delay[j] : ready[j];
            wakes[j] += wake;
            powered[j] = p == 1 || (powered[j] && p != 2);
            mode[j] = p >= 1 && p <= 3 ? (p == 3 ? 0 : p) : mode[j];
        }
        // 2) structural hazards: a dispatch wakes a gated unit; the bundle
        //    starts when every unit it uses is ready and free (units it
        //    does not use need nothing): the cross-unit coupling
        int64_t start = t1;
#pragma unroll
        for (int j = 0; j < UT; ++j) {
            const bool use = lat[j] > 0;
            const bool wake = use && !powered[j];
            ready[j] = wake ? imax(t1, busy[j]) + delay[j] : ready[j];
            wakes[j] += wake;
            powered[j] = powered[j] || wake;
            start = use ? imax(start, imax(ready[j], busy[j])) : start;
        }
        start = row_max(start);
        // 3) issue
#pragma unroll
        for (int j = 0; j < UT; ++j) {
            const bool use = lat[j] > 0;
            busy[j] = use ? start + lat[j] : busy[j];
            gend[j] = use ? busy[j] + wpos[j] : gend[j];
        }
        const int64_t t2 = start + 1;
        // 4) hardware idle detection at the post-issue cycle, then 5) the
        //    cycle's accounting
#pragma unroll
        for (int j = 0; j < UT; ++j) {
            powered[j] = powered[j] && !(mode[j] == 0 && t2 >= gend[j]);
            on1[j] += powered[j];
        }
        stalls += start - t1;
        nsetpm += __vcmpgts4(pmw, 0u) != 0;
        t = t2;
        prev = cycle;
    }
};

// lane 0: chunk k of a task's events (they start at `base`, a multiple of
// 4, and end at `end4`, the columns' padded end or before) into `stage`
__device__ __forceinline__ void issue_chunk(
    Stage* stage, uint64_t* bar, const int64_t* cycle, const int64_t* lat,
    const int8_t* pm, int64_t base, int64_t end4, int64_t k)
{
    const int64_t c0 = base + k * D;
    const unsigned n = (unsigned)imin((int64_t)D, end4 - c0);
    mbar_expect_tx(bar, n * 44u);
    bulk_load_1d(stage->cycle, cycle + c0, n * 8u, bar);
    bulk_load_1d(stage->lat, lat + c0 * U, n * 32u, bar);
    bulk_load_1d(stage->pm, pm + c0 * U, n * 4u, bar);
}
}  // namespace b7

__global__ void __launch_bounds__(b7::WARP) program_exec_kernel(
    const int64_t* __restrict__ cycle, const int64_t* __restrict__ lat,
    const int8_t* __restrict__ pm, const int64_t* __restrict__ ev_lo,
    const int64_t* __restrict__ ev_hi, const int64_t* __restrict__ task_rows,
    const int64_t* __restrict__ row_order, const int64_t* __restrict__ delay,
    const int64_t* __restrict__ window, const int64_t* __restrict__ mode0,
    const int64_t* __restrict__ horizon, int64_t* __restrict__ cycles_o,
    int64_t* __restrict__ stalls_o, int64_t* __restrict__ on_o,
    int64_t* __restrict__ gated_o, int64_t* __restrict__ wakes_o,
    int64_t* __restrict__ nsetpm_o)
{
    using namespace b7;
    __shared__ __align__(128) Stage ring[STAGES];
    __shared__ __align__(8) uint64_t full[STAGES];
    const int lane = threadIdx.x;
    const int slot = lane / Machine::GW;       // the lane's row in a pass
    const int u0 = (lane % Machine::GW) * UT;  // the lane's first unit
    const int64_t task = blockIdx.x;
    const int64_t lo = ev_lo[task], hi = ev_hi[task];
    const int64_t base = lo & ~(int64_t)3;
    const int64_t end4 = (hi + 3) & ~(int64_t)3;
    const int64_t chunks = hi > lo ? (end4 - base + D - 1) / D : 0;
    if (lane == 0) {
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
        mbar_fence_init();
    }
    __syncwarp();
    int64_t used = 0;  // chunks this block has consumed: the stages' phases
    const int64_t r_end = task_rows[task + 1];
    for (int64_t r0 = task_rows[task]; r0 < r_end; r0 += Machine::ROWS) {
        const int64_t ri = r0 + slot;
        const bool live = ri < r_end;
        const int64_t row = live ? row_order[ri] : 0;
        Machine m;
        m.t = 0;
        m.prev = -1;
        m.stalls = 0;
        m.nsetpm = 0;
#pragma unroll
        for (int j = 0; j < UT; ++j) {
            const int64_t at = row * U + u0 + j;
            m.delay[j] = live ? delay[at] : 0;
            m.wpos[j] = live ? imax(window[at], (int64_t)0) : 0;
            m.mode[j] = live ? (int)mode0[at] : 0;
            m.ready[j] = m.busy[j] = m.on[j] = 0;
            m.gend[j] = m.wpos[j];
            m.on1[j] = m.wakes[j] = 0;
            m.powered[j] = true;
        }
        if (lane == 0)
            for (int64_t k = 0; k < chunks && k < STAGES; ++k) {
                const int s = (int)((used + k) % STAGES);
                issue_chunk(&ring[s], &full[s], cycle, lat, pm, base, end4,
                            k);
            }
        for (int64_t k = 0; k < chunks; ++k) {
            const int s = (int)((used + k) % STAGES);
            mbar_wait(&full[s], (unsigned)(((used + k) / STAGES) & 1));
            const Stage& st = ring[s];
            const int64_t c0 = base + k * D;
            const int e0 = (int)imax(lo - c0, (int64_t)0);
            const int e1 = (int)imin(hi - c0, (int64_t)D);
            // the next event's data is read while this one steps (past
            // the chunk's last event, from the stage's spare slot)
            int64_t cyc = st.cycle[e0];
            uint32_t pmw = st.pm[e0];
            int64_t l[UT];
#pragma unroll
            for (int j = 0; j < UT; ++j) l[j] = st.lat[e0 * U + u0 + j];
            for (int e = e0; e < e1; ++e) {
                const int64_t cyc_n = st.cycle[e + 1];
                const uint32_t pmw_n = st.pm[e + 1];
                int64_t l_n[UT];
#pragma unroll
                for (int j = 0; j < UT; ++j)
                    l_n[j] = st.lat[(e + 1) * U + u0 + j];
                if (cyc >= 0) m.step(cyc, l, pmw, u0);  // uniform: one stream
                cyc = cyc_n;
                pmw = pmw_n;
#pragma unroll
                for (int j = 0; j < UT; ++j) l[j] = l_n[j];
            }
            __syncwarp();  // every lane is done with the stage
            if (lane == 0 && k + STAGES < chunks)
                issue_chunk(&ring[s], &full[s], cycle, lat, pm, base, end4,
                            k + STAGES);
        }
        used += chunks;
        // run()'s tail gap to the horizon, then _finish's drain
        m.gap(imax((live ? horizon[row] : 0) - m.prev - 1, (int64_t)0));
        int64_t end = m.t;
#pragma unroll
        for (int j = 0; j < UT; ++j) end = imax(end, m.busy[j]);
        end = Machine::row_max(end);
        const int64_t extra = end - m.t;
        if (!live) continue;
        if (u0 == 0) {
            cycles_o[row] = end;
            stalls_o[row] = m.stalls;
            nsetpm_o[row] = m.nsetpm;
        }
#pragma unroll
        for (int j = 0; j < UT; ++j) {
            const int64_t at = row * U + u0 + j;
            const int64_t on = m.on[j] + m.on1[j];
            on_o[at] = on + (m.powered[j] ? extra : 0);
            gated_o[at] = m.t - m.stalls - on + (m.powered[j] ? 0 : extra);
            wakes_o[at] = m.wakes[j];
        }
    }
}

extern "C" int program_exec_launch(
    const int64_t* cycle, const int64_t* lat, const int8_t* pm,
    const int64_t* ev_lo, const int64_t* ev_hi, const int64_t* task_rows,
    const int64_t* row_order, int64_t T, const int64_t* delay,
    const int64_t* window, const int64_t* mode0, const int64_t* horizon,
    int64_t* cycles_o, int64_t* stalls_o, int64_t* on_o, int64_t* gated_o,
    int64_t* wakes_o, int64_t* nsetpm_o, void* stream)
{
    if (T <= 0 || T > 0x7fffffff || ((uintptr_t)cycle & 15)
            || ((uintptr_t)lat & 15) || ((uintptr_t)pm & 15))
        return (int)cudaErrorInvalidValue;
    program_exec_kernel<<<(unsigned)T, b7::WARP, 0, (cudaStream_t)stream>>>(
        cycle, lat, pm, ev_lo, ev_hi, task_rows, row_order, delay, window,
        mode0, horizon, cycles_o, stalls_o, on_o, gated_o, wakes_o,
        nsetpm_o);
    return (int)cudaGetLastError();
}
