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
// The math, per (batch, head) and chunk of Q = 64 positions (B5's chunk;
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
//   dx_s = dt_s du_s,  dA += sum_s dt_s da_s
//   dH    <- exp(e) dH + sum_t exp(cum_t) dy_t C_t^T   (the entering state's)
//
// Design: one block per (head, batch), 256 threads, walking the chunks in
// reverse with dH (P x N float32) in shared memory from the last chunk to
// the first -- a loop in the block takes the place of the reverse scan, as
// B5's loop takes the forward one. The chunk-entering states h are not kept
// by B5: the block first walks the chunks forward and recomputes them into a
// float32 workspace (S/64 x P x N per (batch, head); 1 MB a head at mamba2's
// training shape, so it stays in L2 while the reverse walk reads it). Asking
// B5 to write them would cost a second output on the serving path and its
// memory under remat, for the P x N x Q operations a chunk this pass costs
// (about a seventh of the backward's). Every product runs on the CUDA cores
// in float32 (bf16 inputs are widened on load), each thread owning one
// position row and a quarter of its columns, every sum in a fixed order; no
// atomics, so two calls give the same bits. The in-chunk cumsum runs
// sequentially in one thread, as B5 keeps it (a parallel float32 cumsum
// drifts in the strong-decay case). dB and dC go per head to a float32
// workspace (B, S, H, N) and a second kernel sums a group's heads in head
// order, as B9 sums a GQA group's dK / dV.
//
// Bound at mamba2-780m's training shape (B 1, S 2048, H 48, P 64, N 128,
// G 1, bf16): the chunked form's products are ~3.7 M FMAs a chunk and head
// with the state recompute, 11.3 GFLOP a call against 53 MB of inputs and
// outputs: 0.016 ms by bytes at the tensor cores' rate (0.011 ms of
// operations), 0.17 ms on the CUDA cores' 67 TFLOP/s, the kernel's route.
// What holds it back: 48 blocks for 132 SMs (one per head), each thread's
// products read both operands from shared memory, and the serial cumsum
// and reductions between the passes. Splitting P over blocks and moving the
// products onto mma.sync are the next steps.
//
// Every launcher runs on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sb {
constexpr int Q = 64, THREADS = 256, PARTS = 6;
// shared memory, in floats: x, dy (Q x P+4); B, C (Q x N+4); h (P x N);
// dH (P x N+4); G L, W L, R (Q x Q+4); eight Q-vectors; PARTS partial-sum
// rows of THREADS
template <int P, int N> __host__ __device__ constexpr size_t smem_floats() {
    return (size_t)2 * Q * (P + 4) + (size_t)2 * Q * (N + 4) + (size_t)P * N
           + (size_t)P * (N + 4) + (size_t)3 * Q * (Q + 4) + 8 * Q
           + (size_t)PARTS * THREADS;
}
}  // namespace sb

__device__ __forceinline__ float sb_f(float v) { return v; }
__device__ __forceinline__ float sb_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T sb_to(float v);
template <> __device__ __forceinline__ float sb_to<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 sb_to<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// rows [c0, c0 + Q) of a (B, S, ·, W) tensor's slice (b, ·, hd) into a
// Q x LD float tile; rows past S are zeros
template <typename T, int W, int LD>
__device__ __forceinline__ void sb_rows(float* dst, const T* __restrict__ src,
                                        int64_t base, int64_t s_seq, int c0, int S)
{
    for (int i = threadIdx.x; i < sb::Q * W; i += sb::THREADS) {
        const int r = i / W, c = i % W, s = c0 + r;
        dst[r * LD + c] = s < S ? sb_f(src[base + (int64_t)s * s_seq + c]) : 0.f;
    }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(sb::THREADS, 1)
ssd_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ dy,
                    const float* __restrict__ dstate, T* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ dA,
                    float* __restrict__ dB_ws, float* __restrict__ dC_ws,
                    float* __restrict__ states, int S, int H, int G,
                    int64_t xsb, int64_t xss, int64_t xsh,
                    int64_t dsb, int64_t dss, int64_t dsh,
                    int64_t asb, int64_t ash,
                    int64_t bsb, int64_t bss, int64_t bsg,
                    int64_t csb, int64_t css, int64_t csg)
{
    using namespace sb;
    constexpr int LP = P + 4, LN = N + 4, LQ = Q + 4;
    constexpr int PN = P * N, EL = PN / THREADS;  // state entries a thread
    constexpr int NJ = N / 4, PJ = P / 4;         // columns a thread
    static_assert(PN % THREADS == 0, "P * N must be a multiple of 256");
    extern __shared__ float sb_smem[];
    float* Xs = sb_smem;          // Q x LP: x
    float* DYs = Xs + Q * LP;     // Q x LP: dy
    float* Bs = DYs + Q * LP;     // Q x LN
    float* Cs = Bs + Q * LN;      // Q x LN
    float* Hs = Cs + Q * LN;      // P x N: the state entering the chunk
    float* DHs = Hs + PN;         // P x LN: the state gradient
    float* GL = DHs + P * LN;     // Q x LQ: (G o L)[t][s]
    float* Ms = GL + Q * LQ;      // Q x LQ: (W o L)[t][s]
    float* Rs = Ms + Q * LQ;      // Q x LQ: (G o W o L)[t][s]
    float* dtv = Rs + Q * LQ;     // Q vectors
    float* cum = dtv + Q;
    float* wv = cum + Q;          // forward walk: exp(e - cum_s) dt_s
    float* zv = wv + Q;
    float* xdu = zv + Q;
    float* dcum = xdu + Q;
    float* ecum = dcum + Q;       // exp(cum_t)
    float* eend = ecum + Q;       // exp(e - cum_s)
    float* part = eend + Q;       // PARTS x THREADS

    const int tid = threadIdx.x;
    const int r = tid / 4, q = tid % 4;  // a position row and its quarter
    const int h = blockIdx.x, b = blockIdx.y;
    const int g = h / (H / G);
    const int nc = (S + Q - 1) / Q;
    const float Ah = A[(int64_t)b * asb + (int64_t)h * ash];
    const int64_t xb = (int64_t)b * xsb + (int64_t)h * xsh;
    const int64_t bb = (int64_t)b * bsb + (int64_t)g * bsg;
    const int64_t cb = (int64_t)b * csb + (int64_t)g * csg;
    float* st = states + ((int64_t)b * H + h) * nc * PN;

    auto load_dt = [&](int c0) {
        if (tid < Q) {
            const int s = c0 + tid;
            dtv[tid] = s < S ? dt[(int64_t)b * dsb + (int64_t)s * dss + (int64_t)h * dsh] : 0.f;
        }
    };
    // the in-chunk cumsum of dt A, sequential in float32 (B5's rule), each
    // product rounded before its add (no contraction into an FMA), as the
    // plain version's torch.cumsum of dt * A rounds it
    auto cumsum = [&]() {
        if (tid == 0) {
            float run = 0.f;
            for (int s = 0; s < Q; ++s) {
                run = __fadd_rn(run, __fmul_rn(dtv[s], Ah));
                cum[s] = run;
            }
        }
    };

    // ---- forward walk: the state entering each chunk, into `states` ----
    float hreg[EL];
#pragma unroll
    for (int i = 0; i < EL; ++i) hreg[i] = 0.f;
    for (int c = 0; c < nc; ++c) {
#pragma unroll
        for (int i = 0; i < EL; ++i) st[(int64_t)c * PN + tid + THREADS * i] = hreg[i];
        if (c == nc - 1) break;
        const int c0 = c * Q;
        __syncthreads();  // the previous chunk is done with Xs, Bs, wv
        sb_rows<T, P, LP>(Xs, x, xb, xss, c0, S);
        sb_rows<T, N, LN>(Bs, Bm, bb, bss, c0, S);
        load_dt(c0);
        __syncthreads();
        cumsum();
        __syncthreads();
        if (tid < Q) wv[tid] = expf(cum[Q - 1] - cum[tid]) * dtv[tid];
        __syncthreads();
        const float decay = expf(cum[Q - 1]);
#pragma unroll
        for (int i = 0; i < EL; ++i) {
            const int e = tid + THREADS * i, p = e / N, n = e % N;
            float acc = hreg[i] * decay;
            for (int s = 0; s < Q; ++s) acc = fmaf(wv[s] * Xs[s * LP + p], Bs[s * LN + n], acc);
            hreg[i] = acc;
        }
    }

    // ---- reverse walk ---------------------------------------------------
#pragma unroll
    for (int i = 0; i < EL; ++i) {
        const int e = tid + THREADS * i, p = e / N, n = e % N;
        DHs[p * LN + n] = dstate != nullptr ? dstate[((int64_t)b * H + h) * PN + e] : 0.f;
    }
    float dA_acc = 0.f;  // thread 0's, chunk by chunk from the last
    for (int c = nc - 1; c >= 0; --c) {
        const int c0 = c * Q;
        __syncthreads();  // the previous chunk is done with every buffer
        sb_rows<T, P, LP>(Xs, x, xb, xss, c0, S);
        sb_rows<float, P, LP>(DYs, dy, ((int64_t)b * S * H + h) * P, (int64_t)H * P, c0, S);
        sb_rows<T, N, LN>(Bs, Bm, bb, bss, c0, S);
        sb_rows<T, N, LN>(Cs, Cm, cb, css, c0, S);
        for (int i = tid; i < PN; i += THREADS) Hs[i] = st[(int64_t)c * PN + i];
        load_dt(c0);
        __syncthreads();
        cumsum();
        __syncthreads();
        if (tid < Q) {
            ecum[tid] = expf(cum[tid]);
            eend[tid] = expf(cum[Q - 1] - cum[tid]);
        }

        // A: G, W, L on the causal half; this thread's row t = r and columns
        // s = q + 4 j
        {
            const int t = r;
            float gg[Q / 4], ww[Q / 4];
#pragma unroll
            for (int j = 0; j < Q / 4; ++j) { gg[j] = 0.f; ww[j] = 0.f; }
            for (int n = 0; n < N; ++n) {
                const float cv = Cs[t * LN + n];
#pragma unroll
                for (int j = 0; j < Q / 4; ++j) gg[j] = fmaf(cv, Bs[(q + 4 * j) * LN + n], gg[j]);
            }
            for (int p = 0; p < P; ++p) {
                const float dv = DYs[t * LP + p];
#pragma unroll
                for (int j = 0; j < Q / 4; ++j) ww[j] = fmaf(dv, Xs[(q + 4 * j) * LP + p], ww[j]);
            }
            float rsum = 0.f;
#pragma unroll
            for (int j = 0; j < Q / 4; ++j) {
                const int s = q + 4 * j;
                float gl = 0.f, m = 0.f, rr = 0.f;
                if (s <= t) {
                    const float L = expf(cum[t] - cum[s]);
                    gl = gg[j] * L;
                    m = ww[j] * dtv[s] * L;
                    rr = gg[j] * m;
                }
                GL[t * LQ + s] = gl;
                Ms[t * LQ + s] = m;
                Rs[t * LQ + s] = rr;
                rsum += rr;
            }
            part[0 * THREADS + tid] = rsum;
        }
        __syncthreads();

        // B: dC on row t = r, columns n = q + 4 j; C_t.(h^T dy_t); and the
        // column sums of R on column r
        {
            const int t = r;
            float acc[NJ], hy[NJ];
#pragma unroll
            for (int j = 0; j < NJ; ++j) { acc[j] = 0.f; hy[j] = 0.f; }
            for (int s = 0; s <= t; ++s) {
                const float m = Ms[t * LQ + s];
#pragma unroll
                for (int j = 0; j < NJ; ++j) acc[j] = fmaf(m, Bs[s * LN + q + 4 * j], acc[j]);
            }
            for (int p = 0; p < P; ++p) {
                const float dv = DYs[t * LP + p];
#pragma unroll
                for (int j = 0; j < NJ; ++j) hy[j] = fmaf(Hs[p * N + q + 4 * j], dv, hy[j]);
            }
            const int pos = c0 + t;
            float ce = 0.f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int n = q + 4 * j;
                ce = fmaf(Cs[t * LN + n], hy[j], ce);
                if (pos < S)
                    dC_ws[(((int64_t)b * S + pos) * H + h) * N + n] = fmaf(ecum[t], hy[j], acc[j]);
            }
            part[1 * THREADS + tid] = ce;
            float col = 0.f;
            for (int j = 0; j < Q / 4; ++j) col += Rs[(q + 4 * j) * LQ + r];
            part[2 * THREADS + tid] = col;
        }

        // C: dB on row s = r, columns n = q + 4 j
        {
            const int s = r;
            float acc[NJ], ku[NJ];
#pragma unroll
            for (int j = 0; j < NJ; ++j) { acc[j] = 0.f; ku[j] = 0.f; }
            for (int t = s; t < Q; ++t) {
                const float m = Ms[t * LQ + s];
#pragma unroll
                for (int j = 0; j < NJ; ++j) acc[j] = fmaf(m, Cs[t * LN + q + 4 * j], acc[j]);
            }
            for (int p = 0; p < P; ++p) {
                const float xv = Xs[s * LP + p];
#pragma unroll
                for (int j = 0; j < NJ; ++j) ku[j] = fmaf(DHs[p * LN + q + 4 * j], xv, ku[j]);
            }
            const int pos = c0 + s;
            const float w = eend[s] * dtv[s];
            if (pos < S) {
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                    dB_ws[(((int64_t)b * S + pos) * H + h) * N + q + 4 * j] = fmaf(w, ku[j], acc[j]);
            }
        }

        // D: du on row s = r, columns p = q + 4 j; dx = dt du, x.du, u.(dH B)
        {
            const int s = r;
            float acc[PJ], f[PJ];
#pragma unroll
            for (int j = 0; j < PJ; ++j) { acc[j] = 0.f; f[j] = 0.f; }
            for (int t = s; t < Q; ++t) {
                const float gl = GL[t * LQ + s];
#pragma unroll
                for (int j = 0; j < PJ; ++j) acc[j] = fmaf(gl, DYs[t * LP + q + 4 * j], acc[j]);
            }
            for (int n = 0; n < N; ++n) {
                const float bv = Bs[s * LN + n];
#pragma unroll
                for (int j = 0; j < PJ; ++j) f[j] = fmaf(DHs[(q + 4 * j) * LN + n], bv, f[j]);
            }
            const int pos = c0 + s;
            float zs = 0.f, xd = 0.f;
#pragma unroll
            for (int j = 0; j < PJ; ++j) {
                const int p = q + 4 * j;
                const float du = fmaf(eend[s], f[j], acc[j]);
                const float xv = Xs[s * LP + p];
                zs = fmaf(xv, f[j], zs);
                xd = fmaf(xv, du, xd);
                if (pos < S) dx[(((int64_t)b * S + pos) * H + h) * P + p] = sb_to<T>(dtv[s] * du);
            }
            part[3 * THREADS + tid] = zs;
            part[4 * THREADS + tid] = xd;
        }
        // <dH, h> over this thread's state entries
        {
            float hd = 0.f;
#pragma unroll
            for (int i = 0; i < EL; ++i) {
                const int e = tid + THREADS * i, p = e / N, n = e % N;
                hd = fmaf(DHs[p * LN + n], Hs[e], hd);
            }
            part[5 * THREADS + tid] = hd;
        }
        __syncthreads();

        // the row sums of the quarters, in quarter order
        if (tid < Q) {
            const int s = tid;
            float rr = 0.f, ce = 0.f, cl = 0.f, zs = 0.f, xd = 0.f;
            for (int k = 0; k < 4; ++k) {
                rr += part[0 * THREADS + 4 * s + k];
                ce += part[1 * THREADS + 4 * s + k];
                cl += part[2 * THREADS + 4 * s + k];
                zs += part[3 * THREADS + 4 * s + k];
                xd += part[4 * THREADS + 4 * s + k];
            }
            const float z = eend[s] * dtv[s] * zs;
            zv[s] = z;
            xdu[s] = xd;
            dcum[s] = rr - cl + ecum[s] * ce - z;
        }
        __syncthreads();
        // the chunk's end, the reverse cumsum, ddt and dA: one thread, in order
        if (tid == 0) {
            float hd = 0.f;
            for (int k = 0; k < THREADS; ++k) hd += part[5 * THREADS + k];
            float zsum = 0.f;
            for (int s = 0; s < Q; ++s) zsum += zv[s];
            dcum[Q - 1] += zsum + expf(cum[Q - 1]) * hd;
            float run = 0.f, da_chunk = 0.f;
            for (int s = Q - 1; s >= 0; --s) {
                run += dcum[s];
                const int pos = c0 + s;
                if (pos < S)
                    ddt[((int64_t)b * S + pos) * H + h] = fmaf(Ah, run, xdu[s]);
                da_chunk = fmaf(dtv[s], run, da_chunk);
            }
            dA_acc += da_chunk;
        }

        // F: dH <- exp(e) dH + sum_t exp(cum_t) dy_t C_t^T (each thread its
        // own entries; every read of the old dH is behind the barrier above)
        {
            const float decay = expf(cum[Q - 1]);
#pragma unroll
            for (int i = 0; i < EL; ++i) {
                const int e = tid + THREADS * i, p = e / N, n = e % N;
                float acc = DHs[p * LN + n] * decay;
                for (int t = 0; t < Q; ++t)
                    acc = fmaf(ecum[t] * DYs[t * LP + p], Cs[t * LN + n], acc);
                DHs[p * LN + n] = acc;
            }
        }
    }
    if (tid == 0) dA[(int64_t)b * H + h] = dA_acc;
}

// dB and dC of group g: its heads' per-head partials summed in head order,
// rounded once to the output's type
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_group_kernel(const float* __restrict__ dB_ws, const float* __restrict__ dC_ws,
                     T* __restrict__ dB, T* __restrict__ dC, int64_t n, int H, int G, int N)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;  // (b, s, g, n)
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
static int ssd_bwd_run(const void* x, const float* dt, const float* A, const void* Bm,
                       const void* Cm, const float* dy, const float* dstate, void* dx,
                       float* ddt, float* dA, void* dB, void* dC, float* dB_ws,
                       float* dC_ws, float* states, int Bz, int S, int H, int G,
                       const int64_t* xs, const int64_t* dts, const int64_t* as,
                       const int64_t* bs, const int64_t* cs, cudaStream_t stream)
{
    const size_t smem = sb::smem_floats<P, N>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(ssd_scan_bwd_kernel<T, P, N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)H, (unsigned)Bz);
    ssd_scan_bwd_kernel<T, P, N><<<grid, sb::THREADS, smem, stream>>>(
        (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, dy, dstate, (T*)dx, ddt, dA,
        dB_ws, dC_ws, states, S, H, G, xs[0], xs[1], xs[2], dts[0], dts[1], dts[2],
        as[0], as[1], bs[0], bs[1], bs[2], cs[0], cs[1], cs[2]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t n = (int64_t)Bz * S * G * N;
    ssd_bwd_group_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        dB_ws, dC_ws, (T*)dB, (T*)dC, n, H, G, N);
    return (int)cudaGetLastError();
}

template <typename T, int P>
static int ssd_bwd_n(int N, const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, const float* dy, const float* dstate,
                     void* dx, float* ddt, float* dA, void* dB, void* dC, float* dB_ws,
                     float* dC_ws, float* states, int Bz, int S, int H, int G,
                     const int64_t* xs, const int64_t* dts, const int64_t* as,
                     const int64_t* bs, const int64_t* cs, cudaStream_t st)
{
#define SB_RUN(NN) ssd_bwd_run<T, P, NN>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA, dB, dC, \
                                         dB_ws, dC_ws, states, Bz, S, H, G, xs, dts, as, bs, cs, st)
    switch (N) {
    case 16:  return SB_RUN(16);
    case 32:  return SB_RUN(32);
    case 64:  return SB_RUN(64);
    case 128: return SB_RUN(128);
    default:  return (int)cudaErrorInvalidValue;
    }
#undef SB_RUN
}

template <typename T>
static int ssd_bwd_dispatch(int P, int N, const void* x, const float* dt, const float* A,
                            const void* Bm, const void* Cm, const float* dy,
                            const float* dstate, void* dx, float* ddt, float* dA, void* dB,
                            void* dC, float* dB_ws, float* dC_ws, float* states, int Bz,
                            int S, int H, int G, const int64_t* xs, const int64_t* dts,
                            const int64_t* as, const int64_t* bs, const int64_t* cs,
                            cudaStream_t st)
{
#define SB_P(PP) ssd_bwd_n<T, PP>(N, x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA, dB, dC, \
                                  dB_ws, dC_ws, states, Bz, S, H, G, xs, dts, as, bs, cs, st)
    switch (P) {
    case 16: return SB_P(16);
    case 32: return SB_P(32);
    case 64: return SB_P(64);
    default: return (int)cudaErrorInvalidValue;
    }
#undef SB_P
}

// is_bf16: 1 for bf16 x / B / C (and dx / dB / dC), 0 for float32. Strides
// in elements: xs, dts {batch, seq, head}; as {batch, head}; bs, cs {batch,
// seq, group}. dstate may be null. dB_ws, dC_ws (B, S, H, N) and states
// (B, H, ceil(S / 64), P, N) float32 workspaces, written before they are read.
extern "C" int ssd_scan_bwd_launch(
    int is_bf16, const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* dy, const float* dstate, void* dx, float* ddt, float* dA,
    void* dB, void* dC, float* dB_ws, float* dC_ws, float* states, int Bz, int S, int H,
    int G, int P, int N, const int64_t* xs, const int64_t* dts, const int64_t* as,
    const int64_t* bs, const int64_t* cs, void* stream)
{
    if (is_bf16)
        return ssd_bwd_dispatch<__nv_bfloat16>(P, N, x, dt, A, Bm, Cm, dy, dstate, dx, ddt,
                                               dA, dB, dC, dB_ws, dC_ws, states, Bz, S, H,
                                               G, xs, dts, as, bs, cs, (cudaStream_t)stream);
    return ssd_bwd_dispatch<float>(P, N, x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA, dB, dC,
                                   dB_ws, dC_ws, states, Bz, S, H, G, xs, dts, as, bs, cs,
                                   (cudaStream_t)stream);
}
