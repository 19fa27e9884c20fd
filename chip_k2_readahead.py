#!/usr/bin/env python3
"""K2 ``segment_sum`` against a simpler design, on one NVIDIA GPU.

    python3 chip_k2_readahead.py

The port's K2 (``csrc/power_plane.cu::segment_sum_kernel``) stages a
block's run of segments through shared memory by ``cp.async`` onto
mbarriers, so that an owner thread's adds never wait on a load from
device memory (a launch whose blocks' runs span at most 256 elements on
average reads device memory directly instead). The
simpler design measured here has no staging at all: a thread per
segment, 128 segments a block, adding its range left to right (the same
order, so the same bits) straight from device memory while it reads the
next ``R`` values ahead of its adds (``R`` = 8, 16 or 32), in some
variants with L2 prefetches further ahead (``VARIANTS``). Its source is
``READAHEAD_SRC`` below, built with the flags of the ``power_plane``
library. Both are held ``torch.equal`` to the CPU plain version and timed
by their device µs a call (``chip_smoke.kernel_device_us``) at the
sweep's four K2 shapes (``chip_smoke.k2_port_shapes``), in one process.

Prints the card's name and power limit, one JSON line per shape, and a
summary line. Needs one card; exits non-zero without one or if a design
gives other bits.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (R, AHEAD): read R values ahead of the adds; with AHEAD > 0 also ask L2
# for the lines AHEAD values ahead (prefetch.global.L2), so that the
# read-ahead hits L2 instead of device memory
VARIANTS = ((8, 0), (32, 0), (32, 256), (32, 1024), (16, 512))
READAHEAD_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void prefetch_l2(const void* p)
{
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

template <int R, int AHEAD>
__global__ void __launch_bounds__(128) segment_sum_readahead_kernel(
    const double* __restrict__ data, const int64_t* __restrict__ starts,
    int64_t n, int64_t num_segments, int64_t batch, double* __restrict__ out)
{
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= num_segments) return;
    const int64_t lo = starts[s], hi = starts[s + 1];
    for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
        const double* x = data + b * n;
        if (AHEAD > 0)
            for (int64_t p = lo; p < hi && p < lo + AHEAD; p += 16)
                prefetch_l2(x + p);
        double acc = 0.0;
        int64_t j = lo;
        if (hi - lo >= R) {
            double v[R];
#pragma unroll
            for (int u = 0; u < R; ++u) v[u] = x[j + u];
            for (j += R; j + R <= hi; j += R) {
                if (AHEAD > 0)
#pragma unroll
                    for (int u = 0; u < R; u += 16)
                        if (j + AHEAD + u < hi) prefetch_l2(x + j + AHEAD + u);
                double w[R];
#pragma unroll
                for (int u = 0; u < R; ++u) w[u] = x[j + u];
#pragma unroll
                for (int u = 0; u < R; ++u) acc += v[u];
#pragma unroll
                for (int u = 0; u < R; ++u) v[u] = w[u];
            }
#pragma unroll
            for (int u = 0; u < R; ++u) acc += v[u];
        }
        for (; j < hi; ++j) acc += x[j];
        out[b * num_segments + s] = acc;
    }
}

#define VARIANT(R, A)                                                       \
    if (r == R && ahead == A) {                                             \
        segment_sum_readahead_kernel<R, A><<<grid, 128, 0, st>>>(           \
            data, starts, n, num_segments, batch, out);                     \
        return (int)cudaGetLastError();                                     \
    }

extern "C" int segment_sum_readahead_launch(
    int r, int ahead, const double* data, const int64_t* starts, int64_t n,
    int64_t num_segments, int64_t batch, double* out, void* stream)
{
    dim3 grid((unsigned)((num_segments + 127) / 128),
              (unsigned)(batch < 65535 ? batch : 65535));
    cudaStream_t st = (cudaStream_t)stream;
    VARIANT(8, 0) VARIANT(32, 0) VARIANT(32, 256) VARIANT(32, 1024)
    VARIANT(16, 512)
    return (int)cudaErrorInvalidValue;
}
"""


def build() -> ctypes.CDLL:
    """The variant's library, from ``READAHEAD_SRC``, under ``build/``."""
    from repro_torch.kernels import _build
    out_dir = os.path.join(HERE, "build", "k2_readahead")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "readahead.cu")
    lib = os.path.join(out_dir, "libreadahead.so")
    with open(src, "w") as f:
        f.write(READAHEAD_SRC)
    flags = _build.LIBRARIES["power_plane"].flags
    proc = subprocess.run([_build.find_nvcc(), *flags, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stderr}")
    dll = ctypes.CDLL(lib)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    dll.segment_sum_readahead_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ptr, ptr, i64, i64, i64, ptr, ptr]
    dll.segment_sum_readahead_launch.restype = ctypes.c_int
    return dll


def main() -> int:
    import chip_smoke  # puts this checkout's src on the path
    import numpy as np
    import torch
    from repro_torch.kernels.segment_sum import (segment_starts, segment_sum,
                                                 segment_sum_plain)
    if not torch.cuda.is_available():
        raise SystemExit("chip_k2_readahead.py: no CUDA device")
    print(chip_smoke.smi_line(), flush=True)
    dll = build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    summary = {}
    for what, ids, num, batch in chip_smoke.k2_port_shapes(dev):
        n = int(ids.shape[0])
        data = torch.tensor(rng.uniform(1e-9, 1e3, (batch, n)), device=dev)
        stt = segment_starts(ids, num)
        want = segment_sum_plain(data.cpu(), ids.cpu(), num)

        def readahead(r, ahead):
            out = torch.empty(batch, num, dtype=torch.float64, device=dev)
            err = dll.segment_sum_readahead_launch(
                r, ahead, data.data_ptr(), stt.data_ptr(), n, num, batch,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"readahead {r}/{ahead}: launch error "
                                 f"{err}")
            return out

        rec = {"what": what, "B": batch, "n": n, "num_segments": num}
        port = segment_sum(data, ids, num, stt)
        if not torch.equal(port.cpu(), want):
            raise SystemExit(f"{what}: the port's kernel gives other bits")
        rec["port_device_us"] = chip_smoke.kernel_device_us(
            lambda: segment_sum(data, ids, num, stt), "segment_sum_kernel",
            reps=20)
        for r, ahead in VARIANTS:
            name = f"readahead_{r}" + (f"_l2_{ahead}" if ahead else "")
            if not torch.equal(readahead(r, ahead).cpu(), want):
                raise SystemExit(f"{what}: {name} gives other bits")
            rec[f"{name}_device_us"] = chip_smoke.kernel_device_us(
                lambda r=r, a=ahead: readahead(r, a),
                "segment_sum_readahead_kernel", reps=20)
        print(json.dumps(rec), flush=True)
        summary[what] = {k: v for k, v in rec.items() if k.endswith("_us")}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
