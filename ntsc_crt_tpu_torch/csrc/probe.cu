// K10 probe: the card's int32 issue rate under the dependency patterns of
// the decode's EQ march — the yardstick for pricing the serial kernels.
//
// Replaces: ntsc_crt_tpu/ops/pallas/vpu_probe.py::probe (_probe_kernel).
// Each thread owns one element x of x = arange(N) and runs `iters`
// iterations (a runtime argument, so the loop cannot be folded) of:
//
//   peak — 16 independent streams r = ((r * 58361 + 977) >> 3) + r from
//          r = x + j: the issue ceiling (16-way instruction-level
//          parallelism in every thread);
//   eq3  — three 3-band EQ chains (eq3.cuh, the decode's own chain) from
//          state x + c, input the loop index; each chain's output & 1 is
//          added back to all 11 of its state ints, so every iteration
//          depends on the last;
//   eq1  — one such chain.
//
// The output folds every stream (XOR), so nothing is dead code, and equals
// the TPU kernel's bit for bit.  Source ops per iteration and element: peak
// 64 (16 x mul, add, shift, add), eq 62 a chain (50 for the step, 11 adds
// and an AND for the feedback).  A source op is not a SASS instruction:
// r * a + b may issue as one IMAD, and a shift-add as one LEA.  On eq1 the
// critical path of an iteration is 27 source ops (four poles of 5 — sub,
// mul, add, shift, add — the output's 5 after the last pole, the AND and
// the feedback add); with one warp per scheduler its time per iteration
// over 27 is the cycles per dependent op that chip_smoke.py prices chains
// with.
//
// What bounds it on the H100: by design, the int32 issue rate (peak, and
// eq3 with enough warps) or the dependent latency (eq1 with few warps);
// bytes are 8 per thread.
#include <cuda_runtime.h>

#include "eq3.cuh"
#include "int32.cuh"

namespace {

__device__ int peak(int x, int iters) {
    int r[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) r[j] = x + j;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
            r[j] = add32(add32(mul32(r[j], 58361), 977) >> 3, r[j]);
    }
    int acc = r[0];
#pragma unroll
    for (int j = 1; j < 16; ++j) acc ^= r[j];
    return acc;
}

__device__ __forceinline__ void nudge(ThreeBand& s, int d) {
    s.fL0 = add32(s.fL0, d);
    s.fL1 = add32(s.fL1, d);
    s.fL2 = add32(s.fL2, d);
    s.fL3 = add32(s.fL3, d);
    s.fH0 = add32(s.fH0, d);
    s.fH1 = add32(s.fH1, d);
    s.fH2 = add32(s.fH2, d);
    s.fH3 = add32(s.fH3, d);
    s.h0 = add32(s.h0, d);
    s.h1 = add32(s.h1, d);
    s.h2 = add32(s.h2, d);
}

template <int NCH>
__device__ int eq(int x, int iters) {
    // the probe's coefficients (vpu_probe.py:45): the NTSC Y channel's
    const EqCoefs k = {56360, 28235, 65536, 8192, 9175};
    ThreeBand st[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) st[c].fill(x + c);
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) nudge(st[c], st[c].step(i, k) & 1);
    }
    // vpu_probe.py:90-93: channel 0's fL0, then every channel's other ten
    int acc = st[0].fL0;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        const ThreeBand& s = st[c];
        acc ^= s.fL1 ^ s.fL2 ^ s.fL3 ^ s.fH0 ^ s.fH1 ^ s.fH2 ^ s.fH3 ^ s.h0 ^
               s.h1 ^ s.h2;
    }
    return acc;
}

template <int PATTERN>
__global__ void probe_kernel(const int* __restrict__ x, int* __restrict__ out,
                             int n, int iters) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if constexpr (PATTERN == 0) {
        out[i] = peak(x[i], iters);
    } else if constexpr (PATTERN == 1) {
        out[i] = eq<3>(x[i], iters);
    } else {
        out[i] = eq<1>(x[i], iters);
    }
}

}  // namespace

// pattern: 0 peak, 1 eq3, 2 eq1; x, out int32 (n,); threads a block (128
// puts one warp on each scheduler of an SM that runs one block)
extern "C" int ntsc_probe(const void* x, void* out, int n, int pattern,
                          int iters, int threads, void* stream) {
    if (n < 1 || iters < 0 || threads < 32 || threads > 1024 ||
        threads % 32 != 0)
        return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    auto s = static_cast<cudaStream_t>(stream);
    auto xi = (const int*)x;
    auto o = (int*)out;
    switch (pattern) {
        case 0: probe_kernel<0><<<blocks, threads, 0, s>>>(xi, o, n, iters); break;
        case 1: probe_kernel<1><<<blocks, threads, 0, s>>>(xi, o, n, iters); break;
        case 2: probe_kernel<2><<<blocks, threads, 0, s>>>(xi, o, n, iters); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
