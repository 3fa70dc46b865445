// K5 vhs_region_b_entries: the crt_rand march of the VHS tracking noise's
// region B (crt_core.c:343-357), one batch entry per thread.
//
// Replaces: ntsc_crt_tpu/ops/pallas/vhs_scan.py::vhs_region_b_entries
// (kernel body _kernel).
//
// In region B the number of crt_rand() calls per sample depends on the
// first draw (C's && short circuit), so the state is a serial recurrence:
// from st, st2 = st*A^2 + C2 (two calls) and st3 = st*A^3 + C3 (three); the
// third call happens when m1*H + t > 19H - 1 with m1 = (st2 >> 1) % 20.
// Every step emits its ENTRY state; the caller derives all noise values
// from those in parallel.
//
// What bounds it on the H100: the chain of n_steps = 19*H dependent steps
// (17,290 on NTSC), each about eight dependent integer instructions (two
// multiply-adds in parallel, shift, the % 20 as multiply-high and
// multiply-subtract, the test's multiply-add, compare, select).  Bytes are
// 4 per step and entry, stored off the chain.  At batch 1 one thread walks
// the whole chain, so the kernel is pure latency.  What the design does
// about it: nothing beyond keeping the chain in registers and the stores
// off it; the (n_steps, B) layout makes the stores of a warp coalesced.  The
// TPU kernel's time blocks, sublane tiles and padding are not carried over.
#include <cuda_runtime.h>

namespace {

// crt_rand (ops/lcg.py): state = state*A1 + C1; A2/C2 and A3/C3 are two and
// three calls composed.  Unsigned arithmetic wraps mod 2^32.
constexpr unsigned A1 = 1103515245u;
constexpr unsigned C1 = 12345u;
constexpr unsigned A2 = A1 * A1;
constexpr unsigned C2 = A1 * C1 + C1;
constexpr unsigned A3 = A2 * A1;
constexpr unsigned C3 = A1 * C2 + C1;

__global__ void vhs_region_b_kernel(const int* __restrict__ st0,  // (B,)
                                    int* __restrict__ out,  // (n_steps, B)
                                    int B, int n_steps, int H) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int lim = 19 * H - 1;
    unsigned st = (unsigned)st0[b];
    for (int t = 0; t < n_steps; ++t) {
        out[(long long)t * B + b] = (int)st;
        const unsigned st2 = st * A2 + C2;
        const unsigned st3 = st * A3 + C3;
        const int m1 = (int)((st2 >> 1) % 20u);
        st = (m1 * H + t > lim) ? st3 : st2;
    }
}

}  // namespace

extern "C" int ntsc_vhs_region_b_entries(const void* st0, void* out, int B,
                                         int n_steps, int H, void* stream) {
    if (B < 1 || n_steps < 1 || H < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = 32;  // one warp a block spreads the chains over SMs
    const int blocks = (B + threads - 1) / threads;
    vhs_region_b_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        (const int*)st0, (int*)out, B, n_steps, H);
    return (int)cudaGetLastError();
}
