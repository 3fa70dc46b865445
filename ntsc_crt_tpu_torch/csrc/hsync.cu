// K3 hsync_chase: the serial per-line horizontal sync search
// (crt_core.c:434-450), one batch entry per thread.
//
// Replaces: ntsc_crt_tpu/ops/pallas/hsync_scan.py::hsync_chase (kernel
// bodies _make_kernel, word-packed, and _make_kernel_b, per-sample).
//
// For each line the thread sums the 2W-sample window that starts at
// hsync + c0, takes the first position whose running sum is <= thresh
// (2W if none), and moves the estimate by that offset minus W when the line
// is active.  The estimate chains line to line, so one entry is a strictly
// serial loop over L lines.
//
// What bounds it on the H100: the dependent chain of L window searches,
// each a load-use latency plus up to 2W adds; a handful of bytes per line
// are read, so bandwidth plays no part.  At batch 1 this is one thread —
// a pure latency kernel.
//
// Left for later: the ccf carrier EMA (ops/pallas/ccf_scan.py) walks the
// same lines right after this chase and still runs as a per-line torch loop;
// fusing it here removes ~8k small launches per step.  The TPU kernel's
// word packing, rebase and funnel exist only for the TPU's layout: here the
// window is a direct indexed load.
#include <cuda_runtime.h>

#include "int32.cuh"

namespace {

__global__ void hsync_chase_kernel(
    const int8_t* __restrict__ rows2,   // (B, L, HP) padded line rows
    const uint8_t* __restrict__ active, // (B, L) bool
    const int* __restrict__ hsync0,     // (B,)
    int* __restrict__ out,              // (B, L) estimate after each line
    int B, int L, int HP, int W, int c0, int thresh, int H) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int tW = 2 * W;
    int hs = hsync0[b];
    for (int l = 0; l < L; ++l) {
        const long long lb = (long long)b * L + l;
        const int8_t* row = rows2 + lb * HP;
        const int base = hs + c0;
        int run = 0, j = tW;
        for (int t = 0; t < tW; ++t) {
            const int x = base + t;
            run += (x >= 0 && x < HP) ? (int)row[x] : 0;
            if (run <= thresh) {
                j = t;
                break;
            }
        }
        int nxt = (j - W + hs) % H;  // POSMOD (crt_core.c:17)
        if (nxt < 0) nxt += H;
        if (active[lb]) hs = nxt;
        out[lb] = hs;
    }
}

}  // namespace

extern "C" int ntsc_hsync_chase(const void* rows2, const void* active,
                                const void* hsync0, void* out, int B, int L,
                                int HP, int W, int c0, int thresh, int H,
                                void* stream) {
    const int threads = 32;
    const int blocks = (B + threads - 1) / threads;
    hsync_chase_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        (const int8_t*)rows2, (const uint8_t*)active, (const int*)hsync0,
        (int*)out, B, L, HP, W, c0, thresh, H);
    return (int)cudaGetLastError();
}
