// K4 ccf_ema: the per-line colour-carrier EMA (crt_core.c:452-466), one
// block per batch entry, one walking thread per carrier phase class.
//
// Replaces: ntsc_crt_tpu/ops/pallas/ccf_scan.py::ccf_ema (kernel body
// _make_kernel).
//
// Line after line, the entry's carried state row vper[l] is folded with the
// line's m burst sample groups, ccr = ccr*127/128 + sample (C truncating
// division, int32 product wrapping), kept unchanged on an inactive line,
// written back, and emitted as ccr_l[l].  The CC phase classes never mix, so
// each class is its own chain: thread c holds column c of the (VP, CC) state
// in registers (VP <= 5, selected by unrolled compares, so no local memory).
//
// What bounds it on the H100: the serial chain of L*m dependent
// multiply-divide-adds per class (2,400 on NTSC), about five dependent
// integer instructions each, so latency and not bytes (~40 KB per entry).
// What the design does about it: the loads leave the chain.  All threads of
// the block stage CHUNK lines of samples, phases and activity flags into
// shared memory with coalesced loads, then the CC walkers fold from shared
// memory, so a step waits on arithmetic only.  One launch replaces the
// per-line torch loop (about 8.4k launches a step).  The TPU kernel's
// (L, ..., sub, LANE) relayouts are not carried over.
#include <cuda_runtime.h>

#include "int32.cuh"

namespace {

constexpr int MAX_VP = 5;
constexpr int MAX_CC = 5;
constexpr int MAX_M = 16;
constexpr int CHUNK = 32;    // lines staged per pass
constexpr int THREADS = 64;  // loaders; threads 0..CC-1 also walk

__global__ void __launch_bounds__(THREADS) ccf_ema_kernel(
    const int* __restrict__ per_cls,     // (B, L, m, CC) burst samples
    const int* __restrict__ vper,        // (B, L) state row of each line
    const uint8_t* __restrict__ active,  // (B, L) bool
    const int* __restrict__ ccf0,        // (B, VP, CC) carried state
    int* __restrict__ ccf_f,             // (B, VP, CC) state after line L-1
    int* __restrict__ ccr_l,             // (B, L, CC) row after every line
    int L, int m, int VP, int CC) {
    __shared__ int s_per[CHUNK * MAX_M * MAX_CC];
    __shared__ int s_vp[CHUNK];
    __shared__ uint8_t s_act[CHUNK];
    const int b = blockIdx.x;
    const int c = threadIdx.x;
    const bool walker = c < CC;
    const int row = m * CC;  // ints per line
    const int* pb = per_cls + (long long)b * L * row;
    int st[MAX_VP];
#pragma unroll
    for (int v = 0; v < MAX_VP; ++v)
        st[v] = (walker && v < VP) ? ccf0[((long long)b * VP + v) * CC + c]
                                   : 0;
    for (int l0 = 0; l0 < L; l0 += CHUNK) {
        const int n = min(CHUNK, L - l0);
        __syncthreads();  // the walkers are done with the previous chunk
        for (int i = threadIdx.x; i < n * row; i += THREADS)
            s_per[i] = pb[(long long)l0 * row + i];
        for (int i = threadIdx.x; i < n; i += THREADS) {
            s_vp[i] = vper[(long long)b * L + l0 + i];
            s_act[i] = active[(long long)b * L + l0 + i];
        }
        __syncthreads();
        if (!walker) continue;
        for (int i = 0; i < n; ++i) {
            const int vp = s_vp[i];
            int r = st[0];
#pragma unroll
            for (int v = 1; v < MAX_VP; ++v)
                if (v == vp) r = st[v];
            if (s_act[i]) {
                const int* s = s_per + i * row + c;
                for (int k = 0; k < m; ++k)
                    r = add32(mul32(r, 127) / 128, s[k * CC]);
            }
#pragma unroll
            for (int v = 0; v < MAX_VP; ++v)
                if (v == vp) st[v] = r;
            ccr_l[((long long)b * L + l0 + i) * CC + c] = r;
        }
    }
    if (walker) {
#pragma unroll
        for (int v = 0; v < MAX_VP; ++v)
            if (v < VP) ccf_f[((long long)b * VP + v) * CC + c] = st[v];
    }
}

}  // namespace

// vper must lie in [0, VP): the wrapper's caller guarantees it.
extern "C" int ntsc_ccf_ema(const void* per_cls, const void* vper,
                            const void* active, const void* ccf0, void* ccf_f,
                            void* ccr_l, int B, int L, int m, int VP, int CC,
                            void* stream) {
    if (VP < 1 || VP > MAX_VP || CC < 1 || CC > MAX_CC || m < 1 ||
        m > MAX_M || B < 1 || L < 1)
        return (int)cudaErrorInvalidValue;
    ccf_ema_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        (const int*)per_cls, (const int*)vper, (const uint8_t*)active,
        (const int*)ccf0, (int*)ccf_f, (int*)ccr_l, L, m, VP, CC);
    return (int)cudaGetLastError();
}
