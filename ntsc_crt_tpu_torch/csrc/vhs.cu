// K5 vhs_region_b_entries: the crt_rand march of the VHS tracking noise's
// region B (crt_core.c:343-357), one warp per batch entry walking batches
// of LCG positions, every window of a batch at once.
//
// Replaces: ntsc_crt_tpu/ops/pallas/vhs_scan.py::vhs_region_b_entries
// (kernel body _kernel).
//
// In region B the number of crt_rand() calls per sample depends on the
// first draw (C's && short circuit): from st, st2 = st*A^2 + C2 (two calls)
// and st3 = st*A^3 + C3 (three); the third call happens when m1*H + t >
// 19H - 1 with m1 = (st2 >> 1) % 20.  Every step emits its ENTRY state; the
// caller derives all noise values from those in parallel.
//
// The fact the design rests on: both moves are jumps along one LCG orbit,
// so the entry state of step t is x_p = LCG^p(st0) at a position p that
// grows by 2 or 3 a step.  In band k (steps [kH, (k+1)H)) the test is
// m1 >= 19 - k whatever t is inside the band, and from t = 19H on it always
// passes, so inside a band the move is a function of the position alone:
// p -> p + 2 + [(x_{p+2} >> 1) % 20 >= 19 - k].  A walk enters each window
// of 32 positions at offset 0, 1 or 2, so a window's walk from each of the
// three entries can be taken before the true entry is known.
//
// What bounds it on the H100: the walk, n_steps = 19*H dependent steps
// (17,290 on NTSC) for each entry, whose stores (4 bytes a step) are far
// below the memory's rate.
//
// What the design does about it: a batch is ten windows from the walk's
// position P.
// - Lane l draws the three-call bit of position P + 32i + l for each window
//   i (a multiply-add by A^32 a window), one ballot a window.
// - Lane 3i + d walks window i from entry offset d, 16 predicated steps of
//   bit = R & 1, R = (R >> 2) >> bit: all 30 walks at once.
// - The true entries follow window by window: one shuffle each (lane 3i +
//   d gives window i's visited bits and its exit, the next window's d).
// - The visited lanes store their x at consecutive steps (a prefix
//   popcount), one predicated store each: the (B, n_steps) layout keeps an
//   entry's steps contiguous.  A band that ends inside the batch keeps its
//   first steps and restarts the walk at the visited position after them,
//   with the next band's threshold.
// A batch of ~130 steps costs ~1,450 cycles on an H100 80GB HBM3 (PERF.md):
// its ballots, walks and ten shuffles wait on each other, and the next
// batch waits on its position.  Tried (PERF.md): the walk on one
// 32-bit view in groups of ten steps (2 dependent ops a step, but run on the
// uniform datapath at ~31 cycles a step), and this design with each store a
// branch (a convergence barrier between the chain's shuffles): 2.8x and
// 1.5x slower.  The TPU kernel's time blocks, sublane tiles and padding are
// not carried over.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // entries per block
constexpr unsigned FULL = 0xffffffffu;

// crt_rand (ops/lcg.py): state = state*A1 + C1.  Unsigned arithmetic wraps
// mod 2^32.
constexpr unsigned A1 = 1103515245u;
constexpr unsigned C1 = 12345u;

struct Jump {  // n calls composed: x -> a*x + c
    unsigned a, c;
};

constexpr Jump calls(int n) {
    Jump j{1u, 0u};
    for (int i = 0; i < n; ++i) j = {j.a * A1, j.c * A1 + C1};
    return j;
}

constexpr Jump J2 = calls(2);
constexpr Jump J32 = calls(32);

constexpr int NWIN = 10;  // windows a batch: three entry offsets each

__device__ __forceinline__ unsigned jump(Jump j, unsigned x) {
    return j.a * x + j.c;
}

// m1 of the step that enters at position p, from z = x_{p+2}
__device__ __forceinline__ unsigned draw(unsigned z) { return (z >> 1) % 20u; }

// *p = v where `on`, as one predicated store: a branch around it would put
// a convergence barrier before the next warp-collective op
__device__ __forceinline__ void store_if(int* p, int v, bool on) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
        " @q st.global.b32 [%0], %1;\n}\n" ::"l"(p),
        "r"(v), "r"((int)on)
        : "memory");
#else
    if (on) *p = v;
#endif
}

__global__ void __launch_bounds__(32 * WARPS)
    vhs_region_b_kernel(const int* __restrict__ st0,  // (B,)
                        int* __restrict__ out,        // (B, n_steps)
                        int B, int n_steps, int H) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;  // the whole warp: b is the warp's
    int* dst = out + (long long)b * n_steps;
    Jump mine{1u, 0u};
    for (int i = 0; i < lane; ++i) mine = {mine.a * A1, mine.c * A1 + C1};
    const unsigned below = (1u << lane) - 1u;
    // lane h walks window h / 3 of a batch from entry offset h % 3
    const int wi = lane / 3, dh = lane % 3;
    unsigned xP = (unsigned)st0[b];  // the state at the batch's first position
    int t = 0;
    for (int k = 0; t < n_steps; ++k) {
        const unsigned thr = k < 19 ? 19u - k : 0u;
        const int end = k < 19 ? min((k + 1) * H, n_steps) : n_steps;
        while (t < end) {
            const int rem = end - t;
            // lane l: x at positions P + 32i + l; the window's three-call bits
            unsigned x = jump(mine, xP), xs[NWIN], myW = 0;
#pragma unroll
            for (int i = 0; i < NWIN; ++i) {
                xs[i] = x;
                const unsigned Wi =
                    __ballot_sync(FULL, draw(jump(J2, x)) >= thr);
                myW = i == wi ? Wi : myW;
                x = jump(J32, x);
            }
            // every hypothesis's walk through its window
            unsigned R = myW >> dh, p = dh, V = 0;
#pragma unroll
            for (int s = 0; s < 16; ++s) {
                const bool on = p < 32;
                const unsigned bit = R & 1u;
                V |= on ? 1u << p : 0u;
                p += on ? 2u + bit : 0u;
                R = (R >> 2) >> bit;
            }
            const int ex = (int)p - 32;
            // the true entries, window by window: one shuffle each on the
            // chain, the visited bits beside it
            int d = 0;
            unsigned Vs[NWIN];
#pragma unroll
            for (int i = 0; i < NWIN; ++i) {
                const int src = 3 * i + d;
                Vs[i] = __shfl_sync(FULL, V, src);
                d = __shfl_sync(FULL, ex, src);
            }
            // stores of the band's steps (no collective among them); the
            // band's next entry is the visited position of rank rem
            int cum = 0;
            unsigned cand = 0;
            bool hit = false;
#pragma unroll
            for (int i = 0; i < NWIN; ++i) {
                const bool vis = (Vs[i] >> lane) & 1u;
                const int r = cum + __popc(Vs[i] & below);
                store_if(dst + t + r, (int)xs[i], vis && r < rem);
                hit = hit || (vis && r == rem);
                cand = vis && r == rem ? xs[i] : cand;
                cum += __popc(Vs[i]);
            }
            const unsigned hits = __ballot_sync(FULL, hit);
            const unsigned xe = __shfl_sync(FULL, x, d);
            const unsigned xh = __shfl_sync(FULL, cand, __ffs(hits) - 1);
            xP = hits ? xh : xe;
            t += min(cum, rem);
        }
    }
}

}  // namespace

extern "C" int ntsc_vhs_region_b_entries(const void* st0, void* out, int B,
                                         int n_steps, int H, void* stream) {
    if (B < 1 || n_steps < 1 || H < 1 ||
        20LL * H + n_steps >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const int blocks = (B + WARPS - 1) / WARPS;
    vhs_region_b_kernel<<<blocks, 32 * WARPS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        (const int*)st0, (int*)out, B, n_steps, H);
    return (int)cudaGetLastError();
}
