// K4 ccf_ema: the per-line colour-carrier EMA (crt_core.c:452-466), one
// warp per batch entry, lane c walking carrier phase class c.
//
// Replaces: ntsc_crt_tpu/ops/pallas/ccf_scan.py::ccf_ema (kernel body
// _make_kernel).
//
// Line after line, the entry's carried state row vper[l] is folded with the
// line's m burst sample groups, ccr = ccr*127/128 + sample (C truncating
// division, int32 product wrapping), kept unchanged on an inactive line,
// written back, and emitted as ccr_l[l].  The CC phase classes never mix, so
// each class is its own chain: lane c holds column c of the (VP, CC) state
// in registers (VP <= 5, a template argument, so no local memory).
//
// What bounds it on the H100: the serial chain of L*m dependent
// multiply-divide-adds per class (2,400 on NTSC), latency and not bytes
// (~40 KB per entry).  A fold step is four dependent instructions (IMAD by
// 127; the truncating /128 as SHF, LEA.HI and a LEA.HI.SX32 that also adds
// the sample; SASS of ccf_ema_kernel<1, 10, 4>).
//
// What the design does about it:
// - The loads overlap the fold.  The entry's per_cls rows and vper stream
//   through three shared-memory stages of CHUNK lines, filled with cp.async
//   by the same warp: while the lanes fold chunk k, chunks k+1 and k+2 are
//   in flight.  No block barrier; the one wait a chunk
//   (cp.async.wait_group) finds chunk k+1 long landed.
// - Only arithmetic is on a class's chain.  Before it folds line l, a lane
//   has line l+1's m samples and state row in registers, and the chunk's
//   activity flags are one ballot, so a line is its m fold steps and two
//   selects.  The row a line reads is the previous line's result when the
//   rows match, else a register not written since, selected off the chain.
// - The per-line loop holds no warp-collective op (each in a per-line
//   branch costs a convergence barrier every line), and m and CC are
//   compile-time for the systems' 10 x 4 and 10 x 5, so the lanes' shared
//   offsets are immediates; unrolled by two lines, so no register copies.
// - One launch replaces the per-line torch loop (about 8.4k launches a
//   step).  The TPU kernel's (L, ..., sub, LANE) relayouts are not carried
//   over.
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"
#include "int32.cuh"

namespace {

constexpr int MAX_VP = 5;
constexpr int MAX_CC = 5;
constexpr int MAX_M = 16;
constexpr int CHUNK = 32;  // lines a stage holds: a flag a lane
constexpr int NSTAGE = 3;  // chunk k folds while k+1 and k+2 are in flight
constexpr unsigned FULL = 0xffffffffu;

// Issues the copies of chunk k into its stage (of NSTAGE, `stage` ints
// each): the entry's rows (`row` ints a line) and, after them, the chunk's
// CHUNK state rows (vper; 0 past L).  One commit group a call, empty past
// the last chunk.
__device__ __forceinline__ void stage_in(int* __restrict__ smem,
                                         const int* __restrict__ pb,
                                         const int* __restrict__ vp_b, int k,
                                         int L, int row, int stage, bool vec,
                                         int lane) {
    const int l0 = k * CHUNK;
    if (l0 < L) {
        int* dst = smem + (k % NSTAGE) * stage;
        const int* src = pb + (long long)l0 * row;
        const int cnt = min(CHUNK, L - l0) * row;
        int i = 0;
        if (vec) {
            for (int v = lane; v < cnt / 4; v += 32)
                cp_async16(dst + 4 * v, src + 4 * v);
            i = cnt & ~3;
        }
        for (i += lane; i < cnt; i += 32) cp_async4_zfill(dst + i, src + i, true);
        const bool in = l0 + lane < L;
        cp_async4_zfill(dst + CHUNK * row + lane, vp_b + (in ? l0 + lane : 0),
                        in);
    }
    cp_async_commit();
}

// M > 0: m == M and CC == CCT, known at compile time (the lanes' shared
// memory offsets become immediates); M == 0: any m <= MAX_M and CC.
template <int VP, int M, int CCT>
__global__ void __launch_bounds__(32) ccf_ema_kernel(
    const int* __restrict__ per_cls,     // (B, L, m, CC) burst samples
    const int* __restrict__ vper,        // (B, L) state row of each line
    const uint8_t* __restrict__ active,  // (B, L) bool
    const int* __restrict__ ccf0,        // (B, VP, CC) carried state
    int* __restrict__ ccf_f,             // (B, VP, CC) state after line L-1
    int* __restrict__ ccr_l,             // (B, L, CC) row after every line
    int L, int m, int CC_) {
    const int CC = CCT ? CCT : CC_;
    // NSTAGE stages x CHUNK x (m*CC samples + 1 state row) ints
    extern __shared__ int4 smem4[];
    int* smem = reinterpret_cast<int*>(smem4);
    constexpr int NM = M ? M : MAX_M;
    const int mm = M ? M : m;
    const int lane = threadIdx.x;
    const int c = min(lane, CC - 1);  // lanes past CC repeat class CC-1
    const bool walker = lane < CC;
    const int b = blockIdx.x;
    const int row = mm * CC;  // sample ints a line
    const int stage = CHUNK * (row + 1);
    const int* pb = per_cls + (long long)b * L * row;
    const int* vp_b = vper + (long long)b * L;
    const uint8_t* act_b = active + (long long)b * L;
    int* out_l = ccr_l + (long long)b * L * CC + c;  // line 0, class c
    const bool vec = (reinterpret_cast<uintptr_t>(pb) & 15) == 0 &&
                     (row & 3) == 0;

    int st[VP];
#pragma unroll
    for (int v = 0; v < VP; ++v)
        st[v] = ccf0[((long long)b * VP + v) * CC + c];

    stage_in(smem, pb, vp_b, 0, L, row, stage, vec, lane);
    stage_in(smem, pb, vp_b, 1, L, row, stage, vec, lane);
    cp_async_wait<1>();
    __syncwarp();
    // the samples and state row of the line being folded
    int cur[NM];
#pragma unroll
    for (int k = 0; k < NM; ++k) cur[k] = (M || k < mm) ? smem[k * CC + c] : 0;
    int vp = smem[CHUNK * row];
    // the row of the line before, not yet written back into st[]
    int pend_v = -1, pend_r = 0;
    int anext = lane < L ? act_b[lane] : 0;  // lane i: line i's flag

    for (int k = 0; k * CHUNK < L; ++k) {
        // chunk k+2 takes chunk k-1's stage, which every lane is done
        // with; chunk k+1 lands before the last line of chunk k preloads
        // from it
        __syncwarp();
        stage_in(smem, pb, vp_b, k + 2, L, row, stage, vec, lane);
        const unsigned amask = __ballot_sync(FULL, anext != 0);
        const int g0 = k * CHUNK, n = min(CHUNK, L - g0);
        anext = g0 + CHUNK + lane < L ? act_b[g0 + CHUNK + lane] : 0;
        cp_async_wait<1>();
        __syncwarp();
        const int* sk = smem + (k % NSTAGE) * stage;
        const int* sk1 = smem + ((k + 1) % NSTAGE) * stage;
        // line g0+i: fold `cur` while line g0+i+1's samples and state row
        // land in `nxt` and vp
#pragma unroll 2
        for (int i = 0; i < n; ++i) {
            const int v_g = vp;
            int nxt[NM];
            // the row this line reads unless the last line wrote the same
            int cand = st[0];
#pragma unroll
            for (int v = 1; v < VP; ++v)
                if (v == v_g) cand = st[v];
            {  // past the last line these read stale words: unused
                const bool last = i == CHUNK - 1;
                const int* sp = last ? sk1 : sk + (i + 1) * row;
#pragma unroll
                for (int q = 0; q < NM; ++q)
                    nxt[q] = (M || q < mm) ? sp[q * CC + c] : 0;
                vp = last ? sk1[CHUNK * row] : sk[CHUNK * row + i + 1];
            }
            const int r_in = v_g == pend_v ? pend_r : cand;
#pragma unroll
            for (int v = 0; v < VP; ++v)
                if (v == pend_v) st[v] = pend_r;
            // the fold: ccr' = ccr * 127 / 128 + s, C truncation, wrapping
            int r = r_in;
#pragma unroll
            for (int q = 0; q < NM; ++q)
                if (M || q < mm) r = add32(mul32(r, 127) / 128, cur[q]);
            const int r_out = (amask >> i) & 1u ? r : r_in;
            if (walker) *out_l = r_out;
            out_l += CC;
            pend_v = v_g;
            pend_r = r_out;
#pragma unroll
            for (int q = 0; q < NM; ++q) cur[q] = nxt[q];
        }
    }
#pragma unroll
    for (int v = 0; v < VP; ++v)
        if (v == pend_v) st[v] = pend_r;
    if (walker) {
#pragma unroll
        for (int v = 0; v < VP; ++v)
            ccf_f[((long long)b * VP + v) * CC + lane] = st[v];
    }
}

template <int VP>
void launch_vp(int m, int CC, dim3 grid, size_t smem, cudaStream_t st,
               const int* per_cls, const int* vper, const uint8_t* active,
               const int* ccf0, int* ccf_f, int* ccr_l, int L) {
    // every system's burst is 40 or 50 samples over 4 or 5 classes
    if (m == 10 && CC == 4)
        ccf_ema_kernel<VP, 10, 4><<<grid, 32, smem, st>>>(
            per_cls, vper, active, ccf0, ccf_f, ccr_l, L, m, CC);
    else if (m == 10 && CC == 5)
        ccf_ema_kernel<VP, 10, 5><<<grid, 32, smem, st>>>(
            per_cls, vper, active, ccf0, ccf_f, ccr_l, L, m, CC);
    else
        ccf_ema_kernel<VP, 0, 0><<<grid, 32, smem, st>>>(
            per_cls, vper, active, ccf0, ccf_f, ccr_l, L, m, CC);
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
    // <= 32 KB: no opt-in above 48 KB needed
    const size_t smem = NSTAGE * CHUNK * (m * CC + 1) * sizeof(int);
    const auto fn = VP == 1   ? launch_vp<1>
                    : VP == 2 ? launch_vp<2>
                    : VP == 3 ? launch_vp<3>
                    : VP == 4 ? launch_vp<4>
                              : launch_vp<5>;
    fn(m, CC, dim3(B), smem, static_cast<cudaStream_t>(stream),
       (const int*)per_cls, (const int*)vper, (const uint8_t*)active,
       (const int*)ccf0, (int*)ccf_f, (int*)ccr_l, L);
    return (int)cudaGetLastError();
}
