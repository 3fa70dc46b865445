// K7 iir_lowpass_rows and K8 eq_threeband_rows: a serial integer filter
// marched along each row of an int32 (R, T) block, state reset at t = 0.
//
// Replaces: ntsc_crt_tpu/ops/pallas/filters_pallas.py::iir_lowpass_rows
// (_iir_kernel: h += ((s - h) * c) >> 11, crt_ntsc.c:117-126) and
// ::eq_threeband_rows (_eq_kernel: the 3-band eqf(), crt_core.c:206-233,
// shared with K2 through eq3.cuh).  Every row has its own coefficients.
//
// What bounds it on the H100: bytes, 8 a sample (int32 in and out), once
// enough rows are in flight.  Each row is one dependent chain along t that
// truncates on every sample, so a row cannot be split: one lane marches one
// row.  At batch 1 (~720 rows: 23 warps, one an SM) a warp's own issue
// bounds it: an SM sub-partition issues int32 at 16 lanes a cycle, so a
// warp's int32 instruction takes 2 cycles, and K8's chain is ~34 of them a
// sample.
//
// Design: one warp a block, 32 rows a warp, one lane a row, the state in
// registers.  The warp streams its rows through a ring of RING tiles of 32
// rows x one 128-byte line in shared memory, one commit group of cp.async
// copies a tile; while one tile is marched the next RING - 1 are in flight,
// and the copies hold no registers.  Row r's tile k is the line holding its
// samples [k * LINE - o_r, (k + 1) * LINE - o_r), o_r the row start's
// offset from its line in y: a row of odd T starts anywhere in a line, and
// row segments that straddle two lines copied at about half the rate of
// whole lines (PERF.md §6).  So every copy and store is whole aligned
// 16-byte granules, 4 rows a warp instruction (where x sits off y's line
// grid, the copies are 4-byte and zero-filled, and only the stores are
// whole granules).  A line's samples before the row start are zeroed before
// the march (zeros keep either filter in its reset state), those past its
// end are marched and never stored; the tiles inside every row store
// without a test, and the granules a row shares with a neighbour at its
// ends are stored a sample at a time.  The march reads and writes
// 16-byte granules of its row in place; a tile row's pitch of 36 words puts
// each quarter warp's 8 granules on 8 distinct bank groups.  The TPU
// kernel's (sub, LANE) row tiling, time blocks and K-step unroll exist for
// the TPU's vector unit and are not carried over.  The line-aligned tiles,
// the 16-byte granules, the ring's depth and the untested inner stores
// were chosen by design runs on the card (chip_smoke.time_variants); every
// design tried and its times are in PERF.md §6.
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"
#include "eq3.cuh"
#include "int32.cuh"

namespace {

constexpr int ROWS = 32;           // rows of a warp, one lane each
constexpr int LINE = 32;           // samples of a 128-byte line: a tile row
constexpr int RING = 4;            // tiles of a warp's ring
constexpr int PITCH = LINE + 4;    // words of a tile row in shared memory
constexpr int GRAN = LINE / 4;     // 16-byte granules of a tile row
constexpr int STRIDE = ROWS / GRAN;  // rows between a lane's granules
constexpr int EXP_P = 11;          // crt_ntsc.c:89

struct Iir {
    struct Ptrs {
        const int* c;
    };
    int c, nc, h;  // nc = -c

    __device__ void load(const Ptrs& p, long long row) {
        c = p.c[row];
        nc = sub32(0, c);
        h = 0;
    }

    // (s - h) * c as s * c + h * (-c): the same int32 value, with s * c off
    // the dependent chain, which keeps one multiply-add and the shift-add
    __device__ int step(int s) {
        h = add32(h, add32(mul32(s, c), mul32(h, nc)) >> EXP_P);
        return h;
    }
};

struct Eq3 {
    struct Ptrs {
        const int *lf, *hf, *g0, *g1, *g2;
    };
    EqCoefs c;
    ThreeBand st;

    __device__ void load(const Ptrs& p, long long row) {
        c = EqCoefs{p.lf[row], p.hf[row], p.g0[row], p.g1[row], p.g2[row]};
        st.reset();
    }

    __device__ int step(int s) { return st.step(s, c); }
};

// VEC: x lies on y's line grid, so the copies are whole 16-byte granules
template <class F, bool VEC>
__global__ void __launch_bounds__(ROWS)
    rows_kernel(const int* __restrict__ x, int* __restrict__ y, long long R,
                int T, typename F::Ptrs coefs) {
    __shared__ __align__(16) int ring[RING][ROWS][PITCH];
    const int lane = threadIdx.x;
    const long long row0 = (long long)blockIdx.x * ROWS;
    const int nrows = (int)min((long long)ROWS, R - row0);
    const int* src = x + row0 * T;
    int* dst = y + row0 * T;
    // o_r for row r of the warp, from y's address of row 0
    const unsigned tm = (unsigned)T % LINE;
    const unsigned o0 = (unsigned)(reinterpret_cast<uintptr_t>(dst) / 4) % LINE;
    auto start = [&](int r) { return (int)((o0 + (unsigned)r * tm) % LINE); };
    const int my_o = start(lane);
    const int omax = (int)__reduce_max_sync(0xffffffffu,
                                            lane < nrows ? my_o : 0);
    const int ntiles = (int)(((long long)T + omax + LINE - 1) / LINE);
    // this lane's granule g of rows rq + STRIDE * i: o_r, and the offset of
    // the granule's first sample in tile 0 from the row block's start
    const int g = lane % GRAN, rq = lane / GRAN;
    int ro[GRAN];
    long long go[GRAN];
#pragma unroll
    for (int i = 0; i < GRAN; ++i) {
        const int r = rq + STRIDE * i;
        ro[i] = start(r);
        go[i] = (long long)r * T - ro[i] + 4 * g;
    }

    // tile k's copies into `slot`, one commit group (an empty one past the
    // last tile, so that the group count stays one a tile)
    auto fill = [&](int k, int slot) {
        if (k < ntiles) {
            if constexpr (VEC) {
#pragma unroll
                for (int i = 0; i < GRAN; ++i) {
                    // a line inside the tensor whenever it holds a sample
                    // of its row
                    const bool in =
                        rq + STRIDE * i < nrows && k * LINE - ro[i] < T;
                    cp_async16_zfill(&ring[slot][rq + STRIDE * i][4 * g],
                                     in ? src + go[i] + k * LINE : x, in);
                }
            } else {  // a sample a lane, zeros outside the row
                const int* p = src;
                unsigned o = o0;
#pragma unroll 4
                for (int r = 0; r < ROWS; ++r) {
                    const int t = k * LINE + lane - (int)o;
                    const bool in = (unsigned)t < (unsigned)T && r < nrows;
                    cp_async4_zfill(&ring[slot][r][lane], in ? p + t : x,
                                    in);
                    p += T;
                    o = (o + tm) % LINE;
                }
            }
        }
        cp_async_commit();
    };
#pragma unroll
    for (int k = 0; k < RING - 1; ++k) fill(k, k);
    F f;  // a row past R marches row R - 1's coefficients
    f.load(coefs, min(row0 + lane, R - 1));

    int s = 0;  // tile k's slot; slot s - 1 (mod RING) is free
    for (int k = 0; k < ntiles; ++k) {
        fill(k + RING - 1, s == 0 ? RING - 1 : s - 1);
        cp_async_wait<RING - 1>();  // tile k has landed
        __syncwarp();               // every lane's copies, seen by the warp
        int(*tile)[PITCH] = ring[s];
        if (k == 0) {  // the line before the row start: zeros
            for (int i = 0; i < my_o; ++i) tile[lane][i] = 0;
        }
#pragma unroll
        for (int q = 0; q < GRAN; ++q) {
            int4 v = *reinterpret_cast<int4*>(&tile[lane][4 * q]);
            v.x = f.step(v.x);
            v.y = f.step(v.y);
            v.z = f.step(v.z);
            v.w = f.step(v.w);
            *reinterpret_cast<int4*>(&tile[lane][4 * q]) = v;
        }
        __syncwarp();
        if (nrows == ROWS && k >= 1 && (k + 1) * LINE <= T) {
            // every granule of the tile inside its row: no test
#pragma unroll
            for (int i = 0; i < GRAN; ++i)
                *reinterpret_cast<int4*>(dst + go[i] + k * LINE) =
                    *reinterpret_cast<const int4*>(
                        &tile[rq + STRIDE * i][4 * g]);
        } else {
#pragma unroll
            for (int i = 0; i < GRAN; ++i) {
                const int r = rq + STRIDE * i;
                const int4 v = *reinterpret_cast<const int4*>(&tile[r][4 * g]);
                int* p = dst + go[i] + k * LINE;  // sample t0 of row r
                const int t0 = k * LINE - ro[i] + 4 * g;
                if (r >= nrows) continue;
                if (t0 >= 0 && t0 + 4 <= T) {
                    *reinterpret_cast<int4*>(p) = v;
                } else {  // a granule shared with a neighbouring row
                    if ((unsigned)t0 < (unsigned)T) p[0] = v.x;
                    if ((unsigned)(t0 + 1) < (unsigned)T) p[1] = v.y;
                    if ((unsigned)(t0 + 2) < (unsigned)T) p[2] = v.z;
                    if ((unsigned)(t0 + 3) < (unsigned)T) p[3] = v.w;
                }
            }
        }
        __syncwarp();  // the slot's reads are done before it is refilled
        s = s == RING - 1 ? 0 : s + 1;
    }
}

template <class F>
int launch(const void* x, void* y, int R, int T, typename F::Ptrs coefs,
           void* stream) {
    if (R < 0 || T < 0) return (int)cudaErrorInvalidValue;
    if (R == 0 || T == 0) return (int)cudaSuccess;
    const unsigned blocks = (unsigned)((R + ROWS - 1) / ROWS);
    const auto st = static_cast<cudaStream_t>(stream);
    const bool vec = (reinterpret_cast<uintptr_t>(x) -
                      reinterpret_cast<uintptr_t>(y)) % (4 * LINE) == 0;
    if (vec)
        rows_kernel<F, true><<<blocks, ROWS, 0, st>>>(
            (const int*)x, (int*)y, R, T, coefs);
    else
        rows_kernel<F, false><<<blocks, ROWS, 0, st>>>(
            (const int*)x, (int*)y, R, T, coefs);
    return (int)cudaGetLastError();
}

}  // namespace

// x, y int32 (R, T); c int32 (R,)
extern "C" int ntsc_iir_lowpass_rows(const void* x, const void* c, void* y,
                                     int R, int T, void* stream) {
    return launch<Iir>(x, y, R, T, Iir::Ptrs{(const int*)c}, stream);
}

// x, y int32 (R, T); lf, hf, g0, g1, g2 int32 (R,)
extern "C" int ntsc_eq_threeband_rows(const void* x, const void* lf,
                                      const void* hf, const void* g0,
                                      const void* g1, const void* g2, void* y,
                                      int R, int T, void* stream) {
    return launch<Eq3>(x, y, R, T,
                       Eq3::Ptrs{(const int*)lf, (const int*)hf,
                                 (const int*)g0, (const int*)g1,
                                 (const int*)g2},
                       stream);
}
