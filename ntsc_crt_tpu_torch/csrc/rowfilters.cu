// K7 iir_lowpass_rows and K8 eq_threeband_rows: a serial integer filter
// marched along each row of an int32 (R, T) block, state reset at t = 0.
//
// Replaces: ntsc_crt_tpu/ops/pallas/filters_pallas.py::iir_lowpass_rows
// (_iir_kernel: h += ((s - h) * c) >> 11, crt_ntsc.c:117-126) and
// ::eq_threeband_rows (_eq_kernel: the 3-band eqf(), crt_core.c:206-233,
// shared with K2 through eq3.cuh).  Every row has its own coefficients.
//
// What bounds it on the H100: each row is one dependent chain along t — 4
// source ops a step for the IIR (sub, mul, shift, add); for the 3-band EQ
// each pole carries its own 5-op recurrence (sub, mul, add, shift, add) and
// the 8 poles pipeline, so its chain is 5 a step plus the 25 of the first
// output — so a row takes at least that chain x (cycles per dependent op);
// bytes are 8 a sample (int32 in and out).  Many rows in flight hide the
// chain: with enough warps the card's int32 issue rate (3-band: ~50 ops a
// sample) or its memory rate (the IIR) is the bound.
//
// Design: one thread per row, the state in registers.  A thread reading its
// own row would make a warp's 32 loads hit 32 rows (32 cache lines a
// sample); instead each warp stages a 32-row x 32-sample tile through
// shared memory — loaded and stored a row at a time, 128 contiguous bytes a
// warp access — and each thread marches its row across the tile, in place.
// For the IIR the next tile's loads are issued into registers before the
// march, so they overlap it (PREFETCH).  The tile's row pitch is 33 ints,
// so the march's column reads and writes hit 32 different banks.  The TPU
// kernel's (sub, LANE) row tiling, time blocks and K-step unroll exist for
// the TPU's vector unit and are not carried over.
#include <cuda_runtime.h>

#include "eq3.cuh"
#include "int32.cuh"

namespace {

constexpr int TILE = 32;   // rows of a warp, samples of a tile
constexpr int WARPS = 4;   // warps of a block
constexpr int EXP_P = 11;  // crt_ntsc.c:89

// PREFETCH: load the next tile into 32 registers while this one is marched.
// The IIR's march (4 ops a sample) is short, so it would wait on the loads;
// the 3-band march (~50 ops a sample) hides them, and there the staging
// registers cost more than the overlap gains, so it loads straight into
// the tile (both measured on the H100, PERF.md).
struct Iir {
    static constexpr bool PREFETCH = true;
    struct Ptrs {
        const int* c;
    };
    int c, h;

    __device__ void load(const Ptrs& p, long long row) {
        c = p.c[row];
        h = 0;
    }

    __device__ int step(int s) {
        h = add32(h, mul32(sub32(s, h), c) >> EXP_P);
        return h;
    }
};

struct Eq3 {
    static constexpr bool PREFETCH = false;
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

template <class F>
__global__ void rows_kernel(const int* __restrict__ x, int* __restrict__ y,
                           long long R, int T, typename F::Ptrs coefs) {
    __shared__ int tiles[WARPS][TILE][TILE + 1];
    const int lane = threadIdx.x % TILE;
    const int warp = threadIdx.x / TILE;
    const long long row0 = ((long long)blockIdx.x * WARPS + warp) * TILE;
    if (row0 >= R) return;  // the whole warp leaves together
    const int nrows = (int)min((long long)TILE, R - row0);
    const bool live = lane < nrows;
    int(*tile)[TILE + 1] = tiles[warp];
    F f;
    if (live) f.load(coefs, row0 + lane);
    // nx[r]: sample t0 + lane of row row0 + r, for the tile at t0
    int nx[TILE];
    auto fetch = [&](int t0) {
        const int n = min(TILE, T - t0);
#pragma unroll
        for (int r = 0; r < TILE; ++r)
            nx[r] = (r < nrows && lane < n) ? x[(row0 + r) * T + t0 + lane]
                                            : 0;
    };
    if constexpr (F::PREFETCH) fetch(0);
    for (int t0 = 0; t0 < T; t0 += TILE) {
        const int n = min(TILE, T - t0);
        if constexpr (F::PREFETCH) {
#pragma unroll
            for (int r = 0; r < TILE; ++r) tile[r][lane] = nx[r];
            __syncwarp();
            // the next tile's loads fly while this one is marched
            if (t0 + TILE < T) fetch(t0 + TILE);
        } else {
            if (lane < n) {
                for (int r = 0; r < nrows; ++r)
                    tile[r][lane] = x[(row0 + r) * T + t0 + lane];
            }
            __syncwarp();
        }
        if (live) {
            if (n == TILE) {
#pragma unroll
                for (int k = 0; k < TILE; ++k)
                    tile[lane][k] = f.step(tile[lane][k]);
            } else {
                for (int k = 0; k < n; ++k)
                    tile[lane][k] = f.step(tile[lane][k]);
            }
        }
        __syncwarp();
        if (lane < n) {
            for (int r = 0; r < nrows; ++r)
                y[(row0 + r) * T + t0 + lane] = tile[r][lane];
        }
        __syncwarp();
    }
}

template <class F>
int launch(const void* x, void* y, int R, int T, typename F::Ptrs coefs,
           void* stream) {
    if (R < 0 || T < 0) return (int)cudaErrorInvalidValue;
    if (R == 0 || T == 0) return (int)cudaSuccess;
    const int rows_per_block = WARPS * TILE;
    const unsigned blocks = (unsigned)((R + rows_per_block - 1) / rows_per_block);
    rows_kernel<F><<<blocks, WARPS * TILE, 0,
                     static_cast<cudaStream_t>(stream)>>>(
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
