// K1 encode_rows: nearest-neighbour resample + RGB->YIQ + 1-pole IIR
// bandlimit + quadrature carrier + IRE scale/clamp, one picture row per
// lane.
//
// Replaces: ntsc_crt_tpu/ops/pallas/encode_fused.py::encode_fused_rows
// (kernel body _make_kernel), in its rgb=True, col_map form.  As there,
// every picture row has its own carrier tables: the SNES/TEMPLATE/PV1K and
// NESRGB encoders pick a row's table by its vertical phase class.
//
// What bounded the first design (one thread a row, reading and writing its
// own row) on the H100: its stores.  A thread wrote its row's destw int8
// samples one at a time and a warp's 32 lanes sat on 32 rows, so every warp
// store wrote 32 separate 32-byte sectors for 32 useful bytes: 0.24 ms at
// batch 64 (NTSC) and 1.9 ms at batch 512, ~47 G single-byte sector writes
// a second, 27x the kernel's bound (PERF.md).  The samples' work (~40 int32
// ops) and their chain (the IIR, 4 dependent ops a sample) are far below
// that.
//
// Design: a warp owns 32 picture rows, one lane a row, the IIR state in
// registers; one warp a block, so batch 1's 236 rows spread over 8 SMs.
// For each tile of S samples [t0, t0 + S), S = 64 (60 for 5-sample chroma):
// - the warp fetches each row's source pixels t*w/destw (3 bytes each) into
//   a shared-memory tile, consecutive lanes on consecutive samples, so a
//   warp load covers a few contiguous sectors of one image row, 8 rows'
//   loads in flight before the first is stored; the column map is computed
//   once a tile for all 32 rows;
// - each lane marches its row across the tile (no branch between a whole
//   tile's samples) and writes its int8 samples into a 32-row output tile,
//   which the warp writes out a row at a time (tile.cuh: store_rows).
//   NTSC's destw of 753 is odd, so rows are only byte-aligned: the lanes
//   store consecutive bytes, 32 of them one or two sectors; where destw % 4
//   == 0 they store 4-byte words.
// What bounds it now: at batch 1 and 64 one warp a scheduler, each tile's
// loads waited on 4 times and the march at well under an instruction a
// cycle; at batch 512 the int32 work.  The TPU kernel's chunking, (sub,
// LANE) tiling and unrolled col_map exist only for the TPU's vector unit
// and are not carried over.
#include <cuda_runtime.h>

#include <cstdint>

#include "int32.cuh"
#include "tile.cuh"

namespace {

constexpr int EXP_P = 11;

// Launched with one warp a block (WARP_ROWS threads), on picture rows
// 32*blockIdx.x ...
template <int CC>
__global__ void __launch_bounds__(WARP_ROWS) encode_rows_kernel(
    const uint8_t* __restrict__ img,   // (B, h, w, 3)
    const int* __restrict__ sy,        // (B, desth) source row per output row
    const int* __restrict__ modI,      // (B, desth, CC) carrier tables,
    const int* __restrict__ modQ,      // phase sign in; (B, desth, CC)
    const int* __restrict__ gain,      // (B,)
    const int* __restrict__ base,      // (B,)
    uint8_t* __restrict__ out,         // (B, desth, destw) int8
    int B, int h, int w, int desth, int destw, int xo_mod,
    int bandlimit, int cY, int cI, int cQ, bool words) {
    constexpr int S = CC == 4 ? 64 : 60;       // samples of a tile
    constexpr int NJ = 2;                      // of them a lane fetches
    static_assert(S % CC == 0 && S <= NJ * WARP_ROWS, "tile");
    constexpr int IPITCH = odd_pitch(3 * S);  // a row's source pixels
    constexpr int OPITCH = odd_pitch(S);      // a row's output samples
    __shared__ uint8_t itile[WARP_ROWS * IPITCH];
    __shared__ __align__(4) uint8_t otile[WARP_ROWS * OPITCH];
    __shared__ const uint8_t* srcs[WARP_ROWS];  // each row's image row

    const int lane = threadIdx.x;
    const long long r0 = (long long)blockIdx.x * WARP_ROWS;
    const int nrows =
        (int)min((long long)WARP_ROWS, (long long)B * desth - r0);
    // idle lanes of the last warp march a copy of its last row, unstored
    const long long row = r0 + min(lane, nrows - 1);
    const int b = (int)(row / desth);
    srcs[lane] = img + ((long long)b * h + sy[row]) * w * 3;
    // carrier tables rotated so that the in-tile phase below is static
    int mi[CC], mq[CC];
#pragma unroll
    for (int k = 0; k < CC; ++k) {
        mi[k] = modI[row * CC + (k + xo_mod) % CC];
        mq[k] = modQ[row * CC + (k + xo_mod) % CC];
    }
    const int g = gain[b];
    const int bs = base[b];
    const uint8_t* mine = itile + lane * IPITCH;  // this lane's pixels
    uint8_t* dst = otile + lane * OPITCH;         // and its samples
    int hy = 0, hi = 0, hq = 0;
    for (int t0 = 0; t0 < destw; t0 += S) {
        const int n = min(S, destw - t0);
        int off[NJ];  // source byte of samples t0 + lane + 32u, every row
#pragma unroll
        for (int u = 0; u < NJ; ++u) {
            const int j = lane + WARP_ROWS * u;
            off[u] = j < n ? 3 * (int)((long long)(t0 + j) * w / destw) : 0;
        }
        __syncwarp();  // srcs written; the last tile marched
        // BATCH rows' pixels in flight before the first is stored
        for (int q0 = 0; q0 < nrows; q0 += BATCH) {
            uint8_t v[BATCH][NJ][3];
#pragma unroll
            for (int e = 0; e < BATCH; ++e) {
                const uint8_t* src = srcs[min(q0 + e, nrows - 1)];
#pragma unroll
                for (int u = 0; u < NJ; ++u)
#pragma unroll
                    for (int c = 0; c < 3; ++c)
                        v[e][u][c] = lane + WARP_ROWS * u < n
                                         ? src[off[u] + c] : 0;
            }
#pragma unroll
            for (int e = 0; e < BATCH; ++e) {
                uint8_t* d = itile + (q0 + e) * IPITCH;
#pragma unroll
                for (int u = 0; u < NJ; ++u) {
                    const int j = lane + WARP_ROWS * u;
                    if (q0 + e < nrows && j < n) {
#pragma unroll
                        for (int c = 0; c < 3; ++c) d[3 * j + c] = v[e][u][c];
                    }
                }
            }
        }
        __syncwarp();
        // sample t0 + j, carrier phase k
        auto march = [&](int j, int k) {
            const uint8_t* px = mine + 3 * j;
            const int r = px[0], gg = px[1], bb = px[2];
            // crt_ntsc.c:307-310
            int vy = (19595 * r + 38470 * gg + 7471 * bb) >> 14;
            int vi = (39059 * r - 18022 * gg - 21103 * bb) >> 14;
            int vq = (13894 * r - 34275 * gg + 20382 * bb) >> 14;
            if (bandlimit) {  // crt_ntsc.c:117-126
                hy = add32(hy, mul32(sub32(vy, hy), cY) >> EXP_P);
                hi = add32(hi, mul32(sub32(vi, hi), cI) >> EXP_P);
                hq = add32(hq, mul32(sub32(vq, hq), cQ) >> EXP_P);
                vy = hy;
                vi = hi;
                vq = hq;
            }
            vi = mul32(vi, mi[k]) >> 4;  // crt_ntsc.c:316-317
            vq = mul32(vq, mq[k]) >> 4;
            const int ire =
                add32(bs, mul32(add32(add32(vy, vi), vq), g) >> 10);
            dst[j] = (uint8_t)(int8_t)clamp_int(ire, 0, 110);
        };
        // a whole tile without a branch between its samples
        if (n == S) {
            for (int j = 0; j < S; j += CC) {
#pragma unroll
                for (int k = 0; k < CC; ++k) march(j + k, k);
            }
        } else {
            for (int j = 0; j < n; j += CC) {
#pragma unroll
                for (int k = 0; k < CC; ++k)
                    if (j + k < n) march(j + k, k);
            }
        }
        store_rows(otile, OPITCH, out, destw, r0, nrows, t0, n, words);
    }
}

template <int CC>
int launch(const uint8_t* img, const int* sy, const int* modI,
           const int* modQ, const int* gain, const int* base, uint8_t* out,
           int B, int h, int w, int desth, int destw, int xo_mod,
           int bandlimit, int cY, int cI, int cQ, cudaStream_t stream) {
    const long long rows = (long long)B * desth;
    if (rows == 0 || destw == 0) return (int)cudaSuccess;
    const unsigned blocks = (unsigned)((rows + WARP_ROWS - 1) / WARP_ROWS);
    const bool words =
        destw % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
    encode_rows_kernel<CC><<<blocks, WARP_ROWS, 0, stream>>>(
        img, sy, modI, modQ, gain, base, out, B, h, w, desth, destw, xo_mod,
        bandlimit, cY, cI, cQ, words);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ntsc_encode_rows(
    const void* img, const void* sy, const void* modI, const void* modQ,
    const void* gain, const void* base, void* out, int B, int h, int w,
    int desth, int destw, int cc, int xo_mod, int bandlimit, int cY, int cI,
    int cQ, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto args = [&](auto fn) {
        return fn((const uint8_t*)img, (const int*)sy, (const int*)modI,
                  (const int*)modQ, (const int*)gain, (const int*)base,
                  (uint8_t*)out, B, h, w, desth, destw, xo_mod, bandlimit,
                  cY, cI, cQ, s);
    };
    if (cc == 4) return args(launch<4>);
    if (cc == 5) return args(launch<5>);
    return (int)cudaErrorInvalidValue;
}
