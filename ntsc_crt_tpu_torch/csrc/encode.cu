// K1 encode_rows: nearest-neighbour resample + RGB->YIQ + 1-pole IIR
// bandlimit + quadrature carrier + IRE scale/clamp, one picture row per
// thread.
//
// Replaces: ntsc_crt_tpu/ops/pallas/encode_fused.py::encode_fused_rows
// (kernel body _make_kernel), in its rgb=True, col_map form.
//
// What bounds it on the H100: each row is a serial chain of destw samples
// (the IIR state carries from sample to sample), so a thread's time is the
// dependent-latency of ~20 integer ops per sample; bytes are not the limit
// (3 bytes in, 1 byte out per sample).  At batch 1 only desth (236) threads
// exist, so the kernel is a latency kernel there.
//
// Left for later: the reads of one warp hit 32 different image rows and the
// int8 writes 32 different output rows, so neither is coalesced; staging a
// tile of rows through shared memory would fix both.  The TPU kernel's
// chunking, (sub, LANE) tiling and unrolled col_map exist only for the TPU's
// vector unit and are not carried over: the column map is computed per
// sample.
#include <cuda_runtime.h>

#include "int32.cuh"

namespace {

constexpr int EXP_P = 11;

template <int CC>
__global__ void encode_rows_kernel(
    const uint8_t* __restrict__ img,   // (B, h, w, 3)
    const int* __restrict__ sy,        // (B, desth) source row per output row
    const int* __restrict__ modI,      // (B, CC) carrier tables, phase sign in
    const int* __restrict__ modQ,      // (B, CC)
    const int* __restrict__ gain,      // (B,)
    const int* __restrict__ base,      // (B,)
    int8_t* __restrict__ out,          // (B, desth, destw)
    int B, int h, int w, int desth, int destw, int xo_mod,
    int bandlimit, int cY, int cI, int cQ) {
    const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= (long long)B * desth) return;
    const int b = (int)(row / desth);
    const uint8_t* src = img + ((long long)b * h + sy[row]) * w * 3;
    // carrier tables rotated so that the in-chunk phase below is static
    int mi[CC], mq[CC];
#pragma unroll
    for (int k = 0; k < CC; ++k) {
        mi[k] = modI[b * CC + (k + xo_mod) % CC];
        mq[k] = modQ[b * CC + (k + xo_mod) % CC];
    }
    const int g = gain[b];
    const int bs = base[b];
    int8_t* dst = out + row * destw;
    int hy = 0, hi = 0, hq = 0;
    for (int t0 = 0; t0 < destw; t0 += CC) {
#pragma unroll
        for (int k = 0; k < CC; ++k) {
            const int t = t0 + k;
            if (t >= destw) break;
            const uint8_t* px = src + ((long long)t * w / destw) * 3;
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
            const int ire = add32(bs, mul32(add32(add32(vy, vi), vq), g) >> 10);
            dst[t] = (int8_t)clamp_int(ire, 0, 110);
        }
    }
}

template <int CC>
void launch(const uint8_t* img, const int* sy, const int* modI,
            const int* modQ, const int* gain, const int* base, int8_t* out,
            int B, int h, int w, int desth, int destw, int xo_mod,
            int bandlimit, int cY, int cI, int cQ, cudaStream_t stream) {
    const long long rows = (long long)B * desth;
    const int threads = 128;
    const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
    encode_rows_kernel<CC><<<blocks, threads, 0, stream>>>(
        img, sy, modI, modQ, gain, base, out, B, h, w, desth, destw, xo_mod,
        bandlimit, cY, cI, cQ);
}

}  // namespace

extern "C" int ntsc_encode_rows(
    const void* img, const void* sy, const void* modI, const void* modQ,
    const void* gain, const void* base, void* out, int B, int h, int w,
    int desth, int destw, int cc, int xo_mod, int bandlimit, int cY, int cI,
    int cQ, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto args = [&](auto fn) {
        fn((const uint8_t*)img, (const int*)sy, (const int*)modI,
           (const int*)modQ, (const int*)gain, (const int*)base,
           (int8_t*)out, B, h, w, desth, destw, xo_mod, bandlimit, cY, cI,
           cQ, s);
    };
    if (cc == 4) {
        args(launch<4>);
    } else if (cc == 5) {
        args(launch<5>);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
