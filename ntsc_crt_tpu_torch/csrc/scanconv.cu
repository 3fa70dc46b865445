// K9 scanconv_rows: the static lerp scan conversion of EQ'd Y/I/Q rows to
// outw pixels, YIQ -> RGB, contrast, clamp and a 0x00RRGGBB pack, one
// thread per (row, output pixel).
//
// Replaces: ntsc_crt_tpu/ops/pallas/scanconv_pallas.py::scanconv_rows
// (_kernel; crt_core.c:555-611).  Pixel p reads samples s = pos >> 12 and
// s + 1 with 12-bit weights L = 0xfff - R, R = pos & 0xfff, pos = p * dx,
// dx = ((T - 1) << 12) / outw — the integer formula of
// ops/fastpath.py::lerp_resample_weights, computed in the kernel.  A read at
// s + 1 == T gives 0, the TPU kernel's zero-padded tail.  Products wrap in
// int32 like the TPU kernel's (y * L >> 2 can wrap for large EQ outputs).
//
// What bounds it on the H100: no recurrence; per pixel 6 int32 loads (24
// bytes, mostly cache hits: neighbouring pixels share samples) and one int32
// store, ~45 int32 ops.  Counting each input once (3 x T x 4 bytes a row)
// and the output once, bytes bound it at outw ~ T.  Threads run along outw,
// so a warp's stores are 128 contiguous bytes and its loads fall in a few
// lines of the same rows.  The TPU kernel's (sub, LANE) row tiling and its
// unrolled static pixel map are not carried over.
#include <cuda_runtime.h>

#include "int32.cuh"

namespace {

__device__ __forceinline__ int channel(int v, int ct) {
    return clamp_int(mul32(v >> 12, ct) >> 8, 0, 255);
}

__global__ void scanconv_kernel(const int* __restrict__ oy,
                                const int* __restrict__ oi,
                                const int* __restrict__ oq,
                                const int* __restrict__ contrast,
                                int* __restrict__ out, long long R, int T,
                                int outw, int dx) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R * outw) return;
    const long long r = i / outw;
    const int p = (int)(i - r * outw);
    const int pos = p * dx;  // < (T - 1) << 12: no wrap
    const int s = pos >> 12;
    const int Rw = pos & 0xFFF;
    const int Lw = 0xFFF - Rw;
    const long long base = r * T;
    const bool tail = s + 1 >= T;
    const int ya = oy[base + s], yb = tail ? 0 : oy[base + s + 1];
    const int ia = oi[base + s], ib = tail ? 0 : oi[base + s + 1];
    const int qa = oq[base + s], qb = tail ? 0 : oq[base + s + 1];
    const int y = add32(mul32(ya, Lw) >> 2, mul32(yb, Rw) >> 2);  // :568
    const int ii = add32(mul32(ia, Lw) >> 14, mul32(ib, Rw) >> 14);
    const int q = add32(mul32(qa, Lw) >> 14, mul32(qb, Rw) >> 14);
    const int ct = contrast[r];
    const int red = channel(add32(add32(y, mul32(3879, ii)), mul32(2556, q)), ct);
    const int grn = channel(sub32(sub32(y, mul32(1126, ii)), mul32(2605, q)), ct);
    const int blu = channel(add32(sub32(y, mul32(4530, ii)), mul32(7021, q)), ct);
    out[i] = (red << 16) | (grn << 8) | blu;
}

}  // namespace

// oy, oi, oq int32 (R, T); contrast int32 (R,); out int32 (R, outw)
extern "C" int ntsc_scanconv_rows(const void* oy, const void* oi,
                                  const void* oq, const void* contrast,
                                  void* out, int R, int T, int outw,
                                  void* stream) {
    if (R < 0 || T < 1 || outw < 1) return (int)cudaErrorInvalidValue;
    if (R == 0) return (int)cudaSuccess;
    const int dx = (int)((((long long)T - 1) << 12) / outw);
    const long long n = (long long)R * outw;
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    scanconv_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        (const int*)oy, (const int*)oi, (const int*)oq, (const int*)contrast,
        (int*)out, R, T, outw, dx);
    return (int)cudaGetLastError();
}
