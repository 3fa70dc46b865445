// bloom_line_width: the beam-energy EMA that sizes each line of the bloom
// build (crt_core.c:512-520), with the line sums that drive it, one block of
// warps per frame.
//
// Replaces: the lax.scan of ntsc_crt_tpu/models/demodulate.py:880-887 and
// the s_sum that feeds it (:869-878); neither has a Pallas form.
//
// Line l's sum s is the sum of its field row over [xpos, xpos + av) clipped
// to the row, plus the next row over [0, xpos + av - H) (the window spills
// into it).  The rows are read in place from the noisy field (B, V, H):
// line l starts on row line_row[l], and the row after row V - 1 is the
// frame's row 0.  Then drive = (((max_e >> 1) - s) << 10) / max_e and
// prev_e = prev_e*123/128 + drive from 16384/8, C truncating divisions in
// wrapping int32; max_e == 0 divides to -1 and max_e == -1 negates, as XLA
// defines division.
//
// What bounds it on the H100: at batch 512 the bytes, the frames' windows
// (~180 KB a frame at NTSC, ~90 MB in all); at batch 1 the latency of
// reading them and the serial chain of L lines (a multiply, the truncating
// /128 and an add).
//
// What the design does about it:
// - A block of NW = 16 warps takes one frame; the warps take its lines in
//   turn, the frame's window starts and line rows staged in shared memory
//   first.  A line's window and its spill are one range of the frame's
//   flat rows (a spill needs the window to reach the row's end), or two
//   where a line on row V - 1 spills into row 0.  A range is read as
//   chunks aligned to 16 bytes of the address (any field alignment), one
//   a lane, both of a lane's chunks in flight before either is summed (the
//   first and last chunk mask their bytes; an aligned chunk that holds a
//   byte of the range never crosses a page), by __dp4a against 0x01010101
//   and one warp reduction: one memory round trip a line.
// - Each line's drive, with its division, is computed by the warp that
//   summed it, off the chain, into shared memory.  Then one thread runs the
//   EMA, reading the drives four at a time ahead of the chain.  The block
//   stores prev_e coalesced.
// - Lines go through shared memory CH at a time, for any L.
// Tried (PERF.md): the window start read from global memory and each
// chunk loaded and summed in turn (three or four round trips a line) took
// 2.2x the time at batch 1; NW = 8 and 32 warps a frame: 8 is slower at
// batch 1, 32 at 512 (two blocks an SM, so two waves).
#include <cuda_runtime.h>

#include <cstdint>

#include "int32.cuh"

namespace {

constexpr int CH = 256;  // lines a pass through shared memory
constexpr unsigned FULL = 0xffffffffu;

// C's truncating a / d, made total as XLA defines it: d == 0 gives -1 and
// INT_MIN / -1 gives INT_MIN
__device__ __forceinline__ int cdiv32(int a, int d) {
    if (d == 0) return -1;
    if (d == -1) return sub32(0, a);
    return a / d;
}

// The bytes of the 16-byte chunk at flat offset c that lie in [s, e),
// summed (int8 each); the chunk's words are w
__device__ __forceinline__ int chunk_sum(const int (&w)[4], long long c,
                                         long long s, long long e,
                                         int acc) {
    const int lo = (int)min(max(s - c, 0LL), 16LL);  // bytes cut below
    const int hi = (int)min(max(c + 16 - e, 0LL), 16LL);  // and above
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int l = min(max(lo - 4 * j, 0), 4);
        const int h = min(max(hi - (12 - 4 * j), 0), 4);
        const unsigned keep = (unsigned)(0xffffffffull << (8 * l)) &
                              (unsigned)(0xffffffffull >> (8 * h));
        acc = __dp4a((int)((unsigned)w[j] & keep), 0x01010101, acc);
    }
    return acc;
}

// This lane's part of the sum of the int8 bytes at offsets [s, e) of
// `frame`: chunk k of the range's 16-byte aligned chunks is lane k % 32's,
// two loads in flight before either is summed (a window of up to 1,009
// bytes is one round)
__device__ __forceinline__ int range_part(const int8_t* __restrict__ frame,
                                          long long s, long long e,
                                          int lane) {
    if (s >= e) return 0;
    const int mis = (int)(reinterpret_cast<uintptr_t>(frame) & 15);
    const int8_t* base = frame - mis;  // 16-byte aligned
    s += mis;
    e += mis;
    int acc = 0;
    for (long long c = (s & ~15LL) + 16LL * lane; c < e; c += 2 * 16 * 32) {
        const long long c2 = c + 16 * 32;
        int4 v = *reinterpret_cast<const int4*>(base + c);
        int4 v2 = c2 < e ? *reinterpret_cast<const int4*>(base + c2)
                         : make_int4(0, 0, 0, 0);
        const int w[4] = {v.x, v.y, v.z, v.w};
        const int w2[4] = {v2.x, v2.y, v2.z, v2.w};
        acc = chunk_sum(w, c, s, e, acc);
        acc = chunk_sum(w2, c2, s, e, acc);
    }
    return acc;
}

template <int NW>
__global__ void __launch_bounds__(32 * NW) bloom_line_width_kernel(
    const int8_t* __restrict__ field,  // (B, V, H) the noisy field
    const int* __restrict__ line_row,  // (B, L) each line's first row
    const int* __restrict__ xpos,      // (B, L) window starts
    const int* __restrict__ max_e,     // (B,)
    int* __restrict__ prev_e,          // (B, L)
    int L, int V, int H, int av) {
    __shared__ __align__(16) int drive[CH];
    __shared__ __align__(16) int ema[CH];
    __shared__ int xs[CH];
    __shared__ int rs[CH];
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long vh = (long long)V * H;
    const int8_t* frame = field + b * vh;
    const int me = max_e[b];
    const int half = me >> 1;
    int e = 16384 / 8;  // thread 0's
    for (int c0 = 0; c0 < L; c0 += CH) {
        const int n = min(CH, L - c0);
        for (int i = threadIdx.x; i < n; i += 32 * NW) {
            xs[i] = xpos[(long long)b * L + c0 + i];
            rs[i] = line_row[(long long)b * L + c0 + i];
        }
        __syncthreads();
        for (int i = warp; i < n; i += NW) {
            const int x = xs[i];
            const int end = add32(x, av);  // wraps as the reference's int
            const int a0 = max(x, 0), a1 = max(min(end, H), a0);
            const int spill = clamp_int(sub32(end, H), 0, H);
            // window [a0, a1) and spill [H, H + spill) of the flat rows from
            // the line's row: one range, as a spill needs a1 == H; its part
            // past the frame's end (a spill from row V - 1) wraps to row 0
            const long long row = (long long)rs[i] * H;
            const long long s = row + (a1 > a0 ? a0 : H);
            const long long en =
                spill > 0 ? row + H + spill : (a1 > a0 ? row + a1 : s);
            int part = range_part(frame, min(s, vh), min(en, vh), lane);
            if (en > vh)  // the warp's line: no lane diverges
                part += range_part(frame, max(s, vh) - vh, en - vh, lane);
            const int sum = __reduce_add_sync(FULL, part);
            if (lane == 0)
                drive[i] =
                    cdiv32((int)((unsigned)sub32(half, sum) << 10), me);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            // four lines a shared-memory word, loads ahead of the chain
            int i = 0;
#pragma unroll 4
            for (; i + 4 <= n; i += 4) {
                const int4 d = *reinterpret_cast<const int4*>(drive + i);
                int4 o;
                o.x = e = add32(mul32(e, 123) / 128, d.x);
                o.y = e = add32(mul32(e, 123) / 128, d.y);
                o.z = e = add32(mul32(e, 123) / 128, d.z);
                o.w = e = add32(mul32(e, 123) / 128, d.w);
                *reinterpret_cast<int4*>(ema + i) = o;
            }
            for (; i < n; ++i)
                ema[i] = e = add32(mul32(e, 123) / 128, drive[i]);
        }
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += 32 * NW)
            prev_e[(long long)b * L + c0 + i] = ema[i];
        // the next pass writes xs[], rs[] and drive[] only after the
        // barrier that ends thread 0's reads, and ema[] after the next two
        // barriers
    }
}

constexpr int WARPS = 16;  // warps a frame

}  // namespace

// field int8 (B, V, H), V * H < 2**31; line l reads rows line_row[l] and
// line_row[l] + 1 (mod V), each line_row in [0, V); xpos, prev_e int32
// (B, L); max_e int32 (B,)
extern "C" int ntsc_bloom_line_width(const void* field, const void* line_row,
                                     const void* xpos, const void* max_e,
                                     void* prev_e, int B, int V, int L, int H,
                                     int av, void* stream) {
    if (B < 1 || V < 1 || L < 1 || H < 1 || (long long)V * H >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    bloom_line_width_kernel<WARPS><<<B, 32 * WARPS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        (const int8_t*)field, (const int*)line_row, (const int*)xpos,
        (const int*)max_e, (int*)prev_e, L, V, H, av);
    return (int)cudaGetLastError();
}
