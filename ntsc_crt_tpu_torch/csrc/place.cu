// K6 place_rows_uniform: uniform row placement of the decoded lines into
// the output frame, with the odd-field shift, the 50/50 blend against the
// previous frame and the scanline gaps (crt_core.c:552-664), one thread per
// 16-byte chunk of an output row (per byte where rows are not 16-byte
// multiples).
//
// Replaces: ntsc_crt_tpu/ops/pallas/place_rows.py::place_rows_uniform and
// place_rows_uniform_tiled (their three pallas_calls compute the same
// function), i.e. the stacked branch of
// ntsc_crt_tpu/models/demodulate.py::_place_rows_uniform.
//
// Output row r = ratio*k + j (line group k, slot j) of frame b reads line
// k - (j < fp and the frame is an odd field), clamped at line 0; with blend
// on it is (line >> 1) + (old[beg] >> 1) bytewise, beg being the group's
// first row (ratio*k, or ratio*(that line) + fp on an odd field); it keeps
// the previous contents in the scanline gap and at the odd field's top and
// bottom clips.  Every decision is per row, so a thread only picks its two
// source rows and moves 16 bytes.
//
// Bloom mode (BLOOM, crt_core.c:512-555): pixel p of the source line is
// drawn iff scan + p * dx < (av_len - 1) << 12 in wrapping int32, from the
// line's (dx, scan); a byte of a pixel not drawn takes the beg row's
// previous contents (the row the blend reads), as the general placement
// does with its `valid` plane (ntsc_crt_tpu/models/demodulate.py:1314).
// A thread tests the six pixels its 16 bytes touch, spreads the result to
// a byte mask and selects with it; it reads the beg row only where a byte
// needs it.
//
// What bounds it on the H100: bytes.  It reads each needed line and old
// row and writes the output once; the ratio slots of a group re-read the
// same line, which the L2 serves.  Bloom mode adds about 40 integer ops a
// chunk.
//
// General mode (ntsc_place_rows_general): the placement off the uniform
// gate, ntsc_crt_tpu_torch/models/demodulate.py::_place_rows_general on the
// card — any outh (832x624's 624 rows of 240 lines, v_fac, a downscale),
// blend and scanlines per slot.  Output row r of frame b takes the last
// line l with active[l] and beg[l] <= r < max(beg[l] + 1, min(end[l], outh)
// - scanlines[b]) (int32, wrapping), or keeps old's row where no line
// covers it; with blend on for the slot it is (line >> 1) + (old[beg'] >>
// 1) bytewise, beg' = clamp(beg[l], 0, outh - 1), and in bloom mode a byte
// of a pixel the line does not draw takes old[beg'] (unblended).  A block
// takes one frame and a band of GEN_ROWS rows: its threads test every line
// against the band and keep each row's last covering line in shared
// memory (an atomicMax a covered row, exact for any beg/end), then stream
// the band's rows 16 bytes a thread.  old is read only for an uncovered
// row, a blended slot or an undrawn byte, so with neither blend nor bloom
// and every row covered the kernel moves the floor's bytes: the lines
// (duplicates re-read from the L2) and the output written once.  Offsets
// are 64-bit: the output passes 2^31 elements at B 2048, 832x624.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned half_sum(unsigned a, unsigned b) {
    // (a >> 1) + (b >> 1) in each byte: at most 254, so no carry crosses
    return ((a >> 1) & 0x7F7F7F7Fu) + ((b >> 1) & 0x7F7F7F7Fu);
}

// pixel p is drawn: scan + p * dx < lim, wrapping
__device__ __forceinline__ bool drawn(int scan, int dx, int p, int lim) {
    return (int)((unsigned)scan + (unsigned)p * (unsigned)dx) < lim;
}

// 0xFF in byte k of the word for each set bit k of a 4-bit mask
__device__ __forceinline__ unsigned byte_mask(unsigned nib) {
    return ((nib * 0x00204081u) & 0x01010101u) * 0xFFu;
}

template <int VEC, bool BLOOM>
__global__ void place_rows_kernel(const uint8_t* __restrict__ rgb,  // (B, L, w3)
                                  const uint8_t* __restrict__ old,  // (B, ratio*L, w3)
                                  const int* __restrict__ field_px,  // (B,)
                                  const int* __restrict__ bloom_dx,    // (B, L)
                                  const int* __restrict__ bloom_scan,  // (B, L)
                                  uint8_t* __restrict__ out,  // (B, ratio*L, w3)
                                  int B, int L, int ratio, int w3, int fp,
                                  int blend, int scanlines, int av_len) {
    const long long nc = w3 / VEC;
    const long long outh = (long long)ratio * L;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)B * outh * nc) return;
    const long long c = (i % nc) * VEC;
    const long long rr = i / nc;
    const int r = (int)(rr % outh);
    const long long b = rr / outh;
    const int k = r / ratio;
    const int j = r % ratio;
    const bool fb = field_px[b] > 0;
    const bool shifted = fp > 0 && j < fp;       // slot reads line k - 1
    const int src = (shifted && fb) ? max(k - 1, 0) : k;
    const int rel = fb ? ((j - fp) % ratio + ratio) % ratio : j;
    bool keep = rel >= ratio - scanlines;         // scanline gap
    if (shifted) keep = keep || (k == 0 && fb);   // rows above the field
    if (fp > 0 && j > fp && j >= ratio - scanlines)
        keep = keep || (k == L - 1 && fb);        // bottom clip (crt_core.c:432)

    const uint8_t* o = old + (b * outh + r) * w3 + c;
    uint8_t* d = out + (b * outh + r) * w3 + c;
    const uint8_t* s = keep ? o : rgb + (b * L + src) * w3 + c;
    const uint8_t* ob =
        old + (b * outh + (long long)ratio * src + (fp > 0 && fb ? fp : 0)) * w3 + c;
    const bool mix = blend && !keep;
    // bit i: byte c + i is drawn (all of them outside bloom mode)
    unsigned dm = VEC == 16 ? 0xFFFFu : 1u;
    if (BLOOM && !keep) {
        const int dx = bloom_dx[b * L + src], sc = bloom_scan[b * L + src];
        const int lim = (av_len - 1) << 12;
        if constexpr (VEC == 16) {
            // bit 3q + t of rep: pixel p0 + q drawn, for its bytes t < 3
            const int p0 = (int)(c / 3), r0 = (int)(c - 3LL * p0);
            unsigned rep = 0;
#pragma unroll
            for (int q = 0; q < 6; ++q)
                rep |= drawn(sc, dx, p0 + q, lim) ? 7u << (3 * q) : 0u;
            dm = (rep >> r0) & 0xFFFFu;
        } else {
            dm = drawn(sc, dx, (int)(c / 3), lim);
        }
    }
    const bool need_ob = mix || dm != (VEC == 16 ? 0xFFFFu : 1u);
    if constexpr (VEC == 16) {
        uint4 v = *reinterpret_cast<const uint4*>(s);
        if (need_ob) {
            const uint4 w = *reinterpret_cast<const uint4*>(ob);
            if (mix) {
                v.x = half_sum(v.x, w.x);
                v.y = half_sum(v.y, w.y);
                v.z = half_sum(v.z, w.z);
                v.w = half_sum(v.w, w.w);
            }
            if (BLOOM) {   // bytes not drawn keep the beg row's contents
                unsigned m = byte_mask(dm & 15u);
                v.x = (v.x & m) | (w.x & ~m);
                m = byte_mask((dm >> 4) & 15u);
                v.y = (v.y & m) | (w.y & ~m);
                m = byte_mask((dm >> 8) & 15u);
                v.z = (v.z & m) | (w.z & ~m);
                m = byte_mask(dm >> 12);
                v.w = (v.w & m) | (w.w & ~m);
            }
        }
        *reinterpret_cast<uint4*>(d) = v;
    } else {
        unsigned v = *s;
        if (need_ob) {
            const unsigned w = *ob;
            if (mix) v = (v >> 1) + (w >> 1);
            if (BLOOM && !dm) v = w;
        }
        *d = (uint8_t)v;
    }
}

template <int VEC, bool BLOOM>
void launch(unsigned blocks, int threads, cudaStream_t s, const void* rgb,
            const void* old, const void* field_px, const void* bloom_dx,
            const void* bloom_scan, void* out, int B, int L, int ratio,
            int w3, int fp, int blend, int scanlines, int av_len) {
    place_rows_kernel<VEC, BLOOM><<<blocks, threads, 0, s>>>(
        (const uint8_t*)rgb, (const uint8_t*)old, (const int*)field_px,
        (const int*)bloom_dx, (const int*)bloom_scan, (uint8_t*)out, B, L,
        ratio, w3, fp, blend, scanlines, av_len);
}

constexpr int GEN_ROWS = 32;       // output rows of one frame a block
constexpr int GEN_THREADS = 256;

template <int VEC, bool BLOOM>
__global__ void __launch_bounds__(GEN_THREADS) place_rows_general_kernel(
    const uint8_t* __restrict__ rgb,       // (B, L, w3)
    const uint8_t* __restrict__ old,       // (B, outh, w3)
    const int* __restrict__ beg,           // (B, L)
    const int* __restrict__ end,           // (B, L)
    const uint8_t* __restrict__ active,    // (B, L) bool
    const int* __restrict__ blend_b,       // (B,), or null: blend_i
    const int* __restrict__ scan_b,        // (B,), or null: scan_i
    const int* __restrict__ bloom_dx,      // (B, L)
    const int* __restrict__ bloom_scan,    // (B, L)
    uint8_t* __restrict__ out,             // (B, outh, w3)
    int L, int outh, int w3, int bands, int blend_i, int scan_i,
    int av_len) {
    __shared__ int line[GEN_ROWS];         // each band row's line, or -1
    const long long b = blockIdx.x / bands;
    const int r0 = (int)(blockIdx.x % bands) * GEN_ROWS;
    const int nr = min(GEN_ROWS, outh - r0);
    for (int r = threadIdx.x; r < GEN_ROWS; r += blockDim.x) line[r] = -1;
    __syncthreads();
    const long long lb = b * L;
    const int sl = scan_b ? scan_b[b] : scan_i;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
        if (!active[lb + l]) continue;
        const int bl = beg[lb + l];
        const int ec = min(end[lb + l], outh);
        // max(beg + 1, end_c - scanlines) in wrapping int32
        const int ce = max((int)((unsigned)bl + 1u),
                           (int)((unsigned)ec - (unsigned)sl));
        const int hi = min(ce, r0 + nr);
        for (int r = max(bl, r0); r < hi; ++r) atomicMax(&line[r - r0], l);
    }
    __syncthreads();

    const bool mix = (blend_b ? blend_b[b] : blend_i) != 0;
    const int nc = w3 / VEC;
    const long long frame = b * outh;
    const unsigned full = VEC == 16 ? 0xFFFFu : 1u;
    for (int i = threadIdx.x; i < nr * nc; i += blockDim.x) {
        const int rr = i / nc;
        const long long c = (long long)(i - rr * nc) * VEC;
        const int l = line[rr];
        uint8_t* d = out + (frame + r0 + rr) * w3 + c;
        if (l < 0) {                       // no line covers the row
            const uint8_t* o = old + (frame + r0 + rr) * w3 + c;
            if constexpr (VEC == 16)
                *reinterpret_cast<uint4*>(d) =
                    *reinterpret_cast<const uint4*>(o);
            else
                *d = *o;
            continue;
        }
        const uint8_t* s = rgb + (lb + l) * w3 + c;
        const int bsel = min(max(beg[lb + l], 0), outh - 1);
        const uint8_t* ob = old + (frame + bsel) * w3 + c;
        unsigned dm = full;                // bit i: byte c + i is drawn
        if (BLOOM) {
            const int dx = bloom_dx[lb + l], sc = bloom_scan[lb + l];
            const int lim = (av_len - 1) << 12;
            if constexpr (VEC == 16) {
                const int p0 = (int)(c / 3), q0 = (int)(c - 3LL * p0);
                unsigned rep = 0;
#pragma unroll
                for (int q = 0; q < 6; ++q)
                    rep |= drawn(sc, dx, p0 + q, lim) ? 7u << (3 * q) : 0u;
                dm = (rep >> q0) & 0xFFFFu;
            } else {
                dm = drawn(sc, dx, (int)(c / 3), lim);
            }
        }
        const bool need_ob = mix || dm != full;
        if constexpr (VEC == 16) {
            uint4 v = *reinterpret_cast<const uint4*>(s);
            if (need_ob) {
                const uint4 w = *reinterpret_cast<const uint4*>(ob);
                if (mix) {
                    v.x = half_sum(v.x, w.x);
                    v.y = half_sum(v.y, w.y);
                    v.z = half_sum(v.z, w.z);
                    v.w = half_sum(v.w, w.w);
                }
                if (BLOOM) {   // bytes not drawn take old[beg']
                    unsigned m = byte_mask(dm & 15u);
                    v.x = (v.x & m) | (w.x & ~m);
                    m = byte_mask((dm >> 4) & 15u);
                    v.y = (v.y & m) | (w.y & ~m);
                    m = byte_mask((dm >> 8) & 15u);
                    v.z = (v.z & m) | (w.z & ~m);
                    m = byte_mask(dm >> 12);
                    v.w = (v.w & m) | (w.w & ~m);
                }
            }
            *reinterpret_cast<uint4*>(d) = v;
        } else {
            unsigned v = *s;
            if (need_ob) {
                const unsigned w = *ob;
                if (mix) v = (v >> 1) + (w >> 1);
                if (BLOOM && !dm) v = w;
            }
            *d = (uint8_t)v;
        }
    }
}

template <int VEC, bool BLOOM>
void launch_general(unsigned blocks, cudaStream_t s, const void* rgb,
                    const void* old, const void* beg, const void* end,
                    const void* active, const void* blend,
                    const void* scanlines, const void* bloom_dx,
                    const void* bloom_scan, void* out, int L, int outh,
                    int w3, int bands, int blend_i, int scan_i, int av_len) {
    place_rows_general_kernel<VEC, BLOOM><<<blocks, GEN_THREADS, 0, s>>>(
        (const uint8_t*)rgb, (const uint8_t*)old, (const int*)beg,
        (const int*)end, (const uint8_t*)active, (const int*)blend,
        (const int*)scanlines, (const int*)bloom_dx, (const int*)bloom_scan,
        (uint8_t*)out, L, outh, w3, bands, blend_i, scan_i, av_len);
}

}  // namespace

// rgb uint8 (B, L, w3); old, out uint8 (B, ratio*L, w3); field_px int32
// (B,); bloom_dx, bloom_scan int32 (B, L), both null outside bloom mode;
// blend 0/1; 0 <= scanlines < ratio; 0 <= fp < ratio; av_len (bloom)
extern "C" int ntsc_place_rows_uniform(const void* rgb, const void* old,
                                       const void* field_px,
                                       const void* bloom_dx,
                                       const void* bloom_scan, void* out,
                                       int B, int L, int ratio, int w3,
                                       int fp, int blend, int scanlines,
                                       int av_len, void* stream) {
    const bool vec = w3 % 16 == 0 && (uintptr_t)rgb % 16 == 0 &&
                     (uintptr_t)old % 16 == 0 && (uintptr_t)out % 16 == 0;
    const bool bloom = bloom_dx != nullptr;
    if (bloom != (bloom_scan != nullptr) ||
        (bloom && (av_len < 1 || av_len > (1 << 19))))
        return (int)cudaErrorInvalidValue;
    const long long n = (long long)B * ratio * L * (vec ? w3 / 16 : w3);
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    auto s = static_cast<cudaStream_t>(stream);
    auto go = vec ? (bloom ? launch<16, true> : launch<16, false>)
                  : (bloom ? launch<1, true> : launch<1, false>);
    go(blocks, threads, s, rgb, old, field_px, bloom_dx, bloom_scan, out, B,
       L, ratio, w3, fp, blend, scanlines, av_len);
    return (int)cudaGetLastError();
}

// rgb uint8 (B, L, w3); old, out uint8 (B, outh, w3); beg, end int32 (B,
// L); active bool (B, L); blend, scanlines int32 (B,) each, or null for
// the host value blend_i / scan_i on every slot; bloom_dx, bloom_scan
// int32 (B, L), both null outside bloom mode; av_len (bloom)
extern "C" int ntsc_place_rows_general(const void* rgb, const void* old,
                                       const void* beg, const void* end,
                                       const void* active, const void* blend,
                                       const void* scanlines,
                                       const void* bloom_dx,
                                       const void* bloom_scan, void* out,
                                       int B, int L, int outh, int w3,
                                       int blend_i, int scan_i, int av_len,
                                       void* stream) {
    const bool bloom = bloom_dx != nullptr;
    if (bloom != (bloom_scan != nullptr) ||
        (bloom && (av_len < 1 || av_len > (1 << 19))) || B < 0 || L < 1 ||
        outh < 1 || w3 < 1 || (long long)GEN_ROWS * w3 > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const int bands = (outh + GEN_ROWS - 1) / GEN_ROWS;
    const long long blocks = (long long)B * bands;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    const bool vec = w3 % 16 == 0 && (uintptr_t)rgb % 16 == 0 &&
                     (uintptr_t)old % 16 == 0 && (uintptr_t)out % 16 == 0;
    auto go = vec ? (bloom ? launch_general<16, true>
                           : launch_general<16, false>)
                  : (bloom ? launch_general<1, true>
                           : launch_general<1, false>);
    go((unsigned)blocks, static_cast<cudaStream_t>(stream), rgb, old, beg,
       end, active, blend, scanlines, bloom_dx, bloom_scan, out, L, outh, w3,
       bands, blend_i, scan_i, av_len);
    return (int)cudaGetLastError();
}
