// K13 nes_square: NES's square-wave encoder pass, every sample of the
// analog field written in place.
//
// Replaces: no Pallas kernel.  The JAX package leaves the pass to XLA:
// ntsc_crt_tpu/models/modulate.py:755 (_nes_square_sum4, square_sample in
// closed form) and :818 (modulate_nes: the skeleton, the burst table and
// rows, the PPU resample through one-hot matmuls, the IRE scale, the int8
// wrap, the flat store, the border).
//
// For slot b, in the reference's order (a later source wins):
// - the skeleton: blank_level, but sync_level over [sync_beg, sync_end) of
//   each row, over [sync_beg, sep_end) from row sep_row on;
// - the burst over rows [br0, br0 + brn) and columns [bc0, bc0 + bcn): at
//   row class y = row % vp and column class k = column % cc, (blank_level
//   + sine(n) * burst_level) >> 5 for the angle n = (hue + 360 / cc * k +
//   (y + dco) * vert_step + 33) % 360 (C's %; sine from the wrapper's
//   table); the slot's first block writes it << 7 to ccf;
// - with the border on, rows nb0 .. nb1 - 1 from column lav: pixel 0xF0 in
//   column lav, border_color & 0x1FF after it, at phase ph(row) + 6 + 3 *
//   (column - lav);
// - picture sample (y, x), y < desth, x < destw: the pixel p = ppu[b, sy,
//   sx] & 0x1FF, sy = min(y*h / desth, h - 1), sx = x*w / destw, at phase
//   ph(yo + y) + 3 * (x % 4), where ph(row) = 4 * ((row + dco) % vp) with
//   C's %, a negative class reading 0.  With S the sum of square_sample
//   over four consecutive phases, it stores (signed char) (((black_level +
//   bp + S) * wp / 100) >> 12) in wrapping int32 (C's truncating division)
//   at the flat field offset (yo + y) * H + xo + x: a row past H spills
//   into the next row, offsets past the field are dropped.
//
// What bounds it on the H100: bytes, the PPU pixels read and the field
// written (at batch 512 from 256x240 pixels: 62.9 MB read, 121.9 MB
// written).  NES's field row is 909 bytes, so neither a row nor a slot's
// field (238,158 bytes) lies on the 16-byte grid.
//
// What the design does about it:
// - square_sample reads only bits 0-8 of the pixel and the phase mod 12,
//   and a row's phase classes are ph(row) + 3q (q = x % 4) with ph(row) in
//   {0, 4, 8} mod 12.  So a block folds its slot's black and white points
//   into G[ph / 4][p], a word whose byte q is the stored byte at phase ph
//   + 3q (3 x 512 words in shared memory, from the wrapper's 512 x 12
//   table, a 48-byte row of it a pixel); the border's bytes are bytes of
//   the same words.
// - A block takes field rows of one slot, sixteen at a time (two a warp).
//   A warp first turns its picture row's 256 PPU pixels into 256 words
//   W[s] = G[ph / 4][p_s] (one 16-byte load a lane, issued a batch ahead),
//   so a picture sample is byte x % 4 of W[sx[x]]: a load whose lanes hit
//   neighbouring words, where a sample's own table lookup would be a
//   random gather.  sx is tabulated as W's byte offsets, four copies
//   shifted by 0..3 samples, so a word's four offsets are one 16-byte
//   shared load.
// - The warp writes its row into a shared buffer that maps the batch's
//   bytes onto the 16-byte grid of the whole (B, V * H) field.  The buffer
//   starts at the blank level; the warp lays the row's sources over it in
//   the reference's order (the sync, the burst, the border, the previous
//   row's spill, the picture), each one span of columns, so every lane of
//   the warp runs the same code: a lane forms a 4-byte word on the
//   buffer's grid and stores it whole, a span's two end words a byte at a
//   time.
// - The block then writes the batch out, a lane a 16-byte chunk of the
//   field's grid: 16-byte stores, whatever the row's alignment; the same
//   lane blanks the chunk for the batch after next.  Only the chunks that
//   straddle a neighbouring block's rows are written a byte at a time, the
//   bytes of this block.  Two buffers alternate, so one barrier a batch
//   separates building a batch from writing the last.
// - Designs tried (PERF.md): the border, sync and burst folded into each
//   word by byte masks (2x slower: that control cost more than the
//   picture), 16 bytes a lane in the spans (bank conflicts), W as four
//   byte planes, one span for the sync and the burst, the copy-out by the
//   bulk copy engine (cp.async.bulk), PPU rows two batches ahead, a lane's
//   16 bytes formed in registers without the buffer: none faster.  The
//   design before this one (a lane a 4-byte word of device memory, row by
//   row; the words at a row's or a source's edge a byte at a time) spent
//   its time in the control around those edges, not in the stores: a copy
//   that only stored took 0.21 of its 0.26 ms at batch 512.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "int32.cuh"

namespace {

constexpr int THREADS = 256;         // 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int RPW = 2;               // rows a warp builds a batch
constexpr int ROWS = WARPS * RPW;    // rows a batch
constexpr int NP = 512, NU = 12;     // the table: pixel & 0x1FF, phase % 12
constexpr int NPH = 3;               // row phase classes ph / 4, ph % 12
constexpr int MAX_DESTW = 4096;      // sx's table: 4 copies
constexpr int SX_PAD = 4;            // sx entries before x = 0 in a copy
constexpr int STAGE_W = 256;         // PPU rows up to this wide are staged
constexpr int MAX_BURST = 64;        // a slot's burst table, vp x cc at most
constexpr int MAX_SMEM = 227 * 1024;  // a block's dynamic shared memory

struct Geometry {
    int V, H, h, w, xo, yo, destw, desth, vp, black_level;
    int border, nb0, nb1, lav;  // border rows [nb0, nb1), columns [lav, H)
    // the skeleton: blank, but sync over [sync_beg, sync_end), or over
    // [sync_beg, sep_end) from row sep_row on
    int sync_beg, sync_end, sep_row, sep_end, sync_level, blank_level;
    int br0, brn, bc0, bcn, cc;  // burst rows, columns; its column classes
    int vert_step, burst_level;  // the burst angle's step a row class
    int tiles, tile_rows;       // blocks a slot, rows a block
    int sxp;                    // a copy of the sx table, in entries
    int bufp;                   // a batch buffer, in bytes
    int staged;                 // PPU rows staged a batch ahead
    unsigned long long sx_mul;  // ceil(2^40 / destw): sx without a division
};

// the dynamic shared memory: two batch buffers (first: 16-byte accesses),
// each warp's W row, G, the sx copies, the rows' PPU offsets and phases
__host__ __device__ constexpr long long shared_bytes(int bufp, int sxp,
                                                     int tile_rows) {
    return 2LL * bufp + WARPS * STAGE_W * 4 + NPH * NP * 4 + 4LL * sxp * 4 +
           8LL * (tile_rows + 2);
}

// 4 * ((row + dco) % vp) with C's %, 0 for a negative class; % 12
__device__ __forceinline__ int phase_of(int row, int dco, int vp) {
    const int cls = add32(row, dco) % vp;
    return cls >= 0 ? (4 * cls) % NU : 0;
}

// The words on the buffer's 4-byte grid over the columns [lo, hi) of a row
// whose column 0 sits at buffer byte pos0: the word whose first byte is
// column c0 (pos0 + c0 == 0 mod 4) is word_at(c0).  A warp's lanes take
// consecutive words and store them whole, the span's two end words a byte
// at a time.  Spans may overlap, a later one winning: the warp meets
// after each.
template <class F>
__device__ __forceinline__ void span(unsigned char* buf, int pos0, int lo,
                                     int hi, int lane, F word_at) {
    const int a = pos0 + lo, e = pos0 + hi;   // buffer bytes [a, e)
    const int we = lo < hi ? (e + 3) >> 2 : 0;
#pragma unroll 1
    for (int wi = (a >> 2) + lane; wi < we; wi += 32) {
        const unsigned v = word_at(4 * wi - pos0);
        if (4 * wi >= a && 4 * wi + 4 <= e) {
            *reinterpret_cast<unsigned*>(buf + 4 * wi) = v;
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (4 * wi + j >= a && 4 * wi + j < e)
                    buf[4 * wi + j] = (unsigned char)(v >> (8 * j));
        }
    }
    __syncwarp();
}

// The picture samples x = c - xs of a PPU row over the columns [lo, hi) of
// a row at buffer byte pos0: from copy x0 % 4 of the shifted tables, the
// byte offsets of W of a word's four samples in one load; a sample's word
// from the row's staged words W (STAGED) or the G row Gp of its pixel in
// device memory (prow); byte x % 4 of it.
template <bool STAGED>
__device__ __forceinline__ void picture(unsigned char* buf, int pos0, int lo,
                                        int hi, int lane, int xs,
                                        const unsigned* sxw, int sxp,
                                        const unsigned char* W,
                                        const unsigned* Gp,
                                        const unsigned short* prow) {
    const int rho = -(pos0 + xs) & 3;   // x % 4 at a word's first byte
    const unsigned sel01 = rho | (4 + ((rho + 1) & 3)) << 4;
    const unsigned sel23 = ((rho + 2) & 3) | (4 + ((rho + 3) & 3)) << 4;
    const unsigned* sxc = sxw + rho * sxp + SX_PAD - rho - xs;
    span(buf, pos0, lo, hi, lane, [&](int c0) {
        // W's offsets of samples x0 .. x0 + 3, x0 = c0 - xs (x0 - rho is a
        // multiple of 4: a 16-byte load)
        const uint4 o = *reinterpret_cast<const uint4*>(sxc + c0);
        unsigned v[4];
        if (STAGED) {
            v[0] = *reinterpret_cast<const unsigned*>(W + o.x);
            v[1] = *reinterpret_cast<const unsigned*>(W + o.y);
            v[2] = *reinterpret_cast<const unsigned*>(W + o.z);
            v[3] = *reinterpret_cast<const unsigned*>(W + o.w);
        } else {
            v[0] = Gp[prow[o.x >> 2] & 0x1FF];
            v[1] = Gp[prow[o.y >> 2] & 0x1FF];
            v[2] = Gp[prow[o.z >> 2] & 0x1FF];
            v[3] = Gp[prow[o.w >> 2] & 0x1FF];
        }
        return __byte_perm(__byte_perm(v[0], v[1], sel01),
                           __byte_perm(v[2], v[3], sel23), 0x5410);
    });
}

// A block takes tile_rows field rows of one slot, ROWS rows a batch.
__global__ void __launch_bounds__(THREADS)
    nes_square_kernel(signed char* __restrict__ analog,       // (B, V, H)
                      const unsigned short* __restrict__ ppu,  // (B, h, w)
                      const int* __restrict__ table,           // (512, 12)
                      const int* __restrict__ dco,             // (B,)
                      const int* __restrict__ bp,              // (B,)
                      const int* __restrict__ wp,              // (B,)
                      const int* __restrict__ bc,              // (B,)
                      const int* __restrict__ hue,             // (B,)
                      const int* __restrict__ sines,           // (719,)
                      int* __restrict__ ccf,                   // (B, vp, cc)
                      Geometry g) {
    __shared__ __align__(4) signed char bts[MAX_BURST];  // the slot's burst
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* bufs = smem;                              // [2][bufp]
    unsigned* Wall = reinterpret_cast<unsigned*>(smem + 2 * g.bufp);
    unsigned* W = Wall + (threadIdx.x >> 5) * STAGE_W;       // this warp's
    unsigned* G = Wall + WARPS * STAGE_W;                    // [NPH][NP]
    unsigned* sxw = G + NPH * NP;                            // [4][sxp]
    int* syo = reinterpret_cast<int*>(sxw + 4 * g.sxp);      // [tile + 2]
    int* phc = syo + g.tile_rows + 2;                        // [tile + 2]

    const int b = blockIdx.x / g.tiles;
    const int r0 = (blockIdx.x - b * g.tiles) * g.tile_rows;
    const int nr = min(g.tile_rows, g.V - r0);
    const int base = add32(g.black_level, bp[b]), gain = wp[b], d = dco[b];
    // G[i][p], byte q: the slot's stored byte at phase u = 4i + 3q (mod
    // 12), from the table's row p (twelve phases, three 16-byte loads)
    for (int p = threadIdx.x; p < NP; p += THREADS) {
        const int4* row = reinterpret_cast<const int4*>(table + p * NU);
        const int4 t0 = row[0], t1 = row[1], t2 = row[2];
        const int t[NU] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y,
                           t1.z, t1.w, t2.x, t2.y, t2.z, t2.w};
#pragma unroll
        for (int i = 0; i < NPH; ++i) {
            unsigned v = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q)
                v |= (unsigned)(unsigned char)((mul32(add32(
                         base, t[(4 * i + 3 * q) % NU]), gain) / 100) >> 12)
                     << (8 * q);
            G[i * NP + p] = v;
        }
    }
    // the slot's burst (crt_nes.c:123-130): the angle hue + 360 / cc * k +
    // (y + dco) * vert_step + 33, reduced % 360 first (C's %), its sine >>
    // 10 from the table; the slot's first block also writes the ccf export
    for (int e = threadIdx.x; e < g.vp * g.cc; e += THREADS) {
        const int y = e / g.cc, k = e - y * g.cc;
        const int n = add32(add32(add32(hue[b], k * (360 / g.cc)),
                                  mul32(add32(y, d), g.vert_step)),
                            33) % 360;
        const int v = (g.blank_level + sines[n + 359] * g.burst_level) >> 5;
        bts[e] = (signed char)v;
        if (r0 == 0) ccf[(long long)b * g.vp * g.cc + e] = v << 7;
    }
    // copy c holds 4 * sx[x + c] (W's byte offset) at SX_PAD + x, 0 outside
    // [0, destw); sx = x*w / destw by a multiply (x*w < 2^28, destw <=
    // 4096: exact)
    for (int c = 0; c < 4; ++c)
        for (int e = threadIdx.x; e < g.sxp; e += THREADS) {
            const int x = e - SX_PAD + c;
            sxw[c * g.sxp + e] =
                x >= 0 && x < g.destw
                    ? 4u * (unsigned)(((unsigned long long)(x * g.w) *
                                       g.sx_mul) >> 40)
                    : 0u;
        }
    // field row r0 - 1 + e: the offset of its PPU row in the slot's pixels
    // (-1 outside the picture) and its phase class ph / 4
    for (int e = threadIdx.x; e < nr + 2; e += THREADS) {
        const int r = r0 - 1 + e, y = r - g.yo;
        syo[e] = y >= 0 && y < g.desth
                     ? min((int)((unsigned)(y * g.h) / (unsigned)g.desth),
                           g.h - 1) * g.w
                     : -1;
        phc[e] = phase_of(r, d, g.vp) >> 2;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
    const unsigned short* px = ppu + (long long)b * g.h * g.w;
    const int pb = bc[b] & 0x1FF;
    const unsigned blank = (unsigned char)g.blank_level * 0x01010101u;
    const unsigned sync = (unsigned char)g.sync_level * 0x01010101u;
    // this warp's picture rows of the next batch, loaded a batch ahead:
    // 16 bytes a lane
    int4 ahead[RPW];
    auto prefetch = [&](int ra) {
#pragma unroll
        for (int m = 0; m < RPW; ++m) {
            const int r = ra + wi + WARPS * m;
            const int o = r < r0 + nr ? syo[r - r0 + 1] : -1;
            if (g.staged && o >= 0 && 8 * lane < g.w)
                ahead[m] = *reinterpret_cast<const int4*>(px + o + 8 * lane);
        }
    };
    prefetch(r0);
    // every byte of both buffers starts at the blank level; writing a batch
    // out blanks its buffer again
    const uint4 blank4 = make_uint4(blank, blank, blank, blank);
    for (int c = 16 * threadIdx.x; c < 2 * g.bufp; c += 16 * THREADS)
        *reinterpret_cast<uint4*>(bufs + c) = blank4;
    __syncthreads();
    const long long f0 = (long long)b * g.V * g.H;  // the slot's first byte
    for (int k = 0, ra = r0; ra < r0 + nr; ++k, ra += ROWS) {
        unsigned char* buf = bufs + (k & 1) * g.bufp;
        // the batch's first byte sits at byte `off` of the 16-byte grid
        const int off = (int)(((uintptr_t)(analog + f0) +
                               (unsigned long long)ra * g.H) & 15);
        int4 now[RPW];
#pragma unroll
        for (int m = 0; m < RPW; ++m) now[m] = ahead[m];
        prefetch(ra + ROWS);
#pragma unroll
        for (int m = 0; m < RPW; ++m) {
            const int r = ra + wi + WARPS * m;
            if (r >= r0 + nr) break;
            const int pos0 = off + (wi + WARPS * m) * g.H;  // column 0 in buf
            const int po = syo[r - r0 + 1], pp = syo[r - r0];
            const unsigned* Gi = G + phc[r - r0 + 1] * NP;
            if (g.staged && po >= 0) {   // W = G[i][pixels] of this row
                __syncwarp();            // the last row's W is read
                if (8 * lane < g.w) {
                    const unsigned short* s =
                        reinterpret_cast<const unsigned short*>(&now[m]);
                    unsigned v[8];
#pragma unroll
                    for (int q = 0; q < 8; ++q) v[q] = Gi[s[q] & 0x1FF];
                    *reinterpret_cast<uint4*>(W + 8 * lane) =
                        make_uint4(v[0], v[1], v[2], v[3]);
                    *reinterpret_cast<uint4*>(W + 8 * lane + 4) =
                        make_uint4(v[4], v[5], v[6], v[7]);
                }
                __syncwarp();
            }
            // the picture's columns in this row, and the spill of the
            // previous picture row into it
            const int a_lo = po >= 0 ? g.xo : g.H;
            const int a_hi = po >= 0 ? min(g.H, g.xo + g.destw) : g.H;
            const int s_hi =
                pp >= 0 && g.xo + g.destw > g.H ? g.xo + g.destw - g.H : 0;
            // over the blank level: the sync, the burst (with 4 column
            // classes, the row's word rotated), the border where the
            // picture does not cover it (pixel 0xF0 in column lav)
            const int se = r >= g.sep_row ? g.sep_end : g.sync_end;
            span(buf, pos0, g.sync_beg, se, lane, [&](int) { return sync; });
            if (r >= g.br0 && r < g.br0 + g.brn) {
                const signed char* bt = bts + (r % g.vp) * g.cc;
                const unsigned w4 =
                    g.cc == 4 ? *reinterpret_cast<const unsigned*>(bt) : 0u;
                span(buf, pos0, g.bc0, g.bc0 + g.bcn, lane, [&](int c0) {
                    if (g.cc == 4) return __funnelshift_r(w4, w4, 8 * (c0 & 3));
                    unsigned u = 0;
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        u |= (unsigned)(unsigned char)bt[max(c0 + j, 0) % g.cc]
                             << (8 * j);
                    return u;
                });
            }
            if (g.border && r >= g.nb0 && r < g.nb1) {
                const unsigned wb = Gi[pb], w0 = Gi[0xF0] >> 16 & 0xFFu;
                auto border = [&](int c0) {
                    const int t = c0 - g.lav;
                    unsigned u = __funnelshift_r(wb, wb, 8 * ((t + 2) & 3));
                    if (t <= 0 && t > -4)
                        u = (u & ~(0xFFu << (-8 * t))) | w0 << (-8 * t);
                    return u;
                };
                span(buf, pos0, g.lav, max(g.lav, min(a_lo, g.H)), lane,
                     border);
                span(buf, pos0, max(g.lav, a_hi), g.H, lane, border);
            }
            if (s_hi > 0)
                picture<false>(buf, pos0, 0, s_hi, lane, g.xo - g.H, sxw,
                               g.sxp, nullptr, G + phc[r - r0] * NP, px + pp);
            if (po >= 0 && g.staged)
                picture<true>(buf, pos0, g.xo, a_hi, lane, g.xo, sxw, g.sxp,
                              reinterpret_cast<const unsigned char*>(W),
                              nullptr, nullptr);
            else if (po >= 0)
                picture<false>(buf, pos0, g.xo, a_hi, lane, g.xo, sxw, g.sxp,
                               nullptr, Gi, px + po);
        }
        __syncthreads();   // the batch is built; the other buffer written

        // write the batch's bytes [f0 + ra*H, f0 + rb*H) out, and blank
        // the buffer: a lane a 16-byte chunk of the field's grid; a chunk
        // that straddles the neighbouring rows takes this batch's bytes one
        // at a time
        const int rb = min(ra + ROWS, r0 + nr);
        signed char* at = analog + f0 + (long long)ra * g.H - off;
        const int n = off + (rb - ra) * g.H;
        for (int c = 16 * threadIdx.x; c < g.bufp; c += 16 * THREADS) {
            uint4* chunk = reinterpret_cast<uint4*>(buf + c);
            if (c >= off && c + 16 <= n) {
                *reinterpret_cast<uint4*>(at + c) = *chunk;
            } else if (c < n) {
                for (int j = max(c, off); j < min(c + 16, n); ++j)
                    at[j] = (signed char)buf[j];
            }
            *chunk = blank4;
        }
    }
}

int sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
        return 132;
    return n;
}

}  // namespace

extern "C" int ntsc_nes_square(void* analog, const void* ppu,
                               const void* table, const void* dco,
                               const void* bp, const void* wp, const void* bc,
                               const void* hue, const void* sines, void* ccf,
                               int B, int V, int H, int h, int w, int xo,
                               int yo, int destw, int desth, int vp,
                               int black_level, int border, int nb0, int nb1,
                               int lav, int sync_beg, int sync_end,
                               int sep_row, int sep_end, int sync_level,
                               int blank_level, int br0, int brn, int bc0,
                               int bcn, int cc, int vert_step,
                               int burst_level, void* stream) {
    if (B < 1 || V < 1 || H < 1 || h < 1 || h > 65535 || w < 1 ||
        w > 65535 || destw < 1 || destw > H || destw > MAX_DESTW ||
        desth < 1 || desth > 32767 || xo < 0 || xo >= H || yo < 0 ||
        yo >= V || vp < 1 || vp > (1 << 20) || nb0 < 0 || nb0 > nb1 ||
        nb1 > V || lav < 0 || lav >= H || (long long)h * w > INT_MAX ||
        sync_beg < 0 || sync_end < sync_beg || sep_end < sync_beg ||
        sync_end > H || sep_end > H || br0 < 0 || brn < 0 || br0 + brn > V ||
        bc0 < 0 || bcn < 0 || bc0 + bcn > H || cc < 1 || cc > 360 ||
        (long long)vp * cc > MAX_BURST || (long long)V * H > INT_MAX)
        return (int)cudaErrorInvalidValue;
    Geometry g{V, H, h, w, xo, yo, destw, desth, vp, black_level,
               border != 0, nb0, nb1, lav, sync_beg, sync_end, sep_row,
               sep_end, sync_level, blank_level, br0, brn, bc0, bcn, cc,
               vert_step, burst_level};
    // about four blocks an SM over the batch, at least a batch of rows each
    int tiles = min(4 * sm_count() / B, (V + ROWS - 1) / ROWS);
    tiles = max(tiles, 1);
    g.tile_rows = (V + tiles - 1) / tiles;
    g.tiles = (V + g.tile_rows - 1) / g.tile_rows;
    g.sxp = (SX_PAD + destw + 3 + 3) & ~3;
    g.sx_mul = ((1ULL << 40) + destw - 1) / destw;
    // a batch's rows and the bytes before its first on the 16-byte grid
    const long long bufp = ((long long)ROWS * H + 15 + 15) & ~15LL;
    // 16-byte loads of whole rows: 8-pixel rows on the 16-byte grid
    g.staged = w <= STAGE_W && w % 8 == 0 && ((uintptr_t)ppu & 15) == 0;
    const long long smem = shared_bytes((int)min(bufp, (long long)INT_MAX),
                                        g.sxp, g.tile_rows);
    const long long blocks = (long long)B * g.tiles;
    if (blocks > INT_MAX || smem > MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    g.bufp = (int)bufp;
    // above 48 KB with the static bts, a kernel's dynamic shared memory is
    // opted into, per card
    static int opted[64];   // the largest size set on each card
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
        return (int)cudaErrorInvalidValue;
    if (smem + MAX_BURST > 48 * 1024 && smem > opted[dev]) {
        if (cudaFuncSetAttribute(nes_square_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem) != cudaSuccess)
            return (int)cudaGetLastError();
        opted[dev] = (int)smem;
    }
    const auto s = static_cast<cudaStream_t>(stream);
    const auto i32 = [](const void* p) { return static_cast<const int*>(p); };
    nes_square_kernel<<<(unsigned)blocks, THREADS, (size_t)smem, s>>>(
        (signed char*)analog, static_cast<const unsigned short*>(ppu),
        i32(table), i32(dco), i32(bp), i32(wp), i32(bc), i32(hue),
        i32(sines), (int*)ccf, g);
    return (int)cudaGetLastError();
}
