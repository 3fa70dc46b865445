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
// What bounds it on the H100: bytes in principle, the PPU pixels read and
// the field written (at batch 512 from 256x240 pixels, 62.9 MB and 121.9
// MB), against ~10 int32 instructions a picture sample; in this design,
// each warp's chain of shared-memory loads a word (PERF.md: a fifth of the
// byte bound at batch 512).
//
// What the design does about it:
// - square_sample reads only bits 0-8 of the pixel and the phase mod 12, so
//   S is a 512 x 12 table (the wrapper's, cached per card), and the whole
//   chain after it, S -> stored byte, is a function of (phase % 12, p) for
//   a slot.  A block takes rows of one slot: it first folds the slot's
//   black and white points into a 12 x 512 byte table in shared memory
//   (its loads issued eight at a time), so a sample's byte is one shared
//   load; it forms the slot's burst samples there too.
// - sx depends on x alone: the block tabulates it (uint16), four copies
//   shifted by 0..3 samples, so a lane reads a word's four sx with one
//   8-byte shared load whatever the row's alignment.  sy and the phase
//   class of each of the block's rows are tabulated too.
// - A warp takes one field row at a time, a lane one 4-byte word of it a
//   step, so each warp store covers 128 contiguous bytes.  The warp stages
//   its picture row's PPU pixels in shared memory (rows up to 256 pixels
//   on the 16-byte grid: NES's), one 16-byte load a lane issued a row
//   ahead, so no word waits on device memory.
// - A word inside one source takes that source's path and one 4-byte
//   store: the picture, the previous picture row's spill, the border, a
//   word of burst (with 4 column classes, the row's 4 samples rotated), a
//   word of one skeleton level; the words at a row's or a source's edge go
//   a byte at a time.  Writing the skeleton and the burst here, not by
//   torch, leaves the encoder one launch and no copy of the skeleton.
// Tried (PERF.md): PPU loads from device memory (24 % of the picture's
// bound), their loads hoisted 4 or 8 words a lane (125 and 64 registers:
// slower), a balanced single wave of blocks, 8- and 16-byte runs a lane
// (slower).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "int32.cuh"

namespace {

constexpr int THREADS = 256;         // 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int NP = 512, NU = 12;     // the table: pixel & 0x1FF, phase % 12
constexpr int MAX_TILE = 256;        // field rows a block, at most
constexpr int MAX_DESTW = 4096;      // sx's table: 4 copies of uint16
constexpr int STAGE_W = 256;         // PPU rows up to this wide are staged
constexpr int MAX_BURST = 64;        // a slot's burst table, vp x cc at most

struct Geometry {
    int V, H, h, w, xo, yo, destw, desth, vp, black_level;
    int border, nb0, nb1, lav;  // border rows [nb0, nb1), columns [lav, H)
    // the skeleton: blank, but sync over [sync_beg, sync_end), or over
    // [sync_beg, sep_end) from row sep_row on
    int sync_beg, sync_end, sep_row, sep_end, sync_level, blank_level;
    int br0, brn, bc0, bcn, cc;  // burst rows, columns; its column classes
    int vert_step, burst_level;  // the burst angle's step a row class
    int row0, nrows;            // the field rows a slot: all of them
    int tiles, tile_rows;       // blocks a slot, rows a block
    int sxp;                    // a copy of the sx table, in entries
    int staged;                 // PPU rows staged a row ahead
};

__host__ __device__ constexpr int shared_bytes(int sxp) {
    return NU * NP + 4 * sxp * 2 + 2 * (MAX_TILE + 1) * 4 +
           WARPS * STAGE_W * 2;
}

// 4 * ((row + dco) % vp) with C's %, 0 for a negative class
__device__ __forceinline__ int phase_of(int row, int dco, int vp) {
    const int cls = add32(row, dco) % vp;
    return cls >= 0 ? 4 * cls : 0;
}

// the four table rows of a word whose first sample sits at phase class ph
// (mod 12) and x % 4 == rho: sample k is at ph + 3 * ((rho + k) % 4)
__device__ __forceinline__ void word_rows(int ph, int rho, int (&u)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int v = ph + 3 * ((rho + k) & 3);
        u[k] = (v >= NU ? v - NU : v) * NP;
    }
}

// a word of four picture samples: sx of x0 .. x0 + 3 from sxc at j (8-byte
// aligned), the pixels from row, the bytes from F at rows u
__device__ __forceinline__ unsigned picture_word(
    const unsigned short* __restrict__ row, const unsigned short* sxc, int j,
    const int (&u)[4], const signed char* F) {
    const uint2 s = *reinterpret_cast<const uint2*>(sxc + j);
    const int q[4] = {(int)(s.x & 0xFFFFu), (int)(s.x >> 16),
                      (int)(s.y & 0xFFFFu), (int)(s.y >> 16)};
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        word |= (unsigned)(unsigned char)F[u[k] + (row[q[k]] & 0x1FF)]
                << (8 * k);
    return word;
}

// A block takes tile_rows field rows of one slot; a warp one row at a
// time, a lane one word of it a step.
template <bool VEC>
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
    // each warp's staged PPU row, first: its 16-byte stores need the grid
    unsigned short* stage =
        reinterpret_cast<unsigned short*>(smem) + (threadIdx.x >> 5) * STAGE_W;
    signed char* F = reinterpret_cast<signed char*>(
        smem + WARPS * STAGE_W * 2);                         // [NU][NP]
    unsigned short* sx =
        reinterpret_cast<unsigned short*>(F + NU * NP);      // [4][sxp]
    int* phr = reinterpret_cast<int*>(sx + 4 * g.sxp);       // [tile + 1]
    int* syw = phr + MAX_TILE + 1;                           // [tile + 1]

    const int b = blockIdx.x / g.tiles;
    const int r0 = g.row0 + (blockIdx.x - b * g.tiles) * g.tile_rows;
    const int nr = min(g.tile_rows, g.row0 + g.nrows - r0);
    const int base = add32(g.black_level, bp[b]), gain = wp[b], d = dco[b];
    // the slot's stored byte for each (phase % 12, p)
#pragma unroll 8
    for (int i = threadIdx.x; i < NU * NP; i += THREADS) {
        const int u = i / NP, p = i - u * NP;
        F[i] = (signed char)((mul32(add32(base, table[p * NU + u]), gain) /
                              100) >> 12);
    }
    // the slot's burst (crt_nes.c:123-130): the angle hue + 360 / cc * k +
    // (y + dco) * vert_step + 33, reduced % 360 first (C's %), its sine >>
    // 10 from the table; the slot's first block also writes the ccf export
    for (int i = threadIdx.x; i < g.vp * g.cc; i += THREADS) {
        const int y = i / g.cc, k = i - y * g.cc;
        const int n = add32(add32(add32(hue[b], k * (360 / g.cc)),
                                  mul32(add32(y, d), g.vert_step)),
                            33) % 360;
        const int v = (g.blank_level + sines[n + 359] * g.burst_level) >> 5;
        bts[i] = (signed char)v;
        if (r0 == g.row0) ccf[(long long)b * g.vp * g.cc + i] = v << 7;
    }
    // copy c holds sx[j + c] at j
    for (int i = threadIdx.x; i < 4 * g.sxp; i += THREADS) {
        const int c = i / g.sxp, x = i - c * g.sxp + c;
        sx[i] = x < g.destw
                    ? (unsigned short)((unsigned)(x * g.w) / (unsigned)g.destw)
                    : (unsigned short)0;
    }
    // field row r0 - 1 + i: its phase class (mod 12) and, if it is a picture
    // row, the offset of its PPU row (else -1)
    for (int i = threadIdx.x; i <= nr; i += THREADS) {
        const int r = r0 - 1 + i, y = r - g.yo;
        phr[i] = phase_of(r, d, g.vp) % NU;
        syw[i] = y >= 0 && y < g.desth
                     ? min((int)((long long)y * g.h / g.desth), g.h - 1) * g.w
                     : -1;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const unsigned short* px = ppu + (long long)b * g.h * g.w;
    const int pb = bc[b] & 0x1FF;
    // the warp's next picture row, loaded a row ahead: 16 bytes a lane
    const bool staged = g.staged;
    int4 ahead = make_int4(0, 0, 0, 0);
    const int wi0 = threadIdx.x >> 5;
    if (staged && wi0 < nr && syw[wi0 + 1] >= 0 && 8 * lane < g.w)
        ahead = *reinterpret_cast<const int4*>(px + syw[wi0 + 1] + 8 * lane);
    for (int i = threadIdx.x >> 5; i < nr; i += WARPS) {
        const int r = r0 + i;
        if (staged) {
            __syncwarp();
            if (8 * lane < g.w)
                *reinterpret_cast<int4*>(stage + 8 * lane) = ahead;
            __syncwarp();
            const int in = i + WARPS;
            if (in < nr && syw[in + 1] >= 0 && 8 * lane < g.w)
                ahead = *reinterpret_cast<const int4*>(px + syw[in + 1] +
                                                       8 * lane);
        }
        const long long f0 = ((long long)b * g.V + r) * g.H;  // column 0
        // the sources: the picture row r - yo over columns [xo, a_hi); the
        // previous picture row's spill over [0, s_hi); the border over
        // [b_lo, H), under both
        const bool act = syw[i + 1] >= 0;
        const int a_hi = act ? min(g.H, g.xo + g.destw) : g.xo;
        const int s_hi = syw[i] >= 0 && g.xo + g.destw > g.H
                             ? g.xo + g.destw - g.H
                             : 0;
        const int b_lo = g.border && r >= g.nb0 && r < g.nb1 ? g.lav : g.H;
        // under them the burst over [u_lo, u_hi) and the skeleton: sync
        // over [g.sync_beg, se), blank elsewhere
        const bool brow = r >= g.br0 && r < g.br0 + g.brn;
        const int u_lo = brow ? g.bc0 : g.H, u_hi = brow ? g.bc0 + g.bcn : g.H;
        const int se = r >= g.sep_row ? g.sep_end : g.sync_end;
        const signed char* bt = bts + (r % g.vp) * g.cc;
        // words start at column cf + 4k: on the buffer's 4-byte grid (VEC),
        // else at the row's first byte
        const int cf = VEC ? -(int)(f0 & 3) : 0;
        // a word of burst: with 4 column classes, the row's 4 samples
        // rotated to the word's first column
        unsigned uword = 0;
        if (g.cc == 4) {
            const unsigned w4 = *reinterpret_cast<const unsigned*>(bt);
            uword = __funnelshift_r(w4, w4, 8 * (cf & 3));
        }
        const int ra = (cf - g.xo) & 3, rs = (cf + g.H - g.xo) & 3;
        const int rb = (cf - g.lav) & 3;
        int ua[4], us[4], ub[4];
        word_rows(phr[i + 1], ra, ua);
        word_rows(phr[i], rs, us);
        const int phb = phr[i + 1] + 6;
        word_rows(phb >= NU ? phb - NU : phb, rb, ub);
        unsigned bword = 0;  // a word of border after its first column
#pragma unroll
        for (int k = 0; k < 4; ++k)
            bword |= (unsigned)(unsigned char)F[ub[k] + pb] << (8 * k);
        const unsigned short* rowa =
            staged ? stage : px + (act ? syw[i + 1] : 0);
        const unsigned short* rows = px + (syw[i] >= 0 ? syw[i] : 0);
        const unsigned short* sxa = sx + ra * g.sxp;
        const unsigned short* sxs = sx + rs * g.sxp;
        const int k_hi = (g.H - cf + 3) >> 2;
        for (int k = lane; k < k_hi; k += 32) {
            const int c0 = cf + 4 * k;
            signed char* dst = analog + f0 + c0;
            const bool inside = c0 >= 0 && c0 + 4 <= g.H;
            unsigned word;
            if (inside && c0 >= g.xo && c0 + 4 <= a_hi) {
                word = picture_word(rowa, sxa, c0 - g.xo - ra, ua, F);
            } else if (inside && c0 + 4 <= s_hi) {
                word = picture_word(rows, sxs, c0 + g.H - g.xo - rs, us, F);
            } else if (inside && c0 > b_lo && c0 >= s_hi &&
                       (c0 + 4 <= g.xo || c0 >= a_hi)) {
                word = bword;
            } else if (g.cc == 4 && inside && c0 >= u_lo && c0 + 4 <= u_hi &&
                       c0 >= s_hi && c0 + 4 <= b_lo &&
                       (c0 + 4 <= g.xo || c0 >= a_hi)) {
                word = uword;
            } else if (inside && c0 >= s_hi && c0 + 4 <= b_lo &&
                       (c0 + 4 <= g.xo || c0 >= a_hi) &&
                       (c0 + 4 <= u_lo || c0 >= u_hi) &&
                       (c0 + 4 <= g.sync_beg || c0 >= se ||
                        (c0 >= g.sync_beg && c0 + 4 <= se))) {
                const bool sync = c0 >= g.sync_beg && c0 < se;
                word = (unsigned)(unsigned char)(sync ? g.sync_level
                                                      : g.blank_level) *
                       0x01010101u;
            } else {
                // an edge: each byte from its own source, or left as it is
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = c0 + j;
                    int x, at;
                    const unsigned short* src;
                    if (c < 0 || c >= g.H) continue;
                    if (c >= g.xo && c < a_hi) {
                        x = c - g.xo, src = rowa, at = phr[i + 1];
                    } else if (c < s_hi) {
                        x = c + g.H - g.xo, src = rows, at = phr[i];
                    } else if (c >= b_lo) {
                        const int t = c - g.lav;
                        const int v = phb + 3 * (t & 3);
                        dst[j] = F[(v % NU) * NP + (t == 0 ? 0xF0 : pb)];
                        continue;
                    } else if (c >= u_lo && c < u_hi) {
                        dst[j] = bt[c % g.cc];
                        continue;
                    } else {
                        dst[j] = (signed char)(c >= g.sync_beg && c < se
                                                   ? g.sync_level
                                                   : g.blank_level);
                        continue;
                    }
                    const int v = at + 3 * (x & 3);
                    dst[j] = F[(v % NU) * NP + (src[sx[x]] & 0x1FF)];
                }
                continue;
            }
            if (VEC) {
                *reinterpret_cast<unsigned*>(dst) = word;
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    dst[j] = (signed char)(word >> 8 * j);
            }
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
        (long long)vp * cc > MAX_BURST)
        return (int)cudaErrorInvalidValue;
    Geometry g{V, H, h, w, xo, yo, destw, desth, vp, black_level,
               border != 0, nb0, nb1, lav, sync_beg, sync_end, sep_row,
               sep_end, sync_level, blank_level, br0, brn, bc0, bcn, cc,
               vert_step, burst_level};
    g.row0 = 0;  // every row: the skeleton and burst are written too
    g.nrows = V;
    // about four blocks an SM over the batch, at least a warp's row each
    int tiles = min(4 * sm_count() / B, (g.nrows + WARPS - 1) / WARPS);
    tiles = max(max(tiles, 1), (g.nrows + MAX_TILE - 1) / MAX_TILE);
    g.tile_rows = (g.nrows + tiles - 1) / tiles;
    g.tiles = (g.nrows + g.tile_rows - 1) / g.tile_rows;
    g.sxp = (destw + 3) & ~3;
    // 16-byte loads of whole rows: 8-pixel rows on the 16-byte grid
    g.staged = w <= STAGE_W && w % 8 == 0 && ((uintptr_t)ppu & 15) == 0;
    const long long blocks = (long long)B * g.tiles;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    const auto s = static_cast<cudaStream_t>(stream);
    const int smem = shared_bytes(g.sxp);
    const auto i32 = [](const void* p) { return static_cast<const int*>(p); };
    const auto* px = static_cast<const unsigned short*>(ppu);
    if (((uintptr_t)analog & 3) == 0)
        nes_square_kernel<true><<<(unsigned)blocks, THREADS, smem, s>>>(
            (signed char*)analog, px, i32(table), i32(dco), i32(bp), i32(wp),
            i32(bc), i32(hue), i32(sines), (int*)ccf, g);
    else
        nes_square_kernel<false><<<(unsigned)blocks, THREADS, smem, s>>>(
            (signed char*)analog, px, i32(table), i32(dco), i32(bp), i32(wp),
            i32(bc), i32(hue), i32(sines), (int*)ccf, g);
    return (int)cudaGetLastError();
}
