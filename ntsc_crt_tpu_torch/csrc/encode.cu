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
//
// Field mode (FIELD, entry ntsc_encode_rows_field, 4-sample chroma): the
// launch writes the whole modulated field of the NTSC-family encoders,
// every byte once, into a fresh (B, V, H) tensor.  The block mode's output
// block and the torch passes around it (the skeleton picked by parity and
// laid over the caller's field, the burst, the block's store at (yo, xo),
// VHS's sync kill) each read and wrote the field again: 3.6 of 5.5 ms a
// step at B 2048 went to passes that copied, selected or overwrote the
// same bytes.  A byte takes, in order of precedence: VHS's sync kill
// (blank on the first bw_beg samples of a killed row), the picture, the
// burst (on the non-vsync rows), the skeleton of the frame's parity (where
// its mask says), the caller's sample.
// - Picture blocks store their rows at flat byte (yo + y) * H + xo + t of
//   the frame, so a row past H runs on into the next row and bytes past
//   the last row are dropped, and skip the bytes the kill owns.  A warp
//   whose rows lose no byte stores as the block mode does (store_rows),
//   one row H bytes after the last, in two runs where its rows cross into
//   the next frame; the others test every byte (store_field_rows: +21 %
//   on the whole launch where every warp took it).
// - Frame blocks, interleaved with them, write every other byte, a warp
//   32 field rows, lanes on consecutive bytes.  The skeleton's mask is a
//   prefix of each row, so a byte's source (kill, burst, skeleton or the
//   caller's field) follows from its row and column without a load: each
//   lane has FRAME_BATCH independent loads in flight before it stores,
//   and reads the caller's field only where nothing else writes.  They
//   are latency-bound and hide behind the picture's int32 work: 16 or 32
//   bytes a lane, or 8 rows a block, were no faster.
// At B 2048 on an H100 the launch takes 1.71 ms (NTSC-VHS) and 1.60 ms
// (bloom's 637 x 232 picture), against 1.59 and 1.34 ms for the block mode
// alone, which then left 0.85 and 0.71 ms of store and the passes.
#include <cuda_runtime.h>

#include <cstdint>

#include "int32.cuh"
#include "tile.cuh"

namespace {

constexpr int EXP_P = 11;
constexpr int FRAME_BATCH = 8;  // bytes a frame lane has in flight

// The field mode's arguments (unread in the block mode).
struct Field {
    const int8_t* prev;    // (B, V, H) the caller's field, read only
    const int8_t* skel;    // (2, V, H) the skeleton of each field parity
    const int* mask_end;   // (V,) the skeleton writes [0, mask_end[r])
    const uint8_t* vrows;  // (V,) 1 on the rows that carry the burst
    const int* parity;     // (B,) each frame's field parity, 0 or 1
    const int8_t* burst;   // (B, burst_len) each frame's burst samples
    const int* kill;       // (B,) VHS's killed bottom rows, or null
    int V, H, xo, yo, cb_beg, burst_len, bw_beg, blank;
    long long pic_blocks;  // blocks of picture rows
    long long frame_blocks;  // blocks of 32 field rows
};

// Block i of a field-mode launch: picture blocks and frame blocks
// alternate while both last, so the latency-bound frame writes overlap
// the picture's int32 work.  Returns the picture block's index, or -1 - the
// frame block's.
__device__ __forceinline__ long long field_block(const Field& f) {
    const long long i = blockIdx.x;
    const long long both = 2 * min(f.pic_blocks, f.frame_blocks);
    if (i < both) return i % 2 == 0 ? i / 2 : -1 - i / 2;
    const long long k = i - both / 2;
    return f.pic_blocks > f.frame_blocks ? k : -1 - k;
}

// A killed row's first bw_beg samples are VHS's (crt_ntscvhs.c:234-238).
__device__ __forceinline__ bool killed(const Field& f, int b, int r) {
    return f.kill != nullptr && f.vrows[r] && r >= f.V - f.kill[b];
}

// Every byte of 32 field rows (from row 32*fb of the B*V) that no
// picture row writes, or that VHS's kill takes from it.  Lane l first
// works out row l's spans: the kill's [0, kend), the picture's [lo, hi)
// (left alone), the previous picture row's spilled tail [kend, spill)
// (left alone too) and the skeleton's [0, mend); then the warp walks each
// row's other bytes, lanes on consecutive bytes.
__device__ void frame_rows(const Field& f, uint8_t* __restrict__ out, int B,
                           int desth, int destw, long long fb) {
    const int lane = threadIdx.x;
    const int V = f.V, H = f.H;
    const long long nrows = (long long)B * V;
    const long long row0 = fb * WARP_ROWS;
    const long long my = min(row0 + lane, nrows - 1);
    const int b = (int)(my / V), r = (int)(my - (long long)b * V);
    const int kend = killed(f, b, r) ? f.bw_beg : 0;
    const int y = r - f.yo;
    const bool pic = y >= 0 && y < desth;
    const int lo = pic ? max(f.xo, kend) : H;
    const int hi = pic ? max(min(f.xo + destw, H), lo) : H;
    const int spill =
        y - 1 >= 0 && y - 1 < desth ? f.xo + destw - H : 0;
    const int par = f.parity[b];
    const bool vr = f.vrows[r] != 0;
    const int mend = f.mask_end[r];
    const int nr = (int)min((long long)WARP_ROWS, nrows - row0);
    for (int q = 0; q < nr; ++q) {
        const int qb = __shfl_sync(0xffffffffu, b, q);
        const int qr = __shfl_sync(0xffffffffu, r, q);
        const int qkend = __shfl_sync(0xffffffffu, kend, q);
        const int qlo = __shfl_sync(0xffffffffu, lo, q);
        const int qhi = __shfl_sync(0xffffffffu, hi, q);
        const int qspill = __shfl_sync(0xffffffffu, spill, q);
        const int qpar = __shfl_sync(0xffffffffu, par, q);
        const bool qvr = __shfl_sync(0xffffffffu, (int)vr, q) != 0;
        const int qmend = __shfl_sync(0xffffffffu, mend, q);
        const long long at = ((long long)qb * V + qr) * H;
        const int8_t* sk = f.skel + ((long long)qpar * V + qr) * H;
        const int8_t* pv = f.prev + at;
        const int8_t* bu = f.burst + (long long)qb * f.burst_len;
        uint8_t* o = out + at;
        const int n = qlo + (H - qhi);  // [0, lo) then [hi, H)
        for (int k0 = 0; k0 < n; k0 += FRAME_BATCH * WARP_ROWS) {
            int c[FRAME_BATCH];
            bool w[FRAME_BATCH];
            int8_t v[FRAME_BATCH];
#pragma unroll
            for (int g = 0; g < FRAME_BATCH; ++g) {
                const int k = k0 + lane + WARP_ROWS * g;
                c[g] = k < qlo ? k : qhi + (k - qlo);
                w[g] = k < n && !(c[g] >= qkend && c[g] < qspill);
                const int cb = c[g] - f.cb_beg;
                if (!w[g]) continue;
                if (c[g] < qkend)
                    v[g] = (int8_t)f.blank;
                else if (qvr && cb >= 0 && cb < f.burst_len)
                    v[g] = bu[cb];
                else
                    v[g] = c[g] < qmend ? sk[c[g]] : pv[c[g]];
            }
#pragma unroll
            for (int g = 0; g < FRAME_BATCH; ++g)
                if (w[g]) o[c[g]] = (uint8_t)v[g];
        }
    }
}

// The field mode's picture stores: bytes [t0, t0 + nb) of the tile's rows,
// row q at flat byte dst[q] + t of the field where t lies in [lo[q],
// hi[q]) and outside [klo[q], khi[q]) (bytes the kill owns, or past the
// frame's last row); lanes on consecutive bytes, BATCH rows in flight.
// Fences the warp on both sides, as store_rows does.
__device__ __forceinline__ void store_field_rows(
    const uint8_t* tile, int pitch, uint8_t* out, const long long* dst,
    const int* lo, const int* hi, const int* klo, const int* khi, int nrows,
    int t0, int nb) {
    __syncwarp();
    const int lane = threadIdx.x % WARP_ROWS;
    for (int q0 = 0; q0 < nrows; q0 += BATCH) {
        for (int j = lane; j - lane < nb; j += WARP_ROWS) {
            const int t = t0 + j;
            bool ok[BATCH];
            uint8_t v[BATCH];
#pragma unroll
            for (int e = 0; e < BATCH; ++e) {
                const int q = min(q0 + e, nrows - 1);
                ok[e] = q0 + e < nrows && j < nb && t >= lo[q] &&
                        t < hi[q] && (t < klo[q] || t >= khi[q]);
                v[e] = ok[e] ? tile[q * pitch + j] : 0;
            }
#pragma unroll
            for (int e = 0; e < BATCH; ++e)
                if (ok[e]) out[dst[q0 + e] + t] = v[e];
        }
    }
    __syncwarp();
}

// Launched with one warp a block (WARP_ROWS threads), on picture rows
// 32*blockIdx.x ... (in the field mode, the picture block field_block
// gives; its frame blocks run frame_rows).
template <int CC, bool FIELD>
__global__ void __launch_bounds__(WARP_ROWS) encode_rows_kernel(
    const uint8_t* __restrict__ img,   // (B, h, w, 3)
    const int* __restrict__ sy,        // (B, desth) source row per output row
    const int* __restrict__ modI,      // (B, desth, CC) carrier tables,
    const int* __restrict__ modQ,      // phase sign in; (B, desth, CC)
    const int* __restrict__ gain,      // (B,)
    const int* __restrict__ base,      // (B,)
    uint8_t* __restrict__ out,         // (B, desth, destw) int8; FIELD:
                                       // the new field (B, V, H)
    int B, int h, int w, int desth, int destw, int xo_mod,
    int bandlimit, int cY, int cI, int cQ, bool words, Field f) {
    constexpr int S = CC == 4 ? 64 : 60;       // samples of a tile
    constexpr int NJ = 2;                      // of them a lane fetches
    static_assert(S % CC == 0 && S <= NJ * WARP_ROWS, "tile");
    constexpr int IPITCH = odd_pitch(3 * S);  // a row's source pixels
    constexpr int OPITCH = odd_pitch(S);      // a row's output samples
    __shared__ uint8_t itile[WARP_ROWS * IPITCH];
    __shared__ __align__(4) uint8_t otile[WARP_ROWS * OPITCH];
    __shared__ const uint8_t* srcs[WARP_ROWS];  // each row's image row
    // FIELD: each row's flat field byte of sample 0 and its stored span
    __shared__ long long fdst[WARP_ROWS];
    __shared__ int flo[WARP_ROWS], fhi[WARP_ROWS], fklo[WARP_ROWS],
        fkhi[WARP_ROWS];
    bool clean = false;  // FIELD: every byte of the warp's rows stored
    int split = 0;       // FIELD: the warp's first row of the next frame

    long long blk = blockIdx.x;
    if (FIELD) {
        blk = field_block(f);
        if (blk < 0) {
            frame_rows(f, out, B, desth, destw, -1 - blk);
            return;
        }
    }
    const int lane = threadIdx.x;
    const long long r0 = blk * WARP_ROWS;
    const int nrows =
        (int)min((long long)WARP_ROWS, (long long)B * desth - r0);
    // idle lanes of the last warp march a copy of its last row, unstored
    const long long row = r0 + min(lane, nrows - 1);
    const int b = (int)(row / desth);
    srcs[lane] = img + ((long long)b * h + sy[row]) * w * 3;
    if (FIELD) {
        // picture row y lands on field row yo + y from column xo; its
        // bytes at and past the frame's end are dropped; the kill takes
        // those of its first bw_beg columns, on its own row (t < lo) and
        // on the next, where a row past H spills ([klo, khi))
        const int y = (int)(row - (long long)b * desth);
        const int fr = f.yo + y;
        const long long flat = (long long)fr * f.H + f.xo;
        fdst[lane] = (long long)b * f.V * f.H + flat;
        fhi[lane] = (int)max(0LL, min((long long)destw,
                                      (long long)f.V * f.H - flat));
        flo[lane] = fr < f.V && killed(f, b, fr) ? f.bw_beg - f.xo : 0;
        const bool next = fr + 1 < f.V && killed(f, b, fr + 1);
        fklo[lane] = next ? f.H - f.xo : 0;
        fkhi[lane] = next ? f.H - f.xo + f.bw_beg : 0;
        const int b0 = (int)(r0 / desth);
        const unsigned later = __ballot_sync(0xffffffffu, b != b0);
        split = later ? __ffs(later) - 1 : WARP_ROWS;
        clean = __all_sync(0xffffffffu,
                           b - b0 <= 1 && flo[lane] <= 0 &&
                               fhi[lane] == destw &&
                               (!next || f.H - f.xo >= destw));
    }
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
        if (FIELD && clean) {
            const int q = min(split, nrows);
            store_rows(otile, OPITCH, out + fdst[0], f.H, 0, q, t0, n,
                       false);
            if (q < nrows)
                store_rows(otile + q * OPITCH, OPITCH, out + fdst[q], f.H, 0,
                           nrows - q, t0, n, false);
        } else if (FIELD)
            store_field_rows(otile, OPITCH, out, fdst, flo, fhi, fklo, fkhi,
                             nrows, t0, n);
        else
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
    encode_rows_kernel<CC, false><<<blocks, WARP_ROWS, 0, stream>>>(
        img, sy, modI, modQ, gain, base, out, B, h, w, desth, destw, xo_mod,
        bandlimit, cY, cI, cQ, words, Field{});
    return (int)cudaGetLastError();
}

int launch_field(const uint8_t* img, const int* sy, const int* modI,
                 const int* modQ, const int* gain, const int* base,
                 uint8_t* out, int B, int h, int w, int desth, int destw,
                 int bandlimit, int cY, int cI, int cQ, Field f,
                 cudaStream_t stream) {
    if (destw == 0) desth = 0;  // no picture: every byte is the frame's
    f.pic_blocks = ((long long)B * desth + WARP_ROWS - 1) / WARP_ROWS;
    f.frame_blocks = ((long long)B * f.V + WARP_ROWS - 1) / WARP_ROWS;
    const long long blocks = f.pic_blocks + f.frame_blocks;
    if (blocks == 0) return (int)cudaSuccess;
    encode_rows_kernel<4, true><<<(unsigned)blocks, WARP_ROWS, 0, stream>>>(
        img, sy, modI, modQ, gain, base, out, B, h, w, desth, destw,
        f.xo % 4, bandlimit, cY, cI, cQ, false, f);
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

// The field mode (4-sample chroma, the NTSC family): out (B, V, H) is
// written whole; prev is only read.  kill may be null (no VHS kill).
// Needs 0 <= xo < H, 0 <= yo and destw < H.
extern "C" int ntsc_encode_rows_field(
    const void* img, const void* sy, const void* modI, const void* modQ,
    const void* gain, const void* base, void* out, const void* prev,
    const void* skel, const void* mask_end, const void* vrows,
    const void* parity, const void* burst, const void* kill, int B, int h,
    int w, int desth, int destw, int cc, int bandlimit, int cY, int cI,
    int cQ, int V, int H, int xo, int yo, int cb_beg, int burst_len,
    int bw_beg, int blank, void* stream) {
    if (cc != 4 || xo < 0 || xo >= H || yo < 0 || destw >= H)
        return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    Field f{(const int8_t*)prev, (const int8_t*)skel, (const int*)mask_end,
            (const uint8_t*)vrows, (const int*)parity, (const int8_t*)burst,
            (const int*)kill, V, H, xo, yo, cb_beg, burst_len, bw_beg, blank,
            0, 0};
    return launch_field((const uint8_t*)img, (const int*)sy,
                        (const int*)modI, (const int*)modQ,
                        (const int*)gain, (const int*)base, (uint8_t*)out, B,
                        h, w, desth, destw, bandlimit, cY, cI, cQ, f, s);
}
