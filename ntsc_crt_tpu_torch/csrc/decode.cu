// K2 decode_rows: per-line sample alignment + Y/I/Q demodulation + EQ + lerp
// scan conversion + YIQ->RGB + contrast + clamp, one (frame, line) row per
// lane.
//
// Replaces: ntsc_crt_tpu/ops/pallas/decode_fused.py::decode_fused_rows
// (kernel body _make_kernel) in all its modes — the 3-band EQ (_eq_chain),
// the convolution EQ (coefs=("conv", taps), _fir_chain) and the bloom scan
// conversion (bloom_dx/bloom_lidx).
//
// Per sample t a lane takes sig[shift + t] of its line, read in place from
// the noisy field (B, V, H): line l starts on field row line_row[l] and
// continues into the next (the reference's flat reads, crt_core.c:538-543),
// so its sample x < 2H is byte (line_row * H + x) mod (V * H) of its frame;
// a line on row V - 1 continues at the frame's row 0.  It then
// forms Y = s + bright and I/Q = s*wave >> 9 with the wave phase t % CC, and
// runs the three equalizers held in registers: the 11-int 3-band chain
// (crt_core.c:206-233) or a FIR of 4-7 taps keeping taps-1 inputs of
// history (crt_core.c:96-147).  The scan conversion streams: lerp sources
// s(p) = (p*dx) >> 12 are monotone, so pixel p is emitted as soon as samples
// s(p) and s(p)+1 exist, from the last two EQ outputs kept in registers —
// the oy/oi/oq rows never exist in memory.
//
// Bloom mode (crt_core.c:512-532): every row has its own dx and EQ start
// lidx (folded into the shift and the wave tables by the caller).  The walk
// is driven by the pixels: pixel p needs samples min(t, n_eq-1) and
// min(t+1, n_eq-1), t = max((p*dx) >> 12, 0); the EQ advances until it has
// them.  dx > 0 on the decode path keeps that monotone; a source that moves
// back (dx <= 0 or a wrapped p*dx, never on the path) restarts the EQ at
// sample 0, so every input has one defined result.  The EQ runs on zero
// input from av to n_eq, and the right source reads zero where t+1 ==
// av-1-lidx (the reference's never-written out[AV-1]), as the TPU kernel
// does (decode_fused.py:239-266).
//
// What bounded the first design (one thread a row, reading and writing its
// own row) on the H100: its stores.  A thread wrote its row's 3*outw bytes
// one at a time and a warp's 32 lanes sat on 32 rows, so every warp store
// wrote 32 separate 32-byte sectors for 32 useful bytes.  Every mode took
// the same time whatever its EQ or chroma width (0.57 ms at batch 64,
// 4.5 ms at batch 512, PERF.md): ~51 G single-byte sector writes a second.
//
// Design: a warp owns 32 rows, one lane a row, the EQ state in registers;
// one warp a block, so batch 1's 240 rows spread over 8 SMs.
// - Input: the warp copies each of its rows' samples into a shared-memory
//   tile as whole aligned 4-byte words, consecutive lanes on consecutive
//   words, 8 loads a lane in flight before the first is stored (tile.cuh:
//   copy_block); a lane reads its row from its shift's byte offset, and
//   bytes outside the line's two field rows or from av on are masked to 0.
//   Only a tile that keeps a byte past a row's frame end (a line on row
//   V - 1 reading on into row 0: one line a frame at most, in its last
//   tile) takes the frame-aware load, which reads a word cut by the line's
//   start or the frame's end byte by byte; every other tile reads plain
//   aligned words, as from a copy of the rows.  At batch 512 on an H100
//   80GB HBM3 at 700 W, a test a word cost 5.5 %, this warp vote a tile
//   1.4 % (chip_smoke.time_variants, NTSC's inputs).
// - Output: each lane writes its pixels' R, G, B into a 32-row x 32-pixel
//   tile, which the warp writes out a row at a time (tile.cuh: store_rows,
//   4-byte words where outw % 4 == 0, else bytes).
// - Static mode, per tile of 8*CC samples, two passes: the EQ march alone,
//   its Y/I/Q outputs into this lane's row of a shared-memory ring (no
//   branch between a whole tile's samples, so their chains overlap), then
//   the pixels whose right source lies in the tile, from the ring.  dx is
//   one number for the launch, so every lane emits the same pixels and the
//   warp flushes the output tile in lockstep.
// - Bloom mode: each row has its own dx, so the warp stages each row's
//   whole window (n_eq samples, dynamic shared memory) and walks the pixels
//   in lockstep, the EQ advancing per lane, flushing every 32 pixels.
// What bounds it now: at batch 512, the int32 work (~50 source ops a
// sample for each of the three EQs) with at most 13 warps an SM (17 KB of
// shared memory a warp); at batch 1 and 64, one warp a scheduler, so each
// row's EQ chains wait on their own latency.  Tried and dropped: a row's
// Y/I/Q on three lanes (warp shuffles to emit) — faster at batch 1, 1.5x
// slower at batch 512 (PERF.md).  The TPU kernel's coarse pre-shift, block
// rebase and alignment funnel are not carried over: the alignment is the
// staging copy's offset.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "eq3.cuh"  // ThreeBand, the 3-band equalizer of one channel
#include "int32.cuh"
#include "tile.cuh"

namespace {

constexpr int MAX_TAPS = 7;
constexpr int P = 32;                    // pixels of an output tile
constexpr int OPITCH = odd_pitch(3 * P);  // its row pitch in bytes

// Static mode: samples of an input tile, and the row pitch (in ints, odd)
// of the ring that holds a tile's EQ outputs, Y/I/Q of samples t0 - 1 ..
// t0 + TS - 1
template <int CC>
constexpr int TS = 8 * CC;
template <int CC>
constexpr int RPITCH = 3 * (TS<CC> + 1);

struct FirCoefs {
    int w[MAX_TAPS];
    int shift;
};

// the convolution EQ: out = (sum_k w_k * s_{i-k}) >> shift, zero history
// at the line start (crt_core.c:96-147)
template <int TAPS>
struct Fir {
    using Coefs = FirCoefs;
    int h[TAPS - 1];  // h[k] = s_{i-1-k}

    __device__ void reset() {
#pragma unroll
        for (int k = 0; k < TAPS - 1; ++k) h[k] = 0;
    }

    __device__ int step(int x, const FirCoefs& c) {
        int acc = mul32(c.w[0], x);
#pragma unroll
        for (int k = 1; k < TAPS; ++k) acc = add32(acc, mul32(c.w[k], h[k - 1]));
#pragma unroll
        for (int k = TAPS - 2; k > 0; --k) h[k] = h[k - 1];
        h[0] = x;
        return acc >> c.shift;
    }
};

__device__ __forceinline__ uint8_t to_u8(int v, int contrast) {
    return (uint8_t)clamp_int(mul32(v >> 12, contrast) >> 8, 0, 255);
}

// crt_core.c:566-611: lerp of samples a and b, YIQ -> RGB, contrast, clamp
__device__ __forceinline__ void emit(uint8_t* px, int ay, int ai, int aq,
                                     int by, int bi, int bq, int pos,
                                     int ct) {
    const int Rw = pos & 0xFFF;
    const int Lw = 0xFFF - Rw;
    const int y = add32(mul32(ay, Lw) >> 2, mul32(by, Rw) >> 2);
    const int i = add32(mul32(ai, Lw) >> 14, mul32(bi, Rw) >> 14);
    const int q = add32(mul32(aq, Lw) >> 14, mul32(bq, Rw) >> 14);
    px[0] = to_u8(add32(add32(y, mul32(3879, i)), mul32(2556, q)), ct);
    px[1] = to_u8(sub32(sub32(y, mul32(1126, i)), mul32(2605, q)), ct);
    px[2] = to_u8(add32(sub32(y, mul32(4530, i)), mul32(7021, q)), ct);
}

// a word of a row's samples and the mask of those that exist
struct Word {
    uint32_t v, keep;
};

// bytes from the aligned word at or before sample 0 of a line shifted by sh
__device__ __forceinline__ int aligned_by(const int8_t* line, int sh) {
    return (int)((reinterpret_cast<uintptr_t>(line) + sh) & 3);
}

// The kept bytes of samples x .. x + 3 of a line one at a time: sample
// x + k lies at line[x + k], or, at or past fe (the frame's end, from the
// line), vh bytes earlier, at the frame's start
__device__ __forceinline__ uint32_t line_bytes(const int8_t* line,
                                               long long x, long long fe,
                                               long long vh, uint32_t keep) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if ((keep >> (8 * k)) & 0xFFu) {
            const long long at = x + k >= fe ? x + k - vh : x + k;
            v |= (uint32_t)(uint8_t)line[at] << (8 * k);
        }
    }
    return v;
}

// Launched with one warp a block (WARP_ROWS threads), on rows
// 32*blockIdx.x ...; dynamic shared memory: the output tile (32 x OPITCH
// bytes), in static mode the ring (32 x RPITCH ints), then the input tile
// (32 x ipitch bytes).
template <int CC, class Eq, bool BLOOM>
__global__ void __launch_bounds__(WARP_ROWS) decode_rows_kernel(
    const int8_t* __restrict__ field,    // (B, V, H) the noisy field
    const int* __restrict__ line_row,    // (B, L) line l's first field row
    const int* __restrict__ shifts,      // (B, L) sample offset of line l
    const int* __restrict__ waveI,       // (B, L, CC)
    const int* __restrict__ waveQ,       // (B, L, CC)
    const int* __restrict__ bright,      // (B, L)
    const int* __restrict__ contrast,    // (B, L)
    const int* __restrict__ bloom_dx,    // (B, L), bloom mode only
    const int* __restrict__ bloom_lidx,  // (B, L), bloom mode only
    uint8_t* __restrict__ out,           // (B, L, outw, 3)
    int B, int L, int V, int H, int av, int n_eq, int outw,
    int dx, int ipitch, bool words, typename Eq::Coefs cy,
    typename Eq::Coefs ci, typename Eq::Coefs cq) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* otile = smem;
    int* ring = reinterpret_cast<int*>(smem + WARP_ROWS * OPITCH);
    int8_t* itile = reinterpret_cast<int8_t*>(
        ring + (BLOOM ? 0 : WARP_ROWS * RPITCH<CC>));
    __shared__ const int8_t* lines[WARP_ROWS];  // each row's field line,
    __shared__ int starts[WARP_ROWS];           // its shift
    __shared__ int fends[WARP_ROWS];            // and its frame's end

    const int lane = threadIdx.x;
    const long long r0 = (long long)blockIdx.x * WARP_ROWS;
    const int nrows = (int)min((long long)WARP_ROWS, (long long)B * L - r0);
    // idle lanes of the last warp march a copy of its last row, unstored
    const long long r = r0 + min(lane, nrows - 1);
    const int b = (int)(r / L);
    const int l = (int)(r % L);
    const int sh = shifts[r];
    const int lr = line_row[r];
    const int8_t* line = field + ((long long)b * V + lr) * H;
    lines[lane] = line;
    starts[lane] = sh;
    fends[lane] = (V - lr) * H;  // the frame's end, from the line
    int wi[CC], wq[CC];
#pragma unroll
    for (int k = 0; k < CC; ++k) {
        wi[k] = waveI[r * CC + k];
        wq[k] = waveQ[r * CC + k];
    }
    const int br = bright[r];
    const int ct = contrast[r];
    Eq sy, si, sq;
    sy.reset();
    si.reset();
    sq.reset();
    // this lane's input row, from its sample t0 (a tile starts at the
    // aligned word at or before it), and its output row
    const int8_t* mine = itile + lane * ipitch + aligned_by(line, sh);
    uint8_t* opx = otile + lane * OPITCH;

    // samples [t0, t0 + n) of every row into the input tile (t0 a multiple
    // of 4), as whole aligned words: 0 outside the line's two field rows
    // and from av on
    auto stage = [&](int t0, int n) {
        __syncwarp();  // lines/starts written; the last tile marched
        // word c of row q: its first byte's x, and the row's end
        auto at = [&](int q, int c, long long& x, long long& hi) {
            const int s = starts[q];
            x = (long long)s + t0 - aligned_by(lines[q], s) + 4 * c;
            hi = min(2LL * H, (long long)s + av);
        };
        // the tile's words on a row end before byte x_end; where a row
        // keeps a byte at or past its frame's end (a line on row V - 1
        // that continues on row 0), the warp reads the tile's words
        // through the frame-aware load, else as plain aligned words
        // (in wrapping int32: a shift so large that the sums wrap keeps no
        // byte, and reads none)
        const int s = starts[lane];
        const int x_end = add32(s, t0 - aligned_by(lines[lane], s) +
                                       4 * ((n + 6) / 4));
        const bool wraps = __any_sync(
            0xffffffffu,
            min(x_end, min(2 * H, add32(s, av))) > fends[lane]);
        auto copy = [&](auto wrap) {
            copy_block<Word>(
                nrows, (n + 6) / 4,
                [&](int q, int c) {
                    long long x, hi;
                    at(q, c, x, hi);
                    uint32_t keep = 0;  // the bytes in [0, hi)
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        if (x + k >= 0 && x + k < hi)
                            keep |= 0xFFu << (8 * k);
                    if (!keep) return Word{0u, 0u};
                    if constexpr (decltype(wrap)::value) {
                        const long long fe = fends[q];
                        if (x < 0 || x + 3 >= fe)
                            return Word{line_bytes(lines[q], x, fe,
                                                   (long long)V * H, keep),
                                        keep};
                    }
                    return Word{
                        *reinterpret_cast<const uint32_t*>(lines[q] + x),
                        keep};
                },
                [&](int q, int c, Word w) {
                    reinterpret_cast<uint32_t*>(itile + q * ipitch)[c] =
                        w.v & w.keep;
                });
        };
        if (wraps)
            copy(std::true_type{});
        else
            copy(std::false_type{});
        __syncwarp();
    };
    int p0 = 0;  // first pixel of the output tile
    auto flush = [&](int p) {  // the tile holds pixels [p0, p)
        store_rows(otile, OPITCH, out, 3LL * outw, r0, nrows, 3LL * p0,
                   3 * (p - p0), words);
        p0 = p;
    };

    if constexpr (!BLOOM) {
        // Per tile, two passes: the EQ march alone (no branch between its
        // samples, so their chains overlap) into this lane's ring row, then
        // the pixels whose right source lies in the tile, each from the
        // ring — the same for every lane.
        constexpr int T = TS<CC>;
        int* mr = ring + lane * RPITCH<CC>;  // slot s: sample t0 - 1 + s
        mr[0] = mr[1] = mr[2] = 0;           // sample -1
        int p = 0, pos = 0;                  // next pixel, its 12-bit source
        auto march = [&](int j, int k) {     // sample t0 + j, phase k
            const int sx = mine[j];
            // crt_core.c:538-543
            mr[3 * j + 3] = (int)((unsigned)sy.step(add32(sx, br), cy) << 4);
            mr[3 * j + 4] = si.step(mul32(sx, wi[k]) >> 9, ci) >> 3;
            mr[3 * j + 5] = sq.step(mul32(sx, wq[k]) >> 9, cq) >> 3;
        };
        for (int t0 = 0; t0 < av; t0 += T) {
            const int n = min(T, av - t0);
            stage(t0, n);
            if (n == T) {
                for (int j = 0; j < T; j += CC) {
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
            // pixels whose right source t = (pos >> 12) + 1 is in the tile
            for (; p < outw && (pos >> 12) + 1 < t0 + n; ++p, pos += dx) {
                const int* a = mr + 3 * ((pos >> 12) - t0 + 1);
                emit(opx + 3 * (p - p0), a[0], a[1], a[2], a[3], a[4], a[5],
                     pos, ct);
                if (p + 1 - p0 == P) flush(p + 1);
            }
            mr[0] = mr[3 * n];  // the tile's last sample leads the next
            mr[1] = mr[3 * n + 1];
            mr[2] = mr[3 * n + 2];
        }
        if (p > p0) flush(p);
    } else {
        stage(0, n_eq);  // the whole window
        const int dxr = bloom_dx[r];
        const int zb = av - 1 - bloom_lidx[r];  // forced-zero source
        int cur = -1, k = 0;        // last sample made; phase of the next
        int y0 = 0, i0 = 0, q0 = 0;  // EQ outputs of sample cur - 1
        int y1 = 0, i1 = 0, q1 = 0;  // and of sample cur
        for (int p = 0; p < outw; ++p) {
            const int pos = mul32(p, dxr);
            const int t = max(pos >> 12, 0);
            const int need = min(t + 1, n_eq - 1);
            if (need < cur) {  // the source moved back: restart the line
                sy.reset();
                si.reset();
                sq.reset();
                cur = -1;
                k = 0;
            }
            while (cur < need) {
                ++cur;
                const int sx = mine[cur];
                int wvi = wi[0], wvq = wq[0];
#pragma unroll
                for (int j = 1; j < CC; ++j) {
                    if (k == j) {
                        wvi = wi[j];
                        wvq = wq[j];
                    }
                }
                k = (k + 1 == CC) ? 0 : k + 1;
                y0 = y1;
                i0 = i1;
                q0 = q1;
                y1 = (int)((unsigned)sy.step(add32(sx, br), cy) << 4);
                i1 = si.step(mul32(sx, wvi) >> 9, ci) >> 3;
                q1 = sq.step(mul32(sx, wvq) >> 9, cq) >> 3;
            }
            // left source min(t, n_eq-1): sample cur when clamped, else cur-1
            const bool clamped = t >= n_eq - 1;
            const bool zero = t + 1 == zb;
            emit(opx + 3 * (p - p0), clamped ? y1 : y0, clamped ? i1 : i0,
                 clamped ? q1 : q0, zero ? 0 : y1, zero ? 0 : i1,
                 zero ? 0 : q1, pos, ct);
            if (p + 1 - p0 == P || p + 1 == outw) flush(p + 1);
        }
    }
}

template <int CC, class Eq, bool BLOOM>
int launch(const int8_t* field, const int* line_row, const int* shifts,
           const int* waveI, const int* waveQ, const int* bright,
           const int* contrast, const int* bloom_dx, const int* bloom_lidx,
           uint8_t* out, int B, int L, int V, int H, int av, int n_eq,
           int outw,
           const typename Eq::Coefs* c, cudaStream_t stream) {
    const long long n = (long long)B * L;
    if (n == 0) return (int)cudaSuccess;
    const unsigned blocks = (unsigned)((n + WARP_ROWS - 1) / WARP_ROWS);
    const int dx = ((av - 1) << 12) / outw;
    // a row's words: its samples plus up to 3 bytes before the first
    const int ipitch = odd_pitch(4 * (((BLOOM ? n_eq : TS<CC>) + 6) / 4));
    const size_t smem = (size_t)WARP_ROWS *
                        (OPITCH + ipitch + (BLOOM ? 0 : 4 * RPITCH<CC>));
    auto kernel = decode_rows_kernel<CC, Eq, BLOOM>;
    if (smem > 48 * 1024) {  // a long bloom window: opt in above 48 KB
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const bool words =
        outw % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
    kernel<<<blocks, WARP_ROWS, smem, stream>>>(
        field, line_row, shifts, waveI, waveQ, bright, contrast, bloom_dx,
        bloom_lidx, out, B, L, V, H, av, n_eq, outw, dx, ipitch, words, c[0],
        c[1], c[2]);
    return (int)cudaGetLastError();
}

template <int CC, class Eq, class Args>
int dispatch_bloom(bool bloom, Args&& args, const typename Eq::Coefs* c) {
    return bloom ? args(launch<CC, Eq, true>, c)
                 : args(launch<CC, Eq, false>, c);
}

}  // namespace

// eq: 0 = 3-band with coefs host int[15], (lf, hf, g_lo, g_mid, g_hi) for
// Y, I, Q; 4..7 = the FIR of that many taps with coefs host int[taps + 1],
// the weights then the shift.  bloom_dx/bloom_lidx null: the static scan
// conversion; both given: bloom mode.  Each line_row lies in [0, V).
extern "C" int ntsc_decode_rows(
    const void* field, const void* line_row, const void* shifts,
    const void* waveI, const void* waveQ, const void* bright,
    const void* contrast, const void* bloom_dx, const void* bloom_lidx,
    const void* coefs, void* out, int B, int L, int V, int H, int av,
    int n_eq, int outw, int cc, int eq, void* stream) {
    const int* k = (const int*)coefs;
    auto s = static_cast<cudaStream_t>(stream);
    const bool bloom = bloom_dx != nullptr;
    if (bloom != (bloom_lidx != nullptr)) return (int)cudaErrorInvalidValue;
    auto args = [&](auto fn, auto c) {
        return fn((const int8_t*)field, (const int*)line_row,
                  (const int*)shifts, (const int*)waveI, (const int*)waveQ,
                  (const int*)bright, (const int*)contrast,
                  (const int*)bloom_dx, (const int*)bloom_lidx, (uint8_t*)out,
                  B, L, V, H, av, n_eq, outw, c, s);
    };
    if (eq == 0) {
        const EqCoefs c[3] = {{k[0], k[1], k[2], k[3], k[4]},
                              {k[5], k[6], k[7], k[8], k[9]},
                              {k[10], k[11], k[12], k[13], k[14]}};
        if (cc == 4) return dispatch_bloom<4, ThreeBand>(bloom, args, c);
        if (cc == 5) return dispatch_bloom<5, ThreeBand>(bloom, args, c);
        return (int)cudaErrorInvalidValue;
    }
    if (cc != 4 || eq < 4 || eq > MAX_TAPS) return (int)cudaErrorInvalidValue;
    FirCoefs f = {};
    for (int j = 0; j < eq; ++j) f.w[j] = k[j];
    f.shift = k[eq];
    const FirCoefs c[3] = {f, f, f};
    switch (eq) {
        case 4: return dispatch_bloom<4, Fir<4>>(bloom, args, c);
        case 5: return dispatch_bloom<4, Fir<5>>(bloom, args, c);
        case 6: return dispatch_bloom<4, Fir<6>>(bloom, args, c);
        default: return dispatch_bloom<4, Fir<7>>(bloom, args, c);
    }
}
