// K3 hsync_chase: the serial per-line horizontal sync search
// (crt_core.c:434-450), one warp per batch entry.
//
// Replaces: ntsc_crt_tpu/ops/pallas/hsync_scan.py::hsync_chase (kernel
// bodies _make_kernel, word-packed, and _make_kernel_b, per-sample).
//
// For each line the search sums the 2W-sample window that starts at
// hsync + c0, takes the first position whose running sum is <= thresh
// (2W if none), and moves the estimate by that offset minus W when the line
// is active.  The estimate chains line to line, so an entry is a strictly
// serial walk over its L lines; window samples outside [0, HP) read as 0.
//
// What bounds it on the H100: the dependent chain of L window searches.  A
// line reads at most 2W bytes, so bandwidth plays no part; a line costs
// the latency of its dependent steps and the warp's own instruction issue
// (one warp an entry leaves nothing to hide either behind).
//
// What the design does about it:
// - One warp walks one entry, four entries a block, so batch 512 puts 512
//   warps on all the SMs.  Lane t computes the window's running sum at t:
//   the window's words are shuffled to every lane, aligned with a funnel
//   shift, and summed with __dp4a against a per-lane mask of bytes 0..t.
//   A warp min-reduction gives the first crossing.  No lane branches on
//   data.
// - The load leaves the chain.  The estimate moves by t - W in [-W, W] a
//   line, so once line l's window start is known, line l+LOOK's window
//   lies inside a span of (2*LOOK + 2) * W bytes around it.  At line l the
//   warp stages that span for line l+LOOK with cp.async, one aligned word
//   a lane, into the lane's own shared-memory slot (no warp barrier: a
//   lane reads back only its own word), and reads line l+1's word into a
//   register; a line's chain is then the shuffles, the sums, the
//   reduction and the update.
// - LOOK = 4 for W <= 8: a line takes ~0.17 us on an H100 80GB HBM3 at
//   700 W (chip_smoke.py; about 330 cycles at 1980 MHz), so the word read a
//   line ahead was staged three lines (~1000 cycles) earlier: more than a
//   device-memory round trip.  LOOK = 6 measured no faster.  W <= 16 takes LOOK = 2, as a window of 32
//   bytes must stay inside the span's 32 words.
// - No warp-collective op sits in a per-line branch: each such branch
//   costs a convergence barrier every line.  The flags are one ballot and
//   the outputs one store per chunk of lines.
// - Where the estimate wrapped across H since the span was staged (the
//   window moves by +-H) or the window leaves [0, HP), the line reads its
//   window from the row itself: rare, slow, exact.  An estimate that starts
//   outside [0, H), or W >= H, takes a one-lane loop for the whole entry.
//
// The TPU kernel's word packing, rebase and funnel exist only for the TPU's
// layout and are not carried over.
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int WARPS = 4;  // entries per block
constexpr int MAX_W = 16;
constexpr unsigned FULL = 0xffffffffu;

// The chase one line at a time on one lane, for entries whose estimate
// starts outside [0, H) or whose window is as wide as a line (W >= H):
// the fast path's single-step wrap needs neither.
__device__ void chase_serial(const int8_t* __restrict__ rows,
                             const uint8_t* __restrict__ act,
                             int* __restrict__ o, int hs, int L, int HP,
                             int W, int c0, int thresh, int H) {
    for (int l = 0; l < L; ++l) {
        const int8_t* row = rows + (long long)l * HP;
        int run = 0, j = 2 * W;
        for (int t = 0; t < 2 * W; ++t) {
            const int x = hs + c0 + t;
            run += (x >= 0 && x < HP) ? (int)row[x] : 0;
            if (run <= thresh) {
                j = t;
                break;
            }
        }
        int nxt = (j - W + hs) % H;  // POSMOD (crt_core.c:17)
        if (nxt < 0) nxt += H;
        if (act[l]) hs = nxt;
        o[l] = hs;
    }
}

// The aligned word of `row` whose first byte is byte xw of the row (xw a
// multiple of 4 away from the row's address alignment), bytes outside
// [0, HP) zeroed.
__device__ __forceinline__ int clean_word(int word, int xw, int HP) {
    unsigned keep = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        keep |= (xw + i >= 0 && xw + i < HP) ? 0xffu << (8 * i) : 0u;
    return (int)((unsigned)word & keep);
}

// Lane k's word of a span: the aligned words from row byte xa on, word k
// at row byte xa + 4k, as cp.async copies them (one group).  A word with no
// byte in [0, HP) is not read (zero filled); a word that straddles the
// row's ends reads bytes of the rows beside it (or up to 3 past the
// tensor): only windows inside [0, HP) are read from a span.
__device__ __forceinline__ void stage_word(int* slot,
                                           const int8_t* __restrict__ row,
                                           int xa, int HP, int lane,
                                           bool live) {
    const int xw = xa + 4 * lane;
    const bool in = live && xw < HP && xw + 3 >= 0;
    cp_async4_zfill(slot + lane, in ? row + xw : row, in);
    cp_async_commit();
}

// LOOK lines of look-ahead; NWA words hold a window of 2W <= 4 * NWA bytes.
template <int LOOK, int NWA>
__global__ void __launch_bounds__(32 * WARPS) hsync_chase_kernel(
    const int8_t* __restrict__ rows2,   // (B, L, HP) padded line rows
    const uint8_t* __restrict__ active, // (B, L) bool
    const int* __restrict__ hsync0,     // (B,)
    int* __restrict__ out,              // (B, L) estimate after each line
    int B, int L, int HP, int W, int c0, int thresh, int H) {
    static_assert(LOOK >= 2, "a span is read into registers a line early");
    constexpr int CH = LOOK * (32 / LOOK);  // lines a chunk: a flag a lane
    __shared__ int slots[WARPS][LOOK][32];
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;  // the whole warp: b is the warp's
    const int8_t* rows = rows2 + (long long)b * L * HP;
    const uint8_t* act = active + (long long)b * L;
    int* o = out + (long long)b * L;
    int hs = hsync0[b];
    if (hs < 0 || hs >= H || W >= H) {
        if (lane == 0) chase_serial(rows, act, o, hs, L, HP, W, c0, thresh, H);
        return;
    }
    int(*slot)[32] = slots[threadIdx.x >> 5];
    const int tW = 2 * W;
    // lane t sums window bytes 0..t: byte i of mask[r] is 1 if 4r + i <= t
    int mask[NWA];
#pragma unroll
    for (int r = 0; r < NWA; ++r) {
        unsigned m = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            m |= (4 * r + i <= lane) ? 1u << (8 * i) : 0u;
        mask[r] = (int)m;
    }

    // slot[j]: lane k's word of the span of the next line l = j (mod
    // LOOK): the line's bytes from x0[j] (the window offsets are measured
    // from it), its words from row byte xa[j] <= x0[j]
    int x0[LOOK], xa[LOOK];
#pragma unroll
    for (int j = 0; j < LOOK; ++j) {
        const int8_t* row = rows + (long long)j * HP;
        x0[j] = hs + c0 - LOOK * W;
        xa[j] = x0[j] - (int)((reinterpret_cast<uintptr_t>(row) + x0[j]) & 3);
        stage_word(slot[j], row, xa[j], HP, lane, j < L);
    }
    cp_async_wait<LOOK - 1>();
    int word = slot[0][lane];
    int anext = lane < min(CH, L) ? act[lane] : 0;

    for (int c = 0; c < L; c += CH) {
        // flags and estimates of the chunk's lines, a lane each
        const unsigned amask = __ballot_sync(FULL, anext != 0);
        anext = c + CH + lane < L && lane < CH ? act[c + CH + lane] : 0;
        int mine = 0;
        const int n = min(CH, L - c);
        for (int i0 = 0; i0 < n; i0 += LOOK) {
#pragma unroll
            for (int j = 0; j < LOOK; ++j) {
                const int i = i0 + j, l = c + i;
                if (i >= n) break;
                const int8_t* row = rows + (long long)l * HP;
                const int base = hs + c0;
                const int off = base - x0[j];
                // the window's words: from the span, or, where the estimate
                // wrapped since the span was staged or the window leaves
                // [0, HP), from the row itself (rare, slow, exact)
                int src = word, ob = base - xa[j];
                if ((unsigned)off > (unsigned)(2 * LOOK * W) || base < 0 ||
                    base + tW > HP) {
                    const int aw =
                        (int)((reinterpret_cast<uintptr_t>(row) + base) & 3);
                    const int xw = base - aw + 4 * lane;
                    src = xw < HP && xw + 3 >= 0
                              ? clean_word(
                                    *reinterpret_cast<const int*>(row + xw),
                                    xw, HP)
                              : 0;
                    ob = aw;
                }
                int w[NWA + 1];
#pragma unroll
                for (int r = 0; r <= NWA; ++r)
                    w[r] = __shfl_sync(FULL, src, ((ob >> 2) + r) & 31);
                const int sh = (ob & 3) * 8;
                // line l+LOOK's span into this slot; line l+1's word: off
                // the chain below
                x0[j] = base - LOOK * W;
                const int8_t* ahead = row + (long long)LOOK * HP;
                xa[j] = x0[j] - (int)((reinterpret_cast<uintptr_t>(ahead) +
                                       x0[j]) & 3);
                stage_word(slot[j], ahead, xa[j], HP, lane, l + LOOK < L);
                cp_async_wait<LOOK - 1>();
                const int next = slot[(j + 1) % LOOK][lane];

                // lane t: the window's running sum at t
                int part[2] = {0, 0};
#pragma unroll
                for (int r = 0; r < NWA; ++r)
                    part[r & 1] = __dp4a(
                        (int)__funnelshift_r(w[r], w[r + 1], sh), mask[r],
                        part[r & 1]);
                // the first crossing, 2W if none
                const int t = (int)__reduce_min_sync(
                    FULL, lane < tW && part[0] + part[1] <= thresh
                              ? (unsigned)lane
                              : (unsigned)tW);
                int nxt = t - W + hs;  // in [-W, H - 1 + W]: POSMOD in one
                nxt = nxt < 0 ? nxt + H : (nxt >= H ? nxt - H : nxt);
                hs = (amask >> i) & 1u ? nxt : hs;
                mine = i == lane ? hs : mine;
                word = next;
            }
        }
        if (lane < n) o[c + lane] = mine;
    }
}

// look-ahead for W <= 8 and for W <= 16: a window's words must stay inside
// the 32 words of its span
constexpr int LOOK_NARROW = 4;
constexpr int LOOK_WIDE = 2;

}  // namespace

// W must lie in [1, 16] and rows2 be 4-byte aligned: the wrapper checks it.
extern "C" int ntsc_hsync_chase(const void* rows2, const void* active,
                                const void* hsync0, void* out, int B, int L,
                                int HP, int W, int c0, int thresh, int H,
                                void* stream) {
    if (W < 1 || W > MAX_W || B < 1 || L < 1 || HP < 1 || H < 1 ||
        (reinterpret_cast<uintptr_t>(rows2) & 3) != 0)
        return (int)cudaErrorInvalidValue;
    const int blocks = (B + WARPS - 1) / WARPS;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* r = (const int8_t*)rows2;
    const auto* a = (const uint8_t*)active;
    const auto* h = (const int*)hsync0;
    if (W <= 8)
        hsync_chase_kernel<LOOK_NARROW, 4><<<blocks, 32 * WARPS, 0, st>>>(
            r, a, h, (int*)out, B, L, HP, W, c0, thresh, H);
    else
        hsync_chase_kernel<LOOK_WIDE, 8><<<blocks, 32 * WARPS, 0, st>>>(
            r, a, h, (int*)out, B, L, HP, W, c0, thresh, H);
    return (int)cudaGetLastError();
}
