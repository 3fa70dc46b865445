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
// The lines are read in place from the noisy field (B, V, H): line l starts
// on row line_row[l] and runs on into the next, so its sample x is byte
// (line_row * H + x) mod (V * H) of its frame, and HP = H + pad.  Only a
// line whose HP samples pass the frame's end (it starts on row V - 1) wraps
// to the frame's row 0.
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
// - The lines' first rows come a lane a line, read two chunks of lines
//   ahead, and reach the staging lane by a shuffle.
// - Where the estimate wrapped across H since the span was staged (the
//   window moves by +-H), the window leaves [0, HP) or the line wraps to
//   the frame's row 0 (one line a frame at most; its span is not staged),
//   the line reads its window from the field itself, byte by byte where a
//   word is cut: rare, slow, exact.  An estimate that starts outside
//   [0, H), or W >= H, takes a one-lane loop for the whole entry.
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

// Sample x of the line whose first byte is byte st of `frame` (VH bytes):
// byte st + x, wrapped to the frame's start past its end
__device__ __forceinline__ int line_byte(const int8_t* __restrict__ frame,
                                         int st, int x, int VH) {
    const int at = st + x;
    return frame[at >= VH ? at - VH : at];
}

// The chase one line at a time on one lane, for entries whose estimate
// starts outside [0, H) or whose window is as wide as a line (W >= H):
// the fast path's single-step wrap needs neither.
__device__ void chase_serial(const int8_t* __restrict__ frame,
                             const int* __restrict__ lrow,
                             const uint8_t* __restrict__ act,
                             int* __restrict__ o, int hs, int L, int HP,
                             int VH, int W, int c0, int thresh, int H) {
    for (int l = 0; l < L; ++l) {
        const int st = lrow[l] * H;
        int run = 0, j = 2 * W;
        for (int t = 0; t < 2 * W; ++t) {
            const int x = hs + c0 + t;
            run += (x >= 0 && x < HP) ? line_byte(frame, st, x, VH) : 0;
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

// Samples xw .. xw + 3 of the line that starts at byte st of `frame` as one
// word (xw a multiple of 4 away from the line's address alignment), those
// outside [0, HP) zeroed: one aligned load where every byte lies in
// [0, HP) and before the frame's end, else byte by byte.
__device__ __forceinline__ int line_word(const int8_t* __restrict__ frame,
                                         int st, int xw, int HP, int VH) {
    if (xw >= 0 && xw + 3 < HP && st + xw + 3 < VH)
        return *reinterpret_cast<const int*>(frame + st + xw);
    unsigned u = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int x = xw + i;
        if (x >= 0 && x < HP)
            u |= (unsigned)(uint8_t)line_byte(frame, st, x, VH) << (8 * i);
    }
    return (int)u;
}

// Lane k's word of a span: the aligned words from row byte xa on, word k
// at row byte xa + 4k, as cp.async copies them (one group).  A word with no
// byte in [0, HP) is not read (zero filled); a word that straddles the
// line's ends reads bytes of the rows beside it (or up to 3 past the
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
    const int8_t* __restrict__ field,   // (B, V, H) the noisy field
    const int* __restrict__ line_row,   // (B, L) each line's first row
    const uint8_t* __restrict__ active, // (B, L) bool
    const int* __restrict__ hsync0,     // (B,)
    int* __restrict__ out,              // (B, L) estimate after each line
    int B, int V, int L, int H, int HP, int W, int c0, int thresh) {
    static_assert(LOOK >= 2, "a span is read into registers a line early");
    constexpr int CH = LOOK * (32 / LOOK);  // lines a chunk: a flag a lane
    __shared__ int slots[WARPS][LOOK][32];
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;  // the whole warp: b is the warp's
    const int VH = V * H;
    const int8_t* frame = field + (long long)b * VH;
    const int* lrow = line_row + (long long)b * L;
    const uint8_t* act = active + (long long)b * L;
    int* o = out + (long long)b * L;
    int hs = hsync0[b];
    if (hs < 0 || hs >= H || W >= H) {
        if (lane == 0)
            chase_serial(frame, lrow, act, o, hs, L, HP, VH, W, c0, thresh,
                         H);
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
    // the first rows of chunks c, c + 1 and c + 2 of lines, a lane a line:
    // the staging reads the first two, a chunk after the third is loaded
    auto rows_of = [&](int c) {
        return lane < CH && c + lane < L ? lrow[c + lane] : 0;
    };
    int rcur = rows_of(0), rnxt = rows_of(CH), rfar = rows_of(2 * CH);
    // a line whose HP samples pass the frame's end: its span is not staged
    const int last_st = VH - HP;

    // slot[j]: lane k's word of the span of the next line l = j (mod
    // LOOK): the line's bytes from x0[j] (the window offsets are measured
    // from it), its words from row byte xa[j] <= x0[j]; st[j] the line's
    // first byte in the frame
    int x0[LOOK], xa[LOOK], st[LOOK];
#pragma unroll
    for (int j = 0; j < LOOK; ++j) {
        st[j] = __shfl_sync(FULL, rcur, j) * H;
        const int8_t* row = frame + st[j];
        x0[j] = hs + c0 - LOOK * W;
        xa[j] = x0[j] - (int)((reinterpret_cast<uintptr_t>(row) + x0[j]) & 3);
        stage_word(slot[j], row, xa[j], HP, lane, j < L && st[j] <= last_st);
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
                const int base = hs + c0;
                const int off = base - x0[j];
                // the window's words: from the span, or, where the estimate
                // wrapped since the span was staged, the window leaves
                // [0, HP) or the line wraps, from the field itself (rare,
                // slow, exact)
                int src = word, ob = base - xa[j];
                if ((unsigned)off > (unsigned)(2 * LOOK * W) || base < 0 ||
                    base + tW > HP || st[j] > last_st) {
                    const int aw = (int)((reinterpret_cast<uintptr_t>(
                                              frame + st[j]) + base) & 3);
                    src = line_word(frame, st[j], base - aw + 4 * lane, HP,
                                    VH);
                    ob = aw;
                }
                int w[NWA + 1];
#pragma unroll
                for (int r = 0; r <= NWA; ++r)
                    w[r] = __shfl_sync(FULL, src, ((ob >> 2) + r) & 31);
                const int sh = (ob & 3) * 8;
                // line l+LOOK's span into this slot; line l+1's word: off
                // the chain below
                const int ia = i + LOOK;  // line l+LOOK's lane, chunk c or c+1
                st[j] = __shfl_sync(FULL, ia < CH ? rcur : rnxt,
                                    ia < CH ? ia : ia - CH) * H;
                const int8_t* ahead = frame + st[j];
                x0[j] = base - LOOK * W;
                xa[j] = x0[j] - (int)((reinterpret_cast<uintptr_t>(ahead) +
                                       x0[j]) & 3);
                stage_word(slot[j], ahead, xa[j], HP, lane,
                           l + LOOK < L && st[j] <= last_st);
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
        rcur = rnxt;
        rnxt = rfar;
        rfar = rows_of(c + 3 * CH);
    }
}

// look-ahead for W <= 8 and for W <= 16: a window's words must stay inside
// the 32 words of its span
constexpr int LOOK_NARROW = 4;
constexpr int LOOK_WIDE = 2;

}  // namespace

// W must lie in [1, 16], H + pad <= V * H < 2**31 and field be 4-byte
// aligned: the wrapper checks it.  Each line_row lies in [0, V).
extern "C" int ntsc_hsync_chase(const void* field, const void* line_row,
                                const void* active, const void* hsync0,
                                void* out, int B, int V, int L, int H,
                                int pad, int W, int c0, int thresh,
                                void* stream) {
    const long long vh = (long long)V * H;
    if (W < 1 || W > MAX_W || B < 1 || V < 1 || L < 1 || H < 1 || pad < 0 ||
        vh >= (1LL << 31) || (long long)H + pad > vh ||
        (reinterpret_cast<uintptr_t>(field) & 3) != 0)
        return (int)cudaErrorInvalidValue;
    const int blocks = (B + WARPS - 1) / WARPS;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* f = (const int8_t*)field;
    const auto* r = (const int*)line_row;
    const auto* a = (const uint8_t*)active;
    const auto* h = (const int*)hsync0;
    if (W <= 8)
        hsync_chase_kernel<LOOK_NARROW, 4><<<blocks, 32 * WARPS, 0, st>>>(
            f, r, a, h, (int*)out, B, V, L, H, H + pad, W, c0, thresh);
    else
        hsync_chase_kernel<LOOK_WIDE, 8><<<blocks, 32 * WARPS, 0, st>>>(
            f, r, a, h, (int*)out, B, V, L, H, H + pad, W, c0, thresh);
    return (int)cudaGetLastError();
}
