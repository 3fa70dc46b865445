// K2 decode_rows: per-line sample alignment + Y/I/Q demodulation + EQ + lerp
// scan conversion + YIQ->RGB + contrast + clamp, one (frame, line) row per
// thread; and bloom_line_width, the beam-energy EMA that sizes each bloom
// line.
//
// Replaces: ntsc_crt_tpu/ops/pallas/decode_fused.py::decode_fused_rows
// (kernel body _make_kernel) in all its modes — the 3-band EQ (_eq_chain),
// the convolution EQ (coefs=("conv", taps), _fir_chain) and the bloom scan
// conversion (bloom_dx/bloom_lidx).  bloom_line_width replaces the lax.scan
// of ntsc_crt_tpu/models/demodulate.py:880-887, which has no Pallas form.
//
// Per sample t the thread loads sig[shift + t] straight from the rolled
// field rows (line l continues into line l+1, the reference's flat reads,
// crt_core.c:538-543), forms Y = s + bright and I/Q = s*wave >> 9 with the
// wave phase t % CC, and runs the three equalizers held in registers: the
// 11-int 3-band chain (crt_core.c:206-233) or a FIR of 4-7 taps keeping
// taps-1 inputs of history (crt_core.c:96-147).  The scan conversion
// streams: lerp sources s(p) = (p*dx) >> 12 are monotone, so pixel p is
// emitted as soon as samples s(p) and s(p)+1 exist, from the last two EQ
// outputs kept in registers — the oy/oi/oq rows never exist in memory.
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
// What bounds it on the H100: not the EQ.  The conv7 FIR has no
// recurrence and a third of the 3-band chain's instructions, yet both
// modes take the same time (PERF.md); one byte is read and ~2.5 bytes
// written per sample, so bytes are not the limit either.  The suspect is
// the access pattern: a warp's 32 rows read 32 different field rows and
// write 32 different output rows one byte at a time, so every load and
// store touches 32 cache lines.
//
// Left for later: staging rows through shared memory would coalesce both.
// The TPU kernel's coarse pre-shift, block rebase and alignment funnel are
// not carried over: the alignment is a direct indexed load.
#include <cuda_runtime.h>

#include "eq3.cuh"  // ThreeBand, the 3-band equalizer of one channel
#include "int32.cuh"

namespace {

constexpr int MAX_TAPS = 7;

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

template <int CC, class Eq, bool BLOOM>
__global__ void decode_rows_kernel(
    const int8_t* __restrict__ rows,     // (B, NR, H) rolled field rows
    const int* __restrict__ shifts,      // (B, L) sample offset of line l
    const int* __restrict__ waveI,       // (B, L, CC)
    const int* __restrict__ waveQ,       // (B, L, CC)
    const int* __restrict__ bright,      // (B, L)
    const int* __restrict__ contrast,    // (B, L)
    const int* __restrict__ bloom_dx,    // (B, L), bloom mode only
    const int* __restrict__ bloom_lidx,  // (B, L), bloom mode only
    uint8_t* __restrict__ out,           // (B, L, outw, 3)
    int B, int L, int NR, int H, int row0, int av, int n_eq, int outw,
    int dx, typename Eq::Coefs cy, typename Eq::Coefs ci,
    typename Eq::Coefs cq) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= (long long)B * L) return;
    const int b = (int)(r / L);
    const int l = (int)(r % L);
    const int8_t* line = rows + ((long long)b * NR + row0 + l) * H;
    const int sh = shifts[r];
    int wi[CC], wq[CC];
#pragma unroll
    for (int k = 0; k < CC; ++k) {
        wi[k] = waveI[r * CC + k];
        wq[k] = waveQ[r * CC + k];
    }
    const int br = bright[r];
    const int ct = contrast[r];
    uint8_t* dst = out + r * outw * 3;
    Eq sy, si, sq;
    sy.reset();
    si.reset();
    sq.reset();

    if constexpr (!BLOOM) {
        int py = 0, pi = 0, pq = 0;  // EQ outputs of sample t - 1
        int p = 0, pos = 0;          // next pixel and its 12-bit source
        for (int t0 = 0; t0 < av; t0 += CC) {
#pragma unroll
            for (int k = 0; k < CC; ++k) {
                const int t = t0 + k;
                if (t >= av) break;
                const int x = sh + t;
                const int sx = (x >= 0 && x < 2 * H) ? (int)line[x] : 0;
                // crt_core.c:538-543
                const int oy = (int)((unsigned)sy.step(add32(sx, br), cy) << 4);
                const int oi = si.step(mul32(sx, wi[k]) >> 9, ci) >> 3;
                const int oq = sq.step(mul32(sx, wq[k]) >> 9, cq) >> 3;
                // pixels whose right source is sample t
                while (p < outw && (pos >> 12) + 1 == t) {
                    emit(dst + p * 3, py, pi, pq, oy, oi, oq, pos, ct);
                    ++p;
                    pos += dx;
                }
                py = oy;
                pi = oi;
                pq = oq;
            }
        }
    } else {
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
                const int x = sh + cur;
                const int sx = (cur < av && x >= 0 && x < 2 * H) ? (int)line[x]
                                                                 : 0;
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
            emit(dst + p * 3, clamped ? y1 : y0, clamped ? i1 : i0,
                 clamped ? q1 : q0, zero ? 0 : y1, zero ? 0 : i1,
                 zero ? 0 : q1, pos, ct);
        }
    }
}

template <int CC, class Eq, bool BLOOM>
void launch(const int8_t* rows, const int* shifts, const int* waveI,
            const int* waveQ, const int* bright, const int* contrast,
            const int* bloom_dx, const int* bloom_lidx, uint8_t* out, int B,
            int L, int NR, int H, int row0, int av, int n_eq, int outw,
            const typename Eq::Coefs* c, cudaStream_t stream) {
    const long long n = (long long)B * L;
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    const int dx = ((av - 1) << 12) / outw;
    decode_rows_kernel<CC, Eq, BLOOM><<<blocks, threads, 0, stream>>>(
        rows, shifts, waveI, waveQ, bright, contrast, bloom_dx, bloom_lidx,
        out, B, L, NR, H, row0, av, n_eq, outw, dx, c[0], c[1], c[2]);
}

template <int CC, class Eq, class Args>
void dispatch_bloom(bool bloom, Args&& args, const typename Eq::Coefs* c) {
    if (bloom) {
        args(launch<CC, Eq, true>, c);
    } else {
        args(launch<CC, Eq, false>, c);
    }
}

// C's truncating a / d, made total as XLA defines it: d == 0 gives -1 and
// INT_MIN / -1 gives INT_MIN
__device__ __forceinline__ int cdiv32(int a, int d) {
    if (d == 0) return -1;
    if (d == -1) return sub32(0, a);
    return a / d;
}

// prev_e = prev_e*123/128 + ((max_e>>1) - s) << 10 / max_e per line, from
// 16384/8 (crt_core.c:512-520): a serial chain along the lines, one thread
// per frame.  The division by max_e is off the chain; the chain itself is
// a multiply, the truncating /128 and an add per line.
__global__ void bloom_line_width_kernel(const int* __restrict__ sums,
                                        const int* __restrict__ max_e,
                                        int* __restrict__ prev_e, int B,
                                        int L) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int me = max_e[b];
    const int half = me >> 1;
    const int* s = sums + (long long)b * L;
    int* dst = prev_e + (long long)b * L;
    int e = 16384 / 8;
    for (int l = 0; l < L; ++l) {
        const int drive = cdiv32((int)((unsigned)sub32(half, s[l]) << 10), me);
        e = add32(cdiv32(mul32(e, 123), 128), drive);
        dst[l] = e;
    }
}

}  // namespace

// eq: 0 = 3-band with coefs host int[15], (lf, hf, g_lo, g_mid, g_hi) for
// Y, I, Q; 4..7 = the FIR of that many taps with coefs host int[taps + 1],
// the weights then the shift.  bloom_dx/bloom_lidx null: the static scan
// conversion; both given: bloom mode.
extern "C" int ntsc_decode_rows(
    const void* rows, const void* shifts, const void* waveI,
    const void* waveQ, const void* bright, const void* contrast,
    const void* bloom_dx, const void* bloom_lidx, const void* coefs,
    void* out, int B, int L, int NR, int H, int row0, int av, int n_eq,
    int outw, int cc, int eq, void* stream) {
    const int* k = (const int*)coefs;
    auto s = static_cast<cudaStream_t>(stream);
    const bool bloom = bloom_dx != nullptr;
    if (bloom != (bloom_lidx != nullptr)) return (int)cudaErrorInvalidValue;
    auto args = [&](auto fn, auto c) {
        fn((const int8_t*)rows, (const int*)shifts, (const int*)waveI,
           (const int*)waveQ, (const int*)bright, (const int*)contrast,
           (const int*)bloom_dx, (const int*)bloom_lidx, (uint8_t*)out, B, L,
           NR, H, row0, av, n_eq, outw, c, s);
    };
    if (eq == 0) {
        const EqCoefs c[3] = {{k[0], k[1], k[2], k[3], k[4]},
                              {k[5], k[6], k[7], k[8], k[9]},
                              {k[10], k[11], k[12], k[13], k[14]}};
        if (cc == 4) {
            dispatch_bloom<4, ThreeBand>(bloom, args, c);
        } else if (cc == 5) {
            dispatch_bloom<5, ThreeBand>(bloom, args, c);
        } else {
            return (int)cudaErrorInvalidValue;
        }
        return (int)cudaGetLastError();
    }
    if (cc != 4 || eq < 4 || eq > MAX_TAPS) return (int)cudaErrorInvalidValue;
    FirCoefs f = {};
    for (int j = 0; j < eq; ++j) f.w[j] = k[j];
    f.shift = k[eq];
    const FirCoefs c[3] = {f, f, f};
    switch (eq) {
        case 4: dispatch_bloom<4, Fir<4>>(bloom, args, c); break;
        case 5: dispatch_bloom<4, Fir<5>>(bloom, args, c); break;
        case 6: dispatch_bloom<4, Fir<6>>(bloom, args, c); break;
        default: dispatch_bloom<4, Fir<7>>(bloom, args, c); break;
    }
    return (int)cudaGetLastError();
}

// sums, prev_e int32 (B, L); max_e int32 (B,)
extern "C" int ntsc_bloom_line_width(const void* sums, const void* max_e,
                                     void* prev_e, int B, int L,
                                     void* stream) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((B + threads - 1) / threads);
    bloom_line_width_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        (const int*)sums, (const int*)max_e, (int*)prev_e, B, L);
    return (int)cudaGetLastError();
}
