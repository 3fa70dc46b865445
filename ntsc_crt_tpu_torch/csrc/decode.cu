// K2 decode_rows: per-line sample alignment + Y/I/Q demodulation + 3-band
// EQ + lerp scan conversion + YIQ->RGB + contrast + clamp, one (frame,
// line) row per thread.
//
// Replaces: ntsc_crt_tpu/ops/pallas/decode_fused.py::decode_fused_rows
// (kernel body _make_kernel with _eq_chain), three-band mode.
//
// Per sample t the thread loads sig[shift + t] straight from the rolled
// field rows (line l continues into line l+1, the reference's flat reads,
// crt_core.c:538-543), forms Y = s + bright and I/Q = s*wave >> 9 with the
// wave phase t % CC, and runs the three 11-int equalizer chains held in
// registers (crt_core.c:206-233).  The scan conversion streams: lerp
// sources s(p) = (p*dx) >> 12 are monotone, so pixel p is emitted as soon
// as samples s(p) and s(p)+1 exist, from the last two EQ outputs kept in
// registers — the oy/oi/oq rows never exist in memory.
//
// What bounds it on the H100: the EQ is a dependent chain of ~4 stages of
// sub/mul/add/shift per channel per sample, so a row costs av_len times
// that latency (the three channels overlap); one byte is read and ~2.5
// bytes written per sample, so bytes are not the limit.
//
// Left for later: a warp's 32 rows read 32 different field rows and write
// 32 different output rows, so loads and stores are uncoalesced; staging
// through shared memory would coalesce both.  The TPU kernel's coarse
// pre-shift, block rebase and alignment funnel are not carried over: the
// alignment is a direct indexed load.  Conv-EQ and bloom modes are not
// ported yet.
#include <cuda_runtime.h>

#include "int32.cuh"

namespace {

constexpr int EQ_P = 16;  // crt_core.c:155
constexpr int EQ_R = 1 << (EQ_P - 1);

struct EqCoefs {
    int lf, hf, g0, g1, g2;
};

struct EqState {
    int fL0, fL1, fL2, fL3, fH0, fH1, fH2, fH3, h0, h1, h2;
};

__device__ __forceinline__ int pole(int f, int c, int x) {
    return add32(f, add32(mul32(c, sub32(x, f)), EQ_R) >> EQ_P);
}

// one eqf() sample (crt_core.c:206-233)
__device__ __forceinline__ int eq_step(EqState& s, int sx, const EqCoefs& c) {
    s.fL0 = pole(s.fL0, c.lf, sx);
    s.fH0 = pole(s.fH0, c.hf, sx);
    s.fL1 = pole(s.fL1, c.lf, s.fL0);
    s.fH1 = pole(s.fH1, c.hf, s.fH0);
    s.fL2 = pole(s.fL2, c.lf, s.fL1);
    s.fH2 = pole(s.fH2, c.hf, s.fH1);
    s.fL3 = pole(s.fL3, c.lf, s.fL2);
    s.fH3 = pole(s.fH3, c.hf, s.fH2);
    const int out = add32(add32(mul32(s.fL3, c.g0) >> EQ_P,
                                mul32(sub32(s.fH3, s.fL3), c.g1) >> EQ_P),
                          mul32(sub32(s.h2, s.fH3), c.g2) >> EQ_P);
    s.h2 = s.h1;
    s.h1 = s.h0;
    s.h0 = sx;
    return out;
}

__device__ __forceinline__ uint8_t to_u8(int v, int contrast) {
    return (uint8_t)clamp_int(mul32(v >> 12, contrast) >> 8, 0, 255);
}

template <int CC>
__global__ void decode_rows_kernel(
    const int8_t* __restrict__ rows,     // (B, NR, H) rolled field rows
    const int* __restrict__ shifts,      // (B, L) sample offset of line l
    const int* __restrict__ waveI,       // (B, L, CC)
    const int* __restrict__ waveQ,       // (B, L, CC)
    const int* __restrict__ bright,      // (B, L)
    const int* __restrict__ contrast,    // (B, L)
    uint8_t* __restrict__ out,           // (B, L, outw, 3)
    int B, int L, int NR, int H, int row0, int av, int outw, int dx,
    EqCoefs cy, EqCoefs ci, EqCoefs cq) {
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
    EqState sy = {}, si = {}, sq = {};
    int py = 0, pi = 0, pq = 0;  // EQ outputs of sample t - 1
    int p = 0, pos = 0;          // next pixel and its 12-bit source position
    for (int t0 = 0; t0 < av; t0 += CC) {
#pragma unroll
        for (int k = 0; k < CC; ++k) {
            const int t = t0 + k;
            if (t >= av) break;
            const int x = sh + t;
            const int sx = (x >= 0 && x < 2 * H) ? (int)line[x] : 0;
            // crt_core.c:538-543
            const int oy = (int)((unsigned)eq_step(sy, add32(sx, br), cy) << 4);
            const int oi = eq_step(si, mul32(sx, wi[k]) >> 9, ci) >> 3;
            const int oq = eq_step(sq, mul32(sx, wq[k]) >> 9, cq) >> 3;
            // crt_core.c:555-611: pixels whose right source is sample t
            while (p < outw && (pos >> 12) + 1 == t) {
                const int Rw = pos & 0xFFF;
                const int Lw = 0xFFF - Rw;
                const int y = add32(mul32(py, Lw) >> 2, mul32(oy, Rw) >> 2);
                const int i = add32(mul32(pi, Lw) >> 14, mul32(oi, Rw) >> 14);
                const int q = add32(mul32(pq, Lw) >> 14, mul32(oq, Rw) >> 14);
                uint8_t* px = dst + p * 3;
                px[0] = to_u8(add32(add32(y, mul32(3879, i)), mul32(2556, q)), ct);
                px[1] = to_u8(sub32(sub32(y, mul32(1126, i)), mul32(2605, q)), ct);
                px[2] = to_u8(add32(sub32(y, mul32(4530, i)), mul32(7021, q)), ct);
                ++p;
                pos += dx;
            }
            py = oy;
            pi = oi;
            pq = oq;
        }
    }
}

template <int CC>
void launch(const int8_t* rows, const int* shifts, const int* waveI,
            const int* waveQ, const int* bright, const int* contrast,
            uint8_t* out, int B, int L, int NR, int H, int row0, int av,
            int outw, const EqCoefs* c, cudaStream_t stream) {
    const long long n = (long long)B * L;
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    const int dx = ((av - 1) << 12) / outw;
    decode_rows_kernel<CC><<<blocks, threads, 0, stream>>>(
        rows, shifts, waveI, waveQ, bright, contrast, out, B, L, NR, H, row0,
        av, outw, dx, c[0], c[1], c[2]);
}

}  // namespace

// coefs: host int[15], (lf, hf, g_lo, g_mid, g_hi) for Y, I, Q
extern "C" int ntsc_decode_rows(
    const void* rows, const void* shifts, const void* waveI,
    const void* waveQ, const void* bright, const void* contrast,
    const void* coefs, void* out, int B, int L, int NR, int H, int row0,
    int av, int outw, int cc, void* stream) {
    const int* k = (const int*)coefs;
    const EqCoefs c[3] = {{k[0], k[1], k[2], k[3], k[4]},
                          {k[5], k[6], k[7], k[8], k[9]},
                          {k[10], k[11], k[12], k[13], k[14]}};
    auto s = static_cast<cudaStream_t>(stream);
    auto args = [&](auto fn) {
        fn((const int8_t*)rows, (const int*)shifts, (const int*)waveI,
           (const int*)waveQ, (const int*)bright, (const int*)contrast,
           (uint8_t*)out, B, L, NR, H, row0, av, outw, c, s);
    };
    if (cc == 4) {
        args(launch<4>);
    } else if (cc == 5) {
        args(launch<5>);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
