// K11 inject_noise and K12 vhs_noise_bc: the decoder's noise stage, one
// elementwise pass each.
//
// Replaces: no Pallas kernel.  The JAX package writes the stage so that XLA
// fuses it into one elementwise pass: ntsc_crt_tpu/models/demodulate.py:128
// (_inject_noise) and :150 (_inject_noise_vhs, whose region B march is K5,
// csrc/vhs.cu).
//
// K11: out[i] = clamp(in[i] + ((((st_i >> shift) & 0xFF) - 0x7F) * noise
// >> 8), -127, 127) for the first n samples of each slot, st_i = apow[i] *
// rn + csum[i] (mod 2^32); the samples past n are copied.  The tables hold
// consecutive positions of one affine stream, st_{i+1} = ga * st_i + gc
// (NTSC's LCG, shift 16; or every second crt_rand state, shift 17, for the
// VHS noise's region A).  K11 also writes st_{n-1}, the state after the
// slot's last draw.
//
// K12: the VHS noise's regions B and C, the last nB + nC samples of each
// slot, in place: from each sample's entry state (region B's from K5's
// output, region C's from one more K5 step and the three-call stream a3,
// c3), the noise byte r1, the band's edges m1 = (st2 >> 1) % 20 and rC %
// 8, and the band sinusoid cs[band_line - 10] or the noise knob.  K12 also
// writes the state after the last call and the last rand value.
//
// Arithmetic: wrapping uint32 for the states; the product byte * noise
// wraps in int32 and >> 8 is the arithmetic shift, as in torch and XLA
// (int32.cuh).
//
// What bounds them on the H100: bytes.  K11 reads a byte and writes a
// byte a sample, ~11 int32 ops a sample; K12 reads region B's 4-byte entry
// states besides.
//
// What the design does about it:
// - K11: a warp takes 1024 consecutive samples of the flat B * N buffer,
//   two 16-sample runs a lane, each one 16-byte load and one store, a
//   warp's load 512 contiguous bytes (N is only 2-byte aligned on NES, so
//   runs are cut from the flat buffer, not a slot).  Where the warp's span
//   lies inside one slot and before n, every lane reads the same table
//   entry (the span's first: one load for the warp), jumps to its runs by
//   ga^16 powers (a few multiply-adds) and steps one multiply-add a
//   sample: the tables stay off the load path.  Elsewhere (a span that
//   crosses a slot or meets n) each sample reads its own table entry.
//   Every loop over a run is unrolled, so the runs stay in registers.
// - K12: a block takes 1024 samples of one slot, four a thread at stride
//   256, and issues every load before the draws: the entry states
//   (coalesced), the samples, and the band sinusoid's entries, needed or
//   not (an L2-resident table; waiting for the band test would add a
//   round trip).  Region C's threads form their entry from region B's
//   last (a broadcast load) and the a3 / c3 tables.
// Tried (PERF.md): K11 one run a thread (its run in local memory behind a
// dynamically indexed loop, 57 % of the bound at batch 512; in registers
// 75 %) and four; K12 a sample a thread (26 %), two and eight; then K12
// as 4-sample quads a lane on x's 4-byte or 128-byte grid (one to eight a
// lane, 16-byte loads of the entries), the band sinusoid loaded only where
// the band test passes, persistent warps that load the next chunk while
// drawing this one, and this design in one wave of blocks: none beat this
// one by more than 5 %.  With no draws at all its loads and stores take as
// long: its memory pattern bounds it.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "int32.cuh"

namespace {

constexpr int RUN = 16;       // K11: samples a run, one 16-byte chunk
constexpr int CH = 2;         // K11: runs a thread
constexpr int SPAN = 32 * RUN * CH;  // K11: samples a warp
constexpr int SPT = 4;        // K12: samples a thread
constexpr int THREADS = 256;  // threads a block, both kernels

struct Jump {  // x -> a * x + c (mod 2^32)
    unsigned a, c;
};

__device__ __forceinline__ Jump then(Jump f, Jump g) {  // f, then g
    return {g.a * f.a, g.a * f.c + g.c};
}

// g^(RUN * k) for k < 32, and g^(32 * RUN): RUN = 2^4 squarings, then one
// composition a bit of k, squaring on to the fifth bit
__device__ __forceinline__ void run_jumps(Jump g, int k, Jump& to_k,
                                          Jump& warp) {
    Jump p = g;
    for (int s = 0; s < 4; ++s) p = then(p, p);
    Jump r{1u, 0u};
    for (int bit = 0; bit < 5; ++bit) {
        if ((k >> bit) & 1) r = then(r, p);
        p = then(p, p);
    }
    to_k = r;
    warp = p;
}

__device__ __forceinline__ signed char noisy(int a, unsigned st, int nz,
                                             int shift) {
    const int byte = (int)((st >> shift) & 0xFFu) - 0x7F;
    return (signed char)clamp_int(a + (mul32(byte, nz) >> 8), -127, 127);
}

union Chunk {
    int4 v;
    signed char b[RUN];
};

// flat sample f -> (slot b, sample i): the quotient from a double product
// (exact for f < 2^52 up to one), corrected
__device__ __forceinline__ void split(long long f, int N, double inv_n,
                                      long long& b, int& i) {
    long long q = (long long)((double)f * inv_n);
    long long r = f - q * N;
    if (r < 0) {
        --q;
        r += N;
    } else if (r >= N) {
        ++q;
        r -= N;
    }
    b = q;
    i = (int)r;
}

template <bool VEC>
__device__ __forceinline__ void load_run(const signed char* in, long long at,
                                         int cnt, Chunk& x) {
    if (VEC && cnt == RUN) {
        x.v = *reinterpret_cast<const int4*>(in + at);
    } else {
#pragma unroll
        for (int k = 0; k < RUN; ++k)
            if (k < cnt) x.b[k] = in[at + k];
    }
}

template <bool VEC>
__device__ __forceinline__ void store_run(signed char* out, long long at,
                                          int cnt, const Chunk& y) {
    if (VEC && cnt == RUN) {
        *reinterpret_cast<int4*>(out + at) = y.v;
    } else {
#pragma unroll
        for (int k = 0; k < RUN; ++k)
            if (k < cnt) out[at + k] = y.b[k];
    }
}

// A warp takes SPAN consecutive samples of the flat buffer, CH runs a
// lane: lane l's run c starts 32 * RUN * c + RUN * l into the span, so each
// load or store of the warp covers 512 contiguous bytes.  Every loop over a
// run is unrolled, so the runs stay in registers.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    inject_noise_kernel(const signed char* __restrict__ in,
                        signed char* __restrict__ out,
                        const int* __restrict__ apow,   // (n,)
                        const int* __restrict__ csum,   // (n,)
                        const int* __restrict__ rn,     // (B,)
                        const int* __restrict__ noise,  // (B,)
                        int* __restrict__ last,         // (B,)
                        long long total, int N, int n, int shift, Jump g,
                        double inv_n) {
    const int lane = threadIdx.x & 31;
    const long long wbase =
        ((long long)blockIdx.x * THREADS + threadIdx.x - lane) * RUN * CH;
    if (wbase >= total) return;  // the last block's spare warps
    long long wb;
    int wi;  // the warp's first sample
    split(wbase, N, inv_n, wb, wi);
    if (wi + SPAN <= n) {
        // the span lies in slot wb, before n (n <= N): every run is whole.
        // Every lane reads the span's first state and jumps to its runs.
        Jump to_lane, next;
        run_jumps(g, lane, to_lane, next);
        unsigned st[CH];
        st[0] = (unsigned)apow[wi] * (unsigned)rn[wb] + (unsigned)csum[wi];
        st[0] = to_lane.a * st[0] + to_lane.c;
#pragma unroll
        for (int c = 1; c < CH; ++c) st[c] = next.a * st[c - 1] + next.c;
        const int nz = noise[wb];
        Chunk x[CH], y[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c)
            load_run<VEC>(in, wbase + (32 * c + lane) * RUN, RUN, x[c]);
#pragma unroll
        for (int k = 0; k < RUN; ++k) {
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                y[c].b[k] = noisy(x[c].b[k], st[c], nz, shift);
                if (k < RUN - 1) st[c] = g.a * st[c] + g.c;
            }
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            store_run<VEC>(out, wbase + (32 * c + lane) * RUN, RUN, y[c]);
            if (wi + (32 * c + lane + 1) * RUN == n) last[wb] = (int)st[c];
        }
        return;
    }
    // elsewhere each sample reads its own table entry
#pragma unroll
    for (int c = 0; c < CH; ++c) {
        const long long base = wbase + (32 * c + lane) * RUN;
        if (base >= total) return;
        const int cnt = (int)min((long long)RUN, total - base);
        Chunk x, y;
        load_run<VEC>(in, base, cnt, x);
        long long b;
        int i;
        split(base, N, inv_n, b, i);
#pragma unroll
        for (int k = 0; k < RUN; ++k) {
            if (k >= cnt) break;
            if (i < n) {
                const unsigned st = (unsigned)apow[i] * (unsigned)rn[b] +
                                    (unsigned)csum[i];
                y.b[k] = noisy(x.b[k], st, noise[b], shift);
                if (i == n - 1) last[b] = (int)st;
            } else {
                y.b[k] = x.b[k];
            }
            if (++i == N) {
                i = 0;
                ++b;
            }
        }
        store_run<VEC>(out, base, cnt, y);
    }
}

// crt_rand (ops/lcg.py): x -> A1 * x + C1; two and three calls composed
constexpr unsigned A1 = 1103515245u, C1 = 12345u;
constexpr unsigned A2 = A1 * A1, C2 = A1 * C1 + C1;
constexpr unsigned A3 = A2 * A1, C3 = A1 * C2 + C1;

// A block takes THREADS * SPT samples of one slot's regions B+C, SPT a
// thread at stride THREADS: every load is issued before the draws.
__global__ void __launch_bounds__(THREADS)
    vhs_noise_bc_kernel(signed char* __restrict__ x,        // (B, N)
                        const int* __restrict__ entB,       // (B, nB)
                        const int* __restrict__ a3,         // (nC,)
                        const int* __restrict__ c3,         // (nC,)
                        const int* __restrict__ cs,         // (8, nB + nC)
                        const int* __restrict__ band_line,  // (B,)
                        const int* __restrict__ noise,      // (B,)
                        int* __restrict__ st_final,         // (B,)
                        int* __restrict__ rn_out,           // (B,)
                        int N, int nB, int nC, int H, int per_slot) {
    const int b = blockIdx.x / per_slot;
    const int j0 = (blockIdx.x - b * per_slot) * THREADS * SPT + threadIdx.x;
    const int nBC = nB + nC;
    const int* eb = entB + (long long)b * nB;
    signed char* xb = x + (long long)b * N + (N - nBC);
    unsigned stC = 0;
    if (j0 + (SPT - 1) * THREADS >= nB) {
        // region C's entry state: K5's step t = nB - 1 from region B's
        // last entry, then the three-call stream
        const unsigned e = (unsigned)eb[nB - 1];
        const unsigned s2 = A2 * e + C2, s3 = A3 * e + C3;
        const int m = (int)((s2 >> 1) % 20u);
        stC = m * H + (nB - 1) > 19 * H - 1 ? s3 : s2;
    }
    // the band sinusoid's entry loads with the rest, needed or not: it is
    // read from L2 (one 8-row table), and waiting on the band test would
    // add a round trip
    const int* csb = cs + (band_line[b] - 10) * nBC;
    const int nz = noise[b];
    unsigned ent[SPT];
    int xs[SPT], cv[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
        const int j = j0 + k * THREADS;
        if (j < nB) {
            ent[k] = (unsigned)eb[j];
        } else if (j < nBC) {
            ent[k] = (unsigned)a3[j - nB] * stC + (unsigned)c3[j - nB];
        }
        xs[k] = j < nBC ? xb[j] : 0;
        cv[k] = j < nBC ? csb[j] : 0;
    }
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
        const int j = j0 + k * THREADS;
        if (j >= nBC) break;
        const int i = N - nBC + j;
        const unsigned r1 = (A1 * ent[k] + C1) >> 1;  // the noise byte's draw
        const unsigned st2 = A2 * ent[k] + C2;
        const int m1 = (int)((st2 >> 1) % 20u);     // the band's upper edge
        const unsigned rC = (A1 * st2 + C1) >> 1;   // its lower edge, call 3
        const bool band = m1 * H > N - 6 * H - i &&
                          H * (1 + (int)(rC % 8u)) < N - i;
        const int nn = band ? cv[k] : nz;
        const int byte = (int)((r1 >> 16) & 0xFFu) - 0x7F;
        xb[j] = (signed char)clamp_int(xs[k] + (mul32(byte, nn) >> 8), -127,
                                       127);
        if (j == nBC - 1) {
            st_final[b] = (int)(A3 * ent[k] + C3);
            rn_out[b] = (int)r1;
        }
    }
}

}  // namespace

extern "C" int ntsc_inject_noise(const void* analog, void* out,
                                 const void* apow, const void* csum,
                                 const void* rn, const void* noise,
                                 void* last, int B, int N, int n, int shift,
                                 int ga, int gc, void* stream) {
    if (B < 1 || N < 1 || n < 1 || n > N || shift < 0 || shift > 24)
        return (int)cudaErrorInvalidValue;
    const long long total = (long long)B * N;
    const long long warps = (total + SPAN - 1) / SPAN;
    const long long blocks = (warps * 32 + THREADS - 1) / THREADS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    const Jump g{(unsigned)ga, (unsigned)gc};
    const double inv_n = 1.0 / N;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto i8 = [](const void* p) {
        return static_cast<const signed char*>(p);
    };
    const auto i32 = [](const void* p) { return static_cast<const int*>(p); };
    if ((((uintptr_t)analog | (uintptr_t)out) & 15) == 0)
        inject_noise_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
            i8(analog), (signed char*)out, i32(apow), i32(csum), i32(rn),
            i32(noise), (int*)last, total, N, n, shift, g, inv_n);
    else
        inject_noise_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
            i8(analog), (signed char*)out, i32(apow), i32(csum), i32(rn),
            i32(noise), (int*)last, total, N, n, shift, g, inv_n);
    return (int)cudaGetLastError();
}

extern "C" int ntsc_vhs_noise_bc(void* x, const void* entB, const void* a3,
                                 const void* c3, const void* cs,
                                 const void* band_line, const void* noise,
                                 void* st_final, void* rn_out, int B, int N,
                                 int nB, int nC, int H, void* stream) {
    if (B < 1 || nB < 1 || nC < 1 || H < 1 || (long long)nB + nC > N ||
        20LL * H + nB >= (1LL << 31) || 6LL * H + N >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const int per_slot = (nB + nC + THREADS * SPT - 1) / (THREADS * SPT);
    const long long blocks = (long long)B * per_slot;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    const auto i32 = [](const void* p) { return static_cast<const int*>(p); };
    vhs_noise_bc_kernel<<<(unsigned)blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        (signed char*)x, i32(entB), i32(a3), i32(c3), i32(cs), i32(band_line),
        i32(noise), (int*)st_final, (int*)rn_out, N, nB, nC, H, per_slot);
    return (int)cudaGetLastError();
}
