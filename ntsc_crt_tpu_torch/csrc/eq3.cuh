// The reference's 3-band equalizer, eqf() (crt_core.c:206-233), for one
// channel: two cascaded 4-stage one-pole low-pass chains and a 3-deep
// history of the input, state reset to zero at each line start.
//
// Shared by K2 decode_rows (csrc/decode.cu), K8 eq_threeband_rows
// (csrc/rowfilters.cu) and the issue-rate probe K10 (csrc/probe.cu), so the
// three run one chain and cannot drift apart.  It is the JAX package's
// _eq_chain (ntsc_crt_tpu/ops/pallas/decode_fused.py:85-97) step for step.
#pragma once

#include "int32.cuh"

constexpr int EQ_P = 16;  // crt_core.c:155
constexpr int EQ_R = 1 << (EQ_P - 1);

struct EqCoefs {
    int lf, hf, g0, g1, g2;
};

__device__ __forceinline__ int pole(int f, int c, int x) {
    return add32(f, add32(mul32(c, sub32(x, f)), EQ_R) >> EQ_P);
}

struct ThreeBand {
    using Coefs = EqCoefs;
    int fL0, fL1, fL2, fL3, fH0, fH1, fH2, fH3, h0, h1, h2;

    __device__ void reset() { fill(0); }

    // every state int set to v (the probe starts from x + channel)
    __device__ void fill(int v) {
        fL0 = fL1 = fL2 = fL3 = fH0 = fH1 = fH2 = fH3 = h0 = h1 = h2 = v;
    }

    __device__ int step(int sx, const EqCoefs& c) {
        fL0 = pole(fL0, c.lf, sx);
        fH0 = pole(fH0, c.hf, sx);
        fL1 = pole(fL1, c.lf, fL0);
        fH1 = pole(fH1, c.hf, fH0);
        fL2 = pole(fL2, c.lf, fL1);
        fH2 = pole(fH2, c.hf, fH1);
        fL3 = pole(fL3, c.lf, fL2);
        fH3 = pole(fH3, c.hf, fH2);
        const int out = add32(add32(mul32(fL3, c.g0) >> EQ_P,
                                    mul32(sub32(fH3, fL3), c.g1) >> EQ_P),
                              mul32(sub32(h2, fH3), c.g2) >> EQ_P);
        h2 = h1;
        h1 = h0;
        h0 = sx;
        return out;
    }
};
