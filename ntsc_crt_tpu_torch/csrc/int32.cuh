// Two's-complement int32 arithmetic for the kernels.
//
// The reference and the JAX package both compute in wrapping int32; signed
// overflow is undefined in C++, so every sum or product that can leave the
// int32 range goes through uint32 and is cast back.  Right shifts of
// negative ints are arithmetic under nvcc, as in the reference and in XLA.
#pragma once

#include <cstdint>

__device__ __forceinline__ int add32(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int sub32(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int mul32(int a, int b) {
    return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
