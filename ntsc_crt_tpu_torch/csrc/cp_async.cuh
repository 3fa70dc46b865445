// Asynchronous global -> shared copies (cp.async, sm_80 and later).
//
// Each copy is issued by one thread and lands in shared memory without
// passing through its registers; the thread goes on at once.  Copies are
// grouped by cp_async_commit(); cp_async_wait<N>() returns once at most the
// N most recent groups are still in flight.  A __syncwarp() after the wait
// makes every lane's landed copies visible to the whole warp.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem)
                 : "memory");
}

// 16 bytes, or 16 zero bytes and no read when `valid` is false; both
// addresses 16-byte aligned
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem), "r"(valid ? 16 : 0)
                 : "memory");
}

// 4 bytes, or 4 zero bytes and no read when `valid` is false; both
// addresses 4-byte aligned
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
