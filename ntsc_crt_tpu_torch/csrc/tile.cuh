// A warp's 32 rows staged through shared memory, one lane a row: the
// shared pieces of K1 encode_rows (csrc/encode.cu) and K2 decode_rows
// (csrc/decode.cu).
//
// Each lane marches its own row along x and writes its results into a
// shared-memory tile, one tile row per lane.  store_rows then writes the
// tile out a row at a time, consecutive lanes on consecutive words or
// bytes, so one warp store covers 128 (or 32) contiguous bytes of one row
// instead of one byte of 32 rows.  A tile row's pitch is an odd number of
// 4-byte words (odd_pitch), so the 32 lanes reading or writing their own
// rows at one column hit 32 different banks.
//
// Every copy between device memory and a tile goes through copy_block,
// which puts BATCH independent loads a lane in flight before the first
// dependent store: one memory round trip a batch instead of one a row.
#pragma once

#include <cstdint>

constexpr int WARP_ROWS = 32;  // rows of a warp, one lane each
constexpr int BATCH = 8;       // loads a lane has in flight in copy_block

// the least pitch of at least n bytes that is an odd number of words
__host__ __device__ constexpr int odd_pitch(int n) {
    return 4 * (((n + 3) / 4) | 1);
}

// The (row, column) of the flattened index k = lane, lane + 32, ... over a
// block of `cols` columns, stepped without a division.
struct Walk {
    int q, c, dq, dc, cols;

    __device__ Walk(int lane, int cols_)
        : q(lane / cols_), c(lane % cols_), dq(WARP_ROWS / cols_),
          dc(WARP_ROWS % cols_), cols(cols_) {}

    __device__ void next() {
        q += dq;
        c += dc;
        if (c >= cols) {
            c -= cols;
            ++q;
        }
    }
};

// store(q, c, load(q, c)) for every element of an nrows x cols block,
// consecutive lanes on consecutive columns; each lane has BATCH loads in
// flight before it stores the first of them.
template <class T, class Load, class Store>
__device__ __forceinline__ void copy_block(int nrows, int cols, Load load,
                                           Store store) {
    Walk w(threadIdx.x % WARP_ROWS, cols);
    while (__any_sync(0xffffffffu, w.q < nrows)) {
        Walk at = w;
        T v[BATCH];
#pragma unroll
        for (int g = 0; g < BATCH; ++g) {
            if (w.q < nrows) v[g] = load(w.q, w.c);
            w.next();
        }
#pragma unroll
        for (int g = 0; g < BATCH; ++g) {
            if (at.q < nrows) store(at.q, at.c, v[g]);
            at.next();
        }
    }
}

// Bytes [col, col + nb) of rows r0 .. r0 + nrows - 1 of `out` (row pitch
// rowbytes) from the tile (row pitch `pitch`, row q for row r0 + q).
// words: every row start and col are 4-byte aligned and nb is a multiple
// of 4, so the lanes move 4-byte words; else single bytes (32 consecutive
// bytes are still one or two 32-byte sectors a warp store).  Fences the
// warp on both sides: every lane's tile writes are done before, and the
// tile may be written again after.
__device__ __forceinline__ void store_rows(const uint8_t* tile, int pitch,
                                           uint8_t* out, long long rowbytes,
                                           long long r0, int nrows,
                                           long long col, int nb,
                                           bool words) {
    __syncwarp();
    uint8_t* base = out + r0 * rowbytes + col;
    if (words) {
        copy_block<uint32_t>(
            nrows, nb / 4,
            [&](int q, int c) {
                return reinterpret_cast<const uint32_t*>(tile + q * pitch)[c];
            },
            [&](int q, int c, uint32_t v) {
                reinterpret_cast<uint32_t*>(base + q * rowbytes)[c] = v;
            });
    } else {  // the lanes on 32 columns, BATCH rows in flight
        const int lane = threadIdx.x % WARP_ROWS;
        for (int j = lane; j - lane < nb; j += WARP_ROWS) {
            for (int q0 = 0; q0 < nrows; q0 += BATCH) {
                uint8_t v[BATCH];
#pragma unroll
                for (int e = 0; e < BATCH; ++e)
                    if (q0 + e < nrows && j < nb)
                        v[e] = tile[(q0 + e) * pitch + j];
#pragma unroll
                for (int e = 0; e < BATCH; ++e)
                    if (q0 + e < nrows && j < nb)
                        base[(q0 + e) * rowbytes + j] = v[e];
            }
        }
    }
    __syncwarp();
}
