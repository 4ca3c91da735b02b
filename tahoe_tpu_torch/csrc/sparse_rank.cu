// The sparse kernel: CSR rank descent, int8 planes -> f32 margins.
//
// Replaces the Pallas kernel tahoe_tpu/ops/sparse_kernel.py
// _make_sparse_kernel (:251; launched by sparse_rank_margins :349). Both
// compute, per row, the sum over trees of the leaf that the node conditions
//     cond(node) = planes[row, :] . column(node) >= 0     (int32 sum)
// select along a descent of the pruned CSR pool, where the stored children
// of a node are child (cond False) and child + 1 (cond True).
//
// The TPU kernel advances every row through a select chain over every slot
// of every level, because a TPU vector unit has no per-lane gather. A GPU
// thread gathers, so here one thread per row walks each tree and reads only
// what it visits. A node's rank column has four nonzeros
// (compiler.rank_normalize), so its node word keeps them in closed form,
// kernel B's record (k << 12) | lane:
//     diff = 127 * p[lane] + p[lane + 30] + k
// with p the row's plane bytes; the constant lanes 120 and 121 carry 127 and
// 1, and k = 127 * c127 + c1 is their part of the dot product.
//
// What bounds it on the H100: below the top levels the rows of a warp sit
// on different nodes, so every warp-wide load of the pool costs the L1 one
// request per thread, and the loads of a descent wait on each other. One
// 16-byte record a level would make 13.6 of them per (row, tree) on
// rf_deep18-class. Here the pool is read as slots of
// kWords = 2^kLevels words (ops/sparse_kernel.py sparse_blocks), one 16-byte
// load at kLevels = 2: the 3 node words of the 2 levels below a node, in
// heap order, and a base word (base << kWords) | mask. One slot load settles
// 2 levels: the walk i = 2i + 1 + cond runs in registers, and exit
// e = i - (kWords - 1) leads to slot base + popcount(mask & (2^e - 1)). A
// leaf inside a block is padded down with pass-through words (k = -2^19:
// always cond False); a leaf slot holds its value in word 0 and -1 in its
// base word. So a (row, tree) makes ceil(depth / 2) + 1 loads (7.5 on
// rf_deep18-class). Slots of 3 levels, one 32-byte sector but two loads,
// read fewer sectors (5.5) and ran slower: the loads, not the sectors,
// bound it (PERF.md). kTrees trees descend together; their slot loads issue
// before any is used. The block stages its rows' planes in shared memory at
// an odd word stride: at one plane group as int16 pairs v[lane] =
// 127 * p[lane] + p[lane + 30] (one shared read a level, as kernel B), at
// more as the bytes. Leaves are summed in double in tree order, no atomics:
// the margins are the same on every run and round once to f32.
#include "common.cuh"

namespace {

constexpr int kMaxGroups = 16;  // compiler.RANK_MAX_GROUPS
constexpr int kLaneQl = 30;     // compiler.RANK_LANE_QL - RANK_LANE_QH
// Each choice was measured (scripts/kernel_ab.py sparse, H100, PERF.md),
// which rebuilds this file alone with other values to measure them again.
// The slots' width must match ops/sparse_kernel.py SPARSE_LEVELS: the
// launcher refuses another.
#ifndef TAHOE_SPARSE_LEVELS
#define TAHOE_SPARSE_LEVELS 2
#endif
#ifndef TAHOE_SPARSE_TREES
#define TAHOE_SPARSE_TREES 8
#endif
#ifndef TAHOE_SPARSE_PAIR_GROUPS
#define TAHOE_SPARSE_PAIR_GROUPS 1
#endif
#ifndef TAHOE_SPARSE_ROWS
#define TAHOE_SPARSE_ROWS 64
#endif
constexpr int kLevels = TAHOE_SPARSE_LEVELS;  // levels a slot settles
constexpr int kWords = 1 << kLevels;          // int32 words a slot
constexpr int kVecs = kWords / 4;             // 16-byte loads a slot
constexpr int kTrees = TAHOE_SPARSE_TREES;    // trees in flight per thread
// the pair staging up to this many groups, the bytes above: on
// rf_deep18-class (one group) the pairs ran 0.3489 ms against the bytes'
// 0.3538, rounds within 0.0007
constexpr int kMaxPairGroups = TAHOE_SPARSE_PAIR_GROUPS;
// rows a block, at most: 64 and 128 tied there (0.3489, 0.3491), 32 ran 1%
// and 256 (160 within 48 KB) 8% slower
constexpr int kMaxRows = TAHOE_SPARSE_ROWS;
static_assert(kLevels == 2 || kLevels == 3, "slots of 2 or 3 levels");
static_assert(kMaxRows >= 32 && kMaxRows % 32 == 0, "rows a block: whole warps");

// Shared-memory words of one staged row, both odd: v as int16 over lanes
// [0, 128G], or the bytes.
__host__ __device__ constexpr int row_words(int G, bool pairs) {
    return pairs ? 64 * G + 1 : 32 * G + 1;
}

template <bool kPairs>
__global__ void sparse_rank_kernel(const int8_t* __restrict__ planes, int rows,
                                   int G, const int4* __restrict__ slots, int T,
                                   int steps, float* __restrict__ out) {
    extern __shared__ int smem_words[];
    const int lanes = 128 * G;
    const int stride = row_words(G, kPairs);
    const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x;
    const int nrows = static_cast<int>(min(static_cast<long long>(blockDim.x),
                                           rows - row0));
    if constexpr (kPairs) {
        // word w of a row holds v[2w] | v[2w + 1] << 16; p past the row is 0
        const int8_t* src = planes + row0 * lanes;
        for (int i = threadIdx.x; i < nrows * stride; i += blockDim.x) {
            const int r = i / stride;
            const int l = 2 * (i - r * stride);
            const int8_t* p = src + static_cast<long long>(r) * lanes;
            int v0 = 0, v1 = 0;
            if (l < lanes) {
                v0 = 127 * p[l] + (l + kLaneQl < lanes ? p[l + kLaneQl] : 0);
                v1 = 127 * p[l + 1] + (l + 1 + kLaneQl < lanes ? p[l + 1 + kLaneQl] : 0);
            }
            smem_words[i] = (v0 & 0xFFFF) | (v1 << 16);
        }
    } else {
        const int words = lanes / 4;
        const int* src = reinterpret_cast<const int*>(planes) + row0 * words;
        for (int i = threadIdx.x; i < nrows * words; i += blockDim.x)
            smem_words[(i / words) * stride + i % words] = src[i];
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) >= nrows) return;

    const int* own = smem_words + threadIdx.x * stride;
    const short* v = reinterpret_cast<const short*>(own);
    const int8_t* p = reinterpret_cast<const int8_t*>(own);
    double acc = 0.0;
    for (int t0 = 0; t0 < T; t0 += kTrees) {
        int slot[kTrees];  // the slot to read next, -1 once the leaf is read
        float leaf[kTrees];
#pragma unroll
        for (int k = 0; k < kTrees; ++k) {
            slot[k] = t0 + k < T ? t0 + k : -1;  // slot t is tree t's root
            leaf[k] = 0.0f;
        }
        for (int s = 0; s < steps; ++s) {
            int w[kTrees][kWords];
#pragma unroll
            for (int k = 0; k < kTrees; ++k) {
                // a finished tree rereads slot 0, so every load issues here
                const int4* src = slots + static_cast<long long>(max(slot[k], 0)) * kVecs;
#pragma unroll
                for (int q = 0; q < kVecs; ++q) {
                    const int4 a = __ldg(src + q);
                    w[k][4 * q] = a.x;
                    w[k][4 * q + 1] = a.y;
                    w[k][4 * q + 2] = a.z;
                    w[k][4 * q + 3] = a.w;
                }
            }
            bool more = false;
#pragma unroll
            for (int k = 0; k < kTrees; ++k) {
                if (slot[k] < 0) continue;
                const int base = w[k][kWords - 1];
                if (base < 0) {  // a leaf slot
                    leaf[k] = __int_as_float(w[k][0]);
                    slot[k] = -1;
                    continue;
                }
                int i = 0;
#pragma unroll
                for (int l = 0; l < kLevels; ++l) {
                    // the word at position i of level l, selected in registers
                    const int first = (1 << l) - 1;
                    int word = w[k][first];
#pragma unroll
                    for (int m = 1; m < (1 << l); ++m)
                        if (i == first + m) word = w[k][first + m];
                    const int lane = word & 0xFFF;
                    int diff;
                    if constexpr (kPairs) {
                        diff = v[lane] + (word >> 12);
                    } else {
                        diff = 127 * p[lane] + p[lane + kLaneQl] + (word >> 12);
                    }
                    i = 2 * i + 1 + (diff >= 0);
                }
                const int e = i - (kWords - 1);
                slot[k] = (base >> kWords) + __popc(base & ((1 << e) - 1));
                more = true;
            }
            if (!more) break;
        }
#pragma unroll
        for (int k = 0; k < kTrees; ++k)
            if (t0 + k < T) acc += static_cast<double>(leaf[k]);
    }
    out[row0 + threadIdx.x] = static_cast<float>(acc);
}

template <bool kPairs>
cudaError_t launch(const int8_t* planes, int rows, int G, const int* slots, int T,
                   int steps, float* out, cudaStream_t stream) {
    // kMaxRows rows a block while they fit 48 KB, else fewer, down to one
    // warp (the bytes at G = 16: 32 rows in 66 KB)
    const int row_bytes = 4 * row_words(G, kPairs);
    const int block = max(32, min(kMaxRows, (48 * 1024 / row_bytes) & ~31));
    const size_t smem = static_cast<size_t>(block) * row_bytes;
    cudaError_t err = tahoe_grant_smem(sparse_rank_kernel<kPairs>, smem);
    if (err != cudaSuccess) return err;
    const long long grid = (static_cast<long long>(rows) + block - 1) / block;
    sparse_rank_kernel<kPairs><<<static_cast<unsigned>(grid), block, smem, stream>>>(
        planes, rows, G, reinterpret_cast<const int4*>(slots), T, steps, out);
    return cudaGetLastError();
}

}  // namespace

TAHOE_EXPORT int tahoe_sparse_rank(const int8_t* planes, int rows, int G,
                                   const int* slots, int words, int T, int steps,
                                   float* out, cudaStream_t stream) {
    if (rows == 0) return 0;
    if (G < 1 || G > kMaxGroups || T < 1 || steps < 1 || words != kWords ||
        reinterpret_cast<uintptr_t>(slots) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        G <= kMaxPairGroups
            ? launch<true>(planes, rows, G, slots, T, steps, out, stream)
            : launch<false>(planes, rows, G, slots, T, steps, out, stream));
}

// Registers a thread of the sparse kernel with its int16 pair staging or its
// bytes.
TAHOE_EXPORT int tahoe_sparse_rank_registers(int pairs, int* regs) {
    return pairs ? tahoe_kernel_registers(sparse_rank_kernel<true>, regs)
                 : tahoe_kernel_registers(sparse_rank_kernel<false>, regs);
}
