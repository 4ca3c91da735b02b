// The fused rank transform + traversal: f32 rows -> f32 margins, the rows'
// ranks kept in shared memory.
//
// Replaces the Pallas kernel tahoe_tpu/ops/rank_kernel.py
// rank_fold_margins_fused (:560; kernel body _make_split_kernel(fuse=...)
// :257-319, launcher _split_row_outer :481-557). It computes the margins of
// kernel A (rank_transform.cu) followed by kernel B (rank_fold.cu) for a
// forest whose virtual features fit one plane group (F <= 30), and nothing
// but the margins reaches device memory: no plane byte is formed (SUSY at
// 65,536 rows: the 8 MB that kernel A writes and kernel B reads back) and
// there is one launch fewer.
//
// One thread owns one row, in both halves:
// - Search (kernel A's, tahoe_rank_search in common.cuh). The block stages
//   the coarse index of the F features once; then a warp's 32 lanes rank
//   their own 32 rows feature by feature (the search needs the warp on one
//   feature's table). A thread writes its row's pair values straight into
//   shared memory: v[i] = q and v[F + i] = -q of feature i, -16384 in both
//   for a missing value, and v[2F] = 0. They are kernel B's pair values
//   127 * p[lane] + p[lane + 30] at the lanes its records point at (qh/ql,
//   -qh/-ql, the zeros past the row), in 2F + 1 int16 at an odd word stride
//   (SUSY-class: 19 words a row against kernel B's 65).
// - Walk (kernel B's). The records are kernel B's with each lane remapped to
//   that compact index (ops/rank_kernel.py fused_records): diff = v[i] + k,
//   n += (1 + (diff >= 0)) << d from the root, kTrees chains in flight,
//   leaves summed in double in tree order and rounded once to f32.
// The ranks, diffs and leaf sums are kernels A and B's, in their order, so
// the margins are bit-identical to kernels A then B.
//
// A warp needs no other warp after the block's one barrier: its rows are
// its own from search to walk. So the warps of an SM drift apart, and the
// searches (L2-bound: a 64-byte window a (row, feature)) overlap the walks
// (bound by the latency of each visit's dependent record load and
// shared-memory read). Of the layouts measured (PERF.md), this one is kept:
// 256 rows a block (fewer rows leave fewer walks in flight where the coarse
// index is large), the compact staging (kernel B's 65 words a row halve the
// blocks an SM beside a 53-61 KB index), x read straight from device
// memory (staging it a warp at a time ran slower but on SUSY-class) and one
// tile a block (persistent blocks ran no faster at 65,536 rows).
//
// What bounds it on the H100 (SUSY-class: 65,536 rows, 500 trees, depth 8,
// 18 features): the walk's operations, four a visited node (kernel B's),
// and the search's steps, 0.0164 ms at 67 T/s; the bytes give 0.0016 ms
// (4.7 MB of rows, 0.52 MB of thresholds, 0.51 MB of records and of
// leaves, 0.26 MB of margins at 3.35 TB/s). Like kernel B it runs far from
// either bound: the walk waits on its dependent loads.
#include "common.cuh"

namespace {

// scripts/kernel_ab.py rebuilds this file alone with 128 rows a block to
// measure it again.
#ifndef TAHOE_FUSED_ROWS
#define TAHOE_FUSED_ROWS 256
#endif
constexpr int kRows = TAHOE_FUSED_ROWS;   // rows (and threads) a block
constexpr int kTrees = 8;                 // trees in flight a thread (kernel B's)
constexpr int kMissing = -16384;          // 127 * -128 + -128

// Words of one row's staging, 2F + 1 int16 at an odd stride.
__host__ __device__ constexpr int row_words(int F) {
    return (F + 1) | 1;
}

__global__ void __launch_bounds__(kRows)
rank_fused_kernel(const float* __restrict__ x, int rows, int F,
                  const float* __restrict__ thr, int K,
                  const int* __restrict__ counts, RankCoarse rc,
                  const int* __restrict__ records, int T, int D,
                  const float* __restrict__ leaf, float* __restrict__ out) {
    extern __shared__ int smem_words[];
    float* coarse = reinterpret_cast<float*>(smem_words);  // [F, rc.Mp]
    const int stride = row_words(F);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    // this thread's row: q of feature i at i, -q at F + i, a zero at 2F
    short* v = reinterpret_cast<short*>(smem_words + F * rc.Mp + threadIdx.x * stride);
    tahoe_rank_stage_coarse(coarse, thr, 0, F, K, rc);
    v[2 * F] = 0;
    __syncthreads();

    const int N = (1 << D) - 1;  // nodes per tree; node n = 2^d - 1 + j
    const int tiles = (rows + kRows - 1) / kRows;
    // one tile a block (grid = tiles), written as a grid-stride loop: ptxas
    // then issues the kTrees record loads of a level together; without the
    // loop it interleaved each with its shared-memory read, 1.24x slower on
    // SUSY-class (PERF.md)
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long wrow0 = static_cast<long long>(tile) * kRows + warp * 32;
        if (wrow0 >= rows) break;  // the whole warp
        const long long row = wrow0 + lane;
        const bool live = row < rows;
        for (int f = 0; f < F; ++f) {  // the warp's 32 rows, a feature at a time
            const float xv = live ? __ldg(x + row * F + f) : CUDART_NAN_F;
            const int q = tahoe_rank_search(xv, coarse + f * rc.Mp, rc,
                                            thr + static_cast<long long>(f) * K, K,
                                            __ldg(counts + f), lane);
            v[f] = static_cast<short>(q < 0 ? kMissing : q);
            v[F + f] = static_cast<short>(q < 0 ? kMissing : -q);
        }
        if (!live) continue;

        double acc = 0.0;
        for (int t0 = 0; t0 < T; t0 += kTrees) {
            const int* rec[kTrees];
            int n[kTrees];
#pragma unroll
            for (int k = 0; k < kTrees; ++k) {
                // tail slots repeat the last tree and are not summed
                rec[k] = records + static_cast<long long>(min(t0 + k, T - 1)) * N;
                n[k] = 0;
            }
            for (int d = 0; d < D; ++d) {
#pragma unroll
                for (int k = 0; k < kTrees; ++k) {
                    const int r = __ldg(rec[k] + n[k]);
                    const int diff = v[r & 0xFFF] + (r >> 12);
                    n[k] += (diff >= 0 ? 2 : 1) << d;
                }
            }
#pragma unroll
            for (int k = 0; k < kTrees; ++k)
                if (t0 + k < T)
                    acc += static_cast<double>(
                        leaf[static_cast<long long>(t0 + k) * (N + 1) + n[k] - N]);
        }
        out[row] = static_cast<float>(acc);
    }
}

cudaError_t launch(const float* x, int rows, int F, const float* thr, int K,
                   const int* counts, const int* records, int T, int D,
                   const float* leaf, float* out, cudaStream_t stream) {
    const RankCoarse rc = tahoe_rank_coarse(K, F);
    const size_t smem = (static_cast<size_t>(F) * rc.Mp +
                         static_cast<size_t>(kRows) * row_words(F)) * 4;
    cudaError_t err = tahoe_grant_smem(rank_fused_kernel, smem);
    if (err != cudaSuccess) return err;
    const long long grid = (static_cast<long long>(rows) + kRows - 1) / kRows;
    rank_fused_kernel<<<static_cast<unsigned>(grid), kRows, smem, stream>>>(
        x, rows, F, thr, K, counts, rc, records, T, D, leaf, out);
    return cudaGetLastError();
}

}  // namespace

TAHOE_EXPORT int tahoe_rank_fused(const float* x, int rows, int F,
                                  const float* thr, int K, const int* counts,
                                  const int* records, int T, int D,
                                  const float* leaf, float* out,
                                  cudaStream_t stream) {
    if (rows == 0) return 0;
    // one plane group; every window an aligned 64 bytes, as kernel A takes
    if (F < 1 || F > kRankGroupCols || K < kRankWindow || K % kRankWindow ||
        reinterpret_cast<uintptr_t>(thr) % 16 || T < 1 || D < 0 || D > 30)
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch(x, rows, F, thr, K, counts, records, T, D, leaf, out, stream));
}
