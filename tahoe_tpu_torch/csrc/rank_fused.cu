// The fused rank transform + traversal: f32 rows -> f32 margins, the planes
// kept in shared memory.
//
// Replaces the Pallas kernel tahoe_tpu/ops/rank_kernel.py
// rank_fold_margins_fused (:560; kernel body _make_split_kernel(fuse=...)
// :257-319, launcher _split_row_outer :481-557). It computes the margins of
// kernel A (rank_transform.cu) followed by kernel B (rank_fold.cu) for a
// forest whose virtual features fit one plane group (G == 1, <= 30), and
// the planes never reach device memory: 128 bytes a row (SUSY at 65,536
// rows: 8 MB written by kernel A and read back by kernel B) and one launch
// fewer.
//
// One warp owns one row, as in kernel B (256 threads, 8 rows a block).
// Lanes 0-29 binary-search the row's features with kernel A's own code
// (tahoe_rank_lanes, common.cuh) and lane 30 writes the constant lanes,
// into the warp's 128-byte slot of shared memory (1 KB a block). After
// __syncwarp() lane k holds plane word k in a register, and the warp runs
// kernel B's descent on it: node j of level d has its children at j and
// j + 2^d of level d + 1, cond = planes . column >= 0 by dp4a and a warp
// sum, four trees in flight, leaves summed in double in tree order. The
// integer dots are exact and the leaf sum runs in kernel B's order, so the
// margins are bit-identical to kernels A then B.
//
// What bounds it on the H100 (SUSY-class: 65,536 rows, 500 trees, depth 8,
// 18 features): the int8 operations of the descent, 8 visited columns of
// 128 multiply-adds per (row, tree): 33.6 G multiply-adds, 67.1 G
// operations, 0.034 ms at 1,979 TOP/s. The bytes give 0.0067 ms: 4.7 MB of
// rows, 16.3 MB of columns, 0.52 MB of thresholds, 0.51 MB of leaves and
// 0.26 MB of margins at 3.35 TB/s. Like kernel B, it runs far from either
// bound: each visited column is a dependent 128-byte load followed by a
// five-step shuffle sum.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;           // 8 warps, 8 rows a block
constexpr int kWarps = kBlock / 32;

__global__ void __launch_bounds__(kBlock)
rank_fused_kernel(const float* __restrict__ x, int rows, int F,
                  const float* __restrict__ thr, int K,
                  const int* __restrict__ counts,
                  const int8_t* __restrict__ mats, int T, int D,
                  const float* __restrict__ leaf, float* __restrict__ out) {
    __shared__ __align__(16) int8_t slot[kWarps][128];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
    if (row >= rows) return;  // the whole warp leaves together

    // kernel A for this row's one group, into the warp's slot
    tahoe_rank_lanes(x + row * F, F, 0, thr, K, counts, slot[warp], lane);
    __syncwarp();
    const int p = reinterpret_cast<const int*>(slot[warp])[lane];

    // kernel B's descent on the row's plane word
    const long long N = (1LL << D) - 1;  // nodes per tree
    const long long L = 1LL << D;        // leaves per tree
    double acc = 0.0;
    for (int t0 = 0; t0 < T; t0 += kTreesInFlight) {
        int j[kTreesInFlight];
        const int* col[kTreesInFlight];
#pragma unroll
        for (int k = 0; k < kTreesInFlight; ++k) {
            j[k] = 0;
            const int t = min(t0 + k, T - 1);  // tail lanes repeat the last tree
            col[k] = reinterpret_cast<const int*>(mats) + t * N * 32;
        }
        for (int d = 0; d < D; ++d) {
            int s[kTreesInFlight];
#pragma unroll
            for (int k = 0; k < kTreesInFlight; ++k)
                s[k] = __dp4a(p, __ldg(col[k] + ((1LL << d) - 1 + j[k]) * 32 + lane), 0);
#pragma unroll
            for (int k = 0; k < kTreesInFlight; ++k)
                j[k] += (tahoe_warp_sum(s[k]) >= 0) << d;
        }
#pragma unroll
        for (int k = 0; k < kTreesInFlight; ++k)
            if (t0 + k < T) acc += static_cast<double>(leaf[(t0 + k) * L + j[k]]);
    }
    if (lane == 0) out[row] = static_cast<float>(acc);
}

}  // namespace

TAHOE_EXPORT int tahoe_rank_fused(const float* x, int rows, int F,
                                  const float* thr, int K, const int* counts,
                                  const int8_t* mats, int T, int D,
                                  const float* leaf, float* out,
                                  cudaStream_t stream) {
    if (rows == 0) return 0;
    if (F < 1 || F > kRankGroupCols) return static_cast<int>(cudaErrorInvalidValue);
    const long long grid = (32LL * rows + kBlock - 1) / kBlock;
    rank_fused_kernel<<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
        x, rows, F, thr, K, counts, mats, T, D, leaf, out);
    return static_cast<int>(cudaGetLastError());
}
