// Kernel A: rank transform, f32 rows -> int8 rank planes.
//
// Replaces the Pallas kernels tahoe_tpu/ops/rank_transform.py
// _make_kernel_v2 (:428, with rank_counts_from_x :274 and the plane assembly
// _assemble_planes :41 / _assemble_group :251) and its flat sibling
// _make_kernel (:78). Both compute, per (row, virtual feature f),
//     q = #{u in U_f : u <= x}
// and write the base-127 plane lanes of compiler.rank_normalize.
//
// On the TPU the bucketed count ran as one-hot digit matmuls because Mosaic
// has no vector gather. Here each thread does a binary search over its
// feature's sorted thresholds (row f of a [F, K] table, +inf padded past
// count[f]); plain float compares give the same rank as the reference's
// monotone int32 key space (-0.0 == +0.0, denormals kept: no fast-math).
//
// What bounds it on the H100: the dependent loads of the binary search
// (log2 K ~ 13 steps for SUSY's 7,250 thresholds per feature), served from
// L1/L2 since the whole table (~0.5 MB for SUSY) stays cache-resident; the
// int8 plane stores are 128 B per row. The design keeps the row's 30
// features of a group in 30 adjacent threads so x loads coalesce, and gives
// the constant lanes to a 31st thread, so no thread loops over features.
// The per-lane work is tahoe_rank_lanes (common.cuh), which the fused
// kernel (rank_fused.cu) runs too.
#include "common.cuh"

namespace {

__global__ void rank_planes_kernel(const float* __restrict__ x, int rows, int F,
                                   int G, const float* __restrict__ thr, int K,
                                   const int* __restrict__ counts,
                                   int8_t* __restrict__ out) {
    const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
    const int i = static_cast<int>(idx & 31);
    const long long rg = idx >> 5;  // (row, group)
    if (rg >= static_cast<long long>(rows) * G) return;
    const int g = static_cast<int>(rg % G);
    const long long r = rg / G;
    tahoe_rank_lanes(x + r * F, F, g, thr, K, counts, out + r * 128 * G + 128 * g, i);
}

}  // namespace

TAHOE_EXPORT int tahoe_rank_planes(const float* x, int rows, int F, int G,
                                   const float* thr, int K, const int* counts,
                                   int8_t* out, cudaStream_t stream) {
    const long long threads = static_cast<long long>(rows) * G * 32;
    if (threads == 0) return 0;
    const int block = 256;
    const long long grid = (threads + block - 1) / block;
    rank_planes_kernel<<<static_cast<unsigned>(grid), block, 0, stream>>>(
        x, rows, F, G, thr, K, counts, out);
    return static_cast<int>(cudaGetLastError());
}
