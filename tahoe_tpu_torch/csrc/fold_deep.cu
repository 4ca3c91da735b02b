// Deep kernel: f32 fold of the forests that kernel C's shared-memory tiles
// serve badly (depth >= 9, rows too wide for 256-row blocks, depth 13-15,
// which no tile holds), ge dual and sign forms, one entry point each.
//
// Replaces the Pallas kernel tahoe_tpu/ops/fold_kernel.py _make_split_kernel
// (:688, launched from fold_margins' split branch :829-865). It computes the
// same margins as kernel C (csrc/fold.cu) on the same tables, with the node
// compare of common.cuh:
//   tahoe_fold_deep        dual, rows as [x, -x]
//   tahoe_fold_deep_sign   sign, rows at width F
// The TPU kernel's subtree-group grid, roots scratch and compile walls exist
// for VMEM and Mosaic compile time; none is carried over.
//
// What bounds it on the H100: one depth-15 tree's tables are 393 KB, more
// than a block's 227 KB, so nodes cannot be staged whole. A descent visits
// only D nodes per (row, tree), though, and a whole deep15-class forest
// (30 trees x 2^15 nodes x 12 B, 11.8 MB) fits the 50 MB L2. So each node is
// one 8-byte (threshold bits, code) load through the read-only path
// (ops/fold_kernel.py deep_nodes), and the top levels, which every row of a
// block visits, stay in L1. The bound is the latency of those dependent
// loads: D per (row, tree). One thread owns one row, the block's rows staged
// in shared memory at an odd stride as in kernel C; kTreesInFlight trees
// descend together to overlap their load chains. Leaf values are summed in
// double in tree order, one pass, no atomics, and round once to f32. Built
// without fast-math or flush-to-zero: denormal thresholds and NaN routing
// stay exact.
#include "common.cuh"

namespace {

template <int Form>
__global__ void fold_deep_kernel(const float* __restrict__ x, int rows, int W,
                                 const int2* __restrict__ nodes,
                                 const float* __restrict__ leaf, int T, int D,
                                 float* __restrict__ out) {
    extern __shared__ float xs[];  // [BR, W | 1]
    const int BR = blockDim.x;
    const int Ws = W | 1;
    const long long N = (1LL << D) - 1;
    const long long L = 1LL << D;

    const long long row0 = static_cast<long long>(blockIdx.x) * BR;
    const int nrows = static_cast<int>(min(static_cast<long long>(BR), rows - row0));
    for (int i = threadIdx.x; i < nrows * W; i += BR)
        xs[(i / W) * Ws + i % W] = x[row0 * W + i];
    __syncthreads();

    const int r = threadIdx.x;
    if (r >= nrows) return;
    const float* xr = xs + r * Ws;
    double acc = 0.0;
    for (int t0 = 0; t0 < T; t0 += kTreesInFlight) {
        const int2* base[kTreesInFlight];
        int j[kTreesInFlight];
#pragma unroll
        for (int k = 0; k < kTreesInFlight; ++k) {
            j[k] = 0;
            base[k] = nodes + min(t0 + k, T - 1) * N;  // tail slots repeat a tree
        }
        for (int d = 0; d < D; ++d) {
            const int off = (1 << d) - 1;
#pragma unroll
            for (int k = 0; k < kTreesInFlight; ++k) {
                const int2 nd = __ldg(base[k] + off + j[k]);
                j[k] += tahoe_node_cond<Form>(xr, nd.y, __int_as_float(nd.x)) << d;
            }
        }
#pragma unroll
        for (int k = 0; k < kTreesInFlight; ++k)
            if (t0 + k < T) acc += static_cast<double>(__ldg(leaf + (t0 + k) * L + j[k]));
    }
    out[row0 + r] = static_cast<float>(acc);
}

template <int Form>
int launch_deep(const float* x, int rows, int W, const int2* nodes,
                const float* leaf, int T, int D, int rows_per_block,
                int smem_bytes, float* out, cudaStream_t stream) {
    if (rows == 0) return 0;
    cudaError_t err = tahoe_set_smem(fold_deep_kernel<Form>, static_cast<size_t>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (rows + rows_per_block - 1) / rows_per_block;
    fold_deep_kernel<Form><<<grid, rows_per_block, smem_bytes, stream>>>(
        x, rows, W, nodes, leaf, T, D, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

TAHOE_EXPORT int tahoe_fold_deep(const float* x2, int rows, int W, const int2* nodes,
                                 const float* leaf, int T, int D,
                                 int rows_per_block, int smem_bytes, float* out,
                                 cudaStream_t stream) {
    return launch_deep<kDual>(x2, rows, W, nodes, leaf, T, D, rows_per_block,
                              smem_bytes, out, stream);
}

TAHOE_EXPORT int tahoe_fold_deep_sign(const float* x, int rows, int W,
                                      const int2* nodes, const float* leaf, int T,
                                      int D, int rows_per_block, int smem_bytes,
                                      float* out, cudaStream_t stream) {
    return launch_deep<kSign>(x, rows, W, nodes, leaf, T, D, rows_per_block,
                              smem_bytes, out, stream);
}
