// Kernel C: f32 fold, canonicalized rows -> f32 margins, in three node forms.
//
// Replaces the Pallas kernel tahoe_tpu/ops/fold_kernel.py _make_kernel (:531,
// launched by fold_margins :814, tree-outer :881 or row-outer :906) in each
// of its forms, one exported entry point per form (ops/fold_kernel.py):
//   tahoe_fold        ge dual-lane: rows as [x, -x] lanes,
//                     cond = x2[fid'] >= t'
//   tahoe_fold_sign   ge sign form (:541-546, :594-605): rows at width F,
//                     cond = (code < 0 ? -x[~code] : x[code]) >= t'
//   tahoe_fold_nonge  non-ge (:551-586, :654-669): levelize's thresholds,
//                     cond = (sel_lt ? x[f] < t : x[f] >= t) XOR flip
// Missing values arrive as NaN. compiler.ge_normalize has folded missing
// routing, def_left and exchange into the ge compares; pass-through nodes
// hold t' = NaN (always False) and negated thresholds are nextafter(-t, +inf),
// denormal near 0, while the negation of a NaN stays NaN and compares False —
// so this file is never built with fast-math or flush-to-zero.
//
// The TPU kernel folds every node bottom-up (no per-lane gather); this one
// descends: node j of level d has its children at j and j + 2^d of level
// d+1, so the walk is j += cond << d and the final j indexes the leaf table.
//
// What bounds it on the H100: the dependent shared-memory loads of the
// descent (code, then x[f] and t', per level), ~D of them per (row, tree).
// One thread owns one row; the block stages its rows (odd row stride, so
// threads reading the same lane hit distinct banks) and then, tile by tile,
// as many trees' node tables as fit its shared-memory budget, which every
// row of the block reuses. The sign form stages rows at width F, not 2F, so
// its blocks hold fewer rows (fold_launch sizes them). Four trees descend
// together to overlap their load chains. Leaf values are summed in double in
// tree order, one pass, no atomics: the margins are the same on every run
// and round once to f32.
//
// The dual form keeps its own kernel body, the sign and non-ge forms share a
// template: compiled from the shared template, the dual form got another
// instruction schedule and ran 1.4% slower at SUSY shapes (0.3862 -> 0.3915
// ms on one H100), while this body compiles to the same SASS as before.
#include "common.cuh"

namespace {

// The dual form (tahoe_fold).
__global__ void fold_kernel(const float* __restrict__ x2, int rows, int W,
                            const float* __restrict__ thr,
                            const int* __restrict__ fid,
                            const float* __restrict__ leaf, int T, int D,
                            int tile_trees, float* __restrict__ out) {
    extern __shared__ float smem[];
    const int BR = blockDim.x;
    const int Ws = W | 1;  // odd stride: conflict-free same-lane reads
    const int N = (1 << D) - 1;
    const int L = 1 << D;
    float* xs = smem;                                  // [BR, Ws]
    float* ts = xs + BR * Ws;                          // [tile, N]
    int* fs = reinterpret_cast<int*>(ts + tile_trees * N);  // [tile, N]
    float* ls = reinterpret_cast<float*>(fs + tile_trees * N);  // [tile, L]

    const long long row0 = static_cast<long long>(blockIdx.x) * BR;
    const int nrows = static_cast<int>(min(static_cast<long long>(BR), rows - row0));
    for (int i = threadIdx.x; i < nrows * W; i += BR)
        xs[(i / W) * Ws + i % W] = x2[row0 * W + i];

    const int r = threadIdx.x;
    const float* xr = xs + r * Ws;
    double acc = 0.0;
    for (int t0 = 0; t0 < T; t0 += tile_trees) {
        const int nt = min(tile_trees, T - t0);
        __syncthreads();  // previous tile fully read
        for (int i = threadIdx.x; i < nt * N; i += BR) {
            ts[i] = thr[static_cast<long long>(t0) * N + i];
            fs[i] = fid[static_cast<long long>(t0) * N + i];
        }
        for (int i = threadIdx.x; i < nt * L; i += BR)
            ls[i] = leaf[static_cast<long long>(t0) * L + i];
        __syncthreads();
        if (r >= nrows) continue;
        for (int tt = 0; tt < nt; tt += kTreesInFlight) {
            int j[kTreesInFlight];
            int base[kTreesInFlight];
#pragma unroll
            for (int k = 0; k < kTreesInFlight; ++k) {
                j[k] = 0;
                base[k] = min(tt + k, nt - 1) * N;  // tail slots repeat a tree
            }
            for (int d = 0; d < D; ++d) {
                const int off = (1 << d) - 1;
#pragma unroll
                for (int k = 0; k < kTreesInFlight; ++k) {
                    const int n = base[k] + off + j[k];
                    // tahoe_node_cond<kDual>, written out: through the
                    // helper ptxas orders this body's loads differently
                    j[k] += (xr[fs[n]] >= ts[n]) << d;
                }
            }
#pragma unroll
            for (int k = 0; k < kTreesInFlight; ++k)
                if (tt + k < nt) acc += static_cast<double>(ls[(tt + k) * L + j[k]]);
        }
    }
    if (r < nrows) out[row0 + r] = static_cast<float>(acc);
}

// The sign and non-ge forms: the dual form's kernel with tahoe_node_cond<F>.
template <int F>
__global__ void fold_form_kernel(const float* __restrict__ x, int rows, int W,
                                 const float* __restrict__ thr,
                                 const int* __restrict__ fid,
                                 const float* __restrict__ leaf, int T, int D,
                                 int tile_trees, float* __restrict__ out) {
    extern __shared__ float smem[];
    const int BR = blockDim.x;
    const int Ws = W | 1;  // odd stride: conflict-free same-lane reads
    const int N = (1 << D) - 1;
    const int L = 1 << D;
    float* xs = smem;                                  // [BR, Ws]
    float* ts = xs + BR * Ws;                          // [tile, N]
    int* fs = reinterpret_cast<int*>(ts + tile_trees * N);  // [tile, N]
    float* ls = reinterpret_cast<float*>(fs + tile_trees * N);  // [tile, L]

    const long long row0 = static_cast<long long>(blockIdx.x) * BR;
    const int nrows = static_cast<int>(min(static_cast<long long>(BR), rows - row0));
    for (int i = threadIdx.x; i < nrows * W; i += BR)
        xs[(i / W) * Ws + i % W] = x[row0 * W + i];

    const int r = threadIdx.x;
    const float* xr = xs + r * Ws;
    double acc = 0.0;
    for (int t0 = 0; t0 < T; t0 += tile_trees) {
        const int nt = min(tile_trees, T - t0);
        __syncthreads();  // previous tile fully read
        for (int i = threadIdx.x; i < nt * N; i += BR) {
            ts[i] = thr[static_cast<long long>(t0) * N + i];
            fs[i] = fid[static_cast<long long>(t0) * N + i];
        }
        for (int i = threadIdx.x; i < nt * L; i += BR)
            ls[i] = leaf[static_cast<long long>(t0) * L + i];
        __syncthreads();
        if (r >= nrows) continue;
        for (int tt = 0; tt < nt; tt += kTreesInFlight) {
            int j[kTreesInFlight];
            int base[kTreesInFlight];
#pragma unroll
            for (int k = 0; k < kTreesInFlight; ++k) {
                j[k] = 0;
                base[k] = min(tt + k, nt - 1) * N;  // tail slots repeat a tree
            }
            for (int d = 0; d < D; ++d) {
                const int off = (1 << d) - 1;
#pragma unroll
                for (int k = 0; k < kTreesInFlight; ++k) {
                    const int n = base[k] + off + j[k];
                    j[k] += tahoe_node_cond<F>(xr, fs[n], ts[n]) << d;
                }
            }
#pragma unroll
            for (int k = 0; k < kTreesInFlight; ++k)
                if (tt + k < nt) acc += static_cast<double>(ls[(tt + k) * L + j[k]]);
        }
    }
    if (r < nrows) out[row0 + r] = static_cast<float>(acc);
}

using FoldFn = void (*)(const float*, int, int, const float*, const int*,
                       const float*, int, int, int, float*);

int launch_fold(FoldFn kernel, const float* x, int rows, int W, const float* thr,
                const int* fid, const float* leaf, int T, int D,
                int rows_per_block, int tile_trees, int smem_bytes, float* out,
                cudaStream_t stream) {
    if (rows == 0) return 0;
    cudaError_t err = tahoe_grant_smem(kernel, static_cast<size_t>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (rows + rows_per_block - 1) / rows_per_block;
    kernel<<<grid, rows_per_block, smem_bytes, stream>>>(
        x, rows, W, thr, fid, leaf, T, D, tile_trees, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

TAHOE_EXPORT int tahoe_fold(const float* x2, int rows, int W, const float* thr,
                            const int* fid, const float* leaf, int T, int D,
                            int rows_per_block, int tile_trees, int smem_bytes,
                            float* out, cudaStream_t stream) {
    return launch_fold(fold_kernel, x2, rows, W, thr, fid, leaf, T, D,
                       rows_per_block, tile_trees, smem_bytes, out, stream);
}

TAHOE_EXPORT int tahoe_fold_sign(const float* x, int rows, int W, const float* thr,
                                 const int* fid, const float* leaf, int T, int D,
                                 int rows_per_block, int tile_trees, int smem_bytes,
                                 float* out, cudaStream_t stream) {
    return launch_fold(fold_form_kernel<kSign>, x, rows, W, thr, fid, leaf, T, D,
                       rows_per_block, tile_trees, smem_bytes, out, stream);
}

TAHOE_EXPORT int tahoe_fold_nonge(const float* x, int rows, int W, const float* thr,
                                  const int* fid, const float* leaf, int T, int D,
                                  int rows_per_block, int tile_trees, int smem_bytes,
                                  float* out, cudaStream_t stream) {
    return launch_fold(fold_form_kernel<kNonGe>, x, rows, W, thr, fid, leaf, T, D,
                       rows_per_block, tile_trees, smem_bytes, out, stream);
}
