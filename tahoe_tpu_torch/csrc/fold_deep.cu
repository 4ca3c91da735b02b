// Deep kernel: f32 fold of the forests that kernel C's shared-memory tiles
// serve badly (from depth 12, whose trees a tile restages too often, and
// every forest past depth 14, one of whose trees no block holds), in the
// dual, sign and non-ge forms, one entry point each.
//
// Replaces the Pallas kernel tahoe_tpu/ops/fold_kernel.py _make_split_kernel
// (:688, launched from fold_margins' split branch :829-865). It computes the
// same margins as kernel C (csrc/fold.cu) from the same blocks and leaves,
// laid out in another order (below), with the node compare of common.cuh:
//   tahoe_fold_deep        dual, rows as [x, -x]
//   tahoe_fold_deep_sign   sign, rows at width F
//   tahoe_fold_deep_nonge  non-ge (fold_kernel.py:551-586), rows at width F;
//                          the non-ge form of DEPTH_BUCKETED's fold buckets
// The TPU kernel's subtree-group grid, roots scratch and compile walls exist
// for VMEM and Mosaic compile time; none is carried over.
//
// One depth-15 tree's tables are 393 KB, more than a block's 227 KB, so the
// nodes cannot be staged; a descent visits only D nodes per (row, tree).
// Depth costs table bytes, not work, so a forest is bounded by its bytes
// only (ops/fold_kernel.py fold_table_bytes, 2 GiB). deep15-class (9 MB of
// blocks and leaves) stays in the 50 MB L2; rf_deep16- and rf_deep18-class
// hold 0.14 and 0.9 GB of tables, past it, though the descents of trained
// trees read few of their lower blocks (8 MB of sectors at rf_deep18-class
// and 65,536 rows, PERF.md). Every index
// past a tree's offset fits an int to D = 30: a block's is below 2^D / 1.5
// and a leaf's below 2^D. What bounds it on the H100 is its node
// loads: rows of a warp sit on different nodes below the top levels, so each
// warp-wide load of a level costs the L1 one request per thread, and where
// wide rows leave few threads an SM (cup98-class: 192 rows), the chain's
// latency. So a node costs less than one load: the nodes are read as
// 16-byte blocks of two levels (ops/fold_kernel.py deep_blocks), three
// threshold words and one word of three 10-bit codes, one load a block.
// The deep kernel reads its own copy of the blocks and leaves, in heap order
// (ops/fold_kernel.py heap_tables): within a group, block q's successors
// are 4q + u of the next group (u = c0 << 1 | c1, the two branch bits, the
// upper one first; 2q + c0 after a root group of one level), so no pointer
// is stored, and the last group's path is the leaf index in the same order.
// A block's four successors, and the leaves of one last-group block, lie
// side by side: rows of a warp that share a long prefix and split late read
// neighbouring blocks, most in one 32-byte sector or 128-byte line, where
// the order of deep_blocks (kernel C's, the root's branch the lowest bit)
// set them 2^d blocks apart. At odd D the root group takes one level. The
// block's rows are staged in shared memory at an odd stride by kernel C's
// staging (common.cuh tahoe_stage_rows): it reads the caller's raw rows
// where they lie (ops/graphed.py's in-place route), applying the column
// map, the row stride, the missing test and the dual lanes as it stages,
// every cp.async of a thread issued before it waits, so that no pass of
// its own copies, gathers or negates the rows first; rows already
// canonicalized take the same path with nothing to do after the copies.
// Each thread descends kTrees trees together, their block loads issued
// before any is used. One thread owns a row (fold_deep_kernel), or, where
// the rows' shared memory leaves fewer than 256 rows a block, two threads
// share it (fold_deep_pair_kernel), each descending half of every group of
// trees: twice the descents in flight. Leaf values are summed in double in
// tree order, one pass, no atomics, and round once to f32. Built without
// fast-math or flush-to-zero: denormal thresholds and NaN routing stay
// exact. The two kernels keep their own walks: written over one shared
// template or helper, the one-thread kernel compiled to a slower schedule,
// 1.67x slower on cup98-class (PERF.md). Only their staging, before the
// walk, is one body (scripts/kernel_ab.py deep times both kernels on every
// shape against an earlier source on staged rows).
#include "common.cuh"

namespace {

// Measured (PERF.md); scripts/kernel_ab.py rebuilds this file alone with
// other values to measure them again.
#ifndef TAHOE_DEEP_TREES
#define TAHOE_DEEP_TREES 8
#endif
constexpr int kTrees = TAHOE_DEEP_TREES;  // trees in flight per thread

// One thread a row.
template <int Form>
__global__ void fold_deep_kernel(const float* __restrict__ x, long long ld,
                                 const int* __restrict__ cols, int F,
                                 float missing, int rows, int W,
                                 const int4* __restrict__ blocks,
                                 long long per_tree,
                                 const float* __restrict__ leaf, int T, int D,
                                 float* __restrict__ out) {
    extern __shared__ float xs[];  // [BR, W | 1]
    const int BR = blockDim.x;
    const int Ws = W | 1;
    const long long L = 1LL << D;

    const long long row0 = static_cast<long long>(blockIdx.x) * BR;
    const int nrows = static_cast<int>(min(static_cast<long long>(BR), rows - row0));
    tahoe_stage_rows<Form>(xs, W, x + row0 * ld, ld, cols, F, missing, nrows,
                           threadIdx.x, BR);
    __syncthreads();

    const int r = threadIdx.x;
    if (r >= nrows) return;
    const float* xr = xs + r * Ws;
    const int groups = (D + 1) / 2;
    double acc = 0.0;
    for (int t0 = 0; t0 < T; t0 += kTrees) {
        const int4* tb[kTrees];
        int j[kTrees];  // the path's branch bits so far, root first: heap order
#pragma unroll
        for (int k = 0; k < kTrees; ++k) {
            // tail slots repeat the last tree and are not summed
            tb[k] = blocks + static_cast<long long>(min(t0 + k, T - 1)) * per_tree;
            j[k] = 0;
        }
        long long off = 0;  // the first block of the group
        int d = 0;          // the group's first level
        for (int g = 0; g < groups; ++g) {
            const bool one = g == 0 && (D & 1);  // a root group of one level
            int4 b[kTrees];
#pragma unroll
            for (int k = 0; k < kTrees; ++k) b[k] = __ldg(tb[k] + off + j[k]);
#pragma unroll
            for (int k = 0; k < kTrees; ++k) {
                const int c0 = tahoe_node_cond<Form>(xr, tahoe_block_code(b[k].w, 0),
                                                     __int_as_float(b[k].x));
                int q = j[k] << 1 | c0;
                if (!one) {
                    const int thr = c0 ? b[k].z : b[k].y;
                    const int code = tahoe_block_code(b[k].w, 1 + c0);
                    q = q << 1 | tahoe_node_cond<Form>(xr, code, __int_as_float(thr));
                }
                j[k] = q;
            }
            off += 1LL << d;
            d += one ? 1 : 2;
        }
#pragma unroll
        for (int k = 0; k < kTrees; ++k)
            if (t0 + k < T) acc += static_cast<double>(__ldg(leaf + (t0 + k) * L + j[k]));
    }
    out[row0 + r] = static_cast<float>(acc);
}

// Two threads a row, neighbours in a warp: of every 2 * kTrees trees, lane
// h descends the kTrees from t0 + h * kTrees, as fold_deep_kernel does; the
// leaves are summed in tree order through shuffles. Past the last row both
// walk it too, so that every lane of the warp takes part.
template <int Form>
__global__ void fold_deep_pair_kernel(const float* __restrict__ x, long long ld,
                                      const int* __restrict__ cols, int F,
                                      float missing, int rows, int W,
                                      const int4* __restrict__ blocks,
                                      long long per_tree,
                                      const float* __restrict__ leaf, int T,
                                      int D, float* __restrict__ out) {
    extern __shared__ float xs[];  // [BR, W | 1]
    const int BR = blockDim.x / 2;
    const int Ws = W | 1;
    const long long L = 1LL << D;

    const long long row0 = static_cast<long long>(blockIdx.x) * BR;
    const int nrows = static_cast<int>(min(static_cast<long long>(BR), rows - row0));
    // all 2 * BR threads stage the block's BR rows
    tahoe_stage_rows<Form>(xs, W, x + row0 * ld, ld, cols, F, missing, nrows,
                           threadIdx.x, blockDim.x);
    __syncthreads();

    const int r = threadIdx.x / 2;
    const int h = threadIdx.x % 2;
    const float* xr = xs + min(r, nrows - 1) * Ws;
    const int groups = (D + 1) / 2;
    double acc = 0.0;
    for (int t0 = 0; t0 < T; t0 += 2 * kTrees) {
        const int own = t0 + h * kTrees;  // this lane's first tree
        const int4* tb[kTrees];
        int j[kTrees];
#pragma unroll
        for (int k = 0; k < kTrees; ++k) {
            tb[k] = blocks + static_cast<long long>(min(own + k, T - 1)) * per_tree;
            j[k] = 0;
        }
        long long off = 0;
        int d = 0;
        for (int g = 0; g < groups; ++g) {
            const bool one = g == 0 && (D & 1);
            int4 b[kTrees];
#pragma unroll
            for (int k = 0; k < kTrees; ++k) b[k] = __ldg(tb[k] + off + j[k]);
#pragma unroll
            for (int k = 0; k < kTrees; ++k) {
                const int c0 = tahoe_node_cond<Form>(xr, tahoe_block_code(b[k].w, 0),
                                                     __int_as_float(b[k].x));
                int q = j[k] << 1 | c0;
                if (!one) {
                    const int thr = c0 ? b[k].z : b[k].y;
                    const int code = tahoe_block_code(b[k].w, 1 + c0);
                    q = q << 1 | tahoe_node_cond<Form>(xr, code, __int_as_float(thr));
                }
                j[k] = q;
            }
            off += 1LL << d;
            d += one ? 1 : 2;
        }
        float v[kTrees];
#pragma unroll
        for (int k = 0; k < kTrees; ++k)
            v[k] = own + k < T ? __ldg(leaf + (own + k) * L + j[k]) : 0.0f;
        // in tree order: lane 0's trees, then lane 1's
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
            for (int k = 0; k < kTrees; ++k) {
                const float u = __shfl_sync(0xffffffffu, v[k], (threadIdx.x & 30) + s);
                if (t0 + s * kTrees + k < T) acc += static_cast<double>(u);
            }
        }
    }
    if (r < nrows && h == 0) out[row0 + r] = static_cast<float>(acc);
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel* kernel, int threads_per_row, const float* x,
                          long long ld, const int* cols, int F, float missing,
                          int rows, int W, const int* blocks, const float* leaf,
                          int T, int D, int rows_per_block, int smem_bytes,
                          float* out, cudaStream_t stream) {
    cudaError_t err = tahoe_grant_smem(kernel, static_cast<size_t>(smem_bytes));
    if (err != cudaSuccess) return err;
    const int grid = (rows + rows_per_block - 1) / rows_per_block;
    kernel<<<grid, rows_per_block * threads_per_row, smem_bytes, stream>>>(
        x, ld, cols, F, missing, rows, W, reinterpret_cast<const int4*>(blocks),
        tahoe_block_count(D), leaf, T, D, out);
    return cudaGetLastError();
}

template <int Form>
int launch_deep(const float* x, long long ld, const int* cols, int F,
                float missing, int rows, int W, const int* blocks,
                const float* leaf, int T, int D, int rows_per_block, int lanes,
                int smem_bytes, float* out, cudaStream_t stream) {
    if (rows == 0) return 0;
    // the rows, F columns of them (half the dual lanes where the staging
    // makes the other half); whole warps stage them, and two lanes a row
    // shuffle across whole warps
    if (x == nullptr || ld < 0 || F < 1 ||
        !(F == W || (Form == kDual && 2 * F == W)) || T < 1 || D < 0 ||
        D > 30 || rows_per_block < 1 || (lanes != 1 && lanes != 2) ||
        (rows_per_block * lanes) % 32 || smem_bytes < rows_per_block * (W | 1) * 4 ||
        reinterpret_cast<uintptr_t>(blocks) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        lanes == 1 ? launch_kernel(fold_deep_kernel<Form>, 1, x, ld, cols, F, missing,
                                   rows, W, blocks, leaf, T, D, rows_per_block,
                                   smem_bytes, out, stream)
                   : launch_kernel(fold_deep_pair_kernel<Form>, 2, x, ld, cols, F,
                                   missing, rows, W, blocks, leaf, T, D,
                                   rows_per_block, smem_bytes, out, stream));
}

}  // namespace

// Each form's launcher, with kernel C's row arguments (fold.cu): the rows
// ``x``, rows ``ld`` floats apart, F columns read of each, column c at
// cols[c] (int32; null: at c); ``missing`` the finite sentinel whose values
// are missing, or NaN for none to test. The dual form takes its [x, -x]
// rows at width W = 2F, or their first half (F = W / 2), whose negated
// lanes the staging writes. Then the heap-ordered blocks and leaves
// (ops/fold_kernel.py heap_tables), T trees of depth D, and the block.
#define TAHOE_FOLD_DEEP_EXPORT(name, form)                                          \
    TAHOE_EXPORT int name(const float* x, long long ld, const int* cols, int F,     \
                          float missing, int rows, int W, const int* blocks,        \
                          const float* leaf, int T, int D, int rows_per_block,      \
                          int lanes, int smem_bytes, float* out,                    \
                          cudaStream_t stream) {                                    \
        return launch_deep<form>(x, ld, cols, F, missing, rows, W, blocks, leaf,    \
                                 T, D, rows_per_block, lanes, smem_bytes, out,      \
                                 stream);                                           \
    }

TAHOE_FOLD_DEEP_EXPORT(tahoe_fold_deep, kDual)
TAHOE_FOLD_DEEP_EXPORT(tahoe_fold_deep_sign, kSign)
TAHOE_FOLD_DEEP_EXPORT(tahoe_fold_deep_nonge, kNonGe)

// Registers a thread of the deep kernel for ``form`` (0 dual, 1 sign, 2
// non-ge) at ``lanes`` threads a row.
TAHOE_EXPORT int tahoe_fold_deep_registers(int form, int lanes, int* regs) {
    if (lanes != 1 && lanes != 2) return static_cast<int>(cudaErrorInvalidValue);
    if (form == kDual)
        return lanes == 1 ? tahoe_kernel_registers(fold_deep_kernel<kDual>, regs)
                          : tahoe_kernel_registers(fold_deep_pair_kernel<kDual>, regs);
    if (form == kSign)
        return lanes == 1 ? tahoe_kernel_registers(fold_deep_kernel<kSign>, regs)
                          : tahoe_kernel_registers(fold_deep_pair_kernel<kSign>, regs);
    if (form == kNonGe)
        return lanes == 1 ? tahoe_kernel_registers(fold_deep_kernel<kNonGe>, regs)
                          : tahoe_kernel_registers(fold_deep_pair_kernel<kNonGe>, regs);
    return static_cast<int>(cudaErrorInvalidValue);
}
