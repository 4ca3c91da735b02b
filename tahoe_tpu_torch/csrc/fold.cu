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
// descends, one thread a row, each thread kTrees trees together. What bounds
// it on the H100 (PERF.md section 6, scripts/kernel_ab.py c): the issue of
// its per-level instructions and the latency of its dependent shared loads,
// and, where one block fills an SM, the staging of its rows; not the bank
// conflicts of its gathers (ops/fold_kernel.py fold_wavefronts counts them).
// So:
// - a tree's nodes are the deep kernel's 16-byte blocks of two levels (three
//   thresholds and one word of three 10-bit codes, ops/fold_kernel.py
//   deep_blocks): one ld.shared.v4 per two levels, where two 4-byte loads a
//   level were; the next block follows by arithmetic, the last path is the
//   leaf index. A one-level root group is peeled off, so that no branch
//   separates the trees' steps; where one block fills an SM, a __syncwarp()
//   after each group's block loads keeps ptxas from sinking them one by one
//   to their first use;
// - the block's rows are staged at an odd stride (conflict-free while a
//   warp reads one feature) by cp.async, every copy of a thread issued
//   before it waits: the whole block's rows are in flight at once;
// - tiles of whole trees (ops/fold_kernel.py fold_c_table: each tree's
//   blocks, then its leaves, so a tile is one contiguous span) arrive by one
//   bulk copy (TMA, counted on an mbarrier) each, into a ring of two buffers:
//   tile t + 1 arrives while tile t descends. A forest that fits one tile
//   takes one buffer and one copy, issued before the rows are staged;
// - a tile with fewer trees than the slots in flight descends only its own
//   trees (groups of kTrees / 2, ..., 1 after the full ones).
// Leaf values are summed in double in tree order, one pass, no atomics: the
// margins are the same on every run, round once to f32, and equal those of
// the earlier kernel C, which read two words a node, bit for bit.
//
// The build macros below change the trees in flight and the load batching
// for scripts/kernel_ab.py c, which times such builds beside the shipped one
// and an earlier source. The layouts that lost to these (feature-major rows,
// (threshold, code) words a node, a staging loop in place of the ring) are
// measured in PERF.md section 6.
#include <climits>

#include "common.cuh"

// trees in flight per thread
#ifndef TAHOE_FOLD_TREES
#define TAHOE_FOLD_TREES 8
#endif
// A __syncwarp() after each group's block loads makes ptxas issue the
// kTrees loads together instead of each beside its first use: faster where
// one block fills an SM (8 warps to hide the loads' latency), slower where
// two share it (PERF.md section 6). 1: so, by the launch's shared memory;
// 0: never; 2: always
#ifndef TAHOE_FOLD_BATCH
#define TAHOE_FOLD_BATCH 1
#endif

namespace {

constexpr int kTrees = TAHOE_FOLD_TREES;
constexpr int kBatchMode = TAHOE_FOLD_BATCH;
constexpr int kBarrierBytes = 16;  // two mbarriers (C_BARRIER_BYTES)
// the runtime's shared memory per resident block (config.GpuLimits
// SMEM_RESERVED_PER_BLOCK)
constexpr int kReservedSmemPerBlock = 1024;

// One tree's 4-byte words in the table (ops/fold_kernel.py fold_c_table):
// its blocks, then its leaves padded to a multiple of 4.
__host__ __device__ __forceinline__ int node_words(int D) {
    return 4 * tahoe_block_count(D);
}

__host__ __device__ __forceinline__ int tree_words(int D) {
    return node_words(D) + ((1 << D) > 4 ? 1 << D : 4);
}

// Bytes of the tile buffers, one if a tile holds every tree, else two; the
// rows at an odd stride and the mbarriers follow them (ops/fold_kernel.py
// fold_smem_bytes).
__host__ __device__ __forceinline__ long long buffer_bytes(int T, int D, int tile) {
    return (tile >= T ? 1LL : 2LL) * tile * tree_words(D) * 4;
}

__host__ __device__ __forceinline__ long long row_bytes(int BR, int W) {
    return static_cast<long long>(BR) * (W | 1) * 4;
}

// Field n of a block's code word (common.cuh tahoe_block_code): only the
// sign form's codes are negative, so the others need no sign extension.
template <int Form>
static __device__ __forceinline__ int block_field(int word, int n) {
    if constexpr (Form == kSign) return tahoe_block_code(word, n);
    else return (word >> (kCodeBits * n)) & ((1 << kCodeBits) - 1);
}

// The node's branch condition on this thread's row ``xr`` (common.cuh
// tahoe_node_test); the sign form negates by the code's sign bit, as -v
// does, NaN included.
template <int Form>
static __device__ __forceinline__ int node_cond(const float* xr, int code, float t) {
    if constexpr (Form == kSign) {
        const float v = xr[code ^ (code >> 31)];
        return __int_as_float(__float_as_int(v) ^ (code & INT_MIN)) >= t;
    } else {
        return tahoe_node_test<Form>(xr[tahoe_node_feature<Form>(code)], code, t);
    }
}

// Trees tt .. tt + K - 1 of a staged tile (tw words a tree, its leaves nw
// words in), their leaves added to acc in tree order.
template <int Form, bool Batch, int K>
static __device__ __forceinline__ void descend(const int* tile, int tw, int nw,
                                               int tt, int D, const float* xr,
                                               double& acc) {
    int j[K];
    const int4* tb[K];  // each tree's blocks
#pragma unroll
    for (int k = 0; k < K; ++k) {
        j[k] = 0;
        tb[k] = reinterpret_cast<const int4*>(tile + (tt + k) * tw);
    }
    int off = 0;  // the group's first block
    int d = 0;    // the group's first level
    if (D & 1) {  // a root group of one level: its block's top node only
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int4 b = tb[k][0];
            j[k] = node_cond<Form>(xr, block_field<Form>(b.w, 0), __int_as_float(b.x));
        }
        off = d = 1;
    }
    // groups of two levels, with no branch between the trees' steps
    for (; d < D; off += 1 << d, d += 2) {
        int4 b[K];
#pragma unroll
        for (int k = 0; k < K; ++k) b[k] = tb[k][off + j[k]];
        if constexpr (Batch) __syncwarp();
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const bool c0 = node_cond<Form>(xr, block_field<Form>(b[k].w, 0),
                                            __int_as_float(b[k].x));
            const int thr = c0 ? b[k].z : b[k].y;
            const int word = c0 ? b[k].w >> kCodeBits : b[k].w;
            const bool c1 = node_cond<Form>(xr, block_field<Form>(word, 1),
                                            __int_as_float(thr));
            j[k] += (c0 ? 1 << d : 0) + (c1 ? 2 << d : 0);
        }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
        acc += static_cast<double>(__int_as_float(tile[(tt + k) * tw + nw + j[k]]));
}

// The trees tt .. nt - 1 of a tile, fewer than 2K: K at a time, then K / 2,
// ..., 1, so that no tree descends twice.
template <int Form, bool Batch, int K>
static __device__ __forceinline__ void descend_rest(const int* tile, int tw, int nw,
                                                    int tt, int nt, int D,
                                                    const float* xr, double& acc) {
    if (nt - tt >= K) {
        descend<Form, Batch, K>(tile, tw, nw, tt, D, xr, acc);
        tt += K;
    }
    if constexpr (K > 1)
        descend_rest<Form, Batch, K / 2>(tile, tw, nw, tt, nt, D, xr, acc);
}

// Every tree of a tile of nt: kTrees at a time, then the rest.
template <int Form, bool Batch>
static __device__ __forceinline__ void descend_tile(const int* tile, int tw, int nw,
                                                    int nt, int D, const float* xr,
                                                    double& acc) {
    int tt = 0;
    for (; tt + kTrees <= nt; tt += kTrees)
        descend<Form, Batch, kTrees>(tile, tw, nw, tt, D, xr, acc);
    descend_rest<Form, Batch, kTrees / 2>(tile, tw, nw, tt, nt, D, xr, acc);
}

// Tile t of the table into a buffer, by one bulk copy (thread 0).
static __device__ __forceinline__ void issue_tile(int* dst, const int* table, int tw,
                                                  int t, int tile_trees, int T,
                                                  uint64_t* bar) {
    const int nt = min(tile_trees, T - t * tile_trees);
    const uint32_t bytes = static_cast<uint32_t>(nt) * tw * 4;
    tahoe_mbar_expect_tx(bar, bytes);
    tahoe_bulk_copy(dst, table + static_cast<long long>(t) * tile_trees * tw, bytes,
                    bar);
}

template <int Form, bool Batch>
__global__ void __launch_bounds__(256)
fold_kernel(const float* __restrict__ x, int rows, int W,
            const int* __restrict__ table, int T, int D, int tile_trees,
            float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int BR = blockDim.x;
    const int nw = node_words(D);
    const int tw = tree_words(D);
    const int nbuf = tile_trees >= T ? 1 : 2;
    const int ntiles = (T + tile_trees - 1) / tile_trees;
    int* bufs = reinterpret_cast<int*>(smem);  // [nbuf][tile_trees * tw]
    float* xs = reinterpret_cast<float*>(smem + buffer_bytes(T, D, tile_trees));
    uint64_t* full = reinterpret_cast<uint64_t*>(
        reinterpret_cast<unsigned char*>(xs) + row_bytes(BR, W));

    const long long row0 = static_cast<long long>(blockIdx.x) * BR;
    const int nrows = static_cast<int>(min(static_cast<long long>(BR), rows - row0));
    const int tid = threadIdx.x;
    if (tid == 0) {  // the first tiles start while the rows are staged
        for (int s = 0; s < nbuf; ++s) tahoe_mbar_init(&full[s], 1);
        tahoe_mbar_init_fence();
        for (int s = 0; s < nbuf && s < ntiles; ++s)
            issue_tile(bufs + s * tile_trees * tw, table, tw, s, tile_trees, T,
                       &full[s]);
    }
    {
        // Element i of the block's rows goes to row i / W, column i % W, at
        // an odd stride (conflict-free same-lane reads); each thread walks
        // its elements with no division and issues every copy before it
        // waits, so the whole block's rows are in flight at once.
        const int Ws = W | 1;
        const int dr = BR / W;
        const int dc = BR - dr * W;
        int r = tid / W;
        int c = tid - r * W;
        const float* src = x + row0 * W + tid;
        for (int i = tid; i < nrows * W; i += BR) {
            tahoe_cp_async4(xs + r * Ws + c, src);
            src += BR;
            r += dr;
            c += dc;
            if (c >= W) {
                c -= W;
                ++r;
            }
        }
        tahoe_cp_async_wait_all();
    }
    __syncthreads();  // rows staged, mbarriers initialised

    // threads past the last row walk its row too, so that whole warps
    // descend (the __syncwarp above), and write nothing
    const float* xr = xs + min(tid, nrows - 1) * (W | 1);
    double acc = 0.0;
    for (int t = 0; t < ntiles; ++t) {
        const int nt = min(tile_trees, T - t * tile_trees);
        const int s = t & (nbuf - 1);
        int* tile = bufs + s * tile_trees * tw;
        tahoe_mbar_wait(&full[s], (t / nbuf) & 1);
        descend_tile<Form, Batch>(tile, tw, nw, nt, D, xr, acc);
        if (t + nbuf < ntiles) {
            __syncthreads();  // every thread done with buffer s
            if (tid == 0) issue_tile(tile, table, tw, t + nbuf, tile_trees, T, &full[s]);
        }
    }
    if (tid < nrows) out[row0 + tid] = static_cast<float>(acc);
}

template <int Form>
int launch_fold(const float* x, int rows, int W, const int* table, int T, int D,
                int rows_per_block, int tile_trees, int smem_bytes, float* out,
                cudaStream_t stream) {
    if (rows == 0) return 0;
    // whole warps and the sizes fold_launch gave
    if (T < 0 || D < 0 || D > 15 || W < 1 || rows_per_block < 32 ||
        rows_per_block > 256 || rows_per_block % 32 || tile_trees < 1 ||
        reinterpret_cast<uintptr_t>(table) % 16 ||
        smem_bytes < buffer_bytes(T, D, tile_trees) + row_bytes(rows_per_block, W) +
                         kBarrierBytes)
        return static_cast<int>(cudaErrorInvalidValue);
    bool batch = kBatchMode == 2;
    if (kBatchMode == 1) {  // one block an SM: more than half its shared memory
        int dev = 0, per_sm = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
        if (err != cudaSuccess) return static_cast<int>(err);
        batch = 2 * (smem_bytes + kReservedSmemPerBlock) > per_sm;
    }
    auto* kernel = batch ? fold_kernel<Form, true> : fold_kernel<Form, false>;
    cudaError_t err = tahoe_grant_smem(kernel, static_cast<size_t>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (rows + rows_per_block - 1) / rows_per_block;
    kernel<<<grid, rows_per_block, smem_bytes, stream>>>(x, rows, W, table, T, D,
                                                         tile_trees, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

TAHOE_EXPORT int tahoe_fold(const float* x2, int rows, int W, const int* table,
                            int T, int D, int rows_per_block, int tile_trees,
                            int smem_bytes, float* out, cudaStream_t stream) {
    return launch_fold<kDual>(x2, rows, W, table, T, D, rows_per_block, tile_trees,
                              smem_bytes, out, stream);
}

TAHOE_EXPORT int tahoe_fold_sign(const float* x, int rows, int W, const int* table,
                                 int T, int D, int rows_per_block, int tile_trees,
                                 int smem_bytes, float* out, cudaStream_t stream) {
    return launch_fold<kSign>(x, rows, W, table, T, D, rows_per_block, tile_trees,
                              smem_bytes, out, stream);
}

TAHOE_EXPORT int tahoe_fold_nonge(const float* x, int rows, int W, const int* table,
                                  int T, int D, int rows_per_block, int tile_trees,
                                  int smem_bytes, float* out, cudaStream_t stream) {
    return launch_fold<kNonGe>(x, rows, W, table, T, D, rows_per_block, tile_trees,
                               smem_bytes, out, stream);
}

// Registers a thread of the instance of kernel C for ``form`` (0 dual, 1
// sign, 2 non-ge) with or without its batched block loads.
TAHOE_EXPORT int tahoe_fold_registers(int form, int batch, int* regs) {
    if (form == kDual)
        return batch ? tahoe_kernel_registers(fold_kernel<kDual, true>, regs)
                     : tahoe_kernel_registers(fold_kernel<kDual, false>, regs);
    if (form == kSign)
        return batch ? tahoe_kernel_registers(fold_kernel<kSign, true>, regs)
                     : tahoe_kernel_registers(fold_kernel<kSign, false>, regs);
    if (form == kNonGe)
        return batch ? tahoe_kernel_registers(fold_kernel<kNonGe, true>, regs)
                     : tahoe_kernel_registers(fold_kernel<kNonGe, false>, regs);
    return static_cast<int>(cudaErrorInvalidValue);
}
