// Kernel B: rank traversal, int8 planes -> f32 margins, over 4-byte node
// records.
//
// Replaces the Pallas kernels tahoe_tpu/ops/rank_kernel.py
// _make_split_kernel (:231; launched by _split_row_outer :481 and the
// stream-once branch of rank_fold_margins :429-473) and the whole-level
// _make_kernel (:112; launched by _nonsplit_margins :575). Both compute, per
// row, the sum over trees of the leaf that the node conditions
//     cond(node) = planes[row, :] . R_d[:, node] >= 0     (int32 sum)
// select (compiler.rank_normalize). In the levelize/rank_normalize layout
// node j of level d has its children at j (cond False) and j + 2^d (cond
// True) of level d + 1, so a walk from the root visits D nodes a tree.
//
// The column collapses to four nonzeros. rank_normalize writes 127 and 1 at
// the lanes ``lane`` and ``lane + 30`` of the node's feature segment (qh/ql
// in the pos form, -qh/-ql in the neg form) and (c127, c1) at lanes 120 and
// 121, where every row's planes carry 127 and 1; a pass-through node holds
// only c1 = -1. So, exactly,
//     planes . column = 127 * p[lane] + p[lane + 30] + k,  k = 127*c127 + c1
// and each node is one int32 record (ops/rank_kernel.py rank_records):
//     record = (k << 12) | lane,   lane = r & 0xFFF,  k = r >> 12 (arithmetic)
// A pass-through node has k = -1 and lane = 128*G, which points at zeros
// staged past the row: its diff is -1, and nothing is read out of bounds.
//
// One thread owns one row. The block stages its rows in shared memory at an
// odd word stride (as sparse_rank.cu), so the threads of a warp reading
// their own rows at unrelated lanes spread over the banks. At one plane
// group the staging precomputes, per lane, the int16 pair value
//     v[lane] = 127 * p[lane] + p[lane + 30]
// so a visit is one 4-byte __ldg of its record, one shared-memory read and
// diff = v[lane] + k; at two or more groups the block stages the bytes
// themselves and a visit reads p[lane] and p[lane + 30], since v takes twice
// the bytes' shared memory and halves the rows a block holds (on the H100,
// the pair staging ran faster at one group and slower at two and sixteen).
// The walk j += (diff >= 0) << d runs as a node index n += (1 + cond) << d
// from the root.
//
// What bounds it on the H100 (the walk probes, probes.cu; PERF.md): per
// visited node a dependent 4-byte load (SUSY-class: 0.51 MB of records) and
// the shared-memory read behind it, then a few integer operations. At
// 65,536 SUSY-class rows (two blocks, 16 warps an SM) mostly the record
// loads' throughput: the same walk with every load of a group issued at
// once takes 0.91-0.98x the time, the record loads alone 0.65-0.72x (the
// probes' path words, which this kernel does not read, taken out or left
// in); at 16,384 rows (8 warps an SM) the dependence costs a third. The design reads no column (SUSY-class: 0.51 MB
// of records against 16.3 MB of int8 columns) and keeps kRankTrees = 8
// independent chains a thread (no warp shuffle serialises them; 8 ran faster
// than 4 or 16). Leaf values are summed in double in tree order and rounded
// once to f32, so the margins are the same on every run and bit-identical to
// the fused kernel's (rank_fused.cu), which sums in the same order.
#include "common.cuh"

namespace {

// The block, the row staging and the per-visit body are common.cuh's
// (tahoe_rank_*), shared with the probes that take this walk apart.
template <bool kPairs>
__global__ void rank_fold_kernel(const int8_t* __restrict__ planes, int rows,
                                 int G, const int* __restrict__ records, int T,
                                 int D, const float* __restrict__ leaf,
                                 float* __restrict__ out) {
    extern __shared__ int smem_words[];
    const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x;
    const int nrows = static_cast<int>(min(static_cast<long long>(blockDim.x),
                                           rows - row0));
    tahoe_rank_stage<kPairs>(smem_words, planes, row0, nrows, G);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) >= nrows) return;

    const int* own = smem_words + threadIdx.x * tahoe_rank_row_words(G, kPairs);
    const int N = (1 << D) - 1;  // nodes per tree; node n = 2^d - 1 + j
    double acc = 0.0;
    for (int t0 = 0; t0 < T; t0 += kRankTrees) {
        const int* rec[kRankTrees];
        int n[kRankTrees];
#pragma unroll
        for (int k = 0; k < kRankTrees; ++k) {
            // tail slots repeat the last tree and are not summed
            rec[k] = records + static_cast<long long>(min(t0 + k, T - 1)) * N;
            n[k] = 0;
        }
        for (int d = 0; d < D; ++d) {
#pragma unroll
            for (int k = 0; k < kRankTrees; ++k) {
                const int diff = tahoe_rank_record_diff<kPairs>(own, __ldg(rec[k] + n[k]));
                n[k] += (diff >= 0 ? 2 : 1) << d;
            }
        }
#pragma unroll
        for (int k = 0; k < kRankTrees; ++k)
            if (t0 + k < T)
                acc += static_cast<double>(
                    leaf[static_cast<long long>(t0 + k) * (N + 1) + n[k] - N]);
    }
    out[row0 + threadIdx.x] = static_cast<float>(acc);
}

template <bool kPairs>
cudaError_t launch(const int8_t* planes, int rows, int G, const int* records,
                   int T, int D, const float* leaf, float* out,
                   cudaStream_t stream) {
    const int block = tahoe_rank_block_rows(G, kPairs);
    const size_t smem = static_cast<size_t>(block) * 4 * tahoe_rank_row_words(G, kPairs);
    cudaError_t err = tahoe_grant_smem(rank_fold_kernel<kPairs>, smem);
    if (err != cudaSuccess) return err;
    const long long grid = (static_cast<long long>(rows) + block - 1) / block;
    rank_fold_kernel<kPairs><<<static_cast<unsigned>(grid), block, smem, stream>>>(
        planes, rows, G, records, T, D, leaf, out);
    return cudaGetLastError();
}

}  // namespace

TAHOE_EXPORT int tahoe_rank_fold(const int8_t* planes, int rows, int G,
                                 const int* records, int T, int D,
                                 const float* leaf, float* out,
                                 cudaStream_t stream) {
    if (rows == 0) return 0;
    if (G < 1 || G > kRankMaxGroups || T < 1 || D < 0 || D > 30)
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        G <= kRankMaxPairGroups
            ? launch<true>(planes, rows, G, records, T, D, leaf, out, stream)
            : launch<false>(planes, rows, G, records, T, D, leaf, out, stream));
}

// Kernel B's launch shape at G plane groups as this build sizes it: rows a
// block and staged words a row (ops/rank_kernel.py rank_block_rows and
// rank_row_words reckon the default build's; tests/test_torch_cuda.py holds
// them to this).
TAHOE_EXPORT void tahoe_rank_launch_shape(int G, int* block_rows, int* row_words) {
    const bool pairs = G <= kRankMaxPairGroups;
    *block_rows = tahoe_rank_block_rows(G, pairs);
    *row_words = tahoe_rank_row_words(G, pairs);
}

// Registers a thread of kernel B with its int16 pair staging or its bytes.
TAHOE_EXPORT int tahoe_rank_fold_registers(int pairs, int* regs) {
    return pairs ? tahoe_kernel_registers(rank_fold_kernel<true>, regs)
                 : tahoe_kernel_registers(rank_fold_kernel<false>, regs);
}
