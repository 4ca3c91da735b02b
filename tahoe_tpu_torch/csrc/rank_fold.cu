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
// What bounds it on the H100: per visited node, a dependent 4-byte load
// (SUSY-class: 0.51 MB of records, L1/L2-resident; a block's trees in
// flight touch a few KB) and the shared-memory read behind it, then a few
// integer operations; the chain is D deep per tree, and a row is one thread,
// so 65,536 rows give ~16 warps an SM to hide it. The design reads no
// column (SUSY-class: 0.51 MB of records against 16.3 MB of int8 columns)
// and keeps kTrees = 8 independent chains a thread (no warp shuffle
// serialises them; 8 ran faster than 4 or 16). Leaf values are summed in
// double in tree order and rounded once to f32, so the margins are the same
// on every run and bit-identical to the fused kernel's (rank_fused.cu),
// which sums in the same order.
#include "common.cuh"

namespace {

constexpr int kMaxGroups = 16;         // compiler.RANK_MAX_GROUPS
constexpr int kLaneQl = 30;            // compiler.RANK_LANE_QL - RANK_LANE_QH
// Both choices were measured (PERF.md); scripts/kernel_ab.py rebuilds this
// file alone with other values to measure them again.
#ifndef TAHOE_RANK_TREES
#define TAHOE_RANK_TREES 8
#endif
#ifndef TAHOE_RANK_PAIR_GROUPS
#define TAHOE_RANK_PAIR_GROUPS 1
#endif
constexpr int kTrees = TAHOE_RANK_TREES;              // trees in flight per thread
constexpr int kMaxPairGroups = TAHOE_RANK_PAIR_GROUPS;  // stage v up to this many groups
constexpr int kMaxRows = 256;          // rows a block, at most
constexpr int kSmemTarget = 96 * 1024; // rows a block while they fit this

// Shared-memory words of one staged row: v as int16 over lanes [0, 128G]
// (v[128G] = 0), or the bytes with 32 zero bytes past lane 128G; both odd.
__host__ __device__ constexpr int row_words(int G, bool pairs) {
    return pairs ? 64 * G + 1 : 32 * G + 9;
}

template <bool kPairs>
__global__ void rank_fold_kernel(const int8_t* __restrict__ planes, int rows,
                                 int G, const int* __restrict__ records, int T,
                                 int D, const float* __restrict__ leaf,
                                 float* __restrict__ out) {
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
        for (int i = threadIdx.x; i < nrows * stride; i += blockDim.x) {
            const int r = i / stride;
            const int w = i - r * stride;
            smem_words[i] = w < words ? src[r * words + w] : 0;
        }
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) >= nrows) return;

    const int* own = smem_words + threadIdx.x * stride;
    const short* v = reinterpret_cast<const short*>(own);
    const int8_t* p = reinterpret_cast<const int8_t*>(own);
    const int N = (1 << D) - 1;  // nodes per tree; node n = 2^d - 1 + j
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
                const int lane = r & 0xFFF;
                int diff;
                if constexpr (kPairs) {
                    diff = v[lane] + (r >> 12);
                } else {
                    diff = 127 * p[lane] + p[lane + kLaneQl] + (r >> 12);
                }
                n[k] += (diff >= 0 ? 2 : 1) << d;
            }
        }
#pragma unroll
        for (int k = 0; k < kTrees; ++k)
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
    const int row_bytes = 4 * row_words(G, kPairs);
    const int block = max(32, min(kMaxRows, (kSmemTarget / row_bytes) & ~31));
    const size_t smem = static_cast<size_t>(block) * row_bytes;
    cudaError_t err = tahoe_set_smem(rank_fold_kernel<kPairs>, smem);
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
    if (G < 1 || G > kMaxGroups || T < 1 || D < 0 || D > 30)
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        G <= kMaxPairGroups
            ? launch<true>(planes, rows, G, records, T, D, leaf, out, stream)
            : launch<false>(planes, rows, G, records, T, D, leaf, out, stream));
}
