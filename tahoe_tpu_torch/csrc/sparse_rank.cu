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
// the nodes it visits. A node's rank column has four nonzeros
// (compiler.rank_normalize), so its record keeps them in closed form:
//     diff = 127 * p[lane] + p[lane + 30] + k
// with p the row's plane bytes; the constant lanes 120 and 121 carry 127 and
// 1, and k = 127 * c127 + c1 is their part of the dot product.
//
// Records are int4 {lane, k, child, value bits}: a leaf has child < 0 and its
// f32 value in .w. The pool (16 bytes a node; 2.6 MB for 200 trees of depth
// 18) stays in the 50 MB L2, and each visit is one 16-byte load through the
// read-only cache. What bounds it on the H100: the chain of dependent loads
// per (row, tree), up to depth 18, and the trees' uneven depths, which idle
// the lanes of a warp whose trees ended early. Four trees descend together
// (kTreesInFlight) to overlap their load chains. The block stages its rows'
// planes in shared memory at a stride of 32*G + 1 words, so that the threads
// of a warp reading the same byte of their rows hit 32 different banks.
// Leaves are summed in double in tree order, no atomics: the margins are the
// same on every run and round once to f32.
#include "common.cuh"

namespace {

constexpr int kMaxGroups = 16;  // compiler.RANK_MAX_GROUPS
constexpr int kLaneQl = 30;     // compiler.RANK_LANE_QL - RANK_LANE_QH

__global__ void sparse_rank_kernel(const int8_t* __restrict__ planes, int rows,
                                   int G, const int4* __restrict__ records,
                                   const int* __restrict__ roots, int T,
                                   int max_depth, float* __restrict__ out) {
    extern __shared__ int smem_words[];
    const int words = 32 * G;         // int32 words of one row's planes
    const int stride = words + 1;     // its shared-memory stride, in words
    const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x;
    const int nrows = static_cast<int>(min(static_cast<long long>(blockDim.x),
                                           rows - row0));
    const int* src = reinterpret_cast<const int*>(planes) + row0 * words;
    for (int i = threadIdx.x; i < nrows * words; i += blockDim.x)
        smem_words[(i / words) * stride + i % words] = src[i];
    __syncthreads();
    if (static_cast<int>(threadIdx.x) >= nrows) return;

    const int8_t* p = reinterpret_cast<const int8_t*>(smem_words + threadIdx.x * stride);
    double acc = 0.0;
    for (int t0 = 0; t0 < T; t0 += kTreesInFlight) {
        int idx[kTreesInFlight];
        float leaf[kTreesInFlight];
#pragma unroll
        for (int k = 0; k < kTreesInFlight; ++k) {
            idx[k] = t0 + k < T ? __ldg(roots + t0 + k) : -1;
            leaf[k] = __int_as_float(0x7fc00000);  // NaN until a leaf is read
        }
        // a tree of depth D takes D moves and one leaf read
        for (int s = 0; s <= max_depth; ++s) {
            bool more = false;
#pragma unroll
            for (int k = 0; k < kTreesInFlight; ++k) {
                if (idx[k] < 0) continue;
                const int4 r = __ldg(records + idx[k]);
                if (r.z < 0) {
                    leaf[k] = __int_as_float(r.w);
                    idx[k] = -1;
                } else {
                    const int diff = 127 * p[r.x] + p[r.x + kLaneQl] + r.y;
                    idx[k] = r.z + (diff >= 0);
                    more = true;
                }
            }
            if (!more) break;
        }
#pragma unroll
        for (int k = 0; k < kTreesInFlight; ++k)
            if (t0 + k < T) acc += static_cast<double>(leaf[k]);
    }
    out[row0 + threadIdx.x] = static_cast<float>(acc);
}

}  // namespace

TAHOE_EXPORT int tahoe_sparse_rank(const int8_t* planes, int rows, int G,
                                   const int* records, const int* roots, int T,
                                   int max_depth, float* out,
                                   cudaStream_t stream) {
    if (rows == 0) return 0;
    if (G < 1 || G > kMaxGroups || T < 1 || max_depth < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    // 128 rows a block while they fit 48 KB (G <= 2: 33 KB), else fewer,
    // down to one warp (G = 16: 32 rows in 66 KB)
    const int row_bytes = 4 * (32 * G + 1);
    const int block = max(32, min(128, (48 * 1024 / row_bytes) & ~31));
    const size_t smem = static_cast<size_t>(block) * row_bytes;
    cudaError_t err = tahoe_set_smem(sparse_rank_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long grid = (static_cast<long long>(rows) + block - 1) / block;
    sparse_rank_kernel<<<static_cast<unsigned>(grid), block, smem, stream>>>(
        planes, rows, G, reinterpret_cast<const int4*>(records), roots, T,
        max_depth, out);
    return static_cast<int>(cudaGetLastError());
}
