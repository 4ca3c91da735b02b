// Kernel A: rank transform, f32 rows -> int8 rank planes.
//
// Replaces the Pallas kernels tahoe_tpu/ops/rank_transform.py
// _make_kernel_v2 (:428, with rank_counts_from_x :274 and the plane assembly
// _assemble_planes :41 / _assemble_group :251) and its flat sibling
// _make_kernel (:78). Both compute, per (row, virtual feature f),
//     q = #{u in U_f : u <= x}
// and write the base-127 plane lanes of compiler.rank_normalize: qh, ql, -qh,
// -ql at lanes i, 30+i, 60+i, 90+i of the feature's group (q = 127*qh + ql,
// i = f % 30), -128 in all four for a missing (NaN) value, 127 and 1 at
// lanes 120 and 121, 0 elsewhere.
//
// On the TPU the bucketed count ran as one-hot digit matmuls because Mosaic
// has no vector gather. Here each row of the [F, K] table ``thr`` is sorted
// (+inf past count[f], which bounds the rank, so an x of +inf does not count
// the padding) and the rank is a two-level search: plain float compares give
// the reference's rank (-0.0 == +0.0, denormals kept: no fast-math).
//
// What bounds it on the H100: the bytes are 4*F of x and 128*G of planes a
// row (0.0041 ms at SUSY-class, 65,536 rows); a plain binary search per (row,
// feature) instead waits on ~13 dependent loads into a table (~0.5 MB) that
// lives in L2, not L1. This design makes two dependent reads a search, and
// is then bound by its L2 traffic: each block's copy of the coarse index
// (one 32-byte sector an entry) plus one 64-byte window a (row, feature).
// The window width W = 16 is the one that minimises the two together at
// SUSY-class (blocks x F x K / W sectors against rows x F x 4W bytes).
// - One block an SM owns one plane group and a run of 256-row tiles. It
//   stages once, in shared memory, a coarse index of the group's features,
//   every S-th threshold (S = W; SUSY-class: 18 x 454 floats, padded to 512
//   with NaN, 37 KB), doubling S only where the index would pass 64 KB (the
//   widest band: S = 32, 30 x 512, 61 KB); a window then takes one more
//   dependent device read per doubling.
// - A warp's 32 lanes are 32 rows of one feature, so the search starts on
//   shared addresses. Each lane searches the coarse index branch-free in
//   shared memory; then the warp counts u <= x in the lanes' windows, 4 lanes
//   a 64-byte window with one 16-byte load each, and adds the counts by
//   shuffles. A window is aligned because the launcher takes only K % 16 == 0
//   and a 16-byte-aligned table: rank_transform.threshold_table pads K so, and
//   the wrapper pads a table built another way.
// - The tile's x is staged feature-major in shared memory, its loads issued
//   before the previous tile's search; the planes are assembled in shared
//   memory at an odd word stride and written with coalesced 16-byte stores.
// The search itself (tahoe_rank_search, common.cuh) is the fused kernel's
// (rank_fused.cu) too.
#include "common.cuh"

namespace {

constexpr int kBlock = 1024;                // one block an SM
constexpr int kTileRows = 256;              // a power of two: a warp's pairs share a feature
constexpr int kSlotWords = 33;              // a row's 128 plane bytes + a word: odd stride
constexpr int kXStride = kTileRows + 1;     // staged x, feature-major: odd stride
constexpr int kXRegs = (kRankGroupCols * kTileRows + kBlock - 1) / kBlock;

// Tile ``tile``'s x, [Fg, kTileRows] feature-major: loaded into registers
// (load_x), then written to shared memory (store_x), so the loads of the
// next tile overlap the current tile's search.
__device__ __forceinline__ void load_x(float (&xr)[kXRegs], const float* __restrict__ x,
                                       int rows, int F, int f0, int Fg, int tile) {
    const long long row0 = static_cast<long long>(tile) * kTileRows;
    const int n = static_cast<int>(min(static_cast<long long>(kTileRows), rows - row0)) * Fg;
#pragma unroll
    for (int k = 0; k < kXRegs; ++k) {
        const int idx = threadIdx.x + k * kBlock;
        const int r = idx / max(Fg, 1);
        xr[k] = idx < n ? __ldg(x + (row0 + r) * F + f0 + idx - r * Fg) : 0.0f;
    }
}

__device__ __forceinline__ void store_x(float* xs, const float (&xr)[kXRegs], int Fg) {
#pragma unroll
    for (int k = 0; k < kXRegs; ++k) {
        const int idx = threadIdx.x + k * kBlock;
        const int r = idx / max(Fg, 1);
        if (idx < kTileRows * Fg) xs[(idx - r * Fg) * kXStride + r] = xr[k];
    }
}

__global__ void __launch_bounds__(kBlock, 1)
rank_planes_kernel(const float* __restrict__ x, int rows, int F, int G,
                   const float* __restrict__ thr, int K,
                   const int* __restrict__ counts, RankCoarse rc,
                   int8_t* __restrict__ out) {
    extern __shared__ int smem_words[];
    int* slots = smem_words;  // kTileRows rows of kSlotWords words
    float* xs = reinterpret_cast<float*>(slots + kTileRows * kSlotWords);
    const int lane = threadIdx.x & 31;
    const int g = blockIdx.y;
    const int f0 = g * kRankGroupCols;
    const int Fg = max(0, min(kRankGroupCols, F - f0));
    float* coarse = xs + Fg * kXStride;  // [Fg, rc.Mp]
    const int tiles = (rows + kTileRows - 1) / kTileRows;
    float xr[kXRegs];
    if (blockIdx.x < tiles) load_x(xr, x, rows, F, f0, Fg, blockIdx.x);

    tahoe_rank_stage_coarse(coarse, thr, f0, Fg, K, rc);
    // lanes no feature writes stay 0; lanes 120 and 121 hold 127 and 1
    for (int w = threadIdx.x; w < kTileRows * kSlotWords; w += blockDim.x)
        slots[w] = w % kSlotWords == 30 ? 0x017F : 0;
    store_x(xs, xr, Fg);
    __syncthreads();

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long row0 = static_cast<long long>(tile) * kTileRows;
        const int nrows = static_cast<int>(min(static_cast<long long>(kTileRows),
                                               rows - row0));
        const bool more = tile + gridDim.x < tiles;
        if (more) load_x(xr, x, rows, F, f0, Fg, tile + gridDim.x);
        // pair (i, r): feature f0 + i of row row0 + r; a warp's 32 pairs are
        // 32 rows of one feature, so the loop runs warp-uniform
        for (int pr = threadIdx.x; pr < Fg * kTileRows; pr += blockDim.x) {
            const int i = pr / kTileRows;
            const int r = pr % kTileRows;
            const int f = f0 + i;
            const float v = r < nrows ? xs[i * kXStride + r] : CUDART_NAN_F;
            const int q = tahoe_rank_search(v, coarse + i * rc.Mp, rc,
                                            thr + static_cast<long long>(f) * K, K,
                                            __ldg(counts + f), lane);
            if (r >= nrows) continue;
            int8_t qh = -128, ql = -128, nqh = -128, nql = -128;  // missing
            if (q >= 0) {
                const int h = q / kRankBase;
                const int l = q - kRankBase * h;
                qh = static_cast<int8_t>(h);
                ql = static_cast<int8_t>(l);
                nqh = static_cast<int8_t>(-h);
                nql = static_cast<int8_t>(-l);
            }
            int8_t* o = reinterpret_cast<int8_t*>(slots + r * kSlotWords);
            o[i] = qh;
            o[kRankGroupCols + i] = ql;
            o[2 * kRankGroupCols + i] = nqh;
            o[3 * kRankGroupCols + i] = nql;
        }
        __syncthreads();
        // write the tile's planes, 16 bytes a store, and stage the next x
        int8_t* dst = out + row0 * 128 * G + 128 * g;
        for (int c = threadIdx.x; c < nrows * 8; c += blockDim.x) {
            const int* w = slots + (c >> 3) * kSlotWords + 4 * (c & 7);
            reinterpret_cast<int4*>(dst + static_cast<long long>(c >> 3) * 128 * G)[c & 7] =
                make_int4(w[0], w[1], w[2], w[3]);
        }
        if (more) store_x(xs, xr, Fg);
        __syncthreads();
    }
}

constexpr int kMaxDevices = 64;

cudaError_t launch(const float* x, int rows, int F, int G, const float* thr,
                   int K, const int* counts, int8_t* out, cudaStream_t stream) {
    const int Fg = min(kRankGroupCols, F);
    const RankCoarse rc = tahoe_rank_coarse(K, Fg);
    const size_t smem = (kTileRows * kSlotWords + static_cast<size_t>(Fg) * kXStride +
                         static_cast<size_t>(Fg) * rc.Mp) * 4;
    // the shared-memory grant (common.cuh) and the SM count, once a device:
    // no attribute call inside a CUDA graph capture
    static int sm_count[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if ((err = tahoe_grant_smem(rank_planes_kernel, smem)) != cudaSuccess) return err;
    if (sm_count[dev] == 0 &&
        (err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    const int sms = sm_count[dev];
    // one wave of one block an SM, spread over the groups; each block stages
    // its group's index once
    const int tiles = (rows + kTileRows - 1) / kTileRows;
    const int per_group = max(1, min(tiles, sms / G));
    const dim3 grid(per_group, G);
    rank_planes_kernel<<<grid, kBlock, smem, stream>>>(
        x, rows, F, G, thr, K, counts, rc, out);
    return cudaGetLastError();
}

}  // namespace

TAHOE_EXPORT int tahoe_rank_planes(const float* x, int rows, int F, int G,
                                   const float* thr, int K, const int* counts,
                                   int8_t* out, cudaStream_t stream) {
    if (rows == 0) return 0;
    // F = 0 (a forest of leaves) gives one group of constant lanes; every
    // window is an aligned 64 bytes
    if (F < 0 || K < kRankWindow || K % kRankWindow ||
        G != max(1, (F + kRankGroupCols - 1) / kRankGroupCols) || G > 16 ||
        reinterpret_cast<uintptr_t>(thr) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch(x, rows, F, G, thr, K, counts, out, stream));
}
