// Shared helpers of the port's CUDA kernels (compiled for sm_90a, loaded
// through ctypes: every exported launcher has C linkage and returns the
// CUDA error code of its launch, 0 on success).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define TAHOE_EXPORT extern "C" __attribute__((visibility("default")))

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
static inline cudaError_t tahoe_set_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// The f32 folds (fold.cu, fold_deep.cu) descend this many trees together to
// overlap their load chains (ops/fold_kernel.py TREES_IN_FLIGHT).
constexpr int kTreesInFlight = 4;

// The fold's node forms (ops/fold_kernel.py module docstring).
enum NodeForm { kDual, kSign, kNonGe };
constexpr int kNonGeSelLt = 1 << 29;  // ops/fold_kernel.py NONGE_SEL_LT
constexpr int kNonGeFlip = 1 << 30;   // NONGE_FLIP
constexpr int kNonGeFid = kNonGeSelLt - 1;

// The branch condition of one node of a row ``xr`` in the form's encoding:
//   dual   x2[code] >= t                            (rows as [x, -x] lanes)
//   sign   (code < 0 ? -x[~code] : x[code]) >= t    (rows at width F)
//   non-ge (sel_lt ? x[f] < t : x[f] >= t) XOR flip
// A NaN on either side compares False, and -NaN stays NaN.
template <int Form>
static __device__ __forceinline__ bool tahoe_node_cond(const float* xr, int code,
                                                       float t) {
    if constexpr (Form == kDual) {
        return xr[code] >= t;
    } else if constexpr (Form == kSign) {
        const float v = xr[code < 0 ? ~code : code];
        return (code < 0 ? -v : v) >= t;
    } else {
        const float v = xr[code & kNonGeFid];
        const bool c = (code & kNonGeSelLt) ? (v < t) : (v >= t);
        return c != ((code & kNonGeFlip) != 0);
    }
}

// Sum of one int over the 32 lanes of a warp; every lane gets the total.
static __device__ __forceinline__ int tahoe_warp_sum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// The rank planes' layout per 30-feature group of 128 lanes
// (compiler.rank_normalize): [0,30) qh | [30,60) ql | [60,90) -qh |
// [90,120) -ql | 120: 127 | 121: 1 | 122-127: 0.
constexpr int kRankGroupCols = 30;  // compiler.RANK_GROUP_COLS
constexpr int kRankBase = 127;      // compiler.RANK_BASE

// Kernel A's per-lane work, which kernel A (rank_transform.cu) and the
// fused kernel (rank_fused.cu) both run. Lane ``i`` of the warp given
// to one (row, group): a lane i < 30 ranks feature f = 30*g + i of the row
// ``xr`` (F features) among its count[f] sorted thresholds (row f of the
// [F, K] table ``thr``) by binary search, q = #{u <= v}, and writes the
// group's plane bytes i, 30+i, 60+i, 90+i of ``o`` (qh, ql, -qh, -ql with
// q = 127*qh + ql; -128 in all four for a missing (NaN) value; 0 past the
// last feature). Lane 30 writes the constant lanes 120-127. Plain float
// compares give the reference's rank (-0.0 == +0.0, denormals kept: no
// fast-math).
static __device__ __forceinline__ void tahoe_rank_lanes(
        const float* __restrict__ xr, int F, int g, const float* __restrict__ thr,
        int K, const int* __restrict__ counts, int8_t* o, int i) {
    if (i < kRankGroupCols) {
        const int f = g * kRankGroupCols + i;
        int8_t qh = 0, ql = 0, nqh = 0, nql = 0;
        if (f < F) {
            const float v = xr[f];
            if (v != v) {  // missing: -128 in all four segments
                qh = ql = nqh = nql = -128;
            } else {
                const float* u = thr + static_cast<long long>(f) * K;
                int lo = 0, hi = counts[f];
                while (lo < hi) {  // first index with u > v
                    const int mid = (lo + hi) >> 1;
                    if (u[mid] <= v) lo = mid + 1; else hi = mid;
                }
                const int h = lo / kRankBase;
                const int l = lo - kRankBase * h;
                qh = static_cast<int8_t>(h);
                ql = static_cast<int8_t>(l);
                nqh = static_cast<int8_t>(-h);
                nql = static_cast<int8_t>(-l);
            }
        }
        o[i] = qh;
        o[kRankGroupCols + i] = ql;
        o[2 * kRankGroupCols + i] = nqh;
        o[3 * kRankGroupCols + i] = nql;
    } else if (i == kRankGroupCols) {  // lanes 120..127: 127, 1, then zeros
        o[120] = 127;
        o[121] = 1;
#pragma unroll
        for (int k = 122; k < 128; ++k) o[k] = 0;
    }
}
