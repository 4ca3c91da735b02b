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
