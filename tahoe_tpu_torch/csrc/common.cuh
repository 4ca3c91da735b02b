// Shared helpers of the port's CUDA kernels (compiled for sm_90a, loaded
// through ctypes: every exported launcher has C linkage and returns the
// CUDA error code of its launch, 0 on success).
#pragma once

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#define TAHOE_EXPORT extern "C" __attribute__((visibility("default")))

// Opt a kernel into more than 48 KB of dynamic shared memory, once per
// (kernel, device) and size: a launch whose size was granted before makes no
// attribute call, so the launchers can be captured in a CUDA graph. The table
// is keyed by the kernel's address, never by its type, since one launcher
// may serve several kernels of one signature (fold.cu's three forms). A
// larger grant covers every smaller size.
static inline cudaError_t tahoe_grant_smem_fn(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    struct Grant { const void* kernel; int device; size_t bytes; };
    constexpr int kMaxGrants = 64;
    static Grant grants[kMaxGrants];
    static int used = 0;
    static std::mutex lock;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> hold(lock);
    Grant* g = nullptr;
    for (int i = 0; i < used && g == nullptr; ++i)
        if (grants[i].kernel == kernel && grants[i].device == dev) g = &grants[i];
    if (g != nullptr && g->bytes >= bytes) return cudaSuccess;
    if (g == nullptr) {
        if (used == kMaxGrants) return cudaErrorInvalidValue;
        g = &grants[used++];
        *g = Grant{kernel, dev, 0};
    }
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err == cudaSuccess) g->bytes = bytes;
    return err;
}

template <typename Kernel>
static inline cudaError_t tahoe_grant_smem(Kernel* kernel, size_t bytes) {
    return tahoe_grant_smem_fn(reinterpret_cast<const void*>(kernel), bytes);
}

// The fused kernel (rank_fused.cu) and the probes (probes.cu) descend this
// many trees together to overlap their load chains.
constexpr int kTreesInFlight = 4;

// The fold's node forms (ops/fold_kernel.py module docstring), as the
// kernels read them from a block's 10-bit code field (ops/fold_kernel.py
// block_codes): the dual and sign forms' codes as they are, the non-ge
// form's feature in bits 0-6, sel_lt in bit 7 and flip in bit 8.
enum NodeForm { kDual, kSign, kNonGe };
constexpr int kCodeBits = 10;                 // ops/fold_kernel.py DEEP_CODE_BITS
constexpr int kBlockNonGeSelLt = 1 << 7;      // BLOCK_NONGE_SEL_LT
constexpr int kBlockNonGeFlip = 1 << 8;       // BLOCK_NONGE_FLIP
constexpr int kBlockNonGeFid = kBlockNonGeSelLt - 1;

// Node n (0: the block's top, 1 and 2: its cond-False and cond-True
// children) of a block's code word, sign-extended.
static __device__ __forceinline__ int tahoe_block_code(int word, int n) {
    return (word << (32 - kCodeBits * (n + 1))) >> (32 - kCodeBits);
}

// Blocks of one tree of depth D (ops/fold_kernel.py deep_block_count): a
// group of two levels from level d has 2^d of them; at odd D the root group
// is one level.
static __host__ __device__ __forceinline__ int tahoe_block_count(int D) {
    int total = 0;
    for (int d = D & 1 ? -1 : 0; d < D; d += 2) total += 1 << (d < 0 ? 0 : d);
    return total;
}

// The row feature (or [x, -x] lane) a node code reads.
template <int Form>
static __device__ __forceinline__ int tahoe_node_feature(int code) {
    if constexpr (Form == kDual) return code;
    else if constexpr (Form == kSign) return code < 0 ? ~code : code;
    else return code & kBlockNonGeFid;
}

// The branch condition of a node on the value ``v`` of its feature:
//   dual   v >= t                                   (rows as [x, -x] lanes)
//   sign   (code < 0 ? -v : v) >= t                 (rows at width F)
//   non-ge (sel_lt ? v < t : v >= t) XOR flip
// A NaN on either side compares False, and -NaN stays NaN.
template <int Form>
static __device__ __forceinline__ bool tahoe_node_test(float v, int code, float t) {
    if constexpr (Form == kDual) {
        return v >= t;
    } else if constexpr (Form == kSign) {
        return (code < 0 ? -v : v) >= t;
    } else {
        const bool c = (code & kBlockNonGeSelLt) ? (v < t) : (v >= t);
        return c != ((code & kBlockNonGeFlip) != 0);
    }
}

// The branch condition of one node of a row ``xr`` staged row-major.
template <int Form>
static __device__ __forceinline__ bool tahoe_node_cond(const float* xr, int code,
                                                       float t) {
    return tahoe_node_test<Form>(xr[tahoe_node_feature<Form>(code)], code, t);
}

// Hopper's bulk copies (TMA without a tensor map) into shared memory, their
// completion counted on an mbarrier; every address and size a multiple of
// 16 bytes.
static __device__ __forceinline__ uint32_t tahoe_smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void tahoe_mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(tahoe_smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised mbarriers visible to the async proxy; a
// __syncthreads() then makes them visible to the block.
static __device__ __forceinline__ void tahoe_mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects ``bytes`` of bulk copies in this phase.
static __device__ __forceinline__ void tahoe_mbar_expect_tx(uint64_t* bar,
                                                            uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(tahoe_smem_addr(bar)), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void tahoe_bulk_copy(void* dst, const void* src,
                                                       uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(tahoe_smem_addr(dst)), "l"(src), "r"(bytes),
           "r"(tahoe_smem_addr(bar)) : "memory");
}

// A 4-byte copy from global to shared memory that no register waits on
// (Ampere's cp.async): a thread issues all of its copies, then waits once.
static __device__ __forceinline__ void tahoe_cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(tahoe_smem_addr(dst)), "l"(src) : "memory");
}

// Waits for all of this thread's cp.async copies.
static __device__ __forceinline__ void tahoe_cp_async_wait_all() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// Waits until the phase of ``bar`` with this parity has completed. A copy
// that never lands traps after ~2^26 tries (seconds), so that a fault ends
// the launch with an error instead of hanging the card.
static __device__ __forceinline__ void tahoe_mbar_wait(uint64_t* bar, int parity) {
    uint32_t done = 0;
    for (uint32_t tries = 0; !done; ++tries) {
        if (tries == (1u << 26)) __trap();
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(tahoe_smem_addr(bar)), "r"(parity) : "memory");
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
