// Shared helpers of the port's CUDA kernels (compiled for sm_90a, loaded
// through ctypes: every exported launcher has C linkage and returns the
// CUDA error code of its launch, 0 on success).
#pragma once

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>
#include <math_constants.h>

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

// A kernel's registers a thread as the runtime reports them
// (cudaFuncGetAttributes). perf_model/model.py keeps them as constants to
// count the blocks an SM holds; chip_smoke.py holds those to these.
template <typename Kernel>
static inline int tahoe_kernel_registers(Kernel* kernel, int* regs) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err == cudaSuccess) *regs = a.numRegs;
    return static_cast<int>(err);
}

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

// The rank planes' layout per 30-feature group of 128 lanes
// (compiler.rank_normalize): [0,30) qh | [30,60) ql | [60,90) -qh |
// [90,120) -ql | 120: 127 | 121: 1 | 122-127: 0.
constexpr int kRankGroupCols = 30;  // compiler.RANK_GROUP_COLS
constexpr int kRankBase = 127;      // compiler.RANK_BASE

// The rank search that kernel A (rank_transform.cu) and the fused kernel
// (rank_fused.cu) share: q = #{u <= v} of a value v among the count[f]
// sorted thresholds u of one row of an [F, K] table (+inf past count[f]),
// in two dependent reads. A coarse index of every S-th threshold, staged in
// shared memory (padded with NaN to Mp, a power of two), is searched
// branch-free; then one aligned window of kRankWindow thresholds is counted
// in device memory. Plain float compares give the reference's rank (-0.0 ==
// +0.0, denormals kept: no fast-math). The tables are K % kRankWindow == 0
// and 16-byte aligned, so that every window is an aligned 64 bytes
// (ops/rank_transform.py TABLE_ALIGN).
constexpr int kRankWindow = 16;                // thresholds counted in device memory
constexpr int kRankCoarseBytes = 64 * 1024;    // coarse index budget a block
constexpr unsigned kFullMask = 0xffffffffu;

// The coarse index of Fg features of a K-threshold table: stride S (the
// window, doubled while the index padded to a power of two would pass
// kRankCoarseBytes), M entries a feature, padded to Mp.
struct RankCoarse { int S, M, Mp; };

static inline RankCoarse tahoe_rank_coarse(int K, int Fg) {
    RankCoarse c{kRankWindow, 0, 1};
    for (;; c.S *= 2) {
        c.M = (K + c.S - 1) / c.S;
        for (c.Mp = 1; c.Mp < c.M; c.Mp *= 2) {}
        if (static_cast<long long>(Fg) * c.Mp * 4 <= kRankCoarseBytes) return c;
    }
}

// The coarse index [Fg, Mp] of the features f0.. f0 + Fg - 1, staged by the
// block's threads in turn: c[m] = u[S*m], NaN from M on (NaN compares false
// for every v, +inf included).
static __device__ __forceinline__ void tahoe_rank_stage_coarse(
        float* coarse, const float* __restrict__ thr, int f0, int Fg, int K,
        RankCoarse c) {
#pragma unroll 4
    for (int i = threadIdx.x; i < Fg * c.Mp; i += blockDim.x) {
        const int f = i / c.Mp;
        const int m = i - f * c.Mp;
        coarse[i] = m < c.M ? __ldg(thr + static_cast<long long>(f0 + f) * K +
                                    static_cast<long long>(m) * c.S)
                            : CUDART_NAN_F;
    }
}

// The window b of a sorted row ``u`` of K floats, W = kRankWindow, with
// u[W*b] <= v < u[W*(b+1)] (or W*(b+1) past the row), found with the coarse
// index ``c`` of the row; -1 when v < u[0] (or v is NaN).
static __device__ __forceinline__ int tahoe_rank_window(
        float v, const float* __restrict__ c, RankCoarse rc,
        const float* __restrict__ u, int K) {
    int lo = 0;  // #{m : c[m] <= v}, branch-free
    for (int step = rc.Mp >> 1; step > 0; step >>= 1)
        lo += c[lo + step - 1] <= v ? step : 0;
    lo += c[lo] <= v;  // the last entry of a run of Mp
    if (lo == 0) return -1;
    const int per = rc.S / kRankWindow;
    int b = (lo - 1) * per;
    int e = min(lo * per, (K + kRankWindow - 1) / kRankWindow);
    while (e - b > 1) {  // only when S > kRankWindow
        const int mid = (b + e) >> 1;
        if (__ldg(u + mid * kRankWindow) <= v) b = mid; else e = mid;
    }
    return b;
}

// #{j < 16 : u[16b + j] <= v} for each lane's (v, b), b >= 0; every lane of
// the warp on the same row u. The warp reads eight lanes' 64-byte windows an
// instruction, four lanes a window with one 16-byte load each, all four
// loads a lane issued before any is used; each lane packs its four counts in
// bytes, and the four lanes of a window add them up by shuffles.
static __device__ __forceinline__ int tahoe_rank_count(
        float v, int b, const float* __restrict__ u, int lane) {
    constexpr int kRounds = 4;  // 32 lanes' windows, 8 a round
    float4 q[kRounds];
    float vj[kRounds];
#pragma unroll
    for (int j = 0; j < kRounds; ++j) {
        const int src = 8 * j + (lane >> 2);
        const int bj = __shfl_sync(kFullMask, b, src);
        vj[j] = __shfl_sync(kFullMask, v, src);
        q[j] = bj >= 0
            ? __ldg(reinterpret_cast<const float4*>(u + bj * kRankWindow + 4 * (lane & 3)))
            : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
    }
    unsigned n = 0;  // byte j: this lane's count for the window of lane 8j + g
#pragma unroll
    for (int j = 0; j < kRounds; ++j)
        n += ((q[j].x <= vj[j]) + (q[j].y <= vj[j]) + (q[j].z <= vj[j]) +
              (q[j].w <= vj[j])) << (8 * j);
    n += __shfl_xor_sync(kFullMask, n, 1);  // over the 4 lanes of a window
    n += __shfl_xor_sync(kFullMask, n, 2);
    // lane 8j + g takes byte j from the lanes 4g..4g+3
    return (__shfl_sync(kFullMask, n, 4 * (lane & 7)) >> (8 * (lane >> 3))) & 0xFF;
}

// The rank q of each lane's value v (NaN: -1, missing) among the count
// thresholds of the row ``u`` of the table, with its coarse index ``c``.
// Warp-uniform: every lane of the warp calls it on the same feature.
static __device__ __forceinline__ int tahoe_rank_search(
        float v, const float* __restrict__ c, RankCoarse rc,
        const float* __restrict__ u, int K, int count, int lane) {
    const int b = v == v ? tahoe_rank_window(v, c, rc, u, K) : -1;
    const int n = tahoe_rank_count(v, b, u, lane);
    if (v != v) return -1;
    return b < 0 ? 0 : min(b * kRankWindow + n, count);
}

// Kernel B's walk (rank_fold.cu): its block, its row staging and its
// per-visit body, shared with the probes that take the walk apart
// (probes.cu), so that a probe cannot drift from the kernel it measures.
// Both choices were measured (PERF.md); scripts/kernel_ab.py rebuilds
// rank_fold.cu alone with other values to measure them again.
#ifndef TAHOE_RANK_TREES
#define TAHOE_RANK_TREES 8
#endif
#ifndef TAHOE_RANK_PAIR_GROUPS
#define TAHOE_RANK_PAIR_GROUPS 1
#endif
constexpr int kRankMaxGroups = 16;             // compiler.RANK_MAX_GROUPS
constexpr int kRankLaneQl = 30;                // compiler.RANK_LANE_QL - RANK_LANE_QH
constexpr int kRankTrees = TAHOE_RANK_TREES;   // trees in flight a thread
constexpr int kRankMaxPairGroups = TAHOE_RANK_PAIR_GROUPS;  // stage v up to this many groups
constexpr int kRankMaxRows = 256;              // rows a block, at most
constexpr int kRankSmemTarget = 96 * 1024;     // rows a block while they fit this

// Shared-memory words of one staged row: v as int16 over lanes [0, 128G]
// (v[128G] = 0), or the bytes with 32 zero bytes past lane 128G; both odd.
static __host__ __device__ __forceinline__ constexpr int tahoe_rank_row_words(
        int G, bool pairs) {
    return pairs ? 64 * G + 1 : 32 * G + 9;
}

// Rows (and threads) of one block: as many whole warps as fit
// kRankSmemTarget, at most kRankMaxRows.
static inline int tahoe_rank_block_rows(int G, bool pairs) {
    const int row_bytes = 4 * tahoe_rank_row_words(G, pairs);
    return max(32, min(kRankMaxRows, (kRankSmemTarget / row_bytes) & ~31));
}

// The block's ``nrows`` rows from row0 into shared memory at an odd word
// stride. kPairs: word w of a row holds v[2w] | v[2w + 1] << 16, with
// v[lane] = 127 * p[lane] + p[lane + 30] and p past the row 0; else the
// plane words, then 9 zero words.
template <bool kPairs>
static __device__ __forceinline__ void tahoe_rank_stage(
        int* smem_words, const int8_t* __restrict__ planes, long long row0,
        int nrows, int G) {
    const int lanes = 128 * G;
    const int stride = tahoe_rank_row_words(G, kPairs);
    if constexpr (kPairs) {
        const int8_t* src = planes + row0 * lanes;
        for (int i = threadIdx.x; i < nrows * stride; i += blockDim.x) {
            const int r = i / stride;
            const int l = 2 * (i - r * stride);
            const int8_t* p = src + static_cast<long long>(r) * lanes;
            int v0 = 0, v1 = 0;
            if (l < lanes) {
                v0 = 127 * p[l] + (l + kRankLaneQl < lanes ? p[l + kRankLaneQl] : 0);
                v1 = 127 * p[l + 1] +
                     (l + 1 + kRankLaneQl < lanes ? p[l + 1 + kRankLaneQl] : 0);
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
}

// A visit's diff = 127 * p[lane] + p[lane + 30] + k on the row ``own``
// staged by tahoe_rank_stage: one shared-memory read of v (kPairs) or two
// of the bytes. cond = diff >= 0.
template <bool kPairs>
static __device__ __forceinline__ int tahoe_rank_diff(const int* own, int lane, int k) {
    if constexpr (kPairs) {
        return reinterpret_cast<const short*>(own)[lane] + k;
    } else {
        const int8_t* p = reinterpret_cast<const int8_t*>(own);
        return 127 * p[lane] + p[lane + kRankLaneQl] + k;
    }
}

// The same for a node record r = (k << 12) | lane (ops/rank_kernel.py
// rank_records).
template <bool kPairs>
static __device__ __forceinline__ int tahoe_rank_record_diff(const int* own, int r) {
    return tahoe_rank_diff<kPairs>(own, r & 0xFFF, r >> 12);
}
