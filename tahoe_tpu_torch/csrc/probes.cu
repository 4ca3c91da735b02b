// Probe kernels: they take apart, on this card, the column walk that kernel B
// (rank_fold.cu) ran before it read 4-byte node records (a warp a row, each
// visited node's 128*G-byte column read whole, dp4a's and a warp sum), and
// ask whether in-kernel int8 products are exact on the tensor cores.
//
// Replace the Pallas probes scripts/int8_cast_probe.py (:52, :75, :101),
// scripts/overhead_bench.py (noop_margins, :107-146, pallas_call :138) and
// scripts/unit_bench.py (variant_margins, :123-210, pallas_call :203). The
// scripts that drive them are tahoe_tpu_torch/scripts/{int8_cast_probe,
// overhead_bench,unit_bench}.py; the plain versions are ops/probes.py.
//
// tahoe_probe_int8: x [M, 128] int32, W [128, 128] int8 (M % 16 == 0).
//   mode 0 store        out int8 [M, 128] = (int8) x, wrapping
//   mode 1 dot_lhs      out int32 [M, 128] = (x > 0) @ W, the int8 lhs
//                       built in registers, products by __dp4a
//   mode 2 dot_lhs      the same by mma.sync m16n8k32 s8.s8.s32
//   mode 3 scratch_dot  out = (int8) x @ W, the cast staged through shared
//                       memory, products by __dp4a
//   mode 4 scratch_dot  the same by mma.sync m16n8k32
//   One block of 256 threads a 16-row tile; W is staged transposed ([n][k])
//   in shared memory so that a column's four k-consecutive bytes are one
//   word for both __dp4a and the mma's B fragment. Bound: 2*M*128*128 int8
//   operations and ~0.3 MB at M = 256, both far below a microsecond; the
//   probe asks for exactness, not speed.
//
// tahoe_probe_overhead: the column walk's launch geometry (a warp a row,
// 256 threads, lane k holding plane words k, k+32, ...) on its columns.
//   mode 0 noop    out[row] = sum of the row's plane bytes
//   mode 1 stream  the same XOR every word lane k reads of every column
//                  the walk would read along the fixed path j = 0 (node
//                  2^d - 1 of each level of each tree): the loads without
//                  the dp4a's and the per-node shuffles
//   Bound: the planes' bytes (128*G a row) for noop; stream reads T*D
//   columns more, the same for every row, so they stay in L1/L2.
//
// tahoe_probe_rank_parts: the column walk's geometry, four trees in flight.
//   mode 0 dot      every visited column read whole, __dp4a and the warp
//                   sum, along the path j_d = h & (2^d - 1) with h a hash
//                   of (row, tree): a root-to-leaf path whose addresses do
//                   not wait on the conditions; the sums are added into the
//                   output (mod 2^32) so that nothing is elided
//   mode 1 descent  the dependent walk j += cond << d with cond the top bit
//                   of a hash of (the row's plane-word sum, tree, level, j),
//                   no column read, then the leaf of the final j, its bits
//                   added into the output (mod 2^32)
//   Bound (dot): the int8 operations of the visited columns, 2*128*G per
//   (row, tree, level), as the column walk's. Descent reads only planes and
//   leaves.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------- int8 ----
constexpr int kK = 128;   // the probe's contraction and output widths
constexpr int kN = 128;
constexpr int kWPitch = kK + 16;  // shared row pitch of W^T, 16-byte aligned

enum Int8Mode { kStore = 0, kDotLhsDp4a, kDotLhsMma, kScratchDp4a, kScratchMma };

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
    return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | (d << 24);
}

// mma.sync m16n8k32, int8 x int8 -> int32 (PTX ISA, "Matrix fragments for
// mma.m16n8k32"): lane = 4*g + t; A regs a0 = row g, cols 4t..4t+3;
// a1 = row g+8, cols 4t..; a2 = row g, cols 16+4t..; a3 = row g+8, cols
// 16+4t..; B regs b0 = col g, rows 4t..4t+3; b1 = col g, rows 16+4t..;
// D regs d0, d1 = row g, cols 2t, 2t+1; d2, d3 = row g+8, the same cols.
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       int b0, int b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(256)
probe_int8_kernel(const int* __restrict__ x, const int8_t* __restrict__ w,
                  int mode, void* __restrict__ out) {
    __shared__ __align__(16) int8_t wt[kN * kWPitch];  // W^T: wt[n][k]
    __shared__ __align__(16) int8_t at[16 * kWPitch];  // the int8 lhs tile
    const int tid = threadIdx.x;
    const int m0 = blockIdx.x * 16;

    if (mode == kStore) {
        int8_t* o = static_cast<int8_t*>(out);
        for (int i = tid; i < 16 * kK; i += blockDim.x)
            o[m0 * kK + i] = static_cast<int8_t>(x[m0 * kK + i]);
        return;
    }
    for (int i = tid; i < kK * kN; i += blockDim.x)
        wt[(i % kN) * kWPitch + i / kN] = w[i];
    const bool scratch = mode == kScratchDp4a || mode == kScratchMma;
    if (scratch) {
        for (int i = tid; i < 16 * kK; i += blockDim.x)
            at[(i / kK) * kWPitch + i % kK] = static_cast<int8_t>(x[m0 * kK + i]);
    }
    __syncthreads();
    int* o = static_cast<int*>(out);

    // the lhs word of row r (0..15), bytes 4c..4c+3
    auto lhs = [&](int r, int c) -> int {
        if (scratch) return *reinterpret_cast<const int*>(&at[r * kWPitch + 4 * c]);
        const int* xr = x + (m0 + r) * kK + 4 * c;
        return pack4(xr[0] > 0, xr[1] > 0, xr[2] > 0, xr[3] > 0);
    };
    auto rhs = [&](int n, int c) -> int {
        return *reinterpret_cast<const int*>(&wt[n * kWPitch + 4 * c]);
    };

    if (mode == kDotLhsDp4a || mode == kScratchDp4a) {
        for (int e = tid; e < 16 * kN; e += blockDim.x) {
            const int r = e / kN, n = e % kN;
            int s = 0;
#pragma unroll 8
            for (int c = 0; c < kK / 4; ++c) s = __dp4a(lhs(r, c), rhs(n, c), s);
            o[(m0 + r) * kN + n] = s;
        }
        return;
    }
    // mma: eight warps, two 8-column tiles each
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    for (int nt = warp; nt < kN / 8; nt += 8) {
        int d[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k0 = 0; k0 < kK / 4; k0 += 8) {  // 32 bytes of k a step
            const int a[4] = {lhs(g, k0 + t), lhs(g + 8, k0 + t),
                              lhs(g, k0 + 4 + t), lhs(g + 8, k0 + 4 + t)};
            mma_s8(d, a, rhs(nt * 8 + g, k0 + t), rhs(nt * 8 + g, k0 + 4 + t));
        }
        const int n = nt * 8 + 2 * t;
        o[(m0 + g) * kN + n] = d[0];
        o[(m0 + g) * kN + n + 1] = d[1];
        o[(m0 + g + 8) * kN + n] = d[2];
        o[(m0 + g + 8) * kN + n + 1] = d[3];
    }
}

// ------------------------------------------------------ kernel B parts ----
constexpr int kMaxGroups = 16;  // compiler.RANK_MAX_GROUPS

__device__ __forceinline__ unsigned mix32(unsigned v) {  // ops/probes.py mix32
    v ^= v >> 16;
    v *= 0x2C1B3C6Du;
    v ^= v >> 12;
    v *= 0x297A2D39u;
    v ^= v >> 15;
    return v;
}

__global__ void probe_overhead_kernel(const int8_t* __restrict__ planes,
                                      int rows, int G,
                                      const int8_t* __restrict__ mats, int T,
                                      int D, int mode, int* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
    if (row >= rows) return;
    const int* pw = reinterpret_cast<const int*>(planes + row * 128 * G);
    int sum = 0;
    unsigned x = 0;
    for (int g = 0; g < G; ++g) {
        const int v = pw[32 * g + lane];
        sum += (v << 24 >> 24) + (v << 16 >> 24) + (v << 8 >> 24) + (v >> 24);
    }
    if (mode == 1) {
        const long long words = 32LL * G;
        const long long N = (1LL << D) - 1;
        const int* m = reinterpret_cast<const int*>(mats);
        for (int t = 0; t < T; ++t)
            for (int d = 0; d < D; ++d)
                for (int g = 0; g < G; ++g)
                    x ^= static_cast<unsigned>(
                        __ldg(m + (t * N + (1LL << d) - 1) * words + 32 * g + lane));
    }
    // one reduction a row, not one a node
    sum = tahoe_warp_sum(sum);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) out[row] = static_cast<int>(static_cast<unsigned>(sum) ^ x);
}

__global__ void probe_rank_parts_kernel(const int8_t* __restrict__ planes,
                                        int rows, int G,
                                        const int8_t* __restrict__ mats, int T,
                                        int D, const float* __restrict__ leaf,
                                        int mode, int* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
    if (row >= rows) return;
    const int* pw = reinterpret_cast<const int*>(planes + row * 128 * G);
    int p[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) p[g] = g < G ? pw[32 * g + lane] : 0;
    const long long words = 32LL * G;
    const long long N = (1LL << D) - 1;
    const long long L = 1LL << D;
    const unsigned r32 = static_cast<unsigned>(row);
    unsigned acc = 0;

    if (mode == 0) {  // dot: the walk's loads, dp4a's and sums, no dependence
        for (int t0 = 0; t0 < T; t0 += kTreesInFlight) {
            unsigned h[kTreesInFlight];
            const int* col[kTreesInFlight];
#pragma unroll
            for (int k = 0; k < kTreesInFlight; ++k) {
                const int t = min(t0 + k, T - 1);
                h[k] = mix32(r32 * 0x9E3779B1u ^ static_cast<unsigned>(t) * 0x85EBCA6Bu);
                col[k] = reinterpret_cast<const int*>(mats) + t * N * words;
            }
            for (int d = 0; d < D; ++d) {
                int s[kTreesInFlight];
#pragma unroll
                for (int k = 0; k < kTreesInFlight; ++k) {
                    const unsigned j = h[k] & ((1u << d) - 1u);
                    const int* c = col[k] + ((1LL << d) - 1 + j) * words;
                    int v = 0;
#pragma unroll
                    for (int g = 0; g < kMaxGroups; ++g)
                        if (g < G) v = __dp4a(p[g], __ldg(c + 32 * g + lane), v);
                    s[k] = v;
                }
#pragma unroll
                for (int k = 0; k < kTreesInFlight; ++k)
                    if (t0 + k < T) acc += static_cast<unsigned>(tahoe_warp_sum(s[k]));
            }
        }
    } else {  // descent: the dependent walk and the leaf reads, no column
        int ps = 0;
        for (int g = 0; g < G; ++g) ps += p[g];
        const unsigned key = static_cast<unsigned>(tahoe_warp_sum(ps));
        for (int t = 0; t < T; ++t) {
            unsigned j = 0;
            for (int d = 0; d < D; ++d) {
                const unsigned c = mix32(key ^ static_cast<unsigned>(t) * 0x9E3779B1u
                                         ^ static_cast<unsigned>(d) * 0x85EBCA6Bu ^ j) >> 31;
                j += c << d;
            }
            acc += static_cast<unsigned>(__float_as_int(leaf[t * L + j]));
        }
    }
    if (lane == 0) out[row] = static_cast<int>(acc);
}

}  // namespace

TAHOE_EXPORT int tahoe_probe_int8(const int* x, int M, const int8_t* w,
                                  int mode, void* out, cudaStream_t stream) {
    if (M == 0) return 0;
    if (M % 16 || mode < kStore || mode > kScratchMma)
        return static_cast<int>(cudaErrorInvalidValue);
    probe_int8_kernel<<<M / 16, 256, 0, stream>>>(x, w, mode, out);
    return static_cast<int>(cudaGetLastError());
}

TAHOE_EXPORT int tahoe_probe_overhead(const int8_t* planes, int rows, int G,
                                      const int8_t* mats, int T, int D,
                                      int mode, int* out, cudaStream_t stream) {
    if (rows == 0) return 0;
    if (G < 1 || G > kMaxGroups || mode < 0 || mode > 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long grid = (32LL * rows + 255) / 256;
    probe_overhead_kernel<<<static_cast<unsigned>(grid), 256, 0, stream>>>(
        planes, rows, G, mats, T, D, mode, out);
    return static_cast<int>(cudaGetLastError());
}

TAHOE_EXPORT int tahoe_probe_rank_parts(const int8_t* planes, int rows, int G,
                                        const int8_t* mats, int T, int D,
                                        const float* leaf, int mode, int* out,
                                        cudaStream_t stream) {
    if (rows == 0) return 0;
    if (G < 1 || G > kMaxGroups || mode < 0 || mode > 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long grid = (32LL * rows + 255) / 256;
    probe_rank_parts_kernel<<<static_cast<unsigned>(grid), 256, 0, stream>>>(
        planes, rows, G, mats, T, D, leaf, mode, out);
    return static_cast<int>(cudaGetLastError());
}
