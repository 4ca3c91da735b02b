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
//   Blocks of 8 warps, at most two an SM, each looping over 128-row tiles,
//   16 rows a warp (one m16 of mma). A block stages W once, transposed
//   ([n][k]) in shared memory so that a column's four k-consecutive bytes
//   are one word for both __dp4a and the mma's B fragment: 16-byte loads,
//   each 4 x 4 byte block transposed in registers by __byte_perm, stores of
//   32 consecutive words a warp. The scratch modes cast the lhs tile whole
//   words at a time (one 16-byte load of x, one word stored); rows of W^T
//   and of the lhs tile are 36 words apart, so the fragments' reads are
//   conflict-free. The mma modes write their output through shared memory
//   as whole 512-byte rows. Bound: the bytes, x int32 in and the output
//   out (M = 65,536: 64 MiB, 0.020 ms at 3.35 TB/s; the int8 operations
//   take 0.0011 ms); at M = 256, a few microseconds of latency.

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
constexpr int kInt8Threads = 256;             // 8 warps
constexpr int kWarpRows = 16;                 // a warp's tile: one m16 of mma
constexpr int kTileRows = 8 * kWarpRows;      // a block's tile
// Word pitches in shared memory. W^T and the lhs tile: 36 words a row
// (= 4 mod 32), so the mma fragments' reads (row g, word t: bank 4g + t)
// and a warp's row-wise stores (32 consecutive words) are conflict-free.
// The output tile: 132 words a row, so a row is one 512-byte store.
constexpr int kPitch = kK / 4 + 4;
constexpr int kOutPitch = kN + 4;
constexpr int kWtWords = kN * kPitch;

enum Int8Mode { kStore = 0, kDotLhsDp4a, kDotLhsMma, kScratchDp4a, kScratchMma };

__host__ __device__ constexpr bool is_mma(int mode) {
    return mode == kDotLhsMma || mode == kScratchMma;
}

// Words of a warp's scratch: the lhs tile (dp4a) or the output tile, which
// the mma modes also use for the lhs tile (read into registers first).
__host__ __device__ constexpr int warp_words(int mode) {
    return is_mma(mode) ? kWarpRows * kOutPitch : kWarpRows * kPitch;
}

// The low bytes of four int32 (the int8 cast, wrapping), and their signs
// (x > 0), packed into a word, lane 0 in the low byte.
__device__ __forceinline__ int cast4(int4 a) {
    return __byte_perm(__byte_perm(a.x, a.y, 0x0040), __byte_perm(a.z, a.w, 0x0040),
                       0x5410);
}
__device__ __forceinline__ int positive4(int4 a) {
    return (a.x > 0) | (a.y > 0) << 8 | (a.z > 0) << 16 | (a.w > 0) << 24;
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

__device__ __forceinline__ int word(const int4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// W [k][n] -> W^T [n][k] words in shared memory. Thread (warp w, lane l)
// loads the 4 x 16 bytes of rows 4l..4l+3, columns 16w..16w+15 with four
// 16-byte loads and transposes each 4 x 4 block in registers
// (__byte_perm); each of its 16 stores is one of 32 consecutive words
// across the warp.
__device__ __forceinline__ void stage_wt(int* wt, const int8_t* __restrict__ w) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int4 r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
        r[j] = __ldg(reinterpret_cast<const int4*>(w + (4 * lane + j) * kN + 16 * warp));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        // t0 = (r0, r1) bytes 0, 0, 1, 1; t1 = 2, 2, 3, 3; t2, t3 of (r2, r3)
        const int t0 = __byte_perm(word(r[0], c), word(r[1], c), 0x5140);
        const int t1 = __byte_perm(word(r[0], c), word(r[1], c), 0x7362);
        const int t2 = __byte_perm(word(r[2], c), word(r[3], c), 0x5140);
        const int t3 = __byte_perm(word(r[2], c), word(r[3], c), 0x7362);
        const int n = 16 * warp + 4 * c;
        wt[(n + 0) * kPitch + lane] = __byte_perm(t0, t2, 0x5410);
        wt[(n + 1) * kPitch + lane] = __byte_perm(t0, t2, 0x7632);
        wt[(n + 2) * kPitch + lane] = __byte_perm(t1, t3, 0x5410);
        wt[(n + 3) * kPitch + lane] = __byte_perm(t1, t3, 0x7632);
    }
}

template <int Mode>
__global__ void __launch_bounds__(kInt8Threads, 2)
probe_int8_kernel(const int* __restrict__ x, int M, const int8_t* __restrict__ w,
                  void* __restrict__ out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if constexpr (Mode == kStore) {  // 16 bytes in, one word out, a thread
        const long long chunks = static_cast<long long>(M) * (kK / 4);
        for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
             i < chunks; i += static_cast<long long>(gridDim.x) * blockDim.x)
            static_cast<int*>(out)[i] = cast4(__ldg(reinterpret_cast<const int4*>(x) + i));
        return;
    } else {
        extern __shared__ int smem_words[];
        int* wt = smem_words;  // W^T: wt[n][k / 4]
        int* scratch = smem_words + kWtWords + warp * warp_words(Mode);
        stage_wt(wt, w);
        __syncthreads();
        const int tiles = (M + kTileRows - 1) / kTileRows;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const int m0 = tile * kTileRows + warp * kWarpRows;
            if (m0 >= M) break;  // M % 16 == 0: a warp's tile is whole
            const int4* xt = reinterpret_cast<const int4*>(x + static_cast<long long>(m0) * kK);
            if constexpr (Mode == kScratchDp4a || Mode == kScratchMma) {
                // the cast through shared memory: lane c packs bytes 4c..4c+3
                // of each row, one 512-byte row a load instruction
                __syncwarp();
#pragma unroll
                for (int r = 0; r < kWarpRows; ++r)
                    scratch[r * kPitch + lane] = cast4(__ldg(xt + r * (kK / 4) + lane));
                __syncwarp();
            }
            if constexpr (is_mma(Mode)) {
                const int g = lane >> 2, t = lane & 3;
                int a[4][4];  // the A fragments of the four 32-byte k steps
#pragma unroll
                for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
                    for (int h = 0; h < 4; ++h) {
                        const int r = g + 8 * (h & 1);
                        const int c = 8 * ks + 4 * (h >> 1) + t;
                        if constexpr (Mode == kScratchMma)
                            a[ks][h] = scratch[r * kPitch + c];
                        else  // the int8 lhs built in registers
                            a[ks][h] = positive4(__ldg(xt + r * (kK / 4) + c));
                    }
                }
                int d[kN / 8][4];
#pragma unroll
                for (int nt = 0; nt < kN / 8; ++nt) {
                    d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0;
                    const int* b = wt + (8 * nt + g) * kPitch + t;
#pragma unroll
                    for (int ks = 0; ks < 4; ++ks)
                        mma_s8(d[nt], a[ks], b[8 * ks], b[8 * ks + 4]);
                }
                __syncwarp();  // every lane has read the lhs tile
                int* o = scratch;
#pragma unroll
                for (int nt = 0; nt < kN / 8; ++nt) {
                    *reinterpret_cast<int2*>(o + g * kOutPitch + 8 * nt + 2 * t) =
                        make_int2(d[nt][0], d[nt][1]);
                    *reinterpret_cast<int2*>(o + (g + 8) * kOutPitch + 8 * nt + 2 * t) =
                        make_int2(d[nt][2], d[nt][3]);
                }
                __syncwarp();
                int4* dst = reinterpret_cast<int4*>(static_cast<int*>(out) +
                                                    static_cast<long long>(m0) * kN);
#pragma unroll
                for (int r = 0; r < kWarpRows; ++r)  // whole rows, 512 bytes each
                    dst[r * (kN / 4) + lane] =
                        *reinterpret_cast<const int4*>(o + r * kOutPitch + 4 * lane);
            } else {
                // dp4a, the control: lane l owns columns l + 32j of the 16
                // rows; lane l starts its k words at l / 8, so the W^T reads
                // of a warp (bank 4l + l/8 + c) are conflict-free
                int acc[kWarpRows][4];
#pragma unroll
                for (int r = 0; r < kWarpRows; ++r)
                    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
#pragma unroll 2
                for (int cc = 0; cc < kK / 4; ++cc) {
                    const int c = (cc + (lane >> 3)) & (kK / 4 - 1);
                    int b[4];
#pragma unroll
                    for (int j = 0; j < 4; ++j) b[j] = wt[(lane + 32 * j) * kPitch + c];
#pragma unroll
                    for (int r = 0; r < kWarpRows; ++r) {
                        const int a = Mode == kScratchDp4a
                            ? scratch[r * kPitch + c]
                            : positive4(__ldg(xt + r * (kK / 4) + c));
#pragma unroll
                        for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a(a, b[j], acc[r][j]);
                    }
                }
                int* dst = static_cast<int*>(out) + static_cast<long long>(m0) * kN;
#pragma unroll
                for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
                    for (int j = 0; j < 4; ++j) dst[r * kN + lane + 32 * j] = acc[r][j];
            }
        }
    }
}

constexpr int kMaxDevices = 64;

template <int Mode>
cudaError_t launch_int8(const int* x, int M, const int8_t* w, void* out,
                        cudaStream_t stream) {
    // the SM count once a device: no attribute call inside a graph capture
    static int sm_count[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (sm_count[dev] == 0 &&
        (err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    const int sms = sm_count[dev];
    if constexpr (Mode == kStore) {
        const long long blocks = (static_cast<long long>(M) * (kK / 4) + kInt8Threads - 1) /
                                 kInt8Threads;
        const long long grid = blocks < 8LL * sms ? blocks : 8LL * sms;
        probe_int8_kernel<kStore><<<static_cast<unsigned>(grid), kInt8Threads, 0,
                                    stream>>>(x, M, w, out);
    } else {
        // W staged once a block, for every tile the block takes: two blocks
        // an SM at most, each looping over 128-row tiles
        const size_t smem = (kWtWords + 8 * warp_words(Mode)) * 4;
        if ((err = tahoe_grant_smem(probe_int8_kernel<Mode>, smem)) != cudaSuccess)
            return err;
        const int tiles = (M + kTileRows - 1) / kTileRows;
        probe_int8_kernel<Mode><<<min(tiles, 2 * sms), kInt8Threads, smem, stream>>>(
            x, M, w, out);
    }
    return cudaGetLastError();
}

// ------------------------------------------------------ kernel B parts ----
constexpr int kMaxGroups = 16;  // compiler.RANK_MAX_GROUPS
constexpr int kTreesInFlight = 4;  // trees the column walk descended together

// Sum of one int over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

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
    sum = warp_sum(sum);
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
                    if (t0 + k < T) acc += static_cast<unsigned>(warp_sum(s[k]));
            }
        }
    } else {  // descent: the dependent walk and the leaf reads, no column
        int ps = 0;
        for (int g = 0; g < G; ++g) ps += p[g];
        const unsigned key = static_cast<unsigned>(warp_sum(ps));
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
    if (M % kWarpRows || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    switch (mode) {
        case kStore: return static_cast<int>(launch_int8<kStore>(x, M, w, out, stream));
        case kDotLhsDp4a: return static_cast<int>(launch_int8<kDotLhsDp4a>(x, M, w, out, stream));
        case kDotLhsMma: return static_cast<int>(launch_int8<kDotLhsMma>(x, M, w, out, stream));
        case kScratchDp4a: return static_cast<int>(launch_int8<kScratchDp4a>(x, M, w, out, stream));
        case kScratchMma: return static_cast<int>(launch_int8<kScratchMma>(x, M, w, out, stream));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
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
