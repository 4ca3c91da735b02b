// Probe kernels: they take apart, on this card, the record walk that
// kernel B (rank_fold.cu) runs, on kernel B's own launch, and ask whether
// in-kernel int8 products are exact on the tensor cores.
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

// tahoe_probe_overhead and tahoe_probe_rank_parts: kernel B's walk in parts.
//   Both take kernel B's inputs (planes [R, 128G] int8, records [T, 2^D - 1]
//   int32, leaf [T, 2^D] f32) and its launch: a thread a row, its block and
//   shared memory, its row staging and per-visit body (common.cuh
//   tahoe_rank_*), kRankTrees trees in flight. Each writes one int32 a row,
//   every sum mod 2^32: S, the sum of the row's staged words, plus, per tree,
//   a part and the f32 bits of one leaf j. paths, stream and dot also take
//   each walk's leaf j, given in advance (paths [ceil(T / 8), R] words of eight
//   bytes: tree 8g + b in byte b of word (g, row); D <= 8): the walk's nodes
//   2^d - 1 + (j & (2^d - 1)) are then known before any condition, and all
//   D x kRankTrees record loads of a group are issued before any is used.
//   overhead mode 0 noop     S alone: the launch, the staging and the write
//            mode 1 stream   part = the XOR of the path's D records: the
//                            walk's global loads alone
//            mode 2 paths    j alone, with no record and no leaf read:
//                            the path words' own cost, which stream and
//                            dot carry and kernel B does not
//   rank_parts mode 0 dot    part = sum over d of cond_d << d, cond_d kernel
//                            B's own visit body (the shared read at the
//                            record's lane, diff >= 0) on the path's
//                            records (= j on the real walk): the whole
//                            visit without the dependence
//              mode 1 descent  kernel B's dependent walk n += (1 + cond) << d
//                            with no record loaded: node n of tree t is
//                            g = (key_t ^ n) * C3, key_t = mix32(t * C1 + C2),
//                            lane = umulhi(g, 128G + 1) (the zero lane past
//                            the row included), k = ((g >> 8) & 0x7FFF) -
//                            16384; part = j = n - (2^D - 1), the leaf it
//                            reaches: the walk without its global loads
//   Bounds (chip_smoke.py): noop the planes' bytes; paths those and the
//   path words'; stream a load and a XOR a visit; dot kernel B's four
//   operations a visit; descent those and the node hash's six. The path
//   words are read a group ahead and past L1: through L1 they evicted the
//   records (stream 0.27 against 0.19 ms).
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
enum WalkMode { kNoop = 0, kPaths, kStream, kDot, kDescent };
// the modes that read the given paths
__host__ __device__ constexpr bool reads_paths(int mode) {
    return mode == kPaths || mode == kStream || mode == kDot;
}
static_assert(kRankTrees % 8 == 0, "the paths hold eight trees' leaves a word");
constexpr int kPathLevels = 8;  // a path's leaf is a byte: D <= 8
constexpr unsigned kC1 = 0x9E3779B1u, kC2 = 0x85EBCA6Bu, kC3 = 0x2C1B3C6Du;

__device__ __forceinline__ unsigned mix32(unsigned v) {  // ops/probes.py mix32
    v ^= v >> 16;
    v *= 0x2C1B3C6Du;
    v ^= v >> 12;
    v *= 0x297A2D39u;
    v ^= v >> 15;
    return v;
}

// A path word: read-only and past L1, where it would evict records.
__device__ __forceinline__ unsigned long long load_path(const unsigned long long* p) {
    unsigned long long v;
    asm("ld.global.nc.L1::no_allocate.u64 %0, [%1];" : "=l"(v) : "l"(p));
    return v;
}

template <int Mode, bool kPairs>
__global__ void __launch_bounds__(kRankMaxRows, 2) probe_walk_kernel(const int8_t* __restrict__ planes, int rows,
                                  int G, const int* __restrict__ records, int T,
                                  int D, const float* __restrict__ leaf,
                                  const unsigned long long* __restrict__ paths,
                                  int* __restrict__ out) {
    extern __shared__ int smem_words[];
    const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x;
    const int nrows = static_cast<int>(min(static_cast<long long>(blockDim.x),
                                           rows - row0));
    tahoe_rank_stage<kPairs>(smem_words, planes, row0, nrows, G);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) >= nrows) return;

    const int stride = tahoe_rank_row_words(G, kPairs);
    const int* own = smem_words + threadIdx.x * stride;
    unsigned acc = 0;
    for (int w = 0; w < stride; ++w) acc += static_cast<unsigned>(own[w]);
    if constexpr (Mode != kNoop) {
        const int N = (1 << D) - 1;  // nodes per tree; node n = 2^d - 1 + j
        const long long row = row0 + threadIdx.x;
        const unsigned span = 128u * G + 1u;  // descent's lanes: [0, 128G]
        // the paths of the next group of trees are read while this one
        // descends, past L1 (see above)
        constexpr int kWords = kRankTrees / 8;
        unsigned long long pnext[kWords];
        if constexpr (reads_paths(Mode)) {
#pragma unroll
            for (int w = 0; w < kWords; ++w)
                pnext[w] = load_path(paths + static_cast<long long>(w) * rows + row);
        }
        for (int t0 = 0; t0 < T; t0 += kRankTrees) {
            const int* rec[kRankTrees];
            unsigned h[kRankTrees];  // the given path's leaf, or descent's tree key
            unsigned part[kRankTrees];
            int n[kRankTrees];
#pragma unroll
            for (int k = 0; k < kRankTrees; ++k) {
                // tail slots repeat the last tree and are not summed
                const unsigned t = static_cast<unsigned>(min(t0 + k, T - 1));
                rec[k] = records + static_cast<long long>(t) * N;
                part[k] = 0;
                n[k] = 0;
                if constexpr (Mode == kDescent) h[k] = mix32(t * kC1 + kC2);
            }
            if constexpr (Mode == kDescent) {
                for (int d = 0; d < D; ++d) {
                    // every chain's shared read before any is used, as kernel
                    // B's record loads are
                    int lane[kRankTrees], k12[kRankTrees], diff[kRankTrees];
#pragma unroll
                    for (int k = 0; k < kRankTrees; ++k) {
                        const unsigned g = (h[k] ^ static_cast<unsigned>(n[k])) * kC3;
                        lane[k] = static_cast<int>(__umulhi(g, span));
                        k12[k] = static_cast<int>((g >> 8) & 0x7FFF) - 16384;
                    }
#pragma unroll
                    for (int k = 0; k < kRankTrees; ++k)
                        diff[k] = tahoe_rank_diff<kPairs>(own, lane[k], k12[k]);
#pragma unroll
                    for (int k = 0; k < kRankTrees; ++k)
                        n[k] += (diff[k] >= 0 ? 2 : 1) << d;
                }
            } else {
                const long long g1 = (t0 + kRankTrees) >> 3;  // the next group's word
#pragma unroll
                for (int w = 0; w < kWords; ++w) {
                    const unsigned long long p = pnext[w];
                    pnext[w] = t0 + kRankTrees < T
                        ? load_path(paths + (g1 + w) * rows + row) : 0ull;
#pragma unroll
                    for (int b = 0; b < 8; ++b)
                        h[8 * w + b] = static_cast<unsigned>(p >> (8 * b)) & 0xFFu;
                }
                if constexpr (Mode != kPaths) {
                    // every record of the group's walks is known: all D x
                    // kRankTrees loads are issued before any is used
                    int r[kPathLevels][kRankTrees];
#pragma unroll
                    for (int d = 0; d < kPathLevels; ++d)
#pragma unroll
                        for (int k = 0; k < kRankTrees; ++k)
                            r[d][k] = d < D ? __ldg(rec[k] + (1 << d) - 1 + (h[k] & ((1u << d) - 1u)))
                                            : 0;
#pragma unroll
                    for (int d = 0; d < kPathLevels; ++d) {
                        if (d >= D) break;
                        if constexpr (Mode == kStream) {
#pragma unroll
                            for (int k = 0; k < kRankTrees; ++k) part[k] ^= static_cast<unsigned>(r[d][k]);
                        } else {
                            int diff[kRankTrees];
#pragma unroll
                            for (int k = 0; k < kRankTrees; ++k)
                                diff[k] = tahoe_rank_record_diff<kPairs>(own, r[d][k]);
#pragma unroll
                            for (int k = 0; k < kRankTrees; ++k)
                                n[k] += (diff[k] >= 0 ? 2 : 1) << d;
                        }
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < kRankTrees; ++k) {
                if (t0 + k >= T) continue;
                const int j = Mode == kDescent ? n[k] - N : static_cast<int>(h[k]);
                if constexpr (Mode == kPaths) {
                    acc += static_cast<unsigned>(j);
                } else {
                    if constexpr (Mode != kStream) part[k] = static_cast<unsigned>(n[k] - N);
                    acc += part[k] + __float_as_uint(
                        leaf[static_cast<long long>(t0 + k) * (N + 1) + j]);
                }
            }
        }
    }
    out[row0 + threadIdx.x] = static_cast<int>(acc);
}

template <int Mode, bool kPairs>
cudaError_t launch_walk(const int8_t* planes, int rows, int G, const int* records,
                        int T, int D, const float* leaf,
                        const unsigned long long* paths, int* out,
                        cudaStream_t stream) {
    const int block = tahoe_rank_block_rows(G, kPairs);
    const size_t smem = static_cast<size_t>(block) * 4 * tahoe_rank_row_words(G, kPairs);
    cudaError_t err = tahoe_grant_smem(probe_walk_kernel<Mode, kPairs>, smem);
    if (err != cudaSuccess) return err;
    const long long grid = (static_cast<long long>(rows) + block - 1) / block;
    probe_walk_kernel<Mode, kPairs><<<static_cast<unsigned>(grid), block, smem, stream>>>(
        planes, rows, G, records, T, D, leaf, paths, out);
    return cudaGetLastError();
}

template <int Mode>
int launch_walk_mode(const int8_t* planes, int rows, int G, const int* records,
                     int T, int D, const float* leaf, const void* paths, int* out,
                     cudaStream_t stream) {
    // the path modes read a path's leaf as a byte: D <= 8
    if (G < 1 || G > kRankMaxGroups || T < 1 || D < 0 || D > 30 ||
        (reads_paths(Mode) &&
         (D > 8 || paths == nullptr || reinterpret_cast<uintptr_t>(paths) % 8)))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* p = static_cast<const unsigned long long*>(paths);
    return static_cast<int>(
        G <= kRankMaxPairGroups
            ? launch_walk<Mode, true>(planes, rows, G, records, T, D, leaf, p, out, stream)
            : launch_walk<Mode, false>(planes, rows, G, records, T, D, leaf, p, out, stream));
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
                                      const int* records, int T, int D,
                                      const float* leaf, const void* paths,
                                      int mode, int* out, cudaStream_t stream) {
    if (rows == 0) return 0;
    if (mode == 0)
        return launch_walk_mode<kNoop>(planes, rows, G, records, T, D, leaf, paths, out, stream);
    if (mode == 1)
        return launch_walk_mode<kStream>(planes, rows, G, records, T, D, leaf, paths, out, stream);
    if (mode == 2)
        return launch_walk_mode<kPaths>(planes, rows, G, records, T, D, leaf, paths, out, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

TAHOE_EXPORT int tahoe_probe_rank_parts(const int8_t* planes, int rows, int G,
                                        const int* records, int T, int D,
                                        const float* leaf, const void* paths,
                                        int mode, int* out, cudaStream_t stream) {
    if (rows == 0) return 0;
    if (mode == 0)
        return launch_walk_mode<kDot>(planes, rows, G, records, T, D, leaf, paths, out, stream);
    if (mode == 1)
        return launch_walk_mode<kDescent>(planes, rows, G, records, T, D, leaf, paths, out, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}
