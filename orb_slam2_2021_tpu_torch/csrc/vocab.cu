// The vocabulary builder's kernels: hierarchical binary k-medians over packed
// 256-bit ORB descriptors on Hopper (sm_90a).
//
// The reference trains its tree in host numpy (orb_slam2_2021_tpu/place/
// vocab.py: `_kmeans_binary` :58-94, `_majority_centroid` :51-55, called
// node by node from `train_vocabulary` :139-166). The port runs every node of
// a level at once (place/vocab.py), with the rows of each node contiguous and
// in corpus order, and three launchers:
//
//   vocab_assign_launch     per row, the first-occurrence argmin of the
//                           Hamming distances to the k centres of the row's
//                           group, and that distance. It is the TPU kernel's
//                           function (orb_slam2_2021_tpu/ops/hamming_pallas.py
//                           :37-92, XOR + popcount) in a segmented shape: each
//                           row meets only its own node's k centres, which a
//                           dense [N, nodes*k] matrix could not carry. With
//                           k = 1 against the newest centre it gives the
//                           k-means++ distance update.
//   vocab_majority_launch   per node and cluster, the bit counts over 256
//                           bits and the cluster size, packed into the
//                           bitwise-majority centroid with the reference's
//                           tie rule 2 * count >= size (FORB::meanValue;
//                           the reference's host `_majority_centroid`).
//   vocab_seed_draw_launch  per node, the k-means++ pick exactly as numpy's
//                           rng.choice(n, p=d2 / s) makes it from the node's
//                           uniform u (`_kmeans_binary` :76): p in IEEE
//                           float64, a strictly left-to-right float64
//                           cumulative sum, cdf /= cdf[-1],
//                           searchsorted(u, side="right"); a flag for s == 0.
//
// What bounds them on an H100 SXM (3.35 TB/s):
//
//   assign reads each row (32 B) and its group (8 B) once and writes 12 B;
//     the k centres of a group are a few hundred bytes that stay in L1/L2.
//     Bytes bound it; at k = 10 its 80 POPC a row come close behind (POPC
//     runs at 16 a clock per SM). One thread per row, two 16-byte loads.
//
//   majority reads each row and its cluster (40 B) once: bytes, 2.8 clocks
//     a row per SM at 4 M rows. Counting bit by bit per row (256 adds a row)
//     cannot keep up, so the counts are a product on the tensor cores:
//     counts[c][b] = sum over rows r of [assign r == c] AND bit b of r, the
//     1-bit `mma.sync m16n8k256 .and.popc` with the rows as k. A warp takes
//     128 rows of one node at a time, 32 rows (one lane each) per k-word:
//     A (16 clusters x rows) holds the membership masks, __ballot_sync(assign
//     == c); B (rows x 8 bits) holds bit columns, which a 32x32 bit transpose
//     of each descriptor word gives (lane b then holds the mask, over the 32
//     rows, of bit 32w + b), and a 4x4 word transpose inside each quad puts
//     into the MMA's B layout (the four lanes of a quad hold one column, each
//     its own k-word). The transpose runs on shuffles (5 a word: 32 ballots
//     a word measured 3.7x slower, and the CUDA-core count, popc(column AND
//     member) into shared counters, 1.5x slower). The [16, 256] s32
//     accumulators live in registers across a warp's rows. A node of at most
//     kMajSmallRows (512) rows takes one warp, which packs the centroids from
//     its registers; a larger node is cut into chunks of at most MAJORITY_CHUNK
//     rows, a block of 8 warps each, whose warps add their counts into shared
//     memory; a node of one chunk is packed there, a node of several adds its
//     chunks into a global table with integer atomics (exact, order-free) and
//     a pack kernel packs it. Integer sums only, so the card and the CPU agree
//     bit for bit. A row whose cluster lies outside 0..k-1 is counted nowhere.
//
//   seed_draw reads each d2 (4 B) once: 16 MB, 4.8 us at 4 M rows. The
//     numpy chain c_i = fl(c_{i-1} + q_i), q = fl(v / s), v = d2 in 0..256,
//     is reproduced exactly without walking it row by row. All terms are
//     >= 0, so c never decreases. While c stays in one binade [2^e, 2^(e+1))
//     it is a multiple of u = 2^(e-52), and with q / u = a + f the rounded
//     sum is c + inc * u: inc = a for f < 1/2, a + 1 for f > 1/2, and at the
//     tie f = 1/2 whichever of a, a + 1 makes c / u + inc even. A row is
//     thus a function of one bit, the parity of c / u, and such functions
//     compose associatively (Fn below: the increment and the parity out, for
//     either parity in), so a run of rows in one binade reduces in parallel.
//     Which binade a row's c lies in follows from the exact integer prefix
//     D_i = sum d2: c_i lies within a relative (n + 3) 2^-53 of D_i / s, so
//     the binade is certain unless D_i / s lies within a margin of a power
//     of two. A row is stepped with a real __dadd_rn (a "break") where its
//     binade is not certain on both sides or changes; every other row with
//     d2 > 0 belongs to the run of its binade (a row with d2 == 0 changes
//     nothing). A node of more than kChainMax (2,048) rows is cut into tiles of
//     4,096 rows (its warp in the chain kernel reserves them with atomics); a
//     block reduces each tile to a segment, 16 rows a thread: the composed
//     run before its first break, the first and last break, the composed
//     run after the last. One block per node then walks the segments in
//     order from c = 0, 32 tiles at a time: a warp composes a group of 32
//     tiles without a break into one run, and thread 0 applies a run as an
//     integer add to the bits of c (its binade checked before and after: the
//     walk traps rather than guess), steps a short middle row by row, and
//     walks a tile whose breaks lie 32 rows or more apart again in 32-row
//     chunks reduced the same way. c is kept at each group's end and at each
//     tile's end in a mixed group; the pick is the first row with
//     fl(c_i / total) > u: in the first group whose end passes, its first
//     tile whose end does (a pure group's from a warp scan of its runs), its
//     first chunk, its first row, each by the same comparison numpy's
//     searchsorted makes. About 30 binades and a few breaks each at 4 M
//     rows: the walk is a few hundred integer adds, and no [n] float64
//     scratch exists. A node of at most kChainMax rows takes one warp,
//     which adds its rows' p in order (a shuffle and a dependent float64 add
//     a row: at that size as fast as the scan), keeps c at each 32-row
//     chunk's end in shared memory, and finds the pick the same way. Where
//     no node of a call exceeds kChainMax rows, the chain kernel is all that
//     launches.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;          // 32-bit words per descriptor
constexpr int kMaxK = 16;          // centres per node the kernels take
constexpr int kBits = 256;         // bits per descriptor
constexpr int kMaxDist = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1, const uint4& b0,
                                       const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
         __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// rows [n, 8] words, group [n] int64, centers [groups, k, 8] words ->
// idx [n] int64 (first occurrence of the least distance), dist [n] int32.
__global__ void vocab_assign_kernel(const uint4* __restrict__ rows,
                                    const long long* __restrict__ group,
                                    const uint4* __restrict__ centers, int k, long long n,
                                    long long* __restrict__ idx, int* __restrict__ dist) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const uint4 a0 = rows[2 * r], a1 = rows[2 * r + 1];
  const uint4* c = centers + 2 * group[r] * k;
  int best = kMaxDist + 1, best_j = 0;
  for (int j = 0; j < k; ++j) {
    const int d = hamming(a0, a1, c[2 * j], c[2 * j + 1]);
    if (d < best) {  // strict: the first occurrence wins a tie
      best = d;
      best_j = j;
    }
  }
  idx[r] = best_j;
  dist[r] = best;
}

// ------------------------------------------------------------------ majority

constexpr int kMajWarps = 8;        // warps of a chunk block
constexpr int kGroupRows = 128;     // rows a warp counts at once: 4 k-words of 32
constexpr int kMajSmallRows = 512;  // nodes up to it take one warp (MAJORITY_SMALL in ops/vocab_kernels.py)
constexpr int kSmallWarps = 4;      // nodes per small-node block

// c += popc(A AND B) over k = 256 for a 16x8 tile, with A's k-words 4..7 and
// B's zero: a0 = (row g, k-word tig), a1 = (row g + 8, k-word tig), b0 =
// (k-word tig, column g); c0, c1 = row g, columns 2 tig, 2 tig + 1; c2, c3 =
// row g + 8 (g = lane / 4, tig = lane % 4).
__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u));
}

template <int J>
__device__ __forceinline__ uint32_t transpose_stage(uint32_t x, int lane, uint32_t low) {
  const uint32_t y = __shfl_xor_sync(kFull, x, J);
  return (lane & J) ? ((x & ~low) | ((y >> J) & low)) : ((x & low) | ((y << J) & ~low));
}

// Lane r holds word x of row r -> lane b holds the mask, over the 32 rows, of
// bit b: a 32x32 bit transpose by swapping off-diagonal blocks.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  x = transpose_stage<16>(x, lane, 0x0000ffffu);
  x = transpose_stage<8>(x, lane, 0x00ff00ffu);
  x = transpose_stage<4>(x, lane, 0x0f0f0f0fu);
  x = transpose_stage<2>(x, lane, 0x33333333u);
  return transpose_stage<1>(x, lane, 0x55555555u);
}

// Inside each quad, lane t's y[s] -> lane s's y[t] (a 4x4 word transpose).
__device__ __forceinline__ void quad_transpose(uint32_t (&y)[4], int tig) {
  {
    const bool hi = tig & 2;
    const uint32_t r0 = __shfl_xor_sync(kFull, hi ? y[0] : y[2], 2);
    const uint32_t r1 = __shfl_xor_sync(kFull, hi ? y[1] : y[3], 2);
    if (hi) {
      y[0] = r0;
      y[1] = r1;
    } else {
      y[2] = r0;
      y[3] = r1;
    }
  }
  const bool odd = tig & 1;
  const uint32_t r0 = __shfl_xor_sync(kFull, odd ? y[0] : y[1], 1);
  const uint32_t r1 = __shfl_xor_sync(kFull, odd ? y[2] : y[3], 1);
  if (odd) {
    y[0] = r0;
    y[2] = r1;
  } else {
    y[1] = r0;
    y[3] = r1;
  }
}

__device__ __forceinline__ uint32_t pick8(const uint32_t* m, int g) {
  const uint32_t a = (g & 1) ? m[1] : m[0], b = (g & 1) ? m[3] : m[2];
  const uint32_t c = (g & 1) ? m[5] : m[4], d = (g & 1) ? m[7] : m[6];
  const uint32_t e = (g & 2) ? b : a, f = (g & 2) ? d : c;
  return (g & 4) ? f : e;
}

// A warp's running counts: acc[4 w + t'] is the 16x8 tile of bits
// {32 w + 4 n + t' : n = 0..7} (column n), clusters 0..15 as rows; sz0 and sz1
// the rows of clusters g and g + 8 among the k-word tig rows this lane saw.
struct MajAcc {
  int c[32][4];
  int sz0, sz1;
};

// Count rows [r0, min(r0 + 128, r_end)) of one node: k-word s holds rows
// r0 + 32 s .. r0 + 32 s + 31, lane = row.
__device__ __forceinline__ void count_group(const uint4* __restrict__ rows,
                                            const long long* __restrict__ assign, long long r0,
                                            long long r_end, int k, int lane, MajAcc& acc) {
  const int g = lane >> 2, tig = lane & 3;
  uint32_t x[4][kWords];
  int a[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const long long r = r0 + 32 * s + lane;
    uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
    a[s] = -1;  // past the end, or outside 0..k-1: counted nowhere
    if (r < r_end) {
      v0 = rows[2 * r];
      v1 = rows[2 * r + 1];
      const long long c = assign[r];
      if (c >= 0 && c < k) a[s] = static_cast<int>(c);
    }
    x[s][0] = v0.x; x[s][1] = v0.y; x[s][2] = v0.z; x[s][3] = v0.w;
    x[s][4] = v1.x; x[s][5] = v1.y; x[s][6] = v1.z; x[s][7] = v1.w;
  }
  uint32_t a0 = 0, a1 = 0;  // membership of clusters g, g + 8 in k-word tig
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t m[kMaxK];
#pragma unroll
    for (int c = 0; c < kMaxK; ++c) m[c] = __ballot_sync(kFull, a[s] == c);
    const uint32_t lo = pick8(m, g), hi = pick8(m + 8, g);
    a0 = tig == s ? lo : a0;
    a1 = tig == s ? hi : a1;
  }
  acc.sz0 += __popc(a0);
  acc.sz1 += __popc(a1);
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint32_t y[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) y[s] = transpose32(x[s][w], lane);
    quad_transpose(y, tig);  // y[t']: bit 32 w + 4 g + t' of k-word tig
#pragma unroll
    for (int t = 0; t < 4; ++t) mma_b1(acc.c[4 * w + t], a0, a1, y[t]);
  }
}

// The quad's sizes of clusters g and g + 8.
__device__ __forceinline__ void quad_sizes(MajAcc& acc) {
  acc.sz0 += __shfl_xor_sync(kFull, acc.sz0, 1);
  acc.sz0 += __shfl_xor_sync(kFull, acc.sz0, 2);
  acc.sz1 += __shfl_xor_sync(kFull, acc.sz1, 1);
  acc.sz1 += __shfl_xor_sync(kFull, acc.sz1, 2);
}

// One warp per node of at most kMajSmallRows rows, a descriptor word at a
// time so that only that word's counts live in registers: first the
// membership masks of each 128-row group (and the sizes), then per word w the
// bit columns of its k-words, transposed, into four MMA tiles, packed into
// word w of the node's centroids (2 * count >= size; an empty cluster packs
// to all ones). k-words past the node's end are skipped (warp-uniform).
__global__ void __launch_bounds__(kSmallWarps * 32)
vocab_majority_small_kernel(const uint32_t* __restrict__ rows, const long long* __restrict__ assign,
                            const long long* __restrict__ offsets, int groups, int k,
                            uint32_t* __restrict__ centers, int* __restrict__ sizes) {
  constexpr int kSmallGroups = kMajSmallRows / kGroupRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int node = blockIdx.x * kSmallWarps + warp;
  if (node >= groups) return;  // the whole warp leaves together
  const long long s0 = offsets[node];
  const long long nl = offsets[node + 1] - s0;
  if (nl > kMajSmallRows) return;  // the chunk kernel's
  const int n = static_cast<int>(nl);
  uint32_t a0[kSmallGroups], a1[kSmallGroups];  // clusters g, g + 8 in k-word tig of each group
  int sz0 = 0, sz1 = 0;
#pragma unroll
  for (int gi = 0; gi < kSmallGroups; ++gi) {
    a0[gi] = a1[gi] = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int r0 = gi * kGroupRows + 32 * s;
      if (r0 >= n) break;
      int a = -1;  // past the end, or outside 0..k-1: counted nowhere
      if (r0 + lane < n) {
        const long long c = assign[s0 + r0 + lane];
        if (c >= 0 && c < k) a = static_cast<int>(c);
      }
      uint32_t m[kMaxK];
#pragma unroll
      for (int c = 0; c < kMaxK; ++c) m[c] = __ballot_sync(kFull, a == c);
      const uint32_t lo = pick8(m, g), hi = pick8(m + 8, g);
      a0[gi] = tig == s ? lo : a0[gi];
      a1[gi] = tig == s ? hi : a1[gi];
    }
    sz0 += __popc(a0[gi]);
    sz1 += __popc(a1[gi]);
  }
  sz0 += __shfl_xor_sync(kFull, sz0, 1);
  sz0 += __shfl_xor_sync(kFull, sz0, 2);
  sz1 += __shfl_xor_sync(kFull, sz1, 1);
  sz1 += __shfl_xor_sync(kFull, sz1, 2);
  const uint32_t* base = rows + s0 * kWords;
#pragma unroll 1
  for (int w = 0; w < kWords; ++w) {
    int acc[4][4] = {};
#pragma unroll
    for (int gi = 0; gi < kSmallGroups; ++gi) {
      if (gi * kGroupRows >= n) break;
      uint32_t y[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r0 = gi * kGroupRows + 32 * s;
        y[s] = r0 < n ? transpose32(r0 + lane < n ? base[(r0 + lane) * kWords + w] : 0u, lane) : 0u;
      }
      quad_transpose(y, tig);  // y[t']: bit 32 w + 4 g + t' of k-word tig
#pragma unroll
      for (int t = 0; t < 4; ++t) mma_b1(acc[t], a0[gi], a1[gi], y[t]);
    }
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      lo |= static_cast<uint32_t>(2 * acc[t][0] >= sz0) << (8 * tig + t);
      lo |= static_cast<uint32_t>(2 * acc[t][1] >= sz0) << (8 * tig + 4 + t);
      hi |= static_cast<uint32_t>(2 * acc[t][2] >= sz1) << (8 * tig + t);
      hi |= static_cast<uint32_t>(2 * acc[t][3] >= sz1) << (8 * tig + 4 + t);
    }
    lo |= __shfl_xor_sync(kFull, lo, 1);
    lo |= __shfl_xor_sync(kFull, lo, 2);
    hi |= __shfl_xor_sync(kFull, hi, 1);
    hi |= __shfl_xor_sync(kFull, hi, 2);
    if (tig == 0) {
      if (g < k) centers[(static_cast<long long>(node) * k + g) * kWords + w] = lo;
      if (g + 8 < k) centers[(static_cast<long long>(node) * k + g + 8) * kWords + w] = hi;
    }
  }
  if (tig == 0) {
    if (g < k) sizes[node * k + g] = sz0;
    if (g + 8 < k) sizes[node * k + g + 8] = sz1;
  }
}

// One block per chunk of a node of more than kMajSmallRows rows; warp w
// counts the chunk's 128-row groups w, w + 8, ... and adds them into shared
// counts. A node of one chunk is packed here; a node of several adds its
// counts into the global table of its slot.
__global__ void __launch_bounds__(kMajWarps * 32, 1)
vocab_majority_chunk_kernel(const uint4* __restrict__ rows, const long long* __restrict__ assign,
                            const long long* __restrict__ chunk_row0,
                            const int* __restrict__ chunk_rows, const int* __restrict__ chunk_node,
                            const int* __restrict__ node_slot, int k,
                            uint32_t* __restrict__ centers, int* __restrict__ sizes,
                            int* __restrict__ slot_counts, int* __restrict__ slot_sizes) {
  __shared__ int s_cnt[kMaxK * kBits];
  __shared__ int s_size[kMaxK];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, tig = lane & 3;
  for (int i = t; i < k * kBits; i += kMajWarps * 32) s_cnt[i] = 0;
  if (t < kMaxK) s_size[t] = 0;
  __syncthreads();
  const long long r0 = chunk_row0[blockIdx.x];
  const long long r_end = r0 + chunk_rows[blockIdx.x];
  MajAcc acc;
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.c[i][e] = 0;
  acc.sz0 = acc.sz1 = 0;
  for (long long r = r0 + static_cast<long long>(warp) * kGroupRows; r < r_end; r += kMajWarps * kGroupRows)
    count_group(rows, assign, r, r_end, k, lane, acc);
#pragma unroll
  for (int w = 0; w < kWords; ++w)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int* c = acc.c[4 * w + q];
      const int b0 = 32 * w + 8 * tig + q, b1 = b0 + 4;
      if (g < k) {
        if (c[0]) atomicAdd(&s_cnt[g * kBits + b0], c[0]);
        if (c[1]) atomicAdd(&s_cnt[g * kBits + b1], c[1]);
      }
      if (g + 8 < k) {
        if (c[2]) atomicAdd(&s_cnt[(g + 8) * kBits + b0], c[2]);
        if (c[3]) atomicAdd(&s_cnt[(g + 8) * kBits + b1], c[3]);
      }
    }
  quad_sizes(acc);
  if (tig == 0) {
    if (g < k && acc.sz0) atomicAdd(&s_size[g], acc.sz0);
    if (g + 8 < k && acc.sz1) atomicAdd(&s_size[g + 8], acc.sz1);
  }
  __syncthreads();
  const int node = chunk_node[blockIdx.x];
  const int slot = node_slot[node];
  const int w = t >> 5, b = t & 31;  // thread t: bit t = bit b of word w
  if (slot < 0) {
    for (int c = 0; c < k; ++c) {
      const unsigned word = __ballot_sync(kFull, 2 * s_cnt[c * kBits + t] >= s_size[c]);
      if (b == 0) centers[(static_cast<long long>(node) * k + c) * kWords + w] = word;
    }
    if (t < k) sizes[node * k + t] = s_size[t];
  } else {
    for (int c = 0; c < k; ++c) {
      const int v = s_cnt[c * kBits + t];
      if (v) atomicAdd(&slot_counts[(static_cast<long long>(slot) * k + c) * kBits + t], v);
    }
    if (t < k && s_size[t]) atomicAdd(&slot_sizes[slot * k + t], s_size[t]);
  }
}

// One block per node of several chunks: pack its summed counts.
__global__ void __launch_bounds__(kBits)
vocab_majority_pack_kernel(const int* __restrict__ slot_counts, const int* __restrict__ slot_sizes,
                           const int* __restrict__ slot_node, int k,
                           uint32_t* __restrict__ centers, int* __restrict__ sizes) {
  const int slot = blockIdx.x, node = slot_node[slot];
  const int t = threadIdx.x, w = t >> 5, b = t & 31;
  for (int c = 0; c < k; ++c) {
    const int s = slot_sizes[slot * k + c];
    const int cnt = slot_counts[(static_cast<long long>(slot) * k + c) * kBits + t];
    const unsigned word = __ballot_sync(kFull, 2 * cnt >= s);
    if (b == 0) centers[(static_cast<long long>(node) * k + c) * kWords + w] = word;
  }
  if (t < k) sizes[node * k + t] = slot_sizes[slot * k + t];
}

// ---------------------------------------------------------------- seed draws

constexpr int kChainWarps = 4;        // nodes per chain block
constexpr int kChainMax = 2048;       // nodes up to it take the chain (SEED_CHAIN_MAX in ops/vocab_kernels.py)
constexpr int kChunk = 32;            // rows of a chunk (a warp's rows)
constexpr int kTileThreads = 256;
constexpr int kTileRowsPerThread = 16;
constexpr int kTile = kTileThreads * kTileRowsPerThread;  // SEED_TILE rows
constexpr int kTileChunks = kTile / kChunk;
constexpr int kNone = -30000;        // Fn.e of the identity (no row with d2 > 0)
constexpr int kBad = 30000;          // Fn.e of a composition across binades (never applied)
constexpr int kNotBinade = -20000;   // classes below: no certain binade
constexpr int kZeroClass = -30001;   // D == 0: c == 0 exactly
constexpr int kUncertain = -30002;   // D / s within the margin of a power of two

// The increment of c / u for either parity of c / u in, and the parity out
// (par bit 0: from even, bit 1: from odd), in binade e.
struct Fn {
  long long inc0, inc1;
  int e, par;
};

// A stretch of rows: the run before its first break (head), the run after
// its last (tail), the first and last break (rows within the node).
struct Seg {
  Fn head, tail;
  int brk, fb, lb;
};
static_assert(sizeof(Seg) == 64, "SEED_SEG_BYTES in ops/vocab_kernels.py");

__device__ __forceinline__ Fn fn_id() { return Fn{0, 0, kNone, 2}; }

__device__ __forceinline__ Fn compose(const Fn& a, const Fn& b) {  // a, then b
  if (a.e == kNone) return b;
  if (b.e == kNone) return a;
  const int p0 = a.par & 1, p1 = a.par >> 1;
  Fn r;
  r.inc0 = a.inc0 + (p0 ? b.inc1 : b.inc0);
  r.inc1 = a.inc1 + (p1 ? b.inc1 : b.inc0);
  r.par = ((b.par >> p0) & 1) | (((b.par >> p1) & 1) << 1);
  r.e = a.e == b.e ? a.e : kBad;
  return r;
}

__device__ __forceinline__ Seg seg_id() { return Seg{fn_id(), fn_id(), 0, 0, 0}; }

__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {  // a, then b
  Seg r;
  if (!a.brk) {
    r.head = compose(a.head, b.head);
    r.tail = b.tail;
    r.brk = b.brk;
    r.fb = b.fb;
    r.lb = b.lb;
  } else {
    r.head = a.head;
    r.brk = 1;
    r.fb = a.fb;
    if (b.brk) {
      r.tail = b.tail;
      r.lb = b.lb;
    } else {
      r.tail = compose(a.tail, b.head);
      r.lb = a.lb;
    }
  }
  return r;
}

// Row i after the rows before it in the same stretch.
__device__ __forceinline__ void seg_push(Seg& s, int i, bool run, const Fn& f) {
  if (run) {
    if (s.brk)
      s.tail = compose(s.tail, f);
    else
      s.head = compose(s.head, f);
    return;
  }
  if (!s.brk) s.fb = i;
  s.brk = 1;
  s.lb = i;
  s.tail = fn_id();
}

__device__ __forceinline__ Fn shfl_fn(const Fn& f, int off) {
  return Fn{__shfl_xor_sync(kFull, f.inc0, off), __shfl_xor_sync(kFull, f.inc1, off),
            __shfl_xor_sync(kFull, f.e, off), __shfl_xor_sync(kFull, f.par, off)};
}

__device__ __forceinline__ Seg shfl_seg(const Seg& s, int off) {
  Seg o;
  o.head = shfl_fn(s.head, off);
  o.tail = shfl_fn(s.tail, off);
  o.brk = __shfl_xor_sync(kFull, s.brk, off);
  o.fb = __shfl_xor_sync(kFull, s.fb, off);
  o.lb = __shfl_xor_sync(kFull, s.lb, off);
  return o;
}

// The stretches of lanes [lane & ~(width - 1), + width) in lane order.
__device__ __forceinline__ Seg warp_combine(Seg s, int lane, int width = 32) {
  for (int off = 1; off < width; off <<= 1) {
    const Seg o = shfl_seg(s, off);
    s = (lane & off) ? combine(o, s) : combine(s, o);
  }
  return s;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// The exclusive prefix of v over the block's threads in order. s_warp: [32].
__device__ __forceinline__ long long block_exclusive_scan(long long v, long long* s_warp) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nw = blockDim.x >> 5;
  const long long incl = warp_inclusive_scan(v, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long x = lane < nw ? s_warp[lane] : 0;
    x = warp_inclusive_scan(x, lane);
    if (lane < nw) s_warp[lane] = x;
  }
  __syncthreads();
  const long long base = warp ? s_warp[warp - 1] : 0;
  __syncthreads();
  return base + incl - v;
}

__device__ __forceinline__ int seed_tiles(long long n) {
  return n > kChainMax ? static_cast<int>((n + kTile - 1) / kTile) : 0;
}

// A node's sum s and the margins of its binade classes.
struct SeedNode {
  double s, inv_s, lo_f, hi_f;
};

__device__ __forceinline__ SeedNode seed_node(long long sum, long long n) {
  const double s = static_cast<double>(sum);  // exact: sum <= 256 * n < 2^53
  // c_i lies within a relative (n + 3) 2^-53 of D_i / s; (n + 64) 2^-51 covers
  // that and the roundings of x and of the two products below with room
  const double delta = static_cast<double>(n + 64) * 4.440892098500626e-16;  // 2^-51
  return SeedNode{s, __ddiv_rn(1.0, s), __dsub_rn(1.0, delta), __dadd_rn(1.0, delta)};
}

// The binade e of c where the prefix is D, if certain; else kZeroClass
// (D == 0, c == 0) or kUncertain.
__device__ __forceinline__ int seed_class(long long D, const SeedNode& nd) {
  if (D == 0) return kZeroClass;
  const double x = __dmul_rn(static_cast<double>(D), nd.inv_s);
  const int elo = static_cast<int>(__double_as_longlong(__dmul_rn(x, nd.lo_f)) >> 52);
  const int ehi = static_cast<int>(__double_as_longlong(__dmul_rn(x, nd.hi_f)) >> 52);
  return elo == ehi ? elo - 1023 : kUncertain;
}

// Row q in binade e (false where q / u reaches 2^52, which a row inside the
// binade cannot).
__device__ __forceinline__ bool row_fn(double q, int e, Fn& f) {
  const double x = __dmul_rn(q, __longlong_as_double(static_cast<long long>(1075 - e) << 52));  // q / u
  if (!(x < 4503599627370496.0)) return false;  // 2^52
  const double ad = floor(x);
  const double fr = __dsub_rn(x, ad);
  const long long a = static_cast<long long>(ad);
  if (fr == 0.5) {  // the tie: to the even multiple of u
    f.inc0 = a + (a & 1);
    f.inc1 = a + ((a + 1) & 1);
    f.par = 0;
  } else {
    const long long inc = a + (fr > 0.5);
    const int p = static_cast<int>(inc & 1);
    f.inc0 = f.inc1 = inc;
    f.par = p | ((p ^ 1) << 1);
  }
  f.e = e;
  return true;
}

__device__ __forceinline__ double seed_q(const double* s_q, int v, double s) {
  return 0 <= v && v <= kMaxDist ? s_q[v] : __ddiv_rn(static_cast<double>(v), s);
}

// The bits of c after the run f; err where c was not in f's binade before
// or after.
__device__ __forceinline__ long long apply_fn(long long cb, const Fn& f, int& err) {
  if (f.e == kNone) return cb;
  const long long ef = static_cast<long long>(f.e) + 1023;
  err |= (f.e == kBad) | ((cb >> 52) != ef);
  cb += (cb & 1) ? f.inc1 : f.inc0;
  err |= (cb >> 52) != ef;
  return cb;
}

__device__ __forceinline__ long long add_bits(long long cb, double q) {
  return __double_as_longlong(__dadd_rn(__longlong_as_double(cb), q));
}

__device__ __forceinline__ bool passes(long long cb, double total, double u) {
  return __ddiv_rn(__longlong_as_double(cb), total) > u;
}

// The tiled scan's bookkeeping (scratch of vocab_seed_draw_launch): each
// node of more than kChainMax rows reserves a contiguous run of tile
// indices (node_first) and a walk index (large_list) with atomics, so a
// node's tiles are in order and nodes in any order; tile_node maps a tile
// back. counts[0] tiles, counts[1] large nodes. All null where the caller
// said no node exceeds kChainMax rows.
struct SeedPlan {
  int* tile_node;
  int* node_first;
  int* large_list;
  int* counts;
};

// One warp per node of at most kChainMax rows: the chain in row order, c at
// each chunk's end kept, the pick found chunk, then row. A larger node's
// warp reserves its tiles in `plan` and leaves (and traps where there is no
// plan: the caller's largest node was wrong).
__global__ void __launch_bounds__(kChainWarps * 32)
vocab_seed_chain_kernel(const int* __restrict__ d2, const long long* __restrict__ offsets,
                        const double* __restrict__ u, int groups, SeedPlan plan,
                        long long* __restrict__ pick, unsigned char* __restrict__ zero) {
  __shared__ double s_q[kChainWarps][kMaxDist + 1];
  __shared__ double s_end[kChainWarps][kChainMax / kChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kChainWarps + warp;
  if (g >= groups) return;  // the whole warp leaves together
  const long long s0 = offsets[g];
  const long long nl = offsets[g + 1] - s0;
  if (nl > kChainMax) {  // the tiles'
    if (plan.counts == nullptr) __trap();
    const int nt = seed_tiles(nl);
    int first = 0;
    if (lane == 0) {
      first = atomicAdd(&plan.counts[0], nt);
      plan.large_list[atomicAdd(&plan.counts[1], 1)] = g;
      plan.node_first[g] = first;
    }
    first = __shfl_sync(kFull, first, 0);
    for (int i = lane; i < nt; i += 32) plan.tile_node[first + i] = g;
    return;
  }
  const int n = static_cast<int>(nl);
  long long sum = 0;
  for (int i = lane; i < n; i += 32) sum += d2[s0 + i];
  sum = warp_sum(sum);
  if (sum == 0) {  // every row coincides with a centre: the caller draws uniformly
    if (lane == 0) {
      zero[g] = 1;
      pick[g] = 0;
    }
    return;
  }
  const double s = static_cast<double>(sum);
  const bool table = n > kMaxDist;  // else a division a row is cheaper than the table
  if (table) {
    for (int v = lane; v <= kMaxDist; v += 32) s_q[warp][v] = __ddiv_rn(static_cast<double>(v), s);
    __syncwarp();
  }
  const int chunks = (n + kChunk - 1) / kChunk;
  // 32 rows a step: each lane loads one d2 (the next step's while this one
  // runs) and makes its p; every lane adds the 32 p's in row order. A lane
  // past the end adds 0.0, which leaves c unchanged.
  double c = 0.0;
  int v = lane < n ? d2[s0 + lane] : 0;
  for (int ch = 0; ch < chunks; ++ch) {
    const int next = (ch + 1) * kChunk + lane;
    const int v_next = next < n ? d2[s0 + next] : 0;
    const double p = table ? seed_q(s_q[warp], v, s) : __ddiv_rn(static_cast<double>(v), s);
#pragma unroll
    for (int t = 0; t < 32; ++t) c = __dadd_rn(c, __shfl_sync(kFull, p, t));  // numpy's cumsum
    if (lane == 0) s_end[warp][ch] = c;
    v = v_next;
  }
  __syncwarp();
  const double total = c, uu = u[g];
  int found = -1;  // the first chunk whose end passes u
  for (int base = 0; base < chunks && found < 0; base += 32) {
    const int ch = base + lane;
    const unsigned m = __ballot_sync(kFull, ch < chunks && __ddiv_rn(s_end[warp][ch], total) > uu);
    if (m) found = base + __ffs(m) - 1;
  }
  long long res = n;  // u >= 1 or NaN: past the end, as searchsorted
  if (found >= 0) {
    double cc = found ? s_end[warp][found - 1] : 0.0;
    const int r = found * kChunk + lane;
    const int vr = r < n ? d2[s0 + r] : 0;
    const double p = table ? seed_q(s_q[warp], vr, s) : __ddiv_rn(static_cast<double>(vr), s);
    double mine = 0.0;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      cc = __dadd_rn(cc, __shfl_sync(kFull, p, t));
      if (t == lane) mine = cc;
    }
    const unsigned m = __ballot_sync(kFull, r < n && __ddiv_rn(mine, total) > uu);
    res = found * kChunk + __ffs(m) - 1;  // m != 0: the chunk's last row passes
  }
  if (lane == 0) {
    pick[g] = res;
    zero[g] = 0;
  }
}

// One block per tile: its rows' sum.
__global__ void __launch_bounds__(kTileThreads)
vocab_seed_tilesum_kernel(const int* __restrict__ d2, const long long* __restrict__ offsets,
                          SeedPlan plan, long long* __restrict__ tile_sum) {
  __shared__ long long s_warp[kTileThreads / 32];
  const int b = blockIdx.x, t = threadIdx.x;
  if (b >= plan.counts[0]) return;
  const int g = plan.tile_node[b];
  const long long r0 = offsets[g] + static_cast<long long>(b - plan.node_first[g]) * kTile;
  const long long r1 = min(offsets[g + 1], r0 + kTile);
  long long sum = 0;
  for (long long i = r0 + t; i < r1; i += kTileThreads) sum += d2[i];
  sum = warp_sum(sum);
  if ((t & 31) == 0) s_warp[t >> 5] = sum;
  __syncthreads();
  if (t == 0) {
    long long total = 0;
    for (int w = 0; w < kTileThreads / 32; ++w) total += s_warp[w];
    tile_sum[b] = total;
  }
}

// A tile's node: its first and last tile, first row and size.
struct TileNode {
  int g, first, last;
  long long row0, n;
};

__device__ __forceinline__ TileNode tile_node_of(int g, const long long* __restrict__ offsets,
                                                 const SeedPlan& plan) {
  TileNode tn;
  tn.g = g;
  tn.row0 = offsets[g];
  tn.n = offsets[g + 1] - tn.row0;
  tn.first = plan.node_first[g];
  tn.last = tn.first + seed_tiles(tn.n) - 1;
  return tn;
}

// The node's rows before its tile j (the prefix D there) and its sum s,
// from its tiles' sums, in every thread of the block. s_pair: [64].
__device__ __forceinline__ void node_sums(const long long* __restrict__ tile_sum, const TileNode& tn,
                                          int j, long long* s_pair, long long& before, long long& sum) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nw = blockDim.x >> 5;
  long long x = 0, y = 0;
  for (int i = t; i <= tn.last - tn.first; i += blockDim.x) {
    const long long v = tile_sum[tn.first + i];
    y += v;
    x += i < j ? v : 0;
  }
  x = warp_sum(x);
  y = warp_sum(y);
  if (lane == 0) {
    s_pair[warp] = x;
    s_pair[32 + warp] = y;
  }
  __syncthreads();
  before = sum = 0;
  for (int w = 0; w < nw; ++w) {
    before += s_pair[w];
    sum += s_pair[32 + w];
  }
  __syncthreads();
}

// The stretch of 16 consecutive rows (d2 in vv, the prefix before them dp,
// the first of them row0 within the node or the walk).
__device__ __forceinline__ Seg fold_rows(const int (&vv)[kTileRowsPerThread], long long dp, int row0,
                                         const SeedNode& nd, const double* s_q) {
  int cp = seed_class(dp, nd);
  Seg acc = seg_id();
#pragma unroll
  for (int r = 0; r < kTileRowsPerThread; ++r) {
    const int v = vv[r];
    if (v == 0) continue;  // c unchanged
    const long long dc = dp + v;
    const int cc = seed_class(dc, nd);
    Fn f;
    const bool run = cp == cc && cc > kNotBinade && row_fn(seed_q(s_q, v, nd.s), cc, f);
    seg_push(acc, row0 + r, run, f);
    dp = dc;
    cp = cc;
  }
  return acc;
}

// One block per tile: its segment (rows stretch of 16 a thread, in order).
__global__ void __launch_bounds__(kTileThreads)
vocab_seed_tile_kernel(const int* __restrict__ d2, const long long* __restrict__ offsets,
                       SeedPlan plan, const long long* __restrict__ tile_sum, Seg* __restrict__ tile_seg) {
  __shared__ int s_d2[kTile + kTile / kTileRowsPerThread];  // row k at k + k / 16: no bank conflicts
  __shared__ double s_q[kMaxDist + 1];
  __shared__ long long s_warp[64];
  __shared__ Seg s_seg[kTileThreads / 32];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (b >= plan.counts[0]) return;
  const TileNode tn = tile_node_of(plan.tile_node[b], offsets, plan);
  long long before, sum;
  node_sums(tile_sum, tn, b - tn.first, s_warp, before, sum);
  if (sum == 0) {  // the walk flags the node
    if (t == 0) tile_seg[b] = seg_id();
    return;
  }
  const SeedNode nd = seed_node(sum, tn.n);
  const int r0 = (b - tn.first) * kTile;  // within the node
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), tn.n - r0));
  for (int v = t; v <= kMaxDist; v += kTileThreads) s_q[v] = __ddiv_rn(static_cast<double>(v), nd.s);
  for (int i = t; i < rows; i += kTileThreads) s_d2[i + i / kTileRowsPerThread] = d2[tn.row0 + r0 + i];
  __syncthreads();
  int vv[kTileRowsPerThread];
  long long mine = 0;
#pragma unroll
  for (int r = 0; r < kTileRowsPerThread; ++r) {
    vv[r] = kTileRowsPerThread * t + r < rows ? s_d2[(kTileRowsPerThread + 1) * t + r] : 0;
    mine += vv[r];
  }
  const long long dp = before + block_exclusive_scan(mine, s_warp);
  Seg acc = fold_rows(vv, dp, r0 + kTileRowsPerThread * t, nd, s_q);
  acc = warp_combine(acc, lane);
  if (lane == 0) s_seg[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    Seg s = lane < kTileThreads / 32 ? s_seg[lane] : seg_id();
    s = warp_combine(s, lane);
    if (lane == 0) tile_seg[b] = s;
  }
}

struct WalkSmem {
  long long cend[kTileChunks], crow[kChunk], scan[64];
  Seg cent[kTileChunks];
  int v[kTile + kTile / kTileRowsPerThread];  // row i at i + i / 16: no bank conflicts
  int hit;
};

__device__ __forceinline__ int walk_row(const WalkSmem& sm, int i) {
  return sm.v[i + i / kTileRowsPerThread];
}

// The block walks rows [ra, ra + len) of a node, len <= kTile (D_a: the
// prefix before ra), from the bits cb (thread 0's): the rows are staged in
// shared memory, every thread folds 16 of them as the tile kernel does, two
// threads make a 32-row chunk's segment, and thread 0 applies the chunks in
// order. With `find`, it also sets *pick_row (every thread's) to the first
// row whose c passes u, or leaves it. Returns thread 0's bits.
__device__ long long walk_chunks(long long cb, int ra, int len, long long d_a,
                                 const int* __restrict__ d2n, const SeedNode& nd, const double* s_q,
                                 bool find, double u, double total, int* pick_row, int& err,
                                 WalkSmem& sm) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int chunks = (len + kChunk - 1) / kChunk;
  for (int i = t; i < kTile; i += kTileThreads) sm.v[i + i / kTileRowsPerThread] = i < len ? d2n[ra + i] : 0;
  __syncthreads();
  int vv[kTileRowsPerThread];
  long long mine = 0;
#pragma unroll
  for (int r = 0; r < kTileRowsPerThread; ++r) {
    vv[r] = sm.v[(kTileRowsPerThread + 1) * t + r];
    mine += vv[r];
  }
  const long long dp = d_a + block_exclusive_scan(mine, sm.scan);
  Seg seg = fold_rows(vv, dp, kTileRowsPerThread * t, nd, s_q);  // rows within the walk
  seg = warp_combine(seg, lane, kChunk / kTileRowsPerThread);
  if ((t & 1) == 0) sm.cent[t >> 1] = seg;
  __syncthreads();
  const long long start = cb;
  if (t == 0) {
    for (int ch = 0; ch < chunks; ++ch) {
      const Seg& e = sm.cent[ch];
      cb = apply_fn(cb, e.head, err);
      if (e.brk) {
        for (int i = e.fb; i <= e.lb; ++i) cb = add_bits(cb, seed_q(s_q, walk_row(sm, i), nd.s));
        cb = apply_fn(cb, e.tail, err);
      }
      sm.cend[ch] = cb;
    }
    sm.hit = chunks;
  }
  __syncthreads();
  if (find) {  // the first chunk whose end passes, then its first row that does
    for (int ch = t; ch < chunks; ch += kTileThreads)
      if (passes(sm.cend[ch], total, u)) {
        atomicMin(&sm.hit, ch);
        break;
      }
    __syncthreads();
    const int ch = sm.hit;
    if (ch < chunks) {
      if (t == 0) {
        long long c = ch ? sm.cend[ch - 1] : start;
        for (int i = 0; i < kChunk; ++i) {
          const int r = ch * kChunk + i;
          if (r < len) c = add_bits(c, seed_q(s_q, walk_row(sm, r), nd.s));
          sm.crow[i] = c;
        }
      }
      __syncthreads();
      if (warp == 0) {
        const unsigned m = __ballot_sync(kFull, ch * kChunk + lane < len && passes(sm.crow[lane], total, u));
        if (lane == 0 && m) sm.hit = ra + ch * kChunk + __ffs(m) - 1;  // m != 0: the chunk's end passes
      }
      __syncthreads();
      *pick_row = sm.hit;
    }
    __syncthreads();
  }
  return cb;
}

// The bits of c after tile j of node tn, from its segment e (block-uniform):
// applied, its short middle stepped by thread 0, or the tile walked again
// in chunks where its breaks lie 32 rows or more apart.
__device__ __forceinline__ long long walk_tile(long long cb, const Seg& e, int j, const TileNode& tn,
                                               const long long* __restrict__ tile_sum,
                                               const int* __restrict__ d2n, const SeedNode& nd,
                                               const double* s_q, int& err, WalkSmem& sm) {
  if (e.brk && e.lb - e.fb >= kChunk) {
    long long before, sum;
    node_sums(tile_sum, tn, j, sm.scan, before, sum);
    return walk_chunks(cb, j * kTile, static_cast<int>(min(static_cast<long long>(kTile), tn.n - j * kTile)),
                       before, d2n, nd, s_q, false, 0.0, 1.0, nullptr, err, sm);
  }
  if (threadIdx.x == 0) {
    cb = apply_fn(cb, e.head, err);
    if (e.brk) {
      for (int i = e.fb; i <= e.lb; ++i) cb = add_bits(cb, seed_q(s_q, d2n[i], nd.s));
      cb = apply_fn(cb, e.tail, err);
    }
  }
  return cb;
}

// The warp's runs in lane order, in every lane.
__device__ __forceinline__ Fn warp_compose(Fn f, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Fn o = shfl_fn(f, off);
    f = (lane & off) ? compose(o, f) : compose(f, o);
  }
  return f;
}

// One block per node of more than kChainMax rows: walk its tiles' segments
// in order from c = 0, 256 at a time: each warp first composes its 32 tiles'
// runs where none of them has a break (a pure group, one apply), and thread
// 0 walks the groups, a mixed group tile by tile. c at each group's end is
// kept (grp_cend), and at each tile's end in a mixed group (tile_cend). The
// pick is in the first group whose end passes u; in its first tile whose end
// does (a pure group's tile ends from a warp scan of its runs); walked in
// chunks there.
__global__ void __launch_bounds__(kTileThreads)
vocab_seed_walk_kernel(const int* __restrict__ d2, const long long* __restrict__ offsets,
                       const double* __restrict__ u, SeedPlan plan,
                       const long long* __restrict__ tile_sum, const Seg* __restrict__ tile_seg,
                       double* __restrict__ tile_cend, double* __restrict__ grp_cend,
                       long long* __restrict__ pick, unsigned char* __restrict__ zero) {
  constexpr int kGroups = kTileThreads / 32;  // groups of 32 tiles a batch
  __shared__ int s_hit, s_tile, s_pure[kGroups];
  __shared__ long long s_bits, s_start;
  __shared__ double s_q[kMaxDist + 1];
  __shared__ Seg s_ent[kTileThreads];
  __shared__ Fn s_grp[kGroups];
  __shared__ WalkSmem sm;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (static_cast<int>(blockIdx.x) >= plan.counts[1]) return;
  const TileNode tn = tile_node_of(plan.large_list[blockIdx.x], offsets, plan);
  long long before, sum;
  node_sums(tile_sum, tn, 0, sm.scan, before, sum);
  if (sum == 0) {
    if (t == 0) {
      zero[tn.g] = 1;
      pick[tn.g] = 0;
    }
    return;
  }
  const SeedNode nd = seed_node(sum, tn.n);
  for (int v = t; v <= kMaxDist; v += kTileThreads) s_q[v] = __ddiv_rn(static_cast<double>(v), nd.s);
  const int* d2n = d2 + tn.row0;
  const int n = static_cast<int>(tn.n), tiles = tn.last - tn.first + 1;
  long long cb = 0;  // the bits of c (thread 0's)
  int err = 0;
  for (int base = 0; base < tiles; base += kTileThreads) {
    const int count = min(kTileThreads, tiles - base);
    __syncthreads();
    if (t < count) s_ent[t] = tile_seg[tn.first + base + t];
    __syncthreads();
    {
      const Seg e = t < count ? s_ent[t] : seg_id();
      const bool pure = !__any_sync(kFull, e.brk);
      const Fn f = warp_compose(e.head, lane);
      if (lane == 0) {
        s_pure[warp] = pure;
        s_grp[warp] = f;
      }
    }
    __syncthreads();
    for (int w = 0; w * 32 < count; ++w) {
      if (s_pure[w]) {
        if (t == 0) cb = apply_fn(cb, s_grp[w], err);
      } else {
        for (int j = 32 * w; j < min(count, 32 * w + 32); ++j) {
          const int tile = base + j;
          cb = walk_tile(cb, s_ent[j], tile, tn, tile_sum, d2n, nd, s_q, err, sm);
          if (t == 0) tile_cend[tn.first + tile] = __longlong_as_double(cb);
        }
      }
      if (t == 0) grp_cend[tn.first + (base >> 5) + w] = __longlong_as_double(cb);
    }
  }
  if (t == 0) {
    s_bits = cb;
    s_hit = INT_MAX;
  }
  __syncthreads();
  const double total = __longlong_as_double(s_bits);
  const double uu = u[tn.g];
  const int groups = (tiles + 31) / 32;
  for (int gi = t; gi < groups; gi += kTileThreads)
    if (__ddiv_rn(grp_cend[tn.first + gi], total) > uu) {
      atomicMin(&s_hit, gi);
      break;
    }
  __syncthreads();
  int row = n;  // u >= 1 or NaN: past the end, as searchsorted
  const int gi = s_hit;
  if (gi < groups) {
    if (warp == 0) {  // the group's first tile whose end passes, and that tile's start
      const long long gstart = gi ? __double_as_longlong(grp_cend[tn.first + gi - 1]) : 0;
      const int tile = 32 * gi + lane;
      const bool in = tile < tiles;
      const Seg e = in ? tile_seg[tn.first + tile] : seg_id();
      long long end;
      if (__any_sync(kFull, e.brk)) {  // a mixed group: its tiles' ends were kept
        end = in ? __double_as_longlong(tile_cend[tn.first + tile]) : s_bits;
      } else {  // a pure group: its runs' prefixes from the group's start
        Fn f = e.head;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          Fn o;
          o.inc0 = __shfl_up_sync(kFull, f.inc0, off);
          o.inc1 = __shfl_up_sync(kFull, f.inc1, off);
          o.e = __shfl_up_sync(kFull, f.e, off);
          o.par = __shfl_up_sync(kFull, f.par, off);
          if (lane >= off) f = compose(o, f);
        }
        int lane_err = 0;
        end = apply_fn(gstart, f, lane_err);
        err |= __any_sync(kFull, lane_err);
      }
      const unsigned m = __ballot_sync(kFull, in && passes(end, total, uu));
      const int j = __ffs(m) - 1;  // m != 0: the group's end passes
      const long long prev = __shfl_sync(kFull, end, j > 0 ? j - 1 : 0);
      if (lane == 0) {
        s_tile = 32 * gi + j;
        s_start = j > 0 ? prev : gstart;
      }
    }
    __syncthreads();
    const int tile = s_tile;
    node_sums(tile_sum, tn, tile, sm.scan, before, sum);
    walk_chunks(s_start, tile * kTile, min(kTile, n - tile * kTile), before, d2n, nd, s_q, true, uu, total,
                &row, err, sm);
  }
  if (t == 0) {
    if (err) __trap();  // a run left its binade: the error bound above was wrong
    pick[tn.g] = row;
    zero[tn.g] = 0;
  }
}

}  // namespace

// rows: [n, 8] words, 16-byte aligned; group: [n] int64 into centers
// [groups, k, 8] words (16-byte aligned), 1 <= k <= 16; outputs idx [n] int64,
// dist [n] int32. Returns cudaGetLastError() after the launch.
extern "C" int vocab_assign_launch(const void* rows, const void* group, const void* centers, int k,
                                   long long n, void* idx, void* dist, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  vocab_assign_kernel<<<static_cast<unsigned>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), static_cast<const long long*>(group),
      static_cast<const uint4*>(centers), k, n, static_cast<long long*>(idx), static_cast<int*>(dist));
  return static_cast<int>(cudaGetLastError());
}

// rows: [n, 8] words, 16-byte aligned; assign: [n] int64 in 0..k-1 (a row
// outside is not counted); offsets [groups + 1] int64: the nodes of at most
// kMajSmallRows rows take a warp each; the chunk plan of the larger nodes
// (chunk_row0 int64, chunk_rows, chunk_node int32, n_chunks of them, a
// node's chunks covering its rows); node_slot [groups] int32 (-1 for a node
// of at most one chunk, else its slot); slot_node [n_slots] int32;
// slot_counts [n_slots, k, 256] and slot_sizes [n_slots, k] int32, zeroed by
// the caller. Outputs centers [groups, k, 8] words and sizes [groups, k]
// int32. Launches the small-node kernel, then the chunk kernel (n_chunks >
// 0) and the pack kernel (n_slots > 0).
extern "C" int vocab_majority_launch(const void* rows, const void* assign, const void* offsets,
                                     int groups, const void* chunk_row0, const void* chunk_rows,
                                     const void* chunk_node, const void* node_slot, int n_chunks,
                                     int k, void* centers, void* sizes, void* slot_counts,
                                     void* slot_sizes, const void* slot_node, int n_slots, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* r = static_cast<const uint4*>(rows);
  const long long* a = static_cast<const long long*>(assign);
  if (groups > 0) {
    vocab_majority_small_kernel<<<(groups + kSmallWarps - 1) / kSmallWarps, kSmallWarps * 32, 0, st>>>(
        static_cast<const uint32_t*>(rows), a, static_cast<const long long*>(offsets), groups, k,
        static_cast<uint32_t*>(centers), static_cast<int*>(sizes));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (n_chunks > 0) {
    vocab_majority_chunk_kernel<<<n_chunks, kMajWarps * 32, 0, st>>>(
        r, a, static_cast<const long long*>(chunk_row0), static_cast<const int*>(chunk_rows),
        static_cast<const int*>(chunk_node), static_cast<const int*>(node_slot), k,
        static_cast<uint32_t*>(centers), static_cast<int*>(sizes), static_cast<int*>(slot_counts),
        static_cast<int*>(slot_sizes));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (n_slots > 0) {
    vocab_majority_pack_kernel<<<n_slots, kBits, 0, st>>>(
        static_cast<const int*>(slot_counts), static_cast<const int*>(slot_sizes),
        static_cast<const int*>(slot_node), k, static_cast<uint32_t*>(centers),
        static_cast<int*>(sizes));
  }
  return static_cast<int>(cudaGetLastError());
}

// d2: [rows] int32 (distances, 0..256: a lookup table; other values >= 0 are
// divided as they come), grouped by node; offsets: [groups + 1] int64; u:
// [groups] float64 in [0, 1); max_rows: the largest node's rows (or more);
// scratch: scratch_bytes (8-byte aligned) of at least
// ops/vocab_kernels.seed_scratch_bytes where max_rows > kChainMax. Outputs
// pick [groups] int64 (index within the node) and zero [groups] bool (1
// where sum d2 == 0). Launches the chain kernel and, where max_rows >
// kChainMax, the tile-sum, tile and walk kernels.
extern "C" int vocab_seed_draw_launch(const void* d2, const void* offsets, const void* u, int groups,
                                      long long rows, long long max_rows, void* scratch,
                                      long long scratch_bytes, void* pick, void* zero, void* stream) {
  if (groups <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* dd = static_cast<const int*>(d2);
  const long long* off = static_cast<const long long*>(offsets);
  const double* uu = static_cast<const double*>(u);
  long long* pk = static_cast<long long*>(pick);
  unsigned char* zr = static_cast<unsigned char*>(zero);
  const unsigned chain_blocks = (groups + kChainWarps - 1) / kChainWarps;
  SeedPlan plan{nullptr, nullptr, nullptr, nullptr};
  if (max_rows <= kChainMax) {  // no node takes tiles
    vocab_seed_chain_kernel<<<chain_blocks, kChainWarps * 32, 0, st>>>(dd, off, uu, groups, plan, pk, zr);
    return static_cast<int>(cudaGetLastError());
  }
  // bounds: a large node has more than kChainMax rows and at most one
  // partial tile
  const long long nl = std::min<long long>(groups, rows / (kChainMax + 1));
  const long long nt = rows / kTile + nl + 1;
  if (scratch_bytes < nt * (3 * 8 + static_cast<long long>(sizeof(Seg)) + 4) + 4LL * (groups + nl) + 8)
    return static_cast<int>(cudaErrorInvalidValue);
  long long* tile_sum = static_cast<long long*>(scratch);
  double* tile_cend = reinterpret_cast<double*>(tile_sum + nt);
  double* grp_cend = tile_cend + nt;
  Seg* tile_seg = reinterpret_cast<Seg*>(grp_cend + nt);
  plan.tile_node = reinterpret_cast<int*>(tile_seg + nt);
  plan.node_first = plan.tile_node + nt;
  plan.large_list = plan.node_first + groups;
  plan.counts = plan.large_list + nl;
  int err = static_cast<int>(cudaMemsetAsync(plan.counts, 0, 2 * sizeof(int), st));
  if (err != 0) return err;
  vocab_seed_chain_kernel<<<chain_blocks, kChainWarps * 32, 0, st>>>(dd, off, uu, groups, plan, pk, zr);
  vocab_seed_tilesum_kernel<<<static_cast<unsigned>(nt), kTileThreads, 0, st>>>(dd, off, plan, tile_sum);
  vocab_seed_tile_kernel<<<static_cast<unsigned>(nt), kTileThreads, 0, st>>>(dd, off, plan, tile_sum,
                                                                              tile_seg);
  vocab_seed_walk_kernel<<<static_cast<unsigned>(nl), kTileThreads, 0, st>>>(
      dd, off, uu, plan, tile_sum, tile_seg, tile_cend, grp_cend, pk, zr);
  return static_cast<int>(cudaGetLastError());
}
