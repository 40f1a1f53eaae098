// The vocabulary builder's kernels: hierarchical binary k-medians over packed
// 256-bit ORB descriptors on Hopper (sm_90a).
//
// The reference trains its tree in host numpy (orb_slam2_2021_tpu/place/
// vocab.py: `_kmeans_binary` :58-94, `_majority_centroid` :51-55, called
// node by node from `train_vocabulary` :139-166). The port runs every node of
// a level at once (place/vocab.py), with the rows of each node contiguous and
// in corpus order, and three kernels:
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
//                           tie rule 2 * count >= size (FORB::meanValue).
//   vocab_seed_draw_launch  per node, the k-means++ pick exactly as numpy's
//                           rng.choice(n, p=d2 / s) makes it from the node's
//                           uniform u: p in IEEE float64, a strictly
//                           left-to-right float64 cumulative sum, cdf /= cdf[-1],
//                           searchsorted(u, side="right"); a flag for s == 0.
//
// What bounds them on an H100 SXM (3.35 TB/s):
//   assign reads each row (32 B) and its group (8 B) once and writes 12 B;
//     the k centres of a group are a few hundred bytes that stay in L1/L2.
//     Bytes bound it; at k = 10 its 80 POPC a row come close behind (POPC
//     runs at 16 a clock per SM). One thread per row, two 16-byte loads,
//     no shared memory.
//   majority reads each row and its cluster (40 B) once and writes 36 B per
//     cluster: bytes. A block takes a chunk of one node's rows (at most
//     MAJORITY_CHUNK of ops/vocab_kernels.py); thread t owns bit t (word
//     t / 32, bit t % 32) and adds it into a shared [k, 256] table, so no
//     two threads touch one counter and no atomics are needed inside a
//     chunk; warp w's ballot of the majority
//     predicate is word w of the centroid. A node of more than one chunk adds
//     its chunks' tables into a global table with integer atomics (exact,
//     order-free) and a second kernel packs it. Integer sums only, so the
//     card and the CPU agree bit for bit.
//   seed_draw is a dependent float64 chain: bytes would allow 4 M rows in
//     under 10 us, but each cumulative sum has to be added in corpus order
//     (a parallel scan rounds differently and moves the pick at bucket
//     edges). A warp takes a node: its lanes sum d2 (integers, exact) and
//     fill a table of the 257 possible p = d / s (d2 is a distance, 0..256);
//     then, 32 rows at a time, each lane loads a row's d2 a step ahead and
//     looks up its p, and the warp adds the 32 p's in order (shuffles; one
//     float64 add a row on the chain), each lane storing its row's cdf;
//     lane 0 binary-searches the cdf. Level 0 is one node with the whole
//     corpus: there the chain's add latency is the kernel's time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;          // 32-bit words per descriptor
constexpr int kMaxK = 16;          // centres per node the kernels take
constexpr int kBits = 256;         // bits per descriptor = threads of a majority block
constexpr int kSeedWarps = 4;      // nodes per seed-draw block
constexpr int kMaxDist = 256;

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

// One block per chunk of one node's rows. A node of one chunk is packed here;
// a node of several adds its counts into the global table of its slot.
__global__ void __launch_bounds__(kBits)
vocab_majority_chunk_kernel(const uint32_t* __restrict__ rows,
                            const long long* __restrict__ assign,
                            const long long* __restrict__ chunk_row0,
                            const int* __restrict__ chunk_rows,
                            const int* __restrict__ chunk_node,
                            const int* __restrict__ node_slot, int k,
                            uint32_t* __restrict__ centers, int* __restrict__ sizes,
                            int* __restrict__ slot_counts, int* __restrict__ slot_sizes) {
  __shared__ int counts[kMaxK * kBits];
  __shared__ int size[kMaxK];
  const int t = threadIdx.x, w = t >> 5, b = t & 31;
  for (int i = t; i < k * kBits; i += kBits) counts[i] = 0;
  if (t < kMaxK) size[t] = 0;
  __syncthreads();
  const long long r0 = chunk_row0[blockIdx.x];
  const int nr = chunk_rows[blockIdx.x];
  for (int i = 0; i < nr; ++i) {
    const long long r = r0 + i;
    const int a = static_cast<int>(assign[r]);
    const uint32_t word = rows[r * kWords + w];
    const bool in = static_cast<unsigned>(a) < static_cast<unsigned>(k);  // else counted nowhere
    counts[(in ? a : 0) * kBits + t] += in ? static_cast<int>((word >> b) & 1u) : 0;  // column t: thread t's
    if (t == 0) size[in ? a : 0] += in;
  }
  __syncthreads();
  const int node = chunk_node[blockIdx.x];
  const int slot = node_slot[node];
  if (slot < 0) {
    for (int c = 0; c < k; ++c) {
      const unsigned word = __ballot_sync(0xffffffffu, 2 * counts[c * kBits + t] >= size[c]);
      if (b == 0) centers[(static_cast<long long>(node) * k + c) * kWords + w] = word;
    }
    if (t < k) sizes[node * k + t] = size[t];
  } else {
    for (int c = 0; c < k; ++c)
      atomicAdd(&slot_counts[(static_cast<long long>(slot) * k + c) * kBits + t], counts[c * kBits + t]);
    if (t < k) atomicAdd(&slot_sizes[slot * k + t], size[t]);
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
    const unsigned word = __ballot_sync(0xffffffffu, 2 * cnt >= s);
    if (b == 0) centers[(static_cast<long long>(node) * k + c) * kWords + w] = word;
  }
  if (t < k) sizes[node * k + t] = slot_sizes[slot * k + t];
}

// One warp per node g (rows offsets[g] .. offsets[g+1] of d2).
__global__ void vocab_seed_draw_kernel(const int* __restrict__ d2,
                                       const long long* __restrict__ offsets,
                                       const double* __restrict__ u, int groups,
                                       double* __restrict__ cdf, long long* __restrict__ pick,
                                       int* __restrict__ zero) {
  __shared__ double q[kSeedWarps][kMaxDist + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kSeedWarps + warp;
  if (g >= groups) return;  // the whole warp leaves together
  const long long s0 = offsets[g], s1 = offsets[g + 1];
  long long sum = 0;
  for (long long i = s0 + lane; i < s1; i += 32) sum += d2[i];
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  sum = __shfl_sync(0xffffffffu, sum, 0);
  if (sum == 0) {  // every row coincides with a centre: the caller draws uniformly
    if (lane == 0) {
      zero[g] = 1;
      pick[g] = 0;
    }
    return;
  }
  const double s = static_cast<double>(sum);  // exact: sum <= 256 * rows < 2^53
  for (int v = lane; v <= kMaxDist; v += 32) q[warp][v] = __ddiv_rn(static_cast<double>(v), s);
  __syncwarp();
  // 32 rows a step: each lane loads one d2 (the next step's while this one
  // runs) and looks up its p; every lane then adds the 32 p's in row order,
  // so the sum is warp-uniform, and keeps the cdf of its own row. A lane
  // past the node's end adds q[0] = 0.0, which leaves the sum unchanged.
  double c = 0.0;
  int v = s0 + lane < s1 ? d2[s0 + lane] : 0;
  for (long long i0 = s0; i0 < s1; i0 += 32) {
    const long long next = i0 + 32 + lane;
    const int v_next = next < s1 ? d2[next] : 0;
    const double p = 0 <= v && v <= kMaxDist ? q[warp][v] : __ddiv_rn(static_cast<double>(v), s);
    double mine = 0.0;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      c = __dadd_rn(c, __shfl_sync(0xffffffffu, p, t));  // numpy's cumsum: strictly left to right
      if (t == lane) mine = c;
    }
    if (i0 + lane < s1) cdf[i0 + lane] = mine;
    v = v_next;
  }
  __syncwarp();
  if (lane != 0) return;
  const double total = c, uu = u[g];
  long long lo = s0, hi = s1;  // first i with cdf[i] / total > u (cdf is nondecreasing)
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (__ddiv_rn(cdf[mid], total) <= uu)
      lo = mid + 1;
    else
      hi = mid;
  }
  pick[g] = lo - s0;
  zero[g] = 0;
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

// rows: [n, 8] words; assign: [n] int64 in 0..k-1 (a row outside is not
// counted); the chunk plan (chunk_row0
// int64, chunk_rows, chunk_node int32, n_chunks of them, every node at least
// one, a node's chunks covering its rows); node_slot [groups] int32 (-1 for a
// node of one chunk, else its slot); slot_node [n_slots] int32; slot_counts
// [n_slots, k, 256] and slot_sizes [n_slots, k] int32, zeroed by the caller.
// Outputs centers [groups, k, 8] words and sizes [groups, k] int32.
extern "C" int vocab_majority_launch(const void* rows, const void* assign, const void* chunk_row0,
                                     const void* chunk_rows, const void* chunk_node,
                                     const void* node_slot, int n_chunks, int k, void* centers,
                                     void* sizes, void* slot_counts, void* slot_sizes,
                                     const void* slot_node, int n_slots, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    vocab_majority_chunk_kernel<<<n_chunks, kBits, 0, st>>>(
        static_cast<const uint32_t*>(rows), static_cast<const long long*>(assign),
        static_cast<const long long*>(chunk_row0), static_cast<const int*>(chunk_rows),
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

// d2: [n] int32 (distances, 0..256: a lookup table; other values are
// divided as they come), grouped by node; offsets: [groups + 1] int64; u:
// [groups] float64 in [0, 1); cdf: [n] float64 scratch. Outputs pick [groups]
// int64 (index within the node) and zero [groups] int32 (1 where sum d2 == 0).
extern "C" int vocab_seed_draw_launch(const void* d2, const void* offsets, const void* u,
                                      int groups, void* cdf, void* pick, void* zero,
                                      void* stream) {
  if (groups <= 0) return 0;
  const int blocks = (groups + kSeedWarps - 1) / kSeedWarps;
  vocab_seed_draw_kernel<<<blocks, kSeedWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(d2), static_cast<const long long*>(offsets),
      static_cast<const double*>(u), groups, static_cast<double*>(cdf),
      static_cast<long long*>(pick), static_cast<int*>(zero));
  return static_cast<int>(cudaGetLastError());
}
