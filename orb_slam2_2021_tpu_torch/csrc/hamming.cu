// Packed-descriptor Hamming distances on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel in orb_slam2_2021_tpu/ops/hamming_pallas.py:37-92
// (`_kernel`, `_hamming_matrix_pallas_padded`, `hamming_matrix_pallas`; the
// bit-identical XLA formula is orb_slam2_2021_tpu/ops/hamming.hamming_matrix).
// Like the TPU kernel it uses the exact integer identity
//
//     hamming(a, b) = popc(a) + popc(b) - 2 * <bits_a, bits_b>,
//
// with the products on the tensor cores.
//
// One tile engine, two launchers:
//   hamming_matrix_launch  [N,8] x [M,8] -> [N,M] int16, the counterpart of
//                          hamming_matrix_pallas;
//   hamming_best2_launch   [N,8] x [(T,)M,8] and a [(T,)N,M] bool mask ->
//                          per row the first-occurrence best and second-best
//                          (index, distance) of where(mask, dist, 256); the
//                          [N,M] matrix never reaches device memory.
//
// What bounds them on an H100 SXM (3.35 TB/s, 1,979 TOP/s int8): the matrix
// launcher must write N*M*2 bytes (16.4 MB, 4.9 us at 4096x2000) against
// 2*N*M*256 int8 operations (4.2 G, 2.1 us): the output write bounds it. The
// fused launcher writes 20 bytes per row and must read the N*M mask bytes
// (8.2 MB, 2.5 us at 4096x2000; 40 MB, 12 us at T=10, 2000x2000): the mask
// read bounds it, the products come close behind.
//
// Why the earlier design (one output per thread, 8 XOR + 8 __popc) could not
// reach the write bound: POPC issues at 16 results per clock per SM, so the
// 65.5 M popcounts of a 4096x2000 matrix take ~16 us on 132 SMs at ~1.98 GHz,
// three times the write, and each thread stored 2 bytes at a time.
//
// Tile engine. A warp owns 32 rows (two m16 tiles) and walks 16 columns at a
// time; the packed tiles sit in shared memory (48-byte row stride, no bank
// conflicts). `dist16` returns the distances themselves from the 1-bit
// `mma.sync m16n8k256 .b1 .and.popc`, which reads the packed words as they
// are. Two products into one accumulator give the identity's two terms,
// popc(a) - <a,b> = popc(a AND NOT b) and popc(b) - <a,b> = popc(NOT a AND b),
// so the accumulator holds popc(a) + popc(b) - 2 <a,b>, exact in s32 (sm_90
// has no native .xor.popc: ptxas lowers it to the same two products plus
// adds). An int8 engine (`mma m16n8k32 .s8` on {0,1} bytes unpacked in
// registers, popc(a), popc(b) from 8 POPC per row) ran both launchers 1.5-2x
// slower on an H100 (PERF.md), hence the 1-bit products.
//
// The matrix launcher stages its 128x128 int16 tile in shared memory and
// writes each row with 16-byte stores.
//
// The fused launcher ranks entries by keys: the lexicographic order of
// (distance, column) is the unsigned order of (d << bits | column), so the
// first occurrence wins ties; masked entries carry distance 256, columns
// past M no key at all. A block of 128 rows walks one slice of the columns
// in 128-column chunks, loading the next chunk of B and the mask into
// registers while it works on this one. Within a chunk a key fits 16 bits
// (d << 7 | column in chunk), so each register holds two columns' keys and
// the running best two take three 16x2 min/max instructions per pair of
// entries; at the chunk's end they become 32-bit keys (d << 22 | column) and
// join the row's running best two. A second, one-thread-per-row pass merges
// the slices. No atomics: the result is the same on every run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;                 // 32-bit words per descriptor
constexpr int kRowWords = 12;             // packed row stride in shared memory
constexpr int kIdxBits = 22;              // column bits of a 32-bit key
constexpr uint32_t kIdxMask = (1u << kIdxBits) - 1u;
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // above every real key
constexpr uint32_t kMaxDist = 256;        // a masked entry's distance

// ---------------------------------------------------------------- tile engine

// c += popc(a AND b) over k = 256, per entry of a 16x8 tile.
__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of a warp's 32 rows, a and NOT a: x[m-tile][a, NOT a].
// Fragment layout of m16n8k256 (.b1), packed words: a0 = word tig of row g,
// a1 of row g+8, a2/a3 word tig+4; b0/b1 = words tig, tig+4 of column g;
// c0,c1 = row g, c2,c3 = row g+8, columns 2*tig, 2*tig+1.
struct AFrags {
  uint32_t x[2][2][4];
};

__device__ __forceinline__ void load_a(AFrags& f, const uint32_t* sA, int r0, int g, int tig) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const uint32_t* lo = sA + (r0 + mt * 16 + g) * kRowWords;
    const uint32_t* hi = lo + 8 * kRowWords;
    const uint32_t w[4] = {lo[tig], hi[tig], lo[tig + 4], hi[tig + 4]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f.x[mt][0][e] = w[e];
      f.x[mt][1][e] = ~w[e];
    }
  }
}

// Distances of the warp's 32 rows against columns [c, c + 16) of the staged
// B tile: d[m-tile][n-tile][reg].
__device__ __forceinline__ void dist16(int (&d)[2][2][4], const AFrags& f, const uint32_t* sB,
                                       int c, int g, int tig) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint32_t* row = sB + (c + q * 8 + g) * kRowWords;
    const uint32_t b0 = row[tig], b1 = row[tig + 4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[mt][q][e] = 0;
      mma_b1(d[mt][q], f.x[mt][0], ~b0, ~b1);  // popc(a AND NOT b)
      mma_b1(d[mt][q], f.x[mt][1], b0, b1);    // + popc(NOT a AND b)
    }
  }
}

// One packed descriptor row (two 16-byte loads), zero past the end.
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p, int row,
                                         int rows, uint4& v0, uint4& v1) {
  v0 = make_uint4(0u, 0u, 0u, 0u);
  v1 = v0;
  if (row < rows) {
    const uint4* q = reinterpret_cast<const uint4*>(p + (size_t)row * kWords);
    v0 = q[0];
    v1 = q[1];
  }
}

// Stage a row in shared memory.
__device__ __forceinline__ void store_row(uint32_t* s, const uint4& v0, const uint4& v1) {
  reinterpret_cast<uint4*>(s)[0] = v0;
  reinterpret_cast<uint4*>(s)[1] = v1;
}

// ------------------------------------------------------------ matrix launcher

constexpr int kMatTile = 128;             // rows and columns of a block's tile
constexpr int kMatThreads = 256;          // 8 warps: 4 along rows x 2 along columns
constexpr int kOutStride = kMatTile + 8;  // int16 per staged output row (272 B)

struct MatSmem {
  uint32_t a[kMatTile * kRowWords];
  uint32_t b[kMatTile * kRowWords];
  int16_t out[kMatTile * kOutStride];
};

__global__ void __launch_bounds__(kMatThreads)
hamming_matrix_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      int16_t* __restrict__ out, int n, int m) {
  extern __shared__ uint4 smem_raw[];
  MatSmem& s = *reinterpret_cast<MatSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kMatTile;
  const int col0 = blockIdx.x * kMatTile;

  {  // threads 0..127 stage A rows, 128..255 B rows
    const bool is_a = tid < kMatTile;
    const int r = tid & (kMatTile - 1);
    uint4 v0, v1;
    load_row(is_a ? a : b, (is_a ? row0 : col0) + r, is_a ? n : m, v0, v1);
    store_row((is_a ? s.a : s.b) + r * kRowWords, v0, v1);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = (warp & 3) * 32;   // warp's first row in the tile
  const int wc = (warp >> 2) * 64;  // warp's first column in the tile
  AFrags f;
  load_a(f, s.a, wr, g, tig);

#pragma unroll 2
  for (int c = wc; c < wc + 64; c += 16) {
    int d[2][2][4];
    dist16(d, f, s.b, c, g, tig);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int cl = c + q * 8 + 2 * tig;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(&s.out[(wr + mt * 16 + g + 8 * h) * kOutStride + cl]) =
              __byte_perm(d[mt][q][2 * h], d[mt][q][2 * h + 1], 0x5410);
    }
  }
  __syncthreads();

  const int rows = min(kMatTile, n - row0);
  const int cols = min(kMatTile, m - col0);
  if ((m & 7) == 0) {  // rows start 16-byte aligned: 16-byte stores
    for (int i = tid; i < kMatTile * (kMatTile / 8); i += kMatThreads) {
      const int r = i >> 4, q = (i & 15) * 8;
      if (r < rows && q < cols)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * m + col0 + q) =
            *reinterpret_cast<const uint4*>(&s.out[r * kOutStride + q]);
    }
  } else {
    for (int i = tid; i < kMatTile * kMatTile; i += kMatThreads) {
      const int r = i >> 7, q = i & (kMatTile - 1);
      if (r < rows && q < cols) out[(size_t)(row0 + r) * m + col0 + q] = s.out[r * kOutStride + q];
    }
  }
}

// ------------------------------------------------------------- best-two launcher

constexpr int kFRows = 128;               // rows per block: 4 warps of 32
constexpr int kFCols = 128;               // columns per chunk of the walk
constexpr int kFThreads = 128;
constexpr int kMaskStride = kFCols + 16;  // bytes per staged mask row (144 B)
constexpr int kMaskLoads = kFRows * kFCols / 16 / kFThreads;  // 16-byte loads a thread
constexpr int kColBits = 7;               // column-in-chunk bits of a 16-bit key
constexpr uint32_t kNoKey16 = 0xFFFFu;    // above every real 16-bit key

struct Best2Smem {
  uint32_t a[kFRows * kRowWords];
  uint32_t b[kFCols * kRowWords];
  uint8_t mask[kFRows * kMaskStride];  // 0x00 masked, 0xFF open
};

__device__ __forceinline__ void merge_keys(uint32_t& k1, uint32_t& k2, uint32_t o1, uint32_t o2) {
  k2 = min(max(k1, o1), min(k2, o2));
  k1 = min(k1, o1);
}

// A 16-bit chunk key (d << kColBits | column in chunk) as a 32-bit key.
__device__ __forceinline__ uint32_t widen_key(uint32_t key16, int col0) {
  return key16 == kNoKey16 ? kNoKey
                           : ((key16 >> kColBits) << kIdxBits) |
                                 (uint32_t)(col0 + (key16 & ((1u << kColBits) - 1u)));
}

// One chunk's B rows and mask tile, in registers between its load and its
// store to shared memory (the next chunk loads while this one is computed).
struct Chunk {
  uint4 b0, b1;
  uint4 mk[kMaskLoads];
};

// Mask bytes past row n or column m load as 0 (masked). A mask whose rows
// are not 16-byte aligned is read byte by byte.
__device__ __forceinline__ void load_chunk(Chunk& ch, const uint32_t* __restrict__ b,
                                           const uint8_t* __restrict__ mask, int tid,
                                           int row0, int col0, int n, int m, bool vec) {
  load_row(b, col0 + tid, m, ch.b0, ch.b1);
#pragma unroll
  for (int j = 0; j < kMaskLoads; ++j) {
    const int i = tid + j * kFThreads;
    const int r = row0 + i / (kFCols / 16), c = col0 + (i % (kFCols / 16)) * 16;
    const bool in = r < n && c < m;
    const uint8_t* p = mask + (in ? (size_t)r * m + c : 0);
    if (vec) {
      ch.mk[j] = in ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      const int e = in ? min(16, m - c) : 0;
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (u < e) w[u >> 2] |= (uint32_t)p[u] << (8 * (u & 3));
      ch.mk[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__global__ void __launch_bounds__(kFThreads)
hamming_best2_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                     const uint8_t* __restrict__ mask, uint2* __restrict__ part,
                     int n, int m, int chunks_per_slice, int vec_mask) {
  extern __shared__ uint4 smem_raw[];
  Best2Smem& s = *reinterpret_cast<Best2Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int t = blockIdx.z, slice = blockIdx.y, slices = gridDim.y;
  const int row0 = blockIdx.x * kFRows;
  b += (size_t)t * m * kWords;
  mask += (size_t)t * n * m;
  const bool vec = vec_mask != 0;

  const int c_begin = slice * chunks_per_slice;
  const int c_end = min(c_begin + chunks_per_slice, (m + kFCols - 1) / kFCols);

  {
    uint4 v0, v1;
    load_row(a, row0 + tid, n, v0, v1);
    store_row(s.a + tid * kRowWords, v0, v1);
  }
  Chunk ch;
  if (c_begin < c_end) load_chunk(ch, b, mask, tid, row0, c_begin * kFCols, n, m, vec);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 32;  // warp's first row in the block; it walks all columns
  AFrags f;
  load_a(f, s.a, wr, g, tig);
  uint32_t k1[2][2], k2[2][2];  // the row's running best two, 32-bit keys
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      k1[mt][h] = kNoKey;
      k2[mt][h] = kNoKey;
    }

#pragma unroll 1
  for (int cc = c_begin; cc < c_end; ++cc) {
    const int col0 = cc * kFCols;
    __syncthreads();  // the previous chunk's readers are done
    store_row(s.b + tid * kRowWords, ch.b0, ch.b1);
#pragma unroll
    for (int j = 0; j < kMaskLoads; ++j) {
      const int i = tid + j * kFThreads;
      uint4 v = ch.mk[j];  // bool bytes 0/1 -> 0x00/0xFF, a select mask per byte
      v.x *= 0xFFu;
      v.y *= 0xFFu;
      v.z *= 0xFFu;
      v.w *= 0xFFu;
      *reinterpret_cast<uint4*>(&s.mask[(i / (kFCols / 16)) * kMaskStride + (i % (kFCols / 16)) * 16]) = v;
    }
    __syncthreads();
    if (cc + 1 < c_end) load_chunk(ch, b, mask, tid, row0, col0 + kFCols, n, m, vec);

    // the chunk's best two per row and column parity: two 16-bit keys a register
    uint32_t h1[2][2], h2[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) h1[mt][h] = h2[mt][h] = 0xFFFFFFFFu;

#pragma unroll 2
    for (int c = 0; c < kFCols; c += 16) {
      int d[2][2][4];
      dist16(d, f, s.b, c, g, tig);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int cl = c + q * 8 + 2 * tig;  // even
        const uint32_t cols = (uint32_t)cl | ((uint32_t)(cl + 1) << 16);
        // a masked entry's key is 256 << kColBits | column, a column past m
        // has none (its mask bytes are 0)
        const uint32_t masked =
            (col0 + cl < m ? (kMaxDist << kColBits) | (uint32_t)cl : kNoKey16) |
            ((col0 + cl + 1 < m ? (kMaxDist << kColBits) | (uint32_t)(cl + 1) : kNoKey16) << 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rl = wr + mt * 16 + g + 8 * h;
            const uint32_t open = __byte_perm(
                *reinterpret_cast<const uint16_t*>(&s.mask[rl * kMaskStride + cl]), 0, 0x1100);
            // d <= 256: d << kColBits stays inside its 16-bit lane
            const uint32_t keys =
                __byte_perm(d[mt][q][2 * h], d[mt][q][2 * h + 1], 0x5410) * (1u << kColBits) + cols;
            const uint32_t x = (keys & open) | (masked & ~open);
            h2[mt][h] = __vminu2(h2[mt][h], __vmaxu2(h1[mt][h], x));
            h1[mt][h] = __vminu2(h1[mt][h], x);
          }
      }
    }
    // merge the two column parities, widen, and join the row's best two
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t s1 = __byte_perm(h1[mt][h], 0, 0x1032), s2 = __byte_perm(h2[mt][h], 0, 0x1032);
        const uint32_t c1 = __vminu2(h1[mt][h], s1);
        const uint32_t c2 = __vminu2(__vmaxu2(h1[mt][h], s1), __vminu2(h2[mt][h], s2));
        merge_keys(k1[mt][h], k2[mt][h], widen_key(c1 & 0xFFFFu, col0), widen_key(c2 & 0xFFFFu, col0));
      }
  }

  // the quad's four lanes hold disjoint columns of the same rows
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const uint32_t o1 = __shfl_xor_sync(0xFFFFFFFFu, k1[mt][h], off);
        const uint32_t o2 = __shfl_xor_sync(0xFFFFFFFFu, k2[mt][h], off);
        merge_keys(k1[mt][h], k2[mt][h], o1, o2);
      }
      const int r = row0 + wr + mt * 16 + g + 8 * h;
      if (tig == 0 && r < n)
        part[((size_t)t * slices + slice) * n + r] = make_uint2(k1[mt][h], k2[mt][h]);
    }
}

// One thread per (t, row): merge the slices' best two and decode the keys.
__global__ void hamming_best2_merge(const uint2* __restrict__ part, long long* __restrict__ best_idx,
                                    int16_t* __restrict__ best, long long* __restrict__ second_idx,
                                    int16_t* __restrict__ second, int n, int rows, int slices) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int t = i / n, r = i - t * n;
  uint32_t k1 = kNoKey, k2 = kNoKey;
  for (int sl = 0; sl < slices; ++sl) {
    const uint2 o = part[((size_t)t * slices + sl) * n + r];
    merge_keys(k1, k2, o.x, o.y);
  }
  if (k2 == kNoKey) k2 = k1;  // M == 1: the second is the best itself
  best_idx[i] = k1 & kIdxMask;
  best[i] = static_cast<int16_t>(k1 >> kIdxBits);
  second_idx[i] = k2 & kIdxMask;
  second[i] = static_cast<int16_t>(k2 >> kIdxBits);
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// a: [n, 8] words, b: [m, 8] words (both 16-byte aligned, contiguous);
// out: [n, m] int16. Returns cudaGetLastError() after the launch.
extern "C" int hamming_matrix_launch(const void* a, const void* b, void* out,
                                     int n, int m, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const int smem = static_cast<int>(sizeof(MatSmem));
  static const int attr = set_smem(reinterpret_cast<const void*>(hamming_matrix_kernel), smem);
  if (attr != 0) return attr;
  const dim3 grid((m + kMatTile - 1) / kMatTile, (n + kMatTile - 1) / kMatTile);
  hamming_matrix_kernel<<<grid, kMatThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int16_t*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

// a: [n, 8] words; b: [t, m, 8] words (16-byte aligned, contiguous); mask:
// [t, n, m] bytes (0 = masked), contiguous; part: scratch of t * slices * n
// uint2; outputs [t, n]: best_idx, second_idx int64, best, second int16.
// m < 2^22. Returns cudaGetLastError() after the launches.
extern "C" int hamming_best2_launch(const void* a, const void* b, const void* mask, void* part,
                                    void* best_idx, void* best, void* second_idx, void* second,
                                    int n, int m, int t, int slices, void* stream) {
  if (n <= 0 || m <= 0 || t <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(sizeof(Best2Smem));
  static const int attr = set_smem(reinterpret_cast<const void*>(hamming_best2_kernel), smem);
  if (attr != 0) return attr;
  const int n_chunks = (m + kFCols - 1) / kFCols;
  const int per_slice = (n_chunks + slices - 1) / slices;
  const int vec = (m % 16 == 0) && (reinterpret_cast<uintptr_t>(mask) % 16 == 0);
  const dim3 grid((n + kFRows - 1) / kFRows, slices, t);
  hamming_best2_kernel<<<grid, kFThreads, smem, st>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint8_t*>(mask), static_cast<uint2*>(part), n, m, per_slice, vec);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int rows = n * t;
  hamming_best2_merge<<<(rows + 255) / 256, 256, 0, st>>>(
      static_cast<const uint2*>(part), static_cast<long long*>(best_idx),
      static_cast<int16_t*>(best), static_cast<long long*>(second_idx),
      static_cast<int16_t*>(second), n, rows, slices);
  return static_cast<int>(cudaGetLastError());
}
