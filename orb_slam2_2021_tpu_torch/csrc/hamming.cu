// Packed-descriptor Hamming distance matrix for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `_hamming_matrix_pallas_padded` in
// orb_slam2_2021_tpu/ops/hamming_pallas.py (and the bit-identical XLA formula
// orb_slam2_2021_tpu/ops/hamming.hamming_matrix). The TPU version unpacks the
// 256 descriptor bits to {0,1} bf16 and gets <bits_a, bits_b> from one MXU
// dot per 128x128 tile; here the card computes the function directly:
// out[n, m] = sum_w popc(a[n, w] ^ b[m, w]) over the 8 32-bit words.
//
// What bounds it on an H100: each output costs 8 XOR + 8 POPC + 8 adds and
// one 2-byte store. POPC issues at 16 results per clock per SM on sm_90, so
// a 4096 x 2000 matrix needs 65.5 M popcounts, about 18 us at 132 SMs and
// ~1.75 GHz, while its 16.4 MB int16 write takes about 5 us at 3.35 TB/s:
// the popcount issue rate is the first bound, the N*M*2-byte write the
// second. Inputs (32 B per descriptor) are negligible traffic.
//
// Design: one thread per output column m holds b[m] in 8 registers; the block
// stages TILE_N rows of A in shared memory (read back as broadcasts, no bank
// conflicts) and walks them, so each thread writes TILE_N outputs and a warp
// stores 64 contiguous bytes of a row per step. Ragged N and M are masked in
// the kernel; nothing is launched when either is 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kThreads = 128;  // output columns per block
constexpr int kTileN = 32;     // output rows per block

__global__ void __launch_bounds__(kThreads)
hamming_matrix_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b,
                      int16_t* __restrict__ out, int n, int m) {
  __shared__ uint4 a_tile[kTileN][2];

  const int row0 = blockIdx.y * kTileN;
  const int col = blockIdx.x * kThreads + threadIdx.x;

  // stage A rows [row0, row0 + kTileN): kTileN * 2 uint4 loads
  for (int i = threadIdx.x; i < kTileN * 2; i += kThreads) {
    const int r = row0 + i / 2;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) v = reinterpret_cast<const uint4*>(a + (size_t)r * kWords)[i % 2];
    a_tile[i / 2][i % 2] = v;
  }
  __syncthreads();
  if (col >= m) return;

  const uint4* bp = reinterpret_cast<const uint4*>(b + (size_t)col * kWords);
  const uint4 b0 = bp[0];
  const uint4 b1 = bp[1];
  const int rows = min(kTileN, n - row0);
  int16_t* o = out + (size_t)row0 * m + col;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const uint4 a0 = a_tile[r][0];
    const uint4 a1 = a_tile[r][1];
    const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                  __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                  __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                  __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
    o[(size_t)r * m] = static_cast<int16_t>(d);
  }
}

}  // namespace

// a: [n, 8] words, b: [m, 8] words (both 16-byte aligned, contiguous);
// out: [n, m] int16. Returns cudaGetLastError() after the launch.
extern "C" int hamming_matrix_launch(const void* a, const void* b, void* out,
                                     int n, int m, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 grid((m + kThreads - 1) / kThreads, (n + kTileN - 1) / kTileN);
  hamming_matrix_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int16_t*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}
