// Motion-only pose solve (ORB-SLAM2's PoseOptimization) in one launch.
//
// Replaces no Pallas kernel: the reference's orb_slam2_2021_tpu/optim/pose.py
// (`pose_optimize`, `make_pose_optimizer`) is an XLA program, 4 rounds of 10
// Levenberg-Marquardt iterations on the 6-DoF pose under jit. Its PyTorch
// twin (optim/pose.py `pose_optimize_plain`) runs them as eager ops on [N]
// tensors, about 265 kernels an iteration and 10.6k a solve; the tracking
// lane runs three solves a frame. This kernel is the same algorithm in one
// launch a solve.
//
// What bounds it on an H100: neither bytes (about 60 KB of observations at
// N = 2,000, read once: 18 ns at 3.35 TB/s) nor operations (about 23 MFLOP:
// 0.35 us at 67 TFLOP/s float32) but the chain of pose_rounds * pose_iters
// dependent iterations, each two reductions over the whole block and a 6x6
// solve that the next iteration waits for: 0.23 ms a solve at N = 2,000 on
// an H100 SXM, about 5.7 us an iteration.
//
// What the design does about it: one block of 512 threads a solve, so every
// dependency is a barrier inside the block and never a kernel boundary.
// Thread i keeps observations i, i + 512, ... (kPer of them, chosen from N at
// launch; N <= 4,096) in registers for the whole solve: after the first read
// the only device-memory traffic is the outputs. An iteration:
//   1. each thread accumulates, over its inlier observations at (R, t), the
//      21 upper-triangle entries of H = sum w G^T G, the 6 of g = sum w G^T r
//      and the robust error: 28 floats (G = d proj / d xi = -J; monocular
//      observations have two rows, the plain version's zeroed third row);
//   2. warp shuffles, then lane j of warp 0 adding entry j of the 16 warps'
//      rows in warp order, reduce them;
//   3. lane 0 forms H + lambda diag(H) + 1e-8 I, solves it for g by LU with
//      partial pivoting (the algorithm of solve_ex), which is -step, takes
//      se3_exp(-step) with so3_exp's small-angle branch, and composes the
//      candidate pose into shared memory;
//   4. each thread sums its inliers' robust error at the candidate, reduced
//      the same way; every thread then adds the 16 warp sums in the same
//      order, so all reach the same accept / reject (and lambda x0.5 / x4)
//      with no further barrier.
// Three barriers an iteration. Between rounds lambda restarts at its initial
// value, the Huber kernel applies in rounds 0 and 1 only, and each thread
// reclassifies its own observations (valid, chi2 <= delta2, in front of the
// camera). No atomics: every sum runs in a fixed order, so the same inputs
// give the same bits on every run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPer = 8;                     // observations a thread holds at most
constexpr int kMaxObs = kThreads * kMaxPer;    // MAX_OBS in optim/pose.py
constexpr int kSums = 28;                      // H (21), g (6), robust error
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Camera {
  float fx, fy, cx, cy, bf;
};

struct Lm {
  float chi2_mono, chi2_stereo, lambda0;
  int rounds, iters;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;  // the warp's sum in lane 0
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// clamp_min(x, 1e-12) that keeps a NaN, as torch.clamp_min does
__device__ __forceinline__ float floor_tiny(float x) { return x < 1e-12f ? 1e-12f : x; }

__device__ __forceinline__ float inv_z(float z) { return 1.0f / (fabsf(z) < 1e-9f ? 1e-9f : z); }

// x_c = R x_w + t
__device__ __forceinline__ void to_camera(const float (&R)[9], const float (&t)[3],
                                          const float (&p)[3], float (&xc)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) xc[i] = R[3 * i] * p[0] + R[3 * i + 1] * p[1] + R[3 * i + 2] * p[2] + t[i];
}

// chi2 of one observation at camera point xc: (u, v, u_r) residuals for a
// stereo observation, (u, v) for a monocular one, scaled by 1 / sigma^2
__device__ __forceinline__ float chi2_at(const Camera& c, const float (&xc)[3], const float (&o)[3],
                                         bool stereo, float is2) {
  const float iz = inv_z(xc[2]);
  const float u = c.fx * xc[0] * iz + c.cx;
  const float v = c.fy * xc[1] * iz + c.cy;
  const float r0 = o[0] - u, r1 = o[1] - v;
  float s = r0 * r0 + r1 * r1;
  if (stereo) {
    const float r2 = o[2] - (u - c.bf * iz);
    s += r2 * r2;
  }
  return s * is2;
}

__device__ __forceinline__ float robust(float chi, float d2, bool huber) {
  if (!huber || chi <= d2) return chi;
  return 2.0f * sqrtf(d2 * floor_tiny(chi)) - d2;
}

// Adds one observation's rows to the 28 sums: H's upper triangle row by row
// (index of (k, l), k <= l: k * (11 - k) / 2 + l), then g, then the error.
__device__ __forceinline__ void accumulate(const Camera& c, const float (&xc)[3], const float (&o)[3],
                                           bool stereo, float is2, float d2, bool huber,
                                           float (&acc)[kSums]) {
  const float x = xc[0], y = xc[1], z = xc[2];
  const float iz = inv_z(z);
  const float iz2 = iz * iz;
  const float u = c.fx * x * iz + c.cx;
  const float v = c.fy * y * iz + c.cy;
  const float r[3] = {o[0] - u, o[1] - v, stereo ? o[2] - (u - c.bf * iz) : 0.0f};
  // d (u, v, u_r) / d x_c times d x_c / d xi = [I | -[x_c]x]
  const float a = c.fx * iz, e = c.fy * iz;
  const float pu = -c.fx * x * iz2, pv = -c.fy * y * iz2;
  const float pr = pu + c.bf * iz2;
  const float G[3][6] = {{a, 0.0f, pu, pu * y, a * z - pu * x, -a * y},
                         {0.0f, e, pv, pv * y - e * z, -pv * x, e * x},
                         {a, 0.0f, pr, pr * y, a * z - pr * x, -a * y}};
  const float chi = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * is2;
  const float wh = (huber && !(chi <= d2)) ? sqrtf(d2 / floor_tiny(chi)) : 1.0f;
  const float w = is2 * wh;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i == 2 && !stereo) break;
    float wg[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) wg[k] = w * G[i][k];
    int idx = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int l = k; l < 6; ++l) acc[idx++] += wg[k] * G[i][l];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[21 + k] += wg[k] * r[i];
  }
  acc[27] += robust(chi, d2, huber);
}

// x = A^-1 y by LU with partial pivoting (the first row of the largest
// |pivot| wins), then back substitution.
__device__ __forceinline__ void solve6(float (&A)[6][6], float (&y)[6], float (&x)[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (fabsf(A[r][c]) > best) {
        best = fabsf(A[r][c]);
        piv = r;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (r == piv) {
#pragma unroll
        for (int j = c; j < 6; ++j) {
          const float s = A[c][j];
          A[c][j] = A[r][j];
          A[r][j] = s;
        }
        const float s = y[c];
        y[c] = y[r];
        y[r] = s;
      }
    }
    const float inv = 1.0f / A[c][c];
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] * inv;
#pragma unroll
      for (int j = c + 1; j < 6; ++j) A[r][j] -= f * A[c][j];
      y[r] -= f * y[c];
    }
  }
#pragma unroll
  for (int c = 5; c >= 0; --c) {
    float s = y[c];
#pragma unroll
    for (int j = c + 1; j < 6; ++j) s -= A[c][j] * x[j];
    x[c] = s / A[c][c];
  }
}

// The LM step from the reduced sums, and the candidate pose
// (dR, dt) o (R, t) with (dR, dt) = se3_exp(xi), written to cand[0..11].
__device__ __forceinline__ void candidate(const float* sums, float lam, const float (&R)[9],
                                          const float (&t)[3], float* cand) {
  float A[6][6], y[6], xi[6];
  int idx = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int l = k; l < 6; ++l) {
      A[k][l] = A[l][k] = sums[idx++];
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    A[k][k] = (A[k][k] + lam * A[k][k]) + 1e-8f;
    y[k] = sums[21 + k];
  }
  // H step = b with b = -g, so -step = H^-1 g exactly (negation commutes
  // with every rounding of the solve)
  solve6(A, y, xi);
  const float v[3] = {xi[0], xi[1], xi[2]};
  const float w[3] = {xi[3], xi[4], xi[5]};
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  float ca, cb, cc;  // so3_exp's a, b and the left Jacobian's c
  if (small) {
    ca = 1.0f - theta2 / 6.0f;
    cb = 0.5f - theta2 / 24.0f;
    cc = 1.0f / 6.0f - theta2 / 120.0f;
  } else {
    const float s = sinf(theta), co = cosf(theta);
    ca = s / theta;
    cb = (1.0f - co) / theta2;
    cc = (theta - s) / (theta2 * theta);
  }
  const float W[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
  float W2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
  }
  float dR[9], dt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float Vrow[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      dR[3 * i + j] = (eye + ca * W[3 * i + j]) + cb * W2[3 * i + j];
      Vrow[j] = (eye + cb * W[3 * i + j]) + cc * W2[3 * i + j];
    }
    dt[i] = Vrow[0] * v[0] + Vrow[1] * v[1] + Vrow[2] * v[2];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      cand[3 * i + j] = dR[3 * i] * R[j] + dR[3 * i + 1] * R[3 + j] + dR[3 * i + 2] * R[6 + j];
    cand[9 + i] = (dR[3 * i] * t[0] + dR[3 * i + 1] * t[1] + dR[3 * i + 2] * t[2]) + dt[i];
  }
}

template <int kPer>
__global__ void __launch_bounds__(kThreads, 1)
pose_lm_kernel(const float* __restrict__ xw, const float* __restrict__ uvr,
               const float* __restrict__ inv_sigma2, const uint8_t* __restrict__ valid,
               const float* __restrict__ R0, const float* __restrict__ t0, int n, Camera cam,
               Lm lm, float* __restrict__ R_out, float* __restrict__ t_out,
               uint8_t* __restrict__ inlier_out, long long* __restrict__ n_out) {
  __shared__ float warp_sums[kWarps][kSums];
  __shared__ float sums[kSums];
  __shared__ float warp_err[kWarps];
  __shared__ float cand[12];
  __shared__ int warp_count[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float p[kPer][3], o[kPer][3], is2[kPer];
  unsigned held = 0, valid_bits = 0, stereo_bits = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = k * kThreads + tid;
    const bool in = i < n;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p[k][j] = in ? xw[3 * i + j] : 0.0f;
      o[k][j] = in ? uvr[3 * i + j] : 0.0f;
    }
    is2[k] = in ? inv_sigma2[i] : 0.0f;
    if (in) {
      held |= 1u << k;
      if (valid[i]) valid_bits |= 1u << k;
      if (o[k][2] >= 0.0f) stereo_bits |= 1u << k;  // u_r < 0: monocular
    }
  }
  unsigned inlier_bits = valid_bits;
  float R[9], t[3];
#pragma unroll
  for (int j = 0; j < 9; ++j) R[j] = R0[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) t[j] = t0[j];

  for (int round = 0; round < lm.rounds; ++round) {
    const bool huber = round < 2;  // the reference drops the kernel in rounds 3-4
    float lam = lm.lambda0;
    for (int it = 0; it < lm.iters; ++it) {
      float acc[kSums];
#pragma unroll
      for (int j = 0; j < kSums; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (inlier_bits >> k & 1u) {
          const bool st = stereo_bits >> k & 1u;
          float xc[3];
          to_camera(R, t, p[k], xc);
          accumulate(cam, xc, o[k], st, is2[k], st ? lm.chi2_stereo : lm.chi2_mono, huber, acc);
        }
      }
#pragma unroll
      for (int j = 0; j < kSums; ++j) {
        const float s = warp_sum(acc[j]);
        if (lane == 0) warp_sums[warp][j] = s;
      }
      __syncthreads();
      if (warp == 0) {
        if (lane < kSums) {
          float s = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s += warp_sums[w][lane];
          sums[lane] = s;
        }
        __syncwarp();
        if (lane == 0) candidate(sums, lam, R, t, cand);
      }
      __syncthreads();
      float Rc[9], tc[3];
#pragma unroll
      for (int j = 0; j < 9; ++j) Rc[j] = cand[j];
#pragma unroll
      for (int j = 0; j < 3; ++j) tc[j] = cand[9 + j];
      float err = 0.0f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (inlier_bits >> k & 1u) {
          const bool st = stereo_bits >> k & 1u;
          float xc[3];
          to_camera(Rc, tc, p[k], xc);
          err += robust(chi2_at(cam, xc, o[k], st, is2[k]), st ? lm.chi2_stereo : lm.chi2_mono, huber);
        }
      }
      err = warp_sum(err);
      if (lane == 0) warp_err[warp] = err;
      __syncthreads();
      float err_new = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) err_new += warp_err[w];
      const bool improved = err_new < sums[27];
      if (improved) {
#pragma unroll
        for (int j = 0; j < 9; ++j) R[j] = Rc[j];
#pragma unroll
        for (int j = 0; j < 3; ++j) t[j] = tc[j];
      }
      lam = improved ? lam * 0.5f : lam * 4.0f;
    }
    // chi2 reclassification at the round's pose
    inlier_bits = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool st = stereo_bits >> k & 1u;
      float xc[3];
      to_camera(R, t, p[k], xc);
      const float chi = chi2_at(cam, xc, o[k], st, is2[k]);
      const bool keep = (valid_bits >> k & 1u) && chi <= (st ? lm.chi2_stereo : lm.chi2_mono) &&
                        !(xc[2] <= 0.0f);
      if (keep) inlier_bits |= 1u << k;
    }
  }

#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (held >> k & 1u) inlier_out[k * kThreads + tid] = (inlier_bits >> k) & 1u;
  }
  const int count = warp_sum(__popc(inlier_bits));
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_count[w];
    *n_out = total;
#pragma unroll
    for (int j = 0; j < 9; ++j) R_out[j] = R[j];
#pragma unroll
    for (int j = 0; j < 3; ++j) t_out[j] = t[j];
  }
}

}  // namespace

// xw, uvr: [n, 3] float32; inv_sigma2: [n] float32; valid: [n] bytes (0/1);
// R0 [3, 3], t0 [3] float32 (device); outputs R [3, 3], t [3] float32,
// inlier [n] bytes, n_inliers one int64. All contiguous, n <= 4,096. One
// launch on `stream`; returns cudaGetLastError() after it.
extern "C" int pose_lm_launch(const void* xw, const void* uvr, const void* inv_sigma2,
                              const void* valid, const void* R0, const void* t0, int n,
                              float fx, float fy, float cx, float cy, float bf,
                              float chi2_mono, float chi2_stereo, float lambda0, int rounds,
                              int iters, void* R, void* t, void* inlier, void* n_inliers,
                              void* stream) {
  if (n < 0 || n > kMaxObs) return static_cast<int>(cudaErrorInvalidValue);
  const Camera cam{fx, fy, cx, cy, bf};
  const Lm lm{chi2_mono, chi2_stereo, lambda0, rounds, iters};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(xw);
  const auto* b = static_cast<const float*>(uvr);
  const auto* s = static_cast<const float*>(inv_sigma2);
  const auto* m = static_cast<const uint8_t*>(valid);
  const auto* r0 = static_cast<const float*>(R0);
  const auto* q0 = static_cast<const float*>(t0);
  auto* r = static_cast<float*>(R);
  auto* q = static_cast<float*>(t);
  auto* in = static_cast<uint8_t*>(inlier);
  auto* cnt = static_cast<long long*>(n_inliers);
  // observations a thread holds: the least power of two that covers n
  if (n <= kThreads)
    pose_lm_kernel<1><<<1, kThreads, 0, st>>>(a, b, s, m, r0, q0, n, cam, lm, r, q, in, cnt);
  else if (n <= 2 * kThreads)
    pose_lm_kernel<2><<<1, kThreads, 0, st>>>(a, b, s, m, r0, q0, n, cam, lm, r, q, in, cnt);
  else if (n <= 4 * kThreads)
    pose_lm_kernel<4><<<1, kThreads, 0, st>>>(a, b, s, m, r0, q0, n, cam, lm, r, q, in, cnt);
  else
    pose_lm_kernel<kMaxPer><<<1, kThreads, 0, st>>>(a, b, s, m, r0, q0, n, cam, lm, r, q, in, cnt);
  return static_cast<int>(cudaGetLastError());
}
