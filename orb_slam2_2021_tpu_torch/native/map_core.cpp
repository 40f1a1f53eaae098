// Native map-store kernels (C ABI, loaded via ctypes).
//
// The reference's map bookkeeping is C++ throughout (KeyFrame.cc,
// MapPoint.cc); our map is flat numpy arrays and most updates are vectorized,
// but three host paths are inherently loopy and dominate keyframe insertion:
//   1. binding ~2000 feature->point observations (MapPoint::AddObservation,
//      MapPoint.cc:128-139 semantics incl. the stereo-counts-2 rule),
//   2. per-point statistics refresh: viewing normal, scale band, and the
//      distinctive descriptor = min-median-Hamming over observations
//      (MapPoint::UpdateNormalAndDepth :360-401,
//       ComputeDistinctiveDescriptors :272-337),
//   3. covisibility weight recount for a keyframe
//      (KeyFrame::UpdateConnections, KeyFrame.cc:304-395).
//
// Build: g++ -O3 -march=native -shared -fPIC map_core.cpp -o libmapcore.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// 1. batch observation binding for a new keyframe
//    returns number of observations added
// ---------------------------------------------------------------------------
int64_t batch_add_observations(
    int64_t kf,                 // keyframe id
    const int64_t* mp_bind,     // [N] feature -> map point id (-1 none)
    const float* kf_ur,         // [N] right-eye coords (>=0 -> stereo)
    int64_t n_feats,
    int64_t* mp_obs_kf,         // [M, O]
    int32_t* mp_obs_feat,       // [M, O]
    int32_t* mp_obs_n,          // [M]
    int32_t* mp_n_obs,          // [M]
    int64_t obs_cap)
{
    int64_t added = 0;
    for (int64_t f = 0; f < n_feats; ++f) {
        int64_t m = mp_bind[f];
        if (m < 0) continue;
        int32_t n = mp_obs_n[m];
        if (n >= obs_cap) continue;
        bool dup = false;
        int64_t* row = mp_obs_kf + m * obs_cap;
        for (int32_t i = 0; i < n; ++i) {
            if (row[i] == kf) { dup = true; break; }
        }
        if (dup) continue;
        row[n] = kf;
        mp_obs_feat[m * obs_cap + n] = (int32_t)f;
        mp_obs_n[m] = n + 1;
        mp_n_obs[m] += (kf_ur[f] >= 0.f) ? 2 : 1;
        ++added;
    }
    return added;
}

// ---------------------------------------------------------------------------
// 2. per-point statistics refresh
// ---------------------------------------------------------------------------
static inline int popcount64(uint64_t x) { return __builtin_popcountll(x); }

void update_point_stats(
    const int64_t* ids, int64_t n_ids,         // unique live point ids
    const float* mp_pos,                       // [M, 3]
    const int64_t* mp_obs_kf,                  // [M, O]
    const int32_t* mp_obs_feat,                // [M, O]
    const int32_t* mp_obs_n,                   // [M]
    int64_t obs_cap,
    const float* kf_R,                         // [K, 3, 3] (Tcw)
    const float* kf_t,                         // [K, 3]
    const uint32_t* kf_desc,                   // [K, N, 8]
    const int32_t* kf_octave,                  // [K, N]
    int64_t n_feats,
    const float* scale_factors, int32_t n_levels,
    float* mp_normal,                          // [M, 3] out
    float* mp_min_dist, float* mp_max_dist,    // [M] out
    uint32_t* mp_desc)                         // [M, 8] out
{
    const int64_t MAXO = obs_cap;
    for (int64_t ii = 0; ii < n_ids; ++ii) {
        int64_t m = ids[ii];
        int32_t n = mp_obs_n[m];
        if (n <= 0) continue;
        const int64_t* okf = mp_obs_kf + m * MAXO;
        const int32_t* ofe = mp_obs_feat + m * MAXO;
        const float* p = mp_pos + m * 3;

        // viewing normal: mean of unit vectors camera-center -> point
        double nx = 0, ny = 0, nz = 0;
        for (int32_t i = 0; i < n; ++i) {
            int64_t k = okf[i];
            const float* R = kf_R + k * 9;
            const float* t = kf_t + k * 3;
            // Ow = -R^T t
            float ox = -(R[0] * t[0] + R[3] * t[1] + R[6] * t[2]);
            float oy = -(R[1] * t[0] + R[4] * t[1] + R[7] * t[2]);
            float oz = -(R[2] * t[0] + R[5] * t[1] + R[8] * t[2]);
            float vx = p[0] - ox, vy = p[1] - oy, vz = p[2] - oz;
            float inv = 1.f / (std::sqrt(vx * vx + vy * vy + vz * vz) + 1e-9f);
            nx += vx * inv; ny += vy * inv; nz += vz * inv;
        }
        double ninv = 1.0 / (std::sqrt(nx * nx + ny * ny + nz * nz) + 1e-9);
        mp_normal[m * 3 + 0] = (float)(nx * ninv);
        mp_normal[m * 3 + 1] = (float)(ny * ninv);
        mp_normal[m * 3 + 2] = (float)(nz * ninv);

        // scale band from the first observation (reference KF)
        {
            int64_t k0 = okf[0];
            int32_t f0 = ofe[0];
            const float* R = kf_R + k0 * 9;
            const float* t = kf_t + k0 * 3;
            float ox = -(R[0] * t[0] + R[3] * t[1] + R[6] * t[2]);
            float oy = -(R[1] * t[0] + R[4] * t[1] + R[7] * t[2]);
            float oz = -(R[2] * t[0] + R[5] * t[1] + R[8] * t[2]);
            float dx = p[0] - ox, dy = p[1] - oy, dz = p[2] - oz;
            float dist = std::sqrt(dx * dx + dy * dy + dz * dz);
            int32_t lvl = kf_octave[k0 * n_feats + f0];
            if (lvl < 0) lvl = 0;
            if (lvl >= n_levels) lvl = n_levels - 1;
            float maxd = dist * scale_factors[lvl];
            mp_max_dist[m] = maxd;
            mp_min_dist[m] = maxd / scale_factors[n_levels - 1];
        }

        // distinctive descriptor: min median Hamming among observations
        // (pairwise work capped at 64x64; points with a wider fan-in use
        // their first 64 observations)
        uint64_t descs[64][4];
        int nn = n < 64 ? n : 64;
        for (int32_t i = 0; i < nn; ++i) {
            const uint32_t* d = kf_desc + (okf[i] * n_feats + ofe[i]) * 8;
            std::memcpy(descs[i], d, 32);
        }
        int best_i = 0;
        int best_med = 1 << 30;
        int dists[64];
        for (int32_t i = 0; i < nn; ++i) {
            for (int32_t j = 0; j < nn; ++j) {
                int d = 0;
                for (int w = 0; w < 4; ++w)
                    d += popcount64(descs[i][w] ^ descs[j][w]);
                dists[j] = d;
            }
            std::nth_element(dists, dists + nn / 2, dists + nn);
            int med = dists[nn / 2];
            if (med < best_med) { best_med = med; best_i = i; }
        }
        std::memcpy(mp_desc + m * 8, descs[best_i], 32);
    }
}

// ---------------------------------------------------------------------------
// 3. covisibility weight recount for one keyframe
//    counts[k2] = shared map points between kf and k2 (excluding kf)
// ---------------------------------------------------------------------------
void covis_counts(
    int64_t kf,
    const int64_t* kf_mp,        // [N] this KF's bindings
    int64_t n_feats,
    const int64_t* mp_obs_kf,    // [M, O]
    const int32_t* mp_obs_n,     // [M]
    int64_t obs_cap,
    int32_t* counts)             // [K] out (caller zeroes)
{
    for (int64_t f = 0; f < n_feats; ++f) {
        int64_t m = kf_mp[f];
        if (m < 0) continue;
        int32_t n = mp_obs_n[m];
        const int64_t* row = mp_obs_kf + m * obs_cap;
        for (int32_t i = 0; i < n; ++i) {
            int64_t k2 = row[i];
            if (k2 >= 0 && k2 != kf) counts[k2] += 1;
        }
    }
}

}  // extern "C"
