// K11 · the PoseUKF visual-marker update with the 59-DOF state augmentation,
// in one launch.
//
// Replaces the TPU kernel models/pose_marker_fused.py::_make_marker_kernel
// (launched by _pose_marker_lanes). One warp per instance, W = 2^log_w
// instances a block:
//   1. the block loads its instances' 59x59 augmented covariances into the
//      warps' tiles (src/PoseUKF.cpp:613-654): the valid (row >= col) half of
//      the 53x53 lanes covariance, bank-minor (block_walk), a zero cross block
//      and the shared marker-pose prior; the augmented mean is the 54 storage
//      rows and the marker pose;
//   2. each warp runs the corners in order (warp_markers.cuh::
//      warp_marker_corner: a fresh equilibrated 59x59 factor, the bearings of
//      the 119 sigma points through measurementVisualLandmark,
//      src/PoseUKF.cpp:233-243, their S² Karcher mean, S, C, the 2x2 gain with
//      every corner accepted, the correction ⊞ into both quaternions and the
//      downdate of the augmented covariance in its tile), writing each
//      corner's m2 and ν;
//   3. the marker block is marginalized out: the block stores the top-left
//      53x53 valid half and the 54 mean rows, bank-minor.
// The results are those of the first design, one thread per instance, bit
// for bit (warp_markers.cuh says how).
//
// Bound on Hopper: operations, ~1.4e5 a corner (the 59x59 factor ~7e4, the
// 119 bearing evaluations, 4 Karcher iterations and the deviations ~5e4 with
// sin, cos, sqrt and atan2, C and the downdate ~1.4e4) against ~6.2 KB of
// float32 in and out an instance. The first design gave each instance one
// thread and kept the augmented covariance, its factor, the bearings and C/W
// in bank-last global scratch (3.65 GB at bank 131 072 in float32, far past
// the 50 MB L2): each factor's ~n³/6 dependent read-modify-writes went to
// device memory. Here all of it lives in the warp's tile of shared memory
// (17.3 KB in float32) and the lanes share each stage out; what is left is
// the factor's n dependent steps, which the warps an SM (12 in float32) hide.
// The warps per block are chosen from the tile's occupancy
// (resident_warps_log2).
//
// Operands (bank-last): cov (53, 53, nb) (col, row), lower half read; mu
// (54, nb); mk (7, nb) the marker pose's mean [position, quaternion]; z (k,
// 3, nb) unit bearings; r (k, 2, 2, nb) tangent covariances; scal (43 + 3k)
// on the device: the camera-in-IMU position (3) and orientation (4), the
// marker pose's 6x6 covariance row-major (the half j >= i of entry (i, j)
// read), then each corner's position in the marker frame. Outputs: cov_out
// (53, 53, nb) valid half, mu_out (54, nb), m2 (k, nb), nu (k, 2, nb). No
// scratch.

#include "warp_markers.cuh"

namespace slam {

template <typename T>
__global__ void __launch_bounds__(kWarpSize* kMaxWarps)
pose_markers_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ mk,
                    const T* __restrict__ z, const T* __restrict__ r, const T* __restrict__ scal, int n_corners,
                    T* __restrict__ cov_out, T* __restrict__ mu_out, T* __restrict__ m2_out,
                    T* __restrict__ nu_out, long long nb, int log_w) {
  constexpr int N0 = kPoseN;
  const MarkerTile t;
  const int stride = t.size;
  T* const base = warp_smem<T>();
  const long long b0 = static_cast<long long>(blockIdx.x) << log_w;
  const int w = threadIdx.x / kWarpSize, lane = threadIdx.x % kWarpSize;
  // the augmented covariance's entry (row, c), row >= c, in tile i
  auto A = [&](int i, int c, int row) -> T& { return marker_cov(base + i * stride, t, c, row); };

  // 1. the pose block's valid half and the means, bank-minor
  const Strides gc{1, nb, N0 * nb}, gv{1, nb, kPoseS * nb};
  block_walk(gc, N0, N0, true, log_w, b0, nb, [&](int i, int row, int c) {
    A(i, c, row) = cov[(b0 + i) + row * nb + c * (N0 * nb)];
  });
  block_walk(gv, kPoseS, 1, false, log_w, b0, nb, [&](int i, int row, int) {
    base[i * stride + t.mean + row] = mu[(b0 + i) + row * nb];
  });
  block_walk(gv, 7, 1, false, log_w, b0, nb, [&](int i, int row, int) {
    base[i * stride + t.mean + kPoseS + row] = mk[(b0 + i) + row * nb];
  });
  // the zero cross block and the marker-pose prior, each warp its own
  if (b0 + w < nb) {
    for (int e = lane; e < N0 * 6; e += kWarpSize) A(w, e / 6, N0 + e % 6) = T(0);
    for (int e = lane; e < 36; e += kWarpSize) {
      const int i = e / 6, j = e % 6;
      if (j >= i) A(w, N0 + i, N0 + j) = scal[7 + 6 * i + j];
    }
  }
  __syncthreads();

  // 2. the corners, one warp an instance
  if (b0 + w < nb) {
    const long long b = b0 + w;
    const T cam_p[3] = {scal[0], scal[1], scal[2]};
    const Quat<T> cam_q{scal[3], scal[4], scal[5], scal[6]};
    T* const s = base + w * stride;
    for (int cn = 0; cn < n_corners; ++cn) {
      const T fp[3] = {scal[43 + 3 * cn], scal[44 + 3 * cn], scal[45 + 3 * cn]};
      warp_marker_corner<T>(s, t, fp, cam_p, cam_q, z + static_cast<long long>(cn) * 3 * nb + b,
                            r + static_cast<long long>(cn) * 4 * nb + b, m2_out + static_cast<long long>(cn) * nb + b,
                            nu_out + static_cast<long long>(cn) * 2 * nb + b, nb);
    }
  }
  __syncthreads();

  // 3. the marker block marginalized out: the 53x53 valid half and the 54
  // storage rows
  block_walk(gc, N0, N0, true, log_w, b0, nb, [&](int i, int row, int c) {
    cov_out[(b0 + i) + row * nb + c * (N0 * nb)] = A(i, c, row);
  });
  block_walk(gv, kPoseS, 1, false, log_w, b0, nb, [&](int i, int row, int) {
    mu_out[(b0 + i) + row * nb] = base[i * stride + t.mean + row];
  });
}

// The launch's warps per block as log2, or a negated cudaError_t; `resident`
// receives the warps an SM keeps.
template <typename T>
int pose_markers_log_w(long long nb, int* resident = nullptr) {
  if (nb < 1) return -static_cast<int>(cudaErrorInvalidValue);
  static const long long max_bytes = opt_in_smem(pose_markers_kernel<T>);
  if (max_bytes < 0) return static_cast<int>(max_bytes);
  const long long bytes = static_cast<long long>(MarkerTile().size) * sizeof(T);
  const int log_w = resident_warps_log2(pose_markers_kernel<T>, nb, bytes, max_bytes, resident);
  if (log_w < -1) return log_w + 1;
  return log_w < 0 ? -static_cast<int>(cudaErrorInvalidValue) : log_w;
}

template <typename T>
int launch_pose_markers(const void* cov, const void* mu, const void* mk, const void* z, const void* r,
                        const void* scal, int n_corners, void* cov_out, void* mu_out, void* m2, void* nu,
                        long long nb, void* stream) {
  if (n_corners < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int log_w = pose_markers_log_w<T>(nb);
  if (log_w < 0) return -log_w;
  const size_t bytes = static_cast<size_t>(MarkerTile().size) * sizeof(T) << log_w;
  const unsigned blocks = static_cast<unsigned>((nb + (1LL << log_w) - 1) >> log_w);
  pose_markers_kernel<T><<<blocks, kWarpSize << log_w, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(mk), static_cast<const T*>(z),
      static_cast<const T*>(r), static_cast<const T*>(scal), n_corners, static_cast<T*>(cov_out),
      static_cast<T*>(mu_out), static_cast<T*>(m2), static_cast<T*>(nu), nb, log_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_POSE_MARKERS_ENTRY(NAME, T)                                                                      \
  extern "C" int NAME(const void* cov, const void* mu, const void* mk, const void* z, const void* r,          \
                      const void* scal, int n_corners, void* cov_out, void* mu_out, void* m2, void* nu,       \
                      long long nb, void* stream) {                                                           \
    return slam::launch_pose_markers<T>(cov, mu, mk, z, r, scal, n_corners, cov_out, mu_out, m2, nu, nb,      \
                                        stream);                                                              \
  }                                                                                                           \
  extern "C" int NAME##_warps(long long nb) {                                                                 \
    const int log_w = slam::pose_markers_log_w<T>(nb);                                                        \
    return log_w < 0 ? log_w : 1 << log_w;                                                                    \
  }                                                                                                           \
  extern "C" int NAME##_resident(long long nb) {                                                              \
    int resident = 0;                                                                                         \
    const int log_w = slam::pose_markers_log_w<T>(nb, &resident);                                             \
    return log_w < 0 ? log_w : resident;                                                                      \
  }

SLAM_POSE_MARKERS_ENTRY(slam_pose_markers_f32, float)
SLAM_POSE_MARKERS_ENTRY(slam_pose_markers_f64, double)
