// K10 · the IndirectPoseUKF visual-marker update with state augmentation,
// in one launch.
//
// Replaces the TPU kernel models/indirect_fused.py::_make_marker_kernel
// (launched by _indirect_markers_lanes). Per instance:
//   1. the 12-DOF augmented covariance (src/IndirectPoseUKF.cpp:26-33,
//      94-135): the filter block ⊕ the marker pose's, zero cross-covariance;
//      the augmented mean is the error state and the marker pose;
//   2. for each corner c (a runtime loop, no cap): the 12x12 Crout factor L
//      of P; 25 sigma points, each built from its ±column of L (the 25x12
//      deltas are never stored); through measurementVisualLandmark
//      (src/IndirectPoseUKF.cpp:38-50): the reference pose ∘ error ∘ camera
//      extrinsics, inverted, applied to the corner that the marker pose
//      moves, normalized to a bearing; the S² Karcher mean of the 25 bearings
//      (MEAN_ITERS = 4 fixed iterations seeded from point 0), its basis, dZ =
//      bearing ⊟ mean and the innovation z_c ⊟ mean; S = ½ΣdZdZᵀ + R_c, C =
//      ½ΣδdZᵀ and the Kalman tail with a threshold of −1 (every corner is
//      accepted, src/IndirectPoseUKF.cpp:131); the correction moves both
//      positions and ⊞ both quaternions (so3.cuh); m2 and ν written;
//   3. the 6x6 filter block (both halves) and the 7 mean rows written: the
//      marker block is marginalized out (src/IndirectPoseUKF.cpp:134).
//
// Bound on Hopper: latency. Each instance reads 28 + 7 + 7 + 7 values and 7
// per corner and writes 43 + 3 per corner against ~16k dependent operations
// per corner (a 12x12 factor, 25 sigma points with two ⊞ maps and the bearing
// model, 4 Karcher iterations over 25 bearings with atan2). The first design
// gave each instance one thread, and the 12x12 covariance, its factor and the
// 25 bearings of one thread lived in local memory (a 912-byte stack frame in
// float32; 2112 bytes and spills in float64): 0.071 ms for one instance, 0.18
// ms for 65 536 at one corner (float32, NVIDIA H100 80GB HBM3, 700 W). Here a
// group of G lanes takes an instance (group_ukf.cuh; G a template
// parameter, 32 or 4) and keeps its working set in a tile of shared memory
// (kIndTile entries: 1.2 KB in float32, 2.4 KB in float64):
//   P, L         the covariance and its factor, packed lower halves (78 each)
//   bear         the 25 bearings, bear[3p + a]; then dZ_p in [3p], [3p + 1]
//   work         the Karcher terms (2 a point); then C's raw sums at [2i + a]
//                (W in place), S's at 24..26 and the correction at 27..38
//   m            the error mean, the marker pose and the pose reference (21)
// and, once after a block's tiles, the camera pose (7). The sigma points read
// the means and the camera from shared memory where they use them, and each
// corner makes its lane's place afresh (fresh_tid, fresh_ctaid), so that no
// long-lived value spills around the math library's calls.
// Lanes own the factor's rows i mod G (group_crout), the sigma points p mod G
// (point p's delta built from column (p − 1)/2 of L in the tile), C's entries
// (i, a) and S's three, the gain rows and the downdate's entries
// (group_kalman_tail2); the pivots, the Karcher mean's ⊞, the 2x2 tail and
// the corrections of the means run on every lane on identical values. Every
// G gives the one-thread design's bits (group_ukf.cuh says how). A wide
// group shortens one instance's path most (32 lanes: 0.016 ms for one
// instance) and a narrow one repeats the O(1) work least (4 lanes: 0.18 ms
// for 65 536 at one corner, where 32 take 0.43); the launch picks one of the
// two from the bank (indirect_group). A block holds 128/G instances (16
// at most); their loads and stores are staged, so each bank-last row moves in
// runs of a block's instances. The tiles stay under 48 KB a block, so no
// launch needs the opt-in shared-memory attribute.
//
// Operands (bank-last): cov (6, 6, nb) (col, row), lower half read; mu (7,
// nb); ref (7, nb) the pose reference [position, quaternion]; mk (7, nb) the
// marker pose; z (k, 3, nb) unit bearings; r (k, 2, 2, nb) tangent
// covariances, lower half read; scal (43 + 3k) on the device: the
// camera-in-body position (3) and orientation (4), the marker pose's 6x6
// covariance row-major (symmetric, lower half read), then each corner's
// position in the marker frame. Outputs: cov_out (6, 6, nb) both halves,
// mu_out (7, nb), m2 (k, nb), nu (k, 2, nb). No scratch.

#include "group_ukf.cuh"
#include "so3.cuh"

namespace slam {

constexpr int kAugDof = 12;
constexpr int kAugSig = 2 * kAugDof + 1;  // 25
constexpr int kMarkerMeanIters = 4;

// the instance's tile, in T units (odd, so the groups of a warp start on
// different banks)
constexpr int kIndP = 0;
constexpr int kIndL = kIndP + tri(kAugDof, 0);
constexpr int kIndBear = kIndL + tri(kAugDof, 0);
constexpr int kIndWork = kIndBear + 3 * kAugSig;
constexpr int kIndMean = kIndWork + 2 * kAugSig;
constexpr int kIndTile = kIndMean + 21 + 1;  // 303
constexpr int kIndCam = 7;  // the camera pose, once a block after its tiles

// row i of sigma point p's tangent delta: 0 for p = 0, else ± column (p −
// 1)/2 of the factor L (+ for odd p), zero above the diagonal
template <typename T>
__device__ __forceinline__ T sigma_delta_at(const T* L, int p, int i) {
  const int j = p > 0 ? (p - 1) >> 1 : 0;
  const bool plus = (p & 1) != 0;
  return (p > 0 && i >= j) ? (plus ? L[tri(i, j)] : -L[tri(i, j)]) : T(0);
}

// the predicted bearing of the sigma point with tangent delta d
// (measurementVisualLandmark: body = ref ∘ error, camera = body ∘ extrinsics)
template <typename T>
__device__ __forceinline__ void indirect_bearing(const T (&d)[kAugDof], const T (&pos)[3], const Quat<T>& qe,
                                                 const T (&mpos)[3], const Quat<T>& mq, const T (&ref_p)[3],
                                                 const Quat<T>& ref_q, const T (&cam_p)[3], const Quat<T>& cam_q,
                                                 const T (&fp)[3], T (&bear)[3]) {
  const T sp[3] = {pos[0] + d[0], pos[1] + d[1], pos[2] + d[2]};
  const Quat<T> sq = so3_boxplus(qe, d[3], d[4], d[5], T(1));
  const T smp[3] = {mpos[0] + d[6], mpos[1] + d[7], mpos[2] + d[8]};
  const Quat<T> smq = so3_boxplus(mq, d[9], d[10], d[11], T(1));
  const Quat<T> body_q = qmul(ref_q, sq);
  T body_p[3], cam_nav_p[3], f_nav[3], f_cam[3];
  rot_fwd(ref_q, sp[0], sp[1], sp[2], body_p[0], body_p[1], body_p[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) body_p[i] += ref_p[i];
  const Quat<T> cam_nav_q = qmul(body_q, cam_q);
  rot_fwd(body_q, cam_p[0], cam_p[1], cam_p[2], cam_nav_p[0], cam_nav_p[1], cam_nav_p[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) cam_nav_p[i] += body_p[i];
  rot_fwd(smq, fp[0], fp[1], fp[2], f_nav[0], f_nav[1], f_nav[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) f_nav[i] = (f_nav[i] + smp[i]) - cam_nav_p[i];
  rot_fwd(qconj(cam_nav_q), f_nav[0], f_nav[1], f_nav[2], f_cam[0], f_cam[1], f_cam[2]);
  const T inv_n = T(1) / d_sqrt(f_cam[0] * f_cam[0] + f_cam[1] * f_cam[1] + f_cam[2] * f_cam[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) bear[i] = inv_n * f_cam[i];
}

// instances a block: 16 at most, so a block's tiles stay under 48 KB (36 KB
// in float64) and no launch needs the opt-in shared-memory attribute
__host__ __device__ constexpr int ind_instances(int G) { return G < 8 ? 16 : kGroupThreads / G; }

// a block's dynamic shared memory: its instances' tiles and the camera pose
template <typename T>
constexpr size_t ind_smem_bytes(int G) {
  return (static_cast<size_t>(ind_instances(G)) * kIndTile + kIndCam) * sizeof(T);
}

// The group size of a launch at bank nb: kIndWide lanes up to
// SLAM_INDIRECT_WIDE_BANKS instances (the shortest path through one
// instance), kIndNarrow past it (the fewest repeats of the O(1) work once the
// card is full). tools/small_kernel_times.py (float32, NVIDIA H100 80GB HBM3
// at 700 W) timed one corner with 32 lanes at 0.0358 ms against 0.0393 with
// 4 at 4096 instances, and 0.0581 against 0.0419 at 8192 (4 corners: 0.1300
// against 0.1363, 0.2144 against 0.1458); it builds this file with
// SLAM_INDIRECT_WIDE_BANKS at 0 and at its largest to time either size at
// any bank.
constexpr int kIndWide = 32, kIndNarrow = 4;
#ifndef SLAM_INDIRECT_WIDE_BANKS
#define SLAM_INDIRECT_WIDE_BANKS 4096
#endif
inline int indirect_group(long long nb) { return nb <= SLAM_INDIRECT_WIDE_BANKS ? kIndWide : kIndNarrow; }

template <typename T, int G>
__global__ void __launch_bounds__(kGroupThreads)
indirect_markers_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ ref,
                        const T* __restrict__ mk, const T* __restrict__ z, const T* __restrict__ r,
                        const T* __restrict__ scal, int n_corners, T* __restrict__ cov_out,
                        T* __restrict__ mu_out, T* __restrict__ m2_out, T* __restrict__ nu_out, long long nb) {
  constexpr int N = kAugDof, K = kAugSig, I = ind_instances(G);
  extern __shared__ __align__(16) unsigned char slam_group_smem[];
  T* const tiles = reinterpret_cast<T*>(slam_group_smem);
  T* const cam = tiles + I * kIndTile;  // read where used, like the means
  const long long b0 = static_cast<long long>(blockIdx.x) * I;
  const auto rows = [](int rr) { return rr; };
  const auto mean = [tiles](int offset) {
    return [tiles, offset](int rr, int w) -> T& { return tiles[w * kIndTile + kIndMean + offset + rr]; };
  };

  // 1. the filter block's lower half into P (the rows (j·6 + i), j <= i, in
  // packed order), the means and the reference into m; the marker block and
  // the zero cross block by each group
  stage_in(cov, tri(6, 0), [](int e) { int i, j; tri_entry(e, i, j); return j * 6 + i; }, b0, I, nb,
           [&](int e, int w) -> T& { return tiles[w * kIndTile + kIndP + e]; });
  stage_in(mu, 7, rows, b0, I, nb, mean(0));
  stage_in(mk, 7, rows, b0, I, nb, mean(7));
  stage_in(ref, 7, rows, b0, I, nb, mean(14));
  if (threadIdx.x < kIndCam) cam[threadIdx.x] = scal[threadIdx.x];
  {
    const Group<G> grp;
    T* const P = tiles + grp.index * kIndTile + kIndP;
    for (int e = grp.g; e < 36; e += G) {
      const int i = e / 6, j = e % 6;
      if (j <= i) P[tri(6 + i, 6 + j)] = scal[7 + 6 * i + j];
      P[tri(6 + i, j)] = T(0);
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int c = 0; c < n_corners; ++c) {
    // the lane's group and tile, made afresh in each corner (fresh_tid)
    const Group<G> grp(fresh_tid());
    T* const s = tiles + grp.index * kIndTile;
    T* const P = s + kIndP;
    T* const L = s + kIndL;
    T* const bear = s + kIndBear;
    T* const work = s + kIndWork;
    T* const m = s + kIndMean;  // pos (3), qe (4), mpos (3), mq (4), ref_p (3), ref_q (4)
    // 2. the factor
    group_crout<T, N>(grp, P, L);
    // 3. the bearings of the sigma points p mod G
    for (int p = grp.g; p < K; p += G) {
      T d[N];
#pragma unroll
      for (int i = 0; i < N; ++i) d[i] = sigma_delta_at(L, p, i);
      const T pos[3] = {m[0], m[1], m[2]}, mpos[3] = {m[7], m[8], m[9]}, ref_p[3] = {m[14], m[15], m[16]};
      const Quat<T> qe{m[3], m[4], m[5], m[6]}, mq{m[10], m[11], m[12], m[13]}, ref_q{m[17], m[18], m[19], m[20]};
      const T cam_p[3] = {cam[0], cam[1], cam[2]};
      const Quat<T> cam_q{cam[3], cam[4], cam[5], cam[6]};
      const T fp[3] = {scal[43 + 3 * c], scal[44 + 3 * c], scal[45 + 3 * c]};
      T y[3];
      indirect_bearing(d, pos, qe, mpos, mq, ref_p, ref_q, cam_p, cam_q, fp, y);
#pragma unroll
      for (int a = 0; a < 3; ++a) bear[3 * p + a] = y[a];
    }
    grp.sync();
    // 4. their Karcher mean, then dZ over the bearings
    T zm[3];
    group_s2_mean_tile<T, K, kMarkerMeanIters>(grp, bear, work, zm);
    const S2Basis<T> B = s2_basis(zm);
    for (int p = grp.g; p < K; p += G) {
      const T y[3] = {bear[3 * p], bear[3 * p + 1], bear[3 * p + 2]};
      s2_boxminus(y, zm, B, bear[3 * p], bear[3 * p + 1]);
    }
    grp.sync();
    // 5. C's raw sums (entries 0..23) and S's (24..26: (0, 0), (1, 0), (1,
    // 1)), each on one lane, p rising; C's over the points whose delta has
    // row i (p = 2j + 1, 2j + 2, j <= i): the others' terms are fma(+0, dZ,
    // sum), which leave a sum that is not zero as it is
    for (int e = grp.g; e < 2 * N + 3; e += G) {
      T acc = T(0);
      if (e < 2 * N) {
        const int i = e >> 1, a = e & 1;
        for (int j = 0; j <= i; ++j) {
          const T l = L[tri(i, j)];
          acc += l * bear[3 * (2 * j + 1) + a];
          acc += -l * bear[3 * (2 * j + 2) + a];
        }
      } else {
        const int a = e == 2 * N ? 0 : 1, f = e == 2 * N + 2 ? 1 : 0;
        for (int p = 0; p < K; ++p) acc += bear[3 * p + a] * bear[3 * p + f];
      }
      work[e] = acc;
    }
    grp.sync();
    // 6. ν, S + R and the tail with every corner accepted; the instance (a
    // spare group's: a copy of the last) read afresh (fresh_ctaid)
    const long long own = static_cast<long long>(fresh_ctaid()) * I + grp.index;
    const long long b = own < nb ? own : nb - 1;
    const long long zc = static_cast<long long>(c) * 3 * nb + b;
    const T zv[3] = {z[zc], z[zc + nb], z[zc + 2 * nb]};
    T nu[2];
    s2_boxminus(zv, zm, B, nu[0], nu[1]);
    const long long rc = static_cast<long long>(c) * 4 * nb + b;
    T S[2][2];
    S[0][0] = T(0.5) * work[2 * N] + r[rc];
    S[1][0] = S[0][1] = T(0.5) * work[2 * N + 1] + r[rc + 2 * nb];
    S[1][1] = T(0.5) * work[2 * N + 2] + r[rc + 3 * nb];
    T* const corr = work + 2 * N + 3;
    T m2;
    group_kalman_tail2<T, N>(grp, P, work, corr, S, nu, T(-1), m2);
    // 7. the correction of both poses on every lane, written by lane 0 once
    // every lane has read the means
    T pos[3] = {m[0], m[1], m[2]}, mpos[3] = {m[7], m[8], m[9]};
    Quat<T> qe{m[3], m[4], m[5], m[6]}, mq{m[10], m[11], m[12], m[13]};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pos[i] += corr[i];
      mpos[i] += corr[6 + i];
    }
    qe = so3_boxplus(qe, corr[3], corr[4], corr[5], T(1));
    mq = so3_boxplus(mq, corr[9], corr[10], corr[11], T(1));
    grp.sync();
    if (grp.g == 0) {
      const T out[14] = {pos[0], pos[1], pos[2], qe.w, qe.x, qe.y, qe.z,
                         mpos[0], mpos[1], mpos[2], mq.w, mq.x, mq.y, mq.z};
#pragma unroll
      for (int i = 0; i < 14; ++i) m[i] = out[i];
      if (own < nb) {
        m2_out[static_cast<long long>(c) * nb + b] = m2;
        nu_out[static_cast<long long>(c) * 2 * nb + b] = nu[0];
        nu_out[static_cast<long long>(c) * 2 * nb + nb + b] = nu[1];
      }
    }
    grp.sync();
  }

  // 8. the filter block (both halves) and the error mean, staged
  __syncthreads();
  stage_out(cov_out, 36, rows, b0, I, nb, [&](int rr, int w) {
    const int j = rr / 6, i = rr % 6;
    return tiles[w * kIndTile + kIndP + (i >= j ? tri(i, j) : tri(j, i))];
  });
  stage_out(mu_out, 7, rows, b0, I, nb, [&](int rr, int w) { return tiles[w * kIndTile + kIndMean + rr]; });
}

template <typename T, int G>
int launch_indirect_markers(const void* cov, const void* mu, const void* ref, const void* mk, const void* z,
                            const void* r, const void* scal, int n_corners, void* cov_out, void* mu_out, void* m2,
                            void* nu, long long nb, void* stream) {
  constexpr int I = ind_instances(G);
  const size_t bytes = ind_smem_bytes<T>(G);
  const unsigned blocks = static_cast<unsigned>((nb + I - 1) / I);
  indirect_markers_kernel<T, G><<<blocks, G * I, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(ref), static_cast<const T*>(mk),
      static_cast<const T*>(z), static_cast<const T*>(r), static_cast<const T*>(scal), n_corners,
      static_cast<T*>(cov_out), static_cast<T*>(mu_out), static_cast<T*>(m2), static_cast<T*>(nu), nb);
  return static_cast<int>(cudaGetLastError());
}

// the warps a block (and, in resident, an SM) of the launch at bank nb
template <typename T>
int indirect_markers_warps(long long nb, int* resident) {
  if (nb < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const auto warps = [resident](auto kernel, int G) {
    return group_warps(kernel, G * ind_instances(G), ind_smem_bytes<T>(G), resident);
  };
  return indirect_group(nb) == kIndWide ? warps(indirect_markers_kernel<T, kIndWide>, kIndWide)
                                        : warps(indirect_markers_kernel<T, kIndNarrow>, kIndNarrow);
}

}  // namespace slam

#define SLAM_INDIRECT_MARKERS_ENTRY(NAME, T)                                                                  \
  extern "C" int NAME(const void* cov, const void* mu, const void* ref, const void* mk, const void* z,        \
                      const void* r, const void* scal, int n_corners, void* cov_out, void* mu_out, void* m2, \
                      void* nu, long long nb, void* stream) {                                                 \
    if (n_corners < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);                              \
    return slam::indirect_group(nb) == slam::kIndWide                                                         \
               ? slam::launch_indirect_markers<T, slam::kIndWide>(cov, mu, ref, mk, z, r, scal, n_corners,     \
                                                                  cov_out, mu_out, m2, nu, nb, stream)         \
               : slam::launch_indirect_markers<T, slam::kIndNarrow>(cov, mu, ref, mk, z, r, scal, n_corners,   \
                                                                    cov_out, mu_out, m2, nu, nb, stream);      \
  }                                                                                                           \
  extern "C" int NAME##_warps(long long nb) { return slam::indirect_markers_warps<T>(nb, nullptr); }          \
  extern "C" int NAME##_resident(long long nb) {                                                              \
    int resident = 0;                                                                                         \
    const int warps = slam::indirect_markers_warps<T>(nb, &resident);                                         \
    return warps < 0 ? warps : resident;                                                                      \
  }

SLAM_INDIRECT_MARKERS_ENTRY(slam_indirect_markers_f32, float)
SLAM_INDIRECT_MARKERS_ENTRY(slam_indirect_markers_f64, double)
