// The PoseUKF's in-kernel measurement models: the model ids, their
// dimensions and measure(), h of one model at one sigma point. K3 and K5
// (warp_update.cuh) call measure() from each lane.
//
// Replaces the TPU helper models/pose_update_fused.py::_model_measurement.
// K2's and K3's first designs ran their whole bodies one thread per instance
// from this header; both now run one warp per instance (warp_predict.cuh,
// warp_update.cuh), with those bodies' expressions and order, so their bits.
#pragma once

#include "common.cuh"

namespace slam {

// ---- K3: the in-kernel measurement models ----------------------------------
enum Model : int {
  kVelocity = 0,
  kZPosition = 1,
  kXYPosition = 2,
  kAcceleration = 3,
  kPressure = 4,
  kWaterVelocity = 5,
  kBodyEfforts = 6,
};

__host__ __device__ constexpr int model_dim(int model) {
  return model == kVelocity ? 3 : model == kZPosition ? 1 : model == kXYPosition ? 2
       : model == kAcceleration ? 3 : model == kPressure ? 1 : model == kWaterVelocity ? 2
       : model == kBodyEfforts ? 6 : 0;
}

template <typename T>
__device__ __forceinline__ void cross3(const T u[3], const T t[3], T out[3]) {
  out[0] = u[1] * t[2] - u[2] * t[1];
  out[1] = u[2] * t[0] - u[0] * t[2];
  out[2] = u[0] * t[1] - u[1] * t[0];
}

// Measurement of `model` at the sigma point μ ⊞ δ; m holds μ's storage rows,
// dl(k) returns tangent row k of δ. Fields the model does not read stay at μ.
template <typename T, typename Delta>
__device__ void measure(int model, const T* m, Delta dl, const T* aux, const T* msc, T* out) {
  auto x = [&](int s, int k) -> T { return m[s] + dl(k); };
  auto quat = [&]() -> Quat<T> {
    return qnorm(qmul(Quat<T>{m[3], m[4], m[5], m[6]}, qexp(dl(3), dl(4), dl(5))));
  };
  switch (model) {
    case kVelocity: {
      rot_inv(quat(), x(7, 6), x(8, 7), x(9, 8), out[0], out[1], out[2]);
      return;
    }
    case kZPosition:
      out[0] = x(2, 2);
      return;
    case kXYPosition:
      out[0] = x(0, 0);
      out[1] = x(1, 1);
      return;
    case kAcceleration: {
      const T g = x(19, 18);
      T rx, ry, rz;
      rot_inv(quat(), x(10, 9), x(11, 10), x(12, 11) + g, rx, ry, rz);
      out[0] = rx + x(16, 15);
      out[1] = ry + x(17, 16);
      out[2] = rz + x(18, 17);
      return;
    }
    case kPressure: {
      T lx, ly, lz;
      rot_fwd(quat(), aux[1], aux[2], aux[3], lx, ly, lz);
      const T sensor_z = x(2, 2) + lz;
      out[0] = aux[0] - sensor_z * x(19, 18) * x(53, 52);
      return;
    }
    case kWaterVelocity: {
      const T cw = aux[0];
      const Quat<T> q = quat();
      const T v0 = x(7, 6), v1 = x(8, 7), v2 = x(9, 8);
      T ax, ay, az, bx, by, bz;
      rot_inv(q, v0 - x(47, 46), v1 - x(48, 47), v2, ax, ay, az);
      rot_inv(q, v0 - x(49, 48), v1 - x(50, 49), v2, bx, by, bz);
      out[0] = cw * bx + (T(1) - cw) * ax + x(51, 50);
      out[1] = cw * by + (T(1) - cw) * ay + x(52, 51);
      return;
    }
    case kBodyEfforts: {
      // tau = M·nu_dot + C(nu)·nu + D_lin·nu + D_quad·(|nu|∘nu) + g(q) with
      // the sigma point's (x, y, psi) inertia/damping blocks substituted into
      // the shared 6x6 matrices (mat33 storage is column-major: k = 3·b2 + a2)
      const int idx[3] = {0, 1, 5};
      T M6[6][6], L6[6][6], Q6[6][6];
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j) {
          M6[i][j] = msc[6 * i + j];
          L6[i][j] = msc[36 + 6 * i + j];
          Q6[i][j] = msc[72 + 6 * i + j];
        }
      for (int a2 = 0; a2 < 3; ++a2)
        for (int b2 = 0; b2 < 3; ++b2) {
          const int k = 3 * b2 + a2;
          M6[idx[a2]][idx[b2]] = x(20 + k, 19 + k);
          L6[idx[a2]][idx[b2]] = x(29 + k, 28 + k);
          Q6[idx[a2]][idx[b2]] = x(38 + k, 37 + k);
        }
      const T weight = msc[108], buoy = msc[109];
      const T cog[3] = {msc[110], msc[111], msc[112]};
      const T cob[3] = {msc[113], msc[114], msc[115]};
      const T pib[3] = {msc[116], msc[117], msc[118]};
      const T w[3] = {aux[0], aux[1], aux[2]};
      const Quat<T> q = quat();
      T vb[3], wv[3], ab[3], cw[3], cc[3];
      rot_inv(q, x(7, 6), x(8, 7), x(9, 8), vb[0], vb[1], vb[2]);
      cross3(w, pib, cw);
      rot_inv(q, x(47, 46), x(48, 47), T(0), wv[0], wv[1], wv[2]);
      const T v6[6] = {vb[0] - cw[0] - wv[0], vb[1] - cw[1] - wv[1], vb[2] - cw[2] - wv[2],
                       w[0], w[1], w[2]};
      rot_inv(q, x(10, 9), x(11, 10), x(12, 11), ab[0], ab[1], ab[2]);
      cross3(w, cw, cc);
      const T a3[3] = {ab[0] - cc[0], ab[1] - cc[1], ab[2] - cc[2]};
      T p1[3], p2[3];
      for (int i = 0; i < 3; ++i) {
        p1[i] = T(0);
        p2[i] = T(0);
        for (int j = 0; j < 6; ++j) {
          p1[i] += M6[i][j] * v6[j];
          p2[i] += M6[3 + i][j] * v6[j];
        }
      }
      T c1[3], c2a[3], c2b[3];
      cross3(w, p1, c1);
      cross3(w, p2, c2a);
      cross3(v6, p1, c2b);
      const T cor[6] = {c1[0], c1[1], c1[2], c2a[0] + c2b[0], c2a[1] + c2b[1], c2a[2] + c2b[2]};
      T up[3];
      rot_inv(q, T(0), T(0), T(1), up[0], up[1], up[2]);
      const T dwb = buoy - weight;
      const T fg[3] = {-up[0] * weight, -up[1] * weight, -up[2] * weight};
      const T fb[3] = {up[0] * buoy, up[1] * buoy, up[2] * buoy};
      T tg[3], tb[3];
      cross3(cog, fg, tg);
      cross3(cob, fb, tb);
      const T g6[6] = {-(up[0] * dwb), -(up[1] * dwb), -(up[2] * dwb),
                       -(tg[0] + tb[0]), -(tg[1] + tb[1]), -(tg[2] + tb[2])};
      for (int i = 0; i < 6; ++i) {
        const T ma = M6[i][0] * a3[0] + M6[i][1] * a3[1] + M6[i][2] * a3[2];
        T dl_ = T(0), dq = T(0);
        for (int j = 0; j < 6; ++j) {
          dl_ += L6[i][j] * v6[j];
          dq += Q6[i][j] * (d_abs(v6[j]) * v6[j]);
        }
        out[i] = ma + cor[i] + (dl_ + dq) + g6[i];
      }
      return;
    }
    default:
      return;
  }
}

}  // namespace slam
