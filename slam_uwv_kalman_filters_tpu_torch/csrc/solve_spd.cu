// K8 · X = A^-1·B for a bank of SPD systems.
//
// Replaces the TPU kernel ops/kernels.py::_solve_spd_kernel (launched by
// _solve_spd_lanes): the equilibrated Cholesky L = D·chol(D^-1·A·D^-1) of each
// (n, n) matrix through common.cuh's equilibrated_core (K1's core, the same
// equilibration, here in KEEP mode so the finished factor stays in scratch),
// then the forward substitution L·Y = B (right-looking, as the TPU kernel:
// each finished y_j is subtracted from the rows below) and the backward
// substitution Lᵀ·X = Y (inner products, descending). Factor column j is
// s(j, r)·D_r; division is by the reciprocal of the pivot, as on the TPU.
// The wrapper counts one launch of K8 per call, which runs both passes.
//
// Bound on Hopper: latency. Two passes in one launch call: (1) one thread per
// system factors it into bank-last global scratch (coalesced: neighbouring
// threads touch neighbouring addresses), ~n³/6 dependent multiply-adds, and
// stores D beside the factor; (2) one thread per (system, right-hand side)
// runs both substitutions, ~n² multiply-adds, on its column in a per-thread
// array, the factor read through L2 (the threads of a warp share the column
// index and read neighbouring systems). The smoother's n = k = 53 at bank 256
// is then two blocks in (1) and 106 in (2): (1) is one thread's serial time.
// A later version gives each system a block (the factor in shared memory).
//
// Inputs: a (n, n, nb) in (col, row, nb) order, lower half read; b (n, k, nb)
// (row, col, nb). Output: out (n, k, nb). Scratch: s (n + 1, n, nb): the
// factor, then D.

#include "common.cuh"

namespace slam {

template <typename T>
__global__ void __launch_bounds__(kThreads)
solve_spd_factor_kernel(const T* __restrict__ a, T* __restrict__ scratch, int n, long long nb) {
  const long long b = instance_index();
  if (b >= nb) return;
  T dvec[kMaxN];
  equilibrated_core<T, true>(a + b, scratch + b, nb, n, dvec, NoEmit{});
  T* d = scratch + static_cast<long long>(n) * n * nb + b;
  for (int j = 0; j < n; ++j) d[j * nb] = dvec[j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
solve_spd_subst_kernel(const T* __restrict__ rhs, const T* __restrict__ scratch, T* __restrict__ out,
                       int n, int k, long long nb) {
  const long long t = instance_index();
  if (t >= nb * k) return;
  const long long b = t % nb;
  const int c = static_cast<int>(t / nb);
  const T* si = scratch + b;
  const T* d = scratch + static_cast<long long>(n) * n * nb + b;
  // factor entry L(r, j), r >= j
  auto L = [&](int r, int j) -> T { return si[(static_cast<long long>(j) * n + r) * nb] * d[r * nb]; };
  T y[kMaxN];
  for (int r = 0; r < n; ++r) y[r] = rhs[(static_cast<long long>(r) * k + c) * nb + b];
  // forward substitution L·y = b
  for (int j = 0; j < n; ++j) {
    const T yj = y[j] * (T(1) / L(j, j));
    y[j] = yj;
    for (int r = j + 1; r < n; ++r) y[r] -= L(r, j) * yj;
  }
  // backward substitution Lᵀ·x = y
  for (int j = n - 1; j >= 0; --j) {
    T acc = y[j];
    for (int r = j + 1; r < n; ++r) acc -= L(r, j) * y[r];
    y[j] = acc * (T(1) / L(j, j));
  }
  for (int r = 0; r < n; ++r) out[(static_cast<long long>(r) * k + c) * nb + b] = y[r];
}

template <typename T>
int launch_solve_spd(const void* a, const void* rhs, void* out, void* scratch, int n, int k,
                     long long nb, void* stream) {
  if (n < 1 || n > kMaxN || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  solve_spd_factor_kernel<T><<<blocks_for(nb), kThreads, 0, st>>>(static_cast<const T*>(a),
                                                                   static_cast<T*>(scratch), n, nb);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  solve_spd_subst_kernel<T><<<blocks_for(nb * k), kThreads, 0, st>>>(
      static_cast<const T*>(rhs), static_cast<const T*>(scratch), static_cast<T*>(out), n, k, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

extern "C" int slam_solve_spd_f32(const void* a, const void* rhs, void* out, void* scratch, int n,
                                  int k, long long nb, void* stream) {
  return slam::launch_solve_spd<float>(a, rhs, out, scratch, n, k, nb, stream);
}

extern "C" int slam_solve_spd_f64(const void* a, const void* rhs, void* out, void* scratch, int n,
                                  int k, long long nb, void* stream) {
  return slam::launch_solve_spd<double>(a, rhs, out, scratch, n, k, nb, stream);
}
