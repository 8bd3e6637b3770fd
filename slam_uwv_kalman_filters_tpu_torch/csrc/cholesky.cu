// K12 · the lower Cholesky factor of a bank of SPD matrices.
//
// Replaces the TPU kernel ops/kernels.py::_cholesky_lanes_kernel (launched by
// _cholesky_lanes from cholesky_banked / cholesky_fast) together with the
// wrapper's equilibration and back-scaling around it: per matrix,
// L = D·chol(D^-1·A·D^-1), D = sqrt(max(diag A, tiny)), written with explicit
// zeros above the diagonal. It runs common.cuh's equilibrated_core (the core
// of K2, K3, K5 and K11) in KEEP mode with the output as its scratch, so the
// finished equilibrated factor lands in place and one pass scales row r by
// D_r. A matrix with a pivot that is not positive (or NaN) is written all NaN,
// as a failed library factorization is in the plain version.
//
// Bound on Hopper: memory, as a function (read the lower half, write the
// whole factor: ~n² elements per matrix against ~n³/3 FMAs). This first
// version is one thread per matrix through the bank-last output (coalesced:
// neighbouring threads touch neighbouring addresses), and the ~n³/6
// read-modify-writes of the factor go to device memory and L2, not
// registers, so the scratch traffic sets its time, as it did in K1's first
// design. K1 and K8 now give a matrix a warp with the factor in shared memory
// (warp_factor.cuh); K12 is the next to take that core.
//
// Input: a (n, n, nb) in (col, row, nb) order, lower half (row >= col) read.
// Output: out (n, n, nb) in the same order.

#include "common.cuh"

namespace slam {

template <typename T>
__global__ void __launch_bounds__(kThreads)
cholesky_kernel(const T* __restrict__ a, T* __restrict__ out, int n, long long nb) {
  const long long b = instance_index();
  if (b >= nb) return;
  T* oi = out + b;
  T dvec[kMaxN];
  bool ok = true;
  auto emit = [&](int, T piv) { ok = ok && piv > T(0); };
  equilibrated_core<T, true>(a + b, oi, nb, n, dvec, emit);
  if (!ok) {
    const T nan = d_nan(T(0));
    for (long long e = 0; e < static_cast<long long>(n) * n; ++e) oi[e * nb] = nan;
    return;
  }
  // the zeros above the diagonal are final; scale the rest: L(r, c) = s(c, r)·D_r
  for (int c = 0; c < n; ++c) {
    for (int r = c; r < n; ++r) oi[(static_cast<long long>(c) * n + r) * nb] *= dvec[r];
  }
}

template <typename T>
int launch_cholesky(const void* a, void* out, int n, long long nb, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  cholesky_kernel<T><<<blocks_for(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(out), n, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

extern "C" int slam_cholesky_f32(const void* a, void* out, int n, long long nb, void* stream) {
  return slam::launch_cholesky<float>(a, out, n, nb, stream);
}

extern "C" int slam_cholesky_f64(const void* a, void* out, int n, long long nb, void* stream) {
  return slam::launch_cholesky<double>(a, out, n, nb, stream);
}
