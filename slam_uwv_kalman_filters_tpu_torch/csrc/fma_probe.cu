// K13 · the card's float32 FMA ceiling: a roofline probe.
//
// Replaces the TPU kernel tools/roofline.py::measure_vpu_fma (its pallas_call
// body): four independent float32 chains a_k = a_k·b + a per element, kChain/4
// steps each, started at a, a+1, a+2, a+3, and out = (a0+a1+a2+a3)·1e-3, which
// keeps a carry chained from launch to launch bounded.
//
// Bound on Hopper: operations, by design. Each element reads 8 bytes and
// writes 4 against 2·kChain = 1024 float32 operations, ~85 operations a byte,
// well above the card's float32 ridge (67e12 / 3.35e12 = 20 operations a
// byte). One thread per element; the four chains are independent so that a
// warp issues an FMA every cycle while each chain waits on its last one, and
// the whole chain is unrolled so the loop costs no instructions. The fused
// multiply-add is written out (fmaf), so the count of operations is exact.
//
// Inputs: a (n,), b (n,) float32. Output: out (n,) float32.

#include <cuda_runtime.h>

namespace slam {

constexpr int kChain = 512;         // multiply-adds per element, over the four chains
constexpr int kProbeThreads = 256;  // threads per block

__global__ void __launch_bounds__(kProbeThreads)
fma_probe_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
                 long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float av = a[i], bv = b[i];
  float a0 = av, a1 = av + 1.0f, a2 = av + 2.0f, a3 = av + 3.0f;
#pragma unroll
  for (int s = 0; s < kChain / 4; ++s) {
    a0 = fmaf(a0, bv, av);
    a1 = fmaf(a1, bv, av);
    a2 = fmaf(a2, bv, av);
    a3 = fmaf(a3, bv, av);
  }
  out[i] = (a0 + a1 + a2 + a3) * 1e-3f;
}

}  // namespace slam

extern "C" int slam_fma_probe_f32(const void* a, const void* b, void* out, long long n, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + slam::kProbeThreads - 1) / slam::kProbeThreads);
  slam::fma_probe_kernel<<<blocks, slam::kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
