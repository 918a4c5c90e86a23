// CSR expansion gather on Hopper: the I_c2p materialization of the CPQx
// engine (classes -> their s-t pairs).
//
// Replaces the TPU kernel repro/kernels/expand_join.py (expand_join_gather,
// body _expand_kernel).  That kernel held the probe ranges and the build
// columns in VMEM and fused the binary search, the offset arithmetic and the
// three gathers over an output tile.  Here one thread owns one output row:
// it binary-searches its lane's inclusive-cumsum `ends`, then gathers.
// blockIdx.y is the lane (one query of a batch); the build columns b_v/b_u
// (the index's c2p arrays) are shared by every lane.
//
// For output row t of lane b:
//   t >= total[b]: all three outputs are SENTINEL;
//   else i  = first index with ends[b, i] > t        (searchsorted right)
//        i' = min(i, n_a - 1)
//        s  = i' > 0 ? ends[b, i' - 1] : 0
//        j  = clip(lo[b, i'] + t - s, 0, n_b - 1)
//        out = (b_v[j], b_u[j], a_payload[b, i']).
//
// Bound: bytes.  Each output row writes 12 bytes and reads 8 bytes of build
// columns; the probe side (ends, lo, a_payload) is small and stays in L2.
// Neighbouring threads read neighbouring build rows within a class, so the
// gathers coalesce.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSentinel = 0x7FFFFFFF;

__global__ void expand_join_gather_kernel(
    const int* __restrict__ ends, const int* __restrict__ lo,
    const int* __restrict__ a_payload, const int* __restrict__ b_v,
    const int* __restrict__ b_u, const int* __restrict__ total,
    int* __restrict__ out_v, int* __restrict__ out_u, int* __restrict__ out_a,
    int n_a, int n_b, int out_capacity) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= out_capacity) return;
  const long long lane = blockIdx.y;
  const long long o = lane * out_capacity + t;
  if (t >= total[lane]) {
    out_v[o] = kSentinel;
    out_u[o] = kSentinel;
    out_a[o] = kSentinel;
    return;
  }
  const int* e = ends + lane * n_a;
  int l = 0, h = n_a;
  while (l < h) {
    const int mid = (l + h) >> 1;
    if (e[mid] <= t) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  const int i = l < n_a - 1 ? l : n_a - 1;
  const int start = i > 0 ? e[i - 1] : 0;
  long long j = static_cast<long long>(lo[lane * n_a + i]) + (t - start);
  j = j < 0 ? 0 : (j > n_b - 1 ? n_b - 1 : j);
  out_v[o] = b_v[j];
  out_u[o] = b_u[j];
  out_a[o] = a_payload[lane * n_a + i];
}

}  // namespace

extern "C" int repro_expand_join_gather(const int* ends, const int* lo,
                                        const int* a_payload, const int* b_v,
                                        const int* b_u, const int* total,
                                        int* out_v, int* out_u, int* out_a,
                                        int lanes, int n_a, int n_b,
                                        int out_capacity, void* stream) {
  if (lanes <= 0 || out_capacity <= 0) return 0;
  const dim3 grid((out_capacity + kThreads - 1) / kThreads, lanes);
  expand_join_gather_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      ends, lo, a_payload, b_v, b_u, total, out_v, out_u, out_a, n_a, n_b,
      out_capacity);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
