// Sorted-set membership on Hopper: the class-space CONJUNCTION of the CPQx
// engine (Prop. 4.1, class-id list intersection).
//
// Replaces the TPU kernel repro/kernels/sorted_intersect.py
// (sorted_member_mask, body _intersect_kernel).  That kernel broadcast the
// whole haystack into VMEM and ran a fixed-trip-count vectorized binary
// search per query block.  Here one thread owns one query and binary-searches
// its lane's haystack in device memory; blockIdx.y is the lane (one query of
// a batch), so a batch is one launch.
//
// out[b, i] = 1 iff queries[b, i] occurs in sorted hay[b, 0:hay_count[b]],
// else 0.  SENTINEL queries never match, because valid hay values are below
// SENTINEL.
//
// Bound: bytes.  Each query is read once and each flag written once (8 bytes
// a query); the haystack is read log2(n_hay) times per query, but class-id
// lists are small and stay in L2 across the block, so device memory sees
// roughly one pass over hay per lane.  The search loop is data-dependent and
// short; there is no arithmetic to speak of.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void sorted_member_mask_kernel(const int* __restrict__ hay,
                                          const int* __restrict__ hay_count,
                                          const int* __restrict__ queries,
                                          int* __restrict__ out, int n_hay,
                                          int n_q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const long long lane = blockIdx.y;
  const int* h = hay + lane * n_hay;
  const int q = queries[lane * n_q + i];
  int count = hay_count[lane];
  count = count < 0 ? 0 : (count > n_hay ? n_hay : count);
  // first position in [0, count) whose value is >= q
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (h[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[lane * n_q + i] = (lo < count && h[lo] == q) ? 1 : 0;
}

}  // namespace

extern "C" int repro_sorted_member_mask(const int* hay, const int* hay_count,
                                        const int* queries, int* out,
                                        int lanes, int n_hay, int n_q,
                                        void* stream) {
  if (lanes <= 0 || n_q <= 0) return 0;
  const dim3 grid((n_q + kThreads - 1) / kThreads, lanes);
  sorted_member_mask_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      hay, hay_count, queries, out, n_hay, n_q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
