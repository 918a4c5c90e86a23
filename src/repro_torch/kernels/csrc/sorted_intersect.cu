// Sorted-set membership on Hopper: the class-space CONJUNCTION of the CPQx
// engine (Prop. 4.1, class-id list intersection).
//
// Replaces the TPU kernel repro/kernels/sorted_intersect.py
// (sorted_member_mask, body _intersect_kernel).  That kernel put the whole
// haystack in VMEM and ran a fixed-trip-count, branch-free binary search per
// query block.
//
// out[b, i] = 1 iff queries[b, i] occurs in sorted hay[b, 0:hay_count[b]],
// else 0, with hay_count clamped to [0, n_hay].  SENTINEL queries never
// match, because valid hay values are below SENTINEL.
//
// What bounds it here.  The bytes are few (a query read and a flag written,
// the haystack once), so at the path's sizes the time is the launch plus
// the latency of the search: a binary search is a chain of log2(count) + 1
// dependent loads, and from device memory each link costs an L2 (or HBM)
// round trip.  The design: blockIdx.y is the lane and blockIdx.x a chunk of
// 256 queries, one thread a query, its query loaded first so that the load
// overlaps what follows.  When the haystack fits the shared-memory budget
// that the wrapper computes (sorted_intersect.launch_plan), each block
// first copies the lane's live ids hay[b, :count] (not the SENTINEL
// padding) into dynamic shared memory with 16-byte loads, one round trip
// for the whole row, and then searches shared memory, where a link of the
// chain costs tens of cycles.  Every block of a lane makes its own copy,
// whose cost grows with the haystack while the search it saves grows with
// its log: the budget, 24 KB (6 144 ids, six 16-byte loads a thread), is
// the largest size at which staging was measured to win at 16 query blocks
// a lane (it lost at 48 KB).  A larger haystack is searched in place, by
// the same kernel on its other path.  Either path runs a fixed number of steps, bit_length(count),
// uniform across the block, with the TPU kernel's branch-free update.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 48 * 1024;  // dynamic shared memory without opt-in

// First position in [0, count) whose value is >= q (count when none), in
// `steps` >= bit_length(count) branch-free steps.
__device__ __forceinline__ int lower_bound(const int* h, int count, int steps,
                                           int q) {
  int lo = 0, hi = count;
  for (int k = 0; k < steps; ++k) {
    const int mid = (lo + hi) >> 1;
    const int v = h[mid < count ? mid : count - 1];
    const bool active = lo < hi;
    const bool right = v < q;
    lo = (active && right) ? mid + 1 : lo;
    hi = (active && !right) ? mid : hi;
  }
  return lo;
}

__device__ __forceinline__ int member(const int* h, int count, int steps,
                                      int q) {
  const int lo = lower_bound(h, count, steps, q);
  return (lo < count && h[lo] == q) ? 1 : 0;
}

// Copies h[0:count] into s[0:count]: a scalar head up to the first 16-byte
// boundary of h, 16-byte loads for the body, a scalar tail.
__device__ __forceinline__ void stage(const int* __restrict__ h, int count,
                                      int* s) {
  const int head_bytes =
      static_cast<int>((16 - (reinterpret_cast<std::uintptr_t>(h) & 15)) & 15);
  const int head = min(count, head_bytes >> 2);
  if (threadIdx.x < head) s[threadIdx.x] = __ldg(h + threadIdx.x);
  const int n4 = (count - head) >> 2;
  const int4* h4 = reinterpret_cast<const int4*>(h + head);
  for (int k = threadIdx.x; k < n4; k += kThreads) {
    const int4 v = __ldg(h4 + k);
    int* d = s + head + 4 * k;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int k = head + 4 * n4 + threadIdx.x; k < count; k += kThreads) {
    s[k] = __ldg(h + k);
  }
}

// No __launch_bounds__: with it, ptxas held the kernel to 32 registers and
// spilled the prefetched query across the barrier.
__global__ void sorted_member_mask_kernel(const int* __restrict__ hay,
                                          const int* __restrict__ hay_count,
                                          const int* __restrict__ queries,
                                          int* __restrict__ out, int n_hay,
                                          int n_q, bool staged) {
  extern __shared__ int s_hay[];
  const long long lane = blockIdx.y;
  const int* h = hay + lane * n_hay;
  int count = __ldg(hay_count + lane);
  count = count < 0 ? 0 : (count > n_hay ? n_hay : count);
  const int steps = count > 0 ? 32 - __clz(count) : 0;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const long long at = lane * n_q + i;
  const int q = i < n_q ? __ldg(queries + at) : 0;
  if (staged) {
    stage(h, count, s_hay);
    __syncthreads();
    if (i < n_q) out[at] = member(s_hay, count, steps, q);
  } else if (i < n_q) {
    out[at] = member(h, count, steps, q);
  }
}

}  // namespace

// hay (lanes, n_hay), hay_count (lanes,), queries and out (lanes, n_q): int32,
// row-major.  shared_bytes > 0 stages each lane's haystack in that many bytes
// of dynamic shared memory (at least 4 * n_hay, at most 48 KB); 0 searches
// it in device memory.  Returns the CUDA error of the launch.
extern "C" int repro_sorted_member_mask(const int* hay, const int* hay_count,
                                        const int* queries, int* out,
                                        int lanes, int n_hay, int n_q,
                                        int shared_bytes, void* stream) {
  if (lanes <= 0 || n_q <= 0) return 0;
  if (shared_bytes < 0 || shared_bytes > kMaxSharedBytes ||
      (shared_bytes > 0 && shared_bytes < 4LL * n_hay)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_q + kThreads - 1) / kThreads, lanes);
  sorted_member_mask_kernel<<<grid, kThreads, shared_bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      hay, hay_count, queries, out, n_hay, n_q, shared_bytes > 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
