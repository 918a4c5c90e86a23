// Fused normalize pass of the segment softmax on Hopper: the GNN substrate's
// per-destination edge softmax (GAT-style attention, edge gates).
//
// Replaces the TPU kernel repro/kernels/segment_softmax.py (segment_softmax,
// body _norm_kernel).  That kernel cut the edges into VMEM blocks of 512 rows
// (asserting E % 512 == 0), held the whole (N, D) max and denominator tables
// in VMEM beside each block, and did both gathers, the exp and the divide in
// one pass.  Here one thread owns one (e, d) element: neighbouring threads
// read neighbouring scores and write neighbouring outputs (coalesced), read
// their row's segment id (one id shared by the D threads of a row), and
// gather the two table entries of their segment, which lie next to each
// other for neighbouring d.  A ragged E needs no padding: the last block
// masks its tail.
//
//   s        = clamp(segment_ids[e], 0, N - 1)
//   out[e,d] = expf(x[e,d] - mx[s,d]) / (den[s,d] + eps)
//
// x and out are float32 or bfloat16; the tables are float32 (the wrapper's
// reductions accumulate in float32).  Each element is read in its own type,
// computed in float32 with the accurate expf and an IEEE divide (the file is
// built without --use_fast_math), and rounded once, to nearest even, on the
// store.  The segment max and sum stay outside this kernel, as they stayed
// outside the Pallas call.
//
// Bound: bytes.  Per element it reads x and writes out (4 or 2 bytes each),
// and per row one int32 id; the tables are read once where segments are
// distinct and hit L2 where rows share a segment.  About 20 float operations
// per element (subtract, exp, add, divide) are far below the card's rate.
// Nothing is staged in shared memory: no element is read twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void segment_normalize_kernel(const T* __restrict__ x,
                                         const int* __restrict__ seg,
                                         const float* __restrict__ mx,
                                         const float* __restrict__ den,
                                         T* __restrict__ out, int n, int d,
                                         int n_seg, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int e = i / d;
  const int c = i - e * d;
  int s = __ldg(seg + e);
  s = s < 0 ? 0 : (s >= n_seg ? n_seg - 1 : s);
  const long long t = static_cast<long long>(s) * d + c;
  const float v = expf(load_f(x + i) - __ldg(mx + t)) / (__ldg(den + t) + eps);
  store_f(out + i, v);
}

template <typename T>
int launch(const void* x, const int* seg, const float* mx, const float* den,
           void* out, int n, int d, int n_seg, float eps, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  segment_normalize_kernel<T><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), seg, mx, den, static_cast<T*>(out), n, d,
      n_seg, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: n = E * D elements of the scores' type (dtype 0: float32, 1:
// bfloat16), row-major (E, D).  seg: E int32.  mx, den: (n_seg, D) float32.
// Returns the CUDA error of the launch.
extern "C" int repro_segment_normalize(const void* x, const int* seg,
                                       const float* mx, const float* den,
                                       void* out, int n, int d, int n_seg,
                                       float eps, int dtype, void* stream) {
  if (d <= 0 || n_seg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return launch<float>(x, seg, mx, den, out, n, d, n_seg, eps, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, seg, mx, den, out, n, d, n_seg, eps,
                                 stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
