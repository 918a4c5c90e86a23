// Two-lane avalanche row fingerprint on Hopper: the signature-set hashing of
// index construction (Algorithm 1's per-pair set grouping in bisim, and the
// iaCPQx class ids).
//
// Replaces the TPU kernel repro/kernels/fingerprint.py (fingerprint_rows,
// body _fp_kernel).  That kernel tiled the rows into VMEM blocks of 2048 and
// ran the whole mix chain of every column over a tile in vector registers.
// Here one thread owns one row: it reads the row's k int32 values (one
// coalesced load per column), chains them through mix32 in registers with
// native wrapping uint32 arithmetic, and writes both lanes once.
//
// For row r with columns c_0..c_{k-1} (each reinterpreted as uint32):
//   h1 = 0x9E3779B9, h2 = 0x85EBCA6B
//   for j in 0..k-1:
//     h1 = mix32(c_j ^ (h1 * 31), 2*salt + 101 + j)
//     h2 = mix32(c_j ^ (h2 * 37), 2*salt + 202 + j)
//   mix32(h, s): h ^= s; h = (h ^ h>>16) * 0x7FEB352D;
//                h = (h ^ h>>15) * 0x846CA68B; h ^= h>>16.
// Both lanes are written as int64 holding the uint32 value (in [0, 2^32)),
// the representation of the plain PyTorch version, so the consumers
// (segment sums, sort-key splitting) take them unchanged.
//
// The column pointers travel by value in a small struct (at most kMaxCols),
// so the caller stacks nothing.
//
// Bound: bytes.  4*k bytes read and 16 bytes written per row; about 12
// integer operations per column and lane is far below the card's rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;

struct Cols {
  const int32_t* p[kMaxCols];
};

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t salt) {
  h ^= salt;
  h = (h ^ (h >> 16)) * 0x7FEB352Du;
  h = (h ^ (h >> 15)) * 0x846CA68Bu;
  return h ^ (h >> 16);
}

__global__ void fingerprint_rows_kernel(Cols cols, int n_cols, int n,
                                        uint32_t salt1, uint32_t salt2,
                                        long long* __restrict__ out1,
                                        long long* __restrict__ out2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  uint32_t h1 = 0x9E3779B9u;
  uint32_t h2 = 0x85EBCA6Bu;
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    if (j < n_cols) {
      const uint32_t c = static_cast<uint32_t>(__ldg(cols.p[j] + r));
      h1 = mix32(c ^ (h1 * 31u), salt1 + static_cast<uint32_t>(j));
      h2 = mix32(c ^ (h2 * 37u), salt2 + static_cast<uint32_t>(j));
    }
  }
  out1[r] = static_cast<long long>(h1);
  out2[r] = static_cast<long long>(h2);
}

}  // namespace

// cols: host array of n_cols device pointers (1 <= n_cols <= 8), each to n
// int32 values.  salt1 = (2*salt + 101) mod 2^32, salt2 = (2*salt + 202)
// mod 2^32.  out1/out2: n int64 each.  Returns the CUDA error of the launch.
extern "C" int repro_fingerprint_rows(const void* const* cols, int n_cols,
                                      int n, unsigned int salt1,
                                      unsigned int salt2, long long* out1,
                                      long long* out2, void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  Cols c = {};
  for (int j = 0; j < n_cols; ++j) {
    c.p[j] = static_cast<const int32_t*>(cols[j]);
  }
  const int grid = (n + kThreads - 1) / kThreads;
  fingerprint_rows_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      c, n_cols, n, salt1, salt2, out1, out2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
