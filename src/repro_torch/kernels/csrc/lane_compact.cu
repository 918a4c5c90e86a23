// Lane-batched stable compaction on Hopper: rel_compact of the relational
// substrate (class and pair conjunctions, intersections, the dedup after
// every sort, the index build's dedups).
//
// Replaces no TPU kernel: the reference's rel_compact
// (src/repro/core/relational.py, rel_compact) is a stable lax.sort on a 0/1
// key, which XLA compiles.  It was added because the plain version's
// lane-batched cumsum of the keep mask (an int64 scan that PyTorch runs with
// one block a lane walking the whole lane) took 21-32 % of the query cells'
// device time: a launch of 4-16 lanes ran on 4-16 of the card's 132 SMs.
//
// For lane b with count n and keep mask m, row r < cap is kept when r < n
// and m[b, r] != 0.  Kept row r goes to slot kept_before(r); every other
// row, padding included, writes SENTINEL to slot
// new_count + dropped_before(r).  So every slot of [0, cap) is written
// exactly once, as a stable partition, and nothing is pre-filled.
//
// Design: reduce-then-scan over tiles of 256 threads x R rows, on a
// (tiles, lanes) grid, so that a launch of a few lanes still fills the
// card.  R is 16 (4 096-row tiles), or 4 where 4 096-row tiles would give
// the card fewer than 2 blocks an SM (one lane of up to ~1 M rows, as the
// index build has): the tile count follows cap and lanes, nothing else.
//   1. count: each block counts the kept rows of its tile.
//   2. scan:  one block a lane turns its tile counts into exclusive offsets
//             in place and writes the lane's new count.
//   3. move:  each block reads its tile's mask again and ranks its kept
//             rows: __popc of each thread's R keep bits, a shuffle scan in
//             each warp and shared memory across the warps, then
//             __ballot_sync/__popc over each warp's 32 consecutive rows as
//             it moves them.  Neighbouring threads read neighbouring rows
//             and write neighbouring slots.
// The scan and the move are launched as programmatic dependents
// (griddepcontrol): each starts while the kernel before it runs, and the
// move ranks its tile from the mask before it waits for the offsets.  A
// load of what the previous kernel wrote is volatile, so that it stays
// after the wait.  Integer sums, so the result is deterministic.  A thread
// loads its R mask bytes in one load where cap, the mask's lane stride and
// its address allow (cap % 16 == 0, as on the engine's power-of-two caps).
// Every column has its own lane stride, so a stride-0 (expanded) column is
// read in place.
//
// Bound: bytes.  What the function needs, a lane: the mask (cap bytes), the
// kept rows of each column read (4 x arity x kept) and every slot of each
// column written (4 x arity x cap).  This design reads the mask twice.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kSentinel = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kMaxCols = 8;
constexpr int kGroup = 4;  // rows a thread loads before it stores
constexpr int kFewBlocks = 264;  // 2 blocks an SM of the card's 132
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Mask {
  const uint8_t* p;
  long long lane_stride;  // bytes
};

struct Cols {
  const int32_t* src[kMaxCols];
  long long src_lane_stride[kMaxCols];  // elements; 0 for a shared column
  int32_t* dst[kMaxCols];               // (lanes, cap), contiguous
};

// Programmatic dependent launch: a kernel lets the next one in the stream
// start (launch_dependents), and waits for the previous one's results
// (wait) only where it first reads them.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// A load of what the previous kernel wrote, after wait_for_previous: a
// volatile load, which the compiler keeps after the wait and which reads
// through L2 (a read-only load could be hoisted above it and read stale
// data).
__device__ __forceinline__ int load_fresh(const int* p) {
  return *static_cast<const volatile int*>(p);
}

// The keep bits of one lane's rows [row0, row0 + R): bit i for row0 + i.
// Rows at and past cap or the lane's count n are not kept.
template <bool kVec, int R>
__device__ __forceinline__ unsigned keep_bits(const uint8_t* m, long long row0,
                                              long long cap, long long n) {
  unsigned bits = 0;
  if (kVec) {
    if (row0 < cap) {  // cap % 16 == 0: all R rows lie below cap
      unsigned w[R / 4];
      if constexpr (R == 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(m + row0));
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else {
        static_assert(R == 4, "R is 4 or 16");
        w[0] = __ldg(reinterpret_cast<const unsigned*>(m + row0));
      }
#pragma unroll
      for (int k = 0; k < R / 4; ++k) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          bits |= (((w[k] >> (8 * b)) & 0xFFu) ? 1u : 0u) << (4 * k + b);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (row0 + i < cap && m[row0 + i]) bits |= 1u << i;
    }
  }
  if (n <= row0) return 0;
  if (n < row0 + R) bits &= (1u << (n - row0)) - 1u;
  return bits;
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

template <bool kVec, int R>
__global__ void __launch_bounds__(kThreads)
    lane_compact_count(Mask mask, const int* __restrict__ count, int cap,
                       int tiles, int* __restrict__ tile_counts) {
  __shared__ int warp_sums[kWarps];
  let_next_start();
  const int lane = blockIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * (kThreads * R) +
                         threadIdx.x * R;
  const unsigned bits = keep_bits<kVec, R>(mask.p + lane * mask.lane_stride,
                                           row0, cap, count[lane]);
  const int c = __reduce_add_sync(kFull, __popc(bits));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    tile_counts[static_cast<long long>(lane) * tiles + blockIdx.x] = s;
  }
}

// One block a lane: the lane's tile counts -> exclusive offsets, in place;
// their sum is the lane's new count.
__global__ void __launch_bounds__(kScanThreads)
    lane_compact_scan(int* tile_counts, int tiles, int* new_count) {
  __shared__ int warp_sums[kScanThreads / 32];
  let_next_start();
  wait_for_previous();
  int* p = tile_counts + static_cast<long long>(blockIdx.x) * tiles;
  const int t = threadIdx.x;
  const int wl = t & 31;
  const int w = t >> 5;
  int carry = 0;
  for (int base = 0; base < tiles; base += kScanThreads) {
    const int i = base + t;
    const int v = i < tiles ? load_fresh(p + i) : 0;
    const int x = warp_inclusive_scan(v, wl);
    if (wl == 31) warp_sums[w] = x;
    __syncthreads();
    if (w == 0) warp_sums[wl] = warp_inclusive_scan(warp_sums[wl], wl);
    __syncthreads();
    if (i < tiles) p[i] = carry + (w > 0 ? warp_sums[w - 1] : 0) + x - v;
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // the next chunk rewrites warp_sums
  }
  if (t == 0) new_count[blockIdx.x] = carry;
}

template <bool kVec, int R, int kCols>
__global__ void __launch_bounds__(kThreads, 4)
    lane_compact_move(Mask mask, const int* __restrict__ count,
                      const int* tile_offsets, const int* new_count,
                      Cols cols, int cap,
                      int tiles) {
  __shared__ unsigned short bits_of[kThreads];
  __shared__ int before_of[kThreads];  // kept rows of the tile before t's R
  __shared__ int warp_sums[kWarps];
  const int lane = blockIdx.y;
  const long long tile0 = static_cast<long long>(blockIdx.x) * (kThreads * R);
  const int t = threadIdx.x;
  const int wl = t & 31;
  const int w = t >> 5;
  // the tile's own ranks need only the inputs: they overlap the scan
  const unsigned bits = keep_bits<kVec, R>(mask.p + lane * mask.lane_stride,
                                           tile0 + t * R, cap, count[lane]);
  const int c = __popc(bits);
  const int x = warp_inclusive_scan(c, wl);
  if (wl == 31) warp_sums[w] = x;
  __syncthreads();
  int off = 0;
  for (int k = 0; k < w; ++k) off += warp_sums[k];
  bits_of[t] = static_cast<unsigned short>(bits);
  before_of[t] = off + x - c;
  __syncthreads();

  wait_for_previous();
  const int base =
      load_fresh(tile_offsets + static_cast<long long>(lane) * tiles + blockIdx.x);
  const int kept = load_fresh(new_count + lane);
  const long long out0 = static_cast<long long>(lane) * cap;
  const unsigned below = (1u << wl) - 1u;
  constexpr int G = R < kGroup ? R : kGroup;
  // G rows a thread at a time: every load of the group is issued before
  // the first store, so the loads are in flight together.
#pragma unroll 1
  for (int j0 = 0; j0 < R; j0 += G) {
    int slot[G];
    int val[G][kCols];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = (j0 + g) * kThreads + t;  // a warp's 32 rows: consecutive
      const long long row = tile0 + r;
      const unsigned keep = (bits_of[r / R] >> (r % R)) & 1u;
      const unsigned warp_keep = __ballot_sync(kFull, keep);
      // kept rows of the lane before row: earlier tiles, the tile's rows
      // before the warp's first row, earlier threads of the warp
      const int kb = base + before_of[(r & ~31) / R] + __popc(warp_keep & below);
      slot[g] = row >= cap ? -1 : keep ? kb : kept + static_cast<int>(row - kb);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        val[g][k] = keep ? __ldg(cols.src[k] + lane * cols.src_lane_stride[k] + row)
                         : kSentinel;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (slot[g] < 0) continue;
#pragma unroll
      for (int k = 0; k < kCols; ++k) cols.dst[k][out0 + slot[g]] = val[g][k];
    }
  }
}

struct Launch {
  Mask mask;
  const int* count;
  Cols cols;
  int lanes, cap;
  int* tile_offsets;
  int* new_count;
  cudaStream_t stream;
};

// A launch that may start before the previous kernel of the stream ends;
// the kernel waits for its results where it reads them.
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, int threads,
                         cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

template <bool kVec, int R, int kCols>
cudaError_t launch(const Launch& a) {
  const int tiles = static_cast<int>(
      (static_cast<long long>(a.cap) + kThreads * R - 1) / (kThreads * R));
  const dim3 grid(tiles, a.lanes);
  lane_compact_count<kVec, R><<<grid, kThreads, 0, a.stream>>>(
      a.mask, a.count, a.cap, tiles, a.tile_offsets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_after(lane_compact_scan, dim3(a.lanes), kScanThreads, a.stream,
                     a.tile_offsets, tiles, a.new_count);
  if (err != cudaSuccess) return err;
  return launch_after(lane_compact_move<kVec, R, kCols>, grid, kThreads,
                      a.stream, a.mask, a.count,
                      static_cast<const int*>(a.tile_offsets),
                      static_cast<const int*>(a.new_count), a.cols, a.cap,
                      tiles);
}

// The column count is a template parameter, so the move keeps only the
// pointers it uses in registers.
template <bool kVec, int R, int kCols = 1>
cudaError_t launch_cols(int n_cols, const Launch& a) {
  if constexpr (kCols < kMaxCols) {
    if (n_cols > kCols) return launch_cols<kVec, R, kCols + 1>(n_cols, a);
  }
  return launch<kVec, R, kCols>(a);
}

// 16 rows a thread; 4 where that leaves the card with few blocks.
template <bool kVec>
cudaError_t launch_rows(int n_cols, const Launch& a) {
  const long long tiles16 = (static_cast<long long>(a.cap) + 4095) / 4096;
  if (tiles16 * a.lanes < kFewBlocks) {
    return launch_cols<kVec, 4>(n_cols, a);
  }
  return launch_cols<kVec, 16>(n_cols, a);
}

}  // namespace

// mask: (lanes, cap) bytes, nonzero = keep, rows at a lane stride of
// mask_lane_stride bytes.  count: lanes int32.  src/src_lane_stride/dst:
// host arrays of n_cols (1 to 8) device pointers and lane strides (in
// elements) of the input columns, and of the (lanes, cap) contiguous output
// columns.  tile_offsets: lanes x ceil(cap / 1024) int32 of scratch.
// new_count: lanes int32.  1 <= lanes <= 65535.  Returns the CUDA error of
// the launches.
extern "C" int repro_lane_compact(const void* mask, long long mask_lane_stride,
                                  const int* count, const void* const* src,
                                  const long long* src_lane_stride,
                                  void* const* dst, int n_cols, int lanes,
                                  int cap, int* tile_offsets, int* new_count,
                                  void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols || lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lanes <= 0 || cap <= 0) return 0;
  Cols c = {};
  for (int k = 0; k < n_cols; ++k) {
    c.src[k] = static_cast<const int32_t*>(src[k]);
    c.src_lane_stride[k] = src_lane_stride[k];
    c.dst[k] = static_cast<int32_t*>(dst[k]);
  }
  const Mask m = {static_cast<const uint8_t*>(mask), mask_lane_stride};
  const Launch a = {m, count, c, lanes, cap, tile_offsets, new_count,
                    static_cast<cudaStream_t>(stream)};
  const bool vec = cap % 16 == 0 && mask_lane_stride % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const cudaError_t err =
      vec ? launch_rows<true>(n_cols, a) : launch_rows<false>(n_cols, a);
  return static_cast<int>(err);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
