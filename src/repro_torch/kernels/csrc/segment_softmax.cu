// Fused normalize pass of the segment softmax on Hopper: the GNN substrate's
// per-destination edge softmax (GAT-style attention, edge gates).
//
// Replaces the TPU kernel repro/kernels/segment_softmax.py (segment_softmax,
// body _norm_kernel).  That kernel cut the edges into VMEM blocks of 512 rows
// (asserting E % 512 == 0), held the whole (N, D) max and denominator tables
// in VMEM beside each block, and did both gathers, the exp and the divide in
// one pass.
//
//   s        = clamp(segment_ids[e], 0, N - 1)
//   out[e,d] = expf(x[e,d] - table[s,d,0]) / (table[s,d,1] + eps)
//
// What bounds it here.  The bytes it must move are the streamed scores, ids
// and outputs plus the table once; at D = 1 with receivers spread over the
// nodes, though, every element gathers a table entry of a random segment, and
// each such gather costs L2 a whole 32-byte sector.  So the L2's random-sector
// rate, and the loads each thread keeps in flight, decide the time, not the
// stream.  The design, against each of those costs:
//
// * One table.  The max and the sum sit side by side in one (N, D, 2) float32
//   table (ref.segment_tables fills it), so an element gathers one aligned
//   8-byte float2 from one sector, not two 4-byte words from two tables.
// * Several gathers in flight.  At D = 1 a thread takes 4 float32 or 8
//   bfloat16 consecutive elements: one 16-byte load of scores, 16-byte loads
//   of their ids, all 4-8 table gathers issued before any is used, one 16-byte
//   store.  A ragged tail, or a base not on 16 bytes, takes the scalar path of
//   the same thread.  At D > 1 a block takes a tile of whole rows: it reads
//   each row's id once into shared memory, then walks the tile's elements with
//   coalesced loads, kUnroll of them in flight a thread, stepping (row, col)
//   by additions (one division a thread, none per element).
// * Small launches.  Below one wave of resident threads (E * D under
//   132 SMs x 2048 on the H100) the time is the launch and two dependent
//   round trips whatever the layout, and a tile's prologue and barrier only
//   add to it; there a thread takes one element, any D, and reads its row's
//   id itself.
// * The table stays in L2.  Scores and ids are read with evict-first loads
//   (__ldcs) and outputs written with evict-first stores (__stcs), so the
//   stream does not push the table (19.6 MB at ogb_products) out of the
//   50 MB L2.  No device-wide persisting-L2 window is set.
//
// Numerics: x and out are float32 or bfloat16, the table float32.  Each
// element is computed in float32 with the accurate expf and an IEEE divide
// (the file is built without --use_fast_math) and rounded once, to nearest
// even, on the store: bit for bit what ref.segment_normalize computes from
// the same table.  The segment max and sum stay outside this kernel, as they
// stayed outside the Pallas call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                       // elements in flight a thread, D > 1
constexpr int kTileElems = kThreads * kUnroll;   // elements of a row tile, D > 1
constexpr int kMaxTileRows = kTileElems / 2;     // rows of a tile at D = 2

__device__ __forceinline__ float load_cs(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_cs(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store_cs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ int clamp_seg(int s, int n_seg) {
  return s < 0 ? 0 : (s >= n_seg ? n_seg - 1 : s);
}

__device__ __forceinline__ float normalize(float x, float2 t, float eps) {
  return expf(x - t.x) / (t.y + eps);
}

// Scores of one 16-byte vector as floats, and floats back into one vector.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[kN]) {
    const float4 r = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[kN]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[kN]) {
    const uint4 r = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[kN]) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]));
      const unsigned hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1]));
      w[k] = lo | (hi << 16);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

// D = 1: thread t owns elements [t*V, t*V + V), V = Vec<T>::kN.  `vec` says
// that x, seg and out all start on 16 bytes; then every full group takes
// the vector path, and a ragged tail or a misaligned base the scalar one.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    normalize_d1_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                        const float2* __restrict__ table, T* __restrict__ out,
                        long long n, int n_seg, float eps, bool vec) {
  constexpr int V = Vec<T>::kN;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (i0 >= n) return;
  float v[V];
  float2 t[V];
  if (vec && i0 + V <= n) {
    Vec<T>::load(x + i0, v);
    int s[V];
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const int4 r = __ldcs(reinterpret_cast<const int4*>(seg + i0 + k));
      s[k] = r.x; s[k + 1] = r.y; s[k + 2] = r.z; s[k + 3] = r.w;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) t[k] = __ldg(table + clamp_seg(s[k], n_seg));
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = normalize(v[k], t[k], eps);
    Vec<T>::store(out + i0, v);
    return;
  }
  const int m = n - i0 < V ? static_cast<int>(n - i0) : V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k < m) {
      v[k] = load_cs(x + i0 + k);
      t[k] = __ldg(table + clamp_seg(__ldcs(seg + i0 + k), n_seg));
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k < m) store_cs(out + i0 + k, normalize(v[k], t[k], eps));
  }
}

// Below one wave of resident threads, any D: one element a thread, which
// finds its row with one division and reads the row's id itself.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    normalize_elems_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                           const float2* __restrict__ table,
                           T* __restrict__ out, int n, int d, int n_seg,
                           float eps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int e = d == 1 ? i : i / d;
  const int s = clamp_seg(__ldcs(seg + e), n_seg);
  const float2 t = __ldg(table + static_cast<long long>(s) * d + (i - e * d));
  store_cs(out + i, normalize(load_cs(x + i), t, eps));
}

// D > 1: block b owns rows [b*tile_rows, (b+1)*tile_rows), tile_rows =
// max(1, kTileElems / d); its threads walk the tile's flat elements with
// stride kThreads, kUnroll at a time.  The first scores are loaded before the
// barrier that publishes the tile's ids, so the two loads overlap.
template <typename T>
struct RowWalk {
  float v[kUnroll];
  int at[kUnroll], row[kUnroll], col[kUnroll];
  int i, r, c;

  // Loads the scores of the next kUnroll elements and steps (i, r, c) past
  // them: by kThreads elements each, that is dr rows and dc columns.
  __device__ __forceinline__ void load(const T* xb, int n_el, int d, int dr,
                                       int dc) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      at[u] = i;
      row[u] = r;
      col[u] = c;
      if (i < n_el) v[u] = load_cs(xb + i);
      i += kThreads;
      r += dr;
      c += dc;
      if (c >= d) {
        c -= d;
        ++r;
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    normalize_rows_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                          const float2* __restrict__ table,
                          T* __restrict__ out, int n_rows, int d, int n_seg,
                          int tile_rows, float eps) {
  __shared__ int s_seg[kMaxTileRows];
  const long long row0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = n_rows - row0 < tile_rows ? static_cast<int>(n_rows - row0)
                                             : tile_rows;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    s_seg[r] = clamp_seg(__ldcs(seg + row0 + r), n_seg);
  }
  const T* xb = x + row0 * d;
  T* ob = out + row0 * d;
  const int n_el = rows * d;
  const int dr = kThreads / d, dc = kThreads - dr * d;  // one stride, as (row, col)
  RowWalk<T> w;
  w.i = threadIdx.x;
  w.r = w.i / d;
  w.c = w.i - w.r * d;
  w.load(xb, n_el, d, dr, dc);
  __syncthreads();
  while (w.at[0] < n_el) {
    float2 t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (w.at[u] < n_el) {
        t[u] = __ldg(table + static_cast<long long>(s_seg[w.row[u]]) * d +
                     w.col[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (w.at[u] < n_el) {
        store_cs(ob + w.at[u], normalize(w.v[u], t[u], eps));
      }
    }
    w.load(xb, n_el, d, dr, dc);
  }
}

// Threads the card holds at once (132 SMs x 2048 on the H100).
int resident_threads() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  return sms * per_sm;
}

template <typename T>
int launch(const void* x, const int* seg, const float* table, void* out,
           int n_rows, int d, int n_seg, float eps, cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  T* os = static_cast<T*>(out);
  const float2* tab = reinterpret_cast<const float2*>(table);
  const long long n = static_cast<long long>(n_rows) * d;
  if (n < resident_threads()) {
    const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    normalize_elems_kernel<T><<<grid, kThreads, 0, stream>>>(
        xs, seg, tab, os, static_cast<int>(n), d, n_seg, eps);
  } else if (d == 1) {
    const bool vec = ((reinterpret_cast<std::uintptr_t>(x) |
                       reinterpret_cast<std::uintptr_t>(seg) |
                       reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
    const long long groups = (n + Vec<T>::kN - 1) / Vec<T>::kN;
    const unsigned grid = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
    normalize_d1_kernel<T><<<grid, kThreads, 0, stream>>>(xs, seg, tab, os, n,
                                                         n_seg, eps, vec);
  } else {
    const int tile_rows = d >= kTileElems ? 1 : kTileElems / d;
    const unsigned grid =
        static_cast<unsigned>((n_rows + tile_rows - 1) / tile_rows);
    normalize_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
        xs, seg, tab, os, n_rows, d, n_seg, tile_rows, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (n_rows, d) row-major elements of the scores' type (dtype 0:
// float32, 1: bfloat16), n_rows * d < 2^31.  seg: n_rows int32.  table:
// (n_seg, d, 2) float32, 8-byte aligned: [..., 0] the max, [..., 1] the sum.
// Returns the CUDA error of the launch.
extern "C" int repro_segment_normalize(const void* x, const int* seg,
                                       const float* table, void* out,
                                       int n_rows, int d, int n_seg, float eps,
                                       int dtype, void* stream) {
  if (d <= 0 || n_seg <= 0 || n_rows < 0 ||
      (reinterpret_cast<std::uintptr_t>(table) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, seg, table, out, n_rows, d, n_seg, eps, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, seg, table, out, n_rows, d, n_seg, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
