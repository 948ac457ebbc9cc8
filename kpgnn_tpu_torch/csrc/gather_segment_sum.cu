// Fused hop-major CSR gather/segment-sum for Hopper (sm_90a).
//
//   out[r, :] = sum over e in [indptr[r], indptr[r+1]) of
//               x[senders[e], :]  +  T_hop(r)[codes[e], :]
//
// Row r = k*N + i is node i at hop k, so one launch covers every hop of a
// layer's k-hop aggregation.  A sender id outside [0, n_cols) adds no x row
// (a null edge); n_rows may differ from n_cols (rectangular plans).  The
// table term is optional (codes == nullptr: a plain gather, which is also
// the backward pass over the transposed CSR): hop(r) = r / rows_per_hop,
// T_0 = table1 (v1 rows), T_k>=1 = tablek (vk rows), code 0 adds nothing.
// It folds the edge-embedding sum of the k-hop aggregate, which the JAX
// package computes as `counts @ table` matmuls plus an add after the
// kernel, into the gather.  x is f32 or bf16, tables and the sum are f32.
//
// Replaces the TPU kernel kpgnn_tpu/ops/pallas_spmm.py `_kernel` (:159),
// driven by `gather_segment_sum` (:294, pallas_call at :391), and the
// embedding epilogue of `khop_spmm` (:884-904).  That kernel turns the
// gather and the scatter into one-hot matmuls over sender windows because
// a TPU has no fast row gather; Hopper has one, so none of the window,
// tile-padding or VMEM machinery carries over.
//
// What bounds it: bytes.  Each output row is written once (n_rows*D*4),
// each gathered row of x read once, plus the CSR; the adds are far below
// the card's f32 rate.  At the loader's n_pad (the split's worst case) 3/4
// of the hop rows are padding with no edge, so most of the bytes are zero
// rows being written, and the live rows are light (~4 edges, at most 17 on
// the flagship batch).  What holds it back is latency: each live row waits
// on the dependent chain indptr -> senders -> x -> store.
//
// Design:
//  * A group of G lanes (G = 16 or 32, the least that covers a row in one
//    pass where it can) owns a run of R consecutive rows (kRowsPerWarp per
//    warp, measured on the flagship plan).  The run's indptr is read with
//    one coalesced load (lane j holds row j's range) and broadcast by
//    shuffle.  A run's edges are contiguous, so the group streams them as
//    one list: sender ids G at a time (one per lane), then kDepth gathered
//    rows in flight before they are added, across row boundaries; a row is
//    stored when the stream passes its end.
//  * Live runs first: the plan knows on the host where each hop's last row
//    with an edge is (hop_live), so the grid's first groups take every
//    hop's live runs and start their latency chains at once; the groups
//    after them take the dead suffixes (the padding) and only store zeros,
//    16 bytes per lane, without reading anything, while the chains wait.
//    A run never crosses a hop boundary, so its table is known up front.
//    A CSR without hop structure is one hop, all of it live.
//  * 16-byte loads and stores: a lane owns 4 f32 or 8 bf16 columns of a row
//    (f32 D = 104 is 26 lanes; bf16 D = 104 is 13 lanes of a 16-lane group,
//    two groups per warp).  x, the indices and the tables go through the
//    read-only path.  Where D*sizeof(x) is not a multiple of 16 or a base
//    pointer is not 16-byte aligned, the wrapper picks the scalar variant of
//    this same kernel (one element per lane).
//  * Null edges and code 0 are masked loads, not branches.  Adds run in a
//    fixed order, edge by edge (x row, then table row), so the kernel is
//    bitwise deterministic: no atomics, no split rows.  Heavy rows are
//    looped by their group.
//  * The tables (5 + 52 rows of 104 f32 for the flagship) are read through
//    L1 when an edge is added: a batch touches a handful of codes, so they
//    stay in L1, and holding them in registers beside the x rows in flight
//    cost more occupancy than the L1 latency costs.  Staging whole tables
//    in shared memory per block would move more bytes than the gather.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 4;           // gathered rows in flight per lane
constexpr int kRowsPerWarp = 2;     // receiver rows a warp owns
constexpr int kMaxHops = 16;        // hops a launch's run map holds

// rows a group of G lanes owns (a 16-lane group owns half a warp's)
template <int G>
__host__ __device__ constexpr int rows_per_group() {
  return kRowsPerWarp * G / 32;
}

struct Args {
  const void* x;
  const int* indptr;
  const int* senders;
  const int* codes;
  const float* table1;
  const float* tablek;
  float* out;
  int n_rows, n_cols, D, rows_per_hop, v1, vk;
  int n_hops;                       // n_hops * rows_per_hop == n_rows
};

// Which run a group owns.  Groups [0, live[n_hops]) take the runs of
// every hop's live prefix, hop by hop, so the latency-bound gathers all
// start first; the groups after them take the runs of the dead suffixes,
// which are only stored as zeros.  Runs never cross a hop boundary.
struct RunMap {
  int live[kMaxHops + 1];     // prefix sums of live runs per hop
  int dead[kMaxHops + 1];     // prefix sums of dead runs per hop
};

// v = the N elements of x at p as f32, or zeros when !ok (load predicated off)
template <typename T, int N>
__device__ __forceinline__ void load_x(const T* p, bool ok, float (&v)[N]) {
  if constexpr (N == 1) {
    if constexpr (std::is_same<T, float>::value) {
      v[0] = ok ? __ldg(p) : 0.f;
    } else {
      const unsigned short u =
          ok ? __ldg(reinterpret_cast<const unsigned short*>(p)) : 0;
      v[0] = __uint_as_float(static_cast<uint32_t>(u) << 16);
    }
  } else {
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (ok) q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (std::is_same<T, float>::value) {
        v[j] = __uint_as_float(w[j]);
      } else {                      // two bf16 per word, low half first
        v[2 * j] = __uint_as_float(w[j] << 16);
        v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void load_table(const float* p, bool ok,
                                           float (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = ok ? __ldg(p) : 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) q = __ldg(reinterpret_cast<const float4*>(p) + j);
      v[4 * j] = q.x; v[4 * j + 1] = q.y; v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  }
}

// store the row chunk, then reset the sum to zero
template <int N>
__device__ __forceinline__ void flush(float* p, bool ok, float (&acc)[N]) {
  if (ok) {
    if constexpr (N == 1) {
      *p = acc[0];
    } else {
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        reinterpret_cast<float4*>(p)[j] =
            make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                        acc[4 * j + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
}

// Capped at 64 registers (4 blocks, 32 warps per SM): the latency-bound
// chains need the warps more than the wider variants need the registers.
template <typename T, bool kVec, bool kFused, int G>
__global__ void __launch_bounds__(kThreads, 4)
gather_segment_sum_kernel(Args a, RunMap m) {
  constexpr int N = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  constexpr int R = rows_per_group<G>();
  const int g = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const int rph = a.rows_per_hop;
  const int n_live = m.live[a.n_hops];
  const bool dead = g >= n_live;            // all group-uniform
  int k = 0, row0;
  if (!dead) {
    while (g >= m.live[k + 1]) ++k;
    row0 = k * rph + (g - m.live[k]) * R;
  } else {
    const int gd = g - n_live;
    if (gd >= m.dead[a.n_hops]) return;
    while (gd >= m.dead[k + 1]) ++k;
    row0 = k * rph + (m.live[k + 1] - m.live[k] + gd - m.dead[k]) * R;
  }
  const int nrun = min(R, (k + 1) * rph - row0);
  const int C = a.D / N;                    // lane chunks per row
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  if (dead) {                               // no edge: zeros, no load
    for (int c0 = 0; c0 < C; c0 += G)
      for (int r = 0; r < nrun; ++r)
        flush<N>(a.out + ((row0 + r) * a.D + (c0 + gl) * N), c0 + gl < C, acc);
    return;
  }

  // the run's indptr in one coalesced load; lane j holds row j's range
  int lo = 0, hi = 0;
  if (gl < nrun) {
    lo = __ldg(a.indptr + row0 + gl);
    hi = __ldg(a.indptr + row0 + gl + 1);
  }
  const int e_lo = __shfl_sync(gmask, lo, 0, G);
  const int e_hi = __shfl_sync(gmask, hi, nrun - 1, G);
  // the run's hop picks its table: T_0 = table1, T_k>=1 = tablek
  const float* tab = k > 0 ? a.tablek : a.table1;
  const int v_tab = k > 0 ? a.vk : a.v1;

  // 32-bit offsets: the wrapper bounds n_rows*D and n_cols*D below 2^31
  const int D = a.D;
  for (int c0 = 0; c0 < C; c0 += G) {
    const int cc = c0 + gl;
    const bool col_ok = cc < C;
    const int col = cc * N;
    int cur = 0;                            // run row being summed
    int cur_end = __shfl_sync(gmask, hi, 0, G);
    for (int base = e_lo; base < e_hi; base += G) {
      int my_s = -1, my_c = 0;
      if (base + gl < e_hi) {
        my_s = __ldg(a.senders + base + gl);
        if (kFused) my_c = __ldg(a.codes + base + gl);
      }
      const int n = min(G, e_hi - base);
      for (int t = 0; t < n; t += kDepth) {
        float v[kDepth][N];
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {     // start kDepth loads ...
          const bool live = t + u < n;
          const int s = __shfl_sync(gmask, my_s, t + u, G);
          const bool ok = live && col_ok && s >= 0 && s < a.n_cols;
          load_x<T, N>(x + ((ok ? s : 0) * D + col), ok, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {     // ... then add them in order
          if (t + u < n) {
            const int e = base + t + u;
            while (e >= cur_end) {             // rows ending before e are done
              flush<N>(a.out + ((row0 + cur) * D + col), col_ok, acc);
              ++cur;
              cur_end = __shfl_sync(gmask, hi, cur, G);
            }
#pragma unroll
            for (int j = 0; j < N; ++j) acc[j] += v[u][j];
            if (kFused) {                      // table row: an L1 hit
              const int c = __shfl_sync(gmask, my_c, t + u, G);
              const bool okt = col_ok && c > 0 && c < v_tab;
              float w[N];
              load_table<N>(tab + ((okt ? c : 0) * D + col), okt, w);
#pragma unroll
              for (int j = 0; j < N; ++j) acc[j] += w[j];
            }
          }
        }
      }
    }
    for (; cur < nrun; ++cur)   // the last summed row, then empty rows
      flush<N>(a.out + ((row0 + cur) * D + col), col_ok, acc);
  }
}

template <typename T, bool kVec, bool kFused, int G>
void launch_g(const Args& a, const int* hop_live, cudaStream_t stream) {
  constexpr int R = rows_per_group<G>();
  static_assert(R >= 1 && R <= G, "a run is at most one row per lane");
  const int rph = a.rows_per_hop;
  RunMap m{};
  for (int k = 0; k < a.n_hops; ++k) {
    const int live = (hop_live[k] + R - 1) / R;
    m.live[k + 1] = m.live[k] + live;
    m.dead[k + 1] = m.dead[k] + (rph - min(rph, live * R) + R - 1) / R;
  }
  const int groups = m.live[a.n_hops] + m.dead[a.n_hops];
  const int per_block = kThreads / G;
  const int blocks = (groups + per_block - 1) / per_block;
  if (blocks > 0)
    gather_segment_sum_kernel<T, kVec, kFused, G>
        <<<blocks, kThreads, 0, stream>>>(a, m);
}

template <typename T, bool kVec, bool kFused>
void launch_v(const Args& a, const int* hop_live, cudaStream_t stream) {
  const int C = a.D / (kVec ? 16 / static_cast<int>(sizeof(T)) : 1);
  if (C > 16) launch_g<T, kVec, kFused, 32>(a, hop_live, stream);
  else launch_g<T, kVec, kFused, 16>(a, hop_live, stream);
}

template <typename T>
int launch(const Args& a, int vec, const int* hop_live, void* stream_ptr) {
  if (a.n_rows == 0 || a.D == 0) return static_cast<int>(cudaSuccess);
  if (a.n_hops < 1 || a.n_hops > kMaxHops ||
      static_cast<int64_t>(a.n_hops) * a.rows_per_hop != a.n_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool fused = a.codes != nullptr;
  if (vec) {
    if (fused) launch_v<T, true, true>(a, hop_live, stream);
    else launch_v<T, true, false>(a, hop_live, stream);
  } else {
    if (fused) launch_v<T, false, true>(a, hop_live, stream);
    else launch_v<T, false, false>(a, hop_live, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes == nullptr: the plain gather (table arguments ignored).  vec != 0
// takes the 16-byte variant: the caller guarantees 16-byte aligned x,
// tables and out, and D*sizeof(x) a multiple of 16.  The rows are n_hops
// hops of rows_per_hop (1 <= n_hops <= kMaxHops); hop_live (host memory,
// n_hops entries, each in [0, rows_per_hop]): the caller guarantees that
// rows at or past hop_live[k] within hop k have no edge.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a bad hop layout).
#define KPGNN_GSS_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* x, const void* indptr, const void* senders, \
                      const void* codes, const void* table1,                  \
                      const void* tablek, void* out, int n_rows, int n_cols,  \
                      int D, int rows_per_hop, int v1, int vk, int vec,       \
                      const int* hop_live, int n_hops, void* stream) {        \
    const Args a{x, static_cast<const int*>(indptr),                          \
                 static_cast<const int*>(senders),                            \
                 static_cast<const int*>(codes),                              \
                 static_cast<const float*>(table1),                           \
                 static_cast<const float*>(tablek), static_cast<float*>(out), \
                 n_rows, n_cols, D, rows_per_hop, v1, vk, n_hops};            \
    return launch<T>(a, vec, hop_live, stream);                               \
  }

KPGNN_GSS_ENTRY(kpgnn_gather_segment_sum_f32, float)
KPGNN_GSS_ENTRY(kpgnn_gather_segment_sum_bf16, __nv_bfloat16)
