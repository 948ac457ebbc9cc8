// Fused hop-major CSR gather/segment-sum for Hopper (sm_90a).
//
//   out[r, :] = sum over e in [indptr[r], indptr[r+1]) of x[senders[e], :]
//
// Row r = k*N + i is node i at hop k, so one launch covers every hop of a
// layer's k-hop aggregation; the backward pass is the same kernel over the
// transposed (sender-sorted) CSR.  A sender id >= n_cols is a null edge
// and adds nothing.  n_rows may differ from n_cols (rectangular plans).
//
// Replaces the TPU kernel kpgnn_tpu/ops/pallas_spmm.py `_kernel` (:159),
// driven by `gather_segment_sum` (:294, pallas_call at :391).  That kernel
// turns the gather and the scatter into one-hot matmuls over sender windows
// because a TPU has no fast row gather; Hopper has one, so none of the
// window, tile-padding or VMEM machinery carries over.
//
// What bounds it: bytes.  Each live edge reads one D-wide row of x
// (E*D*sizeof(x)) and each output row is written once (n_rows*D*4); the
// adds are one per gathered element, far below the card's f32 rate.  At the
// flagship's sizes (K*n_pad = 12288 rows, D = 104, ~37k edges) the 5 MB
// node table stays in the 50 MB L2, so gathered rows mostly hit L2.
//
// Design: one warp per receiver row, lanes across D, so each gathered row
// is one coalesced read.  The row's sender ids are loaded 32 at a time (one
// per lane) and broadcast with shuffles; the sum stays in f32 registers and
// is stored once.  The CSR is receiver-sorted, so rows are disjoint and no
// atomics are needed.  Heavy rows are simply looped; splitting hubs by nnz
// is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kColsPerLane = 4;                 // 128 columns per pass
constexpr int kPassCols = 32 * kColsPerLane;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_segment_sum_kernel(const T* __restrict__ x,
                          const int* __restrict__ indptr,
                          const int* __restrict__ senders,
                          float* __restrict__ out,
                          int n_rows, int n_cols, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int e_lo = indptr[row];
  const int e_hi = indptr[row + 1];
  float* out_row = out + static_cast<int64_t>(row) * D;

  for (int c0 = 0; c0 < D; c0 += kPassCols) {
    float acc[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.f;

    for (int base = e_lo; base < e_hi; base += 32) {
      const int e = base + lane;
      const int mine = e < e_hi ? senders[e] : n_cols;
      const int n = min(32, e_hi - base);
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const int s = __shfl_sync(0xffffffffu, mine, t);
        if (s < 0 || s >= n_cols) continue;     // null edge: adds nothing
        const T* x_row = x + static_cast<int64_t>(s) * D;
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < D) acc[j] += to_f32(x_row[c]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < D) out_row[c] = acc[j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* indptr, const void* senders, void* out,
           int n_rows, int n_cols, int D, void* stream) {
  if (n_rows > 0 && D > 0) {
    const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    gather_segment_sum_kernel<T><<<blocks, kWarpsPerBlock * 32, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const int*>(indptr),
        static_cast<const int*>(senders), static_cast<float*>(out),
        n_rows, n_cols, D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int kpgnn_gather_segment_sum_f32(const void* x, const void* indptr,
                                            const void* senders, void* out,
                                            int n_rows, int n_cols, int D,
                                            void* stream) {
  return launch<float>(x, indptr, senders, out, n_rows, n_cols, D, stream);
}

extern "C" int kpgnn_gather_segment_sum_bf16(const void* x, const void* indptr,
                                             const void* senders, void* out,
                                             int n_rows, int n_cols, int D,
                                             void* stream) {
  return launch<__nv_bfloat16>(x, indptr, senders, out, n_rows, n_cols, D,
                               stream);
}
