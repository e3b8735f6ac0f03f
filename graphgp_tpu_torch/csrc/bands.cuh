// Offset-band staging, shared by the stencil kernels (csrc/stencil.cu: K1 and
// its weight gradient) and the fused masked-Gram kernels (csrc/gram.cu: K2a
// and K2b).
//
// The wrapper's planner (cuda_kernels/stencil.py: plan_bands) sorts the
// centred offsets and groups them into bands, runs of spread (max - min)
// <= kPad - 4 of at most kMaxBandRows offsets. A block owns kTile consecutive
// columns and all B rows. For each band it stages in shared memory, by
// cp.async in two stages, the window of the operand that the band's offsets
// read, (B, kTile + spread) floats from the band's first column mod N, and
// for a product the band's rows of the weight table. Copies are 16 bytes
// when N % 4 == 0 and the pointers are 16-byte aligned (the window's start
// is aligned down and the shift kept), 4 bytes otherwise; every copy's
// column is reduced mod N, so the window wraps at the ring's seam. A thread
// owns kCols columns kThreads apart and reads the staged terms from shared
// memory, consecutive threads on consecutive words. banded_kernel is the
// whole body of the three products (K1; K2a with the mask's window as one
// more staged row; K2b), each with its own store; the gradient kernel takes
// the staging pieces alone.
#pragma once

#include <cuda_runtime.h>

namespace bands {

constexpr int kThreads = 128;
constexpr int kPad = 64;                 // a window row holds kTile + kPad floats
constexpr int kMaxBandRows = 16;         // offsets in one band at most
constexpr int kMaxOffsets = 256;
constexpr int kMaxPlan = 1 + 3 * kMaxOffsets + 2 * kMaxOffsets;

// Columns a block owns at B rows. Wide tiles amortise each band's staging
// at small B; above 12 rows a narrower tile halves a block's shared memory,
// so twice as many blocks share an SM (measured by
// benchmarks/torch_stencil_variants.py).
__host__ __device__ constexpr int tile_for(int B) { return B <= 12 ? 256 : 128; }

template <int B>
struct Tiling {
  static constexpr int kTile = tile_for(B);
  static constexpr int kRow = kTile + kPad;
  static constexpr int kCols = kTile / kThreads;  // columns per thread, kThreads apart
  static_assert(kTile % kThreads == 0 && kTile % 4 == 0, "whole columns and 16-byte chunks");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// The plan, copied to shared memory by every block:
//   [nb | (lo, begin, end) x nb | (s, off_s - lo) x S], entries sorted by offset.
struct Plan {
  const int* tab;
  __device__ int bands() const { return tab[0]; }
  __device__ int lo(int k) const { return tab[1 + 3 * k]; }
  __device__ int begin(int k) const { return tab[2 + 3 * k]; }
  __device__ int end(int k) const { return tab[3 + 3 * k]; }
  __device__ int row(int e) const { return tab[1 + 3 * bands() + 2 * e]; }
  __device__ int rel(int e) const { return tab[2 + 3 * bands() + 2 * e]; }
  __device__ int spread(int k) const { return rel(end(k) - 1); }
};

// First column of band k's window, mod N; with 16-byte copies it is aligned
// down to a multiple of 4 and `shift` (0..3) says by how much.
__device__ __forceinline__ long long window_start(long long c0, int lo, long long N, bool vec,
                                                  int* shift) {
  long long start = c0 + lo;  // |lo| < N, 0 <= c0 < N
  if (start < 0) start += N;
  else if (start >= N) start -= N;
  *shift = vec ? (int)(start & 3) : 0;
  return start - *shift;
}

// col mod N for 0 <= col < N + a window row (kTile + kPad).
__device__ __forceinline__ long long wrap(long long col, long long N) {
  if (col >= N) {
    col -= N;
    if (col >= N) col %= N;  // only when N is shorter than a window row
  }
  return col;
}

// win[r * kRow + j] = src[r, (start + j) mod N] for r < Rows, j < len. A
// thread reduces its column mod N once and issues the copies of all rows
// from it.
template <int Rows, int kRow>
__device__ __forceinline__ void stage_window(float* win, const float* __restrict__ src,
                                             long long N, long long start, int len, bool vec) {
  if (vec) {
    for (int q = threadIdx.x; q < (len + 3) >> 2; q += kThreads) {  // <= kRow / 4 chunks
      const float* col = src + wrap(start + 4 * q, N);
#pragma unroll
      for (int r = 0; r < Rows; ++r) cp_async16(win + r * kRow + 4 * q, col + (long long)r * N);
    }
  } else {
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const float* col = src + wrap(start + j, N);
#pragma unroll
      for (int r = 0; r < Rows; ++r) cp_async4(win + r * kRow + j, col + (long long)r * N);
    }
  }
}

// wt[r * kTile + j] = w[row_r, c0 + j] for the band's rows; columns past N
// are left as they are (their outputs are never stored).
template <int kTile>
__device__ __forceinline__ void stage_weights(float* wt, const float* __restrict__ w, long long N,
                                              long long c0, const Plan& plan, int k, bool vec) {
  const int begin = plan.begin(k), rows = plan.end(k) - begin;
  if (vec) {
    constexpr int kChunks = kTile / 4;
    for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks, q = i % kChunks;
      const long long col = c0 + 4 * q;  // N % 4 == 0: a chunk is all in or all out
      if (col < N) cp_async16(wt + r * kTile + 4 * q, w + (long long)plan.row(begin + r) * N + col);
    }
  } else {
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const long long col = c0 + j;
      if (col < N) {
        for (int r = 0; r < rows; ++r) {
          cp_async4(wt + r * kTile + j, w + (long long)plan.row(begin + r) * N + col);
        }
      }
    }
  }
}

__device__ __forceinline__ Plan load_plan(int* tab, const int* __restrict__ plan, int plan_len) {
  for (int k = threadIdx.x; k < plan_len; k += kThreads) tab[k] = plan[k];
  __syncthreads();
  return Plan{tab};
}

// Floats of one stage of the product: the B rows of the operand's window,
// the mask's window row when kMaskRow, the band's rows of the weight table.
// A multiple of 4, so every stage starts on 16 bytes.
template <int B, bool kMaskRow>
__device__ __forceinline__ int product_stage(int band_rows) {
  return (B + kMaskRow) * Tiling<B>::kRow + band_rows * Tiling<B>::kTile;
}

// The body of a banded product kernel (K1, K2a, K2b): block blockIdx.x owns
// the kTile columns from c0 = blockIdx.x * kTile and computes
//   acc[p][b] = sum_s w[s, i] * m[j] * x[b, j],  i = c0 + threadIdx.x + p * kThreads,
//   j = (i + off_s) mod N,  m = mask when kMaskRow, else 1,
// over every band of the plan, two stages of product_stage<B, kMaskRow>
// floats of dynamic shared memory, then the plan. The mask is 0/1, so
// multiplying it into the weight at read time is exact. Then it calls
// epilogue(acc, c0, smem) to store: accumulators of columns past N hold
// garbage, and the stages are free (the loop ends on a barrier with no copy
// in flight). The kernel is written whole here rather than as a function the
// kernels call around their own set-up, because that form moved K1's
// register allocation (spills at B = 1 and 8, 10% slower at B = 1).
template <int B, bool kMaskRow, class Epilogue>
__device__ __forceinline__ void banded_kernel(const float* __restrict__ w,
                                              const float* __restrict__ x,
                                              const float* __restrict__ mask,
                                              const int* __restrict__ plan_g, int plan_len,
                                              int band_rows, long long N, int vec,
                                              Epilogue epilogue) {
  constexpr int kTile = Tiling<B>::kTile, kRow = Tiling<B>::kRow, kCols = Tiling<B>::kCols;
  constexpr int kWinRows = B + kMaskRow;
  extern __shared__ __align__(16) float smem[];
  const int stage = product_stage<B, kMaskRow>(band_rows);
  const Plan plan = load_plan(reinterpret_cast<int*>(smem + 2 * stage), plan_g, plan_len);
  const long long c0 = (long long)blockIdx.x * kTile;
  const int nb = plan.bands();

  auto issue = [&](int k) {
    float* buf = smem + (k & 1) * stage;
    int shift;
    const long long start = window_start(c0, plan.lo(k), N, vec, &shift);
    const int len = shift + kTile + plan.spread(k);
    stage_window<B, kRow>(buf, x, N, start, len, vec);
    if constexpr (kMaskRow) stage_window<1, kRow>(buf + B * kRow, mask, N, start, len, vec);
    stage_weights<kTile>(buf + kWinRows * kRow, w, N, c0, plan, k, vec);
    cp_async_commit();
  };

  float acc[kCols][B];
#pragma unroll
  for (int p = 0; p < kCols; ++p)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[p][b] = 0.0f;

  issue(0);
  for (int k = 0; k < nb; ++k) {
    if (k + 1 < nb) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* win = smem + (k & 1) * stage;
    const float* wt = win + kWinRows * kRow;
    int shift;
    window_start(c0, plan.lo(k), N, vec, &shift);
    const int begin = plan.begin(k), end = plan.end(k);
    for (int e = begin; e < end; ++e) {
      const float* wr = wt + (e - begin) * kTile + threadIdx.x;
      const float* vr = win + shift + plan.rel(e) + threadIdx.x;
#pragma unroll
      for (int p = 0; p < kCols; ++p) {
        float ws = wr[p * kThreads];
        if constexpr (kMaskRow) ws *= vr[B * kRow + p * kThreads];
#pragma unroll
        for (int b = 0; b < B; ++b) acc[p][b] = fmaf(ws, vr[b * kRow + p * kThreads], acc[p][b]);
      }
    }
    __syncthreads();  // buffer k & 1 is refilled by issue(k + 2)
  }
  epilogue(acc, c0, smem);
}

// Dynamic shared memory of one block: two stages of (B + mask_row) window
// rows and band_rows rows of weights, then the plan.
inline size_t smem_bytes(int B, bool mask_row, int band_rows, int plan_len) {
  const int tile = tile_for(B);
  return sizeof(float) * 2 *
             ((size_t)(B + mask_row) * (tile + kPad) + (size_t)band_rows * tile) +
         sizeof(int) * (size_t)plan_len;
}

inline bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline unsigned num_blocks(int B, long long N) {
  return (unsigned)((N + tile_for(B) - 1) / tile_for(B));
}

inline bool bad_launch(int plan_len, int S, int B, long long N, int tile) {
  return S < 1 || S > kMaxOffsets || plan_len < 1 + 3 + 2 * S || plan_len > kMaxPlan || B < 1 ||
         B > 16 || N < 1 || tile != tile_for(B);
}

// A product's launch arguments, as the planner gives them, checked.
inline bool bad_product_launch(int plan_len, int S, int band_rows, int B, long long N, int tile,
                               long long smem, bool mask_row) {
  return bad_launch(plan_len, S, B, N, tile) || band_rows < 1 || band_rows > kMaxBandRows ||
         smem != (long long)smem_bytes(B, mask_row, band_rows, plan_len);
}

}  // namespace bands

#define GRAPHGP_BATCH_CASES(CALL) \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) \
  CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)
