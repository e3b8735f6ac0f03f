// K1: the stencil product  out[b, i] = sum_s w[s, i] * v[b, (i + off_s) mod N],
// and its weight gradient  dw[s, i] = sum_b g[b, i] * v[b, (i + off_s) mod N].
//
// Replaces the Pallas kernel graphgp_tpu/pallas_kernels/stencil.py:139-185
// (_matvec_pallas / _matvec_kernel, the pl.pallas_call at :176), which every
// CG and Lanczos iteration of the GP fit and the Thompson draw runs, forward
// and transposed, and the XLA roll reduction of its custom VJP (_dw_matvec,
// :201-205). The transpose is the product kernel under the pre-shifted
// weights w_shift[s] = roll(w[s], off_s) and negated offsets; the gradient
// kernel serves both, since the gradient of w_shift is dw under -offsets.
//
// What bounds both on an H100: device-memory bytes. Each must read its table
// (w for the product, none for dw) or write it (dw), and read or write B x N
// floats twice: 4 * (S*N + 2*B*N) bytes, ~172 MB at B = 1 and ~292 MB at
// B = 16 for the flagship's S = 41, N = 1e6, i.e. 51 us and 87 us at
// 3.35 TB/s. The arithmetic, 2*S*B*N flops, is far below the fp32 rate.
//
// What held the first version back: one thread per column issued S*B scalar
// 4-byte loads of v (656 at S = 41, B = 16), served from L1/L2, and those
// re-reads, not HBM, set its pace (45% of the byte bound at B = 16).
//
// Design. The wrapper sorts the offsets and groups them into bands, runs of
// spread (max - min) <= kPad - 4 of at most kMaxBandRows offsets (the
// flagship's dx + 1000*dy, |dx| + |dy| <= 4, gives 9 bands, one per dy). A
// block owns kTile consecutive columns (256 up to B = 12, 128 above) and all
// B rows. For each band it stages the (B, kTile + spread) window of v that
// the band's offsets read, and for the product the band's rows of w, in
// shared memory with cp.async, two stages, so band k+1 is in flight while
// band k is computed. The window wraps mod N at the ring's seam (each copy's
// column is reduced mod N). When N % 4 == 0 and the pointers are 16-byte
// aligned, the copies are 16 bytes (the window's start is aligned down and
// the shift kept); otherwise 4.
// Every thread then reads the band's terms from shared memory, consecutive
// threads on consecutive words (no bank conflicts), and keeps kCols columns
// x B accumulators in registers (the product) or its kCols columns of g
// (the gradient). So v is read from L2 once per band rather than once per
// offset, w is streamed once, and every output is written once, coalesced.
// The gradient sums over b in a fixed order without atomics: two launches
// are bit-identical.
#include <cuda_runtime.h>

namespace {

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

// win[b * kRow + j] = v[b, (start + j) mod N] for j < len. A thread reduces
// its column mod N once and issues the copies of all B rows from it.
template <int B>
__device__ __forceinline__ void stage_window(float* win, const float* __restrict__ v, long long N,
                                             long long start, int len, bool vec) {
  constexpr int kRow = Tiling<B>::kRow;
  if (vec) {
    for (int q = threadIdx.x; q < (len + 3) >> 2; q += kThreads) {  // <= kRow / 4 chunks
      const float* src = v + wrap(start + 4 * q, N);
#pragma unroll
      for (int b = 0; b < B; ++b) cp_async16(win + b * kRow + 4 * q, src + (long long)b * N);
    }
  } else {
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const float* src = v + wrap(start + j, N);
#pragma unroll
      for (int b = 0; b < B; ++b) cp_async4(win + b * kRow + j, src + (long long)b * N);
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

template <int B>
__global__ void __launch_bounds__(kThreads)
stencil_matvec_kernel(const float* __restrict__ w, const float* __restrict__ v,
                      float* __restrict__ out, const int* __restrict__ plan_g, int plan_len,
                      int band_rows, long long N, int vec) {
  constexpr int kTile = Tiling<B>::kTile, kRow = Tiling<B>::kRow, kCols = Tiling<B>::kCols;
  extern __shared__ __align__(16) float smem[];
  const int stage = B * kRow + band_rows * kTile;  // floats; a multiple of 4
  const Plan plan = load_plan(reinterpret_cast<int*>(smem + 2 * stage), plan_g, plan_len);
  const long long c0 = (long long)blockIdx.x * kTile;
  const int nb = plan.bands();

  auto issue = [&](int k) {
    float* buf = smem + (k & 1) * stage;
    int shift;
    const long long start = window_start(c0, plan.lo(k), N, vec, &shift);
    stage_window<B>(buf, v, N, start, shift + kTile + plan.spread(k), vec);
    stage_weights<kTile>(buf + B * kRow, w, N, c0, plan, k, vec);
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
    const float* wt = win + B * kRow;
    int shift;
    window_start(c0, plan.lo(k), N, vec, &shift);
    const int begin = plan.begin(k), end = plan.end(k);
    for (int e = begin; e < end; ++e) {
      const float* wr = wt + (e - begin) * kTile + threadIdx.x;
      const float* vr = win + shift + plan.rel(e) + threadIdx.x;
#pragma unroll
      for (int p = 0; p < kCols; ++p) {
        const float ws = wr[p * kThreads];
#pragma unroll
        for (int b = 0; b < B; ++b) acc[p][b] = fmaf(ws, vr[b * kRow + p * kThreads], acc[p][b]);
      }
    }
    __syncthreads();  // buffer k & 1 is refilled by issue(k + 2)
  }

#pragma unroll
  for (int p = 0; p < kCols; ++p) {
    const long long col = c0 + threadIdx.x + p * kThreads;
    if (col < N) {
#pragma unroll
      for (int b = 0; b < B; ++b) out[(long long)b * N + col] = acc[p][b];
    }
  }
}

template <int B>
__global__ void __launch_bounds__(kThreads)
stencil_dw_kernel(const float* __restrict__ v, const float* __restrict__ g, float* __restrict__ dw,
                  const int* __restrict__ plan_g, int plan_len, long long N, int vec) {
  constexpr int kTile = Tiling<B>::kTile, kRow = Tiling<B>::kRow, kCols = Tiling<B>::kCols;
  extern __shared__ __align__(16) float smem[];
  const int stage = B * kRow;
  const Plan plan = load_plan(reinterpret_cast<int*>(smem + 2 * stage), plan_g, plan_len);
  const long long c0 = (long long)blockIdx.x * kTile;
  const int nb = plan.bands();

  auto issue = [&](int k) {
    int shift;
    const long long start = window_start(c0, plan.lo(k), N, vec, &shift);
    stage_window<B>(smem + (k & 1) * stage, v, N, start, shift + kTile + plan.spread(k), vec);
    cp_async_commit();
  };
  issue(0);

  float gr[kCols][B];  // this thread's columns of g
#pragma unroll
  for (int p = 0; p < kCols; ++p) {
    const long long col = c0 + threadIdx.x + p * kThreads;
#pragma unroll
    for (int b = 0; b < B; ++b) gr[p][b] = col < N ? g[(long long)b * N + col] : 0.0f;
  }

  for (int k = 0; k < nb; ++k) {
    if (k + 1 < nb) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* win = smem + (k & 1) * stage;
    int shift;
    window_start(c0, plan.lo(k), N, vec, &shift);
    for (int e = plan.begin(k); e < plan.end(k); ++e) {
      const float* vr = win + shift + plan.rel(e) + threadIdx.x;
      float* dst = dw + (long long)plan.row(e) * N + c0 + threadIdx.x;
#pragma unroll
      for (int p = 0; p < kCols; ++p) {
        float a = 0.0f;
#pragma unroll
        for (int b = 0; b < B; ++b) a = fmaf(gr[p][b], vr[b * kRow + p * kThreads], a);
        if (c0 + threadIdx.x + p * kThreads < N) dst[p * kThreads] = a;
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int B, int band_rows, int plan_len) {
  const int tile = tile_for(B);
  return sizeof(float) * 2 * ((size_t)B * (tile + kPad) + (size_t)band_rows * tile) +
         sizeof(int) * (size_t)plan_len;
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int B>
cudaError_t launch_matvec(const float* w, const float* v, float* out, const int* plan,
                          int plan_len, int band_rows, long long N, size_t smem,
                          cudaStream_t st) {
  cudaError_t err = allow_smem(stencil_matvec_kernel<B>, smem);
  if (err != cudaSuccess) return err;
  const int vec = (N % 4 == 0) && aligned16(w) && aligned16(v);
  const unsigned blocks = (unsigned)((N + tile_for(B) - 1) / tile_for(B));
  stencil_matvec_kernel<B><<<blocks, kThreads, smem, st>>>(w, v, out, plan, plan_len, band_rows,
                                                           N, vec);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_dw(const float* v, const float* g, float* dw, const int* plan, int plan_len,
                      long long N, size_t smem, cudaStream_t st) {
  cudaError_t err = allow_smem(stencil_dw_kernel<B>, smem);
  if (err != cudaSuccess) return err;
  const int vec = (N % 4 == 0) && aligned16(v);
  const unsigned blocks = (unsigned)((N + tile_for(B) - 1) / tile_for(B));
  stencil_dw_kernel<B><<<blocks, kThreads, smem, st>>>(v, g, dw, plan, plan_len, N, vec);
  return cudaGetLastError();
}

bool bad_launch(int plan_len, int S, int B, long long N, int tile) {
  return S < 1 || S > kMaxOffsets || plan_len < 1 + 3 + 2 * S || plan_len > kMaxPlan || B < 1 ||
         B > 16 || N < 1 || tile != tile_for(B);
}

}  // namespace

#define GRAPHGP_BATCH_CASES(CALL) \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) \
  CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)

// out (B, N) = the stencil product of w (S, N) and v (B, N) under the band
// plan of its S offsets. `tile` and `smem` are the planner's; both are checked.
extern "C" int stencil_matvec_f32(const float* w, const float* v, float* out, const int* plan,
                                  int plan_len, int S, int band_rows, int B, long long N,
                                  int tile, long long smem, void* stream) {
  if (bad_launch(plan_len, S, B, N, tile) || band_rows < 1 || band_rows > kMaxBandRows ||
      smem != (long long)smem_bytes(B, band_rows, plan_len)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  switch (B) {
#define GRAPHGP_CASE(n) \
  case n:               \
    err = launch_matvec<n>(w, v, out, plan, plan_len, band_rows, N, (size_t)smem, st); \
    break;
    GRAPHGP_BATCH_CASES(GRAPHGP_CASE)
#undef GRAPHGP_CASE
  }
  return (int)err;
}

// dw (S, N) = sum_b g[b, i] * v[b, (i + off_s) mod N] for v, g (B, N).
extern "C" int stencil_dw_f32(const float* v, const float* g, float* dw, const int* plan,
                              int plan_len, int S, int B, long long N, int tile, long long smem,
                              void* stream) {
  if (bad_launch(plan_len, S, B, N, tile) || smem != (long long)smem_bytes(B, 0, plan_len)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  switch (B) {
#define GRAPHGP_CASE(n) \
  case n:               \
    err = launch_dw<n>(v, g, dw, plan, plan_len, N, (size_t)smem, st); \
    break;
    GRAPHGP_BATCH_CASES(GRAPHGP_CASE)
#undef GRAPHGP_CASE
  }
  return (int)err;
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
