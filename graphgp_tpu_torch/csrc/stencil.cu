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
// Design: the offset bands of csrc/bands.cuh, which K2a and K2b share. The
// wrapper sorts the offsets into bands (the flagship's dx + 1000*dy,
// |dx| + |dy| <= 4, gives 9, one per dy). A block owns kTile consecutive
// columns (256 up to B = 12, 128 above) and all B rows, and for each band
// stages the (B, kTile + spread) window of v that the band's offsets read,
// and for the product the band's rows of w, in shared memory with cp.async,
// two stages, so band k+1 is in flight while band k is computed.
// Every thread then reads the band's terms from shared memory, consecutive
// threads on consecutive words (no bank conflicts), and keeps kCols columns
// x B accumulators in registers (the product) or its kCols columns of g
// (the gradient). So v is read from L2 once per band rather than once per
// offset, w is streamed once, and every output is written once, coalesced.
// The gradient sums over b in a fixed order without atomics: two launches
// are bit-identical.
#include "bands.cuh"

namespace {

using namespace bands;

template <int B>
__global__ void __launch_bounds__(kThreads)
stencil_matvec_kernel(const float* __restrict__ w, const float* __restrict__ v,
                      float* __restrict__ out, const int* __restrict__ plan_g, int plan_len,
                      int band_rows, long long N, int vec) {
  banded_kernel<B, false>(w, v, nullptr, plan_g, plan_len, band_rows, N, vec,
                          [&](const float (&acc)[Tiling<B>::kCols][B], long long c0, float*) {
#pragma unroll
    for (int p = 0; p < Tiling<B>::kCols; ++p) {
      const long long col = c0 + threadIdx.x + p * kThreads;
      if (col < N) {
#pragma unroll
        for (int b = 0; b < B; ++b) out[(long long)b * N + col] = acc[p][b];
      }
    }
  });
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
    stage_window<B, kRow>(smem + (k & 1) * stage, v, N, start, shift + kTile + plan.spread(k),
                          vec);
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

template <int B>
cudaError_t launch_matvec(const float* w, const float* v, float* out, const int* plan,
                          int plan_len, int band_rows, long long N, size_t smem,
                          cudaStream_t st) {
  cudaError_t err = allow_smem(stencil_matvec_kernel<B>, smem);
  if (err != cudaSuccess) return err;
  const int vec = (N % 4 == 0) && aligned16(w) && aligned16(v);
  stencil_matvec_kernel<B><<<num_blocks(B, N), kThreads, smem, st>>>(w, v, out, plan, plan_len,
                                                                    band_rows, N, vec);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_dw(const float* v, const float* g, float* dw, const int* plan, int plan_len,
                      long long N, size_t smem, cudaStream_t st) {
  cudaError_t err = allow_smem(stencil_dw_kernel<B>, smem);
  if (err != cudaSuccess) return err;
  const int vec = (N % 4 == 0) && aligned16(v);
  stencil_dw_kernel<B><<<num_blocks(B, N), kThreads, smem, st>>>(v, g, dw, plan, plan_len, N, vec);
  return cudaGetLastError();
}

}  // namespace

// out (B, N) = the stencil product of w (S, N) and v (B, N) under the band
// plan of its S offsets. `tile` and `smem` are the planner's; both are checked.
extern "C" int stencil_matvec_f32(const float* w, const float* v, float* out, const int* plan,
                                  int plan_len, int S, int band_rows, int B, long long N,
                                  int tile, long long smem, void* stream) {
  if (bands::bad_product_launch(plan_len, S, band_rows, B, N, tile, smem, false)) {
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
  if (bands::bad_launch(plan_len, S, B, N, tile) ||
      smem != (long long)bands::smem_bytes(B, false, 0, plan_len)) {
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
