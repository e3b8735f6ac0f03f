// K2: the two passes of the fused masked-Gram operator
//
//     A v = M (Phi Phi^T) M v + sigma^2 M v + (I - M) v,     M = diag(mask),
//
// that the full-space prediction solve applies once per CG iteration.
//
//   K2a  gram_rmv_mask:     t[b, i] = sum_s w_shift[s, i] * (mask * v)[b, (i - off_s) mod N]
//   K2b  gram_mv_epilogue:  acc[b, i] = sum_s w[s, i] * t[b, (i + off_s) mod N]
//                           out[b, i] = m_i * acc + (sigma^2 * m_i) * v[b, i] + (1 - m_i) * v[b, i]
//                           partials[b, block] = sum over the block's columns of v[b, i] * out[b, i]
//
// Replaces the Pallas kernels of graphgp_tpu/pallas_kernels/gram.py:
// _rmv_mask / _rmv_mask_kernel (the pl.pallas_call at :200) and _mv_epilogue /
// _mv_epilogue_kernel (the pl.pallas_call at :218), which _gram_cg_padded
// drives.
//
// What bounds them on an H100: device-memory bytes. K2a must read w_shift
// (S x N floats), the mask (N) and v (B x N) and write t (B x N):
// 4 * (S*N + 2*B*N + N) bytes. K2b reads w, t, v and the mask and writes out:
// 4 * (S*N + 3*B*N + N) bytes; the partials and sigma^2 are negligible. At
// S = 41, N = 1e6, B = 8 that is 232 MB and 264 MB, 69 us and 79 us at
// 3.35 TB/s. The arithmetic (2*S*B*N flops a pass) is far below the fp32
// rate. Reading the weight table dominates.
//
// The TPU kernels keep every CG vector in a zero-padded (B, Np) layout with a
// block of pad columns on each side, mirror the edge columns of periodic
// stencils into the pads before every product, and gate the output by an
// indicator of the real columns, all because a Pallas block window cannot
// wrap around. Here the windows are staged column by column mod N, so none
// of that exists: state stays (B, N), wraparound is always exact, and an
// aperiodic stencil reads its wrap columns against zero weights.
//
// Design: both kernels are K1's banded product (csrc/bands.cuh, as
// csrc/stencil.cu uses it). One scalar load of the operand per offset and
// row, served through L1/L2, would set the pace (S*B = 656 a column at
// S = 41, B = 16) and depend on the order of the offsets. Instead the
// planner sorts the offsets into bands, and a block of kTile columns stages
// each band's window of the operand and its rows of the weight table in
// shared memory by cp.async, two stages.
//  - K2a is the product under w_shift and the negated offsets, with the
//    mask's window staged as one more row of the operand's window (same
//    start, shift and length); the weight is multiplied by the staged mask at
//    read time, which is exact because the mask is 0/1. No masked copy of v
//    is written.
//  - K2b is the product under w and the offsets over t, then an epilogue on
//    the accumulators before the store: each thread reads mask[i], v[b, i]
//    and sigma^2 once per column and writes out coalesced (no pass over the
//    product), and the CG denominator <v, A v> leaves as one partial sum per
//    (row, block) (no pass over v and A v).
//
// The partial sums are reduced in a fixed order: over the thread's kCols
// columns in order, then by warp shuffles, then over the warps in order; the
// caller adds the blocks with one torch.sum. No float atomics anywhere: the
// same inputs give the same bits on every launch, so repeated solves are
// identical. Columns past N (the last block's tail) add zero. sigma^2 is
// read from device memory: it is a tensor in the caller's parameters, and
// reading it on the host would stall the stream each launch.
#include "bands.cuh"

namespace {

using namespace bands;

constexpr int kWarps = kThreads / 32;

template <int B>
__global__ void __launch_bounds__(kThreads)
gram_rmv_mask_kernel(const float* __restrict__ w_shift, const float* __restrict__ mask,
                     const float* __restrict__ v, float* __restrict__ t,
                     const int* __restrict__ plan_g, int plan_len, int band_rows, long long N,
                     int vec) {
  banded_kernel<B, true>(w_shift, v, mask, plan_g, plan_len, band_rows, N, vec,
                         [&](const float (&acc)[Tiling<B>::kCols][B], long long c0, float*) {
#pragma unroll
    for (int p = 0; p < Tiling<B>::kCols; ++p) {
      const long long col = c0 + threadIdx.x + p * kThreads;
      if (col < N) {
#pragma unroll
        for (int b = 0; b < B; ++b) t[(long long)b * N + col] = acc[p][b];
      }
    }
  });
}

template <int B>
__global__ void __launch_bounds__(kThreads)
gram_mv_epilogue_kernel(const float* __restrict__ w, const float* __restrict__ t,
                        const float* __restrict__ mask, const float* __restrict__ v,
                        const float* __restrict__ noise_var, float* __restrict__ out,
                        float* __restrict__ partials, const int* __restrict__ plan_g,
                        int plan_len, int band_rows, long long N, int vec, int blocks) {
  banded_kernel<B, false>(w, t, nullptr, plan_g, plan_len, band_rows, N, vec,
                          [&](const float (&acc)[Tiling<B>::kCols][B], long long c0,
                              float* smem) {
    constexpr int kCols = Tiling<B>::kCols;
    const float nv = noise_var[0];
    float dot[B];  // this thread's terms of <v, A v>, its columns in order
#pragma unroll
    for (int b = 0; b < B; ++b) dot[b] = 0.0f;
#pragma unroll
    for (int p = 0; p < kCols; ++p) {
      const long long col = c0 + threadIdx.x + p * kThreads;
      if (col < N) {  // the tail's accumulators are garbage: it adds zero
        const float m = mask[col];
        const float nvm = nv * m;
        const float keep = 1.0f - m;
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const float vb = v[(long long)b * N + col];
          const float o = m * acc[p][b] + nvm * vb + keep * vb;
          out[(long long)b * N + col] = o;
          dot[b] += vb * o;
        }
      }
    }

    float* s_part = smem;  // (B, kWarps) in the freed stages
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float x = dot[b];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
      if (lane == 0) s_part[b * kWarps + warp] = x;
    }
    __syncthreads();
    if (threadIdx.x < B) {
      float x = 0.0f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) x += s_part[threadIdx.x * kWarps + k];
      partials[(long long)threadIdx.x * blocks + blockIdx.x] = x;
    }
  });
}

template <int B>
cudaError_t launch_rmv(const float* w_shift, const float* mask, const float* v, float* t,
                       const int* plan, int plan_len, int band_rows, long long N, size_t smem,
                       cudaStream_t st) {
  cudaError_t err = allow_smem(gram_rmv_mask_kernel<B>, smem);
  if (err != cudaSuccess) return err;
  const int vec = (N % 4 == 0) && aligned16(w_shift) && aligned16(v) && aligned16(mask);
  gram_rmv_mask_kernel<B><<<num_blocks(B, N), kThreads, smem, st>>>(
      w_shift, mask, v, t, plan, plan_len, band_rows, N, vec);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_epilogue(const float* w, const float* t, const float* mask, const float* v,
                            const float* noise_var, float* out, float* partials, const int* plan,
                            int plan_len, int band_rows, long long N, size_t smem,
                            cudaStream_t st) {
  cudaError_t err = allow_smem(gram_mv_epilogue_kernel<B>, smem);
  if (err != cudaSuccess) return err;
  const int vec = (N % 4 == 0) && aligned16(w) && aligned16(t);
  const unsigned blocks = num_blocks(B, N);
  gram_mv_epilogue_kernel<B><<<blocks, kThreads, smem, st>>>(
      w, t, mask, v, noise_var, out, partials, plan, plan_len, band_rows, N, vec, (int)blocks);
  return cudaGetLastError();
}

}  // namespace

// Number of per-block partial sums gram_mv_epilogue_f32 writes per batch row
// at B rows: one per tile of bands::tile_for(B) columns.
extern "C" int gram_num_blocks(int B, long long N) {
  return B < 1 || B > 16 || N < 1 ? -1 : (int)bands::num_blocks(B, N);
}

// t (B, N) from w_shift (S, N), mask (N) and v (B, N) under the band plan of
// the S negated offsets. `tile` and `smem` are the planner's; both are checked.
extern "C" int gram_rmv_mask_f32(const float* w_shift, const float* mask, const float* v,
                                 float* t, const int* plan, int plan_len, int S, int band_rows,
                                 int B, long long N, int tile, long long smem, void* stream) {
  if (bands::bad_product_launch(plan_len, S, band_rows, B, N, tile, smem, true)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  switch (B) {
#define GRAPHGP_CASE(n) \
  case n:               \
    err = launch_rmv<n>(w_shift, mask, v, t, plan, plan_len, band_rows, N, (size_t)smem, st); \
    break;
    GRAPHGP_BATCH_CASES(GRAPHGP_CASE)
#undef GRAPHGP_CASE
  }
  return (int)err;
}

// out (B, N) and partials (B, gram_num_blocks(B, N)) from w (S, N), t, v
// (B, N), the mask (N) and sigma^2 (one float on the device) under the band
// plan of the S offsets.
extern "C" int gram_mv_epilogue_f32(const float* w, const float* t, const float* mask,
                                    const float* v, const float* noise_var, float* out,
                                    float* partials, const int* plan, int plan_len, int S,
                                    int band_rows, int B, long long N, int tile, long long smem,
                                    void* stream) {
  if (bands::bad_product_launch(plan_len, S, band_rows, B, N, tile, smem, false)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  switch (B) {
#define GRAPHGP_CASE(n)                                                                 \
  case n:                                                                               \
    err = launch_epilogue<n>(w, t, mask, v, noise_var, out, partials, plan, plan_len,   \
                             band_rows, N, (size_t)smem, st);                           \
    break;
    GRAPHGP_BATCH_CASES(GRAPHGP_CASE)
#undef GRAPHGP_CASE
  }
  return (int)err;
}
