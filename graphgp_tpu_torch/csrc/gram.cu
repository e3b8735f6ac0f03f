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
// Design. The TPU kernels keep every CG vector in a zero-padded (B, Np) layout
// with a block of pad columns on each side, mirror the edge columns of
// periodic stencils into the pads before every product, and gate the output
// by an indicator of the real columns, all because a Pallas block window
// cannot wrap around. A CUDA thread indexes (i +- off_s) mod N directly, so
// none of that exists here: state stays (B, N), wraparound is always exact,
// and an aperiodic stencil reads its wrap columns against zero weights.
//
// Both kernels share K1's layout (csrc/stencil.cu): one thread owns one node
// column i and loops over the S offsets, reads the weight once (coalesced
// across the warp) and applies it to all B rows held in registers (B is a
// template parameter, 1..16); the shifted operand reads are coalesced and
// served mostly from L1/L2. What the fusion saves over two K1 launches and
// the elementwise algebra of the masked operator: the mask multiply rides the
// operand load of K2a (no masked copy of v is written), the epilogue runs on
// the accumulators of K2b (no pass over the product), and the CG denominator
// <v, A v> leaves K2b as per-block partial sums (no pass over v and A v).
//
// The partial sums are reduced inside a block by warp shuffles and a fixed
// order over the warps, one value per (row, block); the caller adds the
// blocks with one torch.sum. No float atomics anywhere: the same inputs give
// the same bits on every launch, so repeated solves are identical. Threads
// past N (the last block's tail) take part in the reduction and add zero.
// sigma^2 is read from device memory: it is a tensor in the caller's
// parameters, and reading it on the host would stall the stream each launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOffsets = 256;

__device__ __forceinline__ long long wrap(long long j, long long N) {
  // |off| < N after centring, so one correction is enough
  if (j < 0) return j + N;
  if (j >= N) return j - N;
  return j;
}

template <int B>
__global__ void __launch_bounds__(kThreads)
gram_rmv_mask_kernel(const float* __restrict__ w_shift, const float* __restrict__ mask,
                     const float* __restrict__ v, float* __restrict__ t,
                     const int* __restrict__ neg_offs, int S, long long N) {
  __shared__ int s_off[kMaxOffsets];
  for (int k = threadIdx.x; k < S; k += blockDim.x) s_off[k] = neg_offs[k];
  __syncthreads();

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;

  float acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = 0.0f;

  for (int s = 0; s < S; ++s) {
    const long long j = wrap(i + s_off[s], N);
    // the mask is 0/1, so folding it into the weight is exact: one multiply
    // per offset instead of one per batch row
    const float wm = w_shift[(long long)s * N + i] * mask[j];
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] = fmaf(wm, v[(long long)b * N + j], acc[b]);
  }
#pragma unroll
  for (int b = 0; b < B; ++b) t[(long long)b * N + i] = acc[b];
}

template <int B>
__global__ void __launch_bounds__(kThreads)
gram_mv_epilogue_kernel(const float* __restrict__ w, const float* __restrict__ t,
                        const float* __restrict__ mask, const float* __restrict__ v,
                        const float* __restrict__ noise_var, float* __restrict__ out,
                        float* __restrict__ partials, const int* __restrict__ offs,
                        int S, long long N, int num_blocks) {
  __shared__ int s_off[kMaxOffsets];
  __shared__ float s_part[B][kWarps];
  for (int k = threadIdx.x; k < S; k += blockDim.x) s_off[k] = offs[k];
  __syncthreads();

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < N;

  float acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = 0.0f;

  if (live) {
    for (int s = 0; s < S; ++s) {
      const float ws = w[(long long)s * N + i];
      const long long j = wrap(i + s_off[s], N);
#pragma unroll
      for (int b = 0; b < B; ++b) acc[b] = fmaf(ws, t[(long long)b * N + j], acc[b]);
    }
    const float m = mask[i];
    const float nvm = noise_var[0] * m;
    const float keep = 1.0f - m;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float vb = v[(long long)b * N + i];
      const float o = m * acc[b] + nvm * vb + keep * vb;
      out[(long long)b * N + i] = o;
      acc[b] = vb * o;  // this column's term of <v, A v>
    }
  }
  // tail threads carry acc = 0 into the reduction

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    float x = acc[b];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
    if (lane == 0) s_part[b][warp] = x;
  }
  __syncthreads();
  if (threadIdx.x < B) {
    float x = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) x += s_part[threadIdx.x][k];
    partials[(long long)threadIdx.x * num_blocks + blockIdx.x] = x;
  }
}

unsigned blocks_for(long long N) { return (unsigned)((N + kThreads - 1) / kThreads); }

template <int B>
void launch_rmv(const float* w_shift, const float* mask, const float* v, float* t,
                const int* neg_offs, int S, long long N, cudaStream_t stream) {
  gram_rmv_mask_kernel<B><<<blocks_for(N), kThreads, 0, stream>>>(w_shift, mask, v, t,
                                                                  neg_offs, S, N);
}

template <int B>
void launch_epilogue(const float* w, const float* t, const float* mask, const float* v,
                     const float* noise_var, float* out, float* partials, const int* offs,
                     int S, long long N, cudaStream_t stream) {
  const unsigned blocks = blocks_for(N);
  gram_mv_epilogue_kernel<B><<<blocks, kThreads, 0, stream>>>(
      w, t, mask, v, noise_var, out, partials, offs, S, N, (int)blocks);
}

bool bad_shape(int S, int B, long long N) {
  return S < 1 || S > kMaxOffsets || B < 1 || B > 16 || N < 1;
}

}  // namespace

#define GRAPHGP_BATCH_SWITCH(CALL)                                        \
  switch (B) {                                                            \
    case 1: CALL(1); break;   case 2: CALL(2); break;                     \
    case 3: CALL(3); break;   case 4: CALL(4); break;                     \
    case 5: CALL(5); break;   case 6: CALL(6); break;                     \
    case 7: CALL(7); break;   case 8: CALL(8); break;                     \
    case 9: CALL(9); break;   case 10: CALL(10); break;                   \
    case 11: CALL(11); break; case 12: CALL(12); break;                   \
    case 13: CALL(13); break; case 14: CALL(14); break;                   \
    case 15: CALL(15); break; case 16: CALL(16); break;                   \
  }

// Number of per-block partial sums gram_mv_epilogue_f32 writes per batch row.
extern "C" int gram_num_blocks(long long N) { return (int)blocks_for(N); }

extern "C" int gram_rmv_mask_f32(const float* w_shift, const float* mask, const float* v,
                                 float* t, const int* neg_offs, int S, int B, long long N,
                                 void* stream) {
  if (bad_shape(S, B, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define GRAPHGP_RMV(n) launch_rmv<n>(w_shift, mask, v, t, neg_offs, S, N, st)
  GRAPHGP_BATCH_SWITCH(GRAPHGP_RMV)
#undef GRAPHGP_RMV
  return (int)cudaGetLastError();
}

extern "C" int gram_mv_epilogue_f32(const float* w, const float* t, const float* mask,
                                    const float* v, const float* noise_var, float* out,
                                    float* partials, const int* offs, int S, int B,
                                    long long N, void* stream) {
  if (bad_shape(S, B, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define GRAPHGP_EPI(n) \
  launch_epilogue<n>(w, t, mask, v, noise_var, out, partials, offs, S, N, st)
  GRAPHGP_BATCH_SWITCH(GRAPHGP_EPI)
#undef GRAPHGP_EPI
  return (int)cudaGetLastError();
}
