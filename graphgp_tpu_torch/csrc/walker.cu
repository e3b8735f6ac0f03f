// K4: fused random walks -> dense step matrices
//   M[l, i, j] = (1/W) * sum_w load_l(i, w) * [cur_l(i, w) == j],   out (L, N, N) f32.
//
// Replaces the Pallas kernel graphgp_tpu/pallas_kernels/walker.py
// (sample_dense_step_matrices_pallas / _walk_kernel, the pl.pallas_call at
// :280), the dense-regime sampler behind kernels.step_matrices_for_adjacency
// (N <= 4096: the traffic, ablation and quickstart protocols).
//
// Walk semantics, bit for bit those of walker.sample_walk_log: step l records
// (cur, load) before the transition; u = float(hash >> 8) * 2^-24 on the
// splitmix32 stream of (k0, k1, 2l | 2l+1, start node, walk); a walk halts on
// degree 0 or u_halt < p_halt and then adds nothing; pick = min(int(u_pick *
// deg), deg - 1); load = ((load * deg) * wgt) * inv_keep in float32, each a
// separately rounded multiply (__fmul_rn: nothing for fma contraction to
// fuse), or load = wgt under ablation.
//
// What bounds it on an H100: at small walks_per_node the 4*L*N*N output bytes
// (671 MB at N = 4096, L = 10); at the protocols' widths the integer work of
// the hashes, one mix (2 multiplies, 3 shifts, 4 xors) per uniform, two
// uniforms per live transition, plus one shared-memory atomic per live step.
//
// Design. A block owns one start node; its threads stride over that node's
// walks. The block is sized for the larger of the walks and the accumulator's
// cells, so a few walks on a large graph still zero and write out in
// parallel. The (steps, N) accumulator lives in dynamic shared memory and is
// added to with shared-memory float atomics; the lanes of a warp that hit the
// same cell first add up among themselves (the early steps land on a handful
// of cells) and add once. It leaves once, row by row, coalesced, zeros
// included: every output element is written exactly once, so the output
// needs no zero fill. The hash words that do not depend on the walk,
// hash(k0, k1, word, node), are folded once per block into a shared table, so
// a uniform costs one mix. Step 0 is W walks of load 1 on the start node: one
// thread stores W there (the same bits as W adds of 1.0) in place of a W-way
// same-address atomic. A halted walk leaves the loop: its remaining records
// add zero. When L*N floats exceed a block's shared memory, blockIdx.y
// selects a group of steps and the walk is replayed from step 0 up to the
// group's end (the counter hash makes the replay exact). The sum is divided
// by W at the end (IEEE division: M[0] is exactly the identity). The atomics
// make the order of the float additions vary between launches: repeat
// launches agree to summation order, not bit for bit. The kernel never
// indexes outside its tables whatever they hold: a degree is cut to the row
// width and a neighbour id outside [0, N) ends the walk.
//
// What is left on the table (measured on an H100): the three scattered table
// reads of a step go through L1 one cache line per lane, and at N = 4096 the
// 160 KB accumulator leaves one block of 32 warps per SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB, the most a block may ask for on sm_90

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);  // 2^-24
}

template <bool kAblation>
__global__ void __launch_bounds__(kMaxThreads)
walk_step_matrices_kernel(const int* __restrict__ neighbors, const float* __restrict__ weights,
                          const int* __restrict__ degree, float* __restrict__ out,
                          int N, int D, int W, int L, int steps_per_pass,
                          uint32_t k0, uint32_t k1, float p_halt, float inv_keep) {
  extern __shared__ float acc[];  // [steps_per_pass][N], then uint32 prefix[2 * L]
  uint32_t* prefix = reinterpret_cast<uint32_t*>(acc + (size_t)steps_per_pass * N);

  const int node = blockIdx.x;
  const int l0 = blockIdx.y * steps_per_pass;
  const int l1 = min(l0 + steps_per_pass, L);
  const int cells = (l1 - l0) * N;
  const int t = threadIdx.x, T = blockDim.x;

  for (int k = t; k < cells; k += T) acc[k] = 0.0f;
  // transitions l = 0 .. l1-2 draw words 2l and 2l+1
  for (int word = t; word < 2 * (l1 - 1); word += T) {
    uint32_t h = mix(0x9E3779B9u ^ k0);
    h = mix(h ^ k1);
    h = mix(h ^ (uint32_t)word);
    prefix[word] = mix(h ^ (uint32_t)node);
  }
  __syncthreads();
  if (l0 == 0 && t == 0) acc[node] = (float)W;

  for (int w = t; w < W; w += T) {
    int cur = node;
    float load = 1.0f;
    for (int l = 0;; ++l) {
      if (l >= l0 && l > 0) {
        // lanes of the warp that add to the same cell add once, through the
        // lowest of them
        const int cell = (l - l0) * N + cur;
        const unsigned peers = __match_any_sync(__activemask(), cell);
        float sum = load;
        for (unsigned m = peers & (peers - 1); m; m &= m - 1) {
          sum += __shfl_sync(peers, load, __ffs(m) - 1);
        }
        if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&acc[cell], sum);
      }
      if (l == l1 - 1) break;
      const int deg = min(degree[cur], D);
      const float u_halt = uniform01(mix(prefix[2 * l] ^ (uint32_t)w));
      if (deg <= 0 || u_halt < p_halt) break;
      const float u_pick = uniform01(mix(prefix[2 * l + 1] ^ (uint32_t)w));
      const float degf = (float)deg;
      const int pick = min(__float2int_rz(__fmul_rn(u_pick, degf)), deg - 1);
      const int idx = cur * D + pick;
      const float wgt = weights[idx];
      load = kAblation ? wgt : __fmul_rn(__fmul_rn(__fmul_rn(load, degf), wgt), inv_keep);
      cur = neighbors[idx];
      if ((unsigned)cur >= (unsigned)N) break;
    }
  }
  __syncthreads();

  const float wf = (float)W;
  for (int l = l0; l < l1; ++l) {
    const float* row = acc + (l - l0) * N;
    float* dst = out + ((size_t)l * N + node) * N;
    for (int j = t; j < N; j += T) dst[j] = __fdiv_rn(row[j], wf);
  }
}

}  // namespace

extern "C" int walk_step_matrices_f32(const int* neighbors, const float* weights,
                                      const int* degree, float* out, int N, int D, int W,
                                      int L, int steps_per_pass, int ablation,
                                      unsigned int k0, unsigned int k1, float p_halt,
                                      float inv_keep, int threads, void* stream) {
  if (N < 1 || D < 1 || W < 1 || L < 1 || steps_per_pass < 1 || steps_per_pass > L ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * (size_t)steps_per_pass * N + sizeof(uint32_t) * 2 * (size_t)L;
  if (smem > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  const int passes = (L + steps_per_pass - 1) / steps_per_pass;
  if (passes > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = ablation ? walk_step_matrices_kernel<true> : walk_step_matrices_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)N, (unsigned)passes);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      neighbors, weights, degree, out, N, D, W, L, steps_per_pass, (uint32_t)k0, (uint32_t)k1,
      p_halt, inv_keep);
  return (int)cudaGetLastError();
}
