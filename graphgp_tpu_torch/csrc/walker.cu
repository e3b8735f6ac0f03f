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
// the hashes, one mix (2 multiplies, 3 shifts, 3 xors) per uniform, two
// uniforms per taken transition, at the INT32 rate (64 lanes an SM, a
// quarter of the FP32 rate).
//
// What held the first version (a block per start node adding into a (steps,
// N) accumulator in shared memory): a float atomicAdd to shared memory is a
// compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN in the SASS), and the
// walks of one start node crowd a few cells in their early steps, so the
// warps of a block retried each other's swaps; and at N = 4096 its 160 KB
// accumulator left L1 too small for the 180 KB of tables.
//
// Design. A block owns one start node and its L rows of `out`. It writes row
// 0 as the identity row (M[0] is exactly I) and zeroes its other rows; its
// threads then walk walk t, t + T, ... and add each record straight into the
// row of its step with a global float atomic, which sm_90 does natively at L2
// (RED.ADD.F32: no swap loop, no return, no retry); at the end the block
// reads its rows back from L2 and divides them by W once (IEEE division).
// Up to step kAggSteps, where the walks crowd a few cells, the lanes of a
// warp on the same cell first add up among themselves (__match_any_sync)
// and add once. Shared memory holds only the hash prefix: the hash words that
// do not depend on the walk, hash(k0, k1, word, node), folded once per
// block, so a uniform costs one mix. With no accumulator in shared memory,
// L1 keeps the graph's table, several blocks share an SM, and walks of any
// length take one pass. One 8-byte load a transition: a table packed once a
// launch holds {neighbour id, the neighbour's degree cut to [0, D], weight}
// per (node, slot), so the next step's halt test needs no load. A neighbour
// id outside [0, N) ends its walk before it is recorded: the kernel never
// indexes outside its tables. The atomics make the order of the float
// additions vary between launches: repeat launches agree to summation order,
// not bit for bit. A thread walks one walk at a time and a transition reads
// one packed entry: on an H100, two or four walks in flight a thread and
// three table loads a transition were no faster.
// benchmarks/torch_walker_variants.py times the aggregation's reach (kAggSteps)
// and parts of the kernel by editing this source.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAggSteps = 2;  // warp aggregation of records up to this step
constexpr int kMaxThreads = 1024;
constexpr int kPackThreads = 256;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB, the most a block may ask for on sm_90
constexpr int kMaxDevices = 64;

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

// table[i * D + k] = {id | deg << 16, weight bits}: id = neighbors[i, k], or
// 0xFFFF when it lies outside [0, N) (N <= 4096); deg = the neighbour's degree
// cut to [0, D] (D <= 65535), 0 for such an id.
__global__ void pack_walk_table_kernel(const int* __restrict__ neighbors,
                                       const float* __restrict__ weights,
                                       const int* __restrict__ degree, uint2* __restrict__ table,
                                       int N, int D) {
  const long long k = (long long)blockIdx.x * kPackThreads + threadIdx.x;
  if (k >= (long long)N * D) return;
  const int nbr = neighbors[k];
  unsigned word = 0xFFFFu;
  if ((unsigned)nbr < (unsigned)N) {
    word = (unsigned)nbr | ((unsigned)max(0, min(degree[nbr], D)) << 16);
  }
  table[k] = make_uint2(word, __float_as_uint(weights[k]));
}

template <bool kAblation>
__global__ void __launch_bounds__(kMaxThreads)
walk_step_matrices_kernel(const uint2* __restrict__ table, const int* __restrict__ degree,
                          float* __restrict__ out, int N, int D, int W, int L, uint32_t k0,
                          uint32_t k1, float p_halt, float inv_keep) {
  extern __shared__ uint32_t prefix[];  // [2 * (L - 1)]
  const int node = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const bool vec = (N & 3) == 0;  // rows start on 16 bytes
  for (int l = 0; l < L; ++l) {
    float* row = out + ((size_t)l * N + node) * N;
    if (vec) {
      for (int j = 4 * t; j < N; j += 4 * T) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (l == 0 && j == (node & ~3)) (&v.x)[node & 3] = 1.0f;
        *reinterpret_cast<float4*>(row + j) = v;
      }
    } else {
      for (int j = t; j < N; j += T) row[j] = (l == 0 && j == node) ? 1.0f : 0.0f;
    }
  }
  // transitions l = 0 .. L-2 draw words 2l and 2l+1
  for (int word = t; word < 2 * (L - 1); word += T) {
    uint32_t h = mix(0x9E3779B9u ^ k0);
    h = mix(h ^ k1);
    h = mix(h ^ (uint32_t)word);
    prefix[word] = mix(h ^ (uint32_t)node);
  }
  __syncthreads();  // the rows are cleared before any record lands

  const int deg0 = max(0, min(degree[node], D));
  int walk = t, step = 0, cur = node, deg = deg0;
  float load = 1.0f;
  // Each round: the halt test, the pick and the table load (in flight while
  // the record is added), then the record, then the transition; a walk that
  // ends hands the thread to walk + T.
  while (walk < W) {
    const int l = step;
    uint2 next = make_uint2(0xFFFFu, 0u);  // no transition
    if (l < L - 1) {
      const float u_halt = uniform01(mix(prefix[2 * l] ^ (uint32_t)walk));
      if (deg > 0 && u_halt >= p_halt) {
        const float u_pick = uniform01(mix(prefix[2 * l + 1] ^ (uint32_t)walk));
        const int pick = min(__float2int_rz(__fmul_rn(u_pick, (float)deg)), deg - 1);
        next = table[cur * D + pick];
      }
    }
    if (l > 0) {
      float* cell = out + ((size_t)l * N + node) * N + cur;
      if (l <= kAggSteps) {
        // the lanes on the same cell add up in lane order; the lowest adds
        const unsigned peers = __match_any_sync(__activemask(), l * N + cur);
        float sum = load;
        for (unsigned m = peers & (peers - 1); m; m &= m - 1) {
          sum += __shfl_sync(peers, load, __ffs(m) - 1);
        }
        if ((t & 31) == __ffs(peers) - 1) atomicAdd(cell, sum);
      } else {
        atomicAdd(cell, load);
      }
    }
    const unsigned id = next.x & 0xFFFFu;
    if (id != 0xFFFFu) {
      const float wgt = __uint_as_float(next.y);
      load = kAblation ? wgt : __fmul_rn(__fmul_rn(__fmul_rn(load, (float)deg), wgt), inv_keep);
      cur = (int)id;
      deg = (int)(next.x >> 16);
      ++step;
    } else {
      walk += T;
      step = 0;
      cur = node;
      deg = deg0;
      load = 1.0f;
    }
  }
  __syncthreads();  // every record of the block has landed

  const float wf = (float)W;
  for (int l = 1; l < L; ++l) {
    float* row = out + ((size_t)l * N + node) * N;
    if (vec) {
      for (int j = 4 * t; j < N; j += 4 * T) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(row + j));
        *reinterpret_cast<float4*>(row + j) = make_float4(
            __fdiv_rn(v.x, wf), __fdiv_rn(v.y, wf), __fdiv_rn(v.z, wf), __fdiv_rn(v.w, wf));
      }
    } else {
      for (int j = t; j < N; j += T) row[j] = __fdiv_rn(__ldcg(row + j), wf);
    }
  }
}

}  // namespace

// table: scratch of N * D uint2 (8 * N * D bytes), packed by the launch
// before the walks read it. Shared memory: the hash prefix, 8 * L bytes.
extern "C" int walk_step_matrices_f32(const int* neighbors, const float* weights,
                                      const int* degree, void* table, float* out, int N, int D,
                                      int W, int L, int ablation, unsigned int k0, unsigned int k1,
                                      float p_halt, float inv_keep, int threads, void* stream) {
  const size_t smem = sizeof(uint32_t) * 2 * (size_t)L;
  if (N < 1 || N > 0xFFFF || D < 1 || D > 0xFFFF || W < 1 || L < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || (long long)N * D > 0x7fffffffLL ||
      (long long)threads + W > 0x7fffffffLL || smem > kMaxDynamicSmem) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = ablation ? walk_step_matrices_kernel<true> : walk_step_matrices_kernel<false>;
  // cudaFuncSetAttribute once per instantiation and device: the largest size set so far
  static size_t allowed[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || allowed[ablation ? 1 : 0][dev] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) allowed[ablation ? 1 : 0][dev] = smem;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const long long entries = (long long)N * D;
  pack_walk_table_kernel<<<(unsigned)((entries + kPackThreads - 1) / kPackThreads), kPackThreads,
                           0, s>>>(neighbors, weights, degree, (uint2*)table, N, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kernel<<<(unsigned)N, threads, smem, s>>>((const uint2*)table, degree, out, N, D, W, L,
                                            (uint32_t)k0, (uint32_t)k1, p_halt, inv_keep);
  return (int)cudaGetLastError();
}
