// K3: ELL -> stencil conversion
//   out[l, s, i] = sum_r vals[l, i, r] * [vals != 0  and  cols[l, i, r] - i == off_s].
//
// Replaces the Pallas kernel graphgp_tpu/pallas_kernels/stencil_build.py
// (ell_to_stencil_pallas / _build_kernel, the pl.pallas_call at :73), run
// once per graph when preprocess_graph(layout="auto") converts the step
// matrices of a structured graph to the stencil layout.
//
// What bounds it on an H100: device-memory bytes, 8*L*N*R to read cols and
// vals once plus 4*L*S*N to write the stencil values (~3 GB at the flagship
// N = 1e6, L = 5, R = 56, S = 41). The slot lookup is a few shared-memory
// operations per live entry.
//
// The first version gave a thread one node and read its R slots, so the
// lanes of a warp read R words apart (32 cache lines for 128 useful bytes at
// R = 56).
//
// Design. The rows of `tile` consecutive nodes of one step are one
// contiguous slab of tile*R entries in cols and in vals. Persistent blocks
// walk over (step, tile) pairs, blockIdx.x, then gridDim.x further on; each
// tile's slab is cut into chunks of at most `chunk` entries (one chunk
// unless R is wide), staged one at a time in shared memory: the next
// chunk's copy is issued as soon as the current one has been read, so it
// overlaps the tile's write-out, and the blocks that share an SM overlap
// each other's copies. When every chunk starts and ends on 16 bytes (N*R
// and chunk multiples of 4, pointers aligned), one thread moves a chunk of
// cols and of vals by two TMA bulk copies (cp.async.bulk) that complete on
// an mbarrier; otherwise every thread issues 4-byte cp.async copies.
// Threads then take consecutive entries of the staged chunk (no strided
// reads, no bank conflicts), skip vals == 0, and find the slot of cols - i
// in a direct table over the offsets' span (slot_of[d - off_lo], built per
// block, when the span fits `lookup` entries) or else by a branch-free
// lower bound over the sorted offsets, and add into an (S, tile) tile in
// shared memory with a shared-memory atomic; a tile row is tile + 1 floats,
// so the lanes of a warp, which share a node and differ in offset, hit
// distinct banks. A consolidated row holds distinct live columns, so each
// cell receives at most one entry and the result is bit-identical to the
// plain version (two entries would still be exact: one float addition
// commutes). After a tile's last chunk the block writes the tile out row by
// row, coalesced, zeros included, and clears it as it reads it: every
// output element is written once and the output needs no zero fill. No
// float atomics go to device memory.
//
// Narrow rows whose offsets span too many columns for the direct table
// (R <= 8 and a binary search: the planner's choice,
// cuda_kernels/stencil_build.py: plan) take the first version's schedule
// instead: a block of 128 threads, one a node, each reading its own R slots
// from device memory and adding into its own column of the tile with no
// atomic. A warp's reads of one slot then fall in the 32*R*4 contiguous
// bytes its rows span, L1 serves the other slots, and there is no staging
// round trip, which at a few live entries a row and a binary search each
// costs more than it saves (the 2^20-node ring, R = 8, offsets that wrap
// round it). Measured on an H100 by
// benchmarks/torch_stencil_build_variants.py, as are the tile, the single
// stage and the direct table's gain over the binary search.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNodeThreads = 128;  // the narrow-row schedule: one thread a node
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB, the most a block may ask for on sm_90
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The slot of offset d among the S sorted offsets, or -1: a branch-free
// lower bound (top: the highest power of two <= S).
__device__ __forceinline__ int lower_bound_slot(const int* s_off, int S, int top, int d) {
  int lo = 0;  // offsets < d
  for (int h = top; h > 0; h >>= 1) {
    if (lo + h <= S && s_off[lo + h - 1] < d) lo += h;
  }
  return s_off[lo] == d ? lo : -1;  // lo < S: d is at most the last offset
}

// Chunk q of a block's stream: its tile's step, first node and live nodes,
// and the chunk's first entry in cols / vals and its length (0 past the
// tile's slab).
struct Chunk {
  int l, c, nodes, len;
  long long i0, src;
};

__device__ __forceinline__ Chunk chunk_of(long long q, int chunks, long long tiles_per_step,
                                          long long N, int R, int tile, int chunk) {
  Chunk k;
  const long long t = blockIdx.x + (q / chunks) * gridDim.x;
  k.c = (int)(q % chunks);
  k.l = (int)(t / tiles_per_step);
  k.i0 = (t % tiles_per_step) * tile;
  k.nodes = (int)min((long long)tile, N - k.i0);
  const int first = k.c * chunk;
  k.len = max(0, min(chunk, k.nodes * R - first));
  k.src = ((long long)k.l * N + k.i0) * R + first;
  return k;
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads)
ell_to_stencil_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                      const int* __restrict__ offs, float* __restrict__ out, int L,
                      long long N, int R, int S, int tile, int chunk, int lookup) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the buffer starts 32 bytes in: at 16 the flagship read 7% slower
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);               // one mbarrier
  int* s_cols = reinterpret_cast<int*>(smem + 32);                  // [chunk]
  float* s_vals = reinterpret_cast<float*>(s_cols + chunk);         // [chunk]
  float* acc = s_vals + chunk;                                      // [S][tile + 1]
  int* s_off = reinterpret_cast<int*>(acc + (size_t)S * (tile + 1));  // [S]
  unsigned short* slot_of = reinterpret_cast<unsigned short*>(s_off + S);  // [lookup]

  const int t = threadIdx.x;
  const int row = tile + 1;
  const long long tiles_per_step = (N + tile - 1) / tile;
  const long long my_tiles =
      ((long long)L * tiles_per_step - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int chunks = (tile * R + chunk - 1) / chunk;
  const long long my_chunks = my_tiles * chunks;

  for (int k = t; k < S; k += kThreads) s_off[k] = offs[k];
  for (int k = t; k < S * row; k += kThreads) acc[k] = 0.0f;
  for (int k = t; k < lookup; k += kThreads) slot_of[k] = 0;
  if (kBulk && t == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Copy chunk k into the buffer: with kBulk one thread, else all threads,
  // one cp.async group each.
  auto issue = [&](const Chunk& k) {
    if (kBulk) {
      if (t == 0) {
        mbar_arrive_expect(bar, 8u * (unsigned)k.len);
        if (k.len > 0) {
          bulk_copy(s_cols, cols + k.src, 4u * k.len, bar);
          bulk_copy(s_vals, vals + k.src, 4u * k.len, bar);
        }
      }
    } else {
      for (int e = t; e < k.len; e += kThreads) {
        cp_async4(s_cols + e, cols + k.src + e);
        cp_async4(s_vals + e, vals + k.src + e);
      }
      cp_async_commit();
    }
  };

  Chunk k = chunk_of(0, chunks, tiles_per_step, N, R, tile, chunk);  // the chunk in the buffer
  if (my_chunks > 0) issue(k);

  const int off_lo = s_off[0], off_hi = s_off[S - 1];
  const int top = 1 << (31 - __clz(S));  // the highest power of two <= S
  const int step_nodes = kThreads / R, step_slots = kThreads % R;
  // a direct table slot_of[d - off_lo] = slot + 1 (0: not an offset) when
  // the offsets' span fits the `lookup` entries given, else a binary search
  const bool direct = (long long)off_hi - off_lo < lookup;
  if (direct) {
    __syncthreads();  // the table is cleared
    for (int m = t; m < S; m += kThreads) slot_of[s_off[m] - off_lo] = (unsigned short)(m + 1);
  }

  for (long long q = 0; q < my_chunks; ++q) {
    if (kBulk) {
      mbar_wait(bar, (unsigned)(q & 1));
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // the chunk is staged; the previous tile is written out and cleared

    const int first = k.c * chunk + t;
    int node = first / R, slot = first % R;
#pragma unroll 1  // unrolled, the 4-byte copy build spilled and read 11% slower
    for (int e = t; e < k.len; e += kThreads) {
      const float x = s_vals[e];
      const long long d = (long long)s_cols[e] - (k.i0 + node);
      if (x != 0.0f && d >= off_lo && d <= off_hi) {
        const int di = (int)d;
        const int pos =
            direct ? (int)slot_of[di - off_lo] - 1 : lower_bound_slot(s_off, S, top, di);
        if (pos >= 0) atomicAdd(&acc[pos * row + node], x);
      }
      node += step_nodes;
      slot += step_slots;
      if (slot >= R) {
        slot -= R;
        ++node;
      }
    }
    __syncthreads();  // the buffer is read and the tile complete

    if (kBulk) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const Chunk next = chunk_of(q + 1, chunks, tiles_per_step, N, R, tile, chunk);
    if (q + 1 < my_chunks) issue(next);

    if (k.c == chunks - 1) {
      const int shift = 31 - __clz(tile);
      for (int e = t; e < S * tile; e += kThreads) {
        const int s = e >> shift, j = e & (tile - 1);
        if (j < k.nodes) {
          float* cell = &acc[s * row + j];
          out[((long long)k.l * S + s) * N + k.i0 + j] = *cell;
          *cell = 0.0f;
        }
      }
    }
    k = next;
  }
}

// The narrow-row schedule: a block owns one step and kNodeThreads nodes, a
// thread one node; it reads its R slots and adds into its own column of the
// (S, kNodeThreads) tile, then the block writes the tile out row by row.
__global__ void __launch_bounds__(kNodeThreads)
ell_to_stencil_rows_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                           const int* __restrict__ offs, float* __restrict__ out, long long N,
                           int R, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_off = reinterpret_cast<int*>(smem);  // [S]
  float* acc = reinterpret_cast<float*>(s_off + S);  // [S][kNodeThreads]

  const int l = blockIdx.y;
  const long long i0 = (long long)blockIdx.x * kNodeThreads;
  const int t = threadIdx.x;
  for (int k = t; k < S; k += kNodeThreads) s_off[k] = offs[k];
  for (int k = t; k < S * kNodeThreads; k += kNodeThreads) acc[k] = 0.0f;
  __syncthreads();

  const int off_lo = s_off[0], off_hi = s_off[S - 1];
  const int top = 1 << (31 - __clz(S));
  const long long i = i0 + t;
  if (i < N) {
    const long long base = ((long long)l * N + i) * R;
    for (int r = 0; r < R; ++r) {
      const float x = vals[base + r];
      if (x == 0.0f) continue;  // a dead slot's column is not read
      const long long d = (long long)cols[base + r] - i;
      if (d < off_lo || d > off_hi) continue;
      const int pos = lower_bound_slot(s_off, S, top, (int)d);
      if (pos >= 0) acc[pos * kNodeThreads + t] += x;
    }
  }
  __syncthreads();

  for (int k = t; k < S * kNodeThreads; k += kNodeThreads) {
    const long long node = i0 + (k % kNodeThreads);
    if (node < N) out[((long long)l * S + k / kNodeThreads) * N + node] = acc[k];
  }
}

size_t smem_bytes(int S, int tile, int chunk, int lookup) {
  return 32 + 8 * (size_t)chunk + 4 * (size_t)S * (tile + 1) + 4 * (size_t)S + 2 * (size_t)lookup;
}

// cudaFuncSetAttribute once per kernel, device and size: the largest size
// set so far on each device is remembered.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int which, size_t bytes) {
  static size_t allowed[3][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[which][dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[which][dev] = bytes;
  return err;
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

}  // namespace

// staged: 1 for the staged schedule, 0 for the narrow-row one (which reads
// no other argument after it); tile: nodes per tile, a power of two in
// [32, 512]; chunk: entries staged at once, at most tile * R; bulk: TMA bulk
// copies (needs N*R and chunk multiples of 4 and cols / vals 16-byte
// aligned); lookup: entries of the direct slot table (0: always the binary
// search).
extern "C" int ell_to_stencil_f32(const int* cols, const float* vals, const int* offs,
                                  float* out, int L, long long N, int R, int S, int staged,
                                  int tile, int chunk, int bulk, int lookup, void* stream) {
  if (L < 1 || N < 1 || R < 1 || S < 1 || S > 256 || L > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (!staged) {
    const size_t smem = 4 * (size_t)S * (kNodeThreads + 1);
    if ((err = allow_smem(ell_to_stencil_rows_kernel, 2, smem)) != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((N + kNodeThreads - 1) / kNodeThreads), (unsigned)L);
    ell_to_stencil_rows_kernel<<<grid, kNodeThreads, smem, st>>>(cols, vals, offs, out, N, R, S);
    return (int)cudaGetLastError();
  }
  if (tile < 32 || tile > 512 || (tile & (tile - 1)) != 0 ||
      (long long)tile * R > 0x7fffffffLL || chunk < 1 || chunk > tile * R || lookup < 0 ||
      lookup > 65536) {
    return (int)cudaErrorInvalidValue;
  }
  if (bulk && ((N * R) % 4 != 0 || chunk % 4 != 0 || !aligned16(cols) || !aligned16(vals))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(S, tile, chunk, lookup);
  if (smem > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  auto kernel = bulk ? ell_to_stencil_kernel<true> : ell_to_stencil_kernel<false>;
  if ((err = allow_smem(kernel, bulk ? 1 : 0, smem)) != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)L * ((N + tile - 1) / tile);
  const long long blocks = min(tiles, (long long)sms * max(per_sm, 1));
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(cols, vals, offs, out, L, N, R, S, tile,
                                                   chunk, lookup);
  return (int)cudaGetLastError();
}
