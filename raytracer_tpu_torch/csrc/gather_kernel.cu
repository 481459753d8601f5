// The backward of a table read table[idx]: out[r, :] = sum over positions p
// with idx[p] == r of grad[p, :], for a table of R rows of C floats.
//
// Replaces no TPU kernel: in the JAX package this is XLA's scatter-add, the
// transpose of the replay's gathers. It was added because PyTorch's CUDA
// backward of an advanced-index read (index_put_ with accumulate) sorts the
// indices and gives each distinct row to one warp, which walks that row's
// duplicates one after another. The replay's reads are very skewed (every
// miss lane reads row 0, the ground sphere takes a large share of the
// hits), so a few rows carry hundreds of thousands of duplicates a bounce
// and that serial walk took half a second a train step on an H100.
//
// What bounds it on an H100: bytes. The cotangent, N x C floats, is read
// once (the indices add 4 or 8 bytes a position); a train step reads about
// 180 MB of it, 0.05 ms at 3.35 TB/s.
//
// Design: no sort, and a hot row costs what a cold one does.
// * Pass 1 (`gather_backward_partial`): a grid of (position blocks, row
//   tiles). Each block takes a contiguous range of positions, and each of
//   its warps a contiguous share of that range, which the warp walks in
//   order with its lanes over the columns, adding into its own copy of the
//   block's row tile in shared memory. It walks 32 positions at a time:
//   their rows in one coalesced load, their 32 cotangent rows loaded before
//   any is added, so a warp keeps 32 loads in flight and not one. The
//   warps' copies are then summed in warp order, and the block writes its
//   tile of a (blocks, R, C) partial. A table whose one copy fits the
//   block's shared-memory budget has one tile; a larger one is cut into
//   row tiles, each scanning the positions again and reading only the
//   cotangent rows that fall in it.
// * Pass 2 (`gather_backward_sum`): eight lanes sum an element's partials,
//   each over every eighth block in block order, and a fixed shuffle tree
//   adds their eight sums. With one position block, pass 1 writes the
//   gradient itself and pass 2 does not run.
// Deterministic: the launch shape depends on the shapes and the card alone
// (ops/gather_kernel.py:launch_plan), every sum runs in a fixed order, and
// no float atomics carry a sum, so the same inputs give bit-identical
// gradients from run to run.
//
// Plain twin (and spec): raytracer_tpu_torch/ops/gather_kernel.py:
// gather_backward_plain (index_add_ on the CPU).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// Pass 2: each element's partials are summed by kSplit lanes, lane s over
// blocks s, s + kSplit, ... in order, and the kSplit sums combined by a
// fixed shuffle tree.
constexpr int kSplit = 8;
constexpr int kDefaultSharedBytes = 48 * 1024;

template <typename Index>
__global__ void gather_backward_partial(const float* __restrict__ grad,
                                        const Index* __restrict__ idx, long long n, int rows,
                                        int cols, int tile_rows, float* __restrict__ partial) {
  extern __shared__ float acc[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long row0 = (long long)blockIdx.y * tile_rows;
  const int tile = (int)min((long long)tile_rows, rows - row0);
  const int tile_elems = tile * cols;
  for (int i = threadIdx.x; i < warps * tile_elems; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  const long long per_block = (n + gridDim.x - 1) / gridDim.x;
  const long long b0 = min(n, (long long)blockIdx.x * per_block);
  const long long b1 = min(n, b0 + per_block);
  const long long per_warp = (b1 - b0 + warps - 1) / warps;
  const long long p_begin = min(b1, b0 + warp * per_warp);
  const long long p_end = min(b1, p_begin + per_warp);
  float* mine = acc + warp * tile_elems;
  for (int c0 = 0; c0 < cols; c0 += kWarp) {
    const int c = c0 + lane;
    const bool col_on = c < cols;
    // A batch of 32 positions: lane u loads position u's row (one
    // coalesced load), every lane loads its column of the 32 cotangent rows
    // before any is added (32 loads in flight), then the warp adds them in
    // position order, each row taken from lane u by a shuffle.
    for (long long base = p_begin; base < p_end; base += kWarp) {
      const long long r_lane =
          base + lane < p_end ? (long long)idx[base + lane] - row0 : -1;
      const bool in_tile = r_lane >= 0 && r_lane < tile;
      const unsigned live = __ballot_sync(kFull, in_tile);
      float g[kWarp];
#pragma unroll
      for (int u = 0; u < kWarp; ++u)
        g[u] = col_on && (live >> u & 1u) ? grad[(base + u) * cols + c] : 0.0f;
#pragma unroll
      for (int u = 0; u < kWarp; ++u) {
        const int r = __shfl_sync(kFull, (int)r_lane, u);
        if (col_on && (live >> u & 1u)) mine[r * cols + c] += g[u];
      }
    }
  }
  __syncthreads();

  float* dst = partial + (long long)blockIdx.x * rows * cols + row0 * cols;
  for (int i = threadIdx.x; i < tile_elems; i += blockDim.x) {
    float s = acc[i];
    for (int w = 1; w < warps; ++w) s += acc[w * tile_elems + i];
    dst[i] = s;
  }
}

__global__ void gather_backward_sum(const float* __restrict__ partial, int blocks,
                                    long long elems, float* __restrict__ out) {
  constexpr int kPerWarp = kWarp / kSplit;
  const int lane = threadIdx.x % kWarp;
  const int split = lane / kPerWarp;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp * kPerWarp +
                      lane % kPerWarp;
  float s = 0.0f;
  if (i < elems) {
#pragma unroll 4
    for (int b = split; b < blocks; b += kSplit) s += partial[(long long)b * elems + i];
  }
#pragma unroll
  for (int off = kWarp / 2; off >= kPerWarp; off /= 2) s += __shfl_xor_sync(kFull, s, off);
  if (split == 0 && i < elems) out[i] = s;
}

template <typename Index>
int launch_partial(const float* grad, const Index* idx, long long n, int rows, int cols,
                   int tile_rows, int tiles, int blocks, int warps, float* partial,
                   cudaStream_t stream) {
  const int smem = warps * tile_rows * cols * (int)sizeof(float);
  if (smem > kDefaultSharedBytes) {
    static int allowed = kDefaultSharedBytes;  // per instantiation
    if (smem > allowed) {
      const cudaError_t err = cudaFuncSetAttribute(
          gather_backward_partial<Index>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      allowed = smem;
    }
  }
  gather_backward_partial<Index><<<dim3(blocks, tiles), warps * kWarp, smem, stream>>>(
      grad, idx, n, rows, cols, tile_rows, partial);
  return 0;
}

}  // namespace

// Returns the first CUDA error of the launches (0 = launched). `partial`
// holds (blocks, rows, cols) floats, and may be `out` when blocks == 1.
extern "C" int rt_gather_backward(const void* grad, const void* idx, int idx_is_64, int n,
                                  int rows, int cols, int tile_rows, int tiles,
                                  int blocks, int warps, void* partial, void* out,
                                  int sum_threads, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = idx_is_64
      ? launch_partial((const float*)grad, (const int64_t*)idx, n, rows, cols, tile_rows,
                       tiles, blocks, warps, (float*)partial, s)
      : launch_partial((const float*)grad, (const int32_t*)idx, n, rows, cols, tile_rows,
                       tiles, blocks, warps, (float*)partial, s);
  if (err != 0) return err;
  if (blocks > 1) {
    const long long elems = (long long)rows * cols;
    const long long per_block = (long long)sum_threads / kWarp * (kWarp / kSplit);
    const long long grid = (elems + per_block - 1) / per_block;
    gather_backward_sum<<<(unsigned)grid, sum_threads, 0, s>>>((const float*)partial, blocks,
                                                               elems, (float*)out);
  }
  return (int)cudaGetLastError();
}
