// Row-gather probe (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel prof_dma.py::kern (:6-24, pallas_call at :33):
// for each block of B ids, copy the B table rows they name into fast memory,
// several copies in flight (there: pltpu.make_async_copy into VMEM with 64
// DMA semaphores), and write the first 1,024 values of the block's
// concatenated rows.  Here a block of the grid reads its B rows with 16-byte
// read-only vector loads straight into registers, keeps its part of the head
// and adds every value into a float64 sum: on the TPU every row lands in
// VMEM, so the sum makes the whole gather part of what is checked, and reads
// nothing the TPU kernel does not read.
//
// The block's rows, laid end to end, are one run of 16-byte chunks (a row is
// a whole number of chunks): thread t takes chunks t, t + kThreads, ..., so
// neighbouring threads read neighbouring addresses of a row, and issues
// kUnroll loads before it adds any.  Chunk q is row q / C, chunk q % C of it
// (C chunks a row), and value q * (16 / sizeof(T)) of the concatenation, so
// the head is the block's first 1,024 / (16 / sizeof(T)) chunks.  Each thread
// keeps a float64 partial sum, and the block reduces them once, at the end:
// no barrier per row, and every thread issues its own copies.  Bulk copies
// into a ring of shared-memory stages, one ring a block (a barrier a row)
// or one a warp (its lane 0 issuing the copies), were slower on the H100 at
// every row length measured (PERF.md).
//
// What bounds it on the card: the bytes of the rows, read from device
// memory (or from L2 where ids repeat and the rows still sit there).  Each
// thread keeps kUnroll 16-byte loads in flight, so a block of 1,024
// threads (an SM holds one: 41 registers a thread) keeps 64 KB in flight,
// above what the memory's latency times its rate needs (~25 KB per SM at
// 3.35 TB/s and ~1 us).  Of 256, 512 and 1,024 threads with 2-16 loads
// each, 1,024 x 4 was the fastest without spills at all three of the
// probe's shapes on the H100 (PERF.md).
//
// Rows must be a multiple of 16 bytes and the table 16-byte aligned; the
// wrapper checks both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kHead = 1024;            // values of the head kept per block
constexpr int kUnroll = 4;             // 16-byte loads in flight a thread
constexpr int kWarps = kThreads / 32;

// A 16-byte chunk of T values.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  using type = float4;
  __device__ static double sum(const float4& v) {
    return ((double)v.x + (double)v.y) + ((double)v.z + (double)v.w);
  }
};
template <> struct Chunk<double> {
  using type = double2;
  __device__ static double sum(const double2& v) { return v.x + v.y; }
};

// Dynamic shared memory: the block's B ids, then one partial sum a warp.
__host__ __device__ inline int ids_bytes(int B) { return (B * 4 + 15) / 16 * 16; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                  int F, int B, T* __restrict__ head,
                  double* __restrict__ sums) {
  using V = typename Chunk<T>::type;
  constexpr int NV = 16 / sizeof(T);          // values a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* bid = reinterpret_cast<int32_t*>(smem);
  double* part = reinterpret_cast<double*>(smem + ids_bytes(B));
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < B; j += kThreads)
    bid[j] = ids[(int64_t)b * B + j];
  __syncthreads();

  const V* tab = reinterpret_cast<const V*>(table);
  V* hd = reinterpret_cast<V*>(head + (int64_t)b * kHead);
  const int C = F / NV;                       // chunks a row
  const int Q = B * C;                        // chunks of the block
  // (r, c): row and chunk of this thread's next chunk; a step of kThreads
  // chunks is dr rows and dc chunks
  int r = threadIdx.x / C, c = threadIdx.x % C;
  const int dr = kThreads / C, dc = kThreads % C;
  double acc = 0.0;
  for (int q0 = threadIdx.x; q0 < Q; q0 += kUnroll * kThreads) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q0 + u * kThreads < Q)
        v[u] = __ldg(tab + (int64_t)bid[r] * C + c);
      r += dr;
      c += dc;
      if (c >= C) {
        c -= C;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * kThreads;
      if (q < Q) {
        acc += Chunk<T>::sum(v[u]);
        if (q < kHead / NV) hd[q] = v[u];
      }
    }
  }

  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kWarps; ++w) total += part[w];
    sums[b] = total;
  }
}

template <typename T>
int launch_row_gather(const T* table, const int32_t* ids, int n_blocks, int F,
                      int B, T* head, double* sums, void* stream) {
  const int row_bytes = F * (int)sizeof(T);
  if (B < 1 || F < 1 || row_bytes % 16 != 0 || (int64_t)B * F < kHead ||
      (int64_t)B * (row_bytes / 16) > INT32_MAX - kUnroll * kThreads ||
      ((uintptr_t)table & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = ids_bytes(B) + kWarps * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_gather_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n_blocks > 0)
    row_gather_kernel<T><<<n_blocks, kThreads, smem, (cudaStream_t)stream>>>(
        table, ids, F, B, head, sums);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int row_gather_head() { return kHead; }

int row_gather_f32(const float* table, const int32_t* ids, int n_blocks,
                   int F, int B, float* head, double* sums, void* stream) {
  return launch_row_gather<float>(table, ids, n_blocks, F, B, head, sums,
                                  stream);
}

int row_gather_f64(const double* table, const int32_t* ids, int n_blocks,
                   int F, int B, double* head, double* sums, void* stream) {
  return launch_row_gather<double>(table, ids, n_blocks, F, B, head, sums,
                                   stream);
}

}  // extern "C"
