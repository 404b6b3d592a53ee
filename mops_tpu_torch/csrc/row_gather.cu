// Row-gather probe (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel prof_dma.py::kern (:6-24, pallas_call at :33):
// for each block of B ids, copy the B table rows they name into fast memory,
// several copies in flight (there: pltpu.make_async_copy into VMEM with 64
// DMA semaphores), and write the first 1,024 values of the block's
// concatenated rows.  Here a block of the grid streams its B rows through a
// ring of shared-memory stages filled by 1-D bulk copies (cp.async.bulk, the
// TMA's copy of a contiguous run), one mbarrier per stage counting the
// stage's bytes.  As each row lands the block keeps its part of the head
// and adds its values into a float64 sum: on the TPU every row lands in
// VMEM, so the sum makes the whole gather part of what is checked, and
// reads nothing the TPU kernel does not read.  (Stages of several small
// rows, one barrier per stage, measured slower on the H100 at all three
// shapes of chip_smoke.py; PERF.md.)
//
// What bounds it on the card: the bytes of the rows, read from device
// memory (or from L2 where ids repeat and the rows still sit there).  The
// ring keeps up to kMaxStages rows (at most kRingBytes) in flight per block,
// and several blocks share an SM where the ring is small, so the bytes in
// flight per SM stay well above what the memory's latency times its rate
// needs (~25 KB per SM at 3.35 TB/s and ~1 us).  One thread issues the
// copies; every thread consumes every row.
//
// Rows must be a multiple of 16 bytes and 16-byte aligned (the bulk copy's
// rule); the wrapper checks both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHead = 1024;            // values of the head kept per block
constexpr int kMaxStages = 32;
constexpr int kRingBytes = 192 * 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Arrive once and expect ``bytes`` more of copies on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase is no longer ``parity``.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// Global -> shared copy of ``bytes`` (a multiple of 16), completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bytes before the ring: one mbarrier per stage and one partial sum per
// warp, rounded up to 128.
__host__ __device__ inline int header_bytes(int stages) {
  return (stages * 8 + kWarps * 8 + 127) / 128 * 128;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                  int F, int B, int stages, T* __restrict__ head,
                  double* __restrict__ sums) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  double* part = reinterpret_cast<double*>(smem + stages * 8);
  T* ring = reinterpret_cast<T*>(smem + header_bytes(stages));
  const int b = blockIdx.x;
  const int32_t* bid = ids + (int64_t)b * B;
  const uint32_t row_bytes = (uint32_t)F * sizeof(T);

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&bars[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < stages && j < B; ++j) {
      mbar_expect_tx(&bars[j], row_bytes);
      bulk_copy(ring + (size_t)j * F, table + (int64_t)bid[j] * F, row_bytes,
                &bars[j]);
    }
  }

  double acc = 0.0;
  for (int j = 0; j < B; ++j) {
    const int st = j % stages;
    mbar_wait(&bars[st], (uint32_t)((j / stages) & 1));
    const T* row = ring + (size_t)st * F;
    for (int c = threadIdx.x; c < F; c += kThreads) acc += (double)row[c];
    const int h0 = j * F;                    // head index of the row's start
    if (h0 < kHead) {
      const int hn = kHead - h0 < F ? kHead - h0 : F;
      for (int c = threadIdx.x; c < hn; c += kThreads)
        head[(int64_t)b * kHead + h0 + c] = row[c];
    }
    __syncthreads();                         // every thread is done with st
    if (threadIdx.x == 0 && j + stages < B) {
      mbar_expect_tx(&bars[st], row_bytes);
      bulk_copy(ring + (size_t)st * F, table + (int64_t)bid[j + stages] * F,
                row_bytes, &bars[st]);
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

// Stages of the ring for rows of ``row_bytes``: as many as fit in
// kRingBytes, at most kMaxStages and B; 0 when one row does not fit.
inline int ring_stages(int row_bytes, int B) {
  int st = kRingBytes / row_bytes;
  st = st < kMaxStages ? st : kMaxStages;
  return st < B ? st : B;
}

template <typename T>
int launch_row_gather(const T* table, const int32_t* ids, int n_blocks, int F,
                      int B, T* head, double* sums, void* stream) {
  const int row_bytes = F * (int)sizeof(T);
  if (B < 1 || F < 1 || row_bytes % 16 != 0 || (int64_t)B * F < kHead ||
      ((uintptr_t)table & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int stages = ring_stages(row_bytes, B);
  if (stages < 1) return (int)cudaErrorInvalidValue;
  const int smem = header_bytes(stages) + stages * row_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_gather_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n_blocks > 0)
    row_gather_kernel<T><<<n_blocks, kThreads, smem, (cudaStream_t)stream>>>(
        table, ids, F, B, stages, head, sums);
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
