// DINOv2's SwiGLU gate for Hopper (sm_90a): out = silu(h[:, :H]) * h[:, H:].
//
// It replaces no Pallas kernel: the JAX package has no DINOv2, and its
// feed-forwards leave their element-wise work to XLA. It was added for the
// port's DINOv2 backbone (depthg_tpu_torch/models/vit.py SwiGLU), where the
// eager gate is three passes over w12's output: silu over the strided half
// a, then the product with the strided half b, each a full read and write
// of [M, H] (the 270 MB intermediate does not survive in the 50 MB L2).
//
// Arithmetic: what depthg_tpu_torch/ops/swiglu.py swiglu_gate_plain
// computes, F.silu(a) * b, bit for bit. In float32, s = x / (1 + expf(-x))
// with IEEE division and the accurate expf (the flags have no fast-math), as
// torch's silu computes in its opmath type; bf16 rounds s to bf16 (round to
// nearest even), then multiplies float(s) by float(b) and rounds again, as
// torch's bf16 product does. float32 takes the same steps with no rounding
// in between.
//
// What bounds it: bytes. At the DINOv2 cell's shape (M = 32 x 1,029 rows,
// H = 4,096, bf16) a launch reads [M, 2H] (539.5 MB) and writes [M, H]
// (269.7 MB): 809 MB, 0.2416 ms at 3.35 TB/s. The CUDA-core work (one
// expf, one division and two products an element) stays below it.
//
// Design: one read and one write of every byte, in 16-byte accesses. The
// flattened M x H/V vectors (V = 8 bf16 or 4 float32) are walked
// grid-stride by a grid that fills every SM; a thread loads UNROLL vectors
// of a and the matching ones of b (the same row, H elements on) before it
// stores any output, neighbouring threads on neighbouring addresses. The
// loads are marked streaming (ld.global.cs, evicted first: w12's output is
// dead after the gate); the stores are plain, since w3's product reads the
// output next. A ragged last row count needs no padding: each vector is
// checked. The grid (every SM times the blocks resident on one) is read
// from the runtime once a device and dtype, not at every launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // vectors of a and of b in flight a thread

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// one 16-byte vector of the output from the matching vectors of a and b
__device__ __forceinline__ uint4 gate(uint4 a, uint4 b, __nv_bfloat16*) {
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
  uint4 o;
  uint32_t* po = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    po[i] = pack_bf16(round_bf16(silu(lo_f(pa[i]))) * lo_f(pb[i]),
                      round_bf16(silu(hi_f(pa[i]))) * hi_f(pb[i]));
  return o;
}

__device__ __forceinline__ uint4 gate(uint4 a, uint4 b, float*) {
  uint4 o;
  o.x = __float_as_uint(silu(__uint_as_float(a.x)) * __uint_as_float(b.x));
  o.y = __float_as_uint(silu(__uint_as_float(a.y)) * __uint_as_float(b.y));
  o.z = __float_as_uint(silu(__uint_as_float(a.z)) * __uint_as_float(b.z));
  o.w = __float_as_uint(silu(__uint_as_float(a.w)) * __uint_as_float(b.w));
  return o;
}

// h: [m, 2 * hv] vectors, out: [m, hv] vectors; n = m * hv < 2^31 (unsigned
// index arithmetic: v + row * hv < 2n)
template <typename T>
__global__ void __launch_bounds__(THREADS) swiglu_gate_kernel(const uint4* __restrict__ h,
                                                              uint4* __restrict__ out,
                                                              unsigned n, unsigned hv) {
  const unsigned stride = gridDim.x * THREADS * UNROLL;
  for (unsigned v0 = blockIdx.x * THREADS * UNROLL + threadIdx.x; v0 < n; v0 += stride) {
    uint4 a[UNROLL], b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned v = v0 + u * THREADS;
      if (v < n) {
        const unsigned at = v + v / hv * hv;  // row * 2 hv + the column
        a[u] = __ldcs(h + at);
        b[u] = __ldcs(h + at + hv);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned v = v0 + u * THREADS;
      if (v < n) out[v] = gate(a[u], b[u], static_cast<T*>(nullptr));
    }
  }
}

constexpr int MAX_DEVICES = 64;

// sms x resident blocks an SM of `device` for swiglu_gate_kernel<T>: read
// from the runtime at the first launch on the device, kept for every later
// one (0: not read yet; a race reads the same value twice)
template <typename T>
cudaError_t resident_blocks(int device, long long* resident) {
  static std::atomic<long long> cache[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  long long got = cache[device].load(std::memory_order_relaxed);
  if (got == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, swiglu_gate_kernel<T>,
                                                          THREADS, 0);
    if (err != cudaSuccess) return err;
    got = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    cache[device].store(got, std::memory_order_relaxed);
  }
  *resident = got;
  return cudaSuccess;
}

template <typename T>
int launch(const void* h, void* out, int m, int hidden, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (m < 1 || hidden < V || hidden % V) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(m) * (hidden / V);
  if (n > INT_MAX)  // the kernel's unsigned offsets reach 2n plus one grid step
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  long long resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = resident_blocks<T>(device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const int grid = static_cast<int>(blocks < resident ? blocks : resident);
  swiglu_gate_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint4*>(h), static_cast<uint4*>(out), static_cast<unsigned>(n),
      static_cast<unsigned>(hidden / V));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h: [m, 2 * hidden] row-major, 16-byte aligned; out: [m, hidden] row-major,
// 16-byte aligned. dtype 0: bf16, 1: float32. Returns a cudaError_t.
extern "C" int depthg_swiglu_gate(const void* h, void* out, int m, int hidden, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(h, out, m, hidden, s);
  if (dtype == 1) return launch<float>(h, out, m, hidden, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
