// models.vit's residual junction for Hopper (sm_90a): the block's
// s = x + gamma * y and the LayerNorm of s, in one pass over [rows, D].
//
// It replaces no Pallas kernel: the JAX package leaves its blocks'
// element-wise work to XLA. It was added for the port's ViT blocks
// (depthg_tpu_torch/models/vit.py Block, LayerScaleBlock and the final
// norm), where each junction was up to five eager passes over [rows, D]:
// the LayerScale product (its broadcast gamma off the vectorised path), the
// bf16 add, and the float32 LayerNorm's up-cast, norm and down-cast.
//
// Three entries, one template (MODE):
//   RESIDUAL_NORM: out_x = x + gamma * y, out_n = LN(out_x)   8 B/element (bf16)
//   RESIDUAL:      out_x = x + gamma * y                      6 B/element
//   NORM:          out_n = LN(x)                              4 B/element
// gamma may be null (DINO v1's Block): then out_x = x + y. Float32 moves
// twice the bytes. Those byte counts are the bound: the work is below the
// card's 295 FLOP/byte line, so a launch takes at least its bytes over
// 3.35 TB/s.
//
// Arithmetic: what depthg_tpu_torch/ops/residual_norm.py's plain versions
// compute. The residual rounds where eager `x + y * gamma` rounds: the
// product is rounded to the dtype (bf16: round to nearest even), then the
// sum is rounded again; __fmul_rn / __fadd_rn keep nvcc from contracting
// the pair into one fma, so out_x is bit-equal to eager. Without gamma the
// product is y * 1, which is y. The norm reads s as float32, takes the mean
// and then the (biased) variance over the row's registers in float32,
// rstd = rsqrtf(var + eps) as PyTorch's CUDA layer norm takes it, applies
// weight and bias read as float32 and rounds once to the output dtype. It
// differs from F.layer_norm on float32 values only in the order of the sums
// (and so can differ by one bf16 step once rounded).
//
// Design: one warp a row, the whole row in registers: E = D / 32 elements
// a lane (6 to 48 at D = 192 to 1,536; D a multiple of 64, at most 2,048).
// Each lane moves its elements in vectors of 16 bytes, or of 8 bytes where
// its share is not a multiple of 16 bytes (bf16 at D = 384, 640, ...), or
// of 4 bytes where it is an odd number of words (bf16 at D = 192, 320,
// ...), neighbouring lanes on neighbouring addresses. gamma, weight
// and bias are loaded once a warp into registers and kept across its rows
// (in float32 at D > 1,024 they would take over 96 registers: there they
// are read again for every row, from L1). The mean and the variance are
// two passes over the registers, each reduced by warp shuffles. A
// persistent grid (every SM times the blocks resident on one, read from the
// runtime once a device and instantiation) strides over the rows. The
// outputs are fresh tensors, never the inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DEVICES = 64;

enum Mode { NORM = 0, RESIDUAL = 1, RESIDUAL_NORM = 2 };

// a dtype's elements in 32-bit words: read one as float, write a pair
template <typename T>
struct Codec;

template <>
struct Codec<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;
  static constexpr uint32_t ONE = 0x3f803f80u;  // two bf16 ones
  __device__ static float get(const uint32_t* w, int e) {
    const uint32_t u = w[e >> 1];
    return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static void put(uint32_t* w, const float* v, int i) {  // elements 2i, 2i + 1
    __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);  // .x (low half) = 2i
    w[i] = *reinterpret_cast<uint32_t*>(&p);
  }
};

template <>
struct Codec<float> {
  static constexpr int PER_WORD = 1;
  static constexpr uint32_t ONE = 0x3f800000u;
  __device__ static float get(const uint32_t* w, int e) { return __uint_as_float(w[e]); }
  __device__ static float round(float v) { return v; }
  __device__ static void put(uint32_t* w, const float* v, int i) { w[i] = __float_as_uint(v[i]); }
};

// a lane's NW words of a row (or of a [D] parameter), in accesses of WV
// words: access c of lane l holds words (32 c + l) WV .. + WV - 1
template <int NW, int WV>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ row, int lane,
                                         uint32_t (&w)[NW]) {
#pragma unroll
  for (int c = 0; c < NW / WV; ++c) {
    const uint32_t* p = row + (32 * c + lane) * WV;
    if constexpr (WV == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[4 * c] = v.x, w[4 * c + 1] = v.y, w[4 * c + 2] = v.z, w[4 * c + 3] = v.w;
    } else if constexpr (WV == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[2 * c] = v.x, w[2 * c + 1] = v.y;
    } else {
      w[c] = *p;
    }
  }
}

template <int NW, int WV>
__device__ __forceinline__ void store_row(uint32_t* __restrict__ row, int lane,
                                          const uint32_t (&w)[NW]) {
#pragma unroll
  for (int c = 0; c < NW / WV; ++c) {
    uint32_t* p = row + (32 * c + lane) * WV;
    if constexpr (WV == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
    else if constexpr (WV == 2)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[2 * c], w[2 * c + 1]);
    else
      *p = w[c];
  }
}

// gamma's words, or the words of ones where there is none
template <typename T, int NW, int WV>
__device__ __forceinline__ void load_gamma(const uint32_t* __restrict__ gamma, int lane,
                                           uint32_t (&w)[NW]) {
  if (gamma != nullptr) {
    load_row<NW, WV>(gamma, lane, w);
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = Codec<T>::ONE;
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// x, y, out_x, out_n: [rows, D] row-major; gamma, weight, bias: [D]. E = D / 32.
template <typename T, int E, int MODE>
__global__ void __launch_bounds__(THREADS) residual_norm_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const uint32_t* __restrict__ gamma, const uint32_t* __restrict__ weight,
    const uint32_t* __restrict__ bias, uint32_t* __restrict__ out_x,
    uint32_t* __restrict__ out_n, long long rows, float eps) {
  using C = Codec<T>;
  constexpr int D = 32 * E;
  constexpr int NW = E / C::PER_WORD;        // words a lane holds of a row
  constexpr int WV = NW % 4 == 0 ? 4 : NW % 2 == 0 ? 2 : 1;  // words an access moves
  constexpr bool RES = MODE != NORM, NORMED = MODE != RESIDUAL;
  constexpr bool KEEP = 3 * NW <= 96;        // the parameters held in registers
  constexpr int NG = RES ? NW : 1, NP = NORMED ? NW : 1;

  const int lane = threadIdx.x & 31;
  uint32_t g[NG], wt[NP], bi[NP];
  if constexpr (KEEP) {
    if constexpr (RES) load_gamma<T, NG, WV>(gamma, lane, g);
    if constexpr (NORMED) {
      load_row<NP, WV>(weight, lane, wt);
      load_row<NP, WV>(bias, lane, bi);
    }
  }

  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long r = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5); r < rows;
       r += stride) {
    const size_t at = static_cast<size_t>(r) * (D / C::PER_WORD);
    uint32_t xw[NW], yw[NG];
    load_row<NW, WV>(x + at, lane, xw);
    if constexpr (RES) load_row<NG, WV>(y + at, lane, yw);
    if constexpr (RES && !KEEP) load_gamma<T, NG, WV>(gamma, lane, g);

    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[e] = C::get(xw, e);
      if constexpr (RES)
        v[e] = C::round(__fadd_rn(v[e], C::round(__fmul_rn(C::get(yw, e), C::get(g, e)))));
    }
    if constexpr (RES) {
#pragma unroll
      for (int i = 0; i < NW; ++i) C::put(xw, v, i);
      store_row<NW, WV>(out_x + at, lane, xw);
    }
    if constexpr (NORMED) {
      if constexpr (!KEEP) {
        load_row<NP, WV>(weight, lane, wt);
        load_row<NP, WV>(bias, lane, bi);
      }
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[e];
      const float mean = warp_sum(s) / D;
      float q = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[e] - mean;
        q += d * d;
      }
      const float rstd = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = (v[e] - mean) * rstd * C::get(wt, e) + C::get(bi, e);
      uint32_t nw[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) C::put(nw, v, i);
      store_row<NW, WV>(out_n + at, lane, nw);
    }
  }
}

// sms x resident blocks an SM of `device` for one instantiation: read from
// the runtime at its first launch on the device, kept for every later one
// (0: not read yet; a race reads the same value twice)
template <typename T, int E, int MODE>
cudaError_t resident_blocks(int device, long long* resident) {
  static std::atomic<long long> cache[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  long long got = cache[device].load(std::memory_order_relaxed);
  if (got == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, residual_norm_kernel<T, E, MODE>, THREADS, 0);
    if (err != cudaSuccess) return err;
    got = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    cache[device].store(got, std::memory_order_relaxed);
  }
  *resident = got;
  return cudaSuccess;
}

struct Args {
  const void *x, *y, *gamma, *weight, *bias;
  void *out_x, *out_n;
  long long rows;
  float eps;
  int device;
  cudaStream_t stream;
};

// Makes `device` current for a launch and gives the caller's device back.
struct DeviceGuard {
  int prev = -1, err = 0;
  bool switched = false;
  explicit DeviceGuard(int device) {
    err = static_cast<int>(cudaGetDevice(&prev));
    if (err == 0 && prev != device) {
      err = static_cast<int>(cudaSetDevice(device));
      switched = err == 0;
    }
  }
  ~DeviceGuard() {
    if (switched) cudaSetDevice(prev);
  }
};

template <typename T, int E, int MODE>
int launch(const Args& a) {
  long long resident = 0;
  const cudaError_t err = resident_blocks<T, E, MODE>(a.device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (a.rows + WARPS - 1) / WARPS;
  const int grid = static_cast<int>(blocks < resident ? blocks : resident);
  residual_norm_kernel<T, E, MODE><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const uint32_t*>(a.x), static_cast<const uint32_t*>(a.y),
      static_cast<const uint32_t*>(a.gamma), static_cast<const uint32_t*>(a.weight),
      static_cast<const uint32_t*>(a.bias), static_cast<uint32_t*>(a.out_x),
      static_cast<uint32_t*>(a.out_n), a.rows, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch_mode(int mode, const Args& a) {
  if (mode == NORM) return launch<T, E, NORM>(a);
  if (mode == RESIDUAL) return launch<T, E, RESIDUAL>(a);
  return launch<T, E, RESIDUAL_NORM>(a);
}

template <typename T>
int launch_width(int width, int mode, const Args& a) {
  switch (width) {
#define DEPTHG_WIDTH(D) \
  case D:               \
    return launch_mode<T, D / 32>(mode, a);
    DEPTHG_WIDTH(64) DEPTHG_WIDTH(128) DEPTHG_WIDTH(192) DEPTHG_WIDTH(256)
    DEPTHG_WIDTH(320) DEPTHG_WIDTH(384) DEPTHG_WIDTH(448) DEPTHG_WIDTH(512)
    DEPTHG_WIDTH(576) DEPTHG_WIDTH(640) DEPTHG_WIDTH(704) DEPTHG_WIDTH(768)
    DEPTHG_WIDTH(832) DEPTHG_WIDTH(896) DEPTHG_WIDTH(960) DEPTHG_WIDTH(1024)
    DEPTHG_WIDTH(1088) DEPTHG_WIDTH(1152) DEPTHG_WIDTH(1216) DEPTHG_WIDTH(1280)
    DEPTHG_WIDTH(1344) DEPTHG_WIDTH(1408) DEPTHG_WIDTH(1472) DEPTHG_WIDTH(1536)
    DEPTHG_WIDTH(1600) DEPTHG_WIDTH(1664) DEPTHG_WIDTH(1728) DEPTHG_WIDTH(1792)
    DEPTHG_WIDTH(1856) DEPTHG_WIDTH(1920) DEPTHG_WIDTH(1984) DEPTHG_WIDTH(2048)
#undef DEPTHG_WIDTH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (and y, out_x, out_n where given): [rows, width] row-major; gamma,
// weight, bias: [width]; every pointer 16-byte aligned, on `device`, whose
// `stream` takes the launch. y null: the norm of x alone (out_n). weight
// null: the residual alone (out_x). Otherwise both. gamma null: x + y.
// width a multiple of 64 up to 2,048; dtype 0: bf16, 1: float32. Returns a
// cudaError_t.
extern "C" int depthg_residual_norm(const void* x, const void* y, const void* gamma,
                                    const void* weight, const void* bias, void* out_x,
                                    void* out_n, long long rows, int width, float eps,
                                    int dtype, int device, void* stream) {
  const int mode = y == nullptr ? NORM : weight == nullptr ? RESIDUAL : RESIDUAL_NORM;
  if (rows < 1 || x == nullptr ||
      (mode == NORM && (weight == nullptr || bias == nullptr || out_n == nullptr)) ||
      (mode == RESIDUAL_NORM && (bias == nullptr || out_n == nullptr)) ||
      (mode != NORM && out_x == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, y, gamma, weight, bias, out_x, out_n, rows, eps, device,
               static_cast<cudaStream_t>(stream)};
  const DeviceGuard guard(device);
  if (guard.err != 0) return guard.err;
  if (dtype == 0) return launch_width<__nv_bfloat16>(width, mode, a);
  if (dtype == 1) return launch_width<float>(width, mode, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
