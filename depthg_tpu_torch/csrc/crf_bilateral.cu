// Streaming bilateral message of the dense CRF for Hopper (sm_90a).
//
// Replaces the TPU kernel depthg_tpu/ops/crf_pallas.py bilateral_message_pallas
// (_kernel), the fused form of depthg_tpu/ops/crf.py _bilateral_message:
//     out[b, i, :] = sum_j k_ij z[b, j, :],  k_ij = exp(-|f_i - f_j|^2 / 2)
// over N points with 5 features (x, y, r, g, b) already divided by their
// sigmas. The kernel matrix is never stored: each entry is computed,
// exponentiated and multiplied into the values on chip.
//
// What bounds it: per image N^2 kernel entries (1.05e10 at N=102,400), each
// 5 subtractions, 5 FMAs and one exp on the CUDA cores, against N x C values
// of a few MB that stay in L2. So it is bound by the FP32 pipe and the MUFU
// (exp) rate, not by HBM. The value product is cheap next to that and runs
// on tensor cores in the bf16 kernel.
//
// Design: one block owns a tile of query rows of one image (grid: row tile x
// channel chunk x image, so one launch covers the batch) and keeps their
// features in registers; it streams 64-key tiles of features and values
// through shared memory. Both entries take feats [B, N, 5] and values
// [B, N, C] through their strides (last axis contiguous).
//   * Log-kernel: -|f_i - f_j|^2 / 2 in fp32, computed directly (5 subtractions
//     and 5 FMAs). The TPU kernel's augmented depth-7 matmul
//     a.b - |a|^2/2 - |b|^2/2 cancels terms of ~2e4 (rgb/3 ~ 85) and leaves
//     ~1e-3 of noise per entry; the direct form has no cancellation.
//   * bf16 values: four warps of 16 query rows each. Every thread computes
//     the kernel entries at exactly the positions it holds in the A fragment
//     of mma.sync m16n8k16, so P goes from the CUDA cores to the tensor cores
//     without shared memory; P is rounded to bf16 only as that operand and
//     the product accumulates in fp32 (the TPU kernel's value dot_general at
//     default precision). The exp is ex2.approx.ftz (MUFU): ~2^-22 relative
//     error, results below 2^-126 flushed to 0, both far below the bf16
//     rounding of P that follows.
//     The entry first packs the operands (pack_bf16_kernel, a shared-memory
//     transpose) into a workspace the caller allocates with the size
//     depthg_bilateral_workspace_bytes gives: features [B, 5, NP] times
//     sqrt(log2(e) / 2), so an entry is ex2(-|f_i - f_j|^2) with the
//     negation riding on the FMA and no multiply left, and values
//     [B, chunks * CP, NP], both channel-major, NP = N rounded up to the key
//     tile. Every tile is then whole 16-byte rows, copied with cp.async into
//     a second shared buffer while the block computes on the first. (A
//     version that read [B, N, C] in place, through registers, took 1.7-2.5x
//     as long on an H100: rows of C = 54 halves allow no 16-byte copies,
//     and C = 27 no 4-byte ones.) The value tile is
//     stored [channel][key] with a row stride of 72 halves (36 words), so
//     each B fragment is one conflict-free 32-bit load.
//   * f32 values (the parity mode): one thread per query row, accurate expf
//     of -d / 2, an FMA loop over the channels; features and values are read
//     in place and from shared memory as broadcasts.
//   * Channels are padded to the mma width (8) in shared memory (f32) or in
//     the packed copy (bf16): padded channels are zero and never written
//     out. More than 64 channels take further chunks along grid.y (each
//     recomputes the kernel entries; the CRF's largest C is 54).
//   * Ragged edge: the pack step writes zero features and values for keys
//     j >= n, so their term in the bf16 kernel is exactly 0 * P = 0; the f32
//     kernel masks its last tile and never visits them; query rows i >= n
//     compute on zero features and are not written. Nothing past n of the
//     caller's tensors is read.
// What bounds it, per entry: ~10 fp32 operations at 128 per clock per SM
// against one MUFU ex2 at 16 per clock, so the FP32 pipe, then the exp.
// Later work: the kernel's symmetry (half the exps, needs a second pass or
// atomics), wgmma + TMA, more query rows per warp (each key feature load
// serves only two rows now).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NF = 5;          // features per point
constexpr int BQ = 64;         // query rows per block, bf16 kernel (16 per warp)
constexpr int BK = 64;         // keys per tile
constexpr int LDZ = BK + 8;    // padded key stride of the transposed value tile
constexpr int F_BQ = 128;      // query rows per block, f32 kernel (1 per thread)
constexpr int PT = 32;         // keys and channels of one pack-kernel tile
constexpr int MAX_C = PT * 65535;  // channels the pack kernel's grid.y covers
// the bf16 kernel's entry is ex2(-|s f_i - s f_j|^2) = exp(-|f_i - f_j|^2 / 2)
constexpr float EX2_SCALE = 0.84932180028801907f;  // sqrt(log2(e) / 2)

struct Strides {
  long long b, n;  // element strides of image and point; the last axis is contiguous
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// features of keys k0 .. k0+BK-1 into sF[feature][key] (zeros past n)
__device__ __forceinline__ void load_key_feats(float (&sF)[NF][BK], const float* fb,
                                               Strides sf, int k0, int n) {
  for (int i = threadIdx.x; i < NF * BK; i += blockDim.x) {
    const int j = i / NF, f = i - j * NF;
    sF[f][j] = (k0 + j < n) ? fb[(k0 + j) * sf.n + f] : 0.f;
  }
}

// the bf16 kernel's operands: NP keys (N rounded up to BK), chunks of CP
// channels (CP = 8 min(8, ceil(C / 8)))
struct Packed {
  int np, cp, cpad;  // cpad = chunks * CP
  long long feat_bytes, bytes;
};

Packed packed_layout(int batch, int n, int c) {
  Packed p;
  p.np = (n + BK - 1) / BK * BK;
  p.cp = 8 * min(8, (c + 7) / 8);
  p.cpad = (c + p.cp - 1) / p.cp * p.cp;
  p.feat_bytes = static_cast<long long>(batch) * NF * p.np * sizeof(float);
  p.bytes = p.feat_bytes + static_cast<long long>(batch) * p.cpad * p.np * 2;
  return p;
}

// [B, N, 5] / [B, N, C] -> ft [B, 5, np] times EX2_SCALE and zt [B, cpad, np],
// zero past n and c. Block (32, 8) transposes a 32-key x 32-channel tile
// through shared memory; the blocks of the first channel tile also write
// the features of their keys.
__global__ void __launch_bounds__(256)
pack_bf16_kernel(const float* __restrict__ feats, const unsigned short* __restrict__ z,
                 float* __restrict__ ft, unsigned short* __restrict__ zt, Strides sf,
                 Strides sz, int n, int c, int np, int cpad) {
  __shared__ unsigned short tile[PT][PT + 1];
  const int b = blockIdx.z, k0 = blockIdx.x * PT, ch0 = blockIdx.y * PT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < PT; i += 8) {  // read along channels
    const int key = k0 + i, ch = ch0 + tx;
    tile[i][tx] = (key < n && ch < c) ? z[b * sz.b + key * sz.n + ch] : 0;
  }
  __syncthreads();
  for (int i = ty; i < PT; i += 8) {  // write along keys
    const int ch = ch0 + i;
    if (ch < cpad)
      zt[(static_cast<long long>(b) * cpad + ch) * np + k0 + tx] = tile[tx][i];
  }
  if (blockIdx.y == 0)
    for (int f = ty; f < NF; f += 8) {
      const int key = k0 + tx;
      ft[(static_cast<long long>(b) * NF + f) * np + key] =
          key < n ? feats[b * sf.b + key * sf.n + f] * EX2_SCALE : 0.f;
    }
}

// NT n-tiles of 8 channels (CP = 8 NT channels per block). ft: [B, NF, np]
// scaled features, zt: [B, chunks * CP, np] values, as pack_bf16_kernel
// writes them.
template <int NT>
__global__ void __launch_bounds__(128)
bilateral_bf16_kernel(const float* __restrict__ ft,
                      const __nv_bfloat16* __restrict__ zt,
                      __nv_bfloat16* __restrict__ out, long long zt_b, int np,
                      Strides so, int n, int c) {
  constexpr int CP = NT * 8;
  constexpr int F_CHUNKS = NF * BK / 4;  // 16-byte pieces of a feature tile
  constexpr int Z_CHUNKS = CP * BK / 8;  // 16-byte pieces of a value tile
  __shared__ __align__(16) float sF[2][NF][BK];
  __shared__ __align__(16) __nv_bfloat16 sZ[2][CP][LDZ];  // [channel][key]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int b = blockIdx.z, c0 = blockIdx.y * CP;
  const int cc = min(CP, c - c0);  // real channels of this chunk
  const float* fb = ft + b * (long long)NF * np;
  const __nv_bfloat16* zb = zt + b * zt_b + c0 * (long long)np;
  const int row0 = blockIdx.x * BQ + warp * 16 + g;  // rows row0 and row0 + 8 (< np)

  float fq[2][NF];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int f = 0; f < NF; ++f) fq[r][f] = fb[f * (long long)np + row0 + r * 8];

  // one commit group per tile: its features and values, into buffer `buf`
  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * BK;
    for (int i = tid; i < F_CHUNKS + Z_CHUNKS; i += blockDim.x) {
      if (i < F_CHUNKS) {
        const int f = i / (BK / 4), part = (i % (BK / 4)) * 4;
        cp_async16(&sF[buf][f][part], fb + f * (long long)np + k0 + part);
      } else {
        const int j = i - F_CHUNKS, ch = j / (BK / 8), part = (j % (BK / 8)) * 8;
        cp_async16(&sZ[buf][ch][part], zb + ch * (long long)np + k0 + part);
      }
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int dn = 0; dn < NT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  const int n_tiles = (n + BK - 1) / BK;
  load_tile(0, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load_tile(kt + 1, buf ^ 1);  // its buffer was released at the end of kt - 1
      cp_async_wait<1>();          // tile kt has landed, kt + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt is visible to every warp

#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A fragment: regs 0/1 = rows g/g+8 at keys ks*16 + 2t + {0,1},
      //             regs 2/3 = the same rows at keys ks*16 + 8 + 2t + {0,1}
      uint32_t pa[4];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int j = ks * 16 + hi * 8 + t * 2;
        float2 fk[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f)
          fk[f] = *reinterpret_cast<const float2*>(&sF[buf][f][j]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float d0 = 0.f, d1 = 0.f;  // -|f_i - f_j|^2 (scaled) for keys j, j + 1
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            const float a0 = fq[r][f] - fk[f].x, a1 = fq[r][f] - fk[f].y;
            d0 = fmaf(-a0, a0, d0);
            d1 = fmaf(-a1, a1, d1);
          }
          pa[hi * 2 + r] = pack_bf16(ex2_approx(d0), ex2_approx(d1));
        }
      }
#pragma unroll
      for (int dn = 0; dn < NT; ++dn) {
        const int ch = dn * 8 + g, j = ks * 16 + t * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sZ[buf][ch][j]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&sZ[buf][ch][j + 8]);
        mma_bf16(acc[dn], pa, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  // C fragment: acc[dn][0..1] = row g, channels dn*8 + 2t + {0,1}; [2..3] = row g+8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= n) continue;
    __nv_bfloat16* orow = out + b * so.b + row * so.n + c0;
#pragma unroll
    for (int dn = 0; dn < NT; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = dn * 8 + t * 2 + e;
        if (ch < cc) orow[ch] = __float2bfloat16_rn(acc[dn][2 * r + e]);
      }
  }
}

template <int NT>
__global__ void __launch_bounds__(F_BQ)
bilateral_f32_kernel(const float* __restrict__ feats, const float* __restrict__ z,
                     float* __restrict__ out, Strides sf, Strides sz, Strides so,
                     int n, int c) {
  constexpr int CP = NT * 8;
  __shared__ float sF[NF][BK];
  __shared__ __align__(16) float sZ[BK][CP];  // [key][channel]

  const int row = blockIdx.x * F_BQ + threadIdx.x;
  const int b = blockIdx.z, c0 = blockIdx.y * CP;
  const int cc = min(CP, c - c0);
  const float* fb = feats + b * sf.b;
  const float* zb = z + b * sz.b + c0;

  float fq[NF], acc[CP];
#pragma unroll
  for (int f = 0; f < NF; ++f) fq[f] = row < n ? fb[row * sf.n + f] : 0.f;
#pragma unroll
  for (int ch = 0; ch < CP; ++ch) acc[ch] = 0.f;

  const int n_tiles = (n + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_key_feats(sF, fb, sf, k0, n);
    for (int i = threadIdx.x; i < BK * CP; i += blockDim.x) {
      const int j = i / CP, ch = i - j * CP;
      sZ[j][ch] = (k0 + j < n && ch < cc) ? zb[(k0 + j) * sz.n + ch] : 0.f;
    }
    __syncthreads();
    const int kn = min(BK, n - k0);  // keys past n are not visited
    for (int j = 0; j < kn; ++j) {
      float d = 0.f;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float diff = fq[f] - sF[f][j];
        d = fmaf(diff, diff, d);
      }
      const float p = expf(-0.5f * d);
#pragma unroll
      for (int ch = 0; ch < CP; ch += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&sZ[j][ch]);
        acc[ch] = fmaf(p, v.x, acc[ch]);
        acc[ch + 1] = fmaf(p, v.y, acc[ch + 1]);
        acc[ch + 2] = fmaf(p, v.z, acc[ch + 2]);
        acc[ch + 3] = fmaf(p, v.w, acc[ch + 3]);
      }
    }
  }
  if (row >= n) return;
  float* orow = out + b * so.b + row * so.n + c0;
#pragma unroll
  for (int ch = 0; ch < CP; ++ch)
    if (ch < cc) orow[ch] = acc[ch];
}

template <int NT>
void launch_bf16(const float* ft, const __nv_bfloat16* zt, __nv_bfloat16* out,
                 const Packed& p, Strides so, int batch, int n, int c, cudaStream_t st) {
  const dim3 grid(p.np / BQ, p.cpad / p.cp, batch);
  bilateral_bf16_kernel<NT><<<grid, 128, 0, st>>>(
      ft, zt, out, static_cast<long long>(p.cpad) * p.np, p.np, so, n, c);
}

template <int NT>
void launch_f32(const float* feats, const float* z, float* out, Strides sf,
                Strides sz, Strides so, int batch, int n, int c, cudaStream_t st) {
  const dim3 grid((n + F_BQ - 1) / F_BQ, (c + NT * 8 - 1) / (NT * 8), batch);
  bilateral_f32_kernel<NT><<<grid, F_BQ, 0, st>>>(feats, z, out, sf, sz, so, n, c);
}

// NT = min(8, ceil(c / 8)): the channel chunk CP = 8 NT
#define DEPTHG_DISPATCH_NT(c, LAUNCH, ...) \
  switch (min(8, ((c) + 7) / 8)) {        \
    case 1: LAUNCH<1>(__VA_ARGS__); break; \
    case 2: LAUNCH<2>(__VA_ARGS__); break; \
    case 3: LAUNCH<3>(__VA_ARGS__); break; \
    case 4: LAUNCH<4>(__VA_ARGS__); break; \
    case 5: LAUNCH<5>(__VA_ARGS__); break; \
    case 6: LAUNCH<6>(__VA_ARGS__); break; \
    case 7: LAUNCH<7>(__VA_ARGS__); break; \
    default: LAUNCH<8>(__VA_ARGS__); break; \
  }

}  // namespace

// Both entries take feats [B, N, 5] float32 and values / out [B, N, C] in
// one dtype (bf16 or float32), with element strides (x_sb, x_sn) of image
// and point and a contiguous last axis, and launch on `stream`. The bf16
// entry also takes a device workspace of depthg_bilateral_workspace_bytes
// (0 for float32). They return cudaErrorInvalidValue for a shape the grid
// cannot cover, else cudaGetLastError() (0 = launched). Dtypes, devices and
// the contiguous last axis are validated by the Python wrapper
// (depthg_tpu_torch/ops/crf_bilateral.py).
static bool bad_shape(int batch, int n, int c) {
  return batch < 1 || batch > 65535 || n < 1 || n > 2147483647 - F_BQ || c < 1 ||
         c > MAX_C;
}

extern "C" long long depthg_bilateral_workspace_bytes(int batch, int n, int c,
                                                      int bf16) {
  return bf16 && !bad_shape(batch, n, c) ? packed_layout(batch, n, c).bytes : 0;
}

extern "C" int depthg_bilateral_message_bf16(
    const void* feats, const void* z, void* out, void* workspace, long long f_sb,
    long long f_sn, long long z_sb, long long z_sn, long long o_sb, long long o_sn,
    int batch, int n, int c, void* stream) {
  if (bad_shape(batch, n, c)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sf{f_sb, f_sn}, sz{z_sb, z_sn}, so{o_sb, o_sn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Packed p = packed_layout(batch, n, c);
  float* ft = static_cast<float*>(workspace);
  unsigned short* zt = reinterpret_cast<unsigned short*>(
      static_cast<char*>(workspace) + p.feat_bytes);
  pack_bf16_kernel<<<dim3(p.np / PT, (p.cpad + PT - 1) / PT, batch), dim3(PT, 8), 0, st>>>(
      static_cast<const float*>(feats), static_cast<const unsigned short*>(z), ft, zt,
      sf, sz, n, c, p.np, p.cpad);
  DEPTHG_DISPATCH_NT(c, launch_bf16, ft, reinterpret_cast<const __nv_bfloat16*>(zt),
                     static_cast<__nv_bfloat16*>(out), p, so, batch, n, c, st)
  return static_cast<int>(cudaGetLastError());
}

extern "C" int depthg_bilateral_message_f32(
    const void* feats, const void* z, void* out, void* /*workspace*/, long long f_sb,
    long long f_sn, long long z_sb, long long z_sn, long long o_sb, long long o_sn,
    int batch, int n, int c, void* stream) {
  if (bad_shape(batch, n, c)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sf{f_sb, f_sn}, sz{z_sb, z_sn}, so{o_sb, o_sn};
  DEPTHG_DISPATCH_NT(c, launch_f32, static_cast<const float*>(feats),
                     static_cast<const float*>(z), static_cast<float*>(out), sf, sz, so,
                     batch, n, c, static_cast<cudaStream_t>(stream))
  return static_cast<int>(cudaGetLastError());
}
