// Masked non-causal softmax attention for Hopper (sm_90a), head_dim 64.
//
// Replaces three TPU kernels of depthg_tpu, which all compute
//     o = softmax(q k^T * scale) v   with keys j >= n_valid weighted 0
// and query rows i >= n_valid written as exact zeros:
//   * ops/attention.py whole_kv_mha_qkv (_whole_kv_pair_kernel, _attend):
//     packed [B, N, 3D] qkv in, token-major [B, N, D] out;
//   * ops/attention.py whole_kv_mha (_whole_kv_kernel): split [B, H, N, HD];
//   * models/vit.py _flash_mha (the Pallas TPU flash kernel, segment ids).
// Every operand is addressed through (batch, head, token) strides with a
// contiguous head_dim, so the packed and the split layouts are both views.
//
// What bounds it: at the ViT-S/8 eval shape (B=16, N=1601, 6 heads) one
// call is ~63 GFLOP of q.k and p.v products over ~30 MB of q/k/v, so it is
// bound by tensor-core issue, not memory. The TPU kernel kept the whole K/V
// resident in VMEM; K+V of one head at N=1601 in bf16 is ~410 KB, more
// than the 227 KB of shared memory a block can have, so this is a KV-blocked
// online-softmax (flash) loop instead: one block owns 64 query rows of one
// (batch, head), keeps them in registers as mma.sync A fragments, and walks
// 64-key K/V tiles staged in padded shared memory (no bank conflicts on the
// fragment loads). Logits, running max/sum and the output accumulate in
// fp32; P is rounded to bf16 only as the A operand of the p.v product, as
// the TPU kernel does. The ragged last tile is masked here (no padding of
// N to 128 is needed): keys past n_valid are zero-filled in shared memory
// and their logits set to -inf, so their weight is exactly 0.
// The float32 variant is a plain FMA kernel (one thread per query row):
// tensor cores would round the operands, and float32 is the parity mode.
// Later work: wgmma + TMA with a producer warp, cp.async double buffering.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;       // head dim
constexpr int BQ = 64;       // query rows per block, bf16 kernel (16 per warp)
constexpr int BK = 64;       // keys per tile
constexpr int LDS = HD + 8;  // padded shared row: 144 B, conflict-free fragments
constexpr int F_BQ = 128;    // query rows per block, f32 kernel (1 per thread)
constexpr int F_CH = 16;     // keys per online-softmax step, f32 kernel
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, n;  // element strides of batch, head, token
};

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

__global__ void __launch_bounds__(128)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, Strides sq, Strides sk,
                 Strides sv, Strides so, int n, int n_valid, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ][LDS];
  __shared__ __align__(16) __nv_bfloat16 sK[BK][LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[BK][LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;

  // q * scale in f32, rounded back to bf16 (the TPU kernel's contract);
  // padded query rows load as zeros and are written as zeros below
  for (int c = tid; c < BQ * (HD / 8); c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8, row = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_valid) {
      val = *reinterpret_cast<const uint4*>(qb + row * sq.n + col);
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        p[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(&sQ[r][col]) = val;
  }
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qa[4][4];  // [k-step over head_dim][A fragment register]
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + t * 2;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(&sQ[r0 + g][c]);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(&sQ[r0 + g + 8][c]);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(&sQ[r0 + g][c + 8]);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(&sQ[r0 + g + 8][c + 8]);
  }

  float m_i[2] = {-INFINITY, -INFINITY};  // running max (log2 domain), rows g, g+8
  float l_i[2] = {0.f, 0.f};              // running sum
  float acc[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  const unsigned short* sv16 = reinterpret_cast<const unsigned short*>(&sV[0][0]);
  const int n_tiles = (n_valid + BK - 1) / BK;  // tiles past n_valid weigh 0
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < BK * (HD / 8); c += blockDim.x) {
      const int r = c >> 3, col = (c & 7) * 8, row = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (row < n_valid) {
        kv = *reinterpret_cast<const uint4*>(kb + row * sk.n + col);
        vv = *reinterpret_cast<const uint4*>(vb + row * sv.n + col);
      }
      *reinterpret_cast<uint4*>(&sK[r][col]) = kv;
      *reinterpret_cast<uint4*>(&sV[r][col]) = vv;
    }
    __syncthreads();

    // s = q k^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int c = ks * 16 + t * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sK[nt * 8 + g][c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&sK[nt * 8 + g][c + 8]);
        mma_bf16(s[nt], qa[ks], b0, b1);
      }
    }
    const bool edge = k0 + BK > n_valid;
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * LOG2E;
        if (edge && k0 + nt * 8 + t * 2 + (e & 1) >= n_valid) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // key 0 is valid (n_valid >= 1), so mx is finite from the first tile on
    const float alpha[2] = {exp2f(m_i[0] - mx[0]), exp2f(m_i[1] - mx[1])};

    float rs[2] = {0.f, 0.f};
    uint32_t pa[4][4];  // P as A fragments: [k-step over keys][register]
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - mx[0]), p1 = exp2f(s[nt][1] - mx[0]);
      const float p2 = exp2f(s[nt][2] - mx[1]), p3 = exp2f(s[nt][3] - mx[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      const int ks = nt >> 1, hi = (nt & 1) * 2;
      pa[ks][hi] = pack_bf16(p0, p1);
      pa[ks][hi + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_i[r] = l_i[r] * alpha[r] + rs[r];
      m_i[r] = mx[r];
    }
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    // o += p v: B[key][dim] fragments gathered as bf16 pairs along keys
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      const int col = dn * 8 + g;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int key = ks * 16 + t * 2;
        const uint32_t b0 = uint32_t(sv16[key * LDS + col]) |
                            (uint32_t(sv16[(key + 1) * LDS + col]) << 16);
        const uint32_t b1 = uint32_t(sv16[(key + 8) * LDS + col]) |
                            (uint32_t(sv16[(key + 9) * LDS + col]) << 16);
        mma_bf16(acc[dn], pa[ks], b0, b1);
      }
    }
  }

  // normalize on the output (row sum clamped at 1e-30); padded rows -> 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + r * 8;
    if (row >= n) continue;
    const bool valid = row < n_valid;
    const float inv = 1.f / fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      const uint32_t val = valid ? pack_bf16(acc[dn][2 * r] * inv,
                                             acc[dn][2 * r + 1] * inv)
                                 : 0u;
      *reinterpret_cast<uint32_t*>(ob + row * so.n + dn * 8 + t * 2) = val;
    }
  }
}

__global__ void __launch_bounds__(F_BQ)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                Strides sq, Strides sk, Strides sv, Strides so, int n,
                int n_valid, float scale) {
  __shared__ __align__(16) float sK[BK][HD];
  __shared__ __align__(16) float sV[BK][HD];

  const int row = blockIdx.x * F_BQ + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const bool valid = row < n_valid;

  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid)
      x = *reinterpret_cast<const float4*>(q + b * sq.b + h * sq.h + row * sq.n + d);
    qr[d] = x.x * scale;
    qr[d + 1] = x.y * scale;
    qr[d + 2] = x.z * scale;
    qr[d + 3] = x.w * scale;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int n_tiles = (n_valid + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int c = threadIdx.x; c < BK * (HD / 4); c += blockDim.x) {
      const int r = c / (HD / 4), col = (c % (HD / 4)) * 4, key = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < n_valid) {
        kv = *reinterpret_cast<const float4*>(kb + key * sk.n + col);
        vv = *reinterpret_cast<const float4*>(vb + key * sv.n + col);
      }
      *reinterpret_cast<float4*>(&sK[r][col]) = kv;
      *reinterpret_cast<float4*>(&sV[r][col]) = vv;
    }
    __syncthreads();
    for (int c0 = 0; c0 < BK; c0 += F_CH) {
      float s[F_CH];
      float mx = m;
#pragma unroll
      for (int j = 0; j < F_CH; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&sK[c0 + j][d]);
          dot = fmaf(qr[d], kk.x, dot);
          dot = fmaf(qr[d + 1], kk.y, dot);
          dot = fmaf(qr[d + 2], kk.z, dot);
          dot = fmaf(qr[d + 3], kk.w, dot);
        }
        s[j] = (k0 + c0 + j < n_valid) ? dot : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      // the first step holds key 0 (valid), so mx is finite from then on
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < F_CH; ++j) {
        const float p = expf(s[j] - mx);
        l += p;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&sV[c0 + j][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = mx;
    }
  }
  if (row >= n) return;
  const float denom = fmaxf(l, 1e-30f);
  float* orow = o + b * so.b + h * so.h + row * so.n;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 x = valid ? make_float4(acc[d] / denom, acc[d + 1] / denom,
                                         acc[d + 2] / denom, acc[d + 3] / denom)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(orow + d) = x;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). Pointers,
// strides and n_valid are validated by the Python wrapper
// (depthg_tpu_torch/ops/attention.py): head_dim 64, contiguous last axis,
// 16-byte aligned rows, 1 <= n_valid <= n.
extern "C" int depthg_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn,
    long long o_sb, long long o_sh, long long o_sn,
    int batch, int heads, int n, int n_valid, float scale, int is_bf16,
    void* stream) {
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((n + BQ - 1) / BQ, heads, batch);
    attn_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        sq, sk, sv, so, n, n_valid, scale);
  } else {
    const dim3 grid((n + F_BQ - 1) / F_BQ, heads, batch);
    attn_f32_kernel<<<grid, F_BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
        n, n_valid, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
