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
// call is 63 GFLOP of q.k and p.v products and 2.5e8 exponentials over
// ~40 MB of q/k/v/o. On an H100 the tensor cores need 0.064 ms for the
// products at their bf16 peak and the MUFU needs 0.066 ms for the
// exponentials (16 ex2 per clock per SM), HBM 0.012 ms: at head_dim 64
// tensor-core issue and the exponential unit bound it together, so a
// kernel that runs them one after the other cannot pass half the bound.
//
// Design of the bf16 kernel (attn_bf16_wgmma_kernel):
//   * The TPU kernel kept the whole K/V of a head resident in VMEM. K+V of
//     one head at N=1601 is ~410 KB, more than the 227 KB of shared memory
//     a block can have, so this is a KV-blocked online-softmax loop: a block
//     owns 256 query rows of one (batch, head) and walks 128-key tiles.
//   * TMA: the host entry encodes one 4-d tensor map (dim, token, head,
//     batch; 128-byte swizzle; box 64 dims x 128 tokens for K and V, x 64
//     tokens for Q) per operand from the pointer and strides it is given,
//     with the token extent set to n_valid, so rows past n_valid arrive as
//     zeros whatever the memory holds and the ragged last tile needs no
//     padded copy. One producer warp (its warpgroup's registers cut to 24
//     with setmaxnreg) keeps a ring of 4 K/V stages (32 KB each) in flight;
//     full/empty mbarriers per stage, K and V signalled apart so q.k^T can
//     start before V lands.
//   * wgmma: two consumer warpgroups (240 registers), each owning two
//     sub-tiles of 64 query rows. A step is one (key tile, sub-tile) pair.
//     S = Q K^T is 4 x wgmma.m64n128k16 with K from shared memory (K-major,
//     128-byte swizzle) and Q from registers: each warp reads its rows of
//     the Q tile once, multiplies by `scale` in fp32 and rounds back to bf16
//     (the TPU kernel's contract, unchanged), which also keeps Q's
//     shared-memory traffic out of the loop. P stays in registers (the
//     accumulator layout of S is the A layout of the next product, packed
//     to bf16) and O += P V is 8 x wgmma.m64n64k16 with V from shared
//     memory through the transposing (MN-major) descriptor, so V is never
//     transposed. Logits, running max/sum and O accumulate in fp32; P is
//     rounded to bf16 only as that A operand.
//   * Softmax overlapped with the tensor cores: the consumer warpgroups
//     take turns through named barriers. A warpgroup issues O += P V of its
//     step and S of its next step as one batch, hands the turn over and
//     then runs its ex2s, max/sum and the rescale of O while the other
//     warpgroup's batch occupies the tensor cores.
//   * 256 rows per block, not 128: every block streams the whole K/V of its
//     head from L2, so rows per block set that traffic. With one sub-tile
//     per warpgroup (128 rows, 1248 blocks) the kernel took 0.188-0.204 ms
//     on an H100, with two (672 blocks) 0.161 ms. Three consumer warpgroups
//     of one sub-tile each (192 rows) took 0.213 ms: the registers left per
//     thread (128 at 512 threads) no longer hold S, P and O without spills.
//   * Masking: logits of keys >= n_valid are set to -inf in registers on
//     the last tile (their V rows are zeros from the TMA fill, so 0 * 0);
//     query rows >= n_valid are written as zeros. The output goes through
//     the warp's own 16 rows of the (now free) Q tile and leaves as 16-byte
//     plain stores; no TMA store touches the edge. Where the block's second
//     128 rows hold no valid row, both warpgroups walk one sub-tile only.
//   * Grid (ceil(N / 256), heads, batch) = 7 x 6 x 16 = 672 blocks at the
//     eval shape, the seventh of each head half as long (65 rows). A block
//     takes 161 KB of shared memory and 63 K registers, so one fits per SM:
//     4.7 blocks of work per SM in 5.1 waves, and each block's prologue
//     (barrier init, Q and first K in flight) is exposed.
//   * What holds it (timed on an H100 with parts of the loop compiled out):
//     the loads alone take 0.046 ms, both products without the softmax
//     0.096 ms, the softmax without the products 0.119 ms (0.086 ms without
//     its ex2s), everything 0.161 ms: the softmax's ~5 issue slots per logit
//     (max, scale-subtract FMA, ex2, row sum, half a bf16x2 pack, the
//     rescale of O) beside the 8 clocks a warp's ex2 holds the MUFU are the
//     largest part, and a warpgroup's own softmax and products still run
//     one after the other. Later work: a second S accumulator so a
//     warpgroup overlaps with itself, the row sum taken from the P V product
//     (a ones column in V), a persistent block per SM, and an optional
//     [H, N, N] logit bias added to S before the max (BEiT).
// The float32 variant is a plain FMA kernel (one thread per query row):
// tensor cores would round the operands, and float32 is the parity mode.

#include <cuda.h>  // CUtensorMap types only; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;       // head dim
constexpr int BK = 64;       // keys per tile, f32 kernel
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


// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, one producer warp and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int NCW = 2;                   // consumer warpgroups per block
constexpr int SUBS = 2;                  // 64-row sub-tiles per consumer warpgroup
constexpr int CONSUMER_REGS = 240;       // (64 K - 128 x 24) / (128 NCW), in 8s
constexpr int WQ = 64 * NCW * SUBS;      // query rows per block
constexpr int WK = 128;                  // keys per tile
constexpr int STAGES = 4;                // K/V tiles in flight
constexpr int TILE_BYTES = WK * HD * 2;  // one K or V tile: 16 KB, 128-byte rows
constexpr int SUB_BYTES = 64 * HD * 2;   // one 64-row Q sub-tile: 8 KB
constexpr int W_THREADS = 128 * (NCW + 1);  // consumers first, then the producer warpgroup
// 1 KB of slack to align the tiles to the swizzle period, the tiles, the barriers
constexpr int W_SMEM = 1024 + SUB_BYTES * NCW * SUBS + TILE_BYTES * 2 * STAGES + 128;
constexpr int BAR_TURN = 1;              // named barriers BAR_TURN + consumer index

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spins until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box (128 tokens x 64 dims of K or V, 64 x 64 of Q) at (token row0, head h, image b)
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row0), "r"(h), "r"(b)
      : "memory");
}

__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle, 8-row groups 1024 B apart
// (the leading-dimension offset is not used by these tile shapes)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

#define D8(b)                                                                          \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),          \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d[64 rows x 128 keys] (+)= a[64 x 16 dims, registers] . K tile (K-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d[64 rows x 64 dims] += a[64 x 16 keys, registers] . V tile (MN-major: transposed by the descriptor)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#undef D8

// One consumer warpgroup's whole life: U sub-tiles of 64 query rows (rows
// (NCW u + cw) * 64 of the block's Q tile), each walked over every K/V tile.
// A step is one (tile, sub-tile) pair; the warpgroups take turns per step,
// round robin.
template <int U>
__device__ __forceinline__ void consume(uint8_t* smem, uint32_t s_k, uint32_t s_v, uint32_t bar_q,
                                        uint32_t bar_k, uint32_t bar_v, uint32_t bar_e,
                                        __nv_bfloat16* __restrict__ ob, long long o_sn, int q0,
                                        int n, int n_valid, int n_tiles, float scale) {
  const int tid = threadIdx.x;
  const int cw = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group / column pair
  const int my_turn = BAR_TURN + cw, other_turn = BAR_TURN + (cw + 1) % NCW;

  // Q as A fragments: q * scale in f32, rounded back to bf16 (the TPU
  // kernel's contract). Rows past n_valid arrived as zeros.
  mbar_wait(bar_q, 0);
  uint32_t qa[U][4][4];  // [sub-tile][k-step over head_dim][A fragment register]
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = (NCW * u + cw) * 64 + warp * 16 + g + (i & 1) * 8;
        const int col = ks * 16 + t * 2 + (i >> 1) * 8;
        const uint32_t raw = *reinterpret_cast<const uint32_t*>(
            smem + row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2);
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        qa[u][ks][i] = pack_bf16(f.x * scale, f.y * scale);
      }

  float m_i[U][2], l_i[U][2];  // running max of the logits / this thread's share of the sum
  float acc[U][32];            // O: [8 dim chunks][row g: 2 cols, row g+8: 2 cols]
  float s[64];                 // S of the current step: [16 key chunks][the same]
#pragma unroll
  for (int u = 0; u < U; ++u) {
    m_i[u][0] = m_i[u][1] = -INFINITY;
    l_i[u][0] = l_i[u][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
  }

  // the first turn goes to warpgroup 0
  if (cw == NCW - 1) turn_pass(other_turn);
  mbar_wait(bar_k, 0);
  turn_wait(my_turn);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_qk(s, qa[0][ks], smem_desc(s_k) + 2 * ks, ks > 0);
  wgmma_commit();
  turn_pass(other_turn);
  wgmma_wait_all();
  fence_regs(s);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % STAGES, ph = (kt / STAGES) & 1;
    const int st1 = (kt + 1) % STAGES;
    const bool last_tile = kt + 1 == n_tiles;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t pa[8][4];  // P as A fragments: [k-step over keys][register]
      // online softmax of this step, while the other warpgroup's products run
      float mx[2] = {m_i[u][0], m_i[u][1]};
      if (kt * WK + WK > n_valid) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (kt * WK + (i >> 2) * 8 + t * 2 + (i & 1) >= n_valid) s[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2], mlog[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // key 0 is valid (n_valid >= 1), so mx is finite from the first tile on
        alpha[r] = ex2_approx((m_i[u][r] - mx[r]) * LOG2E);
        mlog[r] = mx[r] * LOG2E;
        m_i[u][r] = mx[r];
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) {  // 8-key chunk: regs 0/1 of an even chunk, 2/3 of an odd one
        const float p0 = ex2_approx(fmaf(s[4 * c], LOG2E, -mlog[0]));
        const float p1 = ex2_approx(fmaf(s[4 * c + 1], LOG2E, -mlog[0]));
        const float p2 = ex2_approx(fmaf(s[4 * c + 2], LOG2E, -mlog[1]));
        const float p3 = ex2_approx(fmaf(s[4 * c + 3], LOG2E, -mlog[1]));
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[c >> 1][(c & 1) * 2] = pack_bf16(p0, p1);
        pa[c >> 1][(c & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_i[u][r] = l_i[u][r] * alpha[r] + rs[r];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[u][i] *= alpha[(i >> 1) & 1];

      // one batch for the tensor cores: O += P V of this step, S of the next
      // step (the next sub-tile on this K tile, or sub-tile 0 on the next)
      const bool last_step = last_tile && u + 1 == U;
      mbar_wait(bar_v + 8 * st, ph);
      if (u + 1 == U && !last_tile) mbar_wait(bar_k + 8 * st1, ((kt + 1) / STAGES) & 1);
      turn_wait(my_turn);
      fence_regs(acc[u]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        wgmma_pv(acc[u], pa[ks], smem_desc(s_v + st * TILE_BYTES) + 128 * ks);
      wgmma_commit();
      if (u + 1 < U) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_qk(s, qa[(u + 1) % U][ks], smem_desc(s_k + st * TILE_BYTES) + 2 * ks, ks > 0);
        wgmma_commit();
      } else if (!last_tile) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_qk(s, qa[0][ks], smem_desc(s_k + st1 * TILE_BYTES) + 2 * ks, ks > 0);
        wgmma_commit();
      }
      // the very last turn (last warpgroup, last step) has nobody left to wake
      if (!(last_step && cw == NCW - 1)) turn_pass(other_turn);
      wgmma_wait_all();
      fence_regs(acc[u]);
      fence_regs(s);
      if (u + 1 == U) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_e + 8 * st);  // this warp is done with stage st
      }
    }
  }

  // normalize (row sum clamped at 1e-30); rows past n_valid -> 0. A sub-tile
  // goes through this warp's own 16 rows of the Q buffer (swizzled by row,
  // so neither side has bank conflicts) and leaves as 16-byte stores.
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r0 = (NCW * u + cw) * 64 + warp * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[u][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = r0 + g + r * 8;
      const bool valid = q0 + row < n_valid;
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<uint32_t*>(smem + row * 128 + ((c ^ g) << 4) + t * 4) =
            valid ? pack_bf16(acc[u][4 * c + 2 * r] * inv, acc[u][4 * c + 2 * r + 1] * inv) : 0u;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = i * 32 + lane, row = r0 + (idx >> 3), c = idx & 7;
      if (q0 + row < n)
        *reinterpret_cast<uint4*>(ob + (q0 + row) * o_sn + c * 8) =
            *reinterpret_cast<const uint4*>(smem + row * 128 + ((c ^ (row & 7)) << 4));
    }
  }
}

__global__ void __launch_bounds__(W_THREADS, 1)
attn_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ o, Strides so, int n, int n_valid,
                       float scale) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on that boundary
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t s_q = smem_u32(smem);  // WQ rows, loaded as boxes of 64
  const uint32_t s_k = s_q + SUB_BYTES * NCW * SUBS, s_v = s_k + STAGES * TILE_BYTES;
  const uint32_t bars = s_v + STAGES * TILE_BYTES;
  const uint32_t bar_q = bars;  // then full_k, full_v, empty: STAGES each, 8 bytes apart
  const uint32_t bar_k = bars + 8, bar_v = bar_k + 8 * STAGES, bar_e = bar_v + 8 * STAGES;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * WQ, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (n_valid + WK - 1) / WK;  // tiles past n_valid weigh 0
  // sub-tiles per warpgroup in this block: the second round only where it
  // holds a valid row (the turns need the same number of steps from all)
  const int subs = (SUBS == 2 && q0 + 64 * NCW < n_valid) ? 2 : 1;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 4 * NCW);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * NCW) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * NCW) {
      mbar_expect_tx(bar_q, subs * NCW * SUB_BYTES);
      for (int i = 0; i < subs * NCW; ++i)
        tma_load_tile(s_q + i * SUB_BYTES, &map_q, bar_q, q0 + 64 * i, h, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % STAGES, ph = (kt / STAGES) & 1;
        mbar_wait(bar_e + 8 * st, ph ^ 1);  // a fresh barrier passes at once
        mbar_expect_tx(bar_k + 8 * st, TILE_BYTES);
        tma_load_tile(s_k + st * TILE_BYTES, &map_k, bar_k + 8 * st, kt * WK, h, b);
        mbar_expect_tx(bar_v + 8 * st, TILE_BYTES);
        tma_load_tile(s_v + st * TILE_BYTES, &map_v, bar_v + 8 * st, kt * WK, h, b);
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    __nv_bfloat16* ob = o + b * so.b + h * so.h;
    if (SUBS == 2 && subs == 2)
      consume<SUBS>(smem, s_k, s_v, bar_q, bar_k, bar_v, bar_e, ob, so.n, q0, n, n_valid,
                    n_tiles, scale);
    else
      consume<1>(smem, s_k, s_v, bar_q, bar_k, bar_v, bar_e, ob, so.n, q0, n, n_valid, n_tiles,
                 scale);
  }
}

}  // namespace

// libcuda's tensor-map encoder, fetched from the already loaded library (the
// kernels link against the CUDA runtime only).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// [rows, 64] bf16 per (head, image) through element strides; box box_rows x 64
static CUresult encode_map(CUtensorMap* map, const void* base, const Strides& s, int batch,
                           int heads, int rows, int box_rows) {
  const cuuint64_t dims[4] = {cuuint64_t(HD), cuuint64_t(rows), cuuint64_t(heads),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(s.n) * 2, cuuint64_t(s.h) * 2, cuuint64_t(s.b) * 2};
  const cuuint32_t box[4] = {HD, cuuint32_t(box_rows), 1, 1}, elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Launch on `stream`. Returns 0 when launched, cudaGetLastError() when the
// launch was refused, cudaErrorInvalidValue when an operand's strides are
// negative (a tensor map cannot express them), 10000 when libcuda has no
// tensor-map encoder and 10000 + its CUresult when it refuses a map. Pointers,
// strides and n_valid are validated by the Python wrapper
// (depthg_tpu_torch/ops/attention.py): head_dim 64, contiguous last axis,
// 16-byte aligned base and strides, 1 <= n_valid <= n. The bf16 kernel reads
// q, k and v through tensor maps made here from those pointers and strides
// (a launch, maps included, takes ~30 us of host time; they are not cached).
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
    auto positive = [](const Strides& s) { return s.b > 0 && s.h > 0 && s.n > 0; };
    if (!positive(sq) || !positive(sk) || !positive(sv))
      return static_cast<int>(cudaErrorInvalidValue);
    if (!encode_tiled()) return 10000;
    // the token extent is n_valid: rows past it arrive as zeros
    CUtensorMap mq, mk, mv;
    CUresult res = encode_map(&mq, q, sq, batch, heads, n_valid, 64);
    if (res == CUDA_SUCCESS) res = encode_map(&mk, k, sk, batch, heads, n_valid, WK);
    if (res == CUDA_SUCCESS) res = encode_map(&mv, v, sv, batch, heads, n_valid, WK);
    if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
    // per launch, not once per process: the attribute belongs to the current device
    const cudaError_t attr = cudaFuncSetAttribute(
        attn_bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((n + WQ - 1) / WQ, heads, batch);
    attn_bf16_wgmma_kernel<<<grid, W_THREADS, W_SMEM, st>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), so, n, n_valid, scale);
  } else {
    const dim3 grid((n + F_BQ - 1) / F_BQ, heads, batch);
    attn_f32_kernel<<<grid, F_BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
        n, n_valid, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
