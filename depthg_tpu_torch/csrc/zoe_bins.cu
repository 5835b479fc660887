// The metric-bins head's full-resolution tail of ZoeDepth for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package leaves these operations to
// XLA (depthg_tpu/models/zoedepth/heads.py ConditionalLogBinomial and
// log_binomial, model.py's resizes and depth sum). Per pixel of the [B, H, W]
// output it computes what depthg_tpu_torch/ops/zoe_bins.py bins_tail_plain
// computes under a bf16 model, at the released head's widths:
//     e    = bilinear(prev_emb)            128 channels from [B, H/2, W/2]
//     c    = bilinear(b_centers)           64 bin centers from [B, H/2, W/2]
//     x    = [out_conv (32), rel (1), e (128)]
//     h    = gelu(W1 x + b1)               80
//     pt   = softplus(W2 h + b2)           4
//     p    = pt0 / (pt0 + pt1),  t = t_min + (t_max - t_min) pt2 / (pt2 + pt3)
//     y_k  = log C(63, k) + k log p + (63 - k) log(1 - p)
//     depth = sum_k softmax_k(y / t) c_k
// (bilinear with align_corners=True, p and the temperature after + 1e-4 and
// clamps as heads.py has them), and writes e (the head's `feats`) and depth.
// The [B, 161, H, W] input, the [B, 64, H, W] float32 probabilities and the
// resized centers never reach device memory.
//
// Rounding: the module's. The resizes interpolate in float32 and round to
// bf16; both products take bf16 operands and accumulate in float32, their
// outputs rounded to bf16 before the bias is added and again after (the
// convolution's output, then its bias add); GELU (exact erf) and softplus
// run in float32 and round to bf16, as do p + 1e-4, the two ratios, the
// temperature's scale and shift, 1 - p and both logarithms. The
// log-binomial, its softmax and the depth sum stay float32, with the
// module's operations in its order (__fmul_rn / __fadd_rn keep each product
// and sum apart, and the divisions are IEEE, as torch's kernels divide; only
// a bin term too small for any depth sum to see takes a multiply: prob()).
// What can differ from the module: the products' and the sums' order of
// accumulation, and the resizes' FMA contraction: a resized value can land
// one bf16 step away.
//
// What bounds it: bytes. At B=8, 384 x 512 a pass reads out_conv (100.7 MB),
// rel (3.1 MB), the half-resolution embedding (100.7 MB) and centers (50.3
// MB) and writes feats (402.7 MB) and depth (6.3 MB): 0.66 GB, 0.20 ms at
// 3.35 TB/s. The 161 -> 80 -> 4 products are 41.5 GFLOP (0.04 ms on the
// tensor cores); the rest is CUDA-core work per pixel: 192 interpolated
// channels, 80 erf, 64 exponentials and 128 divisions.
//
// Design: a persistent grid of two blocks per SM walks tiles of 64
// consecutive pixels of one output row (b, h, w0..w0+63; the last tile of a
// row may be ragged). A block holds W1 in shared memory for all its tiles
// and, per tile:
//   * cp.async brings the tile's out_conv rows (channels-last: 64 bytes a
//     pixel) straight into the product's A tile, and the two source rows of
//     the embedding and the centers over the tile's span of source columns
//     (at most 34: the source is half the size) into a window. The loads of
//     the next tile are issued right after the first product, so that they
//     land while the block runs the second product and the bins.
//   * Interpolation from the window: a warp a pixel, a lane four embedding
//     channels (their 8 bytes go to the A tile and to feats, whose 256
//     channels-last bytes a pixel the warp stores whole), then a half-warp
//     a pixel for the centers, into a centers tile.
//   * The 161 -> 80 product: mma.sync m16n8k16 (bf16, float32 sums), a warp
//     16 pixels, operands by ldmatrix from the A tile (its columns ordered
//     out_conv, embedding, rel, zeros to 176; W1's columns permuted to match
//     as they are staged) and from W1. Row strides of 368 bytes keep the
//     ldmatrix rows on distinct banks.
//   * The bias, GELU and the bf16 rounding turn the sums into the A
//     fragments of the 80 -> 4 product in registers (the C fragment of
//     m16n8 is the A fragment of m16n8k16), whose W2 fragments each thread
//     holds for all tiles.
//   * Bins: two lanes a pixel, 32 bins each, combined by shuffles for the
//     softmax's max and sum and for the depth sum.
// No bins are skipped and no fast-math exp, log or erf is used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int TP = 64;                   // output pixels of one tile
constexpr int THREADS = 128;             // 4 warps of 16 pixels in the products
constexpr int MIN_BLOCKS = 2;            // blocks per SM (shared memory allows two)
constexpr int C_OUT = 32;                // out_conv channels
constexpr int C_EMB = 128;               // bin embedding channels
constexpr int N_BINS = 64;
constexpr int C_IN = C_OUT + 1 + C_EMB;  // 161: the first product's inputs
constexpr int K1 = 176;                  // C_IN rounded up to the k16 step
constexpr int N1 = 80;                   // the bottleneck
constexpr int N2 = 4;                    // pt
constexpr int K_REL = C_OUT + C_EMB;     // 160: rel's column in the A tile
constexpr int LDA = 184;                 // row stride (bf16) of the A tile and of W1
constexpr int WIN = TP / 2 + 2;          // source columns a tile spans at most
constexpr int LDC = 66;                  // row stride (bf16) of the centers tile
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  __nv_bfloat16 w1[N1][LDA];              // W1, columns in the A tile's order
  __nv_bfloat16 a[TP][LDA];               // the first product's A tile
  __nv_bfloat16 win_emb[2][WIN][C_EMB];   // the embedding's two source rows
  __nv_bfloat16 win_ctr[2][WIN][N_BINS];  // the centers' two source rows
  __nv_bfloat16 ctr[TP][LDC];             // the tile's interpolated centers
  float b1[N1];
  float lb[N_BINS + 1];                   // log C(63, k); bins 32.. at +1
};

struct Args {
  const __nv_bfloat16 *out_conv, *rel, *emb, *ctr, *w1, *b1, *w2, *b2;
  float* depth;
  __nv_bfloat16* feats;
  float temp_scale, min_temp;  // max_temp - min_temp, min_temp
  float scale_h, scale_w;      // (in - 1) / (out - 1), as the resize computes them
  int h, w, hs, ws, tiles_w, n_tiles;
};

struct Tile {
  int b, h, w0, n;  // image, row, first column, pixels
};

__device__ __forceinline__ Tile tile_at(const Args& a, int t) {
  Tile s;
  const int wt = t % a.tiles_w, row = t / a.tiles_w;
  s.b = row / a.h;
  s.h = row % a.h;
  s.w0 = wt * TP;
  s.n = min(TP, a.w - s.w0);
  return s;
}

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// log C(63, k) as heads.log_binomial's log_binom computes it in float32
__device__ float log_choose(int k) {
  const float n = __fadd_rn(63.f, 1e-7f), r = __fadd_rn(static_cast<float>(k), 1e-7f);
  const float nr = __fsub_rn(n, r);
  const float tail = __fmul_rn(nr, logf(fmaxf(__fadd_rn(nr, 1e-7f), 1e-7f)));
  return __fsub_rn(__fsub_rn(__fmul_rn(n, logf(n)), __fmul_rn(r, logf(r))), tail);
}

// the resize's float32 interpolation: h0 (w0 a + w1 b) + h1 (w0 c + w1 d)
__device__ __forceinline__ float lerp2(float a, float b, float c, float d, float h0, float h1,
                                       float w0, float w1) {
  return h0 * (w0 * a + w1 * b) + h1 * (w0 * c + w1 * d);
}

// four channels (two bf16 pairs) interpolated and rounded to bf16
__device__ __forceinline__ uint2 lerp4(uint2 a, uint2 b, uint2 c, uint2 d, float h0, float h1,
                                       float w0, float w1) {
  uint2 o;
  o.x = pack_bf16(lerp2(lo_f(a.x), lo_f(b.x), lo_f(c.x), lo_f(d.x), h0, h1, w0, w1),
                  lerp2(hi_f(a.x), hi_f(b.x), hi_f(c.x), hi_f(d.x), h0, h1, w0, w1));
  o.y = pack_bf16(lerp2(lo_f(a.y), lo_f(b.y), lo_f(c.y), lo_f(d.y), h0, h1, w0, w1),
                  lerp2(hi_f(a.y), hi_f(b.y), hi_f(c.y), hi_f(d.y), h0, h1, w0, w1));
  return o;
}

// a source coordinate of the resize: its index, its weight, 1 unless it is the last
struct Src {
  int i, step;
  float w1;
};

__device__ __forceinline__ Src source(float scale, int dst, int in_size) {
  const float x = __fmul_rn(scale, static_cast<float>(dst));
  Src s;
  s.i = static_cast<int>(x);
  s.step = s.i < in_size - 1 ? 1 : 0;
  s.w1 = x - static_cast<float>(s.i);
  return s;
}

// the first product's output + bias, GELU, each rounded as the module rounds
__device__ __forceinline__ float gelu_out(float acc, float bias) {
  const float x = bf(bf(acc) + bias);
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

// pt + p_eps: the second product's output + bias, softplus, + 1e-4
__device__ __forceinline__ float pt_eps(float acc, float bias) {
  const float x = bf(bf(acc) + bias);
  return bf(bf(x > 20.f ? x : log1pf(expf(x))) + 1e-4f);
}

// a bin's probability e / sum (1 <= sum <= 64: the largest term is exp(0)).
// The division is IEEE, as the softmax's, wherever e >= 2^-100. Below that
// the division's slow path (a subroutine for quotients near or below the
// smallest normal float, which the bins of a pixel at a low temperature reach
// by the dozen) would buy nothing: 63 such terms times the largest center
// stay under half a unit in the last place of the depth (at least 1/64 of
// the smallest center) unless the centers span more than 2^60 to one, so
// e times 1 / sum stands in and the depth is the same.
__device__ __forceinline__ float prob(float e, float sum, float inv_sum) {
  return e >= 0x1p-100f ? __fdiv_rn(e, sum) : __fmul_rn(e, inv_sum);
}

// issues the cp.async loads of tile t (out_conv into the A tile, the source
// window) and returns its rel value for pixel tid
__device__ __forceinline__ __nv_bfloat16 load_tile(Smem& s, const Args& a, const Tile& t,
                                                   int tid) {
  const long long pix = (static_cast<long long>(t.b) * a.h + t.h) * a.w + t.w0;
  const __nv_bfloat16* oc = a.out_conv + pix * C_OUT;
  for (int i = tid; i < t.n * (C_OUT / 8); i += THREADS)
    cp_async16(&s.a[i / (C_OUT / 8)][(i % (C_OUT / 8)) * 8], oc + i * 8);
  const Src y = source(a.scale_h, t.h, a.hs);
  const int x_lo = source(a.scale_w, t.w0, a.ws).i;
  const int x_hi = min(source(a.scale_w, t.w0 + t.n - 1, a.ws).i + 1, a.ws - 1);
  const int cols = x_hi - x_lo + 1;
  for (int r = 0; r < 2; ++r) {
    const long long src = (static_cast<long long>(t.b) * a.hs + y.i + r * y.step) * a.ws + x_lo;
    const __nv_bfloat16* e = a.emb + src * C_EMB;
    for (int i = tid; i < cols * (C_EMB / 8); i += THREADS)
      cp_async16(&s.win_emb[r][0][0] + i * 8, e + i * 8);
    const __nv_bfloat16* c = a.ctr + src * N_BINS;
    for (int i = tid; i < cols * (N_BINS / 8); i += THREADS)
      cp_async16(&s.win_ctr[r][0][0] + i * 8, c + i * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return tid < t.n ? a.rel[pix + tid] : __float2bfloat16_rn(0.f);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) zoe_bins_tail_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  int t = blockIdx.x;
  Tile cur = tile_at(a, t);
  __nv_bfloat16 rel = load_tile(s, a, cur, tid);

  // once a block: W1 in the A tile's column order (out_conv, embedding,
  // rel, zeros), b1, log C(63, k), the A tile's zero columns
  for (int i = tid; i < N1 * K1; i += THREADS) {
    const int n = i / K1, k = i % K1;
    const int src = k < C_OUT ? k : k < K_REL ? k + 1 : k == K_REL ? C_OUT : -1;
    s.w1[n][k] = src >= 0 ? a.w1[n * C_IN + src] : __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < TP * (K1 - K_REL - 1); i += THREADS)
    s.a[i / (K1 - K_REL - 1)][K_REL + 1 + i % (K1 - K_REL - 1)] = __float2bfloat16_rn(0.f);
  if (tid < N1) s.b1[tid] = __bfloat162float(a.b1[tid]);
  if (tid < N_BINS) s.lb[tid + (tid >> 5)] = log_choose(tid);
  // the second product's B fragments (W2 padded to 8 outputs) and bias
  uint32_t w2f[N1 / 16][2];
#pragma unroll
  for (int j = 0; j < N1 / 16; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      w2f[j][half] = g < N2 ? *reinterpret_cast<const uint32_t*>(
                                  a.w2 + g * N1 + 16 * j + 8 * half + 2 * tig)
                            : 0u;
  const float b2_0 = tig < 2 ? __bfloat162float(a.b2[2 * tig]) : 0.f;
  const float b2_1 = tig < 2 ? __bfloat162float(a.b2[2 * tig + 1]) : 0.f;
  const float eps_lo = bf(1e-4f);  // the clamps' lower bound as a bf16 scalar

  for (;;) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // interpolation: the embedding (a warp a pixel) into the A tile and feats
    const Src y = source(a.scale_h, cur.h, a.hs);
    const float h1 = y.w1, h0 = 1.f - y.w1;
    const int x_lo = source(a.scale_w, cur.w0, a.ws).i;
    const long long pix = (static_cast<long long>(cur.b) * a.h + cur.h) * a.w + cur.w0;
    for (int px = warp; px < cur.n; px += THREADS / 32) {
      const Src x = source(a.scale_w, cur.w0 + px, a.ws);
      const int c0 = x.i - x_lo, c1 = c0 + x.step;
      const uint2 v = lerp4(*reinterpret_cast<const uint2*>(&s.win_emb[0][c0][4 * lane]),
                            *reinterpret_cast<const uint2*>(&s.win_emb[0][c1][4 * lane]),
                            *reinterpret_cast<const uint2*>(&s.win_emb[1][c0][4 * lane]),
                            *reinterpret_cast<const uint2*>(&s.win_emb[1][c1][4 * lane]), h0, h1,
                            1.f - x.w1, x.w1);
      *reinterpret_cast<uint2*>(&s.a[px][C_OUT + 4 * lane]) = v;
      *reinterpret_cast<uint2*>(a.feats + (pix + px) * C_EMB + 4 * lane) = v;
    }
    // the centers (a half-warp a pixel) into the centers tile
    for (int px = 2 * warp + (lane >> 4); px < cur.n; px += THREADS / 16) {
      const int q = lane & 15;
      const Src x = source(a.scale_w, cur.w0 + px, a.ws);
      const int c0 = x.i - x_lo, c1 = c0 + x.step;
      const uint2 v = lerp4(*reinterpret_cast<const uint2*>(&s.win_ctr[0][c0][4 * q]),
                            *reinterpret_cast<const uint2*>(&s.win_ctr[0][c1][4 * q]),
                            *reinterpret_cast<const uint2*>(&s.win_ctr[1][c0][4 * q]),
                            *reinterpret_cast<const uint2*>(&s.win_ctr[1][c1][4 * q]), h0, h1,
                            1.f - x.w1, x.w1);
      uint32_t* dst = reinterpret_cast<uint32_t*>(&s.ctr[px][4 * q]);
      dst[0] = v.x;
      dst[1] = v.y;
    }
    if (tid < cur.n) s.a[tid][K_REL] = rel;
    __syncthreads();

    // the 161 -> 80 product: a warp 16 pixels, 10 n-tiles of 8
    float acc[N1 / 8][4];
#pragma unroll
    for (int nt = 0; nt < N1 / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    {
      const unsigned a_base =
          smem_u32(&s.a[warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][(lane >> 4) * 8]);
      const unsigned b_base = smem_u32(&s.w1[(lane >> 4) * 8 + (lane & 7)][((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int ks = 0; ks < K1 / 16; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(af, a_base + ks * 32);
#pragma unroll
        for (int np = 0; np < N1 / 16; ++np) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, b_base + np * 16 * LDA * 2 + ks * 32);
          mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
          mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // the A tile and the window are free: the next tile's loads go out

    const int tn = t + gridDim.x;
    Tile nxt = cur;
    if (tn < a.n_tiles) {
      nxt = tile_at(a, tn);
      rel = load_tile(s, a, nxt, tid);
    }

    // bias, GELU, bf16: the A fragments of the 80 -> 4 product
    uint32_t hf[N1 / 16][4];
#pragma unroll
    for (int nt = 0; nt < N1 / 8; ++nt) {
      const float2 bb = *reinterpret_cast<const float2*>(&s.b1[8 * nt + 2 * tig]);
      hf[nt >> 1][(nt & 1) * 2] = pack_bf16(gelu_out(acc[nt][0], bb.x), gelu_out(acc[nt][1], bb.y));
      hf[nt >> 1][(nt & 1) * 2 + 1] =
          pack_bf16(gelu_out(acc[nt][2], bb.x), gelu_out(acc[nt][3], bb.y));
    }
    float pt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N1 / 16; ++j) mma_bf16(pt, hf[j], w2f[j][0], w2f[j][1]);
    // lanes with tig 0 hold pt0, pt1 of rows g and g + 8 (the probability),
    // tig 1 pt2, pt3 (the temperature)
    float r_lo, r_hi;
    {
      const float q0 = pt_eps(pt[0], b2_0), q1 = pt_eps(pt[1], b2_1);
      const float q2 = pt_eps(pt[2], b2_0), q3 = pt_eps(pt[3], b2_1);
      r_lo = bf(q0 / bf(q0 + q1));
      r_hi = bf(q2 / bf(q2 + q3));
      if (tig == 1) {
        r_lo = bf(bf(r_lo * a.temp_scale) + a.min_temp);
        r_hi = bf(bf(r_hi * a.temp_scale) + a.min_temp);
      }
    }
    // bins: lanes 2q, 2q + 1 take pixel q of the warp's 16, bins 0-31 and 32-63
    const int q = lane >> 1, half = lane & 1, src = 4 * (q & 7);
    const float p_lo = __shfl_sync(FULL, r_lo, src), p_hi = __shfl_sync(FULL, r_hi, src);
    const float t_lo = __shfl_sync(FULL, r_lo, src + 1), t_hi = __shfl_sync(FULL, r_hi, src + 1);
    const float p = q < 8 ? p_lo : p_hi, temp = q < 8 ? t_lo : t_hi;
    const float lx = bf(logf(fminf(fmaxf(p, eps_lo), 1.f)));
    const float l1x = bf(logf(fminf(fmaxf(bf(1.f - p), eps_lo), 1.f)));
    const float* lb = s.lb + half * 33;
    const int k0 = half * 32;
    float z[32];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float k = static_cast<float>(k0 + j);
      const float yk = __fadd_rn(__fadd_rn(lb[j], __fmul_rn(k, lx)), __fmul_rn(63.f - k, l1x));
      z[j] = __fdiv_rn(yk, temp);
      m = fmaxf(m, z[j]);
    }
    m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      z[j] = expf(z[j] - m);
      sum += z[j];
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    const int px = warp * 16 + q;
    const uint32_t* cr = reinterpret_cast<const uint32_t*>(&s.ctr[px][k0]);
    const float inv_sum = __frcp_rn(sum);
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t cc = cr[j];
      d = __fadd_rn(d, __fmul_rn(prob(z[2 * j], sum, inv_sum), lo_f(cc)));
      d = __fadd_rn(d, __fmul_rn(prob(z[2 * j + 1], sum, inv_sum), hi_f(cc)));
    }
    d = __fadd_rn(d, __shfl_xor_sync(FULL, d, 1));
    if (half == 0 && px < cur.n) a.depth[pix + px] = d;

    if (tn >= a.n_tiles) break;
    t = tn;
    cur = nxt;
  }
}

}  // namespace

// out_conv [B, H, W, 32], emb [B, H/2, W/2, 128], centers [B, H/2, W/2, 64]
// and feats [B, H, W, 128] (the [B, C, H, W] maps in channels-last memory),
// rel [B, H, W] and depth [B, H, W] float32, all contiguous and 16-byte
// aligned; w1 [80, 161] (the input order out_conv, rel, embedding), b1 [80],
// w2 [4, 80], b2 [4]; every tensor but depth bf16. temp_scale is max_temp -
// min_temp. Launches on `stream`; returns cudaErrorInvalidValue for a shape
// the kernel does not take, else cudaGetLastError() (0 = launched). Dtypes,
// devices, layouts and alignment are validated by the Python wrapper
// (depthg_tpu_torch/ops/zoe_bins.py).
extern "C" int depthg_zoe_bins_tail(const void* out_conv, const void* rel, const void* emb,
                                    const void* centers, const void* w1, const void* b1,
                                    const void* w2, const void* b2, float temp_scale,
                                    float min_temp, void* depth, void* feats, int batch, int h,
                                    int w, int hs, int ws, void* stream) {
  if (batch < 1 || hs < 1 || ws < 1 || h != 2 * hs || w != 2 * ws)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = (w + TP - 1) / TP;
  const long long tiles = static_cast<long long>(batch) * h * tiles_w;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // per launch: the attribute belongs to the current device
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(zoe_bins_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.out_conv = static_cast<const __nv_bfloat16*>(out_conv);
  a.rel = static_cast<const __nv_bfloat16*>(rel);
  a.emb = static_cast<const __nv_bfloat16*>(emb);
  a.ctr = static_cast<const __nv_bfloat16*>(centers);
  a.w1 = static_cast<const __nv_bfloat16*>(w1);
  a.b1 = static_cast<const __nv_bfloat16*>(b1);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.b2 = static_cast<const __nv_bfloat16*>(b2);
  a.depth = static_cast<float*>(depth);
  a.feats = static_cast<__nv_bfloat16*>(feats);
  a.temp_scale = temp_scale;
  a.min_temp = min_temp;
  // area_pixel_compute_scale<float> with align_corners: float(in - 1) / (out - 1)
  a.scale_h = static_cast<float>(hs - 1) / (h - 1);
  a.scale_w = static_cast<float>(ws - 1) / (w - 1);
  a.h = h;
  a.w = w;
  a.hs = hs;
  a.ws = ws;
  a.tiles_w = tiles_w;
  a.n_tiles = static_cast<int>(tiles);
  const int grid = static_cast<int>(tiles < static_cast<long long>(sms) * MIN_BLOCKS
                                        ? tiles
                                        : static_cast<long long>(sms) * MIN_BLOCKS);
  zoe_bins_tail_kernel<<<grid, THREADS, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
