// Streaming bilateral message of the dense CRF for Hopper (sm_90a), the
// kernel that builds its int8 kernel cache and the two of the message
// through that cache (both at the end of this note).
//
// Replaces the TPU kernel depthg_tpu/ops/crf_pallas.py bilateral_message_pallas
// (_kernel), the fused form of depthg_tpu/ops/crf.py _bilateral_message:
//     out[b, i, :] = sum_j k_ij z[b, j, :],  k_ij = exp(-|f_i - f_j|^2 / 2)
// over N points with 5 features (x, y, r, g, b) already divided by their
// sigmas. The kernel matrix is never stored: each entry is computed,
// exponentiated and multiplied into the values on chip.
//
// What bounds it: per image N^2 kernel entries (1.05e10 at N=102,400), each
// 5 subtractions and 5 FMAs in fp32 (128 per clock per SM) and one ex2 on
// the MUFU (16 per clock per SM), against N x C values of a few MB that
// stay in L2. So it is bound by operations, not bytes: the FP32 pipe needs
// 10 / 128 clocks per entry per SM, the MUFU 1 / 16, and the instruction
// issue (one warp instruction per clock per scheduler, 128 lanes per clock
// per SM) is the limit the kernel actually meets: 11.5 instructions per
// entry at the least (10 fp32, one ex2, half a bf16x2 conversion), plus the
// shared loads and mma that feed them. The value product is cheap next to
// that and runs on tensor cores.
//
// Design: one block owns a tile of query rows of one image (grid: row tile x
// channel chunk x image, so one launch covers the batch) and keeps their
// features in registers; it streams key tiles of features and values
// through shared memory. All entries take feats [B, N, 5] and values
// [B, N, C] through their strides (last axis contiguous).
//   * Log-kernel: -|f_i - f_j|^2 / 2 in fp32, computed directly (5 subtractions
//     and 5 FMAs). The TPU kernel's augmented depth-7 matmul
//     a.b - |a|^2/2 - |b|^2/2 cancels terms of ~2e4 (rgb/3 ~ 85) and leaves
//     ~1e-3 of noise per entry; the direct form has no cancellation.
//   * bf16 values (bilateral_rows_kernel): a block is one warpgroup and owns
//     FR = 2 tiles of 64 query rows; each warp holds 16 rows of each (4 per
//     thread). Every thread computes the kernel entries at exactly the
//     positions it holds in the A operand of wgmma.m64nNk16, so P goes from
//     the CUDA cores to the tensor cores without shared memory; P is rounded
//     to bf16 only as that operand and the product accumulates in fp32 (the
//     TPU kernel's value dot_general at default precision). The product is
//     asynchronous: while the tensor cores multiply the P of one 16-key step
//     into the value tile (read straight from shared memory, no fragment
//     loads), the CUDA cores compute the P of the next step into a second
//     set of registers. One load of a key's features serves four rows, and
//     each thread runs four independent subtract/FMA/ex2 chains. Tiles are
//     128 keys, double buffered with cp.async: one barrier pair per 128
//     keys. The exp is ex2.approx.ftz (MUFU): ~2^-22 relative error,
//     results below 2^-126 flushed to 0, both far below the bf16 rounding
//     of P that follows.
//     The entry first packs the operands into a workspace the caller
//     allocates with the size depthg_bilateral_workspace_bytes gives:
//     features [B, 5, NP] times sqrt(log2(e) / 2), so an entry is
//     ex2(-|f_i - f_j|^2) with the negation riding on the FMA and no
//     multiply left, and values [B, chunks * CP, NP] (a shared-memory
//     transpose), both channel-major, NP = N rounded up to the key tile.
//     Every tile is then whole 16-byte rows. (A version that read [B, N, C]
//     in place, through registers, took 1.7-2.5x as long on an H100: rows of
//     C = 54 halves allow no 16-byte copies, and C = 27 no 4-byte ones.) The
//     value tile sits in shared memory [channel][key] as two halves of 64
//     keys, 128-byte rows in the 128-byte swizzle (cp.async writes each
//     16-byte piece to its swizzled place), which is wgmma's K-major B
//     layout. With mma.sync m16n8k16 and fragment loads in its place the
//     same loop took 9.5 ms per ds=1 message per image instead of 8.6 ms.
//   * Degree (K . 1, float32, once per CRF call): the same row-blocked loop
//     on the packed features with fp32 row sums of the entries in place of
//     the value product: no value tile, no mma, no bf16 rounding.
//   * f32 values (bilateral_f32_rows_kernel, split TF32): the float32
//     product of C channels per entry would cost C FMAs on the FP32 pipes,
//     (10 + C) instructions per entry with the distance: 40.1 ms at B=2,
//     N=102,400, C=54 at 67 TFLOP/s. The tensor cores take float32 only as
//     TF32 (10 mantissa bits), so entry and value are each split as hi =
//     tf32(x), lo = tf32(x - hi) (cvt.rna, |x - hi - lo| <= 2^-21 |x|) and
//     the product is hi.hi + hi.lo + lo.hi in float32 ("3xTF32"): 3 x 2 C
//     operations per entry at 495 TFLOP/s (13.7 ms there), beside 10
//     distance instructions, one ex2 and the 3-instruction split on the
//     CUDA cores. The log-kernel stays a direct float32 distance (TF32
//     never touches it) on features pre-scaled by sqrt(log2(e) / 2), with
//     ex2.approx.ftz: tests/test_torch_f32_split.py emulates this
//     arithmetic on the CPU, 7e-7 relative from float64 on fidelity scenes.
//     The loop is the bf16 kernel's: entries computed straight into A
//     fragments (keys 2 t, 2 t + 1 of each 8-key step, the TF32 fragment's
//     columns t and t + 4, so the pack step stores each group of 8 keys in
//     that order), 3 x wgmma.m64nNk8.tf32 per step and 64-row tile,
//     committed in groups of one step (two above 32 channels) while the next
//     group's entries are computed. Its pack step
//     (pack_values_f32_kernel) writes the values' hi and lo planes,
//     channel-major; a tile is 64 keys (the two planes take 4x the bytes of
//     bf16). The tensor cores truncate as they accumulate (a float32 sum
//     carried over every key drifts toward zero by up to an ulp per add), so
//     each tile's product starts from zero and is added into the sum on the
//     CUDA cores; the second accumulator leaves registers for 2 blocks per SM.
//   * Channels are padded to the mma width (8) in the packed copy: padded
//     channels are zero and never written out. More than 64 channels take further chunks along grid.y (each
//     recomputes the kernel entries; the CRF's largest C is 54).
//   * Ragged edge: the pack step writes the feature PAD_FEATURE (1e18) and
//     zero values for keys j >= n, so their entry is ex2(-1e36) = 0 exactly
//     (and 0 * 0 in the value product); query rows i >= n are not written.
//     Nothing past n of the caller's tensors is read.
// What holds it (H100): the degree loop, which is the entries alone, runs at
// ~66% of the issue bound; the value product adds the bf16x2 packs, the
// wgmma issue and a tile load six times as large. More rows per thread
// (FR = 3, 4) or fewer blocks per SM were slower: registers, not loads,
// limit the number of warps that hide the fp32 and ex2 latencies.
// The f32 kernel (NVIDIA H100 80GB HBM3, 700 W, N=102,400; chip_smoke.py):
// per image ~10.9 ms at C=1, where the entries alone cost twice the degree
// loop's (the split, 64-key tiles, a wait per step), plus ~0.28 ms per
// channel, the products at ~45% of the TF32 peak; B=2, C=54 took 51.4-51.9
// ms with one step per commit group and 46.6 ms with two (against 136.9 ms
// for the one-thread-per-row FMA kernel it replaced), 3.4x its bound: 13.7
// ms for its split products (40.1 ms on the FMA pipes is a yardstick only).
// The pack step is 0.05 ms of it (torch.profiler in chip_smoke.py): the gap
// to the bound is the message kernel's.
// Left for later: the kernel's symmetry (half the exps, needs a second pass
// or atomics), exact tile skipping.
//
// The int8 kernel cache (bilateral_cache_int8_kernel). It replaces no TPU
// kernel: the JAX package builds the cache with XLA ops
// (depthg_tpu/ops/crf.py _cache_kernel). Where a point set's kernel fits
// the cache (the CRF's default point: ds=8, 4 phases, N=6,400 at 320 px),
// the CRF stores K per image as int8 at the fixed scale 127,
//     out[b, i, j] = round_half_even(127 k_ij) in [0, 127],
// and reads it in every message. What bounds it: the bytes, B N^2 written
// once (655 MB at B=16, N=6,400: 0.196 ms at 3.35 TB/s), beside one ex2 per
// entry on the MUFU (0.157 ms at 1980 MHz) and ~13 instructions per entry at
// the issue rate (10 for the distance, the ex2, the rounding FMA, 3/4 of a
// byte permute). Design: a block owns 512 columns and 256 rows of one
// image; it stages the features of both, scaled by EX2_SCALE, in shared
// memory with coalesced loads. A thread then holds its 16 consecutive
// columns in registers and walks rows: a warp covers the block's 512
// columns of a row, and the 4 warps take every 4th row (every lane reads
// the same row's features: a broadcast). Per row a thread computes its 16
// entries as K4 does (direct distance, ex2.approx.ftz; the diagonal's
// distance is exactly 0, so it is exactly 127), rounds each on the FP32
// pipe (an FMA with 127 and 1.5 * 2^23 leaves the integer, half to even, in
// the low mantissa byte; a cvt would share the MUFU's pipe), packs 4 bytes
// a word with byte permutes and writes the 16 as one 16-byte store, so the
// kernel matrix never exists in float32. Where N is not a multiple of 16
// (row pieces off 16-byte alignment) and at the ragged piece at column N,
// a thread writes byte by byte; nothing past column N or row N is written.
// What holds it (H100, B=16, N=6,400): the instruction issue. The stores
// alone take 0.206 ms (95% of the memory rate) and the entries alone (no
// store) 0.375 ms, ~14.6 instructions an entry (the row loop's address
// and loop work beside the 12.75) at ~76% of the issue rate. Columns read
// by each lane straight from the [B, N, 5] features (320-byte strides
// across a warp) cost 0.477 ms against 0.40-0.42 staged; 64-row tiles 0.60.
//
// The int8 cached message (int8_quantize_kernel, int8_message_kernel). It
// replaces no TPU kernel: the JAX package's message through the cache
// (depthg_tpu/ops/crf.py _cached_matmul) is an XLA int8 product. Per image
//     q8 = round_half_even(z * (127 / zmax)),  zmax = max(|z|, 1e-20),
//     out = (K8 @ q8) * (zmax / 127^2)   in the state dtype,
// in the float32 arithmetic PyTorch's eager ops give on the card (127 / zmax
// is reciprocal(zmax) * 127 with an IEEE division; zmax / 16129 is a
// multiply by float(1 / 16129); int32 -> float32 rounds to nearest; the bf16
// cast to nearest even), so the result is theirs bit for bit: the int32
// sums are exact in any order. What bounds it: the bytes, the cache read
// once per message (B N^2: 655 MB at B=16, N=6,400, 0.196 ms at 3.35
// TB/s); the products (2 B N^2 64 at C=54, 0.04 ms at the int8 peak) and
// the operand (N C per image, L2-resident) are small beside them. Two
// launches a message:
//   * int8_quantize_kernel: a cluster of 8 blocks per image takes max |z|
//     (each block its tiles, combined through distributed shared memory),
//     then writes q8 channel-major [B, cpad, np] (zero past n and c: the
//     product's K-major B operand) and zmax / 16129 per image.
//   * int8_message_kernel: a block of one warpgroup owns 128 cache rows of
//     one image (grid: row tile x 64-channel chunk x image: 800 blocks at
//     B=16, N=6,400) and streams them through a ring of 4 stages of 128
//     keys, beside the operand's lines: TMA where the cache's row pitch is
//     a multiple of 16 bytes, else cp.async 4 bytes a copy (N % 4 = 0:
//     every default-point N = 4 (res / 8)^2) or byte loads. wgmma.m64nNk32.s8
//     with both operands from shared memory, N = 8 NT the channels padded
//     to the nearest s8 width (8, 16, 24, 32, 48, 64); int32 sums in
//     registers; the rescale and the cast in the epilogue. Entries past N
//     are never read (TMA fills zeros; cp.async's stale bytes meet the
//     operand's zeros) and rows past N never written.
// What holds it (H100, B=16, N=6,400; torch.profiler): the product 0.233 ms
// at C=54 (84% of the memory rate; 0.209 at C=1), the quantize 0.035-0.036
// ms, ~30 us of it whatever C (its passes read L2 from 128 blocks). The
// same loop on cp.async 16-byte copies took 0.42 ms with or without the
// products: the loads bound it. 64-row tiles, 256-key stages, 3 or 6
// stages and 256-row tiles all read within 3% of this layout under TMA;
// staggering each block's first stage read 1% slower.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap types only; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NF = 5;          // features per point
constexpr int RK = 128;        // keys per tile, bf16 and degree kernels
constexpr int FK = 64;         // keys per tile, f32 kernel
constexpr int FR = 2;          // m16 fragments (16 query rows) per warp
constexpr int RQ = 64 * FR;    // query rows per block (4 warps)
constexpr int MIN_BLOCKS = 4;  // blocks per SM the register budget is set for
constexpr int F32_MIN_BLOCKS = 2;  // the same, f32 kernel
constexpr float PAD_FEATURE = 1e18f;  // packed feature of a key past n: its entries are 0
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

// the packed operands: NP keys (N rounded up to the key tile RK), chunks of
// CP channels (CP = 8 min(8, ceil(C / 8)); none for the degree, c = 0), each
// value taking value_bytes (bf16: 2; f32: 8, its TF32 hi and lo planes)
struct Packed {
  int np, cp, cpad;  // cpad = chunks * CP
  long long feat_bytes, plane, bytes;  // plane: elements of one value plane
};

Packed packed_layout(int batch, int n, int c, int value_bytes) {
  Packed p;
  p.np = (n + RK - 1) / RK * RK;
  p.cp = 8 * min(8, (c + 7) / 8);
  p.cpad = c ? (c + p.cp - 1) / p.cp * p.cp : 0;
  p.feat_bytes = static_cast<long long>(batch) * NF * p.np * sizeof(float);
  p.plane = static_cast<long long>(batch) * p.cpad * p.np;
  p.bytes = p.feat_bytes + p.plane * value_bytes;
  return p;
}

// [B, N, 5] -> ft [B, 5, np] times EX2_SCALE, PAD_FEATURE past n
__global__ void __launch_bounds__(256)
pack_feats_kernel(const float* __restrict__ feats, float* __restrict__ ft, Strides sf, int n,
                  int np) {
  const int b = blockIdx.y, key = blockIdx.x * 256 + threadIdx.x;
  if (key >= np) return;
#pragma unroll
  for (int f = 0; f < NF; ++f)
    ft[(static_cast<long long>(b) * NF + f) * np + key] =
        key < n ? feats[b * sf.b + key * sf.n + f] * EX2_SCALE : PAD_FEATURE;
}

// [B, N, C] -> zt [B, cpad, np], zero past n and c. Block (32, 8) transposes
// a 32-key x 32-channel tile through shared memory.
__global__ void __launch_bounds__(256)
pack_values_kernel(const unsigned short* __restrict__ z, unsigned short* __restrict__ zt,
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
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// The split of an operand made in registers: hi = tf32(x) rounded to
// nearest (ties away) by adding half a TF32 ulp to the bits and masking,
// lo = x - hi (exact), which the tensor cores read truncated to TF32. Two
// integer operations and an add: cvt.rna would take the conversion pipe,
// which ex2 shares. |x - hi - tf32_truncate(lo)| < 2^-21 |x|; finite x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// [B, N, C] float32 -> zt [B, cpad, np] TF32 hi and, lo_offset elements
// later, lo; zero past n and c. Within each group of 8 keys slot t holds key
// 2 t and slot t + 4 key 2 t + 1 (the A fragment columns t, t + 4 of the
// entries a thread computes for keys 2 t, 2 t + 1). Block (32, 8)
// transposes a 32-key x 32-channel tile through shared memory.
__global__ void __launch_bounds__(256)
pack_values_f32_kernel(const float* __restrict__ z, float* __restrict__ zt, Strides sz, int n,
                       int c, int np, int cpad, long long lo_offset) {
  __shared__ float tile[PT][PT + 1];
  const int b = blockIdx.z, k0 = blockIdx.x * PT, ch0 = blockIdx.y * PT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < PT; i += 8) {  // read along channels
    const int key = k0 + i, ch = ch0 + tx;
    tile[i][tx] = (key < n && ch < c) ? z[b * sz.b + key * sz.n + ch] : 0.f;
  }
  __syncthreads();
  const int key = (tx & ~7) | ((tx & 3) << 1) | ((tx >> 2) & 1);  // held by slot tx
  for (int i = ty; i < PT; i += 8) {  // write along keys
    const int ch = ch0 + i;
    if (ch < cpad) {
      const float x = tile[key][i], hi = __uint_as_float(tf32_rna(x));
      const long long off = (static_cast<long long>(b) * cpad + ch) * np + k0 + tx;
      zt[off] = hi;
      zt[lo_offset + off] = __uint_as_float(tf32_rna(x - hi));
    }
  }
}

// d[64 rows x 8 NT channels] += a[64 rows x 16 keys, registers] . value tile
// (K-major in shared memory, 128-byte swizzle), asynchronously
template <int NT>
__device__ __forceinline__ void wgmma_pz(float (&d)[4 * NT], const uint32_t (&a)[4],
                                         uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_pz<1>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pz<2>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pz<3>(float (&d)[12], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pz<4>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pz<5>(float (&d)[20], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pz<6>(float (&d)[24], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pz<7>(float (&d)[28], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pz<8>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[64 rows x 8 NT channels] += a[64 rows x 8 keys, registers, TF32] . TF32
// value tile (K-major in shared memory, 128-byte swizzle), asynchronously;
// d is overwritten when accumulate is 0
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[4 * NT], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate);
template <>
__device__ __forceinline__ void wgmma_tf32<1>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<2>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<3>(float (&d)[12], const uint32_t (&a)[4], uint64_t desc,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<4>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<5>(float (&d)[20], const uint32_t (&a)[4], uint64_t desc,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<6>(float (&d)[24], const uint32_t (&a)[4], uint64_t desc,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<7>(float (&d)[28], const uint32_t (&a)[4], uint64_t desc,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups 1024 B apart
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

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// The row-blocked kernel. The block is one warpgroup; it owns FR tiles of 64
// query rows, of which each warp holds 16 (rows g and g + 8 of each per
// thread), so a thread's entries are its part of the A operand of
// wgmma.m64nNk16. NT n-tiles of 8 channels (CP = 8 NT channels per block);
// ft: [B, NF, np] scaled features, zt: [B, chunks * CP, np] values, as the
// pack kernels write them. Dynamic shared memory (rows_smem_bytes): two
// buffers of [NF][RK] features and of the value tile, [channel][key] in two
// halves of 64 keys with 128-byte rows in the 128-byte swizzle.
// DEGREE: no values; out [B, N, 1] float32 = the row sums of the entries.
constexpr int rows_smem_bytes(int nt, bool degree) {
  return 1024 + 2 * NF * RK * 4 + (degree ? 0 : 2 * nt * 8 * RK * 2);
}

template <int NT, bool DEGREE>
__global__ void __launch_bounds__(128, MIN_BLOCKS)
bilateral_rows_kernel(const float* __restrict__ ft, const __nv_bfloat16* __restrict__ zt,
                      void* __restrict__ out, long long zt_b, int np, Strides so, int n,
                      int c) {
  constexpr int CP = NT * 8;
  constexpr int F_CHUNKS = NF * RK / 4;               // 16-byte pieces of a feature tile
  constexpr int Z_CHUNKS = DEGREE ? 0 : CP * RK / 8;  // 16-byte pieces of a value tile
  constexpr int HALF_BYTES = CP * 128;                // 64 keys of every channel
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: the value tiles start there
  uint8_t* sz = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float (*sF)[NF][RK] = reinterpret_cast<float (*)[NF][RK]>(sz + (DEGREE ? 0 : 4 * HALF_BYTES));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group / column pair
  const int b = blockIdx.z, c0 = blockIdx.y * CP;
  const float* fb = ft + b * (long long)NF * np;
  const __nv_bfloat16* zb = zt + b * zt_b + c0 * (long long)np;
  const int row0 = blockIdx.x * RQ + warp * 16 + g;  // rows row0 + 64 fr + 8 r

  float fq[FR][2][NF];
#pragma unroll
  for (int fr = 0; fr < FR; ++fr)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + fr * 64 + r * 8;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        fq[fr][r][f] = row < np ? fb[f * (long long)np + row] : PAD_FEATURE;
    }

  // one commit group per tile: its features and values, into buffer `buf`
  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * RK;
    for (int i = tid; i < F_CHUNKS + Z_CHUNKS; i += blockDim.x) {
      if (i < F_CHUNKS) {
        const int f = i / (RK / 4), part = (i % (RK / 4)) * 4;
        cp_async16(&sF[buf][f][part], fb + f * (long long)np + k0 + part);
      } else {
        // 8 keys of one channel: half kc / 8, 16-byte column kc % 8 swizzled by the row
        const int j = i - F_CHUNKS, ch = j / (RK / 8), kc = j % (RK / 8);
        cp_async16(sz + (2 * buf + (kc >> 3)) * HALF_BYTES + ch * 128 +
                       (((kc & 7) ^ (ch & 7)) << 4),
                   zb + ch * (long long)np + k0 + kc * 8);
      }
    }
    cp_async_commit();
  };

  float acc[FR][4 * NT];  // value product (unused for the degree): [n-tile][row g: 2, g+8: 2]
  float rs[FR][2];        // row sums of the entries (the degree)
#pragma unroll
  for (int fr = 0; fr < FR; ++fr) {
    rs[fr][0] = rs[fr][1] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) acc[fr][e] = 0.f;
  }

  const int n_tiles = np / RK;
  load_tile(0, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load_tile(kt + 1, buf ^ 1);  // its buffer was released at the end of kt - 1
      cp_async_wait<1>();          // tile kt has landed, kt + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    // the value tile is read by the tensor cores' (asynchronous) path
    if (!DEGREE) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile kt is visible to every warp
    const uint32_t zdesc = smem_u32(sz + 2 * buf * HALF_BYTES);

    uint32_t pa[2][FR][4];  // P of two consecutive 16-key steps: one feeds the tensor cores
#pragma unroll
    for (int ks = 0; ks < RK / 16; ++ks) {
      // A fragment: regs 0/1 = rows g/g+8 at keys ks*16 + 2t + {0,1},
      //             regs 2/3 = the same rows at keys ks*16 + 8 + 2t + {0,1}
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int j = ks * 16 + hi * 8 + t * 2;
        float2 fk[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f)
          fk[f] = *reinterpret_cast<const float2*>(&sF[buf][f][j]);
#pragma unroll
        for (int fr = 0; fr < FR; ++fr)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float d0 = 0.f, d1 = 0.f;  // -|f_i - f_j|^2 (scaled) for keys j, j + 1
#pragma unroll
            for (int f = 0; f < NF; ++f) {
              const float a0 = fq[fr][r][f] - fk[f].x, a1 = fq[fr][r][f] - fk[f].y;
              d0 = fmaf(-a0, a0, d0);
              d1 = fmaf(-a1, a1, d1);
            }
            const float p0 = ex2_approx(d0), p1 = ex2_approx(d1);
            if (DEGREE) rs[fr][r] += p0 + p1;
            else pa[ks & 1][fr][hi * 2 + r] = pack_bf16(p0, p1);
          }
      }
      if (!DEGREE) {
        // the product of this step runs while the next step's entries are computed
#pragma unroll
        for (int fr = 0; fr < FR; ++fr) fence_regs(acc[fr]);
        wgmma_fence();
#pragma unroll
        for (int fr = 0; fr < FR; ++fr)
          wgmma_pz<NT>(acc[fr], pa[ks & 1][fr],
                       smem_desc(zdesc + (ks >> 2) * HALF_BYTES) + 2 * (ks & 3));
        wgmma_commit();
        wgmma_wait<1>();  // the step before this one is done with its P registers
      }
    }
    if (!DEGREE) {
      wgmma_wait<0>();
#pragma unroll
      for (int fr = 0; fr < FR; ++fr) fence_regs(acc[fr]);
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  if (DEGREE) {
    // the four threads of a row group hold disjoint keys of the same rows
    float* o = static_cast<float*>(out);
#pragma unroll
    for (int fr = 0; fr < FR; ++fr)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = rs[fr][r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int row = row0 + fr * 64 + r * 8;
        if (t == 0 && row < n) o[b * so.b + row * so.n] = sum;
      }
    return;
  }
  // accumulator: acc[..][4 dn + {0,1}] = row g, channels dn*8 + 2t + {0,1}; [+2, +3] = row g+8
  const int cc = min(CP, c - c0);  // real channels of this chunk
#pragma unroll
  for (int fr = 0; fr < FR; ++fr)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + fr * 64 + r * 8;
      if (row >= n) continue;
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(out) + b * so.b + row * so.n + c0;
#pragma unroll
      for (int dn = 0; dn < NT; ++dn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = dn * 8 + t * 2 + e;
          if (ch < cc) orow[ch] = __float2bfloat16_rn(acc[fr][4 * dn + 2 * r + e]);
        }
    }
}

// The f32 kernel: the row-blocked loop of bilateral_rows_kernel on split
// TF32 operands. A thread computes the entries of keys 2 t and 2 t + 1 of
// each 8-key step for its 4 rows in float32, splits each into hi + lo in
// registers (the A fragment columns t and t + 4), and the step's product is
// 3 x wgmma.m64n(8 NT)k8 per 64-row tile: hi.hi, hi.lo, lo.hi against the
// value planes zt (hi) and zt + lo_offset (lo) of the f32 pack step. Tiles of
// FK = 64 keys, double buffered with cp.async; per buffer the values take
// [plane][half of 32 keys][channel][128 bytes] in the 128-byte swizzle, then
// the features [NF][FK].
constexpr int f32_smem_bytes(int nt) { return 1024 + 2 * 4 * nt * 8 * 128 + 2 * NF * FK * 4; }

template <int NT>
__global__ void __launch_bounds__(128, F32_MIN_BLOCKS)
bilateral_f32_rows_kernel(const float* __restrict__ ft, const float* __restrict__ zt,
                          float* __restrict__ out, long long zt_b, long long lo_offset, int np,
                          Strides so, int n, int c) {
  constexpr int CP = NT * 8;
  constexpr int HALF_BYTES = CP * 128;     // 32 keys of every channel, one plane
  constexpr int Z_BYTES = 4 * HALF_BYTES;  // a tile's values: two planes, two halves each
  constexpr int F_CHUNKS = NF * FK / 4;    // 16-byte pieces of a feature tile
  constexpr int P_CHUNKS = CP * FK / 4;    // 16-byte pieces of one value plane's tile
  // 8-key steps per wgmma commit group: two above 32 channels, where the
  // products dominate and fewer waits pay; one below, where the second set
  // of P registers costs more than it saves (both timed on an H100)
  constexpr int F_GROUP = NT > 4 ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sz = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float (*sF)[NF][FK] = reinterpret_cast<float (*)[NF][FK]>(sz + 2 * Z_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group / column pair
  const int b = blockIdx.z, c0 = blockIdx.y * CP;
  const float* fb = ft + b * (long long)NF * np;
  const float* zb = zt + b * zt_b + c0 * (long long)np;
  const int row0 = blockIdx.x * RQ + warp * 16 + g;  // rows row0 + 64 fr + 8 r

  float fq[FR][2][NF];
#pragma unroll
  for (int fr = 0; fr < FR; ++fr)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + fr * 64 + r * 8;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        fq[fr][r][f] = row < np ? fb[f * (long long)np + row] : PAD_FEATURE;
    }

  // one commit group per tile: its features and both value planes, into buffer `buf`
  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * FK;
    for (int i = tid; i < F_CHUNKS + 2 * P_CHUNKS; i += blockDim.x) {
      if (i < F_CHUNKS) {
        const int f = i / (FK / 4), part = (i % (FK / 4)) * 4;
        cp_async16(&sF[buf][f][part], fb + f * (long long)np + k0 + part);
      } else {
        // 4 keys of one channel of one plane: half kc / 8, 16-byte column kc % 8 swizzled by the row
        const int j = i - F_CHUNKS, plane = j / P_CHUNKS, ch = (j % P_CHUNKS) / (FK / 4);
        const int kc = j % (FK / 4);
        cp_async16(sz + buf * Z_BYTES + (2 * plane + (kc >> 3)) * HALF_BYTES + ch * 128 +
                       (((kc & 7) ^ (ch & 7)) << 4),
                   zb + plane * lo_offset + ch * (long long)np + k0 + kc * 4);
      }
    }
    cp_async_commit();
  };

  // the tensor cores truncate as they accumulate: each tile's product
  // starts from zero in `part` and is added into `acc` on the CUDA cores
  float acc[FR][4 * NT], part[FR][4 * NT];  // [n-tile][row g: 2, g+8: 2]
#pragma unroll
  for (int fr = 0; fr < FR; ++fr)
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) acc[fr][e] = 0.f;

  const int n_tiles = np / FK;
  load_tile(0, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load_tile(kt + 1, buf ^ 1);  // its buffer was released at the end of kt - 1
      cp_async_wait<1>();          // tile kt has landed, kt + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    // the value tile is read by the tensor cores' (asynchronous) path
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile kt is visible to every warp
    const uint32_t zdesc = smem_u32(sz + buf * Z_BYTES);
    // descriptor of plane pl (0 hi, 1 lo) at k-step ks
    auto desc = [&](int pl, int ks) {
      return smem_desc(zdesc + (2 * pl + (ks >> 2)) * HALF_BYTES) + 2 * (ks & 3);
    };

    // P of two consecutive groups of F_GROUP 8-key steps: one feeds the tensor cores
    uint32_t pa[2][F_GROUP][FR][2][4];  // [group parity][step][fr][hi, lo][A fragment register]
#pragma unroll
    for (int kg = 0; kg < FK / 8 / F_GROUP; ++kg) {
#pragma unroll
      for (int sub = 0; sub < F_GROUP; ++sub) {
        const int j = (kg * F_GROUP + sub) * 8 + t * 2;
        float2 fk[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) fk[f] = *reinterpret_cast<const float2*>(&sF[buf][f][j]);
#pragma unroll
        for (int fr = 0; fr < FR; ++fr)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float d0 = 0.f, d1 = 0.f;  // -|f_i - f_j|^2 (scaled) for keys j, j + 1
#pragma unroll
            for (int f = 0; f < NF; ++f) {
              const float a0 = fq[fr][r][f] - fk[f].x, a1 = fq[fr][r][f] - fk[f].y;
              d0 = fmaf(-a0, a0, d0);
              d1 = fmaf(-a1, a1, d1);
            }
            // register r: row g + 8 r at slot t (key 2 t); register 2 + r: slot t + 4 (key 2 t + 1)
            uint32_t (&p)[2][4] = pa[kg & 1][sub][fr];
            split_tf32(ex2_approx(d0), p[0][r], p[1][r]);
            split_tf32(ex2_approx(d1), p[0][2 + r], p[1][2 + r]);
          }
      }
      // the products of this group run while the next group's entries are computed
#pragma unroll
      for (int fr = 0; fr < FR; ++fr) fence_regs(part[fr]);
      wgmma_fence();
#pragma unroll
      for (int sub = 0; sub < F_GROUP; ++sub) {
        const int ks = kg * F_GROUP + sub;
#pragma unroll
        for (int fr = 0; fr < FR; ++fr) {
          const uint32_t (&p)[2][4] = pa[kg & 1][sub][fr];
          wgmma_tf32<NT>(part[fr], p[0], desc(0, ks), ks > 0);
          wgmma_tf32<NT>(part[fr], p[0], desc(1, ks), 1);
          wgmma_tf32<NT>(part[fr], p[1], desc(0, ks), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the group before this one is done with its P registers
    }
    wgmma_wait<0>();
#pragma unroll
    for (int fr = 0; fr < FR; ++fr) {
      fence_regs(part[fr]);
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) acc[fr][e] += part[fr][e];
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  // accumulator: acc[..][4 dn + {0,1}] = row g, channels dn*8 + 2t + {0,1}; [+2, +3] = row g+8
  const int cc = min(CP, c - c0);  // real channels of this chunk
#pragma unroll
  for (int fr = 0; fr < FR; ++fr)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + fr * 64 + r * 8;
      if (row >= n) continue;
      float* orow = out + b * so.b + row * so.n + c0;
#pragma unroll
      for (int dn = 0; dn < NT; ++dn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = dn * 8 + t * 2 + e;
          if (ch < cc) orow[ch] = acc[fr][4 * dn + 2 * r + e];
        }
    }
}

constexpr int CACHE_COLS = 16;                 // columns (bytes) a thread writes per row
constexpr int CACHE_THREADS = 128;             // 4 warps
constexpr int CACHE_WARPS = CACHE_THREADS / 32;
constexpr int CACHE_STRIP = 32 * CACHE_COLS;   // columns of a block: one warp's row piece
constexpr int CACHE_ROWS = 256;                // rows of a block
constexpr float ROUND_MAGIC = 12582912.f;      // 1.5 * 2^23: x + it is round(x) in the low bits

// The CACHE_COLS entries of one row at a thread's columns, 4 bytes a word
// (column order, little-endian): q the row's scaled features, fc the columns'.
__device__ __forceinline__ void cache_row(const float4 qa, const float q4,
                                          const float (&fc)[NF][CACHE_COLS],
                                          uint32_t (&w)[CACHE_COLS / 4]) {
#pragma unroll
  for (int c4 = 0; c4 < CACHE_COLS / 4; ++c4) {
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * c4 + e;
      float a = qa.x - fc[0][c], d = -a * a;  // -|f_i - f_j|^2 (scaled)
      a = qa.y - fc[1][c];
      d = fmaf(-a, a, d);
      a = qa.z - fc[2][c];
      d = fmaf(-a, a, d);
      a = qa.w - fc[3][c];
      d = fmaf(-a, a, d);
      a = q4 - fc[4][c];
      d = fmaf(-a, a, d);
      // low byte of the bits: round_half_even(127 k) (k <= 1)
      v[e] = __float_as_uint(fmaf(ex2_approx(d), 127.f, ROUND_MAGIC));
    }
    w[c4] = __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040),
                        0x5410);
  }
}

// [B, N, 5] features (strides sf) -> out [B, N, N] int8, contiguous and
// 16-byte aligned. Block (strip, row tile, image): CACHE_STRIP columns x
// CACHE_ROWS rows; warp w writes rows w, w + 4, ... of the tile.
__global__ void __launch_bounds__(CACHE_THREADS, 5)
bilateral_cache_int8_kernel(const float* __restrict__ feats, int8_t* __restrict__ out, Strides sf,
                            int n) {
  __shared__ float4 s_row[CACHE_ROWS][2];  // the tile's rows: f0-f3, f4
  // the strip's columns, [f][lane][16 + 4 padding floats]: a lane's 16 lie
  // in one piece, and the padding spreads the lanes' LDS.128 over the banks
  __shared__ float4 s_col[NF][32][CACHE_COLS / 4 + 1];
  const int b = blockIdx.z, r0 = blockIdx.y * CACHE_ROWS, c0 = blockIdx.x * CACHE_STRIP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* fb = feats + b * sf.b;
  // both staged with coalesced loads (consecutive threads, consecutive features)
  for (int i = threadIdx.x; i < CACHE_ROWS * NF; i += CACHE_THREADS) {
    const int r = i / NF, f = i % NF, row = r0 + r;
    reinterpret_cast<float*>(s_row[r])[f] = row < n ? fb[row * sf.n + f] * EX2_SCALE : 0.f;
  }
  for (int i = threadIdx.x; i < CACHE_STRIP * NF; i += CACHE_THREADS) {
    const int jj = i / NF, f = i % NF, j = c0 + jj;
    reinterpret_cast<float*>(s_col[f][jj / CACHE_COLS])[jj % CACHE_COLS] =
        j < n ? fb[j * sf.n + f] * EX2_SCALE : PAD_FEATURE;  // past n: entries 0, not written
  }
  __syncthreads();
  const int j0 = c0 + lane * CACHE_COLS;
  if (j0 >= n) return;

  float fc[NF][CACHE_COLS];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int q = 0; q < CACHE_COLS / 4; ++q) {
      const float4 v = s_col[f][lane][q];
      fc[f][4 * q] = v.x;
      fc[f][4 * q + 1] = v.y;
      fc[f][4 * q + 2] = v.z;
      fc[f][4 * q + 3] = v.w;
    }
  const int rows = min(CACHE_ROWS, n - r0);
  const long long row_step = static_cast<long long>(CACHE_WARPS) * n;
  int8_t* dst = out + (static_cast<long long>(b) * n + r0 + warp) * n + j0;
  uint32_t w[CACHE_COLS / 4];
  if (n % CACHE_COLS == 0 && j0 + CACHE_COLS <= n) {
    // every row piece whole and 16-byte aligned: one store each
    for (int r = warp; r < rows; r += CACHE_WARPS, dst += row_step) {
      cache_row(s_row[r][0], s_row[r][1].x, fc, w);
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int r = warp; r < rows; r += CACHE_WARPS, dst += row_step) {
      cache_row(s_row[r][0], s_row[r][1].x, fc, w);
#pragma unroll
      for (int c = 0; c < CACHE_COLS; ++c)
        if (j0 + c < n) dst[c] = static_cast<int8_t>(w[c >> 2] >> (8 * (c & 3)));
    }
  }
}

// The int8 cached message (the note at the top): its shapes and constants.

constexpr int MSG_FR = 2;         // m64 tiles of a product block
constexpr int MSG_ROWS = 64 * MSG_FR;  // its cache rows
constexpr int MSG_KEYS = 128;     // keys of a stage: a 128-byte swizzled line of each row
constexpr int MSG_STAGES = 4;     // the ring of stages in shared memory
constexpr int MSG_MIN_BLOCKS = 2;  // blocks per SM the registers are budgeted for
constexpr int MSG_MAX_CP = 64;    // channels of a product block (wgmma n64); more take grid.y
constexpr int MSG_MAX_N = 132104;  // n 128 127 < 2^31: the int32 sums cannot overflow
constexpr int QUANT_CLUSTER = 8;  // blocks of one image in the quantize kernel
constexpr int QUANT_KEYS = 256;   // keys of a quantize tile
constexpr int QUANT_THREADS = 1024;
constexpr int QUANT_PER_THREAD = QUANT_KEYS * 64 / QUANT_THREADS;  // elements of a tile a thread
static_assert(QUANT_THREADS == 64 * QUANT_KEYS / 16, "one 16-byte piece of a tile a thread");
constexpr float ZMAX_FLOOR = 0x1.79ca1p-67f;  // float(1e-20): clamp_min(1e-20)
constexpr float INV_127_SQ = 0x1.040c2p-14f;  // float(1) / float(16129), rounded to nearest

// the channels of a product block: 8 NT with NT = ceil(min(c, 64) / 8), as
// wgmma's s8 widths allow it (8, 16, 24, 32, 48, 64)
int message_nt(int c) {
  const int nt = (min(c, MSG_MAX_CP) + 7) / 8;
  return nt == 5 ? 6 : nt == 7 ? 8 : nt;
}

// the workspace: q8t [B, cpad, np] int8 (the quantized operand, channel-major,
// zero past n and c), then the rescale factors [B] float32 at a 16-byte offset
struct MessageLayout {
  int cp, chunks, cpad, np;
  long long q_bytes, bytes;
};

MessageLayout message_layout(int batch, int n, int c) {
  MessageLayout m;
  m.cp = 8 * message_nt(c);
  m.chunks = (c + m.cp - 1) / m.cp;
  m.cpad = m.chunks * m.cp;
  m.np = (n + MSG_KEYS - 1) / MSG_KEYS * MSG_KEYS;
  m.q_bytes = (static_cast<long long>(batch) * m.cpad * m.np + 15) / 16 * 16;
  m.bytes = m.q_bytes + 4ll * batch;
  return m;
}

// |x| as the bits of a float32 (an unsigned compare orders them, NaN above inf)
__device__ __forceinline__ uint32_t abs_bits(float x) { return __float_as_uint(x) & 0x7FFFFFFFu; }
__device__ __forceinline__ uint32_t abs_bits(unsigned short x) {
  return static_cast<uint32_t>(x & 0x7FFFu) << 16;
}
__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(unsigned short x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
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

// one box of a tensor map at (x, y, z) (a 2-d map ignores z), into `dst`, signalled on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// z [B, N, C] (float32 or bf16 bits, strides sz) -> q8t and rscale. A cluster
// of QUANT_CLUSTER blocks per image (grid (QUANT_CLUSTER, B)): each takes the
// |z| max of its tiles (QUANT_KEYS keys x 64 channels: thread t reads
// channel t % 64 of every 16th key, QUANT_PER_THREAD loads in flight), the
// cluster combines them through distributed shared memory, then each block
// quantizes its tiles into shared memory [channel][key] and writes them
// channel-major, 16 bytes a thread.
template <typename T>
__global__ void __cluster_dims__(QUANT_CLUSTER, 1, 1) __launch_bounds__(QUANT_THREADS)
int8_quantize_kernel(const T* __restrict__ z, Strides sz, int n, int c, int np, int cpad,
                     int8_t* __restrict__ q8t, float* __restrict__ rscale) {
  constexpr int ROWS = QUANT_THREADS / 64;  // keys a tile's threads read at once
  constexpr int PITCH = QUANT_KEYS + 8;     // bytes of a channel's row: 2-way bank conflicts
  __shared__ uint32_t s_warp[QUANT_THREADS / 32];
  __shared__ uint32_t s_part;
  __shared__ __align__(16) int8_t s_tile[64 * PITCH];  // [channel][key]
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int b = blockIdx.y, rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, ch = tid & 63, kr = tid >> 6;
  const T* zb = z + b * sz.b;
  const int groups = (c + 63) / 64;  // 64-channel groups of a tile
  // this thread's elements of tile t: channel c0 + ch of keys k0 + kr + ROWS u
  auto read_tile = [&](int t, T (&v)[QUANT_PER_THREAD]) {
    const int k0 = t / groups * QUANT_KEYS, c0 = t % groups * 64;
    const bool live = c0 + ch < c;
#pragma unroll
    for (int u = 0; u < QUANT_PER_THREAD; ++u) {
      const int key = k0 + kr + ROWS * u;
      v[u] = live && key < n ? zb[key * sz.n + c0 + ch] : T(0);
    }
  };
  T v[QUANT_PER_THREAD];

  uint32_t m = 0;
  const int real_tiles = (n + QUANT_KEYS - 1) / QUANT_KEYS * groups;
  for (int t = rank; t < real_tiles; t += QUANT_CLUSTER) {
    read_tile(t, v);
#pragma unroll
    for (int u = 0; u < QUANT_PER_THREAD; ++u) m = max(m, abs_bits(v[u]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) s_warp[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < QUANT_THREADS / 32; ++i) w = max(w, s_warp[i]);
    s_part = w;
  }
  cluster.sync();
  m = 0;
#pragma unroll
  for (int r = 0; r < QUANT_CLUSTER; ++r) m = max(m, *cluster.map_shared_rank(&s_part, r));
  cluster.sync();  // no block leaves while another reads its s_part

  // the parent's float32 arithmetic: zmax = clamp_min(amax |z|, 1e-20);
  // 127 / zmax as reciprocal(zmax) * 127; zmax / 16129 as zmax * (1 / 16129)
  float zmax = __uint_as_float(m);
  zmax = isnan(zmax) ? zmax : fmaxf(zmax, ZMAX_FLOOR);
  const float scale = __fmul_rn(__fdiv_rn(1.0f, zmax), 127.0f);
  if (rank == 0 && tid == 0) rscale[b] = __fmul_rn(zmax, INV_127_SQ);

  const int all_tiles = (np + QUANT_KEYS - 1) / QUANT_KEYS * groups;
  for (int t = rank; t < all_tiles; t += QUANT_CLUSTER) {
    const int k0 = t / groups * QUANT_KEYS, c0 = t % groups * 64;
    read_tile(t, v);
    __syncthreads();  // the tile before is written out
#pragma unroll
    for (int u = 0; u < QUANT_PER_THREAD; ++u)  // round half to even, |q| <= 127; 0 past n and c
      s_tile[ch * PITCH + kr + ROWS * u] =
          static_cast<int8_t>(__float2int_rn(__fmul_rn(as_float(v[u]), scale)));
    __syncthreads();
    const int row = tid / (QUANT_KEYS / 16), piece = tid % (QUANT_KEYS / 16) * 16;
    if (c0 + row < cpad && k0 + piece < np) {
      const uint2* src = reinterpret_cast<const uint2*>(s_tile + row * PITCH + piece);
      const uint2 lo = src[0], hi = src[1];
      *reinterpret_cast<uint4*>(q8t + (static_cast<long long>(b) * cpad + c0 + row) * np + k0 +
                                piece) = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
  }
}

// d[64 rows x 8 NT channels] += a[64 rows x 32 keys] . b[32 keys x 8 NT
// channels], both int8 K-major in shared memory (128-byte swizzle), int32 sums
template <int NT>
__device__ __forceinline__ void wgmma_s8(int (&d)[4 * NT], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_s8<1>(int (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<2>(int (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<3>(int (&d)[12], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "%12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<4>(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<6>(int (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<8>(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

constexpr int message_smem_bytes(int nt) {  // the alignment, the stages, their barriers
  return 1024 + MSG_STAGES * (MSG_ROWS + 8 * nt) * MSG_KEYS + 8 * MSG_STAGES;
}

// out[b, rows, c0:c0 + 8 NT] = (K8[b] @ q8[b]) * rscale[b] for a tile of
// MSG_ROWS rows (grid: row tile x channel chunk x image). One warpgroup; a
// ring of MSG_STAGES stages, each 128 keys of the tile's cache rows
// [row][key] and of the operand's lines [channel][key], 128-byte lines in
// the 128-byte swizzle. TMA (a row pitch of 16-byte multiples) loads them,
// one thread issuing each stage's two boxes; else cp.async, 4 bytes a copy
// (N % 4 = 0) or bytes through registers, every thread its share. Cache
// entries past n are never read: TMA fills them with zeros, and where
// cp.async leaves stale bytes they meet zeros of q8t (past n) or belong to
// rows that are not stored. Epilogue: int32 -> float32 (round to nearest)
// times rscale, cast to bf16 (nearest even) or kept float32, rows < n and
// channels < c only.
template <int NT, bool TMA>
__global__ void __launch_bounds__(128, MSG_MIN_BLOCKS)
int8_message_kernel(const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_q, const int8_t* __restrict__ kmat,
                    const int8_t* __restrict__ q8t, const float* __restrict__ rscale,
                    void* __restrict__ out, Strides so, int n, int c, int np, int cpad, int align,
                    int out_bf16) {
  constexpr int CP = 8 * NT;
  constexpr int A_BYTES = MSG_ROWS * MSG_KEYS, STAGE = A_BYTES + CP * MSG_KEYS;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: the stages start there
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, c0 = blockIdx.y * CP, r0 = blockIdx.x * MSG_ROWS;
  const int n_stages = np / MSG_KEYS;

  int acc[MSG_FR][4 * NT];
#pragma unroll
  for (int fr = 0; fr < MSG_FR; ++fr)
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) acc[fr][e] = 0;

  // the products of the stage in `slot`, waited for
  auto multiply = [&](int slot) {
    const uint32_t a = smem_u32(sm + slot * STAGE), bq = a + A_BYTES;
#pragma unroll
    for (int fr = 0; fr < MSG_FR; ++fr) fence_regs(acc[fr]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < MSG_KEYS / 32; ++ks)
#pragma unroll
      for (int fr = 0; fr < MSG_FR; ++fr)
        wgmma_s8<NT>(acc[fr], smem_desc(a + fr * 64 * MSG_KEYS) + 2 * ks, smem_desc(bq) + 2 * ks);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int fr = 0; fr < MSG_FR; ++fr) fence_regs(acc[fr]);
  };

  if constexpr (TMA) {
    // the cache as [B][N rows][N keys], the operand as [B cpad][np]: TMA
    // fills what lies past n with zeros and reads none of it
    const uint32_t full = smem_u32(sm + MSG_STAGES * STAGE);
    auto load_stage = [&](int s, int slot) {
      const uint32_t dst = smem_u32(sm + slot * STAGE), bar = full + 8 * slot;
      mbar_expect_tx(bar, STAGE);
      tma_load_3d(dst, &map_k, bar, s * MSG_KEYS, r0, b);
      tma_load_2d(dst + A_BYTES, &map_q, bar, s * MSG_KEYS, b * cpad + c0);
    };
    if (tid == 0) {
      for (int s = 0; s < MSG_STAGES; ++s) mbar_init(full + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < MSG_STAGES && s < n_stages; ++s) load_stage(s, s);
    }
    __syncthreads();
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % MSG_STAGES;
      mbar_wait(full + 8 * slot, (s / MSG_STAGES) & 1);
      multiply(slot);
      __syncthreads();  // every warp is done with the slot before it is refilled
      if (tid == 0 && s + MSG_STAGES < n_stages) load_stage(s + MSG_STAGES, slot);
    }
  } else {
    const int8_t* kb = kmat + static_cast<long long>(b) * n * n;
    const int8_t* qb = q8t + (static_cast<long long>(b) * cpad + c0) * np;
    // one commit group per stage: its cache rows and operand lines, into `slot`
    auto load = [&](int s, int slot) {
      uint8_t* sa = sm + slot * STAGE;
      const int k0 = s * MSG_KEYS;
      for (int i = tid; i < MSG_ROWS * 8; i += 128) {
        // 16 keys of one row: 16-byte column kc swizzled by the row
        const int r = i >> 3, kc = i & 7, row = r0 + r, key = k0 + kc * 16;
        if (row >= n || key >= n) continue;
        uint8_t* dst = sa + r * 128 + ((kc ^ (r & 7)) << 4);
        const int8_t* src = kb + static_cast<long long>(row) * n + key;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (align == 4) {
            if (key + 4 * q < n) cp_async4(dst + 4 * q, src + 4 * q);
            continue;
          }
          uint32_t w = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key + 4 * q + e < n)
              w |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + 4 * q + e))) << (8 * e);
          *reinterpret_cast<uint32_t*>(dst + 4 * q) = w;
        }
      }
      for (int i = tid; i < CP * 8; i += 128) {
        const int ch = i >> 3, kc = i & 7;
        cp_async16(sa + A_BYTES + ch * 128 + ((kc ^ (ch & 7)) << 4),
                   qb + static_cast<long long>(ch) * np + k0 + kc * 16);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < MSG_STAGES - 1; ++s) {
      if (s < n_stages) load(s, s);
      else cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait<MSG_STAGES - 2>();  // stage s has landed
      // the stage is read by the tensor cores' (asynchronous) path
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // stage s is visible to every warp; stage s - 1's slot is free
      const int next = s + MSG_STAGES - 1;
      if (next < n_stages) load(next, next % MSG_STAGES);
      else cp_async_commit();
      multiply(s % MSG_STAGES);
    }
  }

  // accumulator: acc[..][4 dn + {0,1}] = row g, channels dn*8 + 2t + {0,1}; [+2, +3] = row g+8
  const float r = rscale[b];
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int fr = 0; fr < MSG_FR; ++fr)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + fr * 64 + warp * 16 + g + 8 * h;
      if (row >= n) continue;
      const long long o = b * so.b + row * so.n;
#pragma unroll
      for (int dn = 0; dn < NT; ++dn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = c0 + dn * 8 + 2 * t + e;
          if (ch >= c) continue;
          const float v = __fmul_rn(__int2float_rn(acc[fr][4 * dn + 2 * h + e]), r);
          if (out_bf16) static_cast<__nv_bfloat16*>(out)[o + ch] = __float2bfloat16_rn(v);
          else static_cast<float*>(out)[o + ch] = v;
        }
    }
}

// libcuda's tensor-map encoder, fetched from the already loaded library (the
// kernels link against the CUDA runtime only)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// a byte tensor of `rank` dims (innermost first; byte strides of the outer
// ones) in boxes of `box`, 128-byte swizzle, zeros past its extent
bool encode_bytes(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t elem[3] = {1, 1, 1};
  const EncodeTiledFn fn = encode_tiled();
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT>
cudaError_t launch_message(const int8_t* kmat, const int8_t* q8t, const float* rs, void* out,
                           const MessageLayout& m, Strides so, int batch, int n, int c, int align,
                           int out_bf16, cudaStream_t st) {
  constexpr int CP = 8 * NT;
  CUtensorMap map_k{}, map_q{};
  const bool tma = align == 16;
  if (tma) {
    const cuuint64_t kdims[3] = {cuuint64_t(n), cuuint64_t(n), cuuint64_t(batch)};
    const cuuint64_t kstrides[2] = {cuuint64_t(n), cuuint64_t(n) * n};
    const cuuint32_t kbox[3] = {MSG_KEYS, MSG_ROWS, 1};
    const cuuint64_t qdims[2] = {cuuint64_t(m.np), cuuint64_t(batch) * m.cpad};
    const cuuint64_t qstrides[1] = {cuuint64_t(m.np)};
    const cuuint32_t qbox[2] = {MSG_KEYS, CP};
    if (!encode_bytes(&map_k, kmat, 3, kdims, kstrides, kbox) ||
        !encode_bytes(&map_q, q8t, 2, qdims, qstrides, qbox))
      return cudaErrorInvalidValue;
  }
  auto kernel = tma ? int8_message_kernel<NT, true> : int8_message_kernel<NT, false>;
  // per launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, message_smem_bytes(NT));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + MSG_ROWS - 1) / MSG_ROWS, m.chunks, batch);
  kernel<<<grid, 128, message_smem_bytes(NT), st>>>(map_k, map_q, kmat, q8t, rs, out, so, n, c,
                                                    m.np, m.cpad, align, out_bf16);
  return cudaGetLastError();
}

template <int NT>
void launch_bf16(const float* ft, const __nv_bfloat16* zt, __nv_bfloat16* out,
                 const Packed& p, Strides so, int batch, int n, int c, cudaStream_t st) {
  const dim3 grid((p.np + RQ - 1) / RQ, p.cpad / p.cp, batch);
  bilateral_rows_kernel<NT, false><<<grid, 128, rows_smem_bytes(NT, false), st>>>(
      ft, zt, out, static_cast<long long>(p.cpad) * p.np, p.np, so, n, c);
}

template <int NT>
void launch_f32(const float* ft, const float* zt, float* out, const Packed& p, Strides so,
                int batch, int n, int c, cudaStream_t st) {
  // per launch: the attribute belongs to the current device
  if (cudaFuncSetAttribute(bilateral_f32_rows_kernel<NT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           f32_smem_bytes(NT)) != cudaSuccess)
    return;  // the launch below then fails and cudaGetLastError() reports it
  const dim3 grid((p.np + RQ - 1) / RQ, p.cpad / p.cp, batch);
  bilateral_f32_rows_kernel<NT><<<grid, 128, f32_smem_bytes(NT), st>>>(
      ft, zt, out, static_cast<long long>(p.cpad) * p.np, p.plane, p.np, so, n, c);
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

// The message entries take feats [B, N, 5] float32 and values / out [B, N, C]
// in one dtype (bf16 or float32), with element strides (x_sb, x_sn) of image
// and point and a contiguous last axis, and launch on `stream`. Every
// entry (the degree entry too: out [B, N, 1] float32 = K . 1) also takes a
// device workspace of depthg_bilateral_workspace_bytes (mode 0: float32
// message; 1: bf16 message; 2: degree) for its packed operands. They return
// cudaErrorInvalidValue for a shape the grid cannot cover, else
// cudaGetLastError() (0 = launched). Dtypes, devices and the contiguous last
// axis are validated by the Python wrapper
// (depthg_tpu_torch/ops/crf_bilateral.py).
static bool bad_shape(int batch, int n, int c) {
  return batch < 1 || batch > 65535 || n < 1 || n > 2147483647 - 2 * RQ || c < 1 ||
         c > MAX_C;
}

extern "C" long long depthg_bilateral_workspace_bytes(int batch, int n, int c, int mode) {
  if (mode < 0 || mode > 2 || bad_shape(batch, n, mode == 2 ? 1 : c)) return 0;
  return packed_layout(batch, n, mode == 2 ? 0 : c, mode == 0 ? 8 : 2).bytes;
}

// packs feats (and values, when z is given) into the workspace; returns the values' half
static const __nv_bfloat16* pack_operands(const void* feats, const void* z, void* workspace,
                                          const Packed& p, Strides sf, Strides sz, int batch,
                                          int n, int c, cudaStream_t st) {
  float* ft = static_cast<float*>(workspace);
  unsigned short* zt =
      reinterpret_cast<unsigned short*>(static_cast<char*>(workspace) + p.feat_bytes);
  pack_feats_kernel<<<dim3((p.np + 255) / 256, batch), 256, 0, st>>>(
      static_cast<const float*>(feats), ft, sf, n, p.np);
  if (z)
    pack_values_kernel<<<dim3(p.np / PT, (p.cpad + PT - 1) / PT, batch), dim3(PT, 8), 0, st>>>(
        static_cast<const unsigned short*>(z), zt, sz, n, c, p.np, p.cpad);
  return reinterpret_cast<const __nv_bfloat16*>(zt);
}

extern "C" int depthg_bilateral_message_bf16(
    const void* feats, const void* z, void* out, void* workspace, long long f_sb,
    long long f_sn, long long z_sb, long long z_sn, long long o_sb, long long o_sn,
    int batch, int n, int c, void* stream) {
  if (bad_shape(batch, n, c)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sf{f_sb, f_sn}, sz{z_sb, z_sn}, so{o_sb, o_sn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Packed p = packed_layout(batch, n, c, 2);
  const __nv_bfloat16* zt = pack_operands(feats, z, workspace, p, sf, sz, batch, n, c, st);
  DEPTHG_DISPATCH_NT(c, launch_bf16, static_cast<const float*>(workspace), zt,
                     static_cast<__nv_bfloat16*>(out), p, so, batch, n, c, st)
  return static_cast<int>(cudaGetLastError());
}

extern "C" int depthg_bilateral_degree(
    const void* feats, void* out, void* workspace, long long f_sb, long long f_sn,
    long long o_sb, long long o_sn, int batch, int n, void* stream) {
  if (bad_shape(batch, n, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sf{f_sb, f_sn}, so{o_sb, o_sn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Packed p = packed_layout(batch, n, 0, 2);
  pack_operands(feats, nullptr, workspace, p, sf, sf, batch, n, 0, st);
  bilateral_rows_kernel<1, true>
      <<<dim3((p.np + RQ - 1) / RQ, 1, batch), 128, rows_smem_bytes(1, true), st>>>(
      static_cast<const float*>(workspace), nullptr, out, 0, p.np, so, n, 1);
  return static_cast<int>(cudaGetLastError());
}

// The int8 kernel cache: feats [B, N, 5] float32 (element strides f_sb,
// f_sn, contiguous last axis) -> out [B, N, N] int8, contiguous and 16-byte
// aligned, every byte written; no workspace. The return value is that of
// the message entries.
extern "C" int depthg_bilateral_cache_int8(const void* feats, void* out, long long f_sb,
                                           long long f_sn, int batch, int n, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || (n + CACHE_ROWS - 1) / CACHE_ROWS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + CACHE_STRIP - 1) / CACHE_STRIP, (n + CACHE_ROWS - 1) / CACHE_ROWS, batch);
  bilateral_cache_int8_kernel<<<grid, CACHE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<int8_t*>(out), Strides{f_sb, f_sn}, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int depthg_bilateral_message_f32(
    const void* feats, const void* z, void* out, void* workspace, long long f_sb,
    long long f_sn, long long z_sb, long long z_sn, long long o_sb, long long o_sn,
    int batch, int n, int c, void* stream) {
  if (bad_shape(batch, n, c)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sf{f_sb, f_sn}, sz{z_sb, z_sn}, so{o_sb, o_sn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Packed p = packed_layout(batch, n, c, 8);
  pack_operands(feats, nullptr, workspace, p, sf, sf, batch, n, 0, st);  // the features
  float* zt = reinterpret_cast<float*>(static_cast<char*>(workspace) + p.feat_bytes);
  pack_values_f32_kernel<<<dim3(p.np / PT, (p.cpad + PT - 1) / PT, batch), dim3(PT, 8), 0, st>>>(
      static_cast<const float*>(z), zt, sz, n, c, p.np, p.cpad, p.plane);
  DEPTHG_DISPATCH_NT(c, launch_f32, static_cast<const float*>(workspace), zt,
                     static_cast<float*>(out), p, so, batch, n, c, st)
  return static_cast<int>(cudaGetLastError());
}

// The int8 cached message: kmat [B, N, N] int8, contiguous (row pitch N);
// z [B, N, C] float32 (z_bf16 = 0) or bf16 (1) and out [B, N, C] float32
// (out_bf16 = 0) or bf16 (1), element strides (x_sb, x_sn) of image and
// point, contiguous last axis; a workspace of
// depthg_int8_message_workspace_bytes. Two launches on `stream`: the
// quantize kernel, then the product. The return value is that of the message
// entries (cudaErrorInvalidValue for a shape it does not take).
static bool bad_message_shape(int batch, int n, int c) {
  return batch < 1 || batch > 65535 || n < 1 || n > MSG_MAX_N || c < 1 ||
         (c + MSG_MAX_CP - 1) / MSG_MAX_CP > 65535;
}

extern "C" long long depthg_int8_message_workspace_bytes(int batch, int n, int c) {
  return bad_message_shape(batch, n, c) ? 0 : message_layout(batch, n, c).bytes;
}

extern "C" int depthg_int8_message(const void* kmat, const void* z, void* out, void* workspace,
                                   long long z_sb, long long z_sn, long long o_sb, long long o_sn,
                                   int batch, int n, int c, int z_bf16, int out_bf16,
                                   void* stream) {
  if (bad_message_shape(batch, n, c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MessageLayout m = message_layout(batch, n, c);
  int8_t* q8t = static_cast<int8_t*>(workspace);
  float* rs = reinterpret_cast<float*>(static_cast<char*>(workspace) + m.q_bytes);
  const Strides sz{z_sb, z_sn}, so{o_sb, o_sn};
  const dim3 qgrid(QUANT_CLUSTER, batch);
  if (z_bf16)
    int8_quantize_kernel<unsigned short><<<qgrid, QUANT_THREADS, 0, st>>>(
        static_cast<const unsigned short*>(z), sz, n, c, m.np, m.cpad, q8t, rs);
  else
    int8_quantize_kernel<float><<<qgrid, QUANT_THREADS, 0, st>>>(
        static_cast<const float*>(z), sz, n, c, m.np, m.cpad, q8t, rs);
  const uintptr_t base = reinterpret_cast<uintptr_t>(kmat);
  const int align = n % 16 == 0 && base % 16 == 0 ? 16 : n % 4 == 0 && base % 4 == 0 ? 4 : 1;
  const int8_t* k8 = static_cast<const int8_t*>(kmat);
  const cudaError_t qerr = cudaGetLastError();
  if (qerr != cudaSuccess) return static_cast<int>(qerr);
  cudaError_t err;
  switch (message_nt(c)) {
    case 1: err = launch_message<1>(k8, q8t, rs, out, m, so, batch, n, c, align, out_bf16, st); break;
    case 2: err = launch_message<2>(k8, q8t, rs, out, m, so, batch, n, c, align, out_bf16, st); break;
    case 3: err = launch_message<3>(k8, q8t, rs, out, m, so, batch, n, c, align, out_bf16, st); break;
    case 4: err = launch_message<4>(k8, q8t, rs, out, m, so, batch, n, c, align, out_bf16, st); break;
    case 6: err = launch_message<6>(k8, q8t, rs, out, m, so, batch, n, c, align, out_bf16, st); break;
    default: err = launch_message<8>(k8, q8t, rs, out, m, so, batch, n, c, align, out_bf16, st);
  }
  return static_cast<int>(err);
}
