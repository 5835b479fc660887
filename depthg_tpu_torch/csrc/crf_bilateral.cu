// Streaming bilateral message of the dense CRF for Hopper (sm_90a), and the
// kernel that builds its int8 kernel cache (at the end of this note).
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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
