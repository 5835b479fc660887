// Masked non-causal softmax attention for Hopper (sm_90a), head_dim 64.
//
// Replaces three TPU kernels of depthg_tpu, which all compute
//     o = softmax(q k^T * scale + bias[h]) v   with keys j >= n_valid weighted 0
// and query rows i >= n_valid written as exact zeros:
//   * ops/attention.py whole_kv_mha_qkv (_whole_kv_pair_kernel, _attend):
//     packed [B, N, 3D] qkv in, token-major [B, N, D] out;
//   * ops/attention.py whole_kv_mha (_whole_kv_kernel): split [B, H, N, HD];
//   * models/vit.py _flash_mha (the Pallas TPU flash kernel, segment ids).
// Every operand is addressed through (batch, head, token) strides with a
// contiguous head_dim, so the packed and the split layouts are both views.
// The bias is optional (BEiT's relative-position bias, [H, N, N], the same
// for every image, bf16 or float32): read in its own dtype and added to the
// float32 logits after the scale, before the n_valid mask and the row max,
// so keys >= n_valid still weigh exactly 0 whatever it holds there.
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
//   * 256 rows per block where the grid fills the card: every block streams
//     the whole K/V of its head from L2, so rows per block set that
//     traffic. At the eval shape, with one sub-tile per warpgroup (128 rows,
//     1248 blocks) the kernel took 0.188-0.204 ms on an H100, with two (672
//     blocks) 0.161 ms. Three consumer warpgroups of one sub-tile each (192
//     rows) took 0.213 ms: the registers left per thread (128 at 512
//     threads) no longer hold S, P and O without spills. A 128-row block
//     takes 0.59 of a 256-row block's time (B=1, N=1536, 6 heads, one wave:
//     0.0174 against 0.0299 ms; NVIDIA H100 80GB HBM3, 700.00 W), so where
//     256-row blocks leave SMs idle, 128-row ones win (Grid, below).
//   * Masking: logits of keys >= n_valid are set to -inf in registers on
//     the last tile (their V rows are zeros from the TMA fill, so 0 * 0);
//     query rows >= n_valid are written as zeros. The output goes through
//     the warp's own 16 rows of the (now free) Q tile and leaves as 16-byte
//     plain stores; no TMA store touches the edge. Where the block's second
//     128 rows hold no valid row, both warpgroups walk one sub-tile only
//     and then write that round's rows < N as zeros (with or without a
//     bias): the output comes from torch.empty, so a row nobody writes
//     would keep what the memory held. Written after the walk and not
//     before it, the zeros hold up no product: bf16 B=2, N=769,
//     n_valid=640 with a bias took 0.0193 ms against 0.0200 with the
//     zeros first (attention_contract_study.py; NVIDIA H100 80GB HBM3,
//     700.00 W). Where every block's second round holds a row < n_valid,
//     as at the eval shape, the loop stores nothing.
//   * Grid: one-dimensional (bf16_block): `big` blocks of 256 rows per
//     (image, head) first, then 128-row blocks over the rest of its rows.
//     A block takes 161 KB of shared memory and 63 K registers, so one fits
//     per SM and the card hands blocks to SMs in launch order; the wrapper
//     (ops/attention.py block_plan) dispatches each choice of `big` on the
//     SMs in a model of that and takes the one that finishes first, if it
//     beats every block at 256 rows by 10%. At the eval shape that is 7 x
//     16 x 6 = 672 blocks of 256 rows (5.1 waves, the seventh of each head
//     65 rows). At the serving buckets' smaller grids (N=1601, 6 heads;
//     queued ms, the parent's grid in brackets; NVIDIA H100 80GB HBM3,
//     700.00 W; attention_contract_study.py): B=1 78 blocks of 128 rows in
//     one wave, 0.0186 (0.0323); B=4 5 of 256 a head and the rest of 128,
//     192 blocks, 0.0495 (0.0628); B=8 the same, 384 blocks, 0.0845
//     (0.0968); MiDaS (B=8, N=769, 16 heads) 3 of 256 a head and its
//     one-row block after all of them, 0.0719 (0.0779). B=2 (84 blocks),
//     B=16, B=32 and the train step keep every block at 256 rows.
//   * What holds it (timed on an H100 with parts of the loop compiled out):
//     the loads alone take 0.046 ms, both products without the softmax
//     0.096 ms, the softmax without the products 0.119 ms (0.086 ms without
//     its ex2s), everything 0.161 ms: the softmax's ~5 issue slots per logit
//     (max, scale-subtract FMA, ex2, row sum, half a bf16x2 pack, the
//     rescale of O) beside the 8 clocks a warp's ex2 holds the MUFU are the
//     largest part, and a warpgroup's own softmax and products still run
//     one after the other. Later work: a second S accumulator so a
//     warpgroup overlaps with itself, the row sum taken from the P V product
//     (a ones column in V), a persistent block per SM.
//   * The bias (template argument BIAS: none, bf16, float32; BEiT-L's
//     relative-position bias): the step's S accumulator starts as the bias
//     instead of zero, and the q.k^T wgmma accumulates onto it. The bias
//     comes through TMA: the C entry encodes a tensor map over the caller's
//     [H, N, N] view (extent n_valid in rows and keys, so nothing past
//     n_valid is read: it arrives as zeros; boxes of 64 rows x 128 bytes in
//     the 128-byte swizzle), and a second thread of the producer warpgroup
//     brings each step's [64 rows x 128 keys] tile, in the order the
//     consumers take the steps, into a 64 KB ring after the K/V stages (4
//     slots of bf16, 2 of float32; the block takes 225 KB). A consumer
//     reads its fragment from the slot right after packing P (bf16: 8
//     ldmatrix.x4 a step; a row's 16-byte chunks sit at chunk ^ (row & 7),
//     so each 8 x 8 matrix's rows fall on all 32 banks) and releases the
//     slot once the product that starts from it has completed. Released
//     right after the loads, a slot took the next tile's TMA before the
//     loads had read it: wrong outputs, the more often the fewer slots.
//   * What the bias costs, split with parts compiled out by
//     depthg_tpu_torch/attention_bias_study.py (NVIDIA H100 80GB HBM3,
//     700.00 W; bf16 B=8, N=769, 16 heads; queued; medians of 7 rounds):
//     the first design, each thread loading its fragment from global
//     memory (32 loads of 4 bytes a step, a quad on half of each 32-byte
//     sector), took 0.1315 ms against 0.0777 without the bias; 0.032 ms of
//     that were the loads, 0.021 the fragment itself (64 more instructions a
//     step beside the softmax's ~320, which bounds the loop). Staged through
//     TMA: 0.0935 ms; with ldmatrix for the bf16 fragment 0.091. One tile for
//     several images was not taken: a variant whose every step reads its
//     head's first tile (no bias traffic left) took 0.0931 against 0.0935
//     ms, so sharing tiles between images cannot pay in bf16.
//   * The tails at BEiT's token counts, with a bias. N = 769 = 3 x 256 + 1
//     leaves each (image, head) a block with one valid row: warpgroup 0
//     walks it alone, without turns, and warpgroup 1 writes its zeros and
//     leaves (these blocks alone 0.0188 -> 0.0130 ms). N = 6 x 128 + 1
//     leaves one key in the last tile: its products and softmax cover only
//     the chunks that hold a key < n_valid, as 16, 32 or 64 keys
//     (m64nNk16; N / 16 P V k-steps): 0.0935 -> 0.0877 ms, the same bits.
//     Sub-tiles a warpgroup does not walk hold no row < n_valid and are
//     written as zeros. All told (chip_smoke.py, the parent tree in the
//     same run), bf16 B=8 0.1313-0.1321 -> 0.0880-0.0882 ms (0.0773-0.0778
//     without the bias, 0.285 for PyTorch's fused attention call with the
//     bias as its mask), the same bits; a ZoeDepth batch of 8 at 384 x 512
//     82.33 -> 80.67 ms (attention_bias_study.py --depth).
//     Without a bias the one-warpgroup block is taken (MiDaS B=8,
//     N=769 0.0726 -> 0.0715 ms, train B=32, N=785 0.1084 -> 0.1068), the
//     narrow tile is not: with it in the kernel the whole bias-free loop ran
//     slower (MiDaS 0.0832, train 0.1252; the same with S zeroed before the
//     narrow product, 0.0831 / 0.1250). As runtime branches, the two cost
//     the bias-free loop a third of its speed at every shape, taken or not
//     (B=1, N=1601 0.0321 -> 0.0430 ms): LC (the last tile's live chunks)
//     and ALONE (the launch has a one-warpgroup block) are template
//     arguments of the kernel, which the C entry picks, so a launch without
//     a tail runs the loop with no code of theirs. (NVIDIA H100 80GB HBM3,
//     700.00 W; attention_contract_study.py --sections variants.)
//   * The grid runs the images of one head together, (query blocks, batch,
//     heads) in launch order, so a wave of blocks shares a few heads' bias
//     in L2 (16 x 769 x 769 bf16 is 18.9 MB at the ZoeDepth shape). Against (query blocks,
//     heads, batch), timed by a one-off study that built both orders
//     (NVIDIA H100 80GB HBM3, 700 W; same bits; queued; median of 15
//     rounds): on the first bias design 1.4-2.3% faster with the bias (bf16
//     B=8 0.1326 against 0.1346 ms, B=16 0.2345 / 0.2400, f32 B=2 0.4261 /
//     0.4322); on the staged one level to within 1% in bf16 (B=8 0.0883 /
//     0.0881, B=16 0.1588 / 0.1575) and 3.7% faster in float32 (B=2 0.0855 /
//     0.0888); without a bias level (N=769 B=8 0.0774 / 0.0774, f32 0.0803 /
//     0.0801; N=1601, 6 heads, B=2 0.0324 / 0.0323, B=16 0.1604 / 0.1603,
//     B=32 0.3115 / 0.3122), so both paths keep it. The wrapper requires
//     head and row strides that are multiples of 8 elements and a 16-byte
//     aligned base, which the bias's tensor map needs (16-byte strides and
//     base).
//
// Design of the float32 kernel (attn_f32_wgmma_kernel, split TF32):
//   * What bounds it: the same 4 B H N^2 64 operations, which the FMA pipes
//     do at 67 TFLOP/s (1.81 ms at the KNN embedding's B=128, N=785, 6
//     heads). The tensor cores take float32 only as TF32 (10 mantissa bits:
//     a product off by ~4e-4, against the 1e-5 the float32 path is held
//     to), so every operand x is split as hi = tf32(x), lo = tf32(x - hi)
//     (cvt.rna; |x - hi - lo| <= 2^-21 |x|) and each product is taken as
//     hi.hi + hi.lo + lo.hi with float32 accumulation ("3xTF32"): three
//     products at 495 TFLOP/s, an effective 165, 0.73 ms at that shape.
//     tests/test_torch_f32_split.py emulates this arithmetic on the CPU
//     (against JAX and float64: ~9e-7 relative at full width, one TF32
//     product alone 4e-4).
//   * A pack kernel (attn_pack_f32_kernel) first writes, per key tile of 64
//     and (image, head), K and V as split TF32 operands into a workspace,
//     already in the 128-byte swizzle of shared memory: K [key][dim] and V
//     transposed to [dim][key], since TF32 wgmma takes B only K-major and
//     TMA does not transpose. Keys >= n_valid are zeros there and are never
//     read from the caller's tensors. Along each product's K axis the pack
//     step stores slot t of a group of 8 as element 2 t and slot t + 4 as
//     element 2 t + 1: the S accumulator holds keys 2 t, 2 t + 1 where a TF32
//     A fragment wants columns t, t + 4, so P goes from S to the next A
//     operand without shuffles, and q's fragment is one float2 load.
//   * The attention kernel keeps the bf16 kernel's shape: one producer warp
//     brings each 64 KB tile (K hi/lo, V^T hi/lo) with two bulk copies into
//     a ring of 3 stages; two consumer warpgroups (240 registers) own 64
//     query rows each, with q * scale split into registers (64), S (32), P
//     hi/lo (64) and O (32). Per tile: S = 24 x wgmma.m64n64k8.tf32 (the
//     bias as its starting value, from a 32 KB ring of [64 rows x 64 keys]
//     tiles that a second producer thread fills through TMA, as in bf16:
//     4 slots of bf16, 2 of float32), the online softmax with
//     ex2.approx.ftz and the LOG2E FMA (2 ulp: inside the limits in the
//     emulation), P split in registers, and the tile's P V as 24 more into
//     the S registers, from zero, folded in as O = O * alpha + P V (one
//     FMA). The tensor cores truncate as they accumulate: with O carried in
//     the wgmma accumulator over all 26 tiles of N=1601, the first version
//     was 1.19e-5 relative from the plain version (NVIDIA H100 80GB HBM3,
//     700 W), past the 1e-5 limit. A warpgroup runs its products and its
//     softmax in turn; the two warpgroups overlap each other's. Keys >=
//     n_valid get -inf on the last tile, query rows >= n_valid are written
//     as zeros, and a warpgroup whose rows are all >= n_valid writes its
//     zeros and leaves.
//   * Times (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, device ms queued
//     behind a long product; the one-thread-per-row FMA kernel it replaced
//     and the library call in brackets): KNN B=128, N=785 1.436-1.464 ms
//     (6.57-6.61; 3.99), train B=32, N=785 0.384-0.385 (1.84-1.89; 1.04),
//     eval B=16, N=1601 0.635-0.638 (3.18-3.20 through attention_qkv;
//     2.06), BEiT-L's bias f32 B=2, N=769 0.102 (0.426; 0.303-0.311), and
//     with the bias staged through TMA 0.0844-0.0857, 0.0792-0.0798 without;
//     B=1, N=1201 (a fine-tune validation image, 160 blocks: two waves)
//     0.1327 -> 0.1105-0.1117, 0.0963-0.0969 without. Its per-thread loads were
//     all of the first design's bias cost there (0.036 ms: the next tile's
//     S waited on them); a variant that reads one tile throughout takes
//     0.1001, so a third of what is left is the float32 bias's own traffic
//     (92 MB at N=1201, more than L2 holds).
//     Its bound is that of its split products, 0.734 ms at the KNN shape,
//     0.184 train, 0.382 eval (the FMA pipes' 1.81 / 0.45 / 0.94 ms is a
//     yardstick only): it runs at 50%, 48% and 59% of it. Apart
//     (torch.profiler in chip_smoke.py), the pack step takes 0.337 / 0.085
//     / 0.088 ms (K and V read, twice their bytes written: ~0.96 GB at the
//     KNN shape, near the HBM rate) and the attention kernel 1.126 / 0.292 /
//     0.564 ms (63-68% of the bound). Converting TMA'd float32 tiles inside
//     the kernel would save the pack step's 13-23%.

#include <cuda.h>  // CUtensorMap types only; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int HD = 64;       // head dim
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, n;  // element strides of batch, head, token
};

// The grid is (query blocks, batch, heads), x fastest: the images of one
// head run together, so a wave of blocks shares a few heads' bias in L2.
__device__ __forceinline__ void head_and_image(int& h, int& b) { h = blockIdx.z; b = blockIdx.y; }
static dim3 grid_of(int q_blocks, int batch, int heads) { return dim3(q_blocks, batch, heads); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
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
// With a bias, each step's [64 rows x WK keys] bias tile comes through TMA
// into a ring of slots after the K/V ring, as boxes of 64 rows x 128 bytes
// (128-byte swizzle), with 128 more bytes for the ring's barriers.
constexpr int BIAS_BOX_BYTES = 64 * 128;
constexpr int W_BIAS_RING = 64 * 1024;
template <int BIAS>
constexpr int W_SMEM_OF = BIAS ? W_SMEM + W_BIAS_RING + 128 : W_SMEM;

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

// one bias box (128 bytes of keys x 64 rows) at (key0, row0, head h)
__device__ __forceinline__ void tma_load_bias(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int key0, int row0, int h) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(key0), "r"(row0), "r"(h)
      : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the address of row l & 7 of matrix l / 8
// and thread (g, t) receives row g, columns 2 t and 2 t + 1 of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
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

// d[64 rows x N keys] (+)= a[64 x 16 dims, registers] . the first N keys of a
// K tile (K-major), into the first N / 2 registers of the S accumulator: a
// last key tile of N = 16, 32 or 64 keys
__device__ __forceinline__ void wgmma_qk16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_qk32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : D8(0), D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_qk64(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
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

// d[64 rows x 64 cols] (+)= a[64 x 8, registers, TF32] . B (a K-major TF32
// tile in shared memory, 128-byte swizzle); TF32 takes no transpose flag
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

#undef D8

// The bias ring of a block: slot seq % SLOTS holds the bias tile of the
// consumers' seq-th step, [64 rows x 8 C keys] in the bias's own dtype, as
// boxes of 64 rows x 128 bytes (64 bf16 or 32 float32 keys) in the 128-byte
// swizzle; a full and an empty mbarrier per slot. One producer thread loads
// the tiles in the order the steps take them; the four warps of the
// warpgroup that takes a step release its slot once the product that starts
// from its fragment has completed: a release right after the loads let the
// next tile's TMA land in the slot before the loads had read it (wrong
// outputs, more often the sooner a slot is refilled).
// The bias's tensor map has extent n_valid in rows and keys, so what lies
// past n_valid arrives as zeros (rows past it are written as 0, keys past it
// get -inf on the last tile) and is never read.
template <int BIAS, int C, int RING>
struct BiasRing {
  static constexpr int KEYS_PER_BOX = BIAS == 1 ? 64 : 32;
  static constexpr int SLOT = 64 * 8 * C * (BIAS == 1 ? 2 : 4);
  static constexpr int SLOTS = RING / SLOT;
  const uint8_t* tiles;     // the slots (generic address, 1024-byte aligned)
  uint32_t full, empty;     // SLOTS mbarriers each, 8 bytes apart

  // producer: the tile of step seq, rows row0.. and keys key0.. of head h
  __device__ __forceinline__ void load(const CUtensorMap* map, int seq, int row0, int key0,
                                       int h) const {
    const int slot = seq % SLOTS;
    mbar_wait(empty + 8 * slot, ((seq / SLOTS) & 1) ^ 1);  // a fresh barrier passes at once
    mbar_expect_tx(full + 8 * slot, SLOT);
#pragma unroll
    for (int x = 0; x < SLOT / BIAS_BOX_BYTES; ++x)
      tma_load_bias(smem_u32(tiles) + slot * SLOT + x * BIAS_BOX_BYTES, map, full + 8 * slot,
                    key0 + x * KEYS_PER_BOX, row0, h);
  }

  // S of step seq starts as this thread's fragment of its tile: rows
  // 16 warp + g and + 8, keys 8 c + 2 t and + 1 for c < C (the layout of the
  // S accumulator), as float32. A row's 16-byte chunks sit at chunk ^ (row
  // & 7), so the eight rows of a matrix or a load fall on all 32 banks.
  __device__ __forceinline__ void read(float (&s)[4 * C], int seq, int warp, int lane) const {
    const int slot = seq % SLOTS, g = lane >> 2, t = lane & 3;
    mbar_wait(full + 8 * slot, (seq / SLOTS) & 1);
    const uint8_t* tile = tiles + slot * SLOT;
    if (BIAS == 1) {
      // bf16: chunks c = 2 p and 2 p + 1 of rows g and g + 8 are four 8 x 8
      // matrices, one ldmatrix: lane l gives row l & 7 of matrix l / 8 (its
      // bit 0: rows + 8, bit 1: the next chunk)
      const int i = lane & 7, next = lane >> 4;
      const uint32_t row = smem_u32(tile) + (warp * 16 + i + 8 * ((lane >> 3) & 1)) * 128;
#pragma unroll
      for (int p = 0; p < C / 2; ++p) {
        uint32_t m[4];
        ldmatrix_x4(m, row + (p >> 2) * BIAS_BOX_BYTES + (((2 * (p & 3) + next) ^ i) << 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 2 * p + (j >> 1), r = j & 1;
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&m[j]));
          s[4 * c + 2 * r] = x.x, s[4 * c + 2 * r + 1] = x.y;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint8_t* row = tile + (warp * 16 + g + 8 * r) * 128;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          // float32: keys 8 c + 2 t in chunk 2 (c & 3) + t / 2 of box c / 4
          const float2 x = *reinterpret_cast<const float2*>(
              row + (c >> 2) * BIAS_BOX_BYTES + (((2 * (c & 3) + (t >> 1)) ^ g) << 4) +
              8 * (t & 1));
          s[4 * c + 2 * r] = x.x, s[4 * c + 2 * r + 1] = x.y;
        }
      }
    }
  }

  // the step's fragment has been consumed (its S product has completed)
  __device__ __forceinline__ void release(int seq, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (seq % SLOTS));
  }
};

// The online softmax of one step over S's first NC chunks of 8 keys (16: a
// whole tile), run while the other warpgroup's products are: keys >=
// n_valid get -inf, the running max m and this thread's share of the sum l
// move on, P is packed as the next product's A fragments, alpha is the
// rescale of O.
template <int NC>
__device__ __forceinline__ void softmax_step(float (&s)[64], uint32_t (&pa)[8][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], int key0,
                                             int n_valid, int t) {
  float mx[2] = {m[0], m[1]};
  if (key0 + 8 * NC > n_valid) {
#pragma unroll
    for (int i = 0; i < 4 * NC; ++i)
      if (key0 + (i >> 2) * 8 + t * 2 + (i & 1) >= n_valid) s[i] = -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mlog[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // key 0 is valid (n_valid >= 1), so mx is finite from the first tile on
    alpha[r] = ex2_approx((m[r] - mx[r]) * LOG2E);
    mlog[r] = mx[r] * LOG2E;
    m[r] = mx[r];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {  // 8-key chunk: regs 0/1 of an even chunk, 2/3 of an odd one
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
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// S (+)= Q K^T on a narrow last key tile: its first 8 nc keys (nc = 2, 4 or
// 8 chunks), into S's first 4 nc registers; onto the bias, or from zero
template <int BIAS>
__device__ __forceinline__ void issue_qk_narrow(float (&s)[64], const uint32_t (&qa)[4][4],
                                                uint32_t s_tile, int nc) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t desc = smem_desc(s_tile) + 2 * ks;
    const int accumulate = BIAS || ks > 0;
    if (nc == 8)
      wgmma_qk64(s, qa[ks], desc, accumulate);
    else if (nc == 4)
      wgmma_qk32(s, qa[ks], desc, accumulate);
    else
      wgmma_qk16(s, qa[ks], desc, accumulate);
  }
}

// keys of a last tile of r keys rounded up to a product's width: 8-key chunks
__host__ __device__ __forceinline__ int live_chunks(int r) {
  return r <= 16 ? 2 : r <= 32 ? 4 : r <= 64 ? 8 : 16;
}

// One consumer warpgroup's whole life: U sub-tiles of 64 query rows (rows
// (NCW u + cw) * 64 of the block's Q tile), each walked over every K/V tile.
// A step is one (tile, sub-tile) pair; the warpgroups take steps in turns,
// round robin, or this one alone, without turns (ALONE). The last tile's
// products and softmax cover only its LC live 8-key chunks (N = 128 k + 1,
// as in BEiT-L's and MiDaS's 769, leaves one key there; 16: all). Both are
// template arguments: a walk with neither is the loop without any branch
// of theirs (in runtime branches they cost the bias-free loop a third of
// its speed, NVIDIA H100 80GB HBM3, 700.00 W). With a bias, step (kt, u) of
// warpgroup cw is the ring's (kt U + u) nwg + cw-th.
template <int U, int BIAS, int LC, bool ALONE>
__device__ __forceinline__ void consume(uint8_t* smem, uint32_t s_k, uint32_t s_v, uint32_t bar_q,
                                        uint32_t bar_k, uint32_t bar_v, uint32_t bar_e,
                                        __nv_bfloat16* __restrict__ ob, long long o_sn,
                                        const BiasRing<BIAS, 16, W_BIAS_RING>& ring, int q0,
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

  // the first turn goes to warpgroup 0; a warpgroup alone takes no turns
  constexpr bool turns = !ALONE;
  constexpr int nwg = ALONE ? 1 : NCW;
  if (turns && cw == NCW - 1) turn_pass(other_turn);
  if (BIAS) ring.read(s, cw, warp, lane);
  mbar_wait(bar_k, 0);
  if (turns) turn_wait(my_turn);
  wgmma_fence();
  if (LC < 16 && n_tiles == 1) {
    issue_qk_narrow<BIAS>(s, qa[0], s_k, LC);
  } else {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_qk(s, qa[0][ks], smem_desc(s_k) + 2 * ks, BIAS ? 1 : ks > 0);
  }
  wgmma_commit();
  if (turns) turn_pass(other_turn);
  wgmma_wait_all();
  fence_regs(s);
  if (BIAS) ring.release(cw, lane);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % STAGES, ph = (kt / STAGES) & 1;
    const int st1 = (kt + 1) % STAGES;
    const bool last_tile = kt + 1 == n_tiles;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t pa[8][4];  // P as A fragments: [k-step over keys][register]
      float alpha[2];
      const bool narrow = LC < 16 && last_tile;
      if (narrow)
        softmax_step<LC>(s, pa, m_i[u], l_i[u], alpha, kt * WK, n_valid, t);
      else
        softmax_step<16>(s, pa, m_i[u], l_i[u], alpha, kt * WK, n_valid, t);
      // S is dead until the next q.k^T: start it as the next step's bias
      if (BIAS) {
        if (u + 1 < U)
          ring.read(s, (kt * U + u + 1) * nwg + cw, warp, lane);
        else if (!last_tile)
          ring.read(s, (kt + 1) * U * nwg + cw, warp, lane);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[u][i] *= alpha[(i >> 1) & 1];

      // one batch for the tensor cores: O += P V of this step, S of the next
      // step (the next sub-tile on this K tile, or sub-tile 0 on the next)
      const bool last_step = last_tile && u + 1 == U;
      mbar_wait(bar_v + 8 * st, ph);
      if (u + 1 == U && !last_tile) mbar_wait(bar_k + 8 * st1, ((kt + 1) / STAGES) & 1);
      if (turns) turn_wait(my_turn);
      fence_regs(acc[u]);
      wgmma_fence();
      if (narrow) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)  // a narrow tile has at most 64 keys
          if (2 * ks < LC) wgmma_pv(acc[u], pa[ks], smem_desc(s_v + st * TILE_BYTES) + 128 * ks);
      } else {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          wgmma_pv(acc[u], pa[ks], smem_desc(s_v + st * TILE_BYTES) + 128 * ks);
      }
      wgmma_commit();
      if (u + 1 < U && narrow) {
        issue_qk_narrow<BIAS>(s, qa[(u + 1) % U], s_k + st * TILE_BYTES, LC);
        wgmma_commit();
      } else if (u + 1 < U) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_qk(s, qa[(u + 1) % U][ks], smem_desc(s_k + st * TILE_BYTES) + 2 * ks,
                   BIAS ? 1 : ks > 0);
        wgmma_commit();
      } else if (LC < 16 && kt + 2 == n_tiles) {
        issue_qk_narrow<BIAS>(s, qa[0], s_k + st1 * TILE_BYTES, LC);
        wgmma_commit();
      } else if (!last_tile) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_qk(s, qa[0][ks], smem_desc(s_k + st1 * TILE_BYTES) + 2 * ks, BIAS ? 1 : ks > 0);
        wgmma_commit();
      }
      // the very last turn (last warpgroup, last step) has nobody left to wake
      if (turns && !(last_step && cw == NCW - 1)) turn_pass(other_turn);
      wgmma_wait_all();
      fence_regs(acc[u]);
      fence_regs(s);
      if (BIAS && !last_step)
        ring.release(u + 1 < U ? (kt * U + u + 1) * nwg + cw : (kt + 1) * U * nwg + cw, lane);
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

// The bf16 grid is one-dimensional: first `big` blocks of 256 rows (two
// rounds of sub-tiles) per (image, head), over rows [0, 256 big), then
// `small` blocks of 128 rows (one round) per (image, head), over [256 big,
// n). Within each part the row blocks of one image run together, then the
// images of one head, so a wave of blocks shares a few heads' bias in L2;
// the long blocks are dispatched first and the short ones fill the last
// waves. The wrapper chooses `big` (ops/attention.py block_plan).
struct Plan {
  int big, small, batch, heads;
};

__device__ __forceinline__ void bf16_block(const Plan& p, int& q0, int& rounds, int& h, int& b) {
  int i = blockIdx.x, per = p.big, base = 0;
  rounds = SUBS;
  if (i >= p.big * p.batch * p.heads) {
    i -= p.big * p.batch * p.heads;
    per = p.small, base = WQ * p.big, rounds = 1;
  }
  q0 = base + (i % per) * 64 * NCW * rounds;
  const int bh = i / per;
  b = bh % p.batch; h = bh / p.batch;
}

// LC: the live 8-key chunks of the last key tile, the same for every block
// of a launch (it follows from n_valid); ALONE: the launch has blocks that
// one warpgroup walks. The C entry picks the kernel (launch_bf16).
template <int BIAS, int LC, bool ALONE>
__global__ void __launch_bounds__(W_THREADS, 1)
attn_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_b,
                       __nv_bfloat16* __restrict__ o, Strides so, Plan plan, int n, int n_valid,
                       float scale) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on that boundary
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t s_q = smem_u32(smem);  // WQ rows, loaded as boxes of 64
  const uint32_t s_k = s_q + SUB_BYTES * NCW * SUBS, s_v = s_k + STAGES * TILE_BYTES;
  const uint32_t bars = s_v + STAGES * TILE_BYTES + (BIAS ? W_BIAS_RING : 0);
  const uint32_t bar_q = bars;  // then full_k, full_v, empty: STAGES each, 8 bytes apart
  const uint32_t bar_k = bars + 8, bar_v = bar_k + 8 * STAGES, bar_e = bar_v + 8 * STAGES;
  using Ring = BiasRing<BIAS, 16, W_BIAS_RING>;  // its slots after the V stages, then barriers
  const Ring ring{smem + (s_v + STAGES * TILE_BYTES - s_q), bar_e + 8 * STAGES,
                  bar_e + 8 * STAGES + 8 * Ring::SLOTS};

  const int tid = threadIdx.x;
  int q0, rounds, h, b;
  bf16_block(plan, q0, rounds, h, b);
  const int n_tiles = (n_valid + WK - 1) / WK;  // tiles past n_valid weigh 0
  // sub-tiles per warpgroup in this block: the second round only where it
  // holds a valid row (the turns need the same number of steps from all)
  const int subs = (rounds == 2 && q0 + 64 * NCW < n_valid) ? 2 : 1;
  // a block whose rows past its first 64 are all >= n_valid (N = 256 k + 1
  // or 128 k + 1, as BEiT-L's and MiDaS's 769, leaves one such per head) is
  // walked by warpgroup 0 alone; the other writes its zeros and leaves
  const int nwg = ALONE && q0 + 64 >= n_valid ? 1 : NCW;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 4 * nwg);  // lane 0 of each consumer warp
    }
    for (int s = 0; BIAS && s < Ring::SLOTS; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 4);  // the four warps of the step's warpgroup
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
    } else if (BIAS && tid == 128 * NCW + 32) {
      // a second thread brings the bias tiles, in the order of the steps
      int seq = 0;
      for (int kt = 0; kt < n_tiles; ++kt)
        for (int u = 0; u < subs; ++u)
          for (int cw = 0; cw < nwg; ++cw, ++seq)
            ring.load(&map_b, seq, q0 + (NCW * u + cw) * 64, kt * WK, h);
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    __nv_bfloat16* ob = o + b * so.b + h * so.h;
    // the sub-tiles this warpgroup does not walk (a second round, or all
    // when it is idle) hold no row < n_valid: zeros for their rows < n,
    // after the walk, so they hold up no product. No walked sub-tile holds
    // one of these rows, so the stores never meet.
    const int cw = tid >> 7;
    auto zeros = [&](int u0) {
      for (int u = u0; u < rounds; ++u)
        for (int i = tid & 127; i < 64 * HD / 8; i += 128) {
          const int row = q0 + (NCW * u + cw) * 64 + i / (HD / 8);
          if (row < n) *reinterpret_cast<uint4*>(ob + row * so.n + (i % (HD / 8)) * 8) = uint4{};
        }
    };
    if (cw >= nwg) {
      zeros(0);
      return;
    }
    if (ALONE && nwg == 1)
      consume<1, BIAS, LC, true>(smem, s_k, s_v, bar_q, bar_k, bar_v, bar_e, ob, so.n, ring, q0,
                                 n, n_valid, n_tiles, scale);
    else if (SUBS == 2 && subs == 2)
      consume<SUBS, BIAS, LC, false>(smem, s_k, s_v, bar_q, bar_k, bar_v, bar_e, ob, so.n, ring,
                                     q0, n, n_valid, n_tiles, scale);
    else
      consume<1, BIAS, LC, false>(smem, s_k, s_v, bar_q, bar_k, bar_v, bar_e, ob, so.n, ring, q0,
                                  n, n_valid, n_tiles, scale);
    zeros(subs);
  }
}


// ---------------------------------------------------------------------------
// float32: split TF32 (3xTF32) on wgmma, one producer warp and two consumer
// warpgroups
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64 * NCW;                  // query rows per block (one sub-tile per warpgroup)
constexpr int F_BK = 64;                        // keys per tile
constexpr int F_STAGES = 3;                     // tiles in flight
constexpr int F_OPERAND_BYTES = F_BK * HD * 4;  // one split operand of a tile: 16 KB
constexpr int F_HALF_BYTES = F_OPERAND_BYTES / 2;  // 32 columns of 64 rows: 128-byte rows
constexpr int F_TILE_BYTES = 4 * F_OPERAND_BYTES;  // K hi, K lo, V^T hi, V^T lo: 64 KB
constexpr int F_SMEM = 1024 + F_STAGES * F_TILE_BYTES + 128;
// with a bias: a ring of [64 rows x F_BK keys] bias tiles after the stages
constexpr int F_BIAS_RING = 32 * 1024;
template <int BIAS>
constexpr int F_SMEM_OF = BIAS ? F_SMEM + F_BIAS_RING + 128 : F_SMEM;

// The element a slot of a TF32 operand holds, within its group of 8 along
// the product's K axis: slot t holds element 2 t and slot t + 4 element
// 2 t + 1, so the A fragment registers of slots t and t + 4 (columns t and
// t + 4 of an m64k8 TF32 fragment) are a thread's adjacent pair of S
// accumulator columns (2 t, 2 t + 1), and a q fragment is one float2 load.
__device__ __forceinline__ int slot_element(int s) {
  return (s & ~7) | ((s & 3) << 1) | ((s >> 2) & 1);
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

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One key tile of one (image, head) into its four split operands in the
// workspace, each two halves of 32 K-axis slots with 128-byte rows in the
// 128-byte swizzle, exactly as the consumers' descriptors read them: K as
// [key][dim slot] (hi at 0, lo at 16 KB), V transposed as [dim][key slot]
// (hi at 32 KB, lo at 48 KB). Keys >= n_valid are zeros and never read.
__global__ void __launch_bounds__(256)
attn_pack_f32_kernel(const float* __restrict__ k, const float* __restrict__ v,
                     uint8_t* __restrict__ ws, Strides sk, Strides sv, int heads, int n_valid,
                     int n_tiles) {
  __shared__ float sK[F_BK][HD + 1], sV[F_BK][HD + 1];  // +1: rows fall on other banks
  const int kt = blockIdx.x;
  int h, b;
  head_and_image(h, b);
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  for (int i = threadIdx.x; i < F_BK * HD / 4; i += blockDim.x) {
    const int r = i / (HD / 4), col = (i % (HD / 4)) * 4, key = kt * F_BK + r;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (key < n_valid) {
      kx = *reinterpret_cast<const float4*>(kb + key * sk.n + col);
      vx = *reinterpret_cast<const float4*>(vb + key * sv.n + col);
    }
    sK[r][col] = kx.x, sK[r][col + 1] = kx.y, sK[r][col + 2] = kx.z, sK[r][col + 3] = kx.w;
    sV[r][col] = vx.x, sV[r][col + 1] = vx.y, sV[r][col + 2] = vx.z, sV[r][col + 3] = vx.w;
  }
  __syncthreads();
  uint8_t* tile = ws + ((static_cast<long long>(b) * heads + h) * n_tiles + kt) * F_TILE_BYTES;
  // 16-byte pieces in memory order: operand, half, row, swizzled piece
  for (int i = threadIdx.x; i < F_TILE_BYTES / 16; i += blockDim.x) {
    const int op = i >> 10, half = (i >> 9) & 1, row = (i >> 3) & 63, piece = i & 7;
    const int s0 = half * 32 + ((piece ^ (row & 7)) << 2);  // the piece's first slot
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int el = slot_element(s0 + e);
      const float val = op < 2 ? sK[row][el] : sV[el][row];
      const uint32_t hi = tf32_rna(val);
      x[e] = __uint_as_float((op & 1) ? tf32_rna(val - __uint_as_float(hi)) : hi);
    }
    *reinterpret_cast<float4*>(tile + op * F_OPERAND_BYTES + half * F_HALF_BYTES + row * 128 +
                               piece * 16) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// One consumer warpgroup: its 64 query rows walked over every key tile.
// Q * scale lives in registers as split TF32 A fragments; per tile, S =
// Q K^T (+ bias) is 3 x 8 wgmma.m64n64k8 (hi.hi, hi.lo, lo.hi per k-step),
// the online softmax turns S into P in the A fragment layout (split into hi
// and lo), and the tile's P V is 3 x 8 more, folded into O on the CUDA cores.
// With a bias, tile kt of warpgroup cw is the ring's kt nwg + cw-th step.
template <int BIAS>
__device__ __forceinline__ void consume_f32(uint32_t s_ring, uint32_t bar_k, uint32_t bar_v,
                                            uint32_t bar_e, const float* __restrict__ qb,
                                            long long q_sn, float* __restrict__ ob, long long o_sn,
                                            const BiasRing<BIAS, 8, F_BIAS_RING>& ring, int nwg,
                                            int q0, int n, int n_valid, int n_tiles, float scale) {
  const int tid = threadIdx.x;
  const int cw = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group / column pair
  const int row0 = q0 + cw * 64 + warp * 16;  // this warp's rows: row0 + g and row0 + g + 8

  // k-step ks of Q: slot t = dim 8 ks + 2 t (registers 0/1: rows g/g+8),
  // slot t + 4 = dim 8 ks + 2 t + 1 (registers 2/3). Rows >= n_valid are 0.
  uint32_t qh[8][4], ql[8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      float2 x = make_float2(0.f, 0.f);
      if (row < n_valid) x = *reinterpret_cast<const float2*>(qb + row * q_sn + 8 * ks + 2 * t);
      split_tf32(x.x * scale, qh[ks][r], ql[ks][r]);
      split_tf32(x.y * scale, qh[ks][2 + r], ql[ks][2 + r]);
    }
  }

  // descriptor of operand op (0 K hi, 1 K lo, 2 V^T hi, 3 V^T lo) of stage st at k-step ks
  auto desc = [&](int st, int op, int ks) {
    return smem_desc(s_ring + st * F_TILE_BYTES + op * F_OPERAND_BYTES + (ks >> 2) * F_HALF_BYTES) +
           2 * (ks & 3);
  };
  float s[32];    // S of the current tile, then its P V: [8 key or dim chunks][row g: 2, row g+8: 2]
  float acc[32];  // O: [8 dim chunks][the same]
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  auto issue_s = [&](int st) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      wgmma_tf32(s, qh[ks], desc(st, 0, ks), BIAS || ks > 0);
      wgmma_tf32(s, qh[ks], desc(st, 1, ks), 1);
      wgmma_tf32(s, ql[ks], desc(st, 0, ks), 1);
    }
  };

  if (BIAS) ring.read(s, cw, warp, lane);
  mbar_wait(bar_k, 0);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  if (BIAS) ring.release(cw, lane);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % F_STAGES, ph = (kt / F_STAGES) & 1, st1 = (kt + 1) % F_STAGES;
    const bool last_tile = kt + 1 == n_tiles;
    if (kt * F_BK + F_BK > n_valid) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kt * F_BK + (i >> 2) * 8 + t * 2 + (i & 1) >= n_valid) s[i] = -INFINITY;
    }
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], mlog[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key 0 is valid (n_valid >= 1), so mx is finite from the first tile on
      alpha[r] = ex2_approx((m_i[r] - mx[r]) * LOG2E);
      mlog[r] = mx[r] * LOG2E;
      m_i[r] = mx[r];
    }
    uint32_t ph_[8][4], pl_[8][4];  // P as split A fragments: [k-step over keys][register]
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float p0 = ex2_approx(fmaf(s[4 * c], LOG2E, -mlog[0]));      // row g, key 2t
      const float p1 = ex2_approx(fmaf(s[4 * c + 1], LOG2E, -mlog[0]));  // row g, key 2t + 1
      const float p2 = ex2_approx(fmaf(s[4 * c + 2], LOG2E, -mlog[1]));  // row g + 8, key 2t
      const float p3 = ex2_approx(fmaf(s[4 * c + 3], LOG2E, -mlog[1]));  // row g + 8, key 2t + 1
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      split_tf32(p0, ph_[c][0], pl_[c][0]);
      split_tf32(p2, ph_[c][1], pl_[c][1]);
      split_tf32(p1, ph_[c][2], pl_[c][2]);
      split_tf32(p3, ph_[c][3], pl_[c][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + rs[r];

    // this tile's P V into the S registers (S is dead), from zero: the
    // tensor cores truncate as they accumulate, so a sum carried over every
    // key would drift; the tile's part is folded into O on the CUDA cores
    mbar_wait(bar_v + 8 * st, ph);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      wgmma_tf32(s, ph_[c], desc(st, 2, c), c > 0);
      wgmma_tf32(s, ph_[c], desc(st, 3, c), 1);
      wgmma_tf32(s, pl_[c], desc(st, 2, c), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_e + 8 * st);  // this warp is done with stage st
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], s[i]);
    if (last_tile) break;

    // the next tile's S, from its bias when there is one
    if (BIAS) ring.read(s, (kt + 1) * nwg + cw, warp, lane);
    mbar_wait(bar_k + 8 * st1, ((kt + 1) / F_STAGES) & 1);
    fence_regs(s);
    wgmma_fence();
    issue_s(st1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    if (BIAS) ring.release((kt + 1) * nwg + cw, lane);
  }

  // normalize (row sum clamped at 1e-30); rows past n_valid -> 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    const bool valid = row < n_valid;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<float2*>(ob + row * o_sn + 8 * c + 2 * t) =
          valid ? make_float2(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv)
                : make_float2(0.f, 0.f);
  }
}

template <int BIAS>
__global__ void __launch_bounds__(W_THREADS, 1)
attn_f32_wgmma_kernel(const float* __restrict__ q, const uint8_t* __restrict__ ws,
                      float* __restrict__ o, Strides sq, Strides so,
                      const __grid_constant__ CUtensorMap map_b, int heads, int n, int n_valid,
                      int n_tiles, float scale) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on that boundary
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t s_ring = smem_u32(smem);
  // then full_v, empty: F_STAGES each; with a bias its ring comes first
  const uint32_t bar_k = s_ring + F_STAGES * F_TILE_BYTES + (BIAS ? F_BIAS_RING : 0);
  const uint32_t bar_v = bar_k + 8 * F_STAGES, bar_e = bar_v + 8 * F_STAGES;
  using Ring = BiasRing<BIAS, 8, F_BIAS_RING>;
  const Ring ring{smem + F_STAGES * F_TILE_BYTES, bar_e + 8 * F_STAGES,
                  bar_e + 8 * F_STAGES + 8 * Ring::SLOTS};

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * F_BQ;
  int h, b;
  head_and_image(h, b);
  // consumer warpgroups with a valid row (the other writes zeros and leaves)
  const int active = q0 + 64 < n_valid ? NCW : 1;

  if (tid == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 4 * active);  // lane 0 of each active consumer warp
    }
    for (int s = 0; BIAS && s < Ring::SLOTS; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 4);  // the four warps of the tile's warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * NCW) {
    // ---- producer warpgroup: one thread issues every bulk copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * NCW) {
      const uint8_t* src = ws + (static_cast<long long>(b) * heads + h) * n_tiles * F_TILE_BYTES;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % F_STAGES, ph = (kt / F_STAGES) & 1;
        const uint32_t dst = s_ring + st * F_TILE_BYTES;
        mbar_wait(bar_e + 8 * st, ph ^ 1);  // a fresh barrier passes at once
        mbar_expect_tx(bar_k + 8 * st, 2 * F_OPERAND_BYTES);
        bulk_load(dst, src + kt * F_TILE_BYTES, 2 * F_OPERAND_BYTES, bar_k + 8 * st);
        mbar_expect_tx(bar_v + 8 * st, 2 * F_OPERAND_BYTES);
        bulk_load(dst + 2 * F_OPERAND_BYTES, src + kt * F_TILE_BYTES + 2 * F_OPERAND_BYTES,
                  2 * F_OPERAND_BYTES, bar_v + 8 * st);
      }
    } else if (BIAS && tid == 128 * NCW + 32) {
      // a second thread brings the bias tiles, in the order of the steps
      int seq = 0;
      for (int kt = 0; kt < n_tiles; ++kt)
        for (int cw = 0; cw < active; ++cw, ++seq)
          ring.load(&map_b, seq, q0 + cw * 64, kt * F_BK, h);
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    float* ob = o + b * so.b + h * so.h;
    const int cw = tid >> 7;
    if (cw >= active) {  // rows q0 + 64 cw.. are all >= n_valid
      for (int i = tid & 127; i < 64 * HD / 4; i += 128) {
        const int row = q0 + cw * 64 + i / (HD / 4);
        if (row < n)
          *reinterpret_cast<float4*>(ob + row * so.n + (i % (HD / 4)) * 4) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
    consume_f32<BIAS>(s_ring, bar_k, bar_v, bar_e, q + b * sq.b + h * sq.h, sq.n, ob, so.n, ring,
                      active, q0, n, n_valid, n_tiles, scale);
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

// Everything a tensor map is encoded from (the interleave, swizzle, L2
// promotion and fill are the same for all of this file's maps). A map is a
// pure function of these, so each thread keeps its last MAP_CACHE maps by
// them: a launch whose operands lie where an earlier one's did (the caching
// allocator hands a ViT's layers the same blocks) encodes nothing. Per
// thread, so the service's replica threads share no state.
struct MapKey {
  const void* base;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  int dtype, rank;
};
constexpr int MAP_CACHE = 16;
struct MapCache {
  MapKey key[MAP_CACHE];
  CUtensorMap map[MAP_CACHE];
  int used = 0, next = 0;
};

static CUresult encode_cached(CUtensorMap* map, CUtensorMapDataType dtype, int rank,
                              const void* base, const cuuint64_t* dims,
                              const cuuint64_t* strides, const cuuint32_t* box) {
  static thread_local MapCache cache;
  MapKey key;
  memset(&key, 0, sizeof key);  // the padding too: keys are compared as bytes
  key.base = base, key.dtype = static_cast<int>(dtype), key.rank = rank;
  for (int d = 0; d < rank; ++d) key.dims[d] = dims[d], key.box[d] = box[d];
  for (int d = 0; d + 1 < rank; ++d) key.strides[d] = strides[d];
  for (int i = 0; i < cache.used; ++i)
    if (memcmp(&cache.key[i], &key, sizeof key) == 0) {
      *map = cache.map[i];
      return CUDA_SUCCESS;
    }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode_tiled()(
      map, dtype, rank, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res == CUDA_SUCCESS) {
    cache.key[cache.next] = key, cache.map[cache.next] = *map;
    cache.next = (cache.next + 1) % MAP_CACHE;
    cache.used += cache.used < MAP_CACHE;
  }
  return res;
}

// [rows, 64] bf16 per (head, image) through element strides; box box_rows x 64
static CUresult encode_map(CUtensorMap* map, const void* base, const Strides& s, int batch,
                           int heads, int rows, int box_rows) {
  const cuuint64_t dims[4] = {cuuint64_t(HD), cuuint64_t(rows), cuuint64_t(heads),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(s.n) * 2, cuuint64_t(s.h) * 2, cuuint64_t(s.b) * 2};
  const cuuint32_t box[4] = {HD, cuuint32_t(box_rows), 1, 1};
  return encode_cached(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

// the [heads, n_valid, n_valid] bias (bias_kind 1: bf16, 2: float32) through
// its element strides; boxes of 64 rows x 128 bytes of keys. Its extent is
// n_valid in rows and keys: what lies past n_valid arrives as zeros.
static CUresult encode_bias_map(CUtensorMap* map, const void* base, long long sh, long long sn,
                                int bias_kind, int heads, int n_valid) {
  const int elt = bias_kind == 1 ? 2 : 4;
  const cuuint64_t dims[3] = {cuuint64_t(n_valid), cuuint64_t(n_valid), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(sn) * elt, cuuint64_t(sh) * elt};
  const cuuint32_t box[3] = {cuuint32_t(128 / elt), 64, 1};
  return encode_cached(map, bias_kind == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                       3, base, dims, strides, box);
}

// The dynamic shared memory a kernel takes, set once per device (a bit per
// device in `done`; a device past 63 sets it every launch): the attribute
// belongs to the current device, and setting it twice is harmless, so
// threads that race both set it.
template <typename Kernel>
static cudaError_t smem_attribute(Kernel kernel, int bytes, int device,
                                  std::atomic<unsigned long long>& done) {
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && bit) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int BIAS, int LC, bool ALONE>
static int launch_bf16_kernel(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                              const CUtensorMap& mb, void* o, const Strides& so,
                              const Plan& plan, int n, int n_valid, float scale, int device,
                              cudaStream_t st) {
  static std::atomic<unsigned long long> done{0};
  const cudaError_t attr = smem_attribute(attn_bf16_wgmma_kernel<BIAS, LC, ALONE>,
                                          W_SMEM_OF<BIAS>, device, done);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_bf16_wgmma_kernel<BIAS, LC, ALONE><<<(plan.big + plan.small) * plan.batch * plan.heads,
                                            W_THREADS, W_SMEM_OF<BIAS>, st>>>(
      mq, mk, mv, mb, static_cast<__nv_bfloat16*>(o), so, plan, n, n_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

// whether a block of the plan holds no row < n_valid past its first 64
// (the last block starts furthest in)
static bool has_alone_block(const Plan& p, int n_valid) {
  const int last = p.small ? WQ * p.big + 64 * NCW * (p.small - 1) : WQ * (p.big - 1);
  return last + 64 >= n_valid;
}

template <int BIAS>
static int launch_bf16(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                       const CUtensorMap& mb, void* o, const Strides& so, const Plan& plan,
                       int n, int n_valid, float scale, int device, cudaStream_t st) {
  if constexpr (BIAS != 0) {
    switch (live_chunks(n_valid - (n_valid - 1) / WK * WK)) {
      case 2:
        return launch_bf16_kernel<BIAS, 2, true>(mq, mk, mv, mb, o, so, plan, n, n_valid, scale,
                                                 device, st);
      case 4:
        return launch_bf16_kernel<BIAS, 4, true>(mq, mk, mv, mb, o, so, plan, n, n_valid, scale,
                                                 device, st);
      case 8:
        return launch_bf16_kernel<BIAS, 8, true>(mq, mk, mv, mb, o, so, plan, n, n_valid, scale,
                                                 device, st);
      default:
        return launch_bf16_kernel<BIAS, 16, true>(mq, mk, mv, mb, o, so, plan, n, n_valid,
                                                  scale, device, st);
    }
  } else {
    // Without a bias the last key tile is walked whole: a narrow tile's
    // code in the kernel slowed its whole loop more than the tile saves
    // (attention_contract_study.py --sections variants).
    if (has_alone_block(plan, n_valid))
      return launch_bf16_kernel<0, 16, true>(mq, mk, mv, mb, o, so, plan, n, n_valid, scale,
                                             device, st);
    return launch_bf16_kernel<0, 16, false>(mq, mk, mv, mb, o, so, plan, n, n_valid, scale,
                                            device, st);
  }
}

template <int BIAS>
static int launch_f32(const void* q, const void* k, const void* v, void* o, void* ws,
                      const Strides& sq, const Strides& sk, const Strides& sv, const Strides& so,
                      const CUtensorMap& mb, int batch, int heads, int n, int n_valid, float scale,
                      int device, cudaStream_t st) {
  const int n_tiles = (n_valid + F_BK - 1) / F_BK;
  attn_pack_f32_kernel<<<grid_of(n_tiles, batch, heads), 256, 0, st>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<uint8_t*>(ws), sk,
      sv, heads, n_valid, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::atomic<unsigned long long> done{0};
  err = smem_attribute(attn_f32_wgmma_kernel<BIAS>, F_SMEM_OF<BIAS>, device, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_f32_wgmma_kernel<BIAS><<<grid_of((n + F_BQ - 1) / F_BQ, batch, heads), W_THREADS,
                                F_SMEM_OF<BIAS>, st>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(ws), static_cast<float*>(o), sq,
      so, mb, heads, n, n_valid, n_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the device workspace the float32 entry needs (0 for bf16): the
// split TF32 operands of every key tile of every (image, head), 64 KB each.
extern "C" long long depthg_attention_workspace_bytes(int batch, int heads, int n_valid,
                                                      int is_bf16) {
  if (is_bf16 || batch < 1 || heads < 1 || n_valid < 1) return 0;
  return static_cast<long long>(batch) * heads * ((n_valid + F_BK - 1) / F_BK) * F_TILE_BYTES;
}

// The launch's arguments, one struct passed by address: the wrapper packs
// them in this order (ops/attention.py ARGS, held to sizeof at load).
// Strides are in elements, of (batch, head, token); big_blocks is the
// number of 256-row blocks per (image, head) of the bf16 grid (Plan).
struct LaunchArgs {
  const void *q, *k, *v;
  void* o;
  const void* bias;
  void* workspace;
  void* stream;
  long long q_s[3], k_s[3], v_s[3], o_s[3];
  long long bias_sh, bias_sn;
  int bias_kind, batch, heads, n, n_valid, is_bf16, device, big_blocks;
  float scale;
};

extern "C" int depthg_attention_args_bytes() { return static_cast<int>(sizeof(LaunchArgs)); }

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

static int attention_launch(const LaunchArgs& a) {
  const Strides sq{a.q_s[0], a.q_s[1], a.q_s[2]}, sk{a.k_s[0], a.k_s[1], a.k_s[2]};
  const Strides sv{a.v_s[0], a.v_s[1], a.v_s[2]}, so{a.o_s[0], a.o_s[1], a.o_s[2]};
  if (a.bias_kind < 0 || a.bias_kind > 2 || (a.bias_kind != 0 && a.bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  CUtensorMap mb{};  // read only by the kernels that take a bias
  if (a.bias_kind != 0) {
    if (a.bias_sh <= 0 || a.bias_sn <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (!encode_tiled()) return 10000;
    const CUresult res =
        encode_bias_map(&mb, a.bias, a.bias_sh, a.bias_sn, a.bias_kind, a.heads, a.n_valid);
    if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
  }
  if (a.is_bf16) {
    auto positive = [](const Strides& s) { return s.b > 0 && s.h > 0 && s.n > 0; };
    if (!positive(sq) || !positive(sk) || !positive(sv))
      return static_cast<int>(cudaErrorInvalidValue);
    if (a.big_blocks < 0 || a.big_blocks > (a.n + WQ - 1) / WQ)
      return static_cast<int>(cudaErrorInvalidValue);
    const int rest = a.n - WQ * a.big_blocks;
    const Plan plan{a.big_blocks, rest > 0 ? (rest + 64 * NCW - 1) / (64 * NCW) : 0, a.batch,
                    a.heads};
    if (!encode_tiled()) return 10000;
    // the token extent is n_valid: rows past it arrive as zeros
    CUtensorMap mq, mk, mv;
    CUresult res = encode_map(&mq, a.q, sq, a.batch, a.heads, a.n_valid, 64);
    if (res == CUDA_SUCCESS) res = encode_map(&mk, a.k, sk, a.batch, a.heads, a.n_valid, WK);
    if (res == CUDA_SUCCESS) res = encode_map(&mv, a.v, sv, a.batch, a.heads, a.n_valid, WK);
    if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
    if (a.bias_kind == 1)
      return launch_bf16<1>(mq, mk, mv, mb, a.o, so, plan, a.n, a.n_valid, a.scale, a.device, st);
    if (a.bias_kind == 2)
      return launch_bf16<2>(mq, mk, mv, mb, a.o, so, plan, a.n, a.n_valid, a.scale, a.device, st);
    return launch_bf16<0>(mq, mk, mv, mb, a.o, so, plan, a.n, a.n_valid, a.scale, a.device, st);
  }
  if (a.workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (a.bias_kind == 1)
    return launch_f32<1>(a.q, a.k, a.v, a.o, a.workspace, sq, sk, sv, so, mb, a.batch, a.heads,
                         a.n, a.n_valid, a.scale, a.device, st);
  if (a.bias_kind == 2)
    return launch_f32<2>(a.q, a.k, a.v, a.o, a.workspace, sq, sk, sv, so, mb, a.batch, a.heads,
                         a.n, a.n_valid, a.scale, a.device, st);
  return launch_f32<0>(a.q, a.k, a.v, a.o, a.workspace, sq, sk, sv, so, mb, a.batch, a.heads,
                       a.n, a.n_valid, a.scale, a.device, st);
}

// Launch on `stream`, on `device` (made current for the launch when it is
// not). Returns 0 when launched, cudaGetLastError() when the launch was
// refused, cudaErrorInvalidValue when an operand's strides are negative (a
// tensor map cannot express them) or big_blocks is past ceil(n / 256),
// 10000 when libcuda has no tensor-map encoder and 10000 + its CUresult when
// it refuses a map. Pointers, strides and n_valid are validated by the
// Python wrapper (depthg_tpu_torch/ops/attention.py): head_dim 64,
// contiguous last axis, 16-byte aligned base and strides, 1 <= n_valid <=
// n; a bias (bias_kind 1: bf16, 2: float32; 0: none) of shape [heads, n, n]
// with element strides (bias_sh, bias_sn, 1), both multiples of 8, a 16-byte
// aligned base.
// The bf16 kernel reads q, k and v, and both kernels the bias, through
// tensor maps made here from those pointers and strides (kept per thread,
// encode_cached); the shared-memory attribute is set once per device. A
// launch takes 9-16 us of host time through ops/attention.py _launch and
// 18-24 us through attention_qkv, against the 27-49 and 61-102 us of the
// entry that took 28 arguments, encoded every map and set the attribute on
// every launch (NVIDIA H100 80GB HBM3, 700.00 W; attention_contract_study.py
// --sections host, which splits where the time goes).
// The float32 entry takes a device workspace of
// depthg_attention_workspace_bytes (cudaErrorInvalidValue without one): a
// pack kernel writes the split K and V there, then the attention kernel runs.
extern "C" int depthg_attention_launch(const LaunchArgs* args) {
  const DeviceGuard guard(args->device);
  if (guard.err != 0) return guard.err;
  return attention_launch(*args);
}
