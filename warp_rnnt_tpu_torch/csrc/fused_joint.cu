// Fused joint projection + RNN-T lattice terms for Hopper (sm_90a).
//
// From the projected joint halves a (N, T, H) and c (N, U, H), fp32, and
// the output layer W (H, V) bf16, b (V,) fp32, every lattice cell (n, t, u)
// has the logits
//
//   h = tanh(a[n, t] + c[n, u])             (fp32, rounded to bf16)
//   z = h @ W + b                           (bf16 products, fp32 sums)
//
// and the loss needs only three numbers of each row of z: the blank logit,
// the label logit and logsumexp(z).  These kernels compute them, and the
// backward, without the (N, T, U, V) logits ever being written to memory.
//
// Replaces the Pallas TPU kernels of warp_rnnt_tpu/ops/fused_joint.py:
//   * fj_forward        <- `_fwd_kernel` (:60) and `_fwd_kernel_vb` (:245)
//                          (blank logit, label logit, logZ)
//   * fj_backward_dadc  <- `_bwd_kernel`, its d_a / d_c half, and
//                          `_bwd_dadc_kernel_vb`
//   * fj_backward_dwdb  <- `_bwd_kernel`, its d_W / d_b half, and
//                          `_bwd_dwdb_kernel_vb`
//   * fj_hidden_image   <- the h = tanh(a + c) the TPU kernels form in VMEM,
//                          written once to memory for wide joints
// The TPU kernels walk their grid in order and carry logZ's running sums,
// d_c, d_W and d_b in VMEM from one step to the next.  Hopper runs blocks
// in no order, so sums that cross blocks leave as partials that the caller
// adds in a fixed order (deterministic; no atomics).
//
// What bounds them on this card: bf16 tensor-core operations.  At the
// slice's shape (N=16, T=150, U=21, V=5000, H=256; R = N*T*U = 50,400 rows)
// one product R x H x V is 2*R*H*V = 129 GFLOP, 0.130 ms at 989 TFLOP/s.
// The forward does one product and R x V exps (252 M; the SFUs' 16 a clock
// an SM give ~0.06 ms, under the product); each backward kernel recomputes
// the logits and does one more product (bound 0.261 ms each).  Bytes are
// small: a, c, W and the (N, T, U) lattices are ~30 MB.
//
// Rows.  A tile is 64 lattice rows of one sample: BT = 64 / min(U, 64)
// whole frames of all U rows, or for U > 64 one frame's rows in chunks of
// 64.  Tiles are numbered sample-major; rows with t >= xn[n] read as dead
// (dz = 0, h = 0), and a tile with no live row skips its products.
//
// Layouts, one of each for all three kernels.  Every product is
// `wgmma.mma_async` m64n64k16 bf16 with fp32 accumulators in registers,
// issued by two consumer warpgroups; a third warpgroup gives up its
// registers (setmaxnreg 40; consumers 232) and one of its threads keeps a
// ring of shared-memory stages full with 1-D `cp.async.bulk` copies,
// signalled by full/empty mbarriers.  The caller lays the operands out in
// memory as the shared-memory images wgmma reads (no swizzle: 8 x 16-byte
// core matrices, 128 bytes each), so a stage is one to three contiguous
// blocks:
//   - W image: block (slice s, 64-column chunk) = HS x 64 bf16, element
//     (k, v) at (k/8)*64 + (v/8)*HS*8 + (k%8)*8 + v%8, then the chunk's
//     64 biases fp32, -inf past V (so dz is 0 and exp(z) is 0 there).  One
//     copy serves every product: B of z = h @ W (MN-major: LBO 128 B, SBO
//     HS*16 B) and of d_h = dz @ W^T (K-major: LBO HS*16 B, SBO 128 B).
//   - h image: block (tile, slice s) = 64 x HS bf16, element (r, k) at
//     (r/8)*64 + (k/8)*512 + (r%8)*8 + k%8: A of z (K-major: LBO 1 KB,
//     SBO 128 B) and, transposed, A of d_W = h^T @ dz (MN-major: LBO
//     128 B, SBO 1 KB).
// H is padded to S slices of HS columns, HS a multiple of 64 and at most
// 256 (S = ceil(H / 256); `bwd_plan`): d_h and d_W of a warpgroup are
// 64 x HS fp32, 128 registers a thread at HS = 256.  The caller pads with
// zero columns of a and c and zero rows of W (tanh(0) = 0, a zero row of W
// adds nothing) and cuts the gradients back.  Past one slice
// fj_hidden_image writes the h image first (once before the forward, once
// before the backward).
//
// The forward (fwd_kernel).  A block owns two tiles (one a consumer
// warpgroup) and one part of V (`_v_parts`: a grid of few tiles splits V
// to fill the card), and walks its 64-column chunks:
//   * S = 1: each consumer builds its tile's h straight into registers, in
//     the layout of wgmma's register A operand (rows r0, r0 + 8, columns
//     16k + 2(l%4) (+1, +8, +9) of k16 step k: 16 * HS/64 registers, 64 at
//     HS = 256), from a and c with the tanhf of the h image kernel, once.
//     Each product then reads only its W block from shared memory (2 KB a
//     k16 step against the 4 KB of two shared operands).  The ring holds up
//     to 4 W blocks (33 KB each at HS = 256: 132 KB).
//   * S > 1: a stage holds the slice's W block and the two tiles' h blocks
//     (97 KB at HS = 256: 2 stages); the S slice products of a chunk sum
//     into the same z (the forward keeps no d_h), so the forward does the
//     bound's one product at every H.  The h blocks are read again from L2
//     for every chunk: S * 97 KB a block and chunk at HS = 256.
//   * Every slice runs all HS/16 k steps: against the R x H x V bound the
//     padding costs 1.28x at H = 200 (256), 1x at H = 256, 512, 1024 and
//     2048, 1.2x at H = 640 (768), and 1.011x at V = 5000 (5056 columns);
//     64-row tiles of 63 rows at U = 21 add 1.016x.  Stopping the last
//     slice's k loop at H rounded up to 16 (the rows of W past it are
//     zero) is not done: a guard between the products made ptxas serialize
//     every wgmma of the kernel (C7520, below).  S = 1 and S > 1 are
//     separate instantiations (RES) for the same reason.
//   * The exp pass overlaps the products across the two consumer
//     warpgroups, not within one.  Per stage a warpgroup waits for its
//     turn (named barrier 1 + wg), issues its products, gives the other
//     warpgroup its turn, waits for its own products (wait_group 0) and
//     releases the stage; after a chunk's last slice it runs the chunk's
//     exp pass in registers while the other warpgroup's products run.  In
//     step, both would leave the tensor cores idle through both exp passes
//     (at HS = 256 one chunk's 4096 exps a warpgroup take about two thirds
//     of its product's time).  Two accumulator sets a warpgroup (issue
//     chunk k + 1, then wait_group 1 and chunk k's exp pass) were built
//     and measured slower on an H100 at 700 W, and are not kept.  Each
//     thread keeps a running (max, sum) of its own columns of rows r0 and
//     r0 + 8 (the accumulator layout of wgmma_ss), picks the blank and
//     label logits where it holds them, and merges with its quad
//     (shuffles xor 1, 2) once at the end.  The logits never go through
//     shared memory.  Registers: h 64, z 32, biases 16, the rows' state
//     ~30, under the consumers' 232.
//   * A branch on a value ptxas cannot prove warp-uniform (a tile's
//     lengths) around a wgmma, or between its issue and its wait, makes
//     ptxas serialize every wgmma of the kernel (C7520): a tile with no
//     live row takes a separate path that only walks the ring and the
//     turns, and every wgmma sits inside the other.
//   * Dead rows write zeros; a dead tile skips its products.  With one V
//     part the block writes blank logit, label logit and logZ; with more,
//     each part writes per-row (max, sum, blank logit, label logit) and the
//     caller merges them in a fixed order (`merge_v_parts`).
// Against the four limits of the earlier forward (fragments reloaded from
// shared memory with the legacy tensor-core path; one 8-warp block a
// 64-row tile running copy, barrier, product, barrier, exp pass in strict
// turns; h rows copied again for every slice and chunk with a wait and two
// block barriers a slice; a second layout of W and h): wgmma reads W by
// descriptor and h from registers (S = 1); the producer fills the next
// stages, one warpgroup's products overlap the other's exp pass, and no
// block barrier stands in the loop; at S > 1 the slices come through the
// same ring as contiguous bulk copies, each stage released as soon as its
// products are done; and the forward reads the backward's W image (laid
// out once a loss+grad and kept for the backward) and h image.
//
// The backward (dadc_kernel, dwdb_kernel).  Both recompute the logits and
// form dz = db*[v==blank] + de*[v==lab] - softmax*(db+de), rounded to bf16,
// then: dadc d_h = dz @ W^T, dpre = d_h * (1 - h^2) with fp32 h, summed
// over u (d_a partials per U chunk) and over t (d_c partials per tile);
// dwdb d_W = h_bf16^T @ dz and d_b = sum(dz) in fp32.
//   * dadc: a block owns two tiles (one a consumer warpgroup), one H slice
//     of d_h and one part of V (`_v_parts`), and walks its 64-column chunks
//     through a ring of up to 4 W stages (33 KB each at HS = 256); h of its
//     128 rows stays in shared memory (64 KB a slice), built from a and c
//     and also written out as the h image for dwdb.  Per chunk a warpgroup
//     forms z (64 x 64, 32 registers), then dz in registers from the z
//     accumulators, packs it to bf16 pairs and feeds them as the register
//     A operand of the d_h products (d_h: 64 x HS fp32, 128 registers at
//     HS = 256).  The epilogue stages d_h in the freed shared memory for
//     the fp32 (1 - h^2) and the sums over u and t.
//   * dwdb: a block owns one 128-column chunk of V (64 a consumer
//     warpgroup), one group of consecutive tiles and one H slice of d_W.
//     The chunk's W (66 KB a slice at HS = 256) stays in shared memory;
//     the tiles' h come through a ring of up to 4 stages (32 KB each).  Per
//     tile a warpgroup forms z, then dz, adds it to its fp32 d_b sums,
//     stores it once as bf16 (8 KB, the B image of d_W's product), fences
//     the async proxy (fence.proxy.async) and syncs its warpgroup before
//     the d_W products (d_W: HS x 64 fp32, 128 registers at HS = 256).  Row
//     groups fill the card when V has few chunks (`_row_groups`).
//   * Past one slice each backward block owns one slice of d_h (dadc) or
//     d_W (dwdb), forms the whole logits from all S slices (a stage then
//     holds the slice's W and h, the block's own slice last) and does one
//     more product: S + 1 products against the bound's 2.  With the
//     padding, against the R x H x V bound: 1x at H = 256, 1.28x at H = 200
//     (256), 1.5x at H = 512, 2.4x at H = 640 (768), 2.5x at H = 1024, 4.5x
//     at H = 2048.
//   * Determinism: d_a, d_c, d_W and d_b leave as partials (per U chunk,
//     tile, V part, row group) that the caller sums in a fixed order.
//
// Launches on the caller's stream; allocates nothing; each entry returns
// cudaGetLastError() (or the error of setting the shared-memory size) so
// the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps (the h image kernel)
constexpr int kRows = 64;      // lattice rows per tile

// Tile geometry: rows i = tt * ut + uu of tile (tb, uc) are the cells
// t = tb * bt + tt, u = uc * ut + uu.  H is the padded width S * HS (the
// row stride of a, c, h and the partials); HS the slice width.
struct Geom {
  int T, U, H, V, ut, bt, nuc, ntb, HS, S;
};

__device__ __forceinline__ bool tile_row(const Geom& g, int i, int tb, int uc,
                                         int& t, int& u) {
  const int tt = i / g.ut;
  const int uu = i - tt * g.ut;
  t = tb * g.bt + tt;
  u = uc * g.ut + uu;
  return tt < g.bt && t < g.T && u < g.U;
}

// bf16(tanh(a[n, t, k..k+3] + c[n, u, k..k+3])), packed; fp32 tanhf.
__device__ __forceinline__ uint2 h4(const float* __restrict__ a,
                                    const float* __restrict__ c, size_t ai,
                                    size_t ci) {
  const float4 av = *reinterpret_cast<const float4*>(a + ai);
  const float4 cv = *reinterpret_cast<const float4*>(c + ci);
  __nv_bfloat162 lo = __floats2bfloat162_rn(tanhf(av.x + cv.x), tanhf(av.y + cv.y));
  __nv_bfloat162 hi = __floats2bfloat162_rn(tanhf(av.z + cv.z), tanhf(av.w + cv.w));
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned int*>(&lo);
  packed.y = *reinterpret_cast<unsigned int*>(&hi);
  return packed;
}

// ---- wgmma, bulk copies in an mbarrier ring (all three kernels) ----------

constexpr int kRingThreads = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr int kMaxSlice = 256;     // widest H slice (registers)
constexpr int kMaxStages = 4;
constexpr int kSmemCap = 232448;  // shared memory a block may use
constexpr int kStaticSlack = 4096;  // static shared memory, with room
constexpr int kDzBytes = 64 * 64 * 2;

// W image block (slice, 64-column chunk): HS x 64 bf16 and 64 fp32 biases.
__host__ __device__ constexpr int w_block_bytes(int HS) { return HS * 128 + 256; }
// h image block (tile, slice): 64 rows x HS bf16.
__host__ __device__ constexpr int h_block_bytes(int HS) { return HS * 128; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor, no swizzle: lbo is the byte
// stride between core matrices along K, sbo along M or N.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d;
}

// h image as A of z (rows x k, K-major), k16 step ks.
__device__ __forceinline__ uint64_t desc_h(const void* h, int ks) {
  return make_desc(static_cast<const unsigned char*>(h) + ks * 2048, 1024, 128);
}
// h image as A of d_W (k x rows, MN-major), M tile j, k16 step kk.
__device__ __forceinline__ uint64_t desc_ht(const void* h, int j, int kk) {
  return make_desc(static_cast<const unsigned char*>(h) + j * 8192 + kk * 256,
                   128, 1024);
}
// W image as B of z (k x v, MN-major), k16 step ks.
template <int HS>
__device__ __forceinline__ uint64_t desc_w(const void* w, int ks) {
  return make_desc(static_cast<const unsigned char*>(w) + ks * 256, 128, HS * 16);
}
// W image as B of d_h (v x k, K-major), N tile j, k16 step kk.
template <int HS>
__device__ __forceinline__ uint64_t desc_wt(const void* w, int j, int kk) {
  return make_desc(static_cast<const unsigned char*>(w) + j * 1024 + kk * HS * 32,
                   HS * 16, 128);
}
// dz image (rows x 64 v, element (r, v) at (r/8)*64 + (v/8)*512 + (r%8)*8
// + v%8) as B of d_W (MN-major), k16 step kk.
__device__ __forceinline__ uint64_t desc_dz(const void* dz, int kk) {
  return make_desc(static_cast<const unsigned char*>(dz) + kk * 256, 128, 1024);
}

// d[64 x 64] (+)= A[64 x 16] @ B[16 x 64], both from shared memory; TA / TB
// 1 for an MN-major operand.  Thread layout of d: warp w, lane l holds rows
// 16w + l/4 (+8 for d[4j+2], d[4j+3]) and columns 8j + 2(l%4) (+1).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p,"
      " 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The same with A from registers: a[0..3] hold bf16 pairs of rows
// 16w + l/4 (a[1], a[3]: +8) and columns 2(l%4) (a[2], a[3]: +8), which is
// the layout of two n8 blocks of a product's accumulators.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34,"
      " %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// Keep the compiler from moving accumulator reads and writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until the warpgroup's committed groups are done.
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  wg_commit();
  wg_wait();
}
// Generic-proxy writes to shared memory made visible to wgmma and bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}
// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  }
}
// bytes (a multiple of 16, both ends 16-byte aligned) global -> shared,
// counted on barrier b.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0],"
      " [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void tile_coords(const Geom& g, int tile, int& n,
                                            int& tb, int& uc) {
  const int per_n = g.ntb * g.nuc;
  n = tile / per_n;
  const int rest = tile - n * per_n;
  tb = rest / g.nuc;
  uc = rest - tb * g.nuc;
}

// The lattice terms of row i of tile (n, tb, uc).  A row that is not live
// reads db = de = 0 and logZ = +inf, so its dz is exactly 0.
struct RowTerms {
  float logz, db, de;
  int lab;
};

__device__ __forceinline__ RowTerms row_terms(const Geom& g, int n, int tb, int uc,
                                              int i, int xn,
                                              const int* __restrict__ lab,
                                              const float* __restrict__ logz,
                                              const float* __restrict__ dbl,
                                              const float* __restrict__ del) {
  RowTerms r{INFINITY, 0.0f, 0.0f, -1};
  int t, u;
  if (tile_row(g, i, tb, uc, t, u) && t < xn) {
    const size_t cell = ((size_t)n * g.T + t) * g.U + u;
    r.logz = logz[cell];
    r.db = dbl[cell];
    r.de = del[cell];
    r.lab = lab[(size_t)n * g.U + u];
  }
  return r;
}

// d logit of one cell: db*[v==blank] + de*[v==lab] - softmax*(db+de).
__device__ __forceinline__ float dz_of(float z, float bias, const RowTerms& r,
                                       int v, int blank) {
  const float pick = (v == blank ? r.db : 0.0f) + (v == r.lab ? r.de : 0.0f);
  return pick - expf(z + bias - r.logz) * (r.db + r.de);
}

// bf16 h of the tile's rows, columns [k0, k0 + HS), as the h image (zeros
// for rows that are not live), to shared memory sdst and / or global gdst;
// 8 columns (16 bytes) a thread-step, threads lt of nthr, 8 rows of one
// core matrix side by side.
__device__ __forceinline__ void build_h_image(const Geom& g,
                                              const float* __restrict__ a,
                                              const float* __restrict__ c, int n,
                                              int tb, int uc, int xn, int k0,
                                              int HS, bf16* sdst, bf16* gdst,
                                              int lt, int nthr) {
  const int K8 = HS / 8;
  for (int idx = lt; idx < 64 * K8; idx += nthr) {
    const int rr = idx & 7;
    const int rest = idx >> 3;
    const int rb = rest / K8;
    const int k8 = rest - rb * K8;
    const int r = rb * 8 + rr;
    int t, u;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (tile_row(g, r, tb, uc, t, u) && t < xn) {
      const size_t ai = ((size_t)n * g.T + t) * g.H + k0 + 8 * k8;
      const size_t ci = ((size_t)n * g.U + u) * g.H + k0 + 8 * k8;
      const uint2 lo = h4(a, c, ai, ci);
      const uint2 hi = h4(a, c, ai + 4, ci + 4);
      packed = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    const int off = rb * 64 + k8 * 512 + rr * 8;
    if (sdst != nullptr) *reinterpret_cast<uint4*>(sdst + off) = packed;
    if (gdst != nullptr) *reinterpret_cast<uint4*>(gdst + off) = packed;
  }
}

// ---- the forward -----------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One row of the forward's epilogue, as one thread holds it: the running
// (max, sum of exp) over the thread's own columns, the blank and label
// logits where the thread holds them (else 0), the row's label and where
// its a and c start.
struct FwdRow {
  float m, s, bl, el;
  int lab;
  bool valid, live;
  size_t cell, ai, ci;
};

__device__ __forceinline__ FwdRow fwd_row(const Geom& g, int n, int tb, int uc,
                                          int i, int xn,
                                          const int* __restrict__ lab) {
  FwdRow r{-INFINITY, 0.0f, 0.0f, 0.0f, -1, false, false, 0, 0, 0};
  int t, u;
  r.valid = tile_row(g, i, tb, uc, t, u);
  if (r.valid) {
    r.cell = ((size_t)n * g.T + t) * g.U + u;
    r.live = t < xn;
  }
  if (r.live) {
    r.lab = lab[(size_t)n * g.U + u];
    r.ai = ((size_t)n * g.T + t) * g.H;
    r.ci = ((size_t)n * g.U + u) * g.H;
  }
  return r;
}

// bf16(tanh(a + c)) of columns k, k + 1 of a live row, packed (the tanhf
// of h4); 0 for a row that is not live.
__device__ __forceinline__ uint32_t h2(const float* __restrict__ a,
                                       const float* __restrict__ c,
                                       const FwdRow& r, int k) {
  if (!r.live) return 0u;
  const float2 av = *reinterpret_cast<const float2*>(a + r.ai + k);
  const float2 cv = *reinterpret_cast<const float2*>(c + r.ci + k);
  return pack2(tanhf(av.x + cv.x), tanhf(av.y + cv.y));
}

// Fold one row's values x[0..15] (its 16 logits of the chunk, bias added)
// into its running (max, sum).  A thread whose columns are all padding
// (-inf) keeps (-inf, 0).
__device__ __forceinline__ void fold_row(FwdRow& r, const float (&x)[16]) {
  float cm = r.m;
#pragma unroll
  for (int i = 0; i < 16; ++i) cm = fmaxf(cm, x[i]);
  const float ref = cm == -INFINITY ? 0.0f : cm;
  const float mref = ref * kLog2e;
  float ps = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) ps += ex2(fmaf(x[i], kLog2e, -mref));
  r.s = r.s * ex2(fmaf(r.m, kLog2e, -mref)) + ps;
  r.m = cm;
}

// Chunk ch's logits z (64 x 64 accumulators, thread layout of wgmma_ss:
// z[4j + x] is row r0 (x < 2) or r0 + 8, column 8j + 2t4 + (x & 1)) plus
// the chunk's biases bias[2j + (x & 1)], folded into the two rows; the
// blank and label logits picked where this thread holds them.
__device__ __forceinline__ void fold_chunk(const float (&z)[32],
                                           const float (&bias)[16], int ch,
                                           int t4, int blank, FwdRow& w0,
                                           FwdRow& w1) {
  float x0[16], x1[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x0[2 * j] = z[4 * j] + bias[2 * j];
    x0[2 * j + 1] = z[4 * j + 1] + bias[2 * j + 1];
    x1[2 * j] = z[4 * j + 2] + bias[2 * j];
    x1[2 * j + 1] = z[4 * j + 3] + bias[2 * j + 1];
  }
  if ((blank >> 6) == ch || (w0.lab >> 6) == ch || (w1.lab >> 6) == ch) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int v = ch * 64 + 8 * (i >> 1) + 2 * t4 + (i & 1);
      if (v == blank) {
        w0.bl = x0[i];
        w1.bl = x1[i];
      }
      if (v == w0.lab) w0.el = x0[i];
      if (v == w1.lab) w1.el = x1[i];
    }
  }
  fold_row(w0, x0);
  fold_row(w1, x1);
}

// The row's (max, sum, blank, label) merged over the quad that holds its
// 64 columns of every chunk (lanes xor 1, 2).
__device__ __forceinline__ void quad_merge(FwdRow& r) {
  float m = fmaxf(r.m, __shfl_xor_sync(0xffffffffu, r.m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  const float ref = m == -INFINITY ? 0.0f : m;
  float s = r.s * ex2((r.m - ref) * kLog2e);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  r.bl += __shfl_xor_sync(0xffffffffu, r.bl, 1);
  r.bl += __shfl_xor_sync(0xffffffffu, r.bl, 2);
  r.el += __shfl_xor_sync(0xffffffffu, r.el, 1);
  r.el += __shfl_xor_sync(0xffffffffu, r.el, 2);
  r.m = m;
  r.s = s;
}

// Block (x, p): tiles 2x and 2x + 1 (one a consumer warpgroup), 64-column
// chunks [p*cpp, (p+1)*cpp) of V.  Shared memory: the ring; a stage is the
// chunk's W block of one slice and, at S > 1, the two tiles' h blocks of
// that slice.  RES: S = 1, h in registers.  out: one V part: (3, R) blank
// logit, label logit, logZ; more: (4, parts, R) max, sum, blank logit,
// label logit of each part.
template <int NT, bool RES>
__global__ void __launch_bounds__(kRingThreads, 1)
fwd_kernel(const float* __restrict__ a, const float* __restrict__ c,
           const unsigned char* __restrict__ wimg, const int* __restrict__ lab,
           const int* __restrict__ xn_arr, const bf16* __restrict__ h16,
           float* __restrict__ out, Geom g, long long R, int ntiles,
           int nchunks, int blank, int cpp, int stages) {
  constexpr int HS = NT * 64;
  constexpr int KS = HS / 16;
  constexpr int WB = w_block_bytes(HS);
  constexpr int HB = h_block_bytes(HS);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const int tid = threadIdx.x;
  const int S = g.S;
  const int part = blockIdx.y;
  const int parts = gridDim.y;
  const int ch0 = part * cpp;
  const int ch1 = min(nchunks, ch0 + cpp);
  const int tile0 = 2 * blockIdx.x;
  constexpr int EB = WB + (RES ? 0 : 2 * HB);
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // producer: one thread keeps the ring full
    reg_dealloc<40>();
    if (tid == 256) {
      const int nc2 = nchunks + (nchunks & 1);
      const int tile1 = tile0 + 1 < ntiles ? tile0 + 1 : tile0;  // absent: a copy
      int stage = 0, phase = 0;
      for (int ch = ch0; ch < ch1; ++ch) {
        for (int s = 0; s < S; ++s) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* dst = smem + stage * EB;
          mbar_expect_tx(&full[stage], EB);
          bulk_load(dst, wimg + ((size_t)s * nc2 + ch) * WB, WB, &full[stage]);
          if constexpr (!RES) {
            bulk_load(dst + WB, h16 + ((size_t)tile0 * S + s) * HS * 64, HB,
                      &full[stage]);
            bulk_load(dst + WB + HB, h16 + ((size_t)tile1 * S + s) * HS * 64, HB,
                      &full[stage]);
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  reg_alloc<232>();
  const int wg = tid >> 7;
  const int lt = tid & 127;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int r0 = 16 * (lt >> 5) + (lane >> 2);
  const int tile = tile0 + wg;
  const bool active = tile < ntiles;
  int n = 0, tb = 0, uc = 0;
  if (active) tile_coords(g, tile, n, tb, uc);
  const int xn = active ? xn_arr[n] : 0;
  const bool busy = active && tb * g.bt < xn;
  FwdRow w0 = fwd_row(g, n, tb, uc, r0, xn, lab);
  FwdRow w1 = fwd_row(g, n, tb, uc, r0 + 8, xn, lab);

  // Turns: before each stage's products a warpgroup waits for its turn
  // (barrier 1 + wg, 256 threads) and, once they are issued, gives the
  // other its turn; warpgroup 1 gives warpgroup 0 the first.  So the two
  // issue in alternation, and one's exp pass runs while the other's
  // products do (in step, both would leave the tensor cores idle through
  // their exp passes).  A tile with no live row keeps the turns too.
  const int mine = 1 + wg, other = 2 - wg;
  if (wg == 1) named_bar_arrive(other, 256);
  int stage = 0, phase = 0;
  if (!busy) {  // no live row: the stages are released unread
    for (int i = 0; i < (ch1 - ch0) * S; ++i) {
      mbar_wait(&full[stage], phase);
      named_bar(mine, 256);
      named_bar_arrive(other, 256);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {  // every wgmma inside one branch: no accumulator crosses it
    // S = 1: h of rows r0 and r0 + 8 as the register A operand of each
    // k16 step (a[1], a[3]: row r0 + 8; a[2], a[3]: columns + 8)
    uint32_t hA[RES ? KS : 1][4];
    if constexpr (RES) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int k = 16 * ks + 2 * t4;
        hA[ks][0] = h2(a, c, w0, k);
        hA[ks][1] = h2(a, c, w1, k);
        hA[ks][2] = h2(a, c, w0, k + 8);
        hA[ks][3] = h2(a, c, w1, k + 8);
      }
    }

    // Per chunk: the S slice products into z, each stage released once
    // its products are done; then the last stage's biases to registers
    // and the exp pass.
    float z[32];
    for (int ch = ch0; ch < ch1; ++ch) {
      for (int si = 0; si < S; ++si) {
        mbar_wait(&full[stage], phase);
        const unsigned char* e = smem + (size_t)stage * EB;
        named_bar(mine, 256);
        wg_fence();
        if constexpr (RES) {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            wgmma_rs<1>(z, hA[ks], desc_w<HS>(e, ks), ks > 0);
          }
        } else {
          const unsigned char* hs = e + WB + wg * HB;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            wgmma_ss<0, 1>(z, desc_h(hs, ks), desc_w<HS>(e, ks), si > 0 || ks > 0);
          }
        }
        wg_commit();
        named_bar_arrive(other, 256);
        wg_wait();
        fence_acc(z);
        float bias[16];
        if (si == S - 1) {  // every slice's W block carries the biases
          const float* bsm = reinterpret_cast<const float*>(e + HS * 128);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 bv = *reinterpret_cast<const float2*>(bsm + 8 * j + 2 * t4);
            bias[2 * j] = bv.x;
            bias[2 * j + 1] = bv.y;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
        if (si == S - 1) fold_chunk(z, bias, ch, t4, blank, w0, w1);
      }
    }
  }
  if (wg == 0) named_bar(mine, 256);  // the last turn warpgroup 1 gave

  quad_merge(w0);
  quad_merge(w1);
  if (t4 != 0 || !active) return;  // an absent tile's rows read as tile 0's
  const size_t stride = (size_t)parts * R;
  auto write = [&](const FwdRow& r) {
    if (!r.valid) return;
    if (parts == 1) {
      out[r.cell] = r.live ? r.bl : 0.0f;
      out[R + r.cell] = r.live ? r.el : 0.0f;
      out[2 * R + r.cell] = r.live ? r.m + logf(r.s) : 0.0f;
    } else {
      float* o = out + (size_t)part * R + r.cell;
      o[0] = r.live ? r.m : 0.0f;
      o[stride] = r.live ? r.s : 0.0f;
      o[2 * stride] = r.live ? r.bl : 0.0f;
      o[3 * stride] = r.live ? r.el : 0.0f;
    }
  };
  write(w0);
  write(w1);
}

// Block (x, o, p): tiles 2x and 2x + 1 (one a consumer warpgroup), d_h
// columns [o*HS, (o+1)*HS), 64-column chunks [p*cpp, (p+1)*cpp) of V (its
// own d_a / d_c partials: a grid with few tiles splits V to fill the
// card).  Shared memory: S = 1: the two tiles' h
// images, then the ring of W blocks; S > 1: the ring, each stage a W block
// and the two tiles' h blocks of one slice.
template <int NT>
__global__ void __launch_bounds__(kRingThreads, 1)
dadc_kernel(const float* __restrict__ a, const float* __restrict__ c,
            const unsigned char* __restrict__ wimg, const int* __restrict__ lab,
            const int* __restrict__ xn_arr, const float* __restrict__ logz,
            const float* __restrict__ dbl, const float* __restrict__ del,
            float* __restrict__ da_part, float* __restrict__ dc_part,
            bf16* __restrict__ h16, Geom g, int ntiles, int nchunks, int blank,
            int cpp, int stages) {
  constexpr int HS = NT * 64;
  constexpr int WB = w_block_bytes(HS);
  constexpr int HB = h_block_bytes(HS);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const int tid = threadIdx.x;
  const int S = g.S;
  const int o = blockIdx.y;
  const int part = blockIdx.z;
  const int parts = gridDim.z;
  const int ch0 = part * cpp;
  const int ch1 = min(nchunks, ch0 + cpp);
  const int tile0 = 2 * blockIdx.x;
  const bool resident = S == 1;
  unsigned char* ring = smem + (resident ? 2 * HB : 0);
  const int EB = WB + (resident ? 0 : 2 * HB);
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // producer: one thread keeps the ring full
    reg_dealloc<40>();
    if (tid == 256) {
      const int nc2 = nchunks + (nchunks & 1);
      const int tile1 = tile0 + 1 < ntiles ? tile0 + 1 : tile0;  // absent: a copy
      int stage = 0, phase = 0;
      for (int ch = ch0; ch < ch1; ++ch) {
        for (int si = 0; si < S; ++si) {
          const int s = (o + 1 + si) % S;  // the block's own slice last
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* dst = ring + stage * EB;
          mbar_expect_tx(&full[stage], EB);
          bulk_load(dst, wimg + ((size_t)s * nc2 + ch) * WB, WB, &full[stage]);
          if (!resident) {
            bulk_load(dst + WB, h16 + ((size_t)tile0 * S + s) * HS * 64, HB,
                      &full[stage]);
            bulk_load(dst + WB + HB, h16 + ((size_t)tile1 * S + s) * HS * 64, HB,
                      &full[stage]);
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int wg = tid >> 7;
    const int lt = tid & 127;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const int r0 = 16 * (lt >> 5) + (lane >> 2);
    const int tile = tile0 + wg;
    const bool active = tile < ntiles;
    int n = 0, tb = 0, uc = 0;
    if (active) tile_coords(g, tile, n, tb, uc);
    const int xn = active ? xn_arr[n] : 0;
    const bool busy = active && tb * g.bt < xn;
    const RowTerms rw0 = row_terms(g, n, tb, uc, r0, xn, lab, logz, dbl, del);
    const RowTerms rw1 = row_terms(g, n, tb, uc, r0 + 8, xn, lab, logz, dbl, del);
    if (resident && active) {  // the first V part also writes h for dwdb
      build_h_image(g, a, c, n, tb, uc, xn, 0, HS,
                    reinterpret_cast<bf16*>(smem + wg * HB),
                    part == 0 ? h16 + (size_t)tile * HS * 64 : nullptr, lt, 128);
      fence_proxy_async();
    }
    named_bar(1 + wg, 128);

    float dh[NT][32];
    float z[32];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) dh[j][i] = 0.0f;
    int stage = 0, phase = 0;
    for (int ch = ch0; ch < ch1; ++ch) {
      for (int si = 0; si < S; ++si) {
        mbar_wait(&full[stage], phase);
        const unsigned char* e = ring + stage * EB;
        if (busy) {
          const unsigned char* hA = resident ? smem + wg * HB : e + WB + wg * HB;
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < HS / 16; ++ks) {
            wgmma_ss<0, 1>(z, desc_h(hA, ks), desc_w<HS>(e, ks), si > 0 || ks > 0);
          }
          wg_commit_wait();
          fence_acc(z);
          if (si == S - 1) {  // z complete: dz, then d_h += dz @ W^T
            const float* bias = reinterpret_cast<const float*>(e + HS * 128);
            uint32_t ar[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              float d[8];
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                const int col = 16 * kk + 8 * (q >> 2) + 2 * t4 + (q & 1);
                d[q] = dz_of(z[8 * kk + q], bias[col], (q & 2) ? rw1 : rw0,
                             ch * 64 + col, blank);
              }
              ar[kk][0] = pack2(d[0], d[1]);
              ar[kk][1] = pack2(d[2], d[3]);
              ar[kk][2] = pack2(d[4], d[5]);
              ar[kk][3] = pack2(d[6], d[7]);
            }
            wg_fence();
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_rs<0>(dh[j], ar[kk], desc_wt<HS>(e, j, kk), 1);
            wg_commit_wait();
#pragma unroll
            for (int j = 0; j < NT; ++j) fence_acc(dh[j]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }

    // dpre = d_h * (1 - h^2), staged in the freed shared memory, then
    // summed over u (d_a) and over t (d_c).
    named_bar(3, 256);  // both warpgroups are done with the ring and h
    if (!active) return;
    constexpr int ld = HS + 4;
    float* st = reinterpret_cast<float*>(smem) + wg * 64 * ld;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * j + 8 * i + 2 * t4;
        *reinterpret_cast<float2*>(st + r0 * ld + col) =
            make_float2(dh[j][4 * i], dh[j][4 * i + 1]);
        *reinterpret_cast<float2*>(st + (r0 + 8) * ld + col) =
            make_float2(dh[j][4 * i + 2], dh[j][4 * i + 3]);
      }
    named_bar(1 + wg, 128);
    const int k0 = o * HS;
    for (int idx = lt; idx < 64 * HS; idx += 128) {
      const int r = idx / HS;
      const int k = idx - r * HS;
      int t, u;
      float d = 0.0f;
      if (tile_row(g, r, tb, uc, t, u) && t < xn) {
        const float hv = tanhf(a[((size_t)n * g.T + t) * g.H + k0 + k] +
                               c[((size_t)n * g.U + u) * g.H + k0 + k]);
        d = st[r * ld + k] * (1.0f - hv * hv);
      }
      st[r * ld + k] = d;
    }
    named_bar(1 + wg, 128);
    for (int idx = lt; idx < g.bt * HS; idx += 128) {
      const int tt = idx / HS;
      const int k = idx - tt * HS;
      const int t = tb * g.bt + tt;
      if (t >= g.T) continue;
      float acc = 0.0f;
      for (int uu = 0; uu < g.ut; ++uu) acc += st[(tt * g.ut + uu) * ld + k];
      da_part[((((size_t)n * g.T + t) * g.nuc + uc) * parts + part) * g.H + k0 +
              k] = acc;
    }
    for (int idx = lt; idx < g.ut * HS; idx += 128) {
      const int uu = idx / HS;
      const int k = idx - uu * HS;
      const int u = uc * g.ut + uu;
      if (u >= g.U) continue;
      float acc = 0.0f;
      for (int tt = 0; tt < g.bt; ++tt) acc += st[(tt * g.ut + uu) * ld + k];
      dc_part[((((size_t)n * g.ntb + tb) * parts + part) * g.U + u) * g.H + k0 +
              k] = acc;
    }
  }
}

// Block (q, grp, o): columns [128q, 128q + 128) of V (64 a consumer
// warpgroup), tiles [grp*per, (grp+1)*per), d_W rows [o*HS, (o+1)*HS) and
// (o = 0) d_b.  Shared memory: the two warpgroups' dz images; S = 1: the
// chunk's two W blocks, then the ring of h blocks; S > 1: the ring, each
// stage the chunk's two W blocks and the tile's h block of one slice.
template <int NT>
__global__ void __launch_bounds__(kRingThreads, 1)
dwdb_kernel(const bf16* __restrict__ h16, const unsigned char* __restrict__ wimg,
            const int* __restrict__ lab, const int* __restrict__ xn_arr,
            const float* __restrict__ logz, const float* __restrict__ dbl,
            const float* __restrict__ del, float* __restrict__ dw_part,
            float* __restrict__ db_part, Geom g, int ntiles, int nchunks,
            int blank, int per, int stages) {
  constexpr int HS = NT * 64;
  constexpr int WB = w_block_bytes(HS);
  constexpr int HB = h_block_bytes(HS);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages], wbar;
  __shared__ float red[2][4][64];
  const int tid = threadIdx.x;
  const int S = g.S;
  const int q = blockIdx.x;
  const int grp = blockIdx.y;
  const int o = blockIdx.z;
  const bool resident = S == 1;
  unsigned char* wres = smem + 2 * kDzBytes;
  unsigned char* ring = wres + (resident ? 2 * WB : 0);
  const int EB = resident ? HB : 2 * WB + HB;
  const int nc2 = nchunks + (nchunks & 1);
  const int first = grp * per;
  const int last = min(ntiles, first + per);
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_init(&wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // producer
    reg_dealloc<40>();
    if (tid == 256) {
      if (resident) {
        mbar_expect_tx(&wbar, 2 * WB);
        bulk_load(wres, wimg + (size_t)(2 * q) * WB, 2 * WB, &wbar);
      }
      int stage = 0, phase = 0;
      for (int tile = first; tile < last; ++tile) {
        for (int si = 0; si < S; ++si) {
          const int s = (o + 1 + si) % S;  // the block's own slice last
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* dst = ring + stage * EB;
          mbar_expect_tx(&full[stage], EB);
          if (resident) {
            bulk_load(dst, h16 + (size_t)tile * HS * 64, HB, &full[stage]);
          } else {
            bulk_load(dst, wimg + ((size_t)s * nc2 + 2 * q) * WB, 2 * WB,
                      &full[stage]);
            bulk_load(dst + 2 * WB, h16 + ((size_t)tile * S + s) * HS * 64, HB,
                      &full[stage]);
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int wg = tid >> 7;
    const int lt = tid & 127;
    const int warp = lt >> 5;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const int r0 = 16 * warp + (lane >> 2);
    const int vc = q * 128 + wg * 64;  // first column of this warpgroup
    bf16* dz = reinterpret_cast<bf16*>(smem + wg * kDzBytes);
    if (resident) mbar_wait(&wbar, 0);

    float dw[NT][32];
    float z[32];
    float dbs[16];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) dw[j][i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) dbs[i] = 0.0f;
    int stage = 0, phase = 0;
    for (int tile = first; tile < last; ++tile) {
      int n, tb, uc;
      tile_coords(g, tile, n, tb, uc);
      const int xn = xn_arr[n];
      const bool busy = tb * g.bt < xn;
      const RowTerms rw0 = row_terms(g, n, tb, uc, r0, xn, lab, logz, dbl, del);
      const RowTerms rw1 = row_terms(g, n, tb, uc, r0 + 8, xn, lab, logz, dbl, del);
      for (int si = 0; si < S; ++si) {
        mbar_wait(&full[stage], phase);
        const unsigned char* e = ring + stage * EB;
        if (busy) {
          const unsigned char* hA = resident ? e : e + 2 * WB;
          const unsigned char* wb = (resident ? wres : e) + wg * WB;
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < HS / 16; ++ks) {
            wgmma_ss<0, 1>(z, desc_h(hA, ks), desc_w<HS>(wb, ks), si > 0 || ks > 0);
          }
          wg_commit_wait();
          fence_acc(z);
          if (si == S - 1) {  // z complete: dz, d_b, then d_W += h^T @ dz
            const float* bias = reinterpret_cast<const float*>(wb + HS * 128);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const int col = 8 * j + 2 * t4 + (x & 1);
                z[4 * j + x] = dz_of(z[4 * j + x], bias[col], (x & 2) ? rw1 : rw0,
                                     vc + col, blank);
              }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              dbs[2 * j] += z[4 * j] + z[4 * j + 2];
              dbs[2 * j + 1] += z[4 * j + 1] + z[4 * j + 3];
            }
            named_bar(1 + wg, 128);  // every warp's last d_W product is done
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int off = (r0 >> 3) * 64 + j * 512 + (r0 & 7) * 8 + 2 * t4;
              *reinterpret_cast<uint32_t*>(dz + off) = pack2(z[4 * j], z[4 * j + 1]);
              *reinterpret_cast<uint32_t*>(dz + off + 64) =
                  pack2(z[4 * j + 2], z[4 * j + 3]);  // row r0 + 8
            }
            fence_proxy_async();
            named_bar(1 + wg, 128);
            wg_fence();
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_ss<1, 1>(dw[j], desc_ht(hA, j, kk), desc_dz(dz, kk), 1);
            wg_commit_wait();
#pragma unroll
            for (int j = 0; j < NT; ++j) fence_acc(dw[j]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }

    const size_t row0 = (size_t)grp * g.H + o * HS;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int h = 64 * j + r0 + ((x & 2) ? 8 : 0);
          const int v = vc + 8 * i + 2 * t4 + (x & 1);
          if (v < g.V) dw_part[(row0 + h) * g.V + v] = dw[j][4 * i + x];
        }
    if (o == 0) {  // d_b: over the lanes of a column, then the four warps
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float x = dbs[i];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        dbs[i] = x;
      }
      if (lane < 4) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          red[wg][warp][8 * j + 2 * lane] = dbs[2 * j];
          red[wg][warp][8 * j + 2 * lane + 1] = dbs[2 * j + 1];
        }
      }
      named_bar(1 + wg, 128);
      if (lt < 64 && vc + lt < g.V) {
        db_part[(size_t)grp * g.V + vc + lt] =
            ((red[wg][0][lt] + red[wg][1][lt]) + red[wg][2][lt]) + red[wg][3][lt];
      }
    }
  }
}

// The h image kernel (fj_hidden_image): the h image of every tile and slice,
// zeros for rows that are not live; one block a (tile, slice).
//   What bounds it on this card: the image's bytes written (64 x HS bf16 a
//   block) and, beside them, the issue of one precise tanhf an element (the
//   same tanhf as h4, so the image's bits do not change).
//   Design: the block first copies its tile's bt frame rows of a and ut rows
//   of c, the slice's HS columns, to shared memory with 16-byte cp.async
//   (rows padded by 16 bytes, so the lanes of a quarter warp, on 8
//   consecutive c rows, read 8 distinct bank groups), frames past xn not at
//   all.  Then thread i owns row r = i % 64 of the tile, decoded once, and
//   the 16-byte units k8 * 64 + r of the block's image, k8 = i / 64, i / 64 +
//   4, ...: one warp's stores are 512 contiguous bytes, a thread's 8 stores
//   go out one after the other without a wait, and the blocks resident on an
//   SM (five at 48 registers) overlap one block's copies with the others'
//   tanhf.  tanhf compiles branch-free (both of its halves computed for
//   every element); its issue and the writes overlap only in part.
//   Capping registers for eight resident blocks, and copying half the
//   columns at a time (the second half's copies behind the first half's
//   tanhf), were built and measured no faster on an H100 at 700 W, and
//   are not kept.
constexpr int kStagePad = 4;  // floats after each staged row

__global__ void __launch_bounds__(kThreads)
hidden_image_kernel(const float* __restrict__ a, const float* __restrict__ c,
                    const int* __restrict__ xn_arr, bf16* __restrict__ h16,
                    Geom g) {
  extern __shared__ __align__(16) float stage[];
  const int tile = blockIdx.x;
  const int s = blockIdx.y;
  int n, tb, uc;
  tile_coords(g, tile, n, tb, uc);
  const int xn = xn_arr[n];
  const int ld = g.HS + kStagePad;
  const int k0 = s * g.HS;
  float* as = stage;               // bt rows
  float* cs = stage + g.bt * ld;   // ut rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q4 = g.HS / 4;  // 16-byte units of a staged row
  for (int j = warp; j < g.bt + g.ut; j += kThreads / 32) {
    const float* src;
    float* dst;
    if (j < g.bt) {
      const int t = tb * g.bt + j;
      if (t >= g.T || t >= xn) continue;
      src = a + ((size_t)n * g.T + t) * g.H + k0;
      dst = as + j * ld;
    } else {
      const int u = uc * g.ut + (j - g.bt);
      if (u >= g.U) continue;
      src = c + ((size_t)n * g.U + u) * g.H + k0;
      dst = cs + (j - g.bt) * ld;
    }
    for (int q = lane; q < q4; q += 32) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(dst + 4 * q)),
                   "l"(src + 4 * q)
                   : "memory");
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int r = threadIdx.x & 63;
  int t, u;
  const bool live = tile_row(g, r, tb, uc, t, u) && t < xn;
  const int tt = r / g.ut;
  const float* ar = as + tt * ld;
  const float* cr = cs + (r - tt * g.ut) * ld;
  uint4* dst = reinterpret_cast<uint4*>(h16 + ((size_t)tile * g.S + s) * g.HS * 64);
#pragma unroll 4
  for (int k8 = threadIdx.x >> 6; k8 < g.HS / 8; k8 += kThreads / 64) {
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (live) {
      const uint2 lo = h4(ar, cr, 8 * k8, 8 * k8);
      const uint2 hi = h4(ar, cr, 8 * k8 + 4, 8 * k8 + 4);
      packed = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    dst[k8 * 64 + r] = packed;
  }
}

// H is the padded width, S its slice count (H = S * HS, HS a multiple of
// 64 up to kMaxSlice; the caller checks).
Geom make_geom(int T, int U, int H, int V, int S) {
  Geom g;
  g.T = T;
  g.U = U;
  g.H = H;
  g.V = V;
  g.S = S;
  g.HS = H / S;
  g.ut = U < kRows ? U : kRows;
  g.bt = kRows / g.ut;
  g.nuc = (U + g.ut - 1) / g.ut;
  g.ntb = (T + g.bt - 1) / g.bt;
  return g;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool bad_slices(int H, int S) {
  return S < 1 || H % S != 0 || (H / S) % 64 != 0 || H / S > kMaxSlice;
}

// Stages of a ring of ``entry``-byte stages beside ``fixed`` bytes, up to
// kMaxStages; 0 if fewer than two fit.
int ring_stages(size_t fixed, size_t entry) {
  const long long room = (long long)kSmemCap - kStaticSlack - (long long)fixed;
  const long long n = room / (long long)entry;
  if (n < 2) return 0;
  return n < kMaxStages ? static_cast<int>(n) : kMaxStages;
}

// Shared memory of each kernel: ``fixed`` bytes beside a ring of
// ``entry``-byte stages (the layouts above each kernel).
void fwd_smem(int HS, int S, size_t& fixed, size_t& entry) {
  fixed = 0;
  entry = w_block_bytes(HS) + (S == 1 ? 0 : 2 * h_block_bytes(HS));
}

void dadc_smem(int HS, int S, size_t& fixed, size_t& entry) {
  fixed = S == 1 ? (size_t)2 * h_block_bytes(HS) : 0;
  entry = w_block_bytes(HS) + (S == 1 ? 0 : 2 * h_block_bytes(HS));
}

void dwdb_smem(int HS, int S, size_t& fixed, size_t& entry) {
  fixed = 2 * kDzBytes + (S == 1 ? (size_t)2 * w_block_bytes(HS) : 0);
  entry = h_block_bytes(HS) + (S == 1 ? 0 : 2 * w_block_bytes(HS));
}

struct FwdArgs {
  const float *a, *c;
  const unsigned char* wimg;
  const int *lab, *xn;
  const bf16* h16;
  float* out;
  Geom g;
  long long R;
  int ntiles, nchunks, blank, cpp, stages;
};

template <int NT, bool RES>
cudaError_t launch_fwd(const FwdArgs& p, dim3 grid, size_t bytes,
                       cudaStream_t st) {
  cudaError_t err = set_smem(fwd_kernel<NT, RES>, bytes);
  if (err != cudaSuccess) return err;
  fwd_kernel<NT, RES><<<grid, kRingThreads, bytes, st>>>(
      p.a, p.c, p.wimg, p.lab, p.xn, p.h16, p.out, p.g, p.R, p.ntiles,
      p.nchunks, p.blank, p.cpp, p.stages);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_fwd(const FwdArgs& p, dim3 grid, size_t bytes,
                       cudaStream_t st) {
  return p.g.S == 1 ? launch_fwd<NT, true>(p, grid, bytes, st)
                    : launch_fwd<NT, false>(p, grid, bytes, st);
}

struct DadcArgs {
  const float *a, *c;
  const unsigned char* wimg;
  const int *lab, *xn;
  const float *logz, *db, *de;
  float *da_part, *dc_part;
  bf16* h16;
  Geom g;
  int ntiles, nchunks, blank, cpp, stages;
};

template <int NT>
cudaError_t launch_dadc(const DadcArgs& p, dim3 grid, size_t bytes,
                        cudaStream_t st) {
  cudaError_t err = set_smem(dadc_kernel<NT>, bytes);
  if (err != cudaSuccess) return err;
  dadc_kernel<NT><<<grid, kRingThreads, bytes, st>>>(
      p.a, p.c, p.wimg, p.lab, p.xn, p.logz, p.db, p.de, p.da_part, p.dc_part,
      p.h16, p.g, p.ntiles, p.nchunks, p.blank, p.cpp, p.stages);
  return cudaGetLastError();
}

struct DwdbArgs {
  const bf16* h16;
  const unsigned char* wimg;
  const int *lab, *xn;
  const float *logz, *db, *de;
  float *dw_part, *db_part;
  Geom g;
  int ntiles, nchunks, blank, per, stages;
};

template <int NT>
cudaError_t launch_dwdb(const DwdbArgs& p, dim3 grid, size_t bytes,
                        cudaStream_t st) {
  cudaError_t err = set_smem(dwdb_kernel<NT>, bytes);
  if (err != cudaSuccess) return err;
  dwdb_kernel<NT><<<grid, kRingThreads, bytes, st>>>(
      p.h16, p.wimg, p.lab, p.xn, p.logz, p.db, p.de, p.dw_part, p.db_part, p.g,
      p.ntiles, p.nchunks, p.blank, p.per, p.stages);
  return cudaGetLastError();
}

}  // namespace

// The h image from one packed argument block: a[0] a (N, T, H) fp32, a[1] c
// (N, U, H) fp32, a[2] xn, a[3] h16, the image (tiles, S, 64 x H/S) bf16,
// a[4] N, a[5] T, a[6] U, a[7] H (padded), a[8] S, a[9] stream.
extern "C" int fj_hidden_image(const long long* p) {
  const int N = static_cast<int>(p[4]);
  const int H = static_cast<int>(p[7]);
  const int S = static_cast<int>(p[8]);
  if (bad_slices(H, S)) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = make_geom(static_cast<int>(p[5]), static_cast<int>(p[6]), H, 1, S);
  const long long tiles = (long long)N * g.ntb * g.nuc;
  const size_t bytes = (size_t)(g.bt + g.ut) * (g.HS + kStagePad) * sizeof(float);
  const cudaError_t err = set_smem(hidden_image_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  hidden_image_kernel<<<dim3(static_cast<unsigned int>(tiles), S), kThreads,
                        bytes, reinterpret_cast<cudaStream_t>(p[9])>>>(
      reinterpret_cast<const float*>(p[0]), reinterpret_cast<const float*>(p[1]),
      reinterpret_cast<const int*>(p[2]), reinterpret_cast<bf16*>(p[3]), g);
  return static_cast<int>(cudaGetLastError());
}

// wimg: the W image, (S, chunks rounded up to even, w_block_bytes) bytes.
// h16: the h image (S > 1; unread at S = 1).  parts: V parts of
// ceil(chunks / parts) 64-column chunks, none empty.  out: parts = 1: (3,
// N*T*U) blank logit, label logit, logZ; parts > 1: (4, parts, N*T*U) max,
// sum, blank logit, label logit of each part.
extern "C" int fj_forward(const float* a, const float* c, const void* wimg,
                          const int* lab, const int* xn, const void* h16,
                          float* out, int N, int T, int U, int H, int V,
                          int blank, int S, int parts, void* stream) {
  const int nchunks = (V + 63) / 64;
  if (bad_slices(H, S) || parts < 1 || parts > nchunks || parts > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cpp = (nchunks + parts - 1) / parts;
  const Geom g = make_geom(T, U, H, V, S);
  const long long tiles = (long long)N * g.ntb * g.nuc;
  const int HS = g.HS;
  size_t fixed, entry;
  fwd_smem(HS, S, fixed, entry);
  const int stages = ring_stages(fixed, entry);
  if (stages == 0 || tiles > 0x7fffffffLL || (parts - 1) * cpp >= nchunks ||
      (S > 1 && h16 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdArgs p{a, c, static_cast<const unsigned char*>(wimg), lab, xn,
                  static_cast<const bf16*>(h16), out, g, (long long)N * T * U,
                  static_cast<int>(tiles), nchunks, blank, cpp, stages};
  const dim3 grid(static_cast<unsigned int>((tiles + 1) / 2), parts);
  const size_t bytes = fixed + (size_t)stages * entry;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (HS / 64) {
    case 1: err = launch_fwd<1>(p, grid, bytes, st); break;
    case 2: err = launch_fwd<2>(p, grid, bytes, st); break;
    case 3: err = launch_fwd<3>(p, grid, bytes, st); break;
    default: err = launch_fwd<4>(p, grid, bytes, st); break;
  }
  return static_cast<int>(err);
}

// h16: the h image, (tiles, S, 64 x H/S) bf16; written here when S = 1,
// read (from fj_hidden_image) when S > 1.  parts: V parts of ceil(chunks /
// parts) 64-column chunks; da_part (N, T, U chunks, parts, H), dc_part
// (N, T tiles, parts, U, H).
extern "C" int fj_backward_dadc(const float* a, const float* c, const void* wimg,
                                const int* lab, const int* xn, const float* logz,
                                const float* db, const float* de,
                                float* da_part, float* dc_part, void* h16,
                                int N, int T, int U, int H, int V, int blank,
                                int S, int parts, void* stream) {
  const int nchunks = (V + 63) / 64;
  if (bad_slices(H, S) || parts < 1 || parts > nchunks || parts > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom g = make_geom(T, U, H, V, S);
  const long long tiles = (long long)N * g.ntb * g.nuc;
  const int HS = g.HS;
  size_t fixed, entry;
  dadc_smem(HS, S, fixed, entry);
  const int stages = ring_stages(fixed, entry);
  if (stages == 0 || tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t bytes = fixed + (size_t)stages * entry;
  const size_t stage_bytes = (size_t)2 * 64 * (HS + 4) * 4;  // the epilogue's
  if (bytes < stage_bytes) bytes = stage_bytes;
  const DadcArgs p{a, c, static_cast<const unsigned char*>(wimg), lab, xn, logz,
                   db, de, da_part, dc_part, static_cast<bf16*>(h16), g,
                   static_cast<int>(tiles), nchunks, blank,
                   (nchunks + parts - 1) / parts, stages};
  const dim3 grid(static_cast<unsigned int>((tiles + 1) / 2), S, parts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (HS / 64) {
    case 1: err = launch_dadc<1>(p, grid, bytes, st); break;
    case 2: err = launch_dadc<2>(p, grid, bytes, st); break;
    case 3: err = launch_dadc<3>(p, grid, bytes, st); break;
    default: err = launch_dadc<4>(p, grid, bytes, st); break;
  }
  return static_cast<int>(err);
}

// groups: row groups, each of ceil(tiles / groups) consecutive tiles.
extern "C" int fj_backward_dwdb(const void* h16, const void* wimg,
                                const int* lab, const int* xn,
                                const float* logz, const float* db,
                                const float* de, float* dw_part, float* db_part,
                                int N, int T, int U, int H, int V, int blank,
                                int groups, int S, void* stream) {
  if (bad_slices(H, S) || groups < 1 || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom g = make_geom(T, U, H, V, S);
  const long long tiles = (long long)N * g.ntb * g.nuc;
  const int HS = g.HS;
  size_t fixed, entry;
  dwdb_smem(HS, S, fixed, entry);
  const int stages = ring_stages(fixed, entry);
  if (stages == 0 || tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = fixed + (size_t)stages * entry;
  const DwdbArgs p{static_cast<const bf16*>(h16),
                   static_cast<const unsigned char*>(wimg), lab, xn, logz, db, de,
                   dw_part, db_part, g, static_cast<int>(tiles), (V + 63) / 64,
                   blank, static_cast<int>((tiles + groups - 1) / groups), stages};
  const dim3 grid((V + 127) / 128, groups, S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (HS / 64) {
    case 1: err = launch_dwdb<1>(p, grid, bytes, st); break;
    case 2: err = launch_dwdb<2>(p, grid, bytes, st); break;
    case 3: err = launch_dwdb<3>(p, grid, bytes, st); break;
    default: err = launch_dwdb<4>(p, grid, bytes, st); break;
  }
  return static_cast<int>(err);
}

// What the compiler gave a kernel (0: dadc, 1: dwdb, 2: the forward) at
// slice width HS and S slices: out = registers a thread at entry, local
// memory bytes a thread (spills), static and dynamic shared memory bytes,
// ring stages.
extern "C" int fj_kernel_attrs(int kernel, int HS, int S, int* out) {
  if (bad_slices(HS * S, S) || kernel < 0 || kernel > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fns[3][4] = {
      {(const void*)dadc_kernel<1>, (const void*)dadc_kernel<2>,
       (const void*)dadc_kernel<3>, (const void*)dadc_kernel<4>},
      {(const void*)dwdb_kernel<1>, (const void*)dwdb_kernel<2>,
       (const void*)dwdb_kernel<3>, (const void*)dwdb_kernel<4>},
      {S == 1 ? (const void*)fwd_kernel<1, true> : (const void*)fwd_kernel<1, false>,
       S == 1 ? (const void*)fwd_kernel<2, true> : (const void*)fwd_kernel<2, false>,
       S == 1 ? (const void*)fwd_kernel<3, true> : (const void*)fwd_kernel<3, false>,
       S == 1 ? (const void*)fwd_kernel<4, true> : (const void*)fwd_kernel<4, false>}};
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[kernel][HS / 64 - 1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t fixed, entry;
  if (kernel == 0) {
    dadc_smem(HS, S, fixed, entry);
  } else if (kernel == 1) {
    dwdb_smem(HS, S, fixed, entry);
  } else {
    fwd_smem(HS, S, fixed, entry);
  }
  const int stages = ring_stages(fixed, entry);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(fixed + (size_t)stages * entry);
  out[4] = stages;
  return 0;
}

extern "C" const char* fj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
