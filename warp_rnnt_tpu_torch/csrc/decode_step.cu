// One step of the transducer's decode loop for Hopper (sm_90a): the joint
// and the predictor's GRU cell, the step that XLA fuses inside the JAX
// package's `lax.while_loop` body (warp_rnnt_tpu/models/decoding.py:119,
// warp_rnnt_tpu/models/beam_search.py:298).  No TPU kernel replaces these:
// on the TPU the step is XLA's fusion, not Pallas.
//
// decode_joint, three launches, for `rows` hypotheses (N greedy, N*B beam;
// row r reads sample r / per_sample's frame):
//   1. dense_kernel<T, true>: x = combine(frame, pred_out) in T, then
//      h = tanh(round(round(x W_pre) + b_pre)) into a (rows, H) T scratch.
//      The frame is enc[s, clamp(t[s] - p0, 0, C - 1)], read in place.
//   2. dense_kernel<T, false>: logits = round(round(h W_out) + b_out) as
//      fp32, a (rows, V) scratch.
//   3. rows_kernel: one block a row: the max, the sum of exp, logp =
//      (x - max) - log(sum), then either the first index of the largest
//      logp (greedy) or the blank's logp and the top K labels (beam), with
//      the blank at -1e30, -inf selected as the finite minimum, values read
//      unclamped, ties to the lowest index, indices distinct (the port's
//      `top_k_small`, k argmax rounds).  Optionally the whole logp (a
//      debug output for the card check).
// T is the joint's compute dtype: bf16, whose products run on the tensor
// cores (mma.sync m16n8k16, fp32 accumulation), or fp32 on the CUDA cores.
// Every rounding of the plain version (Flax's Dense(dtype=cd) as
// models/joint.py computes it) is kept: inputs to T, the product's sum
// rounded to T, the bias added in T, tanh of the T value rounded to T.
// The two products differ from cuBLAS's only in the order of their fp32
// sums.
//
// decode_gru, one launch: torch's (r, z, n) GRU cell in fp32 on the CUDA
// cores, no TF32, for the rows' tokens (a token < 0 reads a zero
// embedding), with each row's emit mask: a row that does not emit copies
// its state and output through unchanged, bit for bit.  With the greedy
// fields it also computes the mask and folds the rest of greedy's masked
// update into its epilogue (t, u, emitted_here and the token buffer).
// With a row map (beam), row r reads its state and output from row
// src[r] (the beam's parent), in place of a gather before the launch.
//
// The device loop's mask and count, folded (greedy's decode_gru and
// decode_beam_select, given the loop's count): every block (the select:
// every warp, one ballot) computes the loop's cond, go = any(t <
// frame_bound) over the batch, from the step's inputs (which no launch of
// the step writes), writes the new state where
// go holds and its inputs through where it does not, and one thread writes
// count + go.  In greedy only emitted_here (reset to 0) and last_tok (the
// joint's label) would change in a step that no sample is active in; in
// beam the select writes the beam fields through, emit 0 and src the
// identity, so that decode_gru copies every row.  A step is then the
// step's own launches (greedy 4, beam 5), and decode_gru's programmatic
// launch reaches the next step's hidden layer, which stages its weights
// while the GRU finishes.
//
// decode_beam_select, one launch, beam search's step between the joint
// and the GRU (warp_rnnt_tpu/models/beam_search.py:207-294, XLA in the
// JAX package; the port's decode_beam_select_plain): one warp a sample,
// up to four samples a block and no block barrier.  The warp stages its
// sample's state (scores, u, nexp, waiting, hash, the B token rows) before
// griddepcontrol.wait, so those reads overlap the joint's rows launch,
// then reads the joint's outputs and builds its B (K + 1) candidates (the
// blank or self score, then the top-K labels' scores, masked to -1e30
// where a beam may not expand) in lane registers (up to 4 a lane) or, past
// 128, in shared memory, and takes B exact argmax rounds over them by warp
// shuffles (the keys clamped to -FLT_MAX and NaN the largest, ties to the
// lowest index, a picked key set to -inf: torch's argmax on
// `top_k_small`'s clamped copy).  Then the new state out of place: each
// new beam's parent and kind, its token row copied from the parent's with
// the new token at the parent's u (16-byte stores where rows allow), u,
// nexp and the uint32 prefix hash (stored in int64), the B x B merge of
// duplicates, the frame advance, and for the GRU its emit, token and
// parent row, written first, after which the GRU's launch may start.  The
// adds are the plain version's fp32 adds, the rest comparisons and
// integers, so it equals the plain version bit for bit.  It moves ~0.1 MB
// at bench width (the token rows in and out): latency-bound.  The first
// kernel (one block of 256 threads a sample, block barriers between its
// rounds, a plain launch) stays in decode_step_baseline.cu, the yardstick.
//
// What bounds a step at bench_decode's width (N=32, hidden 512, V=1024,
// beam 4): bytes at greedy (the GRU's 6 MB of fp32 weights and the joint's
// 1.5 MB in bf16 read once: 2.3 us at 3.35 TB/s), the GRU's fp32 products
// at beam (0.4 GFLOP over 128 rows: 6 us at 67 TFLOP/s).  In the loop the
// weights stay in the 50 MB L2, so what a launch pays is latency: trips to
// memory one after the other, and the gap between launches.  Design:
//   * K split over a thread-block cluster (`cluster` blocks, at most 8):
//     each block stages only its share of K (its slice of the rows' inputs
//     and of the weights), stores each partial sum into the shared memory
//     of the rank that owns the element (distributed shared memory), and
//     after one cluster barrier each rank adds its elements' partials in
//     rank order, so two calls give the same bits.  More SMs work on a row
//     tile and each reads a `cluster`-th of the bytes.
//   * A block stages its whole share at once, by the copy engine (bulk
//     copies of each input row's segment; the weights as boxes of 2-D
//     tensor maps, one a chunk and matrix), all counted on one mbarrier,
//     so a launch pays about one trip for its inputs.  Where a share does
//     not fit, a ring of `stages` chunks of `chunk` K is kept in flight.
//   * Programmatic dependent launch along the step's chain (hidden ->
//     logits -> rows -> GRU): each kernel issues its reads of the loop's
//     constants (the joint's weights and biases, the GRU's biases) before
//     `griddepcontrol.wait`, reads and writes everything else after it,
//     and lets the next launch start (`griddepcontrol.launch_dependents`)
//     once its inputs have landed.  The GRU reads its weights only where a
//     row emits, after the wait: most steps of a batch emit nowhere.
//   * The dense blocks are 32 rows x 16 columns, each warp all four m16n8
//     tiles over a quarter of every chunk's k steps; the GRU's 16, 32 or
//     64 rows x 32 hidden units, each thread a register tile of 4 rows x 4
//     units x 4 sums (r and z adding the two products), so that a
//     shared-memory word feeds 3 or more FMAs.
// The launch plan (cluster, K share, chunk, stages, shared bytes, the GRU's
// row tile and K groups) is computed in ops/decode_step.py from the shapes
// and passed in the argument blocks; the entries recompute the shared
// bytes and refuse a plan that disagrees.
//
// Launches on the caller's stream; allocates nothing; reads nothing back
// to the host, so it captures into a CUDA graph (a programmatic edge
// between the chained launches); returns cudaGetLastError() or the launch's
// error so the caller can raise on a refused launch.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <vector>

// Programmatic dependent launch, decided here at build time.
#define DECODE_STEP_PDL 1

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;      // dense and GRU blocks: four warps
constexpr int kRowTile = 32;       // rows a dense block
constexpr int kColTile = 16;       // output columns a dense block
constexpr int kGruUnits = 32;      // hidden units a GRU block
constexpr int kGruMaxRows = 64;    // rows a GRU block, at most
constexpr int kRowThreads = 256;   // rows_kernel: threads a row
constexpr int kMaxK = 64;          // top-K labels a row, at most (ops MAX_K)
constexpr int kMaxCluster = 8;     // blocks a cluster, at most (portable)
constexpr int kMaxStages = 4;      // chunks in flight, at most
constexpr float kNeg = -1.0e30f;   // the blank's key in the beam's top-K

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T (round to nearest even) and widened back
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A stage's barrier in shared memory: every thread of the block arrives
// once a phase, after announcing the bytes of the bulk copies it issued
// into the stage; the phase completes when all have arrived and the bytes
// have landed.
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// A box of a 2-D tensor map (a kernel parameter) at column x, row y into
// shared memory (128-byte aligned), `bytes` of it, counted on `bar`;
// elements outside the tensor are zeros.
__device__ __forceinline__ void tile_copy(void* dst, const CUtensorMap* map,
                                          int x, int y, unsigned bytes,
                                          uint64_t* bar) {
  bar_expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
         "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the copy engine, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  bar_expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The two halves of a cluster barrier (cluster.sync() is both): every
// thread of every block arrives, then waits for all of them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The block's stage barriers, initialised by thread 0 for `count`
// arrivals a phase, visible to every thread after it.
__device__ __forceinline__ void bars_init(uint64_t* bars, int n, unsigned count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) bar_init(bars + i, count);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The launch this one depends on has finished and its writes are visible
// (a no-op without a programmatic edge).
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The next launch may start (its blocks wait in pdl_wait for this one).
__device__ __forceinline__ void pdl_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(bf16 x) { return __bfloat16_as_ushort(x); }

// 16 bytes of T from p, the first `valid` elements (zeros past them),
// element by element: the path of rows that are not whole 16-byte groups.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int valid) {
  constexpr int n = 16 / sizeof(T), per = 4 / sizeof(T);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if (j < valid) w[j / per] |= bits(p[j]) << ((32 / per) * (j % per));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage `n` elements of T from src into shared memory at dst (16-byte
// aligned), zeros past the first `valid`: the path of rows that are not
// whole 16-byte groups on 16-byte boundaries, loaded element by element.
template <typename T>
__device__ __forceinline__ void stage_elems(T* dst, const T* src, int valid,
                                            int n) {
  constexpr int kVec = 16 / sizeof(T);
  for (int k = 0; k < n; k += kVec) {
    *reinterpret_cast<uint4*>(dst + k) = load16(src + k, min(max(valid - k, 0), kVec));
  }
}

// Zeros into `n` (a multiple of 4) floats of shared memory, 16-byte aligned.
__device__ __forceinline__ void zero_floats(float* dst, int n) {
  for (int k = 0; k < n; k += 4) {
    *reinterpret_cast<float4*>(dst + k) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}


// The plan of a dense or GRU launch (ops/decode_step.py computes it): the
// blocks a cluster, each block's share of K, the K a shared-memory stage,
// the stages (1: the whole share at once; more: a ring of chunks).
struct Plan {
  int cluster, k_share, chunk, stages;
};

// One dense layer of the joint: out = epilogue(A W + b), A (rows, K), W
// (K, cols) row-major in T (Flax's (in, out) layout), b (cols,).  kFirst:
// A is combine(frame, g) and the epilogue is tanh into T; else A is the
// (rows, K) T matrix `a` and the epilogue writes fp32 logits.  vec: every
// row of the inputs starts on 16 bytes and holds whole 16-byte groups
// (F and Fg multiples of 4 with kFirst; K, and cols, multiples of 16 bytes
// of T), so the stages copy 16 bytes a thread at a time.
struct Dense {
  CUtensorMap w_map;  // W's boxes of w_rows x 16 columns (where vec_w)
  const float* enc;  // (N, C, F) fp32
  const int* t;      // (N,) frame pointers
  const int* p0;     // the chunk's first stream position (one int)
  const float* g;    // (rows, Fg) fp32 predictor outputs
  const void* a;     // (rows, K) T (the second layer)
  const void* w;
  const void* b;
  void* out;
  int C, F, Fg, per_sample, concat;
  int rows, K, cols;
  int vec_a, vec_w;
  int w_rows;         // rows of a W box: a chunk is chunk / w_rows boxes
  Plan plan;
};

// Byte offsets of a dense block's dynamic shared memory, from its first
// 128-byte boundary (128 bytes are kept for the alignment): the weight
// stages ([stage][k][16 columns], as the tensor map's boxes land);
// kFirst's fp32 input stages (one array concat, f and g add; [stage]
// [array][row][chunk + 4]) and its T tile ([row][chunk + 16 B]); else the
// T input stages; the fp32 partial sums of the elements the block owns
// (32 x 16 in all); the warps' sums (bf16: 4 x 32 x 16).
struct DenseSmem {
  long long ws, raw, as, p, red, total;
};

__host__ __device__ inline DenseSmem dense_smem(int elem, bool first,
                                                bool concat, int chunk,
                                                int stages) {
  const int vec = 16 / elem;
  DenseSmem m;
  m.ws = 0;
  m.raw = static_cast<long long>(stages) * chunk * kColTile * elem;
  m.as = m.raw +
         (first ? 4LL * stages * (concat ? 1 : 2) * kRowTile * (chunk + 4) : 0);
  m.p = m.as + static_cast<long long>(first ? 1 : stages) * kRowTile *
                   (chunk + vec) * elem;
  m.red = m.p + 4LL * kRowTile * kColTile;
  m.total = m.red + 4LL * (kThreads / 32) * kRowTile * kColTile + 128;
  return m;
}

// A block computes kRowTile rows x kColTile columns over its rank's share
// of K (rank = its place in the cluster).  Where `vec`, every row segment
// of the share is one bulk copy into shared memory, counted on the
// stage's barrier: the weights' rows before griddepcontrol.wait, the
// inputs after it (kFirst: the predictor outputs at once, the frames once
// their pointers are read), the whole share in one stage where it fits
// (else a ring of chunks); elsewhere the inputs are loaded element by
// element.  Then the products (bf16: a warp an m16n8 tile, mma.sync;
// fp32: a thread a column of 4 rows), each partial sum stored into the
// shared memory of the rank that owns its element, one cluster barrier,
// and each rank adds its elements' partials in rank order and writes them.
template <typename T, bool kFirst>
__global__ void __launch_bounds__(kThreads)
decode_joint_dense_kernel(const __grid_constant__ Dense d) {
  constexpr int kVec = 16 / sizeof(T);  // T elements in 16 bytes
  constexpr int kWStride = kColTile;  // as the boxes land
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ const float* frow[kRowTile];
  __shared__ __align__(16) T bias[kColTile];
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = blockIdx.y * kRowTile;
  const int c0 = (blockIdx.x / d.plan.cluster) * kColTile;
  const int kc = d.plan.chunk, S = d.plan.stages;
  const int ks0 = rank * d.plan.k_share;
  const int ks1 = min(ks0 + d.plan.k_share, d.K);
  const int nchunks = ks1 > ks0 ? (ks1 - ks0 + kc - 1) / kc : 0;
  const DenseSmem m = dense_smem(sizeof(T), kFirst, d.concat, kc, S);
  const int nraw = d.concat ? 1 : 2;
  const int rstride = kc + 4, astride = kc + kVec;
  unsigned char* base = smem + ((128 - (smem_addr(smem) & 127)) & 127);
  float* raw = reinterpret_cast<float*>(base + m.raw);
  T* As = reinterpret_cast<T*>(base + m.as);
  T* Ws = reinterpret_cast<T*>(base + m.ws);
  float* recv = reinterpret_cast<float*>(base + m.p);  // [rank][element]
  const T* W = static_cast<const T*>(d.w);
  const T* A = static_cast<const T*>(d.a);
  const bool vec_a = d.vec_a != 0, vec_w = d.vec_w != 0;
  cluster_arrive();  // this block has started (waited on before a push)
  bars_init(bars, S, kThreads);

  auto chunk_k = [&](int c, int& k0) {  // chunk c's first k and length
    k0 = ks0 + c * kc;
    return min(kc, ks1 - k0);
  };
  // chunk c's weight rows (16 columns each): where vec_w, chunk / w_rows
  // boxes of the tensor map (rows past the share are another rank's, and
  // meet zeros in A; past K and the columns, zeros); else element by
  // element, zeros past the share
  auto stage_w = [&](int c) {
    int k0;
    const int kn = chunk_k(c, k0);
    T* ws = Ws + (c % S) * kc * kWStride;
    if (vec_w) {
      const int boxes = kc / d.w_rows;
      for (int b = tid; b < boxes; b += kThreads) {
        tile_copy(ws + b * d.w_rows * kWStride, &d.w_map, c0, k0 + b * d.w_rows,
                  d.w_rows * kColTile * sizeof(T), bars + c % S);
      }
      return;
    }
    const int width = min(kColTile, d.cols - c0);
    for (int k = tid; k < kc; k += kThreads) {
      stage_elems(ws + k * kWStride, W + static_cast<long long>(k0 + k) * d.cols + c0,
                  k < kn ? width : 0, kColTile);
    }
  };
  // kFirst, chunk c's inputs: part 0 what reads the frames (add: f;
  // concat: the share's part in f, or all of it without vec), part 1 the
  // predictor outputs (add: g; concat: the share's part in g); a thread a
  // row, rows past `rows` left unread (their products are dropped)
  auto stage_in = [&](int c, int part) {
    int k0;
    const int kn = chunk_k(c, k0);
    if (tid >= kRowTile || r0 + tid >= d.rows) return;
    const int r = tid, row = r0 + r;
    float* dst = raw + ((c % S) * nraw * kRowTile + r) * rstride;
    const float* gr = d.g + static_cast<long long>(row) * d.Fg;
    if (!d.concat) {
      const float* src = part == 0 ? frow[r] + k0 : gr + k0;
      if (part) dst += kRowTile * rstride;
      if (vec_a) {
        bulk_copy(dst, src, kn * 4, bars + c % S);
      } else {
        stage_elems(dst, src, kn, kc);
      }
    } else if (vec_a) {  // [k0, k0 + kn) cut at F: f's part, then g's
      const int fk = min(max(d.F - k0, 0), kn);
      if (part == 0 && fk > 0) bulk_copy(dst, frow[r] + k0, fk * 4, bars + c % S);
      if (part == 1 && fk < kn) {
        bulk_copy(dst + fk, gr + k0 + fk - d.F, (kn - fk) * 4, bars + c % S);
      }
    } else if (part == 0) {
      for (int k = 0; k < kc; ++k) {
        const int kk = k0 + k;
        dst[k] = k < kn ? (kk < d.F ? frow[r][kk] : gr[kk - d.F]) : 0.f;
      }
    }
  };
  auto stage_a = [&](int c) {  // the second layer's chunk c of A
    int k0;
    const int kn = chunk_k(c, k0), kn16 = (kn + 15) & ~15;
    if (tid >= kRowTile || r0 + tid >= d.rows) return;
    T* dst = As + ((c % S) * kRowTile + tid) * astride;
    const T* src = A + static_cast<long long>(r0 + tid) * d.K + k0;
    if (vec_a) {
      bulk_copy(dst, src, kn * sizeof(T), bars + c % S);
      for (int k = kn; k < kn16; k += kVec) {  // the products' K tail
        *reinterpret_cast<uint4*>(dst + k) = make_uint4(0, 0, 0, 0);
      }
    } else {
      stage_elems(dst, src, kn, kn16);
    }
  };

  // the loop's constants first (the weights' rows, the bias: with the
  // first stage), then what earlier launches wrote
  const int pro = min(S, nchunks);
  for (int c = 0; c < pro; ++c) stage_w(c);
  const T* B = static_cast<const T*>(d.b);
  const int width = min(kColTile, d.cols - c0);
  if (vec_w && pro > 0) {
    if (tid == 0) bulk_copy(bias, B + c0, width * sizeof(T), bars);
  } else if (tid < width) {
    bias[tid] = B[c0 + tid];
  }
  pdl_wait();
  if constexpr (kFirst) {
    // the frame pointers' loads first, the predictor outputs' copies
    // while they are in flight
    const int row = r0 + tid;
    int t = 0, p0 = 0;
    if (tid < kRowTile && row < d.rows) {
      t = d.t[row / d.per_sample];
      p0 = *d.p0;
    }
    for (int c = 0; c < pro; ++c) stage_in(c, 1);
    if (tid < kRowTile) {
      const int s = row / d.per_sample;
      const int fr = min(max(t - p0, 0), d.C - 1);
      frow[tid] = row < d.rows
                      ? d.enc + (static_cast<long long>(s) * d.C + fr) * d.F
                      : nullptr;
    }
    __syncthreads();
    for (int c = 0; c < pro; ++c) {
      stage_in(c, 0);
      bar_arrive(bars + c);
    }
  } else {
    for (int c = 0; c < pro; ++c) {
      stage_a(c);
      bar_arrive(bars + c);
    }
  }

  // bf16: a warp's four m16n8 tiles (its share of each chunk's k steps);
  // fp32: acc[0], a thread's 4 rows of one column
  float acc[4][4] = {};
  for (int c = 0; c < nchunks; ++c) {
    int k0;
    const int s = c % S, kn = chunk_k(c, k0);
    bar_wait(bars + s, (c / S) & 1);  // chunk c has landed
    __syncthreads();
    if (c == nchunks - 1) pdl_launch();  // every input is in
    const T* at;
    if constexpr (kFirst) {
      // concat: f or g rounded to T; add: both rounded, their sum rounded;
      // zeros past the share
      const float* rw = raw + s * nraw * kRowTile * rstride;
      const int groups = kc / 4;  // a thread 4 k, neighbours on neighbours
      for (int e = tid; e < kRowTile * groups; e += kThreads) {
        const int r = e / groups, k = (e % groups) * 4;
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f), g = f;
        if (k < kn) {  // (zeros staged past kn where it is not a multiple of 4)
          f = *reinterpret_cast<const float4*>(rw + r * rstride + k);
          if (!d.concat) g = *reinterpret_cast<const float4*>(rw + (kRowTile + r) * rstride + k);
        }
        if constexpr (sizeof(T) == 2) {
          __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y);
          __nv_bfloat162 hi = __floats2bfloat162_rn(f.z, f.w);
          if (!d.concat) {
            const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
            const float2 c = __bfloat1622float2(__floats2bfloat162_rn(g.x, g.y));
            const float2 e2 = __bfloat1622float2(__floats2bfloat162_rn(g.z, g.w));
            lo = __floats2bfloat162_rn(a.x + c.x, a.y + c.y);
            hi = __floats2bfloat162_rn(b.x + e2.x, b.y + e2.y);
          }
          *reinterpret_cast<uint2*>(As + r * astride + k) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
        } else {
          *reinterpret_cast<float4*>(As + r * astride + k) =
              make_float4(f.x + g.x, f.y + g.y, f.z + g.z, f.w + g.w);
        }
      }
      __syncthreads();
      at = As;
    } else {
      at = As + s * kRowTile * astride;
    }
    const T* wt = Ws + s * kc * kWStride;
    if constexpr (sizeof(T) == 2) {
      // warp w: the chunk's k steps w, w + 4, ..., all four m16n8 tiles
      // (rows 0 / 16 .. + 16 x columns 0 / 8 .. + 8)
      const int kn16 = (kn + 15) & ~15;  // zeros past kn
      for (int kk = warp * 16; kk < kn16; kk += 16 * (kThreads / 32)) {
        uint32_t a0[4], a1[4], b0[2], b1[2];
        const T* ar = at + (lane & 15) * astride + kk + ((lane >> 4) << 3);
        ldmatrix_x4(a0, ar);
        ldmatrix_x4(a1, ar + 16 * astride);
        ldmatrix_x2_trans(b0, wt + (kk + (lane & 15)) * kWStride);
        ldmatrix_x2_trans(b1, wt + (kk + (lane & 15)) * kWStride + 8);
        mma_bf16(acc[0], a0, b0);
        mma_bf16(acc[1], a0, b1);
        mma_bf16(acc[2], a1, b0);
        mma_bf16(acc[3], a1, b1);
      }
    } else {
      // thread: column tid % 16, rows tid / 16 + 8 i
      const int n = tid & 15, rg = tid >> 4;
      for (int k = 0; k < kn; ++k) {
        const float w = to_f(wt[k * kWStride + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[0][i] = fmaf(to_f(at[(rg + 8 * i) * astride + k]), w, acc[0][i]);
        }
      }
    }
    if (c + S < nchunks) {  // the ring: refill the stage just read
      __syncthreads();
      stage_w(c + S);
      if constexpr (kFirst) {
        stage_in(c + S, 1);
        stage_in(c + S, 0);
      } else {
        stage_a(c + S);
      }
      bar_arrive(bars + s);
    }
  }
  // the epilogue of element q = row * 16 + column, its sum v
  auto emit = [&](int q, float v) {
    const int row = r0 + q / kColTile, col = c0 + q % kColTile;
    if (row >= d.rows || col >= d.cols) return;
    const float y = rnd<T>(rnd<T>(v) + to_f(bias[q % kColTile]));
    const long long o = static_cast<long long>(row) * d.cols + col;
    if (kFirst) {
      static_cast<T*>(d.out)[o] = from_f<T>(tanhf(y));
    } else {
      static_cast<float*>(d.out)[o] = y;
    }
  };
  // the block's partial sums, four a thread: part[i] of element qs[i]
  float part[4];
  int qs[4];
  if constexpr (sizeof(T) == 2) {
    // the warps' tiles added in warp order: red[warp][row * 16 + column]
    // (the m16n8 accumulator: (row g, columns 2c, 2c+1), then row g + 8)
    float* red = reinterpret_cast<float*>(base + m.red);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int row = (t >> 1) * 16 + (lane >> 2);
      const int col = (t & 1) * 8 + 2 * (lane & 3);
      float* rr = red + warp * kRowTile * kColTile;
      rr[row * kColTile + col] = acc[t][0];
      rr[row * kColTile + col + 1] = acc[t][1];
      rr[(row + 8) * kColTile + col] = acc[t][2];
      rr[(row + 8) * kColTile + col + 1] = acc[t][3];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qs[i] = tid + i * kThreads;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) v += red[w * kRowTile * kColTile + qs[i]];
      part[i] = v;
    }
  } else {
    const int n = tid & 15, rg = tid >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qs[i] = (rg + 8 * i) * kColTile + n;
      part[i] = acc[0][i];
    }
  }
  cluster_wait();  // every block of the cluster has started
  const int per = kRowTile * kColTile / d.plan.cluster;
  if (d.plan.cluster == 1) {  // the epilogue at once
#pragma unroll
    for (int i = 0; i < 4; ++i) emit(qs[i], part[i]);
    return;
  }
  // element q belongs to rank q / per, which keeps each rank's partial in
  // recv[rank][q % per]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cluster.map_shared_rank(recv, qs[i] / per)[rank * per + qs[i] % per] = part[i];
  }
  cluster.sync();  // every partial is in its owner's shared memory
  for (int e = tid; e < per; e += kThreads) {
    float v = 0.f;
    for (int r = 0; r < d.plan.cluster; ++r) v += recv[r * per + e];
    emit(rank * per + e, v);
  }
}

// (key, index) pairs in torch's argmax order, which the top-K's follow:
// a NaN above every number (the first NaN wins), then the larger key,
// then the lower index.
__device__ __forceinline__ void take_first_max(float& key, int& idx, float k2,
                                               int i2) {
  const bool n2 = isnan(k2), n1 = isnan(key);
  if (n2 != n1 ? n2 : (n2 ? i2 < idx : (k2 > key || (k2 == key && i2 < idx)))) {
    key = k2;
    idx = i2;
  }
}

// Block-wide reductions of kRowThreads threads in a fixed tree, so every
// call gives the same bits; every thread gets the result.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kRowThreads / 32; ++w) v = fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(~0u, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kRowThreads / 32; ++w) v += red[w];
  __syncthreads();
  return v;
}

__device__ void block_best(float& key, int& idx, float* redf, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off; off >>= 1) {
    const float k2 = __shfl_xor_sync(~0u, key, off);
    const int i2 = __shfl_xor_sync(~0u, idx, off);
    take_first_max(key, idx, k2, i2);
  }
  if (lane == 0) {
    redf[warp] = key;
    redi[warp] = idx;
  }
  __syncthreads();
  key = redf[0];
  idx = redi[0];
  for (int w = 1; w < kRowThreads / 32; ++w) take_first_max(key, idx, redf[w], redi[w]);
  __syncthreads();
}

struct Rows {
  const float* logits;  // (rows, V)
  float* logp;          // (rows, V) or null
  int* best;            // (rows,) greedy, or null
  float* lp_blank;      // (rows,) beam
  float* top_lp;        // (rows, K)
  int* top_ids;         // (rows, K)
  int V, blank, K;
};

__global__ void __launch_bounds__(kRowThreads)
decode_joint_rows_kernel(const Rows d) {
  __shared__ float redf[kRowThreads / 32];
  __shared__ int redi[kRowThreads / 32];
  __shared__ int picked[kMaxK];
  const int tid = threadIdx.x;
  pdl_wait();    // the logits are written
  pdl_launch();  // the step's next launch may stage its weights
  const long long base = static_cast<long long>(blockIdx.x) * d.V;
  const float* x = d.logits + base;
  float m = -INFINITY;
  for (int v = tid; v < d.V; v += kRowThreads) m = fmaxf(m, x[v]);
  m = block_max(m, redf);
  float s = 0.f;
  for (int v = tid; v < d.V; v += kRowThreads) s += expf(x[v] - m);
  const float ls = logf(block_sum(s, redf));
  if (d.logp) {
    for (int v = tid; v < d.V; v += kRowThreads) d.logp[base + v] = (x[v] - m) - ls;
  }
  if (d.best) {
    float key = -INFINITY;
    int idx = INT_MAX;
    for (int v = tid; v < d.V; v += kRowThreads) take_first_max(key, idx, (x[v] - m) - ls, v);
    block_best(key, idx, redf, redi);
    if (tid == 0) d.best[blockIdx.x] = idx;
    return;
  }
  if (tid == 0) d.lp_blank[blockIdx.x] = (x[d.blank] - m) - ls;
  for (int j = 0; j < d.K; ++j) {
    float key = -INFINITY;
    int idx = INT_MAX;
    for (int v = tid; v < d.V; v += kRowThreads) {
      bool taken = false;
      for (int q = 0; q < j; ++q) taken |= picked[q] == v;
      if (taken) continue;
      const float k2 = v == d.blank ? kNeg : fmaxf((x[v] - m) - ls, -FLT_MAX);
      take_first_max(key, idx, k2, v);
    }
    block_best(key, idx, redf, redi);
    if (tid == 0) {
      picked[j] = idx;
      d.top_ids[static_cast<long long>(blockIdx.x) * d.K + j] = idx;
      d.top_lp[static_cast<long long>(blockIdx.x) * d.K + j] =
          idx == d.blank ? kNeg : (x[idx] - m) - ls;
    }
    __syncthreads();
  }
}

struct Gru {
  CUtensorMap ih_map, hh_map;    // W_ih's, W_hh's boxes of 32 units x 32 k
  const int* token;              // (rows,); < 0: a zero embedding
  const float* emb;              // (vocab, H)
  const float* h;                // (rows, H) state in
  const float* out_in;           // (rows, H) output in
  const float* w_ih;             // (3H, H), gates r, z, n
  const float* w_hh;             // (3H, H)
  const float* b_ih;             // (3H,)
  const float* b_hh;             // (3H,)
  const unsigned char* emit;     // (rows,) bool; null with the greedy fields
  const int* src;                // (rows,) row read for each row, or null
  float* h_out;
  float* out_out;
  // greedy's masked update (all null otherwise)
  const int *t, *u, *eh, *fb, *tokens;
  int *t_out, *u_out, *eh_out, *tokens_out;
  // the loop's mask and count, folded (all null otherwise)
  const int* last_tok;
  int* last_tok_out;
  const int* count;
  int* count_out;
  int vocab, rows, H, L, blank, max_symbols;
  int vec;                       // H a multiple of 4, rows on 16 bytes
  int row_tile, k_groups;        // rows a block; K groups of its threads
  Plan plan;
};

constexpr int kGruBox = 32;  // k a box of the GRU's weights: 128-byte rows

// Dynamic shared bytes of a GRU block, from its first 1024-byte boundary
// (1024 bytes are kept for the alignment): `stages` stages of its 6 x 32
// weight rows ((W_ih, W_hh) x (r, z, n) x units, as the tensor maps'
// boxes of 32 units x 32 k land: 128-byte rows, 16-byte chunk c of unit u
// at c ^ (u % 8)), then its rows' states and embeddings [row][chunk];
// after the products the same memory holds the K groups' partial sums
// [K group][row][unit][4], then the cluster's partial sums of the
// elements the block owns [rank][element][4].  The 4 sums of an element:
// r and z (the W_ih and W_hh products added), W_ih's n and W_hh's n.
__host__ __device__ inline long long gru_smem(int row_tile, int chunk,
                                              int stages, int k_groups) {
  const long long stage = 4LL * (6 * kGruUnits + 2 * row_tile) * chunk;
  const long long sums = 16LL * (k_groups + 1) * row_tile * kGruUnits;
  return (stages * stage > sums ? stages * stage : sums) + 1024;
}

// Greedy's emit mask of a row, its fields loaded at once (one trip).
__device__ __forceinline__ bool greedy_emit(const Gru& d, int row, bool& active,
                                            int& t, int& u, int& eh) {
  t = d.t[row];
  u = d.u[row];
  eh = d.eh[row];
  const int fb = d.fb[row], tok = d.token[row];
  active = t < fb;
  return active && tok != d.blank && u < d.L && eh < d.max_symbols;
}

// The row of h and out that row `row` (< rows) reads.
__device__ __forceinline__ int src_row(const Gru& d, int row) {
  return d.src ? d.src[row] : row;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// block (x, y): hidden units (x / cluster) * 32 .. + 32 and rows y *
// row_tile .. + row_tile over the K share of rank x % cluster.  Thread
// (unit group ug, row group rg, K group kg): units ug + 8 j, rows rg +
// (row_tile / 4) i (i, j < 4), the 4 sums of each (r and z: both
// products; n: each) over its K group's part of every chunk.  Before
// griddepcontrol.wait: the biases (the weights are read only where a row
// emits, after the wait: most decode steps of a batch emit nowhere, and
// the weights' reads would hold every block of such a step).  After it,
// the rows' emit, token and source row; then, where `vec`, each weight
// row's and
// each emitting row's segment of the share is one bulk copy counted on
// the stage's barrier (a token outside the vocabulary: zeros).  The
// partial sums go to the shared memory of the rank that owns each element
// (a block's K groups added first), 16 bytes a store, one cluster
// barrier, and each rank adds its elements' partials in rank order.  A
// cluster none of whose rows emits only copies its rows through.
__global__ void __launch_bounds__(kThreads)
decode_gru_kernel(const __grid_constant__ Gru d) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int tok_s[kGruMaxRows], src_s[kGruMaxRows];
  __shared__ int emit_s[kGruMaxRows], put_at[kGruMaxRows];
  __shared__ __align__(16) float bias[6][kGruUnits];  // (b_ih, b_hh) x (r, z, n)
  __shared__ __align__(8) uint64_t bars[kMaxStages + 1];  // the stages', the biases' 
  cg::cluster_group cluster = cg::this_cluster();
  float* sm = reinterpret_cast<float*>(
      smem + ((1024 - (smem_addr(smem) & 1023)) & 1023));
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int MT = d.row_tile, RG = MT / 4, KG = d.k_groups;
  const int ug = tid % 8, rg = (tid / 8) % RG, kg = tid / (8 * RG);
  const int tile = blockIdx.x / d.plan.cluster;
  const int j0 = tile * kGruUnits, r0 = blockIdx.y * MT, H = d.H;
  const int kc = d.plan.chunk, S = d.plan.stages;
  const int ks0 = rank * d.plan.k_share;
  const int ks1 = min(ks0 + d.plan.k_share, H);
  const int nchunks = ks1 > ks0 ? (ks1 - ks0 + kc - 1) / kc : 0;
  const int stage_floats = (6 * kGruUnits + 2 * MT) * kc;
  const int wfloats = kGruUnits * kc;  // a matrix-gate's weights a stage
  const int plane = MT * kGruUnits, per = plane / d.plan.cluster;
  float4* recv = reinterpret_cast<float4*>(sm) + KG * plane;  // [rank][per]
  const bool vec = d.vec != 0;
  bars_init(bars, S + 1, kThreads);
  uint64_t* bias_bar = bars + S;

  auto chunk_k = [&](int c, int& k0) {  // chunk c's first k and length
    k0 = ks0 + c * kc;
    return min(kc, ks1 - k0);
  };
  // chunk c's 6 x 32 weight rows: where vec, a box a matrix-gate and 32
  // k (units past H read the next gate's rows or zeros, k past the share
  // the next rank's: their products are dropped or never made); else
  // element by element, placed as the boxes would be
  auto stage_w = [&](int c) {
    int k0;
    const int kn = chunk_k(c, k0);
    float* ws = sm + (c % S) * stage_floats;
    if (vec) {
      for (int b = tid; b < 6 * (kc / kGruBox); b += kThreads) {
        const int mg = b / (kc / kGruBox), kb = b % (kc / kGruBox);
        tile_copy(ws + mg * wfloats + kb * kGruUnits * kGruBox,
                  mg < 3 ? &d.ih_map : &d.hh_map, k0 + kb * kGruBox,
                  (mg % 3) * H + j0, kGruUnits * kGruBox * 4, bars + c % S);
      }
      return;
    }
    for (int e = tid; e < 6 * kGruUnits * kc; e += kThreads) {
      const int mg = e / (kGruUnits * kc), u = (e / kc) % kGruUnits, k = e % kc;
      const float* m = mg < 3 ? d.w_ih : d.w_hh;
      const int unit = j0 + u;
      ws[mg * wfloats + (k / kGruBox) * kGruUnits * kGruBox + u * kGruBox +
         ((((k % kGruBox) / 4) ^ (u & 7)) * 4) + k % 4] =
          k < kn && unit < H ? m[(static_cast<long long>(mg % 3) * H + unit) * H + k0 + k]
                             : 0.f;
    }
  };
  // chunk c of the emitting rows' states (threads 0 ..) and embeddings
  // (threads 64 ..); the other rows are copied through, left unread
  auto stage_rows = [&](int c) {
    int k0;
    const int kn = chunk_k(c, k0);
    float* hs = sm + (c % S) * stage_floats + 6 * wfloats;
    const int r = tid % kGruMaxRows;
    if (r >= MT || !emit_s[r]) return;
    if (tid < kGruMaxRows) {
      const float* src = d.h + static_cast<long long>(src_s[r]) * H + k0;
      if (vec) {
        bulk_copy(hs + r * kc, src, kn * 4, bars + c % S);
      } else {
        stage_elems(hs + r * kc, src, kn, kc);
      }
      return;
    }
    float* es = hs + (MT + r) * kc;
    const int tok = tok_s[r];
    if (tok < 0 || tok >= d.vocab) {
      zero_floats(es, kc);
    } else if (vec) {
      bulk_copy(es, d.emb + static_cast<long long>(tok) * H + k0, kn * 4,
                bars + c % S);
    } else {
      stage_elems(es, d.emb + static_cast<long long>(tok) * H + k0, kn, kc);
    }
  };

  // the loop's constants first: the biases
  const int pro = min(S, nchunks);
  const int width = min(kGruUnits, H - j0);
  if (vec && tid < 6) {  // gate tid's 32 biases, one bulk copy
    bulk_copy(bias[tid], (tid < 3 ? d.b_ih : d.b_hh) + (tid % 3) * H + j0,
              width * 4, bias_bar);
  } else if (!vec) {
    for (int e = tid; e < 6 * kGruUnits; e += kThreads) {
      const int g = e / kGruUnits, j = j0 + e % kGruUnits;
      bias[g][e % kGruUnits] =
          j < H ? (g < 3 ? d.b_ih : d.b_hh)[(g % 3) * H + j] : 0.f;
    }
  }
  bar_arrive(bias_bar);
  pdl_wait();
  const bool greedy = d.t_out != nullptr;
  bool go = true;  // the loop's cond, where it is folded in
  if (d.count) {
    bool live = false;
    for (int r = tid; r < d.rows; r += kThreads) live |= d.t[r] < d.fb[r];
    go = __syncthreads_or(live);
    if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) d.count_out[0] = d.count[0] + go;
  }
  bool em = false;
  if (tid < MT) {
    const int row = r0 + tid;
    int src = 0, tok = -1, at = -1;
    if (row < d.rows) {
      bool active = false;
      int t = 0, u = 0, eh = 0;
      const int e0 = greedy ? 0 : d.emit[row];
      src = src_row(d, row);
      tok = d.token[row];
      em = greedy ? greedy_emit(d, row, active, t, u, eh) : e0 != 0;
      at = em ? u : -1;
      if (greedy && tile == 0 && rank == 0) {  // the integer fields
        // (where go is false no row is active: t, u and the rows keep)
        d.t_out[row] = active && !em ? t + 1 : t;
        d.u_out[row] = em ? u + 1 : u;
        d.eh_out[row] = em ? eh + 1 : go ? 0 : eh;
        if (d.count) d.last_tok_out[row] = go ? tok : d.last_tok[row];
      }
    }
    emit_s[tid] = em;
    src_s[tid] = src;
    tok_s[tid] = tok;
    put_at[tid] = at;
  }
  const bool any = __syncthreads_or(em);
  if (greedy) {  // greedy: the token rows, spread over the row tile's blocks
    const int n = min(MT, d.rows - r0) * d.L;
    const long long base = static_cast<long long>(r0) * d.L;
#pragma unroll 4
    for (int e = blockIdx.x * kThreads + tid; e < n; e += gridDim.x * kThreads) {
      const int r = e / d.L, l = e - r * d.L;
      d.tokens_out[base + e] = l == put_at[r] ? tok_s[r] : d.tokens[base + e];
    }
  }
  if (!any) {  // the cluster's rows all keep their state
    pdl_launch();
    for (int q = rank * kThreads + tid; q < plane;
         q += d.plan.cluster * kThreads) {
      const int r = q / kGruUnits, row = r0 + r, j = j0 + q % kGruUnits;
      if (row >= d.rows || j >= H) continue;
      const long long o = static_cast<long long>(row) * H + j;
      const long long oi = static_cast<long long>(src_s[r]) * H + j;
      d.h_out[o] = d.h[oi];
      d.out_out[o] = d.out_in[oi];
    }
    bar_wait(bias_bar, 0);  // the biases land before the block leaves
    return;
  }
  for (int c = 0; c < pro; ++c) {
    stage_w(c);
    stage_rows(c);
    bar_arrive(bars + c);
  }

  float acc[4][4][4];  // [row i][unit j][r, z, W_ih n, W_hh n]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][j][g] = 0.f;
    }
  }
  const int kspan = kc / KG;
  for (int c = 0; c < nchunks; ++c) {
    int k0;
    const int s = c % S, kn = chunk_k(c, k0);
    bar_wait(bars + s, (c / S) & 1);  // chunk c has landed
    __syncthreads();
    if (c == nchunks - 1) pdl_launch();  // every input is in
    const float* ws = sm + s * stage_floats;
    const float* hs = ws + 6 * wfloats;
    const float* es = hs + MT * kc;
    const int kb = kg * kspan, ke = min(kb + kspan, (kn + 3) & ~3);
    for (int k = kb; k < ke; k += 4) {
      float4 hv[4], ev[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hv[i] = lds4(hs + (rg + RG * i) * kc + k);
        ev[i] = lds4(es + (rg + RG * i) * kc + k);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // unit ug + 8 j's 16 bytes at k, in its swizzled 128-byte row
        const float* wr = ws + (k / kGruBox) * kGruUnits * kGruBox +
                          (ug + 8 * j) * kGruBox + ((((k % kGruBox) / 4) ^ ug) * 4);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float4 a = lds4(wr + g * wfloats);
          const float4 b = lds4(wr + (3 + g) * wfloats);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float& x = acc[i][j][g];  // r, z: W_ih's and W_hh's in one sum
            float& y = acc[i][j][g < 2 ? g : 3];
            x = fmaf(ev[i].w, a.w, fmaf(ev[i].z, a.z,
                fmaf(ev[i].y, a.y, fmaf(ev[i].x, a.x, x))));
            y = fmaf(hv[i].w, b.w, fmaf(hv[i].z, b.z,
                fmaf(hv[i].y, b.y, fmaf(hv[i].x, b.x, y))));
          }
        }
      }
    }
    if (c + S < nchunks) {  // the ring: refill the stage just read
      __syncthreads();
      stage_w(c + S);
      stage_rows(c + S);
      bar_arrive(bars + s);
    }
  }
  // element q = row * 32 + unit belongs to rank q / per, which keeps each
  // rank's 4 partial sums of it in recv[rank][q % per], in the memory of
  // the stages: every rank is done with its stages first
  auto push = [&](int q, float4 v) {
    cluster.map_shared_rank(recv, q / per)[rank * per + q % per] = v;
  };
  if (KG == 1) {
    cluster.sync();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        push((rg + RG * i) * kGruUnits + ug + 8 * j,
             make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]));
      }
    }
  } else {  // the block's K groups added in order first
    __syncthreads();  // the stages are read: the K groups' sums take their place
    float4* P = reinterpret_cast<float4*>(sm);  // [K group][row][unit]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        P[kg * plane + (rg + RG * i) * kGruUnits + ug + 8 * j] =
            make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
      }
    }
    __syncthreads();
    float4 v[kGruMaxRows * kGruUnits / kThreads];
#pragma unroll
    for (int n = 0; n < kGruMaxRows * kGruUnits / kThreads; ++n) {
      const int q = tid + n * kThreads;
      if (q >= plane) break;
      v[n] = P[q];
      for (int kq = 1; kq < KG; ++kq) {
        const float4 w = P[kq * plane + q];
        v[n] = make_float4(v[n].x + w.x, v[n].y + w.y, v[n].z + w.z, v[n].w + w.w);
      }
    }
    cluster.sync();
#pragma unroll
    for (int n = 0; n < kGruMaxRows * kGruUnits / kThreads; ++n) {
      const int q = tid + n * kThreads;
      if (q >= plane) break;
      push(q, v[n]);
    }
  }
  cluster.sync();  // every partial is in its owner's shared memory
  bar_wait(bias_bar, 0);
  for (int e = tid; e < per; e += kThreads) {
    const int q = rank * per + e;
    const int lr = q / kGruUnits, row = r0 + lr, u = q % kGruUnits, j = j0 + u;
    if (row >= d.rows || j >= H) continue;
    const long long o = static_cast<long long>(row) * H + j;
    const long long oi = static_cast<long long>(src_s[lr]) * H + j;
    const float h_old = d.h[oi];
    if (!emit_s[lr]) {
      d.h_out[o] = h_old;
      d.out_out[o] = d.out_in[oi];
      continue;
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cr = 0; cr < d.plan.cluster; ++cr) {  // in rank order
      const float4 w = recv[cr * per + e];
      v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
    }
    const float in = v.z + bias[2][u], hn = v.w + bias[5][u];
    const float r = 1.f / (1.f + expf(-(v.x + bias[0][u] + bias[3][u])));
    const float z = 1.f / (1.f + expf(-(v.y + bias[1][u] + bias[4][u])));
    const float n = tanhf(in + hn * r);
    const float hy = (h_old - n) * z + n;
    d.h_out[o] = hy;
    d.out_out[o] = hy;
  }
}

struct Select {
  // the state (N samples, B beams, L tokens a beam) and the joint's output
  const int* t;                  // (N,)
  const float* scores;           // (N, B)
  const int* tokens;             // (N, B, L)
  const int* u;                  // (N, B)
  const int* nexp;               // (N, B)
  const unsigned char* waiting;  // (N, B) bool
  const long long* hcode;        // (N, B), in [0, 2^32)
  const float* lp_blank;         // (N B,)
  const float* top_lp;           // (N B, K)
  const int* top_ids;            // (N B, K)
  const int* fb;                 // (N,) frame bounds
  // the new state, then the GRU's emit, token and parent row (N B,)
  int* t_out;
  float* scores_out;
  int* tokens_out;
  int* u_out;
  int* nexp_out;
  unsigned char* waiting_out;
  long long* hcode_out;
  unsigned char* emit;
  int* new_tok;
  int* src;
  // the loop's mask and count, folded (null otherwise)
  const int* count;
  int* count_out;
  int N, B, K, L, max_symbols;
  // the launch plan (ops select_plan): samples (warps) a block, candidate
  // slots a lane (0: the candidates in shared memory), the token rows
  // staged in shared memory (1) or read in place (0), and a warp's share
  // of the dynamic shared memory: its staged rows, then its candidates
  int warps, slots, stage, vec;
  int tok_bytes, warp_bytes;
};

constexpr int kSelWarps = 4;  // samples (warps) a select block, at most
constexpr unsigned kHashMul = 1000003u;

// Bytes of a sample's staged token rows and of its candidates in shared
// memory (values, clamped keys, label ids), each rounded up to 16.
__host__ __device__ inline int select_tok_bytes(int B, int L, int stage) {
  return stage ? (B * L * 4 + 15) / 16 * 16 : 0;
}

__host__ __device__ inline int select_cand_bytes(int B, int K, int slots) {
  return slots ? 0 : (12 * B * (K + 1) + 15) / 16 * 16;
}

// A beam's fields a warp keeps in shared memory: its sample's state before
// the step, staged before griddepcontrol.wait, then each new beam's pick
// and the fields it takes from its parent.
struct SelectBeams {
  float score[kMaxK];
  int u[kMaxK], nexp[kMaxK];
  long long hash[kMaxK];
  unsigned char wait[kMaxK];
  // new beam j: its candidate, value and label id (the picks), then its
  // parent, the parent's u, its u, nexp, hash, emission and settledness
  int pick[kMaxK], tok[kMaxK];
  float val[kMaxK];
  int parent[kMaxK], u_at[kMaxK], u_new[kMaxK], nexp_new[kMaxK];
  long long hash_new[kMaxK];
  unsigned char emits[kMaxK], waits[kMaxK];
};

// Candidate c of sample n's B (K + 1): the blank or self score (q = 0) or
// label q's, masked to kNeg where the beam may not expand; its label id
// (the beam's first where q = 0, as the plain version's clamped gather).
__device__ __forceinline__ float select_candidate(const Select& d,
                                                  const SelectBeams& sb,
                                                  long long nb, int c,
                                                  bool frame_on, int& id) {
  const int K1 = d.K + 1, b = c / K1, q = c - b * K1;
  const long long r = nb + b;
  const float s = sb.score[b];
  const bool wait = sb.wait[b] != 0;
  id = d.top_ids[r * d.K + max(q - 1, 0)];
  if (q == 0) return frame_on && !wait ? s + d.lp_blank[r] : s;
  const bool expandable = frame_on && s > 0.5f * kNeg && !wait &&
                          sb.u[b] < d.L && sb.nexp[b] < d.max_symbols;
  return expandable ? s + d.top_lp[r * d.K + q - 1] : kNeg;
}

__device__ __forceinline__ float select_key(float v) {
  return isnan(v) ? v : fmaxf(v, -FLT_MAX);
}

// The warp's best (key, index) by take_first_max's order: every lane gets
// it (a butterfly of shuffles; the order is total, so all agree).
__device__ __forceinline__ void warp_best(float& key, int& idx) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float k2 = __shfl_xor_sync(~0u, key, off);
    const int i2 = __shfl_xor_sync(~0u, idx, off);
    take_first_max(key, idx, k2, i2);
  }
}

// One warp a sample, `warps` samples a block, no block barrier.
// SLOTS > 0: lane l holds candidates l, l + 32, .. in registers (B (K + 1)
// <= 32 SLOTS); SLOTS == 0: the warp's candidates in shared memory, each
// round a scan of them.
//
// Before griddepcontrol.wait the warp reads what no launch since the
// previous step's selection has written: its sample's t, frame bound and
// beams' scores, u, nexp, waiting and hash, and (`stage`) its B token rows,
// into shared memory; with the loop's fold, every sample's t and bound for
// the loop's cond (one ballot).  This is safe because every launch of the
// step (the joint's three, this, the GRU) triggers its dependents only
// after its own griddepcontrol.wait: when this launch starts, the joint's
// rows launch has passed its wait, so every launch before the rows launch
// (the previous step's selection among them) has ended and its writes are
// visible.  A caller that launches this after another kernel that writes
// those inputs must let that kernel end first.  Nothing is written before
// the wait.  After it: the joint's lp_blank, top_lp and top_ids (one trip),
// the B exact argmax rounds, the beams' fields from the staged state, the
// merge and the frame advance; then emit, new_tok and src (what the GRU
// reads), griddepcontrol.launch_dependents, and the rest of the state, the
// token rows 16 bytes a store where `vec`.
template <int SLOTS>
__global__ void __launch_bounds__(kSelWarps * 32)
decode_beam_select_kernel(const Select d) {
  extern __shared__ __align__(16) unsigned char sel_smem[];
  __shared__ SelectBeams beams[kSelWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n = blockIdx.x * d.warps + w;
  if (n >= d.N) return;
  SelectBeams& sb = beams[w];
  unsigned char* mine = sel_smem + static_cast<long long>(w) * d.warp_bytes;
  int* tok_s = reinterpret_cast<int*>(mine);
  float* cval = reinterpret_cast<float*>(mine + d.tok_bytes);
  const int B = d.B, K1 = d.K + 1, L = d.L, nc = B * K1;
  float* ckey = cval + nc;
  int* cid = reinterpret_cast<int*>(ckey + nc);
  const long long nb = static_cast<long long>(n) * B;
  const long long base = nb * L;

  // what the previous step's selection wrote, before the wait
  const int t = d.t[n];
  const bool frame_on = t < d.fb[n];
  bool go = true;  // the loop's cond, where it is folded in
  if (d.count) {
    bool live = false;
    for (int m = lane; m < d.N; m += 32) live |= d.t[m] < d.fb[m];
    go = __any_sync(~0u, live);
  }
  for (int b = lane; b < B; b += 32) {
    const long long r = nb + b;
    sb.score[b] = d.scores[r];
    sb.u[b] = d.u[r];
    sb.nexp[b] = d.nexp[r];
    sb.wait[b] = d.waiting[r];
    sb.hash[b] = d.hcode[r];
  }
  if (d.stage && d.vec) {
    const int4* from = reinterpret_cast<const int4*>(d.tokens + base);
    for (int e = lane; e < B * L / 4; e += 32) {
      reinterpret_cast<int4*>(tok_s)[e] = from[e];
    }
  } else if (d.stage) {
    for (int e = lane; e < B * L; e += 32) tok_s[e] = d.tokens[base + e];
  }
  pdl_wait();  // the joint's outputs are written
  __syncwarp();

  // the candidates, then B argmax rounds
  float val[SLOTS > 0 ? SLOTS : 1], key[SLOTS > 0 ? SLOTS : 1];
  int ids[SLOTS > 0 ? SLOTS : 1];
  if constexpr (SLOTS > 0) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int c = lane + 32 * s;
      val[s] = 0.f;
      key[s] = -INFINITY;
      ids[s] = 0;
      if (c < nc) {
        val[s] = select_candidate(d, sb, nb, c, frame_on, ids[s]);
        key[s] = select_key(val[s]);
      }
    }
  } else {
    for (int c = lane; c < nc; c += 32) {
      int id;
      const float v = select_candidate(d, sb, nb, c, frame_on, id);
      cval[c] = v;
      ckey[c] = select_key(v);
      cid[c] = id;
    }
    __syncwarp();
  }
  for (int j = 0; j < B; ++j) {
    float bk = -INFINITY;
    int bi = INT_MAX;
    if constexpr (SLOTS > 0) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if (lane + 32 * s < nc) take_first_max(bk, bi, key[s], lane + 32 * s);
      }
    } else {
      for (int c = lane; c < nc; c += 32) take_first_max(bk, bi, ckey[c], c);
    }
    warp_best(bk, bi);
    float pv;
    int pid;
    if constexpr (SLOTS > 0) {  // the owner's slot, broadcast
      const int owner = bi & 31, slot = bi >> 5;
      pv = val[0];
      pid = ids[0];
#pragma unroll
      for (int s = 1; s < SLOTS; ++s) {
        if (s == slot) {
          pv = val[s];
          pid = ids[s];
        }
      }
      pv = __shfl_sync(~0u, pv, owner);
      pid = __shfl_sync(~0u, pid, owner);
      if (lane == owner) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          if (s == slot) key[s] = -INFINITY;
        }
      }
    } else {
      pv = cval[bi];
      pid = cid[bi];
      __syncwarp();  // every lane has read this round's keys
      if (lane == 0) ckey[bi] = -INFINITY;
      __syncwarp();
    }
    if (lane == 0) {
      sb.pick[j] = bi;
      sb.val[j] = pv;
      sb.tok[j] = pid;
    }
  }
  __syncwarp();
  // new beam j (lanes j and j + 32): its parent's fields, its emission
  for (int j = lane; j < B; j += 32) {
    const int c = sb.pick[j], parent = c / K1, kind = c - parent * K1;
    const bool emit = kind > 0;
    const int u = sb.u[parent], nexp = sb.nexp[parent], tok = sb.tok[j];
    const long long h = sb.hash[parent];
    sb.parent[j] = parent;
    sb.u_at[j] = u;
    sb.u_new[j] = emit ? u + 1 : u;
    sb.nexp_new[j] = emit ? nexp + 1 : nexp;
    sb.emits[j] = emit;
    sb.waits[j] = frame_on && !emit;
    sb.hash_new[j] = emit ? static_cast<long long>(
                                static_cast<unsigned>(h) * kHashMul +
                                static_cast<unsigned>(tok + 1))
                          : h;
  }
  __syncwarp();
  // the merge: a beam dies where another of the same hash, length and
  // settledness beats it (higher score; ties: the lower index)
  float score[2] = {0.f, 0.f};
  bool active = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (j >= B) continue;
    const float sj = sb.val[j];
    bool killed = false;
    for (int i = 0; i < B; ++i) {
      const float si = sb.val[i];
      const bool same = sb.hash_new[i] == sb.hash_new[j] &&
                        sb.u_new[i] == sb.u_new[j] && sb.waits[i] == sb.waits[j];
      const bool beats = si > sj || (si == sj && i < j);
      killed |= i != j && same && beats;
    }
    score[h] = killed ? kNeg : sj;
    active |= !sb.waits[j] && score[h] > 0.5f * kNeg;
  }
  // a sample whose live beams have all settled advances its frame
  const bool advance = frame_on && !__any_sync(~0u, active);
  // what the GRU reads first, then its launch may start
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (j >= B) continue;
    const long long r = nb + j;
    d.emit[r] = go && sb.emits[j];
    d.new_tok[r] = sb.tok[j];
    d.src[r] = static_cast<int>(go ? nb + sb.parent[j] : r);
  }
  pdl_launch();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (j >= B) continue;
    const long long r = nb + j;
    if (go) {
      d.scores_out[r] = score[h];
      d.u_out[r] = sb.u_new[j];
      d.nexp_out[r] = advance ? 0 : sb.nexp_new[j];
      d.waiting_out[r] = sb.waits[j] && !advance;
      d.hcode_out[r] = sb.hash_new[j];
    } else {  // the loop's cond is false: the state through
      d.scores_out[r] = sb.score[j];
      d.u_out[r] = sb.u[j];
      d.nexp_out[r] = sb.nexp[j];
      d.waiting_out[r] = sb.wait[j];
      d.hcode_out[r] = sb.hash[j];
    }
  }
  // (where go is false no sample's frame is on: t keeps)
  if (lane == 0) d.t_out[n] = advance ? t + 1 : t;
  if (d.count && n == 0 && lane == 0) d.count_out[0] = d.count[0] + go;
  // the token rows: the parent's, the new token at the parent's u (where
  // go is false, each beam's own)
  const int* rows = d.stage ? tok_s : d.tokens + base;
  if (d.vec) {
    int4* to = reinterpret_cast<int4*>(d.tokens_out + base);
    for (int e = lane; e < B * L / 4; e += 32) {
      const int b = 4 * e / L, l0 = 4 * e - b * L;
      const int from = go ? sb.parent[b] : b;
      int4 v = *reinterpret_cast<const int4*>(rows + from * L + l0);
      if (go && sb.emits[b]) {
        const int at = sb.u_at[b] - l0, tok = sb.tok[b];
        v.x = at == 0 ? tok : v.x;
        v.y = at == 1 ? tok : v.y;
        v.z = at == 2 ? tok : v.z;
        v.w = at == 3 ? tok : v.w;
      }
      to[e] = v;
    }
  } else {
    for (int e = lane; e < B * L; e += 32) {
      const int b = e / L, l = e - b * L;
      d.tokens_out[base + e] =
          !go ? rows[e]
          : sb.emits[b] && l == sb.u_at[b] ? sb.tok[b]
                                            : rows[sb.parent[b] * L + l];
    }
  }
}

template <typename P>
P ptr(long long v) { return reinterpret_cast<P>(v); }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Let kKernel take `bytes` of dynamic shared memory on the current device
// (raised once a device to the most asked of it, before any capture: the
// first call of a shape runs outside a graph).
// `static_bytes`: what the kernel declares itself, which counts against
// the 48 KB a block may take without asking.
template <auto kKernel>
cudaError_t allow_smem(long long bytes, long long static_bytes = 0) {
  static long long allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (bytes + static_bytes <= 48 * 1024 || dev >= 64 || allowed[dev] >= bytes) {
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) allowed[dev] = bytes;
  return e;
}

// One launch on stream s: a cluster of `cluster` blocks along x (0: none),
// and, with DECODE_STEP_PDL, a programmatic edge to the launch before it.
template <auto kKernel, typename Arg>
cudaError_t launch(dim3 grid, int threads, long long smem, int cluster,
                   cudaStream_t s, const Arg& arg) {
  cudaError_t e = allow_smem<kKernel>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute at[2];
  int n = 0;
  if (cluster > 0) {
    at[n].id = cudaLaunchAttributeClusterDimension;
    at[n].val.clusterDim.x = cluster;
    at[n].val.clusterDim.y = 1;
    at[n].val.clusterDim.z = 1;
    ++n;
  }
#if DECODE_STEP_PDL
  at[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[n].val.programmaticStreamSerializationAllowed = 1;
  ++n;
#endif
  cfg.attrs = at;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kKernel, arg);
}

bool plan_ok(const Plan& p, int K) {
  return p.cluster >= 1 && p.cluster <= kMaxCluster && p.stages >= 1 &&
         p.stages <= kMaxStages && p.chunk > 0 && p.chunk % 16 == 0 &&
         p.k_share > 0 && p.k_share % 16 == 0 &&
         static_cast<long long>(p.cluster) * p.k_share >= K;
}

// cuTensorMapEncodeTiled (libcuda's), looked up once through the runtime.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// The rows of a W box: the fewest boxes (at most 256 rows each, a
// multiple of 16) that make a chunk.
int box_rows(int chunk) {
  int boxes = (chunk + 255) / 256;
  while (chunk % boxes != 0 || (chunk / boxes) % 16 != 0) ++boxes;
  return chunk / boxes;
}

template <typename T, bool kFirst>
cudaError_t launch_dense(Dense& d, long long smem, cudaStream_t s) {
  const DenseSmem m = dense_smem(sizeof(T), kFirst, d.concat, d.plan.chunk,
                                 d.plan.stages);
  if (!plan_ok(d.plan, d.K) || m.total != smem) return cudaErrorInvalidValue;
  d.w_rows = box_rows(d.plan.chunk);
  if (d.vec_w) {  // W (K, cols) row-major in boxes of w_rows x 16 columns
    const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dim[2] = {static_cast<cuuint64_t>(d.cols),
                               static_cast<cuuint64_t>(d.K)};
    const cuuint64_t stride[1] = {static_cast<cuuint64_t>(d.cols) * sizeof(T)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kColTile),
                               static_cast<cuuint32_t>(d.w_rows)};
    const cuuint32_t step[2] = {1, 1};
    if (encode(&d.w_map,
               sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               2, const_cast<void*>(d.w), dim, stride, box, step,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  const dim3 grid(d.plan.cluster * ((d.cols + kColTile - 1) / kColTile),
                  (d.rows + kRowTile - 1) / kRowTile);
  return launch<decode_joint_dense_kernel<T, kFirst>>(grid, kThreads, smem,
                                                      d.plan.cluster, s, d);
}

template <typename T>
cudaError_t launch_joint(Dense& hid, long long hid_smem, Dense& out,
                         long long out_smem, cudaStream_t s) {
  const cudaError_t e = launch_dense<T, true>(hid, hid_smem, s);
  if (e != cudaSuccess) return e;
  return launch_dense<T, false>(out, out_smem, s);
}

Plan read_plan(const long long* a) {
  Plan p;
  p.cluster = static_cast<int>(a[0]);
  p.k_share = static_cast<int>(a[1]);
  p.chunk = static_cast<int>(a[2]);
  p.stages = static_cast<int>(a[3]);
  return p;
}

}  // namespace

// decode_joint's argument block (int64 each): enc, t, p0, pred_out, w_pre,
// b_pre, w_out, b_out, hidden scratch, logits scratch, logp (or 0), best
// (or 0), lp_blank, top_lp, top_ids, N, C, F, Fg, rows, H, V, concat, bf16,
// blank, K, stream, then the hidden layer's plan (cluster, K share, chunk,
// stages, dynamic shared bytes) and the logits layer's.  Three launches.
extern "C" int decode_joint(const long long* a) {
  const int N = static_cast<int>(a[15]), rows = static_cast<int>(a[19]);
  const int F = static_cast<int>(a[17]), Fg = static_cast<int>(a[18]);
  const int H = static_cast<int>(a[20]), V = static_cast<int>(a[21]);
  const int concat = static_cast<int>(a[22]);
  const cudaStream_t s = ptr<cudaStream_t>(a[26]);
  Dense hid{};
  hid.enc = ptr<const float*>(a[0]);
  hid.t = ptr<const int*>(a[1]);
  hid.p0 = ptr<const int*>(a[2]);
  hid.g = ptr<const float*>(a[3]);
  hid.w = ptr<const void*>(a[4]);
  hid.b = ptr<const void*>(a[5]);
  hid.out = ptr<void*>(a[8]);
  hid.C = static_cast<int>(a[16]);
  hid.F = F;
  hid.Fg = Fg;
  hid.per_sample = rows / N;
  hid.concat = concat;
  hid.rows = rows;
  hid.K = concat ? F + Fg : F;
  hid.cols = H;
  hid.vec_a = F % 4 == 0 && Fg % 4 == 0 && aligned16(hid.enc) && aligned16(hid.g);
  hid.plan = read_plan(a + 27);
  Dense out = hid;
  out.a = ptr<const void*>(a[8]);
  out.w = ptr<const void*>(a[6]);
  out.b = ptr<const void*>(a[7]);
  out.out = ptr<void*>(a[9]);
  out.K = H;
  out.cols = V;
  out.plan = read_plan(a + 32);
  const int elem = a[23] ? 8 : 4;  // T elements in 16 bytes
  hid.vec_w = H % elem == 0 && aligned16(hid.w);
  out.vec_a = H % elem == 0 && aligned16(out.a);
  out.vec_w = V % elem == 0 && aligned16(out.w);
  const cudaError_t e = a[23] ? launch_joint<bf16>(hid, a[31], out, a[36], s)
                              : launch_joint<float>(hid, a[31], out, a[36], s);
  if (e != cudaSuccess) return static_cast<int>(e);
  Rows r{};
  r.logits = ptr<const float*>(a[9]);
  r.logp = ptr<float*>(a[10]);
  r.best = ptr<int*>(a[11]);
  r.lp_blank = ptr<float*>(a[12]);
  r.top_lp = ptr<float*>(a[13]);
  r.top_ids = ptr<int*>(a[14]);
  r.V = V;
  r.blank = static_cast<int>(a[24]);
  r.K = static_cast<int>(a[25]);
  const cudaError_t er =
      launch<decode_joint_rows_kernel>(dim3(rows), kRowThreads, 0, 0, s, r);
  return static_cast<int>(er != cudaSuccess ? er : cudaGetLastError());
}

// decode_gru's argument block (int64 each): token, emb, h, out_in, w_ih,
// w_hh, b_ih, b_hh, emit (or 0), h_out, out_out, then greedy's t, u,
// emitted_here, frame_bound, tokens, t_out, u_out, eh_out, tokens_out (all
// 0 without), vocab, rows, H, L, blank, max_symbols, stream, src (or 0),
// then the plan: cluster, K share, chunk, stages, dynamic shared bytes,
// rows a block, K groups; then the loop's fold, with greedy's fields only:
// last_tok, last_tok_out, count, count_out (all 0 without).  One launch.
extern "C" int decode_gru(const long long* a) {
  Gru d{};
  d.token = ptr<const int*>(a[0]);
  d.emb = ptr<const float*>(a[1]);
  d.h = ptr<const float*>(a[2]);
  d.out_in = ptr<const float*>(a[3]);
  d.w_ih = ptr<const float*>(a[4]);
  d.w_hh = ptr<const float*>(a[5]);
  d.b_ih = ptr<const float*>(a[6]);
  d.b_hh = ptr<const float*>(a[7]);
  d.emit = ptr<const unsigned char*>(a[8]);
  d.h_out = ptr<float*>(a[9]);
  d.out_out = ptr<float*>(a[10]);
  d.t = ptr<const int*>(a[11]);
  d.u = ptr<const int*>(a[12]);
  d.eh = ptr<const int*>(a[13]);
  d.fb = ptr<const int*>(a[14]);
  d.tokens = ptr<const int*>(a[15]);
  d.t_out = ptr<int*>(a[16]);
  d.u_out = ptr<int*>(a[17]);
  d.eh_out = ptr<int*>(a[18]);
  d.tokens_out = ptr<int*>(a[19]);
  d.vocab = static_cast<int>(a[20]);
  d.rows = static_cast<int>(a[21]);
  d.H = static_cast<int>(a[22]);
  d.L = static_cast<int>(a[23]);
  d.blank = static_cast<int>(a[24]);
  d.max_symbols = static_cast<int>(a[25]);
  const cudaStream_t s = ptr<cudaStream_t>(a[26]);
  d.src = ptr<const int*>(a[27]);
  d.plan = read_plan(a + 28);
  const long long smem = a[32];
  d.row_tile = static_cast<int>(a[33]);
  d.k_groups = static_cast<int>(a[34]);
  d.last_tok = ptr<const int*>(a[35]);
  d.last_tok_out = ptr<int*>(a[36]);
  d.count = ptr<const int*>(a[37]);
  d.count_out = ptr<int*>(a[38]);
  if (d.count && (!d.t_out || !d.last_tok || !d.last_tok_out || !d.count_out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  d.vec = d.H % 4 == 0 && aligned16(d.emb) && aligned16(d.h) &&
          aligned16(d.w_ih) && aligned16(d.w_hh);
  if (d.vec) {  // W_ih, W_hh (3H, H) in boxes of 32 units x 32 k
    const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dim[2] = {static_cast<cuuint64_t>(d.H),
                               3 * static_cast<cuuint64_t>(d.H)};
    const cuuint64_t stride[1] = {static_cast<cuuint64_t>(d.H) * 4};
    const cuuint32_t box[2] = {kGruBox, kGruUnits};
    const cuuint32_t step[2] = {1, 1};
    CUtensorMap* maps[2] = {&d.ih_map, &d.hh_map};
    const float* ws[2] = {d.w_ih, d.w_hh};
    for (int i = 0; i < 2; ++i) {
      if (encode(maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                 const_cast<float*>(ws[i]), dim, stride, box, step,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  const int MT = d.row_tile;
  if (!plan_ok(d.plan, d.H) || (MT != 16 && MT != 32 && MT != kGruMaxRows) ||
      (MT / 4) * 8 * d.k_groups != kThreads ||
      d.plan.chunk % kGruBox != 0 || d.plan.k_share % kGruBox != 0 ||
      gru_smem(MT, d.plan.chunk, d.plan.stages, d.k_groups) != smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(d.plan.cluster * ((d.H + kGruUnits - 1) / kGruUnits),
                  (d.rows + MT - 1) / MT);
  const cudaError_t e =
      launch<decode_gru_kernel>(grid, kThreads, smem, d.plan.cluster, s, d);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// decode_beam_select's argument block (int64 each): t, scores, tokens, u,
// nexp, waiting, hcode, lp_blank, top_lp, top_ids, frame_bound, then t_out,
// scores_out, tokens_out, u_out, nexp_out, waiting_out, hcode_out, emit,
// new_tok, src, then N, B, K, L, max_symbols, stream, then the loop's
// fold: count, count_out (0 and 0 without), then the plan (ops
// select_plan): samples a block, candidate slots a lane (0: in shared
// memory), token rows staged (1 or 0), dynamic shared bytes.  B and K at
// most kMaxK; the entry recomputes the shared bytes and refuses a plan
// that disagrees.  One launch, programmatic on the edge before it.
extern "C" int decode_beam_select(const long long* a) {
  Select d{};
  d.t = ptr<const int*>(a[0]);
  d.scores = ptr<const float*>(a[1]);
  d.tokens = ptr<const int*>(a[2]);
  d.u = ptr<const int*>(a[3]);
  d.nexp = ptr<const int*>(a[4]);
  d.waiting = ptr<const unsigned char*>(a[5]);
  d.hcode = ptr<const long long*>(a[6]);
  d.lp_blank = ptr<const float*>(a[7]);
  d.top_lp = ptr<const float*>(a[8]);
  d.top_ids = ptr<const int*>(a[9]);
  d.fb = ptr<const int*>(a[10]);
  d.t_out = ptr<int*>(a[11]);
  d.scores_out = ptr<float*>(a[12]);
  d.tokens_out = ptr<int*>(a[13]);
  d.u_out = ptr<int*>(a[14]);
  d.nexp_out = ptr<int*>(a[15]);
  d.waiting_out = ptr<unsigned char*>(a[16]);
  d.hcode_out = ptr<long long*>(a[17]);
  d.emit = ptr<unsigned char*>(a[18]);
  d.new_tok = ptr<int*>(a[19]);
  d.src = ptr<int*>(a[20]);
  d.N = static_cast<int>(a[21]);
  d.B = static_cast<int>(a[22]);
  d.K = static_cast<int>(a[23]);
  d.L = static_cast<int>(a[24]);
  d.max_symbols = static_cast<int>(a[25]);
  const cudaStream_t s = ptr<cudaStream_t>(a[26]);
  d.count = ptr<const int*>(a[27]);
  d.count_out = ptr<int*>(a[28]);
  d.warps = static_cast<int>(a[29]);
  d.slots = static_cast<int>(a[30]);
  d.stage = static_cast<int>(a[31]);
  const long long smem = a[32];
  const int nc = d.B * (d.K + 1);
  d.tok_bytes = select_tok_bytes(d.B, d.L, d.stage);
  d.warp_bytes = d.tok_bytes + select_cand_bytes(d.B, d.K, d.slots);
  if (d.B < 1 || d.B > kMaxK || d.K < 1 || d.K > kMaxK || d.N < 1 ||
      (d.count != nullptr) != (d.count_out != nullptr) || d.warps < 1 ||
      d.warps > kSelWarps || (d.stage != 0 && d.stage != 1) ||
      (d.slots != 0 && d.slots != 1 && d.slots != 2 && d.slots != 4) ||
      32 * d.slots < (d.slots ? nc : 0) ||
      static_cast<long long>(d.warps) * d.warp_bytes != smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  d.vec = d.L % 4 == 0 && aligned16(d.tokens) && aligned16(d.tokens_out);
  const dim3 grid((d.N + d.warps - 1) / d.warps);
  const int threads = 32 * d.warps;
  constexpr long long kStatic = sizeof(SelectBeams) * kSelWarps;
  cudaError_t e;
  switch (d.slots) {
    case 1:
      e = allow_smem<decode_beam_select_kernel<1>>(smem, kStatic);
      if (e == cudaSuccess) e = launch<decode_beam_select_kernel<1>>(grid, threads, smem, 0, s, d);
      break;
    case 2:
      e = allow_smem<decode_beam_select_kernel<2>>(smem, kStatic);
      if (e == cudaSuccess) e = launch<decode_beam_select_kernel<2>>(grid, threads, smem, 0, s, d);
      break;
    case 4:
      e = allow_smem<decode_beam_select_kernel<4>>(smem, kStatic);
      if (e == cudaSuccess) e = launch<decode_beam_select_kernel<4>>(grid, threads, smem, 0, s, d);
      break;
    default:
      e = allow_smem<decode_beam_select_kernel<0>>(smem, kStatic);
      if (e == cudaSuccess) e = launch<decode_beam_select_kernel<0>>(grid, threads, smem, 0, s, d);
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// 1 where the launches carry programmatic dependent launch (a build-time
// choice, DECODE_STEP_PDL), else 0.
extern "C" int decode_step_pdl() { return DECODE_STEP_PDL; }

extern "C" const char* decode_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The edges of a captured CUDA graph (a `torch.cuda.CUDAGraph(keep_graph=
// True)`'s raw_cuda_graph()): out[0] the programmatic ones (a launch that
// may start before the one it depends on has ended), out[1] all of them.
extern "C" int decode_graph_edges(long long graph, long long* out) {
#if CUDART_VERSION >= 12030
  const cudaGraph_t g = ptr<cudaGraph_t>(graph);
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &n);
#else
  cudaError_t e = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n);
#endif
  if (e != cudaSuccess) return static_cast<int>(e);
  std::vector<cudaGraphNode_t> from(n), to(n);
  std::vector<cudaGraphEdgeData> data(n);
#if CUDART_VERSION >= 13000
  e = cudaGraphGetEdges(g, from.data(), to.data(), data.data(), &n);
#else
  e = cudaGraphGetEdges_v2(g, from.data(), to.data(), data.data(), &n);
#endif
  if (e != cudaSuccess) return static_cast<int>(e);
  long long programmatic = 0;
  for (size_t i = 0; i < n; ++i) {
    programmatic += data[i].type == cudaGraphDependencyTypeProgrammatic;
  }
  out[0] = programmatic;
  out[1] = static_cast<long long>(n);
  return 0;
#else
  (void)graph;
  (void)out;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}
