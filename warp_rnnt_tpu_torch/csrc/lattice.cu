// RNN-T lattice sweeps for Hopper (sm_90a): alphas and betas of the
// (N, T, U) gathered lattice, in fp32.
//
// Replaces the Pallas TPU kernels `_fused_kernel` and `_beta_only_kernel`
// (warp_rnnt_tpu/ops/pallas_impl.py).  Same recurrence, same masking, same
// -1e30 sentinel at invalid cells; a log-prob below the sentinel (-inf) is
// read as the sentinel, so a cell whose blank and label are both -inf stays
// finite, as in the JAX scan (the Pallas kernel gives NaN there):
//
//   alpha[t, u] = LSE(alpha[t-1, u] + blank[t-1, u], alpha[t, u-1] + emit[t, u-1])
//   beta[t, u]  = LSE(beta[t+1, u] + blank[t, u],    beta[t, u+1] + emit[t, u])
//
// Each column u is the first-order log-space recurrence
// a[j] = LSE(a[j-1] + m[j], b[j]) along the scan position j (j = t for
// alphas, j = T-1-t for betas), whose b[j] needs the previous column.
//
// What bounds it on this card: not bytes (~0.5 us for the main path's
// lattice) and not the card's arithmetic, but the lattice's own chain of
// dependent logaddexps (T + U - 1 anti-diagonals, each an exp and a log) and
// the issue rate of the one SM a sample's direction runs on (PERF.md gives
// the times beside the chain floor and the byte bound).  The previous
// design solved each column with a block-wide doubling scan: U x
// ceil(T/256) x 19 block barriers a sample (4.4 ms at T=1473, U=299 on an
// H100).
//
// Design: a warp pipeline over the lattice, as in the original CUDA
// warp-rnnt, rebuilt for this card.  One block per (sample, direction):
// grid (N, 2) for the fused sweep, (N, 1) for beta only.  The block's W
// warps own consecutive ranges of 32*K scan positions, each lane K
// consecutive positions (K and W from the wrapper's `lattice_plan`).  A warp
// walks the columns in order; per column each lane folds its K cells, a
// 5-step __shfl_up_sync scan combines the lanes' (m, b) pairs (the combine
// of `_scan_fwd`: b = LSE(b' + m, b), m = m' + m), and the carry that warp
// w-1 published for the same column seeds it.  The chain is thus about
// U + W - 1 warp stages, with no block barrier inside a stage:
//   * the previous column stays in registers (each lane's own cells);
//   * hand-off between neighbouring warps is a ring of 8 carry slots in
//     shared memory per warp, each with a full and an empty mbarrier
//     (arrive releases, try_wait acquires and suspends the waiting lane in
//     hardware); a warp runs ahead of its successor by at most 8 columns;
//   * inputs come off the chain: each warp stages tiles of (its 32*K
//     positions x C columns) of blank and emit in shared memory, two tiles
//     in flight, with 4-byte cp.async.ca.  A row's C columns are contiguous
//     in (N, T, U), so neighbouring lanes copy neighbouring columns of a row
//     (U*4 bytes is not a multiple of 16 at U=21 or 299, so 16-byte copies,
//     1-D bulk copies and TMA's 16-byte strides do not apply to these rows);
//     the inputs are read at an element stride: 1 for blank and emit planes,
//     2 for the channels of the interleaved (N, T, U, 2) lattice that the
//     gather writes, read in place;
//     C is chosen here, from K, W and U (`tile_log2_cols`);
//   * outputs are staged the same way and written a tile at a time, along
//     the rows.
// Past 32 warps x 8 positions a lane (T > 8192) the block sweeps T in
// segments of W*32*K positions; warp 0 of a segment reads its carries from
// the row the previous segment wrote.
// Numerics: the combines run in a fixed order, with no atomics, so two calls
// give bit-equal outputs; the order and the logaddexp (precise expf and
// log1pf) are those of the torch twin (`cuda_impl._solve`), so on the card
// the kernel and the twin agree to rounding of the same operations.
//
// The same library holds the epilogue after the sweep (`epilogue_kernel`,
// below): the costs, the canary and both gradients in one launch.
//
// Launches on the caller's stream; allocates nothing; returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kMaxFrames = 8;   // positions a lane
constexpr int kMaxWarps = 32;
constexpr int kRing = 8;        // carry slots between neighbouring warps
constexpr int kMaxCols = 8;     // columns a staged tile
constexpr int kSmemBudget = 200 << 10;  // of the 227 KB a block may have
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// A log-prob as the sweeps read it: values below the sentinel, -inf among
// them, become the sentinel, so that lae never meets two -inf (|a - b| would
// be NaN where the JAX scan's safe logaddexp gives -inf); a NaN stays NaN.
// Finite log-probs at or above -1e30 pass unchanged.
__device__ __forceinline__ float ld(float x) { return x < kNeg ? kNeg : x; }

// logaddexp on finite sentinel values; fp32, precise expf/log1pf, as the
// twin's `_lae`.
__device__ __forceinline__ float lae(float a, float b) {
  const float mx = fmaxf(a, b);
  return mx + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)),
               "r"(count) : "memory");
}

// Arrive (release): what this thread wrote before is visible to a waiter.
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(b))
               : "memory");
}

// Wait (acquire) until the phase of parity `parity` has completed; the
// thread is suspended in hardware between tries, so a waiting warp does not
// flood the shared-memory pipe that the working warps' shuffles use.
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

struct Args {
  const float* blank;
  const float* emit;
  long long stride;  // elements between a lattice's neighbouring cells
  const int* xn;
  const int* yn;
  float* alphas;
  float* betas;
  int T, U, beta_only;
  int warps;      // the wrapper's `lattice_plan`
  int log2_cols;  // `tile_log2_cols`
};

// Shared memory: full and empty barriers of each warp's carry ring
// ([W][kRing] each), the rings' carries ([W][kRing]), then per warp two
// buffers of two input tiles (blank then emit rows, C columns each) and one
// output tile (`smem_bytes`).  A tile is C columns of P = 32K + 1 floats;
// position p = lane*K + i of the warp sits at i*32 + lane, so a lane's reads
// of its own cells hit 32 different banks.
template <int K>
struct Tile {
  static constexpr int P = 32 * K + 1;
  __device__ static int at(int c, int p) { return c * P + (p % K) * 32 + p / K; }
};

template <int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
lattice_kernel(const Args a) {
  extern __shared__ uint64_t smem_raw[];
  constexpr int P = Tile<K>::P;
  constexpr int kRows = 32 * K;
  const int W = a.warps, lc = a.log2_cols, C = 1 << lc;
  const int T = a.T, U = a.U;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = C * P;
  uint64_t* full = smem_raw;             // [W][kRing]: a carry is in the slot
  uint64_t* empty = full + W * kRing;    // [W][kRing]: the slot was read
  float* ring = reinterpret_cast<float*>(empty + W * kRing);  // [W][kRing]
  float* tiles = ring + W * kRing + w * 5 * tile;  // [buffer 2][blank, emit][C][P]
  float* otile = tiles + 4 * tile;
  for (int i = threadIdx.x; i < W * kRing; i += blockDim.x) {
    mbar_init(full + i, 1);
    mbar_init(empty + i, 1);
  }
  __syncthreads();

  const int n = blockIdx.x;
  const bool alpha_dir = !a.beta_only && blockIdx.y == 0;
  const int xn = a.xn[n];
  const int yn = a.yn[n];
  const size_t base = (size_t)n * T * U;
  const long long st = a.stride;
  const float* bl = a.blank + base * st;
  const float* em = a.emit + base * st;
  float* out = (alpha_dir ? a.alphas : a.betas) + base;
  const int groups = (U + C - 1) >> lc;
  const int seg_len = W * kRows;

  float prev[K];  // this lane's cells of the previous column
#pragma unroll
  for (int i = 0; i < K; ++i) prev[i] = kNeg;

  // Scan position j at step s is cell (t, u) = (j, s) for alphas and
  // (T-1-j, U-1-s) for betas; a tile row dp positions on is row_step floats
  // on.
  auto cell = [&](int j, int s) -> long long {
    return alpha_dir ? (long long)j * U + s
                     : (long long)(T - 1 - j) * U + (U - 1 - s);
  };
  const long long row_step = (long long)(32 >> lc) * (alpha_dir ? U : -U);
  const int p0 = lane >> lc, dp = 32 >> lc;  // this lane's rows in a tile

  for (int seg = 0; seg * seg_len < T; ++seg) {
    const int j0 = seg * seg_len + w * kRows;  // the warp's first position

    // Copy column group g (steps g*C .. g*C+C-1) of the warp's rows into
    // buffer g&1: for step s and position j, the blank that multiplies the
    // carry (m) and the emit that b adds.  Lane l copies column l % C of
    // rows l / C, l / C + 32 / C, ...: neighbouring lanes take neighbouring
    // columns of one row.
    auto issue = [&](int g) {
      const int c = lane & (C - 1), s = g * C + c;
      if (s < U) {
        float* tm = tiles + (g & 1) * 2 * tile;
        float* te = tm + tile;
        const float* src_m = bl + (cell(j0 + p0, s) - (alpha_dir ? U : 0)) * st;
        const float* src_e = em + (cell(j0 + p0, s) - (alpha_dir ? 1 : 0)) * st;
        const long long in_step = row_step * st;
        const bool load_e = !alpha_dir || s > 0;
        for (int p = p0; p < kRows && j0 + p < T;
             p += dp, src_m += in_step, src_e += in_step) {
          const int d = Tile<K>::at(c, p);
          if (!alpha_dir || j0 + p > 0) cp_async4(tm + d, src_m);
          if (load_e) cp_async4(te + d, src_e);
        }
      }
      cp_commit();  // an empty group past the last keeps the count uniform
    };

    issue(0);
    issue(1);
    for (int g = 0; g < groups; ++g) {
      cp_wait_one();
      __syncwarp();
      const float* tm = tiles + (g & 1) * 2 * tile;
      const float* te = tm + tile;
      const int cols = min(C, U - g * C);
      for (int c = 0; c < cols; ++c) {
        const int s = g * C + c;
        const int u = alpha_dir ? s : U - 1 - s;
        // Each lane folds its K cells: pm, pb = the inclusive (m, b) pairs.
        float pm[K], pb[K];
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const int j = j0 + lane * K + i;
          const int at = c * P + i * 32 + lane;
          float m = 0.0f;
          float b = kNeg;
          if (j < T) {
            if (alpha_dir) {
              m = j == 0 ? 0.0f : ld(tm[at]);
              if (u == 0) {
                b = j == 0 ? 0.0f : kNeg;
              } else if (u - 1 < yn && j < xn) {
                b = prev[i] + ld(te[at]);
              }
            } else {
              const int t = T - 1 - j;
              m = ld(tm[at]);
              if (t == xn - 1 && u == yn) {
                b = m;
              } else if (u < yn && t < xn && u + 1 < U) {
                b = ld(te[at]) + prev[i];
              }
            }
          }
          if (i == 0) {
            pm[0] = m;
            pb[0] = b;
          } else {
            pb[i] = lae(pb[i - 1] + m, b);
            pm[i] = pm[i - 1] + m;
          }
        }
        // Inclusive scan of the lanes' pairs, then each lane's exclusive one.
        float M = pm[K - 1], B = pb[K - 1];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          float ms = __shfl_up_sync(kFull, M, d);
          float bs = __shfl_up_sync(kFull, B, d);
          if (lane < d) {  // the identity (0, kNeg): B and M pass unchanged
            ms = 0.0f;
            bs = kNeg;
          }
          B = lae(bs + M, B);
          M = ms + M;
        }
        float me = __shfl_up_sync(kFull, M, 1);
        float be = __shfl_up_sync(kFull, B, 1);
        if (lane == 0) {
          me = 0.0f;
          be = kNeg;
        }
        // The value at the position before the warp's first: from warp w-1
        // through the ring, or from the row the previous segment wrote.
        const int sg = seg * U + s;  // columns walked by this block so far
        const int slot = sg & (kRing - 1), round = sg / kRing;
        float v = kNeg;
        if (lane == 0) {
          if (w > 0) {
            const int at = (w - 1) * kRing + slot;
            mbar_wait(full + at, round & 1);
            v = ring[at];
            mbar_arrive(empty + at);
          } else if (seg > 0) {
            const int t = alpha_dir ? j0 - 1 : T - j0;
            v = out[(size_t)t * U + u];
          }
        }
        const float cin = __shfl_sync(kFull, v, 0);
        if (w + 1 < W && lane == 31) {
          const float carry = lae(cin + M, B);
          const int at = w * kRing + slot;
          if (round > 0) mbar_wait(empty + at, (round - 1) & 1);
          ring[at] = carry;
          mbar_arrive(full + at);
        }
        const float ain = lae(cin + me, be);
#pragma unroll
        for (int i = 0; i < K; ++i) {
          prev[i] = lae(ain + pm[i], pb[i]);
          otile[c * P + i * 32 + lane] = prev[i];
        }
      }
      __syncwarp();
      // Write the group's columns along the rows.
      {
        const int c = lane & (C - 1);
        if (c < cols) {
          float* dst = out + cell(j0 + p0, g * C + c);
          for (int p = p0; p < kRows && j0 + p < T; p += dp, dst += row_step) {
            *dst = otile[Tile<K>::at(c, p)];
          }
        }
      }
      __syncwarp();
      issue(g + 2);
    }
    cp_wait_all();
    __syncthreads();  // the segment's last row is visible to the next
  }
}

// A probe of the chain's step: one thread walks n dependent logaddexps of
// the recurrence's form, a = LSE(a + m, b).
__global__ void lae_probe_kernel(float* out, int n) {
  float a = out[0], m = out[1], b = out[2];
  for (int i = 0; i < n; ++i) {
    a = lae(a + m, b);
    b -= 1.0e-3f;
  }
  out[0] = a;
}

using Kernel = void (*)(Args);
const Kernel kKernels[kMaxFrames] = {
    lattice_kernel<1>, lattice_kernel<2>, lattice_kernel<3>, lattice_kernel<4>,
    lattice_kernel<5>, lattice_kernel<6>, lattice_kernel<7>, lattice_kernel<8>};

// The layout that `lattice_kernel` carves: per warp a full and an empty
// barrier (8 bytes each) and a carry for each ring slot, two buffers of two
// input tiles and one output tile of `cols` x (32 * frames + 1) floats.
int smem_bytes(int frames, int warps, int cols) {
  return warps * (20 * kRing + 4 * 5 * cols * (32 * frames + 1));
}

// The widest tile, a power of two of at most kMaxCols columns and no wider
// than U needs, that fits the budget (one column always does).
int tile_log2_cols(int frames, int warps, int U) {
  int lc = 0;
  while ((1 << lc) < kMaxCols && (1 << lc) < U &&
         smem_bytes(frames, warps, 2 << lc) <= kSmemBudget) {
    ++lc;
  }
  return lc;
}

bool valid_plan(int frames, int warps) {
  return frames >= 1 && frames <= kMaxFrames && warps >= 1 &&
         warps <= kMaxWarps;
}

// Whether kernel K on a device may take kSmemBudget bytes: set once, the
// first time a launch needs more than the default 48 KB.
std::atomic<bool> g_opted_in[kMaxDevices][kMaxFrames];

cudaError_t opt_in(int frames, int smem) {
  if (smem <= (48 << 10)) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<bool>* done =
      dev < kMaxDevices ? &g_opted_in[dev][frames - 1] : nullptr;
  if (done != nullptr && done->load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kKernels[frames - 1],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBudget);
  if (err == cudaSuccess && done != nullptr) {
    done->store(true, std::memory_order_release);
  }
  return err;
}

// ---- The epilogue after the sweep -----------------------------------------
//
// Everything `functional/postprocess.costs_and_grads` computes from the
// alphas and betas, in one launch (in JAX, XLA fuses that code and the
// gradients' stack and cast around the Pallas sweep):
//
//   ll_f = alpha[t_last, u_last] + blank[t_last, u_last], ll_b = beta[0, 0]
//     (t_last = xn - 1, wrapped once if negative, then clamped; u_last = yn
//     clamped: JAX's indexing);
//   bad  = |ll_f - ll_b| / |max(ll_f, ll_b)| > 0.001 (NaN compares false);
//   cost = bad ? -(ll_f + ll_b) * 0.5 : -ll_b;
//   g_blank = valid_b ? -exp(alpha + blank + (terminal ? 0 : beta[t+1]) - ll_b) : 0
//   g_emit  = valid_e ? -(1 + lambda) * exp(alpha + emit + beta[u+1] - ll_b) : 0
//   both times keep = bad ? 0 : 1, then rounded once to the output dtype.
//
// Each value is computed with the plain version's operations in its order
// (the 0 added at the terminal cell, precise expf, the keep multiply, not a
// select, round-to-nearest-even), so the two agree bit for bit.  What bounds
// it: bytes (alpha, beta, blank, emit read, two gradients written: ~24 B a
// cell in fp32).  Design: one 1-D grid; a sample's T*U cells are tiled by
// blocks of kEpiThreads x kEpiCells cells, thread 0 of each block reads the
// sample's lengths and log-likelihoods once, and neighbouring threads take
// neighbouring cells.  Inputs and outputs take an element stride (1:
// planes; 2: the channels of an interleaved (N, T, U, 2) tensor, moved two
// at a time where the two channels are neighbours).

constexpr int kEpiThreads = 256;
constexpr int kEpiCells = 4;  // cells a thread

// An output element from the fp32 value, rounded once.
template <typename O>
__device__ __forceinline__ O to_out(float x);
template <>
__device__ __forceinline__ float to_out<float>(float x) { return x; }
template <>
__device__ __forceinline__ double to_out<double>(float x) {
  return static_cast<double>(x);
}
template <>
__device__ __forceinline__ __half to_out<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename O>
struct alignas(2 * sizeof(O)) Pair {
  O x, y;
};

struct EpiArgs {
  const float* blank;
  const float* emit;
  long long in_stride;
  const float* alphas;
  const float* betas;
  const int* xn;
  const int* yn;
  float* costs;
  bool* bad;
  void* g_blank;
  void* g_emit;
  long long out_stride;
  int T, U;
  int tiles;        // blocks a sample
  float emit_coef;  // -(1 + lambda), rounded to fp32 as torch rounds it
  bool in_pair;     // emit is blank's neighbour, read as one 8-byte pair
  bool out_pair;    // g_emit is g_blank's neighbour, written as one pair
};

template <typename O>
__global__ void __launch_bounds__(kEpiThreads)
epilogue_kernel(const EpiArgs a) {
  __shared__ float s_ll, s_keep;
  __shared__ int s_xn, s_yn;
  const int n = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles;
  const int T = a.T, U = a.U;
  const long long cells = static_cast<long long>(T) * U;
  const long long base = n * cells;
  if (threadIdx.x == 0) {
    const int xn = a.xn[n], yn = a.yn[n];
    int tl = xn - 1;
    if (tl < 0) tl += T;
    tl = min(max(tl, 0), T - 1);
    const int ul = min(max(yn, 0), U - 1);
    const long long at = base + static_cast<long long>(tl) * U + ul;
    const float ll_b = a.betas[base];
    const float ll_f = a.alphas[at] + a.blank[at * a.in_stride];
    // torch.maximum: NaN if either is NaN
    const float mx = (ll_f != ll_f || ll_b != ll_b) ? __int_as_float(0x7fc00000)
                                                   : fmaxf(ll_f, ll_b);
    const float ratio = fabsf(ll_f - ll_b) / fabsf(mx);
    const bool bad = ratio > 0.001f;
    if (tile == 0) {
      a.costs[n] = bad ? -(ll_f + ll_b) * 0.5f : -ll_b;
      a.bad[n] = bad;
    }
    s_ll = ll_b;
    s_keep = bad ? 0.0f : 1.0f;
    s_xn = xn;
    s_yn = yn;
  }
  __syncthreads();
  const float ll = s_ll, keep = s_keep;
  const int xn = s_xn, yn = s_yn;
  const float inf = __int_as_float(0xff800000);  // -inf past the lattice
  O* gb = static_cast<O*>(a.g_blank);
  O* ge = static_cast<O*>(a.g_emit);
  const long long c0 = static_cast<long long>(tile) * kEpiThreads * kEpiCells;
#pragma unroll
  for (int k = 0; k < kEpiCells; ++k) {
    const long long c = c0 + k * kEpiThreads + threadIdx.x;
    if (c >= cells) break;
    const int t = static_cast<int>(c / U), u = static_cast<int>(c - static_cast<long long>(t) * U);
    const long long i = base + c;
    float bl, em;
    if (a.in_pair) {
      const float2 v = reinterpret_cast<const float2*>(a.blank)[i];
      bl = v.x;
      em = v.y;
    } else {
      bl = a.blank[i * a.in_stride];
      em = a.emit[i * a.in_stride];
    }
    const float al = a.alphas[i];
    const float bt1 = t + 1 < T ? a.betas[i + U] : inf;
    const float bu1 = u + 1 < U ? a.betas[i + 1] : inf;
    const bool terminal = t == xn - 1 && u == yn;
    const float occ_b = ((al + bl) + (terminal ? 0.0f : bt1)) - ll;
    const float occ_e = ((al + em) + bu1) - ll;
    float g0 = t < xn && u <= yn ? -expf(occ_b) : 0.0f;
    float g1 = t < xn && u < yn ? a.emit_coef * expf(occ_e) : 0.0f;
    g0 = g0 * keep;
    g1 = g1 * keep;
    if (a.out_pair) {
      reinterpret_cast<Pair<O>*>(gb)[i] = Pair<O>{to_out<O>(g0), to_out<O>(g1)};
    } else {
      gb[i * a.out_stride] = to_out<O>(g0);
      ge[i * a.out_stride] = to_out<O>(g1);
    }
  }
}

using EpiKernel = void (*)(EpiArgs);
// by output dtype: 0 float32, 1 float64, 2 float16, 3 bfloat16
const EpiKernel kEpiKernels[4] = {epilogue_kernel<float>, epilogue_kernel<double>,
                                  epilogue_kernel<__half>,
                                  epilogue_kernel<__nv_bfloat16>};
const int kOutSize[4] = {4, 8, 2, 2};

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// The sweep.  frames (K) and warps are the wrapper's `lattice_plan(T)`; the
// tile width and the shared bytes follow from them and U.  blank and emit
// are read at an element stride of `stride` floats (alphas and betas are
// written contiguous).
extern "C" int rnnt_lattice(const float* blank, const float* emit,
                            int stride, const int* xn, const int* yn,
                            float* alphas, float* betas, int N, int T, int U,
                            int compute_alpha, void* stream, int frames,
                            int warps) {
  if (!valid_plan(frames, warps) || stride < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lc = tile_log2_cols(frames, warps, U);
  const int smem = smem_bytes(frames, warps, 1 << lc);
  const cudaError_t err = opt_in(frames, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{blank, emit, stride, xn, yn, alphas, betas, T, U,
               compute_alpha ? 0 : 1, warps, lc};
  const dim3 grid(N, compute_alpha ? 2 : 1);
  kKernels[frames - 1]<<<grid, warps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// What the sweep takes at (frames, warps, U): out = registers a thread,
// local memory bytes a thread (spills), static shared memory bytes, the
// tile's log2 columns and the dynamic shared memory bytes.
extern "C" int rnnt_lattice_attrs(int frames, int warps, int U, int* out) {
  if (!valid_plan(frames, warps) || U < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kKernels[frames - 1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lc = tile_log2_cols(frames, warps, U);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = lc;
  out[4] = smem_bytes(frames, warps, 1 << lc);
  return 0;
}

// n dependent logaddexps on one thread; io[0..2] = a, m, b in, a out.
extern "C" int rnnt_lae_probe(float* io, int n, void* stream) {
  lae_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(io, n);
  return static_cast<int>(cudaGetLastError());
}

// The epilogue: costs (N,) fp32 and the canary's mask (N,) bool, and the
// blank and emit gradients of the (N, T, U) lattice written at an element
// stride of `out_stride` in `out_dtype` (0 float32, 1 float64, 2 float16,
// 3 bfloat16); blank and emit are read at `in_stride` floats, alphas and
// betas contiguous.  emit_coef is -(1 + fastemit_lambda) in fp32.
extern "C" int rnnt_lattice_epilogue(
    const float* blank, const float* emit, int in_stride, const float* alphas,
    const float* betas, const int* xn, const int* yn, float* costs, bool* bad,
    void* g_blank, void* g_emit, int out_stride, int out_dtype, int N, int T,
    int U, float emit_coef, void* stream) {
  if (N < 1 || T < 1 || U < 1 || in_stride < 1 || out_stride < 1 ||
      out_dtype < 0 || out_dtype > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long cells = static_cast<long long>(T) * U;
  const long long tiles = (cells + kEpiThreads * kEpiCells - 1) /
                          (kEpiThreads * kEpiCells);
  if (tiles * N > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int size = kOutSize[out_dtype];
  EpiArgs a{blank, emit, in_stride, alphas, betas, xn, yn, costs, bad,
            g_blank, g_emit, out_stride, T, U, static_cast<int>(tiles),
            emit_coef, false, false};
  a.in_pair = in_stride == 2 && emit == blank + 1 && aligned(blank, 8);
  a.out_pair = out_stride == 2 &&
               static_cast<char*>(g_emit) == static_cast<char*>(g_blank) + size &&
               aligned(g_blank, 2 * size);
  kEpiKernels[out_dtype]<<<static_cast<unsigned>(tiles * N), kEpiThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rnnt_lattice_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
