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
// Replaces the single-V-block Pallas TPU kernels of
// warp_rnnt_tpu/ops/fused_joint.py:
//   * fj_forward        <- `_fwd_kernel`  (blank, label logit, logZ)
//   * fj_backward_dadc  <- `_bwd_kernel`, its d_a / d_c half
//   * fj_backward_dwdb  <- `_bwd_kernel`, its d_W / d_b half
//   * fj_hidden         <- the h = tanh(a + c) both kernels form in VMEM,
//                          written once to memory for wide joints (below)
// The TPU kernel walks its grid in order and carries d_c, d_W and d_b in
// VMEM from one step to the next.  Hopper runs blocks in no order, so the
// backward is two kernels that each own what they sum, and the sums that
// cross blocks leave as partials that the caller adds in a fixed order
// (deterministic; no atomics).
//
// What bounds them on this card: bf16 tensor-core operations.  At the
// slice's shape (N=16, T=150, U=21, V=5000, H=256; R = N*T*U = 50,400 rows)
// one product R x H x V is 2*R*H*V = 129 GFLOP, 0.130 ms at 989 TFLOP/s.
// The forward does one product (bound 0.130 ms); each backward kernel
// recomputes the logits and does one more (bound 0.261 ms each; the
// backward as a whole needs three products, 0.391 ms).  Bytes are small:
// a, c, W and the (N, T, U) lattices are ~30 MB.
//
// Design (simple first; wgmma, TMA and double-buffered loads are later work):
//   * A tile is 64 lattice rows of one sample: BT = 64 / min(U, 64) whole
//     frames of all U rows, or for U > 64 one frame's rows in chunks of 64.
//     Blocks are numbered sample-major along grid x, so N has no limit
//     beyond the grid's 2^31 - 1 blocks.
//   * V is walked in chunks of 64 columns.  The caller lays W out in chunks
//     ((ceil(V/64), H, 64), zero columns past V), so each chunk is one
//     contiguous block that cp.async copies into shared memory 16 bytes a
//     thread, all copies in flight at once.  The chunk's logits are formed
//     by the 8 warps with `nvcuda::wmma` bf16 16x16x16 products, fp32
//     accumulate.
//   * Forward: a running (max, sum) per row gives logZ over the chunks; the
//     blank and label columns are picked where a chunk holds them.
//   * dadc: per chunk, dz = db*[v==blank] + de*[v==lab] - softmax*(db+de),
//     rounded to bf16, and dh += dz @ W_chunk^T in registers.  At the end
//     dpre = dh * (1 - h^2) (fp32 h) is summed over u into d_a partials
//     (per U chunk) and over t into d_c partials (per tile).
//   * dwdb: one block per (V chunk, row group).  The block walks its rows in
//     tiles of 64, recomputes the chunk's logits from the stored bf16 h,
//     forms dz, and accumulates d_W[:, chunk] += h^T @ dz in registers and
//     d_b[chunk] += sum(dz) in fp32.  Row groups fill the card when V has
//     few chunks.
//   * Rows with t >= xn[n] are skipped: the forward writes zeros there, the
//     backward treats their dz as zero.  A tile with no live row does no
//     product at all.
//
// Any H.  The caller pads H with zero columns of a and c and zero rows of W
// up to S slices of HS columns, HS a multiple of 16 and at most 512 (S =
// ceil(H / 512)): tanh(0) = 0 and a zero row of W adds nothing, and the
// caller cuts d_a, d_c and d_W back.  Two things cap a slice at 512: a
// block's 227 KB of shared memory (a W chunk of HS x 72 and an h tile of
// 64 x (HS + 8) bf16, 167 KB at HS = 512), and registers (dadc's d_h tile
// and dwdb's d_W tile, 64 x HS fp32 over 256 threads: 128 a thread at 512).
//   * S = 1 (H <= 512): each tile's h is built once in shared memory from
//     float4 loads of a and c, dadc writes it out as bf16 (R, H) for dwdb,
//     and a block holds the whole W chunk.  The products are the bound's:
//     one (forward), two (dadc), two (dwdb).
//   * S > 1: fj_hidden writes h as bf16 (R, H) first (R*H*2 bytes, e.g.
//     103 MB at the slice's lattice and H = 1024), and a chunk's logits sum
//     S slice products, each slice's h rows and W rows copied into shared
//     memory in turn.  dadc and dwdb split their output over S blocks a
//     tile (dadc: d_h columns; dwdb: d_W rows), and each block forms the
//     whole logits: S + 1 products instead of 2.  Against the R x H x V
//     bound: forward 1x, dadc and dwdb (S + 1) / 2 each, so 1.5x at
//     H = 640 or 1024 (S = 2), 2.5x at H = 2048 (S = 4).
//
// Launches on the caller's stream; allocates nothing; each entry returns
// cudaGetLastError() (or the error of setting the shared-memory size) so
// the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // lattice rows per tile
constexpr int kVC = 64;        // vocabulary columns per chunk
constexpr int kLdW = kVC + 8;  // bf16 pitch of a W chunk or a dz chunk
constexpr int kLdZ = kVC + 4;  // fp32 pitch of a logits chunk
constexpr int kMaxHS = 512;    // widest H slice (shared memory, registers)

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using ARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using ACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using BRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using BCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;

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

// Dynamic shared memory: ws (HS x kLdW bf16) | hs (kRows x (HS + 8) bf16) |
// zs (kRows x kLdZ fp32) | dzs (kRows x kLdW bf16).  Every part is a
// multiple of 128 bytes when HS is a multiple of 16.
struct Smem {
  bf16* ws;
  bf16* hs;
  float* zs;
  bf16* dzs;
  int ldh;
};

__device__ __forceinline__ Smem carve(unsigned char* base, int HS) {
  Smem s;
  s.ldh = HS + 8;
  s.ws = reinterpret_cast<bf16*>(base);
  s.hs = s.ws + (size_t)HS * kLdW;
  s.zs = reinterpret_cast<float*>(s.hs + (size_t)kRows * s.ldh);
  s.dzs = reinterpret_cast<bf16*>(s.zs + kRows * kLdZ);
  return s;
}

size_t smem_bytes(int HS) {
  return (size_t)HS * kLdW * 2 + (size_t)kRows * (HS + 8) * 2 +
         (size_t)kRows * kLdZ * 4 + (size_t)kRows * kLdW * 2;
}

// Rows [k0, k0 + K) of W chunk v0 / 64 -> ws.  wc is W in chunks,
// (ceil(V/64), H, 64) bf16 with zero columns past V, so a chunk's rows are
// one contiguous block, copied 16 bytes a thread with cp.async (all copies
// in flight at once, no registers).  The caller commits and waits.
__device__ __forceinline__ void load_w_rows(const bf16* __restrict__ wc,
                                            bf16* ws, int H, int v0, int k0,
                                            int K) {
  const bf16* src = wc + ((size_t)(v0 / kVC) * H + k0) * kVC;
  for (int idx = threadIdx.x; idx < K * (kVC / 8); idx += kThreads) {
    const int k = idx >> 3;
    const int part = (idx & 7) * 8;
    __pipeline_memcpy_async(ws + k * kLdW + part, src + k * kVC + part, 16);
  }
}

__device__ __forceinline__ void load_bias(const float* __restrict__ bias,
                                          float* bs, int V, int v0) {
  if (threadIdx.x < kVC) {
    const int v = v0 + threadIdx.x;
    bs[threadIdx.x] = v < V ? bias[v] : 0.0f;
  }
}

// The whole of chunk v0 / 64 of W (H rows) -> ws, b[v0:v0+64] -> bs.  The
// caller syncs the block after.
__device__ __forceinline__ void load_w_chunk(const bf16* __restrict__ wc,
                                             const float* __restrict__ bias,
                                             bf16* ws, float* bs, int H, int V,
                                             int v0) {
  load_w_rows(wc, ws, H, v0, 0, H);
  __pipeline_commit();
  load_bias(bias, bs, V, v0);
  __pipeline_wait_prior(0);
}

// Columns [k0, k0 + K) of rows hrow[r] of h (bf16, (R, H)) -> hs, zeros
// for rows with hrow[r] < 0; cp.async 16 bytes a thread.  The caller
// commits and waits.
__device__ __forceinline__ void load_h_rows(const bf16* __restrict__ h16,
                                            int H, const long long* hrow,
                                            bf16* hs, int ldh, int k0, int K) {
  const int K8 = K / 8;
  for (int idx = threadIdx.x; idx < kRows * K8; idx += kThreads) {
    const int r = idx / K8;
    const int k = (idx - r * K8) * 8;
    const long long row = hrow[r];
    if (row >= 0) {
      __pipeline_memcpy_async(hs + r * ldh + k, h16 + row * H + k0 + k, 16);
    } else {
      *reinterpret_cast<uint4*>(hs + r * ldh + k) = make_uint4(0, 0, 0, 0);
    }
  }
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

// h of the tile's live rows, rounded to bf16, into hs (zeros elsewhere),
// four columns a thread-step; with h16 set, live rows are also written
// there (flat row-major (R, H)).  S = 1 only: hs holds all H columns.
__device__ __forceinline__ void build_h(const Geom& g, const float* __restrict__ a,
                                        const float* __restrict__ c, bf16* hs,
                                        int ldh, int n, int tb, int uc, int xn,
                                        bf16* __restrict__ h16) {
  const int H4 = g.H / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kRows * H4; idx += kThreads) {
    const int r = idx / H4;
    const int k4 = idx - r * H4;
    int t, u;
    uint2 packed = make_uint2(0, 0);
    const bool live = tile_row(g, r, tb, uc, t, u) && t < xn;
    if (live) {
      packed = h4(a, c, ((size_t)n * g.T + t) * g.H + 4 * k4,
                  ((size_t)n * g.U + u) * g.H + 4 * k4);
    }
    *reinterpret_cast<uint2*>(hs + r * ldh + 4 * k4) = packed;
    if (h16 != nullptr && live) {
      *reinterpret_cast<uint2*>(
          h16 + (((size_t)n * g.T + t) * g.U + u) * g.H + 4 * k4) = packed;
    }
  }
}

// acc += hs[:, :K] @ ws[:K, :]: warp w computes rows 16*(w%4).. and column
// tiles 2*(w/4) and 2*(w/4)+1 of the 64 x 64 chunk.
__device__ __forceinline__ void logits_mma(Acc& acc0, Acc& acc1, const Smem& s,
                                           int K, int warp) {
  const int rt = warp & 3;
  const int ct = (warp >> 2) * 2;
  for (int k = 0; k < K; k += 16) {
    ARow fa;
    BRow fb0, fb1;
    wmma::load_matrix_sync(fa, s.hs + rt * 16 * s.ldh + k, s.ldh);
    wmma::load_matrix_sync(fb0, s.ws + k * kLdW + ct * 16, kLdW);
    wmma::load_matrix_sync(fb1, s.ws + k * kLdW + (ct + 1) * 16, kLdW);
    wmma::mma_sync(acc0, fa, fb0, acc0);
    wmma::mma_sync(acc1, fa, fb1, acc1);
  }
}

__device__ __forceinline__ void store_logits(const Smem& s, const Acc& acc0,
                                             const Acc& acc1, int warp) {
  const int rt = warp & 3;
  const int ct = (warp >> 2) * 2;
  wmma::store_matrix_sync(s.zs + rt * 16 * kLdZ + ct * 16, acc0, kLdZ,
                          wmma::mem_row_major);
  wmma::store_matrix_sync(s.zs + rt * 16 * kLdZ + (ct + 1) * 16, acc1, kLdZ,
                          wmma::mem_row_major);
}

// zs = hs @ ws (S = 1: both hold all H rows).
__device__ __forceinline__ void chunk_logits(const Smem& s, int K, int warp) {
  Acc acc0, acc1;
  wmma::fill_fragment(acc0, 0.0f);
  wmma::fill_fragment(acc1, 0.0f);
  logits_mma(acc0, acc1, s, K, warp);
  store_logits(s, acc0, acc1, warp);
}

// zs = h @ W[:, chunk v0 / 64] and bs = its bias, for S > 1: S slice
// products, each slice's h rows (hrow, from h16) and W rows copied into hs
// and ws in turn.  The caller syncs before (the last reads of hs, ws, zs and
// bs done) and after (zs visible).
__device__ __forceinline__ void sliced_logits(const Geom& g, const Smem& s,
                                              const bf16* __restrict__ h16,
                                              const long long* hrow,
                                              const bf16* __restrict__ wc,
                                              const float* __restrict__ bias,
                                              float* bs, int v0, int warp) {
  Acc acc0, acc1;
  wmma::fill_fragment(acc0, 0.0f);
  wmma::fill_fragment(acc1, 0.0f);
  for (int sl = 0; sl < g.S; ++sl) {
    if (sl > 0) __syncthreads();  // the last slice's products are done
    load_h_rows(h16, g.H, hrow, s.hs, s.ldh, sl * g.HS, g.HS);
    load_w_rows(wc, s.ws, g.H, v0, sl * g.HS, g.HS);
    __pipeline_commit();
    if (sl == 0) load_bias(bias, bs, g.V, v0);
    __pipeline_wait_prior(0);
    __syncthreads();
    logits_mma(acc0, acc1, s, g.HS, warp);
  }
  store_logits(s, acc0, acc1, warp);
}

// d logit of one cell: db*[v==blank] + de*[v==lab] - softmax*(db+de).
__device__ __forceinline__ float dlogit(float z, float logz, float db, float de,
                                        int v, int blank, int lab) {
  const float pick = (v == blank ? db : 0.0f) + (v == lab ? de : 0.0f);
  return pick - expf(z - logz) * (db + de);
}

// Per-row metadata of a tile, in static shared memory; hrow is the row's
// index in the flat (R, H) h, or -1 where the row is not live.
struct Rows {
  long long hrow[kRows];
  int live[kRows];
  int lab[kRows];
  float logz[kRows];
  float db[kRows];
  float de[kRows];
};

// Sample, tile and (dadc) H slice of a block of the sample-major grid x.
__device__ __forceinline__ void block_tile(const Geom& g, int slices, int& n,
                                           int& tb, int& uc, int& o) {
  const int tiles = g.ntb * g.nuc;
  const int bid = blockIdx.x;
  const int rest = bid / slices;
  o = bid - rest * slices;
  n = rest / tiles;
  const int tile = rest - n * tiles;
  tb = tile / g.nuc;
  uc = tile - tb * g.nuc;
}

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ a, const float* __restrict__ c,
           const bf16* __restrict__ w, const float* __restrict__ bias,
           const int* __restrict__ lab, const int* __restrict__ xn_arr,
           const bf16* __restrict__ h16, float* __restrict__ blank_out,
           float* __restrict__ emit_out, float* __restrict__ logz_out, Geom g,
           int blank) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float bs[kVC];
  __shared__ long long hrow[kRows];
  const Smem s = carve(smem, g.HS);
  int n, tb, uc, o;
  block_tile(g, 1, n, tb, uc, o);
  const int xn = xn_arr[n];
  const int tid = threadIdx.x;

  // thread -> (row i, quarter q of the chunk's 64 columns)
  const int i = tid >> 2;
  const int q = tid & 3;
  int t, u;
  const bool valid = tile_row(g, i, tb, uc, t, u);
  const bool live = valid && t < xn;
  const size_t cell = ((size_t)n * g.T + t) * g.U + u;

  if (tb * g.bt >= xn) {  // no live row: zeros (the core masks them)
    if (valid && q == 0) {
      blank_out[cell] = 0.0f;
      emit_out[cell] = 0.0f;
      logz_out[cell] = 0.0f;
    }
    return;
  }

  if (g.S == 1) {
    build_h(g, a, c, s.hs, s.ldh, n, tb, uc, xn, nullptr);
  } else if (tid < kRows) {
    int tr, ur;
    const bool lr = tile_row(g, tid, tb, uc, tr, ur) && tr < xn;
    hrow[tid] = lr ? ((long long)n * g.T + tr) * g.U + ur : -1;
  }
  const int my_lab = valid ? lab[(size_t)n * g.U + u] : -1;

  float m = -INFINITY, sum = 0.0f, bl = 0.0f, el = 0.0f;
  for (int v0 = 0; v0 < g.V; v0 += kVC) {
    __syncthreads();  // hs built; the last chunk's ws, zs and bs reads done
    if (g.S == 1) {
      load_w_chunk(w, bias, s.ws, bs, g.H, g.V, v0);
      __syncthreads();
      chunk_logits(s, g.HS, tid >> 5);
    } else {
      sliced_logits(g, s, h16, hrow, w, bias, bs, v0, tid >> 5);
    }
    __syncthreads();
    const int vend = min(kVC, g.V - v0);
    float zl[16];
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = q * 16 + j;
      zl[j] = -INFINITY;
      if (col < vend) {
        const float z = s.zs[i * kLdZ + col] + bs[col];
        zl[j] = z;
        cmax = fmaxf(cmax, z);
        if (v0 + col == blank) bl = z;
        if (v0 + col == my_lab) el = z;
      }
    }
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
    const float mn = fmaxf(m, cmax);  // finite: column 0 of a chunk is < V
    float ps = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) ps += expf(zl[j] - mn);
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    sum = sum * expf(m - mn) + ps;
    m = mn;
  }
  // one lane of the row found each pick; the others hold 0
  bl += __shfl_xor_sync(0xffffffffu, bl, 1);
  bl += __shfl_xor_sync(0xffffffffu, bl, 2);
  el += __shfl_xor_sync(0xffffffffu, el, 1);
  el += __shfl_xor_sync(0xffffffffu, el, 2);
  if (valid && q == 0) {
    blank_out[cell] = live ? bl : 0.0f;
    emit_out[cell] = live ? el : 0.0f;
    logz_out[cell] = live ? m + logf(sum) : 0.0f;
  }
}

// Row metadata of tile rows; rows that are not live get db = de = 0 and
// hrow = -1 (``row`` is the cell's flat index).
__device__ __forceinline__ void load_rows(Rows& rows, int i, bool live, int lab_v,
                                          size_t row,
                                          const float* __restrict__ logz,
                                          const float* __restrict__ dbl,
                                          const float* __restrict__ del) {
  rows.hrow[i] = live ? (long long)row : -1;
  rows.live[i] = live;
  rows.lab[i] = lab_v;
  rows.logz[i] = live ? logz[row] : 0.0f;
  rows.db[i] = live ? dbl[row] : 0.0f;
  rows.de[i] = live ? del[row] : 0.0f;
}

// dz chunk -> dzs (bf16).  Thread layout: any.
__device__ __forceinline__ void chunk_dz(const Smem& s, const float* bs,
                                         const Rows& rows, int v0, int V,
                                         int blank) {
  for (int idx = threadIdx.x; idx < kRows * kVC; idx += kThreads) {
    const int r = idx / kVC;
    const int col = idx - r * kVC;
    float d = 0.0f;
    if (rows.live[r] && v0 + col < V) {
      d = dlogit(s.zs[r * kLdZ + col] + bs[col], rows.logz[r], rows.db[r],
                 rows.de[r], v0 + col, blank, rows.lab[r]);
    }
    s.dzs[r * kLdW + col] = __float2bfloat16(d);
  }
}

// Block (n, tile, o): d_h columns [o*HS, (o+1)*HS) of one tile.
template <int MAXF>
__global__ void __launch_bounds__(kThreads, 1)
dadc_kernel(const float* __restrict__ a, const float* __restrict__ c,
            const bf16* __restrict__ w, const float* __restrict__ bias,
            const int* __restrict__ lab, const int* __restrict__ xn_arr,
            const float* __restrict__ logz, const float* __restrict__ dbl,
            const float* __restrict__ del, float* __restrict__ da_part,
            float* __restrict__ dc_part, bf16* __restrict__ h16, Geom g,
            int blank) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float bs[kVC];
  __shared__ Rows rows;
  const Smem s = carve(smem, g.HS);
  const int H = g.H;
  const int HS = g.HS;
  const int KT = HS / 16;
  int n, tb, uc, o;
  block_tile(g, g.S, n, tb, uc, o);
  const int k0 = o * HS;
  const int xn = xn_arr[n];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  if (tb * g.bt >= xn) {  // no live row: the partials of this tile are zero
    for (int idx = tid; idx < g.bt * HS; idx += kThreads) {
      const int tt = idx / HS;
      const int k = k0 + idx - tt * HS;
      const int t = tb * g.bt + tt;
      if (t < g.T) da_part[(((size_t)n * g.T + t) * g.nuc + uc) * H + k] = 0.0f;
    }
    for (int idx = tid; idx < g.ut * HS; idx += kThreads) {
      const int uu = idx / HS;
      const int k = k0 + idx - uu * HS;
      const int u = uc * g.ut + uu;
      if (u < g.U) dc_part[(((size_t)n * g.ntb + tb) * g.U + u) * H + k] = 0.0f;
    }
    return;
  }

  if (tid < kRows) {
    int t, u;
    const bool valid = tile_row(g, tid, tb, uc, t, u);
    const bool live = valid && t < xn;
    load_rows(rows, tid, live, valid ? lab[(size_t)n * g.U + u] : -1,
              ((size_t)n * g.T + t) * g.U + u, logz, dbl, del);
  }
  if (g.S == 1) build_h(g, a, c, s.hs, s.ldh, n, tb, uc, xn, h16);

  // dh accumulators: warp w holds row tile w%4 and column tiles w/4 + 2f
  // of the block's slice
  const int rt = warp & 3;
  const int half = warp >> 2;
  Acc dh[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(dh[f], 0.0f);

  for (int v0 = 0; v0 < g.V; v0 += kVC) {
    __syncthreads();
    if (g.S == 1) {
      load_w_chunk(w, bias, s.ws, bs, H, g.V, v0);
      __syncthreads();
      chunk_logits(s, HS, warp);
    } else {
      sliced_logits(g, s, h16, rows.hrow, w, bias, bs, v0, warp);
    }
    __syncthreads();
    chunk_dz(s, bs, rows, v0, g.V, blank);
    if (g.S > 1) {  // the slice's W rows, for dh
      load_w_rows(w, s.ws, H, v0, k0, HS);
      __pipeline_commit();
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    for (int ks = 0; ks < kVC; ks += 16) {
      ARow fa;
      wmma::load_matrix_sync(fa, s.dzs + rt * 16 * kLdW + ks, kLdW);
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        const int j = half + 2 * f;
        if (j < KT) {
          BCol fb;  // W^T: element (v, h) = ws[h][v]
          wmma::load_matrix_sync(fb, s.ws + j * 16 * kLdW + ks, kLdW);
          wmma::mma_sync(dh[f], fa, fb, dh[f]);
        }
      }
    }
  }

  // dpre = dh * (1 - h^2), staged in the freed ws/zs space one column half
  // at a time, then summed over u (d_a) and over t (d_c).
  float* stage = reinterpret_cast<float*>(smem);
  const int nf_max = (KT + 1) / 2;
  const int ldst = nf_max * 16 + 4;
  for (int p = 0; p < 2; ++p) {
    const int nf = (KT - p + 1) / 2;  // column tiles j = p + 2f < KT
    const int width = nf * 16;
    __syncthreads();
    if (half == p) {
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        if (f < nf) {
          wmma::store_matrix_sync(stage + rt * 16 * ldst + f * 16, dh[f], ldst,
                                  wmma::mem_row_major);
        }
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int idx = tid; idx < kRows * width; idx += kThreads) {
      const int r = idx / width;
      const int bc = idx - r * width;
      const int k = k0 + (2 * (bc >> 4) + p) * 16 + (bc & 15);
      float d = 0.0f;
      if (rows.live[r]) {
        int t, u;
        tile_row(g, r, tb, uc, t, u);
        const float hv = tanhf(a[((size_t)n * g.T + t) * H + k] +
                               c[((size_t)n * g.U + u) * H + k]);
        d = stage[r * ldst + bc] * (1.0f - hv * hv);
      }
      stage[r * ldst + bc] = d;
    }
    __syncthreads();
    for (int idx = tid; idx < g.bt * width; idx += kThreads) {
      const int tt = idx / width;
      const int bc = idx - tt * width;
      const int t = tb * g.bt + tt;
      if (t >= g.T) continue;
      float acc = 0.0f;
      for (int uu = 0; uu < g.ut; ++uu) acc += stage[(tt * g.ut + uu) * ldst + bc];
      const int k = k0 + (2 * (bc >> 4) + p) * 16 + (bc & 15);
      da_part[(((size_t)n * g.T + t) * g.nuc + uc) * H + k] = acc;
    }
    for (int idx = tid; idx < g.ut * width; idx += kThreads) {
      const int uu = idx / width;
      const int bc = idx - uu * width;
      const int u = uc * g.ut + uu;
      if (u >= g.U) continue;
      float acc = 0.0f;
      for (int tt = 0; tt < g.bt; ++tt) acc += stage[(tt * g.ut + uu) * ldst + bc];
      const int k = k0 + (2 * (bc >> 4) + p) * 16 + (bc & 15);
      dc_part[(((size_t)n * g.ntb + tb) * g.U + u) * H + k] = acc;
    }
  }
}

// Block (V chunk, row group, o): d_W rows [o*HS, (o+1)*HS) of one chunk,
// and (o = 0) its d_b.
template <int MAXF>
__global__ void __launch_bounds__(kThreads, 1)
dwdb_kernel(const bf16* __restrict__ h16, const bf16* __restrict__ w,
            const float* __restrict__ bias, const int* __restrict__ lab,
            const int* __restrict__ xn_arr, const float* __restrict__ logz,
            const float* __restrict__ dbl, const float* __restrict__ del,
            float* __restrict__ dw_part, float* __restrict__ db_part, Geom g,
            int N, int blank, int tiles_per_group) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float bs[kVC];
  __shared__ float dbs[kThreads / kVC][kVC];
  __shared__ Rows rows;
  const Smem s = carve(smem, g.HS);
  const int H = g.H;
  const int HS = g.HS;
  const int KT = HS / 16;
  const int V = g.V;
  const int v0 = blockIdx.x * kVC;
  const int grp = blockIdx.y;
  const int o = blockIdx.z;
  const int k0 = o * HS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long R = (long long)N * g.T * g.U;
  const long long ntile = (R + kRows - 1) / kRows;
  const long long tile0 = (long long)grp * tiles_per_group;
  const long long tile1 = min(ntile, tile0 + tiles_per_group);

  if (g.S == 1) load_w_chunk(w, bias, s.ws, bs, H, V, v0);  // stays

  // d_W accumulators: warp w holds column tile w%4 of the chunk and row
  // tiles (of the slice) w/4 + 2f
  const int vt = warp & 3;
  const int hh = warp >> 2;
  Acc dw[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(dw[f], 0.0f);
  // d_b: thread owns column tid%64 for rows 16*(tid/64) .. +15 of a tile
  const int col = tid & (kVC - 1);
  const int rg = tid / kVC;
  float dbsum = 0.0f;

  for (long long tile = tile0; tile < tile1; ++tile) {
    const long long r0 = tile * kRows;
    __syncthreads();  // the last tile's hs, zs, dzs and bs reads done
    if (tid < kRows) {
      const long long r = r0 + tid;
      bool live = false;
      int lab_v = -1;
      if (r < R) {
        const int n = (int)(r / ((long long)g.T * g.U));
        const int rem = (int)(r - (long long)n * g.T * g.U);
        const int t = rem / g.U;
        const int u = rem - t * g.U;
        live = t < xn_arr[n];
        lab_v = lab[(size_t)n * g.U + u];
      }
      load_rows(rows, tid, live, lab_v, (size_t)r, logz, dbl, del);
    }
    __syncthreads();
    if (g.S == 1) {
      load_h_rows(h16, H, rows.hrow, s.hs, s.ldh, 0, HS);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      chunk_logits(s, HS, warp);
    } else {
      sliced_logits(g, s, h16, rows.hrow, w, bias, bs, v0, warp);
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < 16; ++rr) {
      const int r = rg * 16 + rr;
      float d = 0.0f;
      if (rows.live[r] && v0 + col < V) {
        d = dlogit(s.zs[r * kLdZ + col] + bs[col], rows.logz[r], rows.db[r],
                   rows.de[r], v0 + col, blank, rows.lab[r]);
      }
      dbsum += d;
      s.dzs[r * kLdW + col] = __float2bfloat16(d);
    }
    if (g.S > 1) {  // the slice's h columns, for d_W
      load_h_rows(h16, H, rows.hrow, s.hs, s.ldh, k0, HS);
      __pipeline_commit();
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    for (int ks = 0; ks < kRows; ks += 16) {
      BRow fb;
      wmma::load_matrix_sync(fb, s.dzs + ks * kLdW + vt * 16, kLdW);
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        const int j = hh + 2 * f;
        if (j < KT) {
          ACol fa;  // h^T: element (h, r) = hs[r][h]
          wmma::load_matrix_sync(fa, s.hs + ks * s.ldh + j * 16, s.ldh);
          wmma::mma_sync(dw[f], fa, fb, dw[f]);
        }
      }
    }
  }

  __syncthreads();  // all shared reads done: reuse it as the d_W stage
  float* stage = reinterpret_cast<float*>(smem);  // HS x kLdZ fp32
#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int j = hh + 2 * f;
    if (j < KT) {
      wmma::store_matrix_sync(stage + j * 16 * kLdZ + vt * 16, dw[f], kLdZ,
                              wmma::mem_row_major);
    }
  }
  dbs[rg][col] = dbsum;
  __syncthreads();
  for (int idx = tid; idx < HS * kVC; idx += kThreads) {
    const int k = idx / kVC;
    const int v = idx - k * kVC;
    if (v0 + v < V) {
      dw_part[((size_t)grp * H + k0 + k) * V + v0 + v] = stage[k * kLdZ + v];
    }
  }
  if (o == 0 && tid < kVC && v0 + tid < V) {
    float acc = 0.0f;
    for (int q = 0; q < kThreads / kVC; ++q) acc += dbs[q][tid];
    db_part[(size_t)grp * V + v0 + tid] = acc;
  }
}

// h of every live cell as bf16 rows of (R, H); one block a cell, four
// columns a thread-step (the bits build_h forms).  Rows of cells past xn
// are not written: every reader zeroes them.
__global__ void __launch_bounds__(kThreads)
hidden_kernel(const float* __restrict__ a, const float* __restrict__ c,
              const int* __restrict__ xn_arr, bf16* __restrict__ h16, Geom g) {
  const long long row = blockIdx.x;
  const long long TU = (long long)g.T * g.U;
  const int n = (int)(row / TU);
  const int rem = (int)(row - n * TU);
  const int t = rem / g.U;
  const int u = rem - t * g.U;
  if (t >= xn_arr[n]) return;
  const int H4 = g.H / 4;
  for (int k4 = threadIdx.x; k4 < H4; k4 += kThreads) {
    *reinterpret_cast<uint2*>(h16 + row * g.H + 4 * k4) =
        h4(a, c, ((size_t)n * g.T + t) * g.H + 4 * k4,
           ((size_t)n * g.U + u) * g.H + 4 * k4);
  }
}

// H is the padded width, S its slice count (H = S * HS, HS a multiple of
// 16 up to kMaxHS; the caller checks).
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

bool bad_slices(int H, int S) {
  return S < 1 || H % S != 0 || (H / S) % 16 != 0 || H / S > kMaxHS;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Tiles of one sample along T (times U chunks), for the caller's d_c
// partials: (N, fj_t_tiles, U, H).
extern "C" int fj_t_tiles(int T, int U) { return make_geom(T, U, 16, 1, 1).ntb; }

// U chunks of a frame, for the caller's d_a partials: (N, T, fj_u_chunks, H).
extern "C" int fj_u_chunks(int U) { return make_geom(1, U, 16, 1, 1).nuc; }

extern "C" int fj_hidden(const float* a, const float* c, const int* xn,
                         void* h16, int N, int T, int U, int H, void* stream) {
  if (H % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = make_geom(T, U, H, 1, 1);
  const long long R = (long long)N * T * U;
  hidden_kernel<<<static_cast<unsigned int>(R), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      a, c, xn, static_cast<bf16*>(h16), g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fj_forward(const float* a, const float* c, const void* w,
                          const float* bias, const int* lab, const int* xn,
                          const void* h16, float* blank_out, float* emit_out,
                          float* logz_out, int N, int T, int U, int H, int V,
                          int blank, int S, void* stream) {
  if (bad_slices(H, S)) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = make_geom(T, U, H, V, S);
  const size_t bytes = smem_bytes(g.HS) - (size_t)kRows * kLdW * 2;  // no dzs
  cudaError_t err = set_smem(fwd_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)N * g.ntb * g.nuc;
  fwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, bytes,
               static_cast<cudaStream_t>(stream)>>>(
      a, c, static_cast<const bf16*>(w), bias, lab, xn,
      static_cast<const bf16*>(h16), blank_out, emit_out, logz_out, g, blank);
  return static_cast<int>(cudaGetLastError());
}

// h16: written here when S = 1, read (from fj_hidden) when S > 1.
extern "C" int fj_backward_dadc(const float* a, const float* c, const void* w,
                                const float* bias, const int* lab,
                                const int* xn, const float* logz,
                                const float* db, const float* de,
                                float* da_part, float* dc_part, void* h16,
                                int N, int T, int U, int H, int V, int blank,
                                int S, void* stream) {
  if (bad_slices(H, S)) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = make_geom(T, U, H, V, S);
  const size_t bytes = smem_bytes(g.HS);
  const long long blocks = (long long)N * g.ntb * g.nuc * S;
  const dim3 grid(static_cast<unsigned int>(blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* hb = static_cast<bf16*>(h16);
  cudaError_t err;
  if (g.HS <= 256) {
    err = set_smem(dadc_kernel<8>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dadc_kernel<8><<<grid, kThreads, bytes, st>>>(
        a, c, wb, bias, lab, xn, logz, db, de, da_part, dc_part, hb, g, blank);
  } else {
    err = set_smem(dadc_kernel<16>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dadc_kernel<16><<<grid, kThreads, bytes, st>>>(
        a, c, wb, bias, lab, xn, logz, db, de, da_part, dc_part, hb, g, blank);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fj_backward_dwdb(const void* h16, const void* w,
                                const float* bias, const int* lab,
                                const int* xn, const float* logz,
                                const float* db, const float* de,
                                float* dw_part, float* db_part, int N, int T,
                                int U, int H, int V, int blank, int groups,
                                int S, void* stream) {
  if (bad_slices(H, S) || groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom g = make_geom(T, U, H, V, S);
  const size_t bytes = smem_bytes(g.HS);
  const long long R = (long long)N * T * U;
  const long long ntile = (R + kRows - 1) / kRows;
  const int per = static_cast<int>((ntile + groups - 1) / groups);
  const dim3 grid((V + kVC - 1) / kVC, groups, S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* hb = static_cast<const bf16*>(h16);
  const bf16* wb = static_cast<const bf16*>(w);
  cudaError_t err;
  if (g.HS <= 256) {
    err = set_smem(dwdb_kernel<8>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dwdb_kernel<8><<<grid, kThreads, bytes, st>>>(
        hb, wb, bias, lab, xn, logz, db, de, dw_part, db_part, g, N, blank, per);
  } else {
    err = set_smem(dwdb_kernel<16>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dwdb_kernel<16><<<grid, kThreads, bytes, st>>>(
        hb, wb, bias, lab, xn, logz, db, de, dw_part, db_part, g, N, blank, per);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
