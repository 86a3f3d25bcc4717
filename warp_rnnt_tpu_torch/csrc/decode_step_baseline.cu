// The decode step's first kernels for Hopper (sm_90a), kept beside
// `decode_step.cu` as the yardstick its redesign is timed against, in turns
// on one card (`benchmarks/decode_step_cases.BASELINE`); the decoders never
// load it.  Its entries read the first 27 (decode_joint), 28 (decode_gru)
// and 29 (decode_beam_select) fields of `decode_step.cu`'s argument
// blocks, which keep these fields in this order, so the same wrappers
// drive both libraries.
//
// decode_joint, three launches: two dense layers of blocks of 32 rows x 16
// columns that walk K in chunks of 128 (each chunk's 16-byte loads issued
// before the last chunk's products), then a block a row for log_softmax
// and greedy's argmax or beam's blank log-prob and top-K.  decode_gru, one
// launch: blocks of 32 rows x 4 hidden units over K in chunks of 128, a
// lane a row; greedy's masked update folded in; beam's row map.  The
// arithmetic and its roundings are `decode_step.cu`'s, the sums in another
// order.  decode_beam_select, one launch: beam search's selection as it
// was first written, one block of 256 threads a sample (the candidates in
// shared memory, B block-wide argmax rounds, a block barrier between each
// part), launched plainly; with the loop's count, its mask and count
// folded in.  It equals `decode_step.cu`'s selection bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;      // dense and GRU blocks: four warps
constexpr int kRowTile = 32;       // rows a dense or GRU block
constexpr int kColTile = 16;       // output columns a dense block
constexpr int kChunk = 128;        // K a shared-memory stage
constexpr int kUnits = 4;          // GRU hidden units a block, one a warp
constexpr int kRowThreads = 256;   // rows_kernel: threads a row
constexpr int kMaxK = 64;          // top-K labels a row, at most (ops MAX_K)
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

// One dense layer of the joint: out = epilogue(A W + b), A (rows, K), W
// (K, cols) row-major in T (Flax's (in, out) layout), b (cols,).  kFirst:
// A is combine(frame, g) and the epilogue is tanh into T; else A is the
// (rows, K) T matrix `a` and the epilogue writes fp32 logits.  vec: every
// row of the inputs starts on 16 bytes and holds whole 16-byte groups
// (F and Fg multiples of 4 with kFirst; K, and cols, multiples of 16 bytes
// of T), so the stages load 16 bytes a thread at a time.
struct Dense {
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
};

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(bf16 x) { return __bfloat16_as_ushort(x); }

// 16 bytes of T from p, the first `valid` elements (zeros past them): one
// vector load where `vec` and the group is whole, else element by element.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int valid, bool vec) {
  constexpr int n = 16 / sizeof(T), per = 4 / sizeof(T);
  if (vec && valid >= n) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if (j < valid) w[j / per] |= bits(p[j]) << ((32 / per) * (j % per));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float4 load4(const float* p, int valid, bool vec) {
  if (vec && valid >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) v.x = p[0];
  if (valid > 1) v.y = p[1];
  if (valid > 2) v.z = p[2];
  if (valid > 3) v.w = p[3];
  return v;
}

// A block computes kRowTile rows x kColTile columns over K in chunks of
// kChunk: each chunk's inputs and weight slice go from device memory into
// registers (16-byte loads, all issued before the first is used), then
// into shared memory; the next chunk's loads are issued before this
// chunk's products, so they are in flight while the products run.
template <typename T, bool kFirst>
__global__ void __launch_bounds__(kThreads)
decode_joint_dense_kernel(const Dense d) {
  constexpr int kVec = 16 / sizeof(T);  // T elements in 16 bytes
  constexpr int kPad = kVec;  // rows of 16-byte multiples, skewed banks
  // groups a thread stages a chunk: of 4 k (kFirst, fp32 sources) or of
  // kVec k (a T matrix); of kVec columns of the weights
  constexpr int kAG = kRowTile * kChunk / (kFirst ? 4 : kVec) / kThreads;
  constexpr int kAGroupsRow = kChunk / (kFirst ? 4 : kVec);
  constexpr int kWG = kChunk * kColTile / kVec / kThreads;
  constexpr int kWGroupsRow = kColTile / kVec;
  __shared__ __align__(16) T As[kRowTile][kChunk + kPad];
  __shared__ __align__(16) T Ws[kChunk][kColTile + kPad];
  __shared__ const float* frow[kRowTile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * kRowTile, c0 = blockIdx.x * kColTile;
  if (kFirst && tid < kRowTile) {
    const int row = r0 + tid;
    const float* p = nullptr;
    if (row < d.rows) {
      const int s = row / d.per_sample;
      const int fr = min(max(d.t[s] - *d.p0, 0), d.C - 1);
      p = d.enc + (static_cast<long long>(s) * d.C + fr) * d.F;
    }
    frow[tid] = p;
  }
  __syncthreads();
  const T* W = static_cast<const T*>(d.w);
  const T* A = static_cast<const T*>(d.a);
  float4 fa[kFirst ? kAG : 1], ga[kFirst ? kAG : 1];
  uint4 aa[kFirst ? 1 : kAG], wa[kWG];

  auto load = [&](int k0) {
    const int kn = min(kChunk, d.K - k0);
#pragma unroll
    for (int i = 0; i < kAG; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kAGroupsRow, row = r0 + r;
      if constexpr (kFirst) {
        const int k = (e % kAGroupsRow) * 4, kk = k0 + k;
        const int valid = row < d.rows ? kn - k : 0;
        const float* gr = d.g + static_cast<long long>(row) * d.Fg;
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f), g = f;
        if (!d.concat) {
          f = load4(frow[r] + kk, valid, d.vec_a);
          g = load4(gr + kk, valid, d.vec_a);
        } else if (d.vec_a) {  // a group lies in f or in g
          if (kk < d.F) {
            f = load4(frow[r] + kk, valid, true);
          } else {
            g = load4(gr + kk - d.F, valid, true);
          }
        } else {
          float fv[4] = {0.f, 0.f, 0.f, 0.f}, gv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q < valid) {
              if (kk + q < d.F) {
                fv[q] = frow[r][kk + q];
              } else {
                gv[q] = gr[kk + q - d.F];
              }
            }
          }
          f = make_float4(fv[0], fv[1], fv[2], fv[3]);
          g = make_float4(gv[0], gv[1], gv[2], gv[3]);
        }
        fa[i] = f;
        ga[i] = g;
      } else {
        const int k = (e % kAGroupsRow) * kVec;
        const int valid = row < d.rows ? kn - k : 0;
        aa[i] = load16(A + static_cast<long long>(row) * d.K + k0 + k, valid,
                       d.vec_a);
      }
    }
#pragma unroll
    for (int i = 0; i < kWG; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / kWGroupsRow, c = (e % kWGroupsRow) * kVec;
      const int valid = k < kn ? d.cols - (c0 + c) : 0;
      wa[i] = load16(W + static_cast<long long>(k0 + k) * d.cols + c0 + c,
                     valid, d.vec_w);
    }
  };

  auto store = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAG; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kAGroupsRow;
      if constexpr (kFirst) {
        const int k = (e % kAGroupsRow) * 4, kk = k0 + k;
        const float f[4] = {fa[i].x, fa[i].y, fa[i].z, fa[i].w};
        const float g[4] = {ga[i].x, ga[i].y, ga[i].z, ga[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // concat: f or g rounded to T; add: both rounded, their sum rounded
          const float v = d.concat ? rnd<T>(kk + q < d.F ? f[q] : g[q])
                                   : rnd<T>(rnd<T>(f[q]) + rnd<T>(g[q]));
          As[r][k + q] = from_f<T>(v);
        }
      } else {
        const int k = (e % kAGroupsRow) * kVec;
        *reinterpret_cast<uint4*>(&As[r][k]) = aa[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kWG; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / kWGroupsRow, c = (e % kWGroupsRow) * kVec;
      *reinterpret_cast<uint4*>(&Ws[k][c]) = wa[i];
    }
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  load(0);
  for (int k0 = 0; k0 < d.K; k0 += kChunk) {
    const int kn = min(kChunk, d.K - k0);
    __syncthreads();  // the last chunk's products have read the stage
    store(k0);
    __syncthreads();
    if (k0 + kChunk < d.K) load(k0 + kChunk);
    if constexpr (sizeof(T) == 2) {
      // warp w: rows (w / 2) * 16 .. + 16, columns (w % 2) * 8 .. + 8
      const int mt = warp >> 1, nt = warp & 1;
      for (int kk = 0; kk < kn; kk += 16) {
        uint32_t a[4], b[2];
        ldmatrix_x4(a, &As[mt * 16 + (lane & 15)][kk + ((lane >> 4) << 3)]);
        ldmatrix_x2_trans(b, &Ws[kk + (lane & 15)][nt * 8]);
        mma_bf16(acc, a, b);
      }
    } else {
      // thread: column tid % 16, rows tid / 16 + 8 i
      const int n = tid & 15, rg = tid >> 4;
      for (int k = 0; k < kn; ++k) {
        const float w = to_f(Ws[k][n]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(to_f(As[rg + 8 * i][k]), w, acc[i]);
      }
    }
  }
  const T* B = static_cast<const T*>(d.b);
  auto put = [&](int row, int col, float v) {
    if (row >= d.rows || col >= d.cols) return;
    const float y = rnd<T>(rnd<T>(v) + to_f(B[col]));
    const long long o = static_cast<long long>(row) * d.cols + col;
    if (kFirst) {
      static_cast<T*>(d.out)[o] = from_f<T>(tanhf(y));
    } else {
      static_cast<float*>(d.out)[o] = y;
    }
  };
  if constexpr (sizeof(T) == 2) {
    // the m16n8 accumulator: (row g, columns 2c, 2c+1), then row g + 8
    const int row = r0 + (warp >> 1) * 16 + (lane >> 2);
    const int col = c0 + (warp & 1) * 8 + 2 * (lane & 3);
    put(row, col, acc[0]);
    put(row, col + 1, acc[1]);
    put(row + 8, col, acc[2]);
    put(row + 8, col + 1, acc[3]);
  } else {
    const int n = tid & 15, rg = tid >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) put(r0 + rg + 8 * i, c0 + n, acc[i]);
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
  int vocab, rows, H, L, blank, max_symbols;
};

__device__ __forceinline__ bool greedy_emit(const Gru& d, int row, bool& active) {
  active = d.t[row] < d.fb[row];
  return active && d.token[row] != d.blank && d.u[row] < d.L &&
         d.eh[row] < d.max_symbols;
}

// The row of h and out that row `row` (< rows) reads.
__device__ __forceinline__ int src_row(const Gru& d, int row) {
  return d.src ? d.src[row] : row;
}

// block (x, y): hidden units x * 4 + warp, rows y * 32 + lane.  Over K in
// chunks of kChunk, the rows' states and embeddings and the block's 24
// weight rows (r, z, n of W_ih and W_hh for its 4 units) go from device
// memory into registers (16-byte loads where vec: H a multiple of 4), then
// into shared memory, the next chunk's loads issued before this chunk's
// products; a lane reads its row's values as 16-byte words (conflict-free:
// rows 132 floats apart), a warp its unit's weights as broadcasts.  A
// block none of whose rows emits only copies.
__global__ void __launch_bounds__(kThreads) decode_gru_kernel(const Gru d) {
  constexpr int kStride = kChunk + 4;
  constexpr int kWRows = 6 * kUnits;  // (W_ih, W_hh) x (r, z, n) x units
  constexpr int kAG = kRowTile * kChunk / 4 / kThreads;  // per input
  constexpr int kWG = kWRows * kChunk / 4 / kThreads;
  __shared__ __align__(16) float Ah[kRowTile][kStride];
  __shared__ __align__(16) float Ae[kRowTile][kStride];
  __shared__ __align__(16) float Ws[kWRows][kStride];
  __shared__ int put_at[kRowTile];  // greedy: where a row writes its token
  __shared__ int put_tok[kRowTile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * kRowTile, row = r0 + lane;
  const int j0 = blockIdx.x * kUnits, j = j0 + warp, H = d.H;
  if (d.t_out && blockIdx.x == 0) {  // greedy: the integer fields, the tokens
    if (warp == 0) {
      int at = -1, tok = 0;
      if (row < d.rows) {
        bool active;
        const bool em = greedy_emit(d, row, active);
        const int t = d.t[row], u = d.u[row];
        d.t_out[row] = active && !em ? t + 1 : t;
        d.u_out[row] = em ? u + 1 : u;
        d.eh_out[row] = em ? d.eh[row] + 1 : 0;
        at = em ? u : -1;
        tok = d.token[row];
      }
      put_at[lane] = at;
      put_tok[lane] = tok;
    }
    __syncthreads();
    const int n = min(kRowTile, d.rows - r0) * d.L;
    const long long base = static_cast<long long>(r0) * d.L;
#pragma unroll 4
    for (int e = tid; e < n; e += kThreads) {
      const int r = e / d.L, l = e - r * d.L;
      d.tokens_out[base + e] = l == put_at[r] ? put_tok[r] : d.tokens[base + e];
    }
  }
  const bool live = j < H && row < d.rows;
  bool active = false;
  const bool emit = live && (d.t_out ? greedy_emit(d, row, active)
                                     : d.emit[row] != 0);
  const long long o = static_cast<long long>(row) * H + j;
  // where row reads: its parent's row under a row map
  const long long oi =
      row < d.rows ? static_cast<long long>(src_row(d, row)) * H + j : o;
  if (!__syncthreads_or(emit)) {
    if (live) {
      d.h_out[o] = d.h[oi];
      d.out_out[o] = d.out_in[oi];
    }
    return;
  }
  const bool vec = H % 4 == 0;
  float4 ha[kAG], ea[kAG], wa[kWG];
  auto load = [&](int k0) {
    const int kn = min(kChunk, H - k0);
#pragma unroll
    for (int i = 0; i < kAG; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kChunk / 4), k = (e % (kChunk / 4)) * 4;
      const int rr = r0 + r;
      const int valid = rr < d.rows ? kn - k : 0;
      const long long at =
          static_cast<long long>(valid > 0 ? src_row(d, rr) : rr) * H + k0 + k;
      ha[i] = load4(d.h + at, valid, vec);
      const int tok = valid > 0 ? d.token[rr] : -1;
      ea[i] = tok >= 0 && tok < d.vocab
                  ? load4(d.emb + static_cast<long long>(tok) * H + k0 + k,
                          valid, vec)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kWG; ++i) {
      const int e = tid + i * kThreads;
      const int w = e / (kChunk / 4), k = (e % (kChunk / 4)) * 4;
      // w: unit w / 6, matrix (w / 3) % 2 (W_ih, W_hh), gate w % 3
      const int unit = j0 + w / 6, g = w % 3;
      const float* m = (w / 3) % 2 ? d.w_hh : d.w_ih;
      wa[i] = load4(m + (static_cast<long long>(g) * H + unit) * H + k0 + k,
                    unit < H ? kn - k : 0, vec);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kAG; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kChunk / 4), k = (e % (kChunk / 4)) * 4;
      *reinterpret_cast<float4*>(&Ah[r][k]) = ha[i];
      *reinterpret_cast<float4*>(&Ae[r][k]) = ea[i];
    }
#pragma unroll
    for (int i = 0; i < kWG; ++i) {
      const int e = tid + i * kThreads;
      const int w = e / (kChunk / 4), k = (e % (kChunk / 4)) * 4;
      *reinterpret_cast<float4*>(&Ws[w][k]) = wa[i];
    }
  };
  float gi[3] = {0.f, 0.f, 0.f}, gh[3] = {0.f, 0.f, 0.f};
  load(0);
  for (int k0 = 0; k0 < H; k0 += kChunk) {
    const int kn = min(kChunk, H - k0);
    __syncthreads();  // the last chunk's products have read the stage
    store();
    __syncthreads();
    if (k0 + kChunk < H) load(k0 + kChunk);
    const float* wi = Ws[warp * 6];
    const float* wh = Ws[warp * 6 + 3];
    for (int k = 0; k < kn; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(&Ah[lane][k]);
      const float4 ev = *reinterpret_cast<const float4*>(&Ae[lane][k]);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(wi + g * kStride + k);
        const float4 b = *reinterpret_cast<const float4*>(wh + g * kStride + k);
        gi[g] = fmaf(ev.w, a.w, fmaf(ev.z, a.z, fmaf(ev.y, a.y, fmaf(ev.x, a.x, gi[g]))));
        gh[g] = fmaf(hv.w, b.w, fmaf(hv.z, b.z, fmaf(hv.y, b.y, fmaf(hv.x, b.x, gh[g]))));
      }
    }
  }
  if (!live) return;
  if (!emit) {
    d.h_out[o] = d.h[oi];
    d.out_out[o] = d.out_in[oi];
    return;
  }
  const float ir = gi[0] + d.b_ih[j], iz = gi[1] + d.b_ih[H + j];
  const float in = gi[2] + d.b_ih[2 * H + j];
  const float hr = gh[0] + d.b_hh[j], hz = gh[1] + d.b_hh[H + j];
  const float hn = gh[2] + d.b_hh[2 * H + j];
  const float r = 1.f / (1.f + expf(-(hr + ir)));
  const float z = 1.f / (1.f + expf(-(hz + iz)));
  const float n = tanhf(in + hn * r);
  const float hy = (d.h[oi] - n) * z + n;
  d.h_out[o] = hy;
  d.out_out[o] = hy;
}

template <typename T>
void launch_joint(const Dense& hid, const Dense& out, cudaStream_t s) {
  const dim3 g1((hid.cols + kColTile - 1) / kColTile,
                (hid.rows + kRowTile - 1) / kRowTile);
  const dim3 g2((out.cols + kColTile - 1) / kColTile, g1.y);
  decode_joint_dense_kernel<T, true><<<g1, kThreads, 0, s>>>(hid);
  decode_joint_dense_kernel<T, false><<<g2, kThreads, 0, s>>>(out);
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
};

constexpr int kMaxCand = kMaxK * (kMaxK + 1);  // B (K + 1) candidates, at most
constexpr unsigned kHashMul = 1000003u;

// One block (kRowThreads) a sample: the candidates in shared memory, B
// block-wide argmax rounds (block_best), then the beams' fields, the
// merge, the frame advance and the token rows, each after a block
// barrier; a plain launch (no programmatic edge on either side).
__global__ void __launch_bounds__(kRowThreads)
decode_beam_select_kernel(const Select d) {
  __shared__ float vals[kMaxCand];  // the candidates' scores
  __shared__ float keys[kMaxCand];  // clamped; -inf once picked
  __shared__ float redf[kRowThreads / 32];
  __shared__ int redi[kRowThreads / 32];
  __shared__ int pick[kMaxK];
  __shared__ int parent_of[kMaxK], u_at[kMaxK], u_new[kMaxK], nexp_new[kMaxK];
  __shared__ int tok_of[kMaxK];
  __shared__ unsigned char emits[kMaxK], waits[kMaxK];
  __shared__ long long hash_new[kMaxK];
  const int tid = threadIdx.x, n = blockIdx.x;
  const int B = d.B, K = d.K, K1 = d.K + 1, L = d.L, nc = B * K1;
  const long long nb = static_cast<long long>(n) * B;
  const float half_neg = 0.5f * kNeg;  // a live beam scores above it
  const int t = d.t[n];
  const bool frame_on = t < d.fb[n];
  bool go = true;  // the loop's cond, where it is folded in
  if (d.count) {
    bool live = false;
    for (int m = tid; m < d.N; m += kRowThreads) live |= d.t[m] < d.fb[m];
    go = __syncthreads_or(live);
    if (n == 0 && tid == 0) d.count_out[0] = d.count[0] + go;
  }
  for (int c = tid; c < nc; c += kRowThreads) {
    const int b = c / K1, q = c - b * K1;
    const long long r = nb + b;
    const float s = d.scores[r];
    const bool wait = d.waiting[r] != 0;
    float v;
    if (q == 0) {  // blank (an active beam) or self (settled, off-frame)
      v = frame_on && !wait ? s + d.lp_blank[r] : s;
    } else {  // a label, where the beam may expand
      const bool expandable = frame_on && s > half_neg && !wait &&
                              d.u[r] < L && d.nexp[r] < d.max_symbols;
      v = expandable ? s + d.top_lp[r * K + q - 1] : kNeg;
    }
    vals[c] = v;
    keys[c] = isnan(v) ? v : fmaxf(v, -FLT_MAX);
  }
  __syncthreads();
  for (int j = 0; j < B; ++j) {
    float key = -INFINITY;
    int idx = INT_MAX;
    for (int c = tid; c < nc; c += kRowThreads) take_first_max(key, idx, keys[c], c);
    block_best(key, idx, redf, redi);
    if (tid == 0) {
      pick[j] = idx;
      keys[idx] = -INFINITY;
    }
    __syncthreads();
  }
  if (tid < B) {  // new beam tid: its parent's fields, then its emission
    const int c = pick[tid], parent = c / K1, kind = c - parent * K1;
    const long long pr = nb + parent;
    const bool emit = kind > 0;
    const int tok = d.top_ids[pr * K + max(kind - 1, 0)];
    const int u = d.u[pr], nexp = d.nexp[pr];
    const long long h = d.hcode[pr];
    parent_of[tid] = parent;
    u_at[tid] = u;
    u_new[tid] = emit ? u + 1 : u;
    nexp_new[tid] = emit ? nexp + 1 : nexp;
    tok_of[tid] = tok;
    emits[tid] = emit;
    waits[tid] = frame_on && !emit;
    hash_new[tid] = emit ? static_cast<long long>(
                               static_cast<unsigned>(h) * kHashMul +
                               static_cast<unsigned>(tok + 1))
                         : h;
  }
  __syncthreads();
  // the merge: a beam dies where another of the same hash, length and
  // settledness beats it (higher score; ties: the lower index)
  float score = 0.f;
  bool active = false;
  if (tid < B) {
    const float sj = vals[pick[tid]];
    bool killed = false;
    for (int i = 0; i < B; ++i) {
      const float si = vals[pick[i]];
      const bool same = hash_new[i] == hash_new[tid] && u_new[i] == u_new[tid] &&
                        waits[i] == waits[tid];
      const bool beats = si > sj || (si == sj && i < tid);
      killed |= i != tid && same && beats;
    }
    score = killed ? kNeg : sj;
    active = !waits[tid] && score > half_neg;
  }
  // a sample whose live beams have all settled advances its frame
  const bool advance = frame_on && !__syncthreads_or(active);
  if (tid < B && go) {
    const long long r = nb + tid;
    d.scores_out[r] = score;
    d.u_out[r] = u_new[tid];
    d.nexp_out[r] = advance ? 0 : nexp_new[tid];
    d.waiting_out[r] = waits[tid] && !advance;
    d.hcode_out[r] = hash_new[tid];
    d.emit[r] = emits[tid];
    d.new_tok[r] = tok_of[tid];
    d.src[r] = static_cast<int>(nb + parent_of[tid]);
  } else if (tid < B) {  // the loop's cond is false: the state through
    const long long r = nb + tid;
    d.scores_out[r] = d.scores[r];
    d.u_out[r] = d.u[r];
    d.nexp_out[r] = d.nexp[r];
    d.waiting_out[r] = d.waiting[r];
    d.hcode_out[r] = d.hcode[r];
    d.emit[r] = 0;
    d.new_tok[r] = tok_of[tid];
    d.src[r] = static_cast<int>(r);
  }
  // (where go is false no sample's frame is on: t keeps)
  if (tid == 0) d.t_out[n] = advance ? t + 1 : t;
  // the token rows: the parent's, the new token at the parent's u (where
  // go is false, each beam's own)
  const long long base = nb * L;
  for (int e = tid; e < B * L; e += kRowThreads) {
    const int b = e / L, l = e - b * L;
    d.tokens_out[base + e] =
        !go ? d.tokens[base + e]
        : emits[b] && l == u_at[b]
            ? tok_of[b]
            : d.tokens[(nb + parent_of[b]) * L + l];
  }
}

template <typename P>
P ptr(long long v) { return reinterpret_cast<P>(v); }

}  // namespace

// decode_joint's argument block (int64 each): enc, t, p0, pred_out, w_pre,
// b_pre, w_out, b_out, hidden scratch, logits scratch, logp (or 0), best
// (or 0), lp_blank, top_lp, top_ids, N, C, F, Fg, rows, H, V, concat, bf16,
// blank, K, stream.  Three launches.
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
  hid.vec_a = F % 4 == 0 && Fg % 4 == 0;
  Dense out = hid;
  out.a = ptr<const void*>(a[8]);
  out.w = ptr<const void*>(a[6]);
  out.b = ptr<const void*>(a[7]);
  out.out = ptr<void*>(a[9]);
  out.K = H;
  out.cols = V;
  const int elem = a[23] ? 8 : 4;  // T elements in 16 bytes
  hid.vec_w = H % elem == 0;
  out.vec_a = H % elem == 0;
  out.vec_w = V % elem == 0;
  if (a[23]) {
    launch_joint<bf16>(hid, out, s);
  } else {
    launch_joint<float>(hid, out, s);
  }
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
  decode_joint_rows_kernel<<<rows, kRowThreads, 0, s>>>(r);
  return static_cast<int>(cudaGetLastError());
}

// decode_gru's argument block (int64 each): token, emb, h, out_in, w_ih,
// w_hh, b_ih, b_hh, emit (or 0), h_out, out_out, then greedy's t, u,
// emitted_here, frame_bound, tokens, t_out, u_out, eh_out, tokens_out (all
// 0 without), vocab, rows, H, L, blank, max_symbols, stream, src (or 0).
// One launch.
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
  const dim3 grid((d.H + kUnits - 1) / kUnits, (d.rows + kRowTile - 1) / kRowTile);
  decode_gru_kernel<<<grid, kThreads, 0, s>>>(d);
  return static_cast<int>(cudaGetLastError());
}

// decode_beam_select's argument block (int64 each): t, scores, tokens, u,
// nexp, waiting, hcode, lp_blank, top_lp, top_ids, frame_bound, then t_out,
// scores_out, tokens_out, u_out, nexp_out, waiting_out, hcode_out, emit,
// new_tok, src, then N, B, K, L, max_symbols, stream, then the loop's
// fold: count, count_out (0 and 0 without).  B and K at most kMaxK.  One
// launch.
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
  const int N = static_cast<int>(a[21]);
  d.N = N;
  d.B = static_cast<int>(a[22]);
  d.K = static_cast<int>(a[23]);
  d.L = static_cast<int>(a[24]);
  d.max_symbols = static_cast<int>(a[25]);
  const cudaStream_t s = ptr<cudaStream_t>(a[26]);
  d.count = ptr<const int*>(a[27]);
  d.count_out = ptr<int*>(a[28]);
  if (d.B < 1 || d.B > kMaxK || d.K < 1 || d.K > kMaxK ||
      (d.count != nullptr) != (d.count_out != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  decode_beam_select_kernel<<<N, kRowThreads, 0, s>>>(d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
