// Data movement of the compact (packed) RNN-T layout for Hopper (sm_90a).
//
// In the packed layout each sample n's (xn[n], yn[n] + 1) lattice is
// flattened row-major and the samples are concatenated: lattice cell
// (n, t, u) is packed row
//
//   row = mem_pref[n] + t * (yn[n] + 1) + u,   mem_pref = exclusive cumsum of
//                                              xn * (yn + 1)
//
// of the (rows, V) log-probs.  Rows past sum(xn * (yn + 1)) are padding (a
// bucketed buffer): never read, and their gradient is exactly zero.
//
// packed_lattice replaces the Pallas TPU kernel `_gather_kernel`
// (warp_rnnt_tpu/ops/packed_kernels.py:130) and the stack of
// `packed_lattice` (:426): packed (rows, V) log-probs, packed labels ys
// (sum(yn),) and the lengths -> the interleaved (N, T, U, 2) fp32 lattice
// that the lattice sweep reads (channel 0 the blank, 1 the next label), 0 at
// cells with t >= xn or u > yn.  Beside it, the meta the backward reuses:
// pref (2, N) int64 (row 0 the first packed row of each sample, row 1 its
// first label) and loc (N, U) int32 (row u's label, the blank from u == yn).
//   What bounds it on this card: sectors, not bytes.  Each valid cell reads
//   two entries of one V-wide row; at V * sizeof(E) >= 32 bytes they lie in
//   two 32-byte sectors, so it moves ~64 bytes a valid cell against the 2 *
//   sizeof(E) its byte bound counts.  Then the lattice's 8 bytes a cell.
//   Design: two launches from one C entry.  One block scans the lengths into
//   pref (exclusive prefix sums, 64-bit).  Then one warp a padded (n, t)
//   frame, whose yn + 1 packed rows are contiguous: lanes go along u, each
//   lane takes kUnroll cells and issues the reads of all of them before it
//   stores, and the (u, 2) pairs leave as contiguous 8-byte stores.  A
//   frame's only division is its own (n, t); frames past xn only store
//   zeros.  The frames t == 0 also write loc.  The TPU kernel's DMA windows
//   and one-hot MXU permutation exist because the TPU has no cheap
//   per-element offsets; a GPU lane has them.
//   Where a row lies past the buffer or a label outside [0, V) the cell is
//   NaN (both channels): never silent.

// packed_scatter replaces the Pallas TPU kernel `_scatter_kernel`
// (warp_rnnt_tpu/ops/packed_kernels.py:193): the (N, T, U, 2) fp32
// cotangent of the lattice, as the backward hands it over (interleaved,
// read in place) -> the dense (rows, V) gradient in the output dtype,
//
//   d[row, v] = ct[n, t, u, 0] * (v == blank) + ct[n, t, u, 1] * (v == loc[n, u])
//
// (both terms add where loc == blank, the row u == yn), and zero rows past
// sum(xn * (yn + 1)).  It reads the forward's pref and loc.  Every element
// is written exactly once, so the output needs no zero fill.
//   What bounds it on this card: bytes, the rows * V * sizeof(out) written.
//   Design: one block per (n, t) frame, whose yn + 1 rows are one contiguous
//   span of (yn + 1) * V elements; 16-byte stores on the aligned body of the
//   span, scalar stores on its head and tail (V * sizeof(out) need not be a
//   multiple of 16).  Each 16-byte group takes one integer division to find
//   its row.  Frames past xn exit at once.  A second range of blocks zeroes
//   the pad rows; the first valid-row count they need is read on the device
//   from the last sample's prefix, so the wrapper needs no host sync.  The
//   arithmetic is the multiply form above, as in the plain torch version, so
//   the two agree bit for bit.
//
// Both entries compute offsets in 64-bit arithmetic and never touch a row at
// or past `rows` (the buffer's row count).  They take one packed argument
// block (the host converts one ctypes argument, not fifteen), launch on the
// caller's stream, allocate nothing and return cudaGetLastError() so the
// caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // frames a block of the lattice gather
constexpr int kUnroll = 8;             // cells a lane reads before it stores
constexpr int kScanThreads = 1024;     // the prefix scan's one block
constexpr int kPadBlocks = 1024;       // most blocks that zero pad rows

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(double x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The bits of a float stored as the output type.
template <typename E>
struct Out;
template <>
struct Out<float> {
  using B = unsigned int;
  static __device__ __forceinline__ B bits(float x) { return __float_as_uint(x); }
};
template <>
struct Out<double> {
  using B = unsigned long long;
  static __device__ __forceinline__ B bits(float x) {
    return static_cast<B>(__double_as_longlong(static_cast<double>(x)));
  }
};
template <>
struct Out<__half> {
  using B = unsigned short;
  static __device__ __forceinline__ B bits(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};
template <>
struct Out<__nv_bfloat16> {
  using B = unsigned short;
  static __device__ __forceinline__ B bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float term(float2 c, int v, int blank, int loc) {
  return c.x * static_cast<float>(v == blank) + c.y * static_cast<float>(v == loc);
}

// Inclusive sums of (a, b) over the warp's lanes.
__device__ __forceinline__ void warp_scan(long long& a, long long& b, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long x = __shfl_up_sync(0xffffffffu, a, d);
    const long long y = __shfl_up_sync(0xffffffffu, b, d);
    if (lane >= d) {
      a += x;
      b += y;
    }
  }
}

// pref[n] = sum over m < n of xn[m] * (yn[m] + 1), pref[N + n] = sum over
// m < n of yn[m]: one block, kScanThreads samples a step, each thread
// carrying the steps' totals.
__global__ void __launch_bounds__(kScanThreads)
prefix_kernel(const int* __restrict__ xn, const int* __restrict__ yn,
              long long* __restrict__ pref, int N) {
  constexpr int kW = kScanThreads / 32;
  __shared__ long long part[2][kW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long carry_rows = 0;
  long long carry_labels = 0;
  for (int base = 0; base < N; base += kScanThreads) {
    const int n = base + threadIdx.x;
    long long rows = 0;
    long long labels = 0;
    if (n < N) {
      labels = yn[n];
      rows = static_cast<long long>(xn[n]) * (labels + 1);
    }
    long long ir = rows;
    long long il = labels;
    warp_scan(ir, il, lane);
    if (lane == 31) {
      part[0][warp] = ir;
      part[1][warp] = il;
    }
    __syncthreads();
    if (warp == 0) {
      long long pr = part[0][lane];
      long long pl = part[1][lane];
      warp_scan(pr, pl, lane);
      part[0][lane] = pr;
      part[1][lane] = pl;
    }
    __syncthreads();
    if (n < N) {
      pref[n] = carry_rows + (warp ? part[0][warp - 1] : 0) + ir - rows;
      pref[N + n] = carry_labels + (warp ? part[1][warp - 1] : 0) + il - labels;
    }
    carry_rows += part[0][kW - 1];
    carry_labels += part[1][kW - 1];
    __syncthreads();  // before the next step writes part
  }
}

// One warp a padded frame f = n * frames + t of the (N, frames, U, 2)
// lattice; lanes along u.
template <typename E>
__global__ void __launch_bounds__(kThreads)
lattice_gather_kernel(const E* __restrict__ xs, const int* __restrict__ ys,
                      const int* __restrict__ xn, const int* __restrict__ yn,
                      const long long* __restrict__ pref,
                      float2* __restrict__ out, int* __restrict__ loc, int N,
                      int frames, int U, int V, int blank, long long rows,
                      long long n_labels) {
  const int f = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (f >= N * frames) return;
  const int lane = threadIdx.x & 31;
  const int n = f / frames;
  const int t = f - n * frames;
  const int ynn = yn[n];
  const bool live = t < xn[n];
  const long long row0 = pref[n] + static_cast<long long>(t) * (ynn + 1);
  const long long lab0 = pref[N + n];
  float2* dst = out + static_cast<long long>(f) * U;
  for (int u0 = 0; u0 < U; u0 += 32 * kUnroll) {
    E b[kUnroll], e[kUnroll];
    bool read[kUnroll], bad[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = u0 + 32 * k + lane;
      int l = blank;
      if (u < ynn && n_labels > 0) {
        const long long p = lab0 + u;
        l = ys[p < n_labels ? p : n_labels - 1];
      }
      if (t == 0 && u < U) loc[static_cast<long long>(n) * U + u] = l;
      const long long row = row0 + u;
      read[k] = live && u < U && u <= ynn;
      bad[k] = read[k] && (row >= rows || l < 0 || l >= V);
      read[k] = read[k] && !bad[k];
      if (read[k]) {
        const E* r = xs + row * V;
        b[k] = r[blank];
        e[k] = r[l];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = u0 + 32 * k + lane;
      if (u >= U) break;
      float2 v = make_float2(0.0f, 0.0f);
      if (read[k]) {
        v = make_float2(to_float(b[k]), to_float(e[k]));
      } else if (bad[k]) {
        v.x = v.y = __int_as_float(0x7fc00000);
      }
      dst[u] = v;
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
packed_scatter_kernel(const float2* __restrict__ ct,
                      const int* __restrict__ loc, const int* __restrict__ xn,
                      const int* __restrict__ yn,
                      const long long* __restrict__ mem_pref,
                      typename Out<E>::B* __restrict__ out, int N, int frames,
                      int U, int V, int blank, long long rows,
                      int frame_blocks) {
  using B = typename Out<E>::B;
  constexpr int kVec = 16 / sizeof(B);

  if (static_cast<int>(blockIdx.x) >= frame_blocks) {
    // pad rows [valid, rows): zero, grid-strided over the pad blocks
    const long long valid =
        mem_pref[N - 1] + static_cast<long long>(xn[N - 1]) * (yn[N - 1] + 1);
    const long long begin = (valid < 0 ? 0 : valid) * V;
    const long long end = rows * V;
    const long long step =
        static_cast<long long>(gridDim.x - frame_blocks) * kThreads;
    for (long long j = begin + (blockIdx.x - frame_blocks) * kThreads +
                       threadIdx.x;
         j < end; j += step) {
      out[j] = B(0);
    }
    return;
  }

  const int n = blockIdx.x / frames;
  const int t = blockIdx.x - n * frames;
  if (t >= xn[n]) return;
  const int stride = yn[n] + 1;
  const long long row0 = mem_pref[n] + static_cast<long long>(t) * stride;
  const long long nrows = min(static_cast<long long>(stride), rows - row0);
  if (nrows <= 0) return;
  const long long start = row0 * V;
  const int len = static_cast<int>(nrows * V);
  const float2* c = ct + (static_cast<long long>(n) * frames + t) * U;
  const int* lc = loc + static_cast<long long>(n) * U;
  B* dst = out + start;

  const int head = min(len, static_cast<int>((kVec - start % kVec) % kVec));
  const int nvec = (len - head) / kVec;
  const int tail = head + nvec * kVec;
  for (int j = threadIdx.x; j < len - nvec * kVec; j += kThreads) {
    const int jj = j < head ? j : tail + (j - head);  // head, then tail
    const int u = jj / V;
    const int v = jj - u * V;
    dst[jj] = Out<E>::bits(term(c[u], v, blank, lc[u]));
  }
  for (int q = threadIdx.x; q < nvec; q += kThreads) {
    const int j0 = head + q * kVec;
    int u = j0 / V;
    int v = j0 - u * V;
    alignas(16) B pack[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      pack[k] = Out<E>::bits(term(c[u], v, blank, lc[u]));
      if (++v == V) {
        v = 0;
        ++u;
      }
    }
    *reinterpret_cast<uint4*>(dst + j0) = *reinterpret_cast<const uint4*>(pack);
  }
}

struct LatticeArgs {
  const void* xs;
  const int *ys, *xn, *yn;
  long long* pref;
  int* loc;
  float2* out;
  int N, frames, U, V, blank;
  long long rows, n_labels;
};

template <typename E>
int launch_lattice(const LatticeArgs& p, cudaStream_t s) {
  prefix_kernel<<<1, kScanThreads, 0, s>>>(p.xn, p.yn, p.pref, p.N);
  const int frames = p.N * p.frames;
  lattice_gather_kernel<E><<<(frames + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const E*>(p.xs), p.ys, p.xn, p.yn, p.pref, p.out, p.loc, p.N,
      p.frames, p.U, p.V, p.blank, p.rows, p.n_labels);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_scatter(const float2* ct, const int* loc, const int* xn,
                   const int* yn, const long long* mem_pref, void* out, int N,
                   int frames, int U, int V, int blank, long long rows,
                   cudaStream_t s) {
  const int frame_blocks = N * frames;
  const long long per_block = static_cast<long long>(kThreads) * 8;
  const long long want = (rows * V + per_block - 1) / per_block;
  const int pad_blocks = static_cast<int>(want < kPadBlocks ? want : kPadBlocks);
  const dim3 grid(static_cast<unsigned int>(frame_blocks + pad_blocks));
  packed_scatter_kernel<E><<<grid, kThreads, 0, s>>>(
      ct, loc, xn, yn, mem_pref, static_cast<typename Out<E>::B*>(out), N,
      frames, U, V, blank, rows, frame_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The lattice gather, two launches (prefix scan, then the gather) from one
// packed argument block:
//   a[0] xs (rows, V), a[1] dtype (0 float32, 1 float64, 2 float16,
//   3 bfloat16), a[2] ys, a[3] len(ys), a[4] xn, a[5] yn, a[6] pref (2, N)
//   int64, a[7] loc (N, U) int32, a[8] out (N, frames, U, 2) fp32, a[9] N,
//   a[10] frames, a[11] U, a[12] V, a[13] blank, a[14] rows, a[15] stream.
extern "C" int rnnt_packed_lattice(const long long* a) {
  LatticeArgs p;
  p.xs = reinterpret_cast<const void*>(a[0]);
  p.ys = reinterpret_cast<const int*>(a[2]);
  p.n_labels = a[3];
  p.xn = reinterpret_cast<const int*>(a[4]);
  p.yn = reinterpret_cast<const int*>(a[5]);
  p.pref = reinterpret_cast<long long*>(a[6]);
  p.loc = reinterpret_cast<int*>(a[7]);
  p.out = reinterpret_cast<float2*>(a[8]);
  p.N = static_cast<int>(a[9]);
  p.frames = static_cast<int>(a[10]);
  p.U = static_cast<int>(a[11]);
  p.V = static_cast<int>(a[12]);
  p.blank = static_cast<int>(a[13]);
  p.rows = a[14];
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a[15]);
  switch (a[1]) {
    case 0:
      return launch_lattice<float>(p, s);
    case 1:
      return launch_lattice<double>(p, s);
    case 2:
      return launch_lattice<__half>(p, s);
    case 3:
      return launch_lattice<__nv_bfloat16>(p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The scatter from one packed argument block:
//   a[0] ct (N, frames, U, 2) fp32, a[1] loc (N, U) int32, a[2] xn, a[3] yn,
//   a[4] pref (its first N entries), a[5] out (rows, V), a[6] out dtype
//   (codes as above), a[7] N, a[8] frames, a[9] U, a[10] V, a[11] blank,
//   a[12] rows, a[13] stream.
extern "C" int rnnt_packed_scatter(const long long* a) {
  const float2* ct = reinterpret_cast<const float2*>(a[0]);
  const int* loc = reinterpret_cast<const int*>(a[1]);
  const int* xn = reinterpret_cast<const int*>(a[2]);
  const int* yn = reinterpret_cast<const int*>(a[3]);
  const long long* pref = reinterpret_cast<const long long*>(a[4]);
  void* out = reinterpret_cast<void*>(a[5]);
  const int N = static_cast<int>(a[7]);
  const int frames = static_cast<int>(a[8]);
  const int U = static_cast<int>(a[9]);
  const int V = static_cast<int>(a[10]);
  const int blank = static_cast<int>(a[11]);
  const long long rows = a[12];
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a[13]);
  switch (a[6]) {
    case 0:
      return launch_scatter<float>(ct, loc, xn, yn, pref, out, N, frames, U, V,
                                   blank, rows, s);
    case 1:
      return launch_scatter<double>(ct, loc, xn, yn, pref, out, N, frames, U,
                                    V, blank, rows, s);
    case 2:
      return launch_scatter<__half>(ct, loc, xn, yn, pref, out, N, frames, U,
                                    V, blank, rows, s);
    case 3:
      return launch_scatter<__nv_bfloat16>(ct, loc, xn, yn, pref, out, N,
                                           frames, U, V, blank, rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rnnt_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
