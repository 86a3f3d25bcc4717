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
// Each column is the first-order log-space recurrence
// a[j] = LSE(a[j-1] + m[j], b[j]), solved by a Hillis-Steele doubling scan
// over (m, b) pairs in shared memory (the combine of `_scan_fwd`/`_scan_bwd`).
//
// What bounds it on this card: not bytes (the lattice moves ~1.6 MB at
// N=32, T=150, U=21) and not arithmetic, but latency: each sample is a chain
// of U columns x ceil(log2 T) dependent scan steps, each a __syncthreads.
// Design: one block per (sample, direction) -- grid (N, 2) for the fused
// sweep, (N, 1) for beta only -- so alpha and beta of every sample run in
// parallel on separate SMs; the TPU's sequential grid over U becomes a loop
// inside the block.  The column carry is read back from the block's own
// output column (made visible by __syncthreads), so T has no limit: the
// column is scanned in chunks of kThreads positions, each chunk seeded with
// the previous chunk's last value.  The beta sweep runs the same forward
// scan over a reversed index (j = T-1-t).  Wavefront schedules (one warp per
// T chunk, as the CUDA reference does) are later work.
//
// Launches on the caller's stream; allocates nothing; returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1.0e30f;

// A log-prob as the sweeps read it: values below the sentinel, -inf among
// them, become the sentinel, so that lae never meets two -inf (|a - b| would
// be NaN where the JAX scan's safe logaddexp gives -inf); a NaN stays NaN.
// Finite log-probs at or above -1e30 pass unchanged.
__device__ __forceinline__ float ld(const float* p) {
  const float x = *p;
  return x < kNeg ? kNeg : x;
}

// logaddexp on finite sentinel values; fp32, precise expf/log1pf.
__device__ __forceinline__ float lae(float a, float b) {
  const float mx = fmaxf(a, b);
  return mx + log1pf(expf(-fabsf(a - b)));
}

// In-place inclusive scan of one chunk: on return sb[j] holds the chunk-local
// solution and sm[j] the running sum of m.  Positions with no left neighbour
// at distance k combine with the identity (0, kNeg).
__device__ __forceinline__ void chunk_scan(float* sm, float* sb, int j) {
  float m = sm[j];
  float b = sb[j];
  for (int k = 1; k < kThreads; k <<= 1) {
    const float ms = j >= k ? sm[j - k] : 0.0f;
    const float bs = j >= k ? sb[j - k] : kNeg;
    __syncthreads();
    b = lae(bs + m, b);
    m = ms + m;
    sm[j] = m;
    sb[j] = b;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
lattice_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
               const int* __restrict__ xn_arr, const int* __restrict__ yn_arr,
               float* __restrict__ alphas, float* __restrict__ betas,
               int T, int U, int beta_only) {
  __shared__ float sm[kThreads];
  __shared__ float sb[kThreads];
  __shared__ float carry;

  const int n = blockIdx.x;
  const bool alpha_dir = !beta_only && blockIdx.y == 0;
  const int j = threadIdx.x;
  const int xn = xn_arr[n];
  const int yn = yn_arr[n];
  const size_t base = (size_t)n * T * U;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* out = (alpha_dir ? alphas : betas) + base;

  for (int step = 0; step < U; ++step) {
    const int u = alpha_dir ? step : U - 1 - step;
    for (int c0 = 0; c0 < T; c0 += kThreads) {
      const int pos = c0 + j;  // position along the scan
      const bool in = pos < T;
      const int t = alpha_dir ? pos : T - 1 - pos;
      float m = 0.0f;
      float b = kNeg;
      if (in) {
        const size_t cell = (size_t)t * U + u;
        if (alpha_dir) {
          m = t == 0 ? 0.0f : ld(bl + cell - U);
          if (u == 0) {
            b = t == 0 ? 0.0f : kNeg;
          } else if (u - 1 < yn && t < xn) {
            b = out[cell - 1] + ld(em + cell - 1);
          }
        } else {
          m = ld(bl + cell);
          if (t == xn - 1 && u == yn) {
            b = m;
          } else if (u < yn && t < xn && u + 1 < U) {
            b = ld(em + cell) + out[cell + 1];
          }
        }
      }
      sm[j] = m;
      sb[j] = b;
      __syncthreads();
      chunk_scan(sm, sb, j);
      float a = sb[j];
      if (c0 > 0) a = lae(carry + sm[j], a);
      __syncthreads();  // every thread has read `carry` before it changes
      if (in) out[(size_t)t * U + u] = a;
      if (j == kThreads - 1) carry = a;
      __syncthreads();  // column writes and `carry` visible to the block
    }
  }
}

}  // namespace

extern "C" int rnnt_lattice(const float* blank, const float* emit,
                            const int* xn, const int* yn, float* alphas,
                            float* betas, int N, int T, int U,
                            int compute_alpha, void* stream) {
  const dim3 grid(N, compute_alpha ? 2 : 1);
  lattice_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      blank, emit, xn, yn, alphas, betas, T, U, compute_alpha ? 0 : 1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rnnt_lattice_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
