// IIR filter: the direct-form-II-transposed recurrence over the rows of
// x (T, M), one thread per column, float32 or float64.
//
// It replaces no Pallas kernel. The JAX package filters with a lax.scan of
// the same recurrence (eegsynth/ops/filtering.py:43-77, the scan at :76),
// which XLA compiles into one loop; as PyTorch operations one time step is
// about seven launches. Preprocessing runs four passes a file (notch and
// band-pass, forward and backward), each over the trial plus its odd
// extension.
//
// Per step, with normalised taps b, a (n <= 9) and state z (n - 1):
//   y    = b0 * x + z0
//   z_i <- (b_{i+1} * x + z_{i+1}) - a_{i+1} * y      (z_{n-1} = 0)
// Every product and sum is rounded on its own (the _rn intrinsics, which
// nvcc never contracts into a fused multiply-add), as the plain PyTorch
// version (eegsynth_torch/ops/filtering.py lfilter_reference) and
// scipy.signal.lfilter round them: the kernel equals both bit for bit.
//
// Bound: not bytes (a (7734, 14) float64 pass reads and writes 1.7 MB, half a
// microsecond at 3.35 TB/s) but the chain of dependent steps: z0 -> y (add)
// -> a1 * y (mul) -> z0' (sub), three dependent operations a step, T steps
// in a row. The design keeps everything else off that chain: one thread per
// column holds its state and taps in registers (no shared memory, no
// synchronisation), the products b_i * x do not depend on the state, and the
// loads of x (coalesced across the columns of a row) are issued a chunk of
// kChunk rows ahead of their use.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxTaps = 9;
constexpr int kThreads = 128;
constexpr int kChunk = 16;

template <typename T>
struct Taps {
  T b[kMaxTaps];
  T a[kMaxTaps];
};

__device__ __forceinline__ double mul_rn(double p, double q) { return __dmul_rn(p, q); }
__device__ __forceinline__ float mul_rn(float p, float q) { return __fmul_rn(p, q); }
__device__ __forceinline__ double add_rn(double p, double q) { return __dadd_rn(p, q); }
__device__ __forceinline__ float add_rn(float p, float q) { return __fadd_rn(p, q); }
__device__ __forceinline__ double sub_rn(double p, double q) { return __dsub_rn(p, q); }
__device__ __forceinline__ float sub_rn(float p, float q) { return __fsub_rn(p, q); }

template <typename T>
__device__ __forceinline__ void load_chunk(T (&buf)[kChunk], const T* __restrict__ xc,
                                           int t0, int T_len, size_t stride) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u)
    buf[u] = (t0 + u < T_len) ? xc[static_cast<size_t>(t0 + u) * stride] : T(0);
}

// N taps (order N - 1), known at compile time so that the state, the taps
// and the chunk of x all live in registers.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
iir_filter_kernel(const T* __restrict__ x, const T* __restrict__ zi, const Taps<T> taps,
                  T* __restrict__ y, int T_len, int M) {
  constexpr int O = N - 1;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= M) return;
  const size_t stride = static_cast<size_t>(M);
  T b[N], a[N], z[O + 1];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    b[i] = taps.b[i];
    a[i] = taps.a[i];
  }
#pragma unroll
  for (int i = 0; i < O; ++i) z[i] = zi[static_cast<size_t>(i) * stride + col];
  z[O] = T(0);

  const T* xc = x + col;
  T* yc = y + col;
  T cur[kChunk], nxt[kChunk];
  load_chunk(cur, xc, 0, T_len, stride);
  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    if (t0 + kChunk < T_len) load_chunk(nxt, xc, t0 + kChunk, T_len, stride);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (t0 + u < T_len) {
        const T xt = cur[u];
        const T yt = add_rn(mul_rn(b[0], xt), z[0]);
#pragma unroll
        for (int i = 0; i < O; ++i)
          z[i] = sub_rn(add_rn(mul_rn(b[i + 1], xt), z[i + 1]), mul_rn(a[i + 1], yt));
        yc[static_cast<size_t>(t0 + u) * stride] = yt;
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) cur[u] = nxt[u];
  }
}

template <typename T>
int launch(const T* x, const T* zi, const T* b_host, const T* a_host, T* y, int T_len,
           int M, int n, cudaStream_t stream) {
  if (T_len < 0 || M < 0 || n < 1 || n > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T_len == 0 || M == 0) return 0;
  Taps<T> taps{};
  for (int i = 0; i < n; ++i) {
    taps.b[i] = b_host[i];
    taps.a[i] = a_host[i];
  }
  const dim3 grid((M + kThreads - 1) / kThreads), block(kThreads);
  switch (n) {
#define IIR_CASE(NT)                                                                  \
  case NT:                                                                            \
    iir_filter_kernel<T, NT><<<grid, block, 0, stream>>>(x, zi, taps, y, T_len, M); \
    break;
    IIR_CASE(1) IIR_CASE(2) IIR_CASE(3) IIR_CASE(4) IIR_CASE(5)
    IIR_CASE(6) IIR_CASE(7) IIR_CASE(8) IIR_CASE(9)
#undef IIR_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (T, M) and zi (n - 1, M) on the card, row-major; b and a (n) on the
// host, normalised by a[0]; y (T, M) on the card. Returns a CUDA error code.
extern "C" int iir_filter_f64(const double* x, const double* zi, const double* b,
                              const double* a, double* y, int T, int M, int n,
                              cudaStream_t stream) {
  return launch(x, zi, b, a, y, T, M, n, stream);
}

extern "C" int iir_filter_f32(const float* x, const float* zi, const float* b,
                              const float* a, float* y, int T, int M, int n,
                              cudaStream_t stream) {
  return launch(x, zi, b, a, y, T, M, n, stream);
}
