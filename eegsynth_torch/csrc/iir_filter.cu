// IIR filter: the direct-form-II-transposed recurrence over the rows of
// x (T, M), float32 or float64, each column's state spread over a group of
// lanes (the "lanes" route) or held by one thread (the "column" route).
//
// It replaces no Pallas kernel. The JAX package filters with a lax.scan of
// the same recurrence (eegsynth/ops/filtering.py:43-77, the scan at :76),
// which XLA compiles into one loop; as PyTorch operations one time step is
// about seven launches. Preprocessing runs four passes a file (notch and
// band-pass, forward and backward), each over the trial plus its odd
// extension, 14 columns at a time.
//
// Per step, with normalised taps b, a (n <= 9) and state z (O = n - 1):
//   y    = b0 * x + z0
//   z_i <- (b_{i+1} * x + z_{i+1}) - a_{i+1} * y      (z_O = 0)
// Every product and sum is rounded on its own (the _rn intrinsics, which
// nvcc never contracts into a fused multiply-add), in this order, as the
// plain PyTorch version (eegsynth_torch/ops/filtering.py lfilter_reference)
// and scipy.signal.lfilter round them: the kernel equals both bit for bit.
// A scan over time (chunks carried by powers of the companion matrix) would
// not: the band-pass's poles (|p| up to 0.982) make those powers
// ill-conditioned, so the recurrence stays serial in time.
//
// Bound: not bytes (a (7734, 14) float64 pass reads and writes 1.7 MB, half a
// microsecond at 3.35 TB/s) but the chain of dependent steps: z0 -> y (add)
// -> a1 * y (mul) -> z0' (sub), three dependent operations a step, T steps
// in a row (iir_filter_chain_* times that chain alone). With one thread a
// column the step is also ~34 operations issued by one warp for order 8
// (4 a state element), twice the chain's length at 2 cycles a float64 warp
// instruction. So on the lanes route a group of G lanes (a power of two)
// shares a column's step:
//   - lane 0 holds z0 .. z_{L-1} (L = kLocal) and forms y and those
//     elements itself, with its own y: its chain is the three operations
//     and no shuffle;
//   - lane g >= 1 holds z_{L-1+g} and forms it from y, broadcast from lane 0
//     by __shfl_sync, and z_{L+g}, taken from lane g + 1 by __shfl_down_sync
//     before y is ready (the value of the step before: one step of slack);
//   - lane 0 takes z_L from lane 1 the same way. The loop y_t -> lane L's
//     z_L -> z_{L-1} .. z0 -> y spans L + 1 steps with two shuffles on it;
//     holding L = 2 elements spreads them over three.
// Each link of the shift (z_{i+1} of the step before into z_i) past lane 0
// still crosses a lane, a shuffle a step, which holds the lanes' step at
// about three times the chain on the H100 (PERF.md).
// 32 / G columns share a warp, 128 threads a block (one warp on each of an
// SM's four schedulers). Float32 takes the column route (G = 1, every
// element local): its four-cycle operations leave the shuffles' latency on
// the lanes' step, so the lanes route is built for float64 alone. The plan
// (ops/filtering.py iir_plan) picks.
// On both routes x is loaded a chunk of kChunk rows ahead into registers
// (every lane of a group reads its column's row), the step is unrolled over
// the chunk with no bounds test (the last, partial chunk apart), and lane 0
// of a group stores the chunk's y after it. (Loads and stores spread one row
// a step over the chunk ran slower on the H100: PERF.md.)

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxTaps = 9;
constexpr int kThreads = 128;
constexpr int kChunk = 16;
constexpr int kLocal = 2;
constexpr unsigned kFull = 0xffffffffu;
// The dtypes the lanes route is built for
template <typename T>
constexpr bool kLanesRoute = sizeof(T) == 8;

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

// Lanes a column on the lanes route for n taps: the fewest (a power of two)
// whose lanes 1.. hold the state elements lane 0 does not.
constexpr int lanes_for(int n) {
  const int order = n - 1;
  const int need = order - (kLocal < order ? kLocal : order) + 1;
  int g = 1;
  while (g < need) g *= 2;
  return g;
}

// One lane's part of a column's step: lane 0's elements zl (LC of them) and
// y; lane g >= 1's element zo (z_{LC-1+g}, or nothing past the order).
template <typename T, int N, int G, int L>
struct Lane {
  static constexpr int O = N - 1;
  static constexpr int LC = L < O ? L : O;
  T b[LC + 1], a[LC + 1], zl[LC + 1];  // zl[LC] pads the array at LC 0
  T bo, ao, zo;
  bool tail;  // this lane's neighbour element is z_O = 0
  int base;   // the group's lane 0 within the warp

  __device__ __forceinline__ T step(T xt) {
    T zn = T(0);
    if constexpr (G > 1) {
      const T s = __shfl_down_sync(kFull, zo, 1);
      zn = tail ? T(0) : s;
    }
    T head;
    if constexpr (LC > 0) {
      head = zl[0];
    } else {
      head = zn;
    }
    const T yt = add_rn(mul_rn(b[0], xt), head);
#pragma unroll
    for (int i = 0; i < LC; ++i)
      zl[i] = sub_rn(add_rn(mul_rn(b[i + 1], xt), i + 1 < LC ? zl[i + 1] : zn),
                     mul_rn(a[i + 1], yt));
    if constexpr (G > 1) {
      const T yb = __shfl_sync(kFull, yt, base);
      zo = sub_rn(add_rn(mul_rn(bo, xt), zn), mul_rn(ao, yb));
    }
    return yt;
  }
};

// A chunk of x's rows from xc on: all kChunk of them, or the first ``rows``.
template <bool kAll, typename T>
__device__ __forceinline__ void load_rows(T (&buf)[kChunk], const T* __restrict__ xc,
                                          int rows, size_t stride) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u)
    buf[u] = (kAll || u < rows) ? xc[static_cast<size_t>(u) * stride] : T(0);
}

// N taps (order N - 1), G lanes a column, lane 0 holding L state elements
// (the column route: G 1, L N - 1), all known at compile time so that the
// state, the taps and the chunks of x and y live in registers.
template <typename T, int N, int G, int L>
__global__ void __launch_bounds__(kThreads)
iir_filter_kernel(const T* __restrict__ x, const T* __restrict__ zi, const Taps<T> taps,
                  T* __restrict__ y, int T_len, int M) {
  using LaneT = Lane<T, N, G, L>;
  constexpr int O = LaneT::O;
  constexpr int LC = LaneT::LC;
  static_assert(32 % G == 0 && LC + G - 1 >= O, "a group holds every state element");
  const int thread = blockIdx.x * kThreads + threadIdx.x;
  const int g = threadIdx.x % G;
  const int col = thread / G;
  // a whole warp past the last column leaves; within a warp every lane
  // takes part in the shuffles, past the last column on a copy of it
  if ((thread - static_cast<int>(threadIdx.x % 32)) / G >= M) return;
  const bool live = col < M;
  const int c = live ? col : M - 1;
  const size_t stride = static_cast<size_t>(M);

  LaneT lane;
#pragma unroll
  for (int i = 0; i <= LC; ++i) {
    lane.b[i] = taps.b[i];
    lane.a[i] = taps.a[i];
    lane.zl[i] = i < LC ? zi[static_cast<size_t>(i) * stride + c] : T(0);
  }
  const int e = LC - 1 + g;  // lane g's element
  lane.bo = lane.ao = lane.zo = T(0);
  if constexpr (G > 1) {
#pragma unroll
    for (int i = 1; i < N; ++i) {
      if (i == e + 1) {
        lane.bo = taps.b[i];
        lane.ao = taps.a[i];
      }
    }
    if (g >= 1 && e < O) lane.zo = zi[static_cast<size_t>(e) * stride + c];
  }
  lane.tail = (g == 0) ? (LC >= O) : (e + 1 >= O);
  lane.base = (threadIdx.x % 32) & ~(G - 1);

  const T* xc = x + c;
  T* yc = y + c;
  const bool store = live && g == 0;
  const int full = T_len / kChunk;
  T cur[kChunk], nxt[kChunk], out[kChunk];
  load_rows<false>(cur, xc, min(kChunk, T_len), stride);
  int t0 = 0;
  for (int k = 0; k < full; ++k, t0 += kChunk) {
    const T* xn = xc + static_cast<size_t>(t0 + kChunk) * stride;
    if (k + 1 < full)
      load_rows<true>(nxt, xn, kChunk, stride);
    else
      load_rows<false>(nxt, xn, T_len - t0 - kChunk, stride);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) out[u] = lane.step(cur[u]);
    if (store) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u) yc[static_cast<size_t>(t0 + u) * stride] = out[u];
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) cur[u] = nxt[u];
  }
  const int rest = T_len - t0;  // fewer than kChunk rows, already in cur
  if (rest > 0) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (u < rest) out[u] = lane.step(cur[u]);
    if (store) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        if (u < rest) yc[static_cast<size_t>(t0 + u) * stride] = out[u];
    }
  }
}

// The step-chain probe: lane 0's chain of the kernel (y = b0 * x + z0, a1 * y,
// z0' = (b1 * x + z1) - a1 * y, the same intrinsics), T_len times in a row,
// with x and z1 fixed (read from the taps: b[2], a[2]) so that b0 * x and
// b1 * x + z1 stay off the chain, as they do in the kernel; with kShuffle,
// y also makes a __shfl_sync round trip each step, each lane taking the next
// lane's (a broadcast would make y the same in every lane, and the compiler
// then drops all but the first shuffle). Each lane starts from its own z0
// (its lane number times x). No loads, one store at the end.
template <typename T, bool kShuffle>
__global__ void __launch_bounds__(32)
iir_chain_kernel(const Taps<T> taps, T* __restrict__ out, int T_len, int M) {
  const T xt = taps.b[2];
  const T bx = mul_rn(taps.b[0], xt);
  const T p = add_rn(mul_rn(taps.b[1], xt), taps.a[2]);
  T z0 = mul_rn(static_cast<T>(threadIdx.x), xt), yt = T(0);
  for (int t = 0; t < T_len; ++t) {
    yt = add_rn(bx, z0);
    if constexpr (kShuffle) yt = __shfl_sync(kFull, yt, (threadIdx.x + 1) % 32);
    z0 = sub_rn(p, mul_rn(taps.a[1], yt));
  }
  if (static_cast<int>(threadIdx.x) < M) out[threadIdx.x] = yt;
}

template <typename T>
Taps<T> copy_taps(const T* b_host, const T* a_host, int n) {
  Taps<T> taps{};
  for (int i = 0; i < n; ++i) {
    taps.b[i] = b_host[i];
    taps.a[i] = a_host[i];
  }
  return taps;
}

template <typename T, int N>
void launch_n(const T* x, const T* zi, const Taps<T>& taps, T* y, int T_len, int M, int lanes,
              cudaStream_t stream) {
  constexpr int G = lanes_for(N);
  const long long threads = static_cast<long long>(M) * lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads)), block(kThreads);
  if constexpr (G > 1 && kLanesRoute<T>) {
    if (lanes == G) {
      iir_filter_kernel<T, N, G, kLocal><<<grid, block, 0, stream>>>(x, zi, taps, y, T_len, M);
      return;
    }
  }
  iir_filter_kernel<T, N, 1, N - 1><<<grid, block, 0, stream>>>(x, zi, taps, y, T_len, M);
}

template <typename T>
int launch(const T* x, const T* zi, const T* b_host, const T* a_host, T* y, int T_len,
           int M, int n, int lanes, cudaStream_t stream) {
  if (T_len < 0 || M < 0 || n < 1 || n > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  // the plan's lanes: 1 (the column route) or, where built, the lanes route's
  if (lanes != 1 && !(kLanesRoute<T> && lanes == lanes_for(n)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T_len == 0 || M == 0) return 0;
  const Taps<T> taps = copy_taps(b_host, a_host, n);
  switch (n) {
#define IIR_CASE(NT)                                                   \
  case NT:                                                             \
    launch_n<T, NT>(x, zi, taps, y, T_len, M, lanes, stream);          \
    break;
    IIR_CASE(1) IIR_CASE(2) IIR_CASE(3) IIR_CASE(4) IIR_CASE(5)
    IIR_CASE(6) IIR_CASE(7) IIR_CASE(8) IIR_CASE(9)
#undef IIR_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_chain(const T* b_host, const T* a_host, T* out, int T_len, int M, int shuffle,
                 cudaStream_t stream) {
  if (T_len < 0 || M < 1 || M > 32) return static_cast<int>(cudaErrorInvalidValue);
  const Taps<T> taps = copy_taps(b_host, a_host, 3);
  if (shuffle)
    iir_chain_kernel<T, true><<<1, 32, 0, stream>>>(taps, out, T_len, M);
  else
    iir_chain_kernel<T, false><<<1, 32, 0, stream>>>(taps, out, T_len, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (T, M) and zi (n - 1, M) on the card, row-major; b and a (n) on the
// host, normalised by a[0]; y (T, M) on the card; lanes a column from the
// plan (1: one thread a column). Returns a CUDA error code.
extern "C" int iir_filter_f64(const double* x, const double* zi, const double* b,
                              const double* a, double* y, int T, int M, int n, int lanes,
                              cudaStream_t stream) {
  return launch(x, zi, b, a, y, T, M, n, lanes, stream);
}

extern "C" int iir_filter_f32(const float* x, const float* zi, const float* b,
                              const float* a, float* y, int T, int M, int n, int lanes,
                              cudaStream_t stream) {
  return launch(x, zi, b, a, y, T, M, n, lanes, stream);
}

// The step-chain probe on one warp: b and a (3) on the host, out (M <= 32)
// on the card; shuffle 1 adds the broadcast of y to each step.
extern "C" int iir_filter_chain_f64(const double* b, const double* a, double* out, int T,
                                    int M, int shuffle, cudaStream_t stream) {
  return launch_chain(b, a, out, T, M, shuffle, stream);
}

extern "C" int iir_filter_chain_f32(const float* b, const float* a, float* out, int T, int M,
                                    int shuffle, cudaStream_t stream) {
  return launch_chain(b, a, out, T, M, shuffle, stream);
}
