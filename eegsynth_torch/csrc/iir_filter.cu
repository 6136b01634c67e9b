// IIR filter: the direct-form-II-transposed recurrence over the rows of
// x (T, M), float64, float32, bfloat16 or float16, each column's state
// spread over a group of lanes (the "lanes" route), held in registers by
// one thread (the "column" route), or, past the orders those are built for,
// held in memory by one thread (the "runtime" route).
//
// It replaces no Pallas kernel. The JAX package filters with a lax.scan of
// the same recurrence (eegsynth/ops/filtering.py:43-77, the scan at :76),
// which XLA compiles into one loop; as PyTorch operations one time step is
// about seven launches. Preprocessing runs four passes a file (notch and
// band-pass, forward and backward), each over the trial plus its odd
// extension, 14 columns at a time.
//
// Per step, with normalised taps b, a (n of them) and state z (O = n - 1):
//   y    = b0 * x + z0
//   z_i <- (b_{i+1} * x + z_{i+1}) - a_{i+1} * y      (z_O = 0)
// Every product and sum is rounded on its own (the _rn intrinsics, which
// nvcc never contracts into a fused multiply-add), in this order, as the
// plain PyTorch version (eegsynth_torch/ops/filtering.py lfilter_reference)
// and scipy.signal.lfilter round them: the kernel equals both bit for bit.
// In bfloat16 and float16 each product and sum is taken in float32 and
// rounded to x's dtype (to nearest even), as PyTorch rounds each operation
// of the plain version in those dtypes.
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
// On every route x is loaded a chunk of kChunk rows ahead into registers
// (every lane of a group reads its column's row), the step is unrolled over
// the chunk with no bounds test (the last, partial chunk apart), and lane 0
// of a group stores the chunk's y after it. (Loads and stores spread one row
// a step over the chunk ran slower on the H100: PERF.md.)
//
// Which orders are built: the state, the taps and the chunks live in
// registers only where n is a template parameter, one kernel instance for
// each n, which the build pays for (ptxas compiles them one after another).
// The lanes route is built for float64 up to kMaxLaneTaps (17: 16 lanes a
// column; a warp would hold a column to 34 taps), the column route for
// float32 up to kMaxColumnTaps (17: 16 state elements, 34 taps and three
// chunks in a thread's registers) and for float64 up to 9 (its plan takes
// it to 3 taps; tools/iir_variants.py times it at preprocessing's 9). Past
// them, and in bfloat16 and float16 at every n, the runtime route takes the
// order as an argument: one thread a column, the taps in a device buffer
// (read by every lane at one address), the state element i of column c at
// i * stride + c of a buffer of its own, in shared memory where a block's
// 128 columns' states fit the 48 KB every card gives a block, else in a
// global buffer laid out as local memory is (element i of neighbouring
// columns side by side), cached in L1. The taps a kernel parameter carries
// stop at kMaxTaps; a buffer has no such bound.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLaneTaps = 17;    // the lanes route's widest n: lanes_for(17) = 16
constexpr int kMaxColumnTaps = 17;  // the column route's widest n (float32)
constexpr int kMaxTaps = 17;        // the widest templated n, the taps a parameter carries
constexpr int kSharedStateBytes = 49152;  // 48 KB: the runtime route's state in shared memory
constexpr int kThreads = 128;
constexpr int kRuntimeGroup = 8;  // state elements the runtime route loads ahead
constexpr int kChunk = 16;
constexpr int kLocal = 2;
constexpr unsigned kFull = 0xffffffffu;
// The dtypes the lanes route is built for
template <typename T>
constexpr bool kLanesRoute = sizeof(T) == 8;
// The column route's widest n in each dtype: float32 kMaxColumnTaps,
// float64 9, none in bfloat16 and float16 (the runtime route takes them)
template <typename T>
constexpr int kColumnTaps = sizeof(T) == 4 ? kMaxColumnTaps : sizeof(T) == 8 ? 9 : 0;

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
// bfloat16 and float16: the operation in float32, rounded to the dtype
__device__ __forceinline__ __nv_bfloat16 mul_rn(__nv_bfloat16 p, __nv_bfloat16 q) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(p), __bfloat162float(q)));
}
__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 p, __nv_bfloat16 q) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(p), __bfloat162float(q)));
}
__device__ __forceinline__ __nv_bfloat16 sub_rn(__nv_bfloat16 p, __nv_bfloat16 q) {
  return __float2bfloat16_rn(__fsub_rn(__bfloat162float(p), __bfloat162float(q)));
}
__device__ __forceinline__ __half mul_rn(__half p, __half q) {
  return __float2half_rn(__fmul_rn(__half2float(p), __half2float(q)));
}
__device__ __forceinline__ __half add_rn(__half p, __half q) {
  return __float2half_rn(__fadd_rn(__half2float(p), __half2float(q)));
}
__device__ __forceinline__ __half sub_rn(__half p, __half q) {
  return __float2half_rn(__fsub_rn(__half2float(p), __half2float(q)));
}

template <typename T>
__device__ __forceinline__ T zero() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }
template <>
__device__ __forceinline__ __half zero<__half>() { return __float2half_rn(0.f); }

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
    T zn = zero<T>();
    if constexpr (G > 1) {
      const T s = __shfl_down_sync(kFull, zo, 1);
      zn = tail ? zero<T>() : s;
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
    buf[u] = (kAll || u < rows) ? xc[static_cast<size_t>(u) * stride] : zero<T>();
}

// The rows of one column (every lane of a group runs it): x's rows from xc
// on, a chunk loaded ahead, step(x_t) -> y_t on each, and, with store, y's
// rows from yc on after each chunk.
template <typename T, typename Step>
__device__ __forceinline__ void run_rows(const T* __restrict__ xc, T* __restrict__ yc,
                                         int T_len, size_t stride, bool store, Step step) {
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
    for (int u = 0; u < kChunk; ++u) out[u] = step(cur[u]);
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
      if (u < rest) out[u] = step(cur[u]);
    if (store) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        if (u < rest) yc[static_cast<size_t>(t0 + u) * stride] = out[u];
    }
  }
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
    lane.zl[i] = i < LC ? zi[static_cast<size_t>(i) * stride + c] : zero<T>();
  }
  const int e = LC - 1 + g;  // lane g's element
  lane.bo = lane.ao = lane.zo = zero<T>();
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

  run_rows(x + c, y + c, T_len, stride, live && g == 0, [&](T xt) { return lane.step(xt); });
}

// Any n (order n - 1, known at run time), one thread a column: the taps
// b (n) then a (n) in a device buffer, the state element i at s[i * ss],
// in shared memory (shared_state: each thread's own slots, ss = kThreads;
// z (O, M) holds zi) or in z itself (ss = M), which the kernel then
// updates in place.
template <typename T>
__global__ void __launch_bounds__(kThreads)
iir_filter_runtime_kernel(const T* __restrict__ x, T* __restrict__ z, const T* __restrict__ taps,
                          T* __restrict__ y, int T_len, int M, int n, bool shared_state) {
  extern __shared__ __align__(16) unsigned char iir_state_smem[];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= M) return;  // no barrier follows: a thread's slots are its own
  const int O = n - 1;
  const size_t stride = static_cast<size_t>(M);
  T* s = z + c;
  size_t ss = stride;
  if (shared_state) {
    s = reinterpret_cast<T*>(iir_state_smem) + threadIdx.x;
    ss = kThreads;
    for (int i = 0; i < O; ++i) s[i * ss] = z[i * stride + c];
  }
  const T* tb = taps;
  const T* ta = taps + n;
  const T b0 = tb[0];
  run_rows(x + c, y + c, T_len, stride, true, [&](T xt) {
    const T yt = add_rn(mul_rn(b0, xt), O > 0 ? s[0] : zero<T>());
    // the step's elements are independent of one another: load a group's
    // z_{i+1} of the step before and its taps, then form and store its z_i,
    // so that no load waits on the stores before it
    for (int i0 = 0; i0 < O; i0 += kRuntimeGroup) {
      T next[kRuntimeGroup], bk[kRuntimeGroup], ak[kRuntimeGroup];
#pragma unroll
      for (int k = 0; k < kRuntimeGroup; ++k) {
        const int i = i0 + k + 1;
        next[k] = i < O ? s[i * ss] : zero<T>();
        bk[k] = i <= O ? tb[i] : zero<T>();
        ak[k] = i <= O ? ta[i] : zero<T>();
      }
#pragma unroll
      for (int k = 0; k < kRuntimeGroup; ++k) {
        if (i0 + k < O)
          s[(i0 + k) * ss] = sub_rn(add_rn(mul_rn(bk[k], xt), next[k]), mul_rn(ak[k], yt));
      }
    }
    return yt;
  });
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

// N taps on the route the plan's lanes name: the lanes route's G (where
// built: float64, N up to kMaxLaneTaps) or 1, the column route (N up to
// kColumnTaps); anything else is refused before a launch.
template <typename T, int N>
cudaError_t launch_n(const T* x, const T* zi, const Taps<T>& taps, T* y, int T_len, int M,
                     int lanes, cudaStream_t stream) {
  constexpr int G = lanes_for(N);
  const long long threads = static_cast<long long>(M) * lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads)), block(kThreads);
  if constexpr (G > 1 && kLanesRoute<T> && N <= kMaxLaneTaps) {
    if (lanes == G) {
      iir_filter_kernel<T, N, G, kLocal><<<grid, block, 0, stream>>>(x, zi, taps, y, T_len, M);
      return cudaGetLastError();
    }
  }
  if constexpr (N <= kColumnTaps<T>) {
    if (lanes == 1) {
      iir_filter_kernel<T, N, 1, N - 1><<<grid, block, 0, stream>>>(x, zi, taps, y, T_len, M);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

// launch_n for the n given, N = 1 .. kMaxTaps
template <typename T, int N = 1>
cudaError_t launch_taps(int n, const T* x, const T* zi, const Taps<T>& taps, T* y, int T_len,
                        int M, int lanes, cudaStream_t stream) {
  if constexpr (N > kMaxTaps) {
    return cudaErrorInvalidValue;
  } else {
    if (n == N) return launch_n<T, N>(x, zi, taps, y, T_len, M, lanes, stream);
    return launch_taps<T, N + 1>(n, x, zi, taps, y, T_len, M, lanes, stream);
  }
}

template <typename T>
int launch(const T* x, const T* zi, const T* b_host, const T* a_host, T* y, int T_len,
           int M, int n, int lanes, cudaStream_t stream) {
  if (T_len < 0 || M < 0 || n < 1 || n > kMaxTaps || lanes < 1 || lanes > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T_len == 0 || M == 0) {
    // refuse what a launch would refuse: a route not built for n
    const bool lanes_ok = kLanesRoute<T> && lanes == lanes_for(n) && lanes > 1 &&
                          n <= kMaxLaneTaps;
    return lanes_ok || (lanes == 1 && n <= kColumnTaps<T>)
               ? 0 : static_cast<int>(cudaErrorInvalidValue);
  }
  const Taps<T> taps = copy_taps(b_host, a_host, n);
  return static_cast<int>(launch_taps<T>(n, x, zi, taps, y, T_len, M, lanes, stream));
}

template <typename T>
int launch_runtime(const T* x, T* z, const T* taps, T* y, int T_len, int M, int n,
                   cudaStream_t stream) {
  if (T_len < 0 || M < 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (T_len == 0 || M == 0) return 0;
  const size_t smem = static_cast<size_t>(kThreads) * (n - 1) * sizeof(T);
  const bool shared_state = smem <= static_cast<size_t>(kSharedStateBytes);
  const dim3 grid(static_cast<unsigned>((M + kThreads - 1) / kThreads)), block(kThreads);
  iir_filter_runtime_kernel<T><<<grid, block, shared_state ? smem : 0, stream>>>(
      x, z, taps, y, T_len, M, n, shared_state);
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
// plan (1: one thread a column, n <= kColumnTaps; the lanes route's count
// in float64, n <= kMaxLaneTaps). Returns a CUDA error code.
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

// The runtime route, any n >= 1, every dtype: x (T, M) on the card; z (n - 1, M) on the
// card, zi on entry (the kernel may overwrite it with its state); taps (2n)
// on the card, b then a, normalised by a[0]; y (T, M) on the card.
extern "C" int iir_filter_runtime_f64(const double* x, double* z, const double* taps, double* y,
                                      int T, int M, int n, cudaStream_t stream) {
  return launch_runtime(x, z, taps, y, T, M, n, stream);
}

extern "C" int iir_filter_runtime_f32(const float* x, float* z, const float* taps, float* y,
                                      int T, int M, int n, cudaStream_t stream) {
  return launch_runtime(x, z, taps, y, T, M, n, stream);
}

extern "C" int iir_filter_runtime_bf16(const __nv_bfloat16* x, __nv_bfloat16* z,
                                       const __nv_bfloat16* taps, __nv_bfloat16* y, int T,
                                       int M, int n, cudaStream_t stream) {
  return launch_runtime(x, z, taps, y, T, M, n, stream);
}

extern "C" int iir_filter_runtime_f16(const __half* x, __half* z, const __half* taps, __half* y,
                                      int T, int M, int n, cudaStream_t stream) {
  return launch_runtime(x, z, taps, y, T, M, n, stream);
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
