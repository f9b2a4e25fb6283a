// probes: the gather-cost microbenchmark kernels, timed loops over one
// [rows, 128] tile.
//
// Replaces the four Pallas TPU probe kernels:
//   make(op, n).run            scripts/gather_cost_probe.py:34 (pallas_call :53),
//                              op = mul, where, take
//   make_bf16_take(n).run      scripts/gather_cost_probe.py:94 (:110)
//   _loop_kernel(body, n).run  scripts/profile_r4.py:72 (:86), with the bodies
//                              two_takes and packed_take_unpack of
//                              experiment_a_packed_takes (:111-125)
//   probe_bf16_dynslice.run    scripts/gather_cost_probe.py:133 (:142)
//
// loop_probe<Body> runs acc = acc + g(x0 + i) for i < n, per element, with
// acc starting at 0; each Body is one g. One block of 128 threads owns one
// row of the tile (the gathers stay inside a row, as take_along_axis on the
// last axis does), so the 80-row tile is one wave of 80 blocks.
//
// The gather stays in the loop. On the TPU, x = x0 + i is formed each
// iteration and the take reads that fresh value. Here each iteration stores
// the row of x0 + i into shared memory, waits at a barrier, and gathers from
// there. The stored value depends on i, so the compiler cannot hoist the
// gather of a loop-invariant x0. The stage is double-buffered (iteration i
// uses buffer i & 1): the barrier of iteration i+1 orders every read of
// iteration i before the writes of iteration i+2, so one barrier per
// iteration suffices.
//
// What it measures on Hopper: a shared-memory store, a barrier and a
// shared-memory gather (plus an add), against a select and a multiply, as
// the latency of one dependent chain per thread on one wave of blocks. That
// is a different thing from the TPU's intra-vreg lane gather; the slope
// between two trip counts cancels the launch.
//
// Every element runs x0 + (float)i, then g, then acc + g, in that order,
// and the build uses --fmad=false, so the kernel equals its plain PyTorch
// version bit for bit. i < 2^24 is exact in float32. take_bf16 rounds i to
// bf16 (nearest even), adds in float32, rounds the sum once to bf16 and
// widens the gathered value to float32 before the accumulate, the rounding
// points of XLA's bf16 add. packed_take_unpack shifts as unsigned, like
// lax.shift_right_logical. Indices outside [0, 128) are clamped to it.
//
// dynslice copies a 24-row window of a bf16 [80, 128] tile, widened to
// float32, starting at row rem(off, 8) * 8 (C's truncating %), clamped to
// [0, 56] as lax.dynamic_slice clamps. The offset is read on the device, the
// counterpart of the TPU kernel's SMEM scalar; the block stages the tile in
// shared memory and copies the window out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 80;
constexpr int kWindow = 24;
constexpr int kDynThreads = 256;

struct Mul {
  using In = float;
  struct Stage {};
  __device__ __forceinline__ static float g(float x0, int, float fi, float,
                                            Stage&, int) {
    return (x0 + fi) * 1.0001f;
  }
};

struct Where {
  using In = float;
  struct Stage {};
  __device__ __forceinline__ static float g(float x0, int j, float fi,
                                            float acc, Stage&, int) {
    const float x = x0 + fi;
    return j > 64 ? x : acc;
  }
};

struct Take {
  using In = float;
  struct Stage {
    float x[kLanes];
  };
  __device__ __forceinline__ static float g(float x0, int j, float fi, float,
                                            Stage& s, int lane) {
    s.x[lane] = x0 + fi;
    __syncthreads();
    return s.x[j];
  }
};

struct TakeBf16 {
  using In = __nv_bfloat16;
  struct Stage {
    __nv_bfloat16 x[kLanes];
  };
  __device__ __forceinline__ static float g(__nv_bfloat16 x0, int j, float fi,
                                            float, Stage& s, int lane) {
    const float ib = __bfloat162float(__float2bfloat16_rn(fi));
    s.x[lane] = __float2bfloat16_rn(__bfloat162float(x0) + ib);
    __syncthreads();
    return __bfloat162float(s.x[j]);
  }
};

struct TwoTakes {
  using In = float;
  struct Stage {
    float a[kLanes];
    float b[kLanes];
  };
  __device__ __forceinline__ static float g(float x0, int j, float fi, float,
                                            Stage& s, int lane) {
    s.a[lane] = x0 + fi;
    s.b[lane] = x0 * 1.0001f + fi;
    __syncthreads();
    return s.a[j] + s.b[j];
  }
};

struct PackedTakeUnpack {
  using In = float;
  struct Stage {
    float x[kLanes];
  };
  __device__ __forceinline__ static float g(float x0, int j, float fi, float,
                                            Stage& s, int lane) {
    s.x[lane] = x0 + fi;
    __syncthreads();
    const unsigned u = __float_as_uint(s.x[j]);
    const float lo = static_cast<float>(static_cast<int>(u & 0xFFFFu));
    const float hi = static_cast<float>(static_cast<int>(u >> 16));
    return lo + hi;
  }
};

template <class Body>
__global__ void __launch_bounds__(kLanes)
    loop_probe_kernel(const typename Body::In* __restrict__ x,
                      const int* __restrict__ idx, float* __restrict__ out,
                      int n) {
  __shared__ typename Body::Stage stage[2];
  const int lane = threadIdx.x;
  const int64_t at = static_cast<int64_t>(blockIdx.x) * kLanes + lane;
  const typename Body::In x0 = x[at];
  const int j = min(max(idx[at], 0), kLanes - 1);
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    acc = acc + Body::g(x0, j, static_cast<float>(i), acc, stage[i & 1], lane);
  }
  out[at] = acc;
}

template <class Body>
int launch_loop(const void* x, const int* idx, float* out, int rows, int n,
                cudaStream_t stream) {
  loop_probe_kernel<Body><<<rows, kLanes, 0, stream>>>(
      static_cast<const typename Body::In*>(x), idx, out, n);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kDynThreads)
    dynslice_kernel(const __nv_bfloat16* __restrict__ x,
                    const int* __restrict__ off, float* __restrict__ out) {
  __shared__ __nv_bfloat16 tile[kRows * kLanes];
  for (int k = threadIdx.x; k < kRows * kLanes; k += kDynThreads) tile[k] = x[k];
  const int start = min(max((off[0] % 8) * 8, 0), kRows - kWindow);
  __syncthreads();
  for (int k = threadIdx.x; k < kWindow * kLanes; k += kDynThreads) {
    out[k] = __bfloat162float(tile[start * kLanes + k]);
  }
}

}  // namespace

// body: 0 mul, 1 where, 2 take, 3 take_bf16, 4 two_takes,
// 5 packed_take_unpack (the order of kernels/probes.py BODIES).
// x: [rows, 128] float32 (bf16 for take_bf16); idx: [rows, 128] int32;
// out: [rows, 128] float32; contiguous, on the current device; 0 <= n < 2^24.
// Enqueues on `stream`; returns the launch's cudaError_t.
extern "C" int ofc_loop_probe(int body, const void* x, const int* idx,
                              float* out, int rows, int n, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0: return launch_loop<Mul>(x, idx, out, rows, n, s);
    case 1: return launch_loop<Where>(x, idx, out, rows, n, s);
    case 2: return launch_loop<Take>(x, idx, out, rows, n, s);
    case 3: return launch_loop<TakeBf16>(x, idx, out, rows, n, s);
    case 4: return launch_loop<TwoTakes>(x, idx, out, rows, n, s);
    case 5: return launch_loop<PackedTakeUnpack>(x, idx, out, rows, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: [80, 128] bf16; off: one int32; out: [24, 128] float32; contiguous, on
// the current device. Enqueues on `stream`; returns the launch's cudaError_t.
extern "C" int ofc_dynslice(const void* x, const int* off, float* out,
                            void* stream) {
  dynslice_kernel<<<1, kDynThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), off, out);
  return static_cast<int>(cudaGetLastError());
}
