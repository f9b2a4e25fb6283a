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
// last axis does), so the 80-row tile is one wave of 80 blocks, one per SM.
//
// The gather stays in the loop. On the TPU, x = x0 + i is formed each
// iteration and the take reads that fresh value. Here every iteration i
// stores the row of x0 + i into a shared-memory buffer of its own and
// gathers from that buffer: each take body gathers, in every iteration,
// values written in that iteration. fl(x0 + i)[j] equals fl(x0[j] + i), so a
// loop that gathered the loop-invariant x0 once and added i afterwards
// would give the same bits and measure no gather at all; that is why the
// stored row is the fresh one and the read comes after the store.
//
// What bounds it on Hopper. mul and where: the dependent add (where: a
// select and an add) on acc per iteration, and 4 instructions a warp issues
// per iteration. The take bodies: shared memory, at one 128-byte wavefront
// per clock per SM. A row's 4 warps store 4 wavefronts a stage (8 for
// two_takes), and a random gather of a warp takes as many wavefronts as its
// busiest bank has distinct words (f32: 1 to 4, 2.77 on average for the
// probes' seed-0 idx; bf16: 2), so the busiest row of that tile needs 4 + 13
// wavefronts an iteration for take (4 + 8 for take_bf16, 8 + 26 for
// two_takes) on its SM, whatever the schedule.
//
// What the design does about it:
// - Stage groups. kUnroll successive iterations store their kUnroll fresh
//   rows into kUnroll buffers, wait at one __syncthreads(), and issue their
//   kUnroll gathers back to back, so the barrier is paid once a group and
//   the gathers' latencies overlap. The values a group gathers are added to
//   acc after the next group's gathers (they do not depend on acc), in the
//   order of i. Groups alternate between two buffer sets: the barrier of
//   group g + 1 orders every read of group g before the writes of group
//   g + 2, so one barrier a group suffices. The n mod kUnroll iterations
//   left over run as one short group at the end, with the same order of
//   adds on acc. ptxas hoists a group's adds above the next barrier, so
//   shared memory idles for a barrier's round trip once a group; 16
//   iterations a group make that a sixteenth. On an H100 SXM at 700 W take
//   ran 11.3 ns an iteration with 8, 9.2 with 16; a pipeline one group
//   deeper on split mbarrier arrive/wait ran 19 to 21.
// - No conversion per element. The counter is a float: a group's base fb
//   (a multiple of kUnroll, incremented by kUnroll.0f) plus the constant k,
//   exact and equal to (float)i for i < 2^24. packed_take_unpack turns each
//   16-bit half k into a float as __int_as_float(0x4B000000 | k) - 2^23,
//   exact for k < 2^23. take_bf16 rounds two iterations' counters with one
//   packed conversion (cvt.rn.bf16x2.f32) and their sums with another: 8.9
//   ns an iteration, against 14.6 for rounding each by integer operations
//   on its bits.
//
// Every element runs x0 + i, then g, then acc + g, in that order, and the
// build uses --fmad=false, so the kernel equals its plain PyTorch version bit
// for bit (finite inputs). take_bf16 rounds i to bf16, adds in float32,
// rounds the sum once to bf16 and widens the gathered value to float32
// before the accumulate, the rounding points of XLA's bf16 add.
// packed_take_unpack shifts as unsigned, like lax.shift_right_logical.
// Indices outside [0, 128) are clamped to it.
//
// dynslice copies a 24-row window of a bf16 [80, 128] tile, widened to
// float32, starting at row rem(off, 8) * 8 (C's truncating %), clamped to
// [0, 56] as lax.dynamic_slice clamps. The offset is read on the device, the
// counterpart of the TPU kernel's SMEM scalar. It reads the window alone
// (6,144 bytes): each of 384 threads loads 8 bf16 as one 16-byte load,
// widens them in registers and stores two 16-byte float4s. No shared
// memory, no barrier. It is bound by the launch and by two dependent
// device-memory reads (the offset, then the window), not by its bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 80;
constexpr int kWindow = 24;
constexpr int kUnroll = 16;  // iterations a stage group; kernels/probes.py UNROLL
constexpr int kDynThreads = kWindow * kLanes / 8;  // 8 bf16 (16 bytes) each

static_assert(kUnroll >= 2 && kUnroll % 2 == 0, "kUnroll must be even");

// k (0 <= k < 2^23) as a float, without a conversion instruction.
__device__ __forceinline__ float small_uint_to_float(unsigned k) {
  return __uint_as_float(0x4B000000u | k) - 8388608.0f;
}

struct Mul {
  using In = float;
  static constexpr bool kStaged = false;
  struct Row {
    float x;
  };
  __device__ __forceinline__ static Row row(float x0) { return {x0}; }
  __device__ __forceinline__ static float g(const Row& r, int, float fi, float) {
    return (r.x + fi) * 1.0001f;
  }
};

struct Where {
  using In = float;
  static constexpr bool kStaged = false;
  struct Row {
    float x;
  };
  __device__ __forceinline__ static Row row(float x0) { return {x0}; }
  __device__ __forceinline__ static float g(const Row& r, int j, float fi,
                                            float acc) {
    const float x = r.x + fi;
    return j > 64 ? x : acc;
  }
};

// A staged body stores the fresh row of one iteration (put), gathers from it
// (load) and turns what it gathered into g (value, off the load's latency).
struct F32Staged {
  using In = float;
  static constexpr bool kStaged = true;
  static constexpr bool kPairs = false;
  struct Row {
    float x;
  };
  __device__ __forceinline__ static Row row(float x0) { return {x0}; }
};

struct Take : F32Staged {
  struct Stage {
    float x[kLanes];
  };
  using Val = float;
  __device__ __forceinline__ static void put(Stage& s, int lane, const Row& r,
                                             float fi) {
    s.x[lane] = r.x + fi;
  }
  __device__ __forceinline__ static Val load(const Stage& s, int j) {
    return s.x[j];
  }
  __device__ __forceinline__ static float value(Val v) { return v; }
};

struct PackedTakeUnpack : Take {
  __device__ __forceinline__ static float value(Val v) {
    const unsigned u = __float_as_uint(v);
    return small_uint_to_float(u & 0xFFFFu) + small_uint_to_float(u >> 16);
  }
};

struct TwoTakes : F32Staged {
  struct Row {
    float x, xm;  // x0 and the loop-invariant x0 * 1.0001
  };
  __device__ __forceinline__ static Row row(float x0) {
    return {x0, x0 * 1.0001f};
  }
  struct Stage {
    float a[kLanes];
    float b[kLanes];
  };
  struct Val {
    float a, b;
  };
  __device__ __forceinline__ static void put(Stage& s, int lane, const Row& r,
                                             float fi) {
    s.a[lane] = r.x + fi;
    s.b[lane] = r.xm + fi;
  }
  __device__ __forceinline__ static Val load(const Stage& s, int j) {
    return {s.a[j], s.b[j]};
  }
  __device__ __forceinline__ static float value(Val v) { return v.a + v.b; }
};

struct TakeBf16 {
  using In = __nv_bfloat16;
  static constexpr bool kStaged = true;
  static constexpr bool kPairs = true;
  struct Row {
    float x;
  };
  __device__ __forceinline__ static Row row(__nv_bfloat16 x0) {
    return {__bfloat162float(x0)};
  }
  struct Stage {
    unsigned short x[kLanes];  // bf16 bits
  };
  using Val = unsigned;
  __device__ __forceinline__ static void put(Stage& s, int lane, const Row& r,
                                             float fi) {
    const float ib = __bfloat162float(__float2bfloat16_rn(fi));
    s.x[lane] = __bfloat16_as_ushort(__float2bfloat16_rn(r.x + ib));
  }
  // Two iterations with one conversion of their counters and one of their
  // sums; the same roundings as put.
  __device__ __forceinline__ static void put2(Stage& s0, Stage& s1, int lane,
                                              const Row& r, float fi0,
                                              float fi1) {
    const float2 ib = __bfloat1622float2(__floats2bfloat162_rn(fi0, fi1));
    const __nv_bfloat162 v = __floats2bfloat162_rn(r.x + ib.x, r.x + ib.y);
    s0.x[lane] = __bfloat16_as_ushort(v.x);
    s1.x[lane] = __bfloat16_as_ushort(v.y);
  }
  __device__ __forceinline__ static Val load(const Stage& s, int j) {
    return s.x[j];
  }
  __device__ __forceinline__ static float value(Val v) {
    return __uint_as_float(v << 16);
  }
};

// Stores the fresh rows of iterations fb + k, k < r, into s[k].
template <class Body>
__device__ __forceinline__ void put_group(typename Body::Stage* s, int lane,
                                          const typename Body::Row& row,
                                          float fb, int r) {
#pragma unroll
  for (int k = 0; k < kUnroll; k += 2) {
    const float f0 = fb + static_cast<float>(k);
    const float f1 = fb + static_cast<float>(k + 1);
    if constexpr (Body::kPairs) {
      if (k + 1 < r) {
        Body::put2(s[k], s[k + 1], lane, row, f0, f1);
        continue;
      }
    }
    if (k < r) Body::put(s[k], lane, row, f0);
    if (k + 1 < r) Body::put(s[k + 1], lane, row, f1);
  }
}

template <class Body>
__device__ __forceinline__ float plain_loop(const typename Body::Row& row,
                                            int j, int n) {
  float acc = 0.0f;
  float fb = 0.0f;
  int i = 0;
  for (; i + kUnroll <= n; i += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      acc = acc + Body::g(row, j, fb + static_cast<float>(k), acc);
    }
    fb += static_cast<float>(kUnroll);
  }
  for (float fi = fb; i < n; ++i, fi += 1.0f) acc = acc + Body::g(row, j, fi, acc);
  return acc;
}

template <class Body>
__device__ __forceinline__ float staged_loop(const typename Body::Row& row,
                                             int j, int lane, int n) {
  using Val = typename Body::Val;
  static_assert(sizeof(typename Body::Stage) * 2 * kUnroll <= 48 * 1024,
                "the two stage sets must fit in static shared memory");
  __shared__ typename Body::Stage stage[2][kUnroll];
  const int groups = n / kUnroll;
  const int rem = n - groups * kUnroll;
  float acc = 0.0f;
  float fb = 0.0f;
  Val held[kUnroll];  // gathered by the last group, not yet added
#pragma unroll 2
  for (int grp = 0; grp < groups; ++grp) {
    typename Body::Stage* s = stage[grp & 1];
    put_group<Body>(s, lane, row, fb, kUnroll);
    fb += static_cast<float>(kUnroll);
    __syncthreads();
    Val got[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) got[k] = Body::load(s[k], j);
    if (grp > 0) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) acc = acc + Body::value(held[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) held[k] = got[k];
  }
  Val tail[kUnroll];
  if (rem > 0) {  // uniform across the block
    typename Body::Stage* s = stage[groups & 1];
    put_group<Body>(s, lane, row, fb, rem);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (k < rem) tail[k] = Body::load(s[k], j);
    }
  }
  if (groups > 0) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc = acc + Body::value(held[k]);
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (k < rem) acc = acc + Body::value(tail[k]);
  }
  return acc;
}

template <class Body>
__global__ void __launch_bounds__(kLanes)
    loop_probe_kernel(const typename Body::In* __restrict__ x,
                      const int* __restrict__ idx, float* __restrict__ out,
                      int n) {
  const int lane = threadIdx.x;
  const int64_t at = static_cast<int64_t>(blockIdx.x) * kLanes + lane;
  const typename Body::Row row = Body::row(x[at]);
  const int j = min(max(idx[at], 0), kLanes - 1);
  if constexpr (Body::kStaged) {
    out[at] = staged_loop<Body>(row, j, lane, n);
  } else {
    out[at] = plain_loop<Body>(row, j, n);
  }
}

template <class Body>
int launch_loop(const void* x, const int* idx, float* out, int rows, int n,
                cudaStream_t stream) {
  loop_probe_kernel<Body><<<rows, kLanes, 0, stream>>>(
      static_cast<const typename Body::In*>(x), idx, out, n);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float4 widen_bf16x4(unsigned lo, unsigned hi) {
  return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xFFFF0000u),
                     __uint_as_float(hi << 16), __uint_as_float(hi & 0xFFFF0000u));
}

__global__ void __launch_bounds__(kDynThreads)
    dynslice_kernel(const __nv_bfloat16* __restrict__ x,
                    const int* __restrict__ off, float* __restrict__ out) {
  const int start = min(max((off[0] % 8) * 8, 0), kRows - kWindow);
  const uint4 v =
      reinterpret_cast<const uint4*>(x + start * kLanes)[threadIdx.x];
  float4* o = reinterpret_cast<float4*>(out) + 2 * threadIdx.x;
  o[0] = widen_bf16x4(v.x, v.y);
  o[1] = widen_bf16x4(v.z, v.w);
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

// x: [80, 128] bf16, 16-byte aligned; off: one int32; out: [24, 128]
// float32, 16-byte aligned; contiguous, on the current device. Enqueues on
// `stream`; returns the launch's cudaError_t.
extern "C" int ofc_dynslice(const void* x, const int* off, float* out,
                            void* stream) {
  dynslice_kernel<<<1, kDynThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), off, out);
  return static_cast<int>(cudaGetLastError());
}
