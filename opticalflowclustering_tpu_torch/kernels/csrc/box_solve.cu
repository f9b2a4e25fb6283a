// box_solve: winsize x winsize box sum of M and the regularized 2x2 solve.
//
// Replaces the Pallas TPU kernel `_solve_kernel`
// (opticalflowclustering_tpu/kernels/warp.py:338, entry `fused_solve` :655),
// whose semantics are the reference's `_update_flow(m, winsize,
// gaussian=False)` (flow/farneback.py:402): per pixel
//   s    = box_sum(M, winsize, replicate border) * (1/winsize^2)
//   idet = 1 / (G11*G22 - G12*G12 + 1e-3)
//   fx   = (G11*h2 - G12*h1) * idet,   fy = (G22*h1 - G12*h2) * idet
// The vertical pass, then the horizontal pass, each in the symmetric-pair
// order of `ops.filters.box_sum`: acc = c; for d in 1..r: acc += (a[-d] +
// a[+d]). That order is fixed per output pixel, and the build uses
// --fmad=false, so the kernel equals the plain PyTorch version bit for bit
// whatever the schedule below does.
//
// What bounds it on the card: memory. It must read the 5 planes of M once and
// write the 2 flow planes: 28 bytes per pixel, 0.123 ms at [16,5,720,1280]
// and 3.35 TB/s. It does 20r + 18 adds and multiplies per pixel (158 at
// winsize 15), ~0.07 ms at one float32 op per lane per clock.
//
// The first design staged a 32x16 tile of all five channels in shared memory
// and ran both passes from there: ~40 shared-memory accesses per output and
// channel, ~200 per pixel, which at 32 words per clock per SM was most of its
// 0.62 ms. Half of its 512 threads idled in the second round of the vertical
// pass, and the tile read 2.7x its pixels as scalar loads. This design:
//   - makes r a template parameter, so every window is an unrolled register
//     array;
//   - vertical pass: a block's 128x32 output tile has 128 + 2r staged
//     columns per channel. Each thread takes one (channel, staged column) at
//     a time, loads the column's 32 + 2r clamped rows once from global memory
//     (neighbouring threads on neighbouring columns, so the loads coalesce),
//     forms the 32 vertical sums in registers and stores each to shared
//     memory once. 5 (128 + 2r) columns over 256 threads keep 92% of the
//     threads busy at r = 7;
//   - horizontal pass: a warp takes one row, each lane 4 consecutive
//     outputs. A lane reads the 4 + 2r vertical sums it needs per channel as
//     float4 loads (a warp reads consecutive 16-byte words: no bank
//     conflict), forms the 4 horizontal sums of all 5 channels in registers,
//     solves, and stores fx and fy as float4 (a warp writes 512 contiguous
//     bytes per plane). Shared-memory traffic per output and channel falls
//     from ~40 accesses to one store and (4 + 2r) / 4 loads;
//   - the tile reads (128 + 2r)(32 + 2r) / (128 * 32) = 1.6x its pixels at
//     r = 7, against 2.7x, and neighbouring tiles find the halo in L2;
//   - the vertical sums of all five channels take 5 x 32 x 144 floats =
//     90 KB of dynamic shared memory, so two blocks (16 warps) share an SM
//     and one block's loads overlap the other's arithmetic.
// Clamped coordinates are the replicate border; they stay right where the
// window is wider than the frame.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kTileX = 128;  // output columns of a block
constexpr int kTileY = 32;   // output rows of a block
constexpr int kStrip = 4;    // consecutive outputs of a row per lane
constexpr int kThreads = 256;
constexpr int kMaxRadius = 8;  // winsize <= 17
constexpr int kPitch = kTileX + 2 * kMaxRadius;  // floats per staged row
constexpr int kSmemBytes = 5 * kTileY * kPitch * static_cast<int>(sizeof(float));

static_assert(kStrip == 4 && kTileX == 32 * kStrip, "a warp covers a row as float4s");
static_assert(kPitch % 4 == 0, "staged rows start on 16-byte boundaries");

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
    box_solve_kernel(const float* __restrict__ m, float* __restrict__ fxo,
                     float* __restrict__ fyo, int h, int w, float inv_area) {
  constexpr int kCols = kTileX + 2 * R;  // staged columns per channel
  constexpr int kRows = kTileY + 2 * R;  // staged rows
  constexpr int kVec = (kStrip + 2 * R + 3) / 4;  // float4 loads per lane and channel
  static_assert(kStrip * 31 + 4 * kVec <= kPitch, "a lane's reads stay inside its row");
  extern __shared__ float4 smem[];
  float* vsum = reinterpret_cast<float*>(smem);  // [5][kTileY][kPitch]

  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t b = blockIdx.z;
  const float* mb = m + b * 5 * plane;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;

  // Vertical pass: staged column i of channel c covers frame column
  // x0 - R + i; its rows y0 - R .. y0 + kTileY - 1 + R are clamped.
  for (int u = threadIdx.x; u < 5 * kCols; u += kThreads) {
    const int c = u / kCols;
    const int i = u - c * kCols;
    const int gx = min(max(x0 - R + i, 0), w - 1);
    const float* col = mb + c * plane + gx;
    // The row addresses do not depend on u, and for r <= 5 ptxas hoisted
    // all kRows of them out of this loop; it then lacked the registers to
    // keep the column's loads in flight together, and the pass waited on
    // each load in turn. Hiding w and the top row from it keeps them inside.
    int wv = w, top = y0 - R;
    asm volatile("" : "+r"(wv), "+r"(top));
    float v[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int gy = min(max(top + j, 0), h - 1);
      v[j] = __ldg(col + static_cast<int64_t>(gy) * wv);
    }
    float* out = vsum + c * (kTileY * kPitch) + i;
#pragma unroll
    for (int t = 0; t < kTileY; ++t) {
      float acc = v[t + R];
#pragma unroll
      for (int d = 1; d <= R; ++d) acc = acc + (v[t + R - d] + v[t + R + d]);
      out[t * kPitch] = acc;
    }
  }
  __syncthreads();

  // Horizontal pass and solve: warp t % 8 takes row t, lane l the outputs
  // x0 + 4l .. x0 + 4l + 3, whose windows are staged columns 4l .. 4l+3+2R.
  const int lane = threadIdx.x & 31;
  const int x = x0 + kStrip * lane;
  const bool vec = (w & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(fxo) | reinterpret_cast<uintptr_t>(fyo)) & 15) == 0;
  for (int t = threadIdx.x >> 5; t < kTileY; t += kThreads / 32) {
    const int y = y0 + t;
    if (y >= h) break;
    float s[5][kStrip];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float4* row = reinterpret_cast<const float4*>(vsum + (c * kTileY + t) * kPitch) + lane;
      float a[4 * kVec];
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const float4 f = row[q];
        a[4 * q] = f.x;
        a[4 * q + 1] = f.y;
        a[4 * q + 2] = f.z;
        a[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int k = 0; k < kStrip; ++k) {
        float acc = a[k + R];
#pragma unroll
        for (int d = 1; d <= R; ++d) acc = acc + (a[k + R - d] + a[k + R + d]);
        s[c][k] = acc * inv_area;
      }
    }
    float fx[kStrip], fy[kStrip];
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      const float g11 = s[0][k], g12 = s[1][k], g22 = s[2][k], h1 = s[3][k], h2 = s[4][k];
      const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
      fx[k] = (g11 * h2 - g12 * h1) * idet;
      fy[k] = (g22 * h1 - g12 * h2) * idet;
    }
    const int64_t pix = b * plane + static_cast<int64_t>(y) * w + x;
    if (vec && x + kStrip <= w) {
      *reinterpret_cast<float4*>(fxo + pix) = make_float4(fx[0], fx[1], fx[2], fx[3]);
      *reinterpret_cast<float4*>(fyo + pix) = make_float4(fy[0], fy[1], fy[2], fy[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kStrip; ++k) {
        if (x + k < w) {
          fxo[pix + k] = fx[k];
          fyo[pix + k] = fy[k];
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

template <int R>
int launch(const float* m, float* fx, float* fy, int b, int h, int w, float inv_area,
           cudaStream_t stream) {
  // The shared-memory limit is a function attribute of each device's
  // context: set it at the first launch on a device, not at every launch.
  // Two threads racing here both set it, which is harmless.
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool known = dev < kMaxDevices;
  if (!known || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(box_solve_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (known) ready[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, b);
  box_solve_kernel<R><<<grid, kThreads, kSmemBytes, stream>>>(m, fx, fy, h, w, inv_area);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m: [b, 5, h, w]; fx, fy: [b, h, w]; contiguous float32 on the current
// device. radius = winsize / 2 <= 8; inv_area = float32(1 / winsize^2).
// Enqueues on `stream`; returns the launch's cudaError_t.
extern "C" int ofc_box_solve(const float* m, float* fx, float* fy, int b, int h,
                             int w, int radius, float inv_area, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 0: return launch<0>(m, fx, fy, b, h, w, inv_area, s);
    case 1: return launch<1>(m, fx, fy, b, h, w, inv_area, s);
    case 2: return launch<2>(m, fx, fy, b, h, w, inv_area, s);
    case 3: return launch<3>(m, fx, fy, b, h, w, inv_area, s);
    case 4: return launch<4>(m, fx, fy, b, h, w, inv_area, s);
    case 5: return launch<5>(m, fx, fy, b, h, w, inv_area, s);
    case 6: return launch<6>(m, fx, fy, b, h, w, inv_area, s);
    case 7: return launch<7>(m, fx, fy, b, h, w, inv_area, s);
    case 8: return launch<8>(m, fx, fy, b, h, w, inv_area, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
