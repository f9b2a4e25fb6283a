// gauss_solve: the Gaussian-weighted window sum of M and the regularized
// 2x2 solve, OpenCV's OPTFLOW_FARNEBACK_GAUSSIAN update of the flow.
//
// Replaces no Pallas kernel: the JAX package runs the Gaussian window as
// plain jnp in `_update_flow(m, winsize, gaussian=True)`
// (opticalflowclustering_tpu/flow/farneback.py) on every backend, and so did
// the port (flow/farneback.py `_update_flow`): some 50 eager operators a
// call, two 13-tap passes over five planes and the solve, called
// `iterations` times at every pyramid level. This kernel is that call in one
// launch. Per pixel, with M = winsize / 2 and k[d] the float32 weight at
// distance d (the float64 Gaussian of sigma 0.3 M, normalised, then
// rounded):
//   vertical:   v = k[0]*M[y];   for d = 1..M: v = v + k[d]*(M[y-d] + M[y+d])
//   horizontal: s = k[0]*v[x];   for d = 1..M: s = s + k[d]*(v[x-d] + v[x+d])
//   idet = 1 / (G11*G22 - G12*G12 + 1e-3)
//   fx   = (G11*h2 - G12*h1) * idet,   fy = (G22*h1 - G12*h2) * idet
// for each of the five planes (G11, G12, G22, h1, h2), rows and columns
// beyond the frame replicating its edge. That is `ops.filters.sep_filter_axis`'s
// symmetric-pair order; the build uses --fmad=false, so the kernel equals
// the plain version bit for bit whatever the schedule below does.
//
// What bounds it on the card: memory. It must read the 5 planes of M once
// and write the 2 flow planes: 28 bytes a pixel, 0.1232 ms at
// [16,5,720,1280] and 3.35 TB/s. Its 30M + 23 float32 operations a pixel
// (203 at winsize 13) take 0.0894 ms there at one operation per lane and
// clock: twice box_solve's, whose design this kernel keeps (box_solve.cu
// says why each part is as it is):
//   - M is a template parameter (1..8), so every window is an unrolled
//     register array and the weights are constants of the launch;
//   - vertical pass: a block's 128x32 output tile has 128 + 2M columns a
//     channel; a thread takes one (channel, column) at a time, reads the
//     column's 32 + 2M clamped rows straight from global memory (the loads
//     of neighbouring threads coalesce; the halo rows come from L2), forms
//     its 32 weighted vertical sums in registers and stores each to shared
//     memory once;
//   - horizontal pass: a warp takes one row, a lane 4 consecutive outputs,
//     read as float4s (no bank conflict); it forms the 4 weighted sums of all
//     five channels, solves and stores fx and fy as float4s;
//   - 5 x 32 x 144 floats of vertical sums, 90 KB of dynamic shared memory,
//     so two blocks (16 warps) share an SM.

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

struct Window {
  float k[kMaxRadius + 1];  // k[d]: the weight at distance d, d = 0..M
};

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
    gauss_solve_kernel(const float* __restrict__ m, float* __restrict__ fxo,
                       float* __restrict__ fyo, int h, int w, const Window win) {
  constexpr int kCols = kTileX + 2 * R;  // staged columns per channel
  constexpr int kRows = kTileY + 2 * R;  // rows each column reads
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
    // As in box_solve.cu: hiding w and the top row from ptxas keeps the row
    // addresses inside the loop, so the column's loads stay in flight together.
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
      float acc = win.k[0] * v[t + R];
#pragma unroll
      for (int d = 1; d <= R; ++d) acc = acc + win.k[d] * (v[t + R - d] + v[t + R + d]);
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
        float acc = win.k[0] * a[k + R];
#pragma unroll
        for (int d = 1; d <= R; ++d) acc = acc + win.k[d] * (a[k + R - d] + a[k + R + d]);
        s[c][k] = acc;
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
int launch(const float* m, float* fx, float* fy, int b, int h, int w, const Window& win,
           cudaStream_t stream) {
  // The shared-memory limit is a function attribute of each device's
  // context: set it at the first launch on a device (box_solve.cu).
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool known = dev < kMaxDevices;
  if (!known || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(gauss_solve_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (known) ready[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, b);
  gauss_solve_kernel<R><<<grid, kThreads, kSmemBytes, stream>>>(m, fx, fy, h, w, win);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m: [b, 5, h, w]; fx, fy: [b, h, w]; contiguous float32 on the current
// device; 1 <= radius = winsize / 2 <= 8. taps: host memory, radius + 1
// float32 weights, the centre's first. Enqueues on `stream` (nothing for
// b = 0); returns the launch's cudaError_t.
extern "C" int ofc_gauss_solve(const float* m, float* fx, float* fy, int b, int h, int w,
                               int radius, const float* taps, void* stream) {
  if (radius < 1 || radius > kMaxRadius || b < 0 || h < 1 || w < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  Window win{};
  for (int d = 0; d <= radius; ++d) win.k[d] = taps[d];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch<1>(m, fx, fy, b, h, w, win, s);
    case 2: return launch<2>(m, fx, fy, b, h, w, win, s);
    case 3: return launch<3>(m, fx, fy, b, h, w, win, s);
    case 4: return launch<4>(m, fx, fy, b, h, w, win, s);
    case 5: return launch<5>(m, fx, fy, b, h, w, win, s);
    case 6: return launch<6>(m, fx, fy, b, h, w, win, s);
    case 7: return launch<7>(m, fx, fy, b, h, w, win, s);
    default: return launch<8>(m, fx, fy, b, h, w, win, s);
  }
}
