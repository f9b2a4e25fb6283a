// box_solve: winsize x winsize box sum of M and the regularized 2x2 solve.
//
// Replaces the Pallas TPU kernel `_solve_kernel`
// (opticalflowclustering_tpu/kernels/warp.py:338, entry `fused_solve` :655),
// whose semantics are the reference's `_update_flow(m, winsize,
// gaussian=False)` (flow/farneback.py:402): per pixel
//   s   = box_sum(M, winsize, replicate border) * (1/winsize^2)
//   idet = 1 / (G11*G22 - G12*G12 + 1e-3)
//   fx  = (G11*h2 - G12*h1) * idet,   fy = (G22*h1 - G12*h2) * idet
// Both passes of the box sum run in the symmetric-pair order of
// `ops.filters.box_sum`: acc = c; for d in 1..r: acc += (a[-d] + a[+d]).
// Built with --fmad=false, so it equals the plain PyTorch version bit for
// bit.
//
// What bounds it on the card: memory. It reads 5 planes of M once and
// writes 2 flow planes (28 bytes per pixel) for ~(2r+1)*10 adds. A block
// stages its 32x16 output tile plus an r-pixel halo (r <= 8) of all five
// channels in shared memory (30 KB at r = 8), clamping coordinates at the
// frame edge, which is the replicate border. The vertical pass writes a
// second 15 KB buffer; the horizontal pass and the solve then run from
// shared memory. The TPU kernel's windowed DMA with a 128-lane halo and its
// interior/border split are gone: the clamped load handles every tile.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 16;
constexpr int kMaxRadius = 8;  // winsize <= 17
constexpr int kStageX = kTileX + 2 * kMaxRadius;
constexpr int kStageY = kTileY + 2 * kMaxRadius;
constexpr int kThreads = kTileX * kTileY;

__global__ void __launch_bounds__(kThreads)
    box_solve_kernel(const float* __restrict__ m, float* __restrict__ fxo,
                     float* __restrict__ fyo, int h, int w, int r,
                     float inv_area) {
  __shared__ float stage[5][kStageY][kStageX];
  __shared__ float vsum[5][kTileY][kStageX];

  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t b = blockIdx.z;
  const float* mb = m + b * 5 * plane;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int sw = kTileX + 2 * r;
  const int sh = kTileY + 2 * r;

  // Stage rows y0-r .. y0+15+r and columns x0-r .. x0+31+r, clamped.
  for (int e = tid; e < sh * sw; e += kThreads) {
    const int j = e / sw;
    const int i = e - j * sw;
    const int gy = min(max(y0 - r + j, 0), h - 1);
    const int gx = min(max(x0 - r + i, 0), w - 1);
    const int64_t off = static_cast<int64_t>(gy) * w + gx;
#pragma unroll
    for (int c = 0; c < 5; ++c) stage[c][j][i] = mb[c * plane + off];
  }
  __syncthreads();

  // Vertical pass for the tile's rows, over every staged column.
  for (int e = tid; e < kTileY * sw; e += kThreads) {
    const int t = e / sw;
    const int i = e - t * sw;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      float acc = stage[c][t + r][i];
      for (int d = 1; d <= r; ++d)
        acc = acc + (stage[c][t + r - d][i] + stage[c][t + r + d][i]);
      vsum[c][t][i] = acc;
    }
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int x = x0 + tx;
  const int y = y0 + ty;
  if (x >= w || y >= h) return;

  float s[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    float acc = vsum[c][ty][tx + r];
    for (int d = 1; d <= r; ++d)
      acc = acc + (vsum[c][ty][tx + r - d] + vsum[c][ty][tx + r + d]);
    s[c] = acc * inv_area;
  }
  const float g11 = s[0], g12 = s[1], g22 = s[2], h1 = s[3], h2 = s[4];
  const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
  const int64_t pix = b * plane + static_cast<int64_t>(y) * w + x;
  fxo[pix] = (g11 * h2 - g12 * h1) * idet;
  fyo[pix] = (g22 * h1 - g12 * h2) * idet;
}

}  // namespace

// m: [b, 5, h, w]; fx, fy: [b, h, w]; contiguous float32 on the current
// device. radius = winsize / 2 <= 8; inv_area = float32(1 / winsize^2).
// Enqueues on `stream`; returns the launch's cudaError_t.
extern "C" int ofc_box_solve(const float* m, float* fx, float* fy, int b, int h,
                             int w, int radius, float inv_area, void* stream) {
  if (radius < 0 || radius > kMaxRadius) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, b);
  box_solve_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      m, fx, fy, h, w, radius, inv_area);
  return static_cast<int>(cudaGetLastError());
}
