// warp_m: exact bilinear warp of R1 by the flow, fused with the M build.
//
// Replaces the Pallas TPU kernel `_warp_m_kernel`
// (opticalflowclustering_tpu/kernels/warp.py:177, entry `fused_m_planes` :581).
// Its semantics are the reference's `update_matrices_gather` (:713): per
// output pixel (b, y, x)
//   gx = x + dx, gy = y + dy; x1 = floor(gx), y1 = floor(gy)
//   R1 sampled bilinearly at the corners clamped to [0, w-2] x [0, h-2]
//   in-bounds = x1, y1 inside the image and |y1-y| <= 119, |x1-x| <= 127
//   M = _m_build(R0, R1w, dx, dy, in-bounds, border taper)
// in the reference's float32 operation order. Built with --fmad=false so no
// multiply-add is contracted and the result equals the plain PyTorch
// version bit for bit.
//
// What bounds it on the card: memory. Per pixel it reads 2 flow values,
// 5 of R0 and 4 corners x 5 channels of R1 (cached: neighbouring threads
// share corners, so each R1 value comes from memory about once) and writes
// 5 of M: 68 bytes of compulsory traffic (8 + 20 + 20 + 20) for ~100 float32
// operations. The TPU kernel's windowed DMA, candidate-row loop and
// 128-lane padding existed because the TPU has no fast per-element gather;
// here each thread gathers its own corners through the read-only cache
// (__ldg), and consecutive threads take consecutive pixels so the flow,
// R0 and M accesses coalesce.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kReachY = 119;
constexpr int kReachX = 127;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// OpenCV's 5-px border taper ramp at integer position `pos` of `size`,
// multiplied in the order of the reference's `_border_taper` table.
__device__ __forceinline__ float taper_ramp(int pos, int size) {
  const float scale[5] = {0.14f, 0.14f, 0.4472f, 0.4472f, 0.4472f};
  float r = 1.0f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (pos == i) r = r * scale[i];
    if (size - 1 - pos == i) r = r * scale[i];
  }
  return r;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
    warp_m_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                  const float* __restrict__ fxp, const float* __restrict__ fyp,
                  float* __restrict__ m, int h, int w) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t b = blockIdx.z;
  const int64_t pix = static_cast<int64_t>(y) * w + x;

  const float dx = fxp[b * plane + pix];
  const float dy = fyp[b * plane + pix];
  const float gx = static_cast<float>(x) + dx;
  const float gy = static_cast<float>(y) + dy;
  const float x1 = floorf(gx);
  const float y1 = floorf(gy);
  const float fx = gx - x1;
  const float fy = gy - y1;
  const int x1i = static_cast<int>(x1);
  const int y1i = static_cast<int>(y1);
  const bool inb = x1i >= 0 && x1i <= w - 2 && y1i >= 0 && y1i <= h - 2 &&
                   abs(y1i - y) <= kReachY && abs(x1i - x) <= kReachX;
  const int x1c = min(max(x1i, 0), w - 2);
  const int y1c = min(max(y1i, 0), h - 2);

  // Bilinear sample of the 5 planes: p00*(1-fx)*(1-fy) + p01*fx*(1-fy)
  // + p10*(1-fx)*fy + p11*fx*fy, left to right, as `_warp_gather`.
  const float wx0 = 1.0f - fx;
  const float wy0 = 1.0f - fy;
  const float* r1b = r1 + b * 5 * plane;
  const int64_t i00 = static_cast<int64_t>(y1c) * w + x1c;
  float rw[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* p = r1b + c * plane + i00;
    const float p00 = __ldg(p);
    const float p01 = __ldg(p + 1);
    const float p10 = __ldg(p + w);
    const float p11 = __ldg(p + w + 1);
    rw[c] = p00 * wx0 * wy0 + p01 * fx * wy0 + p10 * wx0 * fy + p11 * fx * fy;
  }

  const float* r0b = r0 + b * 5 * plane + pix;
  const float a0 = r0b[0];
  const float a1 = r0b[plane];
  const float a2 = r0b[2 * plane];
  const float a3 = r0b[3 * plane];
  const float a4 = r0b[4 * plane];

  // _m_build (reference flow/farneback.py:299-329), op for op.
  float r4 = inb ? (a2 + rw[2]) * 0.5f : a2;
  float r5 = inb ? (a3 + rw[3]) * 0.5f : a3;
  float r6 = inb ? (a4 + rw[4]) * 0.25f : a4 * 0.5f;
  float r2 = (a0 - (inb ? rw[0] : 0.0f)) * 0.5f;
  float r3 = (a1 - (inb ? rw[1] : 0.0f)) * 0.5f;
  r2 = r2 + r4 * dy + r6 * dx;
  r3 = r3 + r6 * dy + r5 * dx;

  const float taper = taper_ramp(y, h) * taper_ramp(x, w);
  r2 = r2 * taper;
  r3 = r3 * taper;
  r4 = r4 * taper;
  r5 = r5 * taper;
  r6 = r6 * taper;

  float* mb = m + b * 5 * plane + pix;
  mb[0] = r4 * r4 + r6 * r6;
  mb[plane] = (r4 + r5) * r6;
  mb[2 * plane] = r5 * r5 + r6 * r6;
  mb[3 * plane] = r4 * r2 + r6 * r3;
  mb[4 * plane] = r6 * r2 + r5 * r3;
}

}  // namespace

// r0, r1, m: [b, 5, h, w]; fx, fy: [b, h, w]; contiguous float32 on the
// current device. Enqueues on `stream`; returns the launch's cudaError_t.
extern "C" int ofc_warp_m(const float* r0, const float* r1, const float* fx,
                          const float* fy, float* m, int b, int h, int w,
                          void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, b);
  warp_m_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      r0, r1, fx, fy, m, h, w);
  return static_cast<int>(cudaGetLastError());
}
