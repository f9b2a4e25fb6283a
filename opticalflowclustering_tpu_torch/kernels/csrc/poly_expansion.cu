// poly_expansion: the quadratic polynomial expansion of one pyramid level.
//
// Replaces no Pallas kernel: the JAX package's stage
// (opticalflowclustering_tpu/flow/farneback.py, `poly_expansion`) is plain
// jnp that XLA fuses. On the card the port's plain version
// (flow/farneback.py, `_poly_expansion_plain`) is 158 eager operators a call
// and two blocking uploads of its edge index vectors; traces of the
// benchmark showed it as the stage that sets the pace of the in-memory
// cells, on the card (40% of its busy time at 720p) and on the driving
// thread (its launches). This kernel is that stage in one launch.
//
// Semantics, per image of [B, H, W] float32, output channel-first
// [B, 5, H, W] (y, x, y^2, x^2, xy), rows and columns beyond the image
// replicating the edge:
//   vertical:   t0 = g[0]*I[y]; t1 = t2 = +0
//               for d = 1..n: t0 = t0 + g[d]*(I[y-d] + I[y+d])
//                             t1 = t1 + xg[d]*(I[y+d] - I[y-d])
//                             t2 = t2 + xxg[d]*(I[y-d] + I[y+d])
//   horizontal: b1 = g[0]*t0[x], b3 = g[0]*t1[x], b5 = g[0]*t2[x];
//               b2 = b4 = b6 = +0; for d = 1..n, with l*, r* the t* at
//               x-d, x+d: b1 += g[d]*(l0+r0), b4 += xxg[d]*(l0+r0),
//               b2 += xg[d]*(r0-l0), b6 += xg[d]*(r1-l1),
//               b3 += g[d]*(l1+r1), b5 += g[d]*(l2+r2)
//   out = b3*ig11, b2*ig11, b5*ig33 + b1*ig03, b4*ig33 + b1*ig03, b6*ig55
// with g[d], xg[d], xxg[d] the float32 taps at n + d of `_poly_exp_consts`.
// That is the plain version's float32 operation order, the +0 starts
// included (a zeros_like plus a -0 is +0); the build uses --fmad=false, so
// the kernel equals the plain version bit for bit, signed zeros included.
//
// What bounds it on the card: memory. It must read the image once (4 bytes
// a pixel) and write the 5 planes (20 bytes): 24 bytes a pixel, 0.1056 ms
// for one level-0 call at [16, 720, 1280] and 3.35 TB/s. Its 25n + 11
// float32 operations a pixel (136 at n = 5) take 0.060 ms there at one
// operation per lane and clock, so the arithmetic has to hide under the
// writes. The design:
//   - one block per 128 x 16 output tile of one image;
//   - vertical pass: each of the tile's columns and its 2n halo columns is
//     one thread's; it loads the column's 16 + 2n rows, clamped to the image
//     (the replicate border), from global memory into registers
//     (neighbouring threads on neighbouring columns, so the loads coalesce,
//     and the halo rows of the tiles above and below come from L1 and L2),
//     forms t0, t1, t2 of the 16 rows and stores each to shared memory once;
//   - horizontal pass: a warp takes one row, each lane 4 consecutive
//     outputs; it reads the 4 + 2n values of t0, t1, t2 it needs as 16-byte
//     loads (no bank conflict), forms the 5 outputs of its 4 pixels in
//     registers and stores each plane as one float4 (a warp writes 512
//     contiguous bytes a plane, whole lines);
//   - n is a template parameter (1..8, OpenCV's poly_n 5 and 7 inside), so
//     every window is an unrolled register array and the taps are
//     constants of the launch;
//   - 3 x 16 rows of t take 26.9 KB of static shared memory at n = 5
//     (27.6 KB at n = 8) and the kernel 64 registers, so four blocks
//     (32 warps) share an SM.
// A first design staged the tile and its halo in shared memory and ran the
// vertical pass from there (83 KB a block at n = 8, two blocks an SM): 57%
// of the bound at level 0 against this design's 81% (PERF.md, section 6).
// The halo columns are summed again by the neighbouring tile (2n / 128, 8%
// at n = 5).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxN = 8;
constexpr int kTileX = 128;  // output columns of a block
constexpr int kTileY = 16;   // output rows of a block
constexpr int kStrip = 4;    // consecutive outputs of a row per lane
constexpr int kThreads = 256;

static_assert(kStrip == 4 && kTileX == 32 * kStrip, "a warp covers a row as float4s");
static_assert(kTileX + 2 * kMaxN <= kThreads, "a thread per column of the vertical pass");

struct Taps {
  float g[kMaxN + 1];    // g[n + d], d = 0..n
  float xg[kMaxN + 1];   // xg[n + d]
  float xxg[kMaxN + 1];  // xxg[n + d]
  float ig11, ig03, ig33, ig55;
};

template <int N>
struct Geometry {
  static constexpr int kCols = kTileX + 2 * N;  // columns of the vertical pass
  static constexpr int kRows = kTileY + 2 * N;  // rows each of them reads
  static constexpr int kVec = (kStrip + 2 * N + 3) / 4;  // float4 loads per lane and array
  // Floats per shared row: a lane's last float4 ends inside the row.
  static constexpr int kPitch = kStrip * 31 + 4 * kVec;
  static_assert(kPitch >= kCols && kPitch % 4 == 0, "rows hold the halo, 16-byte aligned");
};

template <int N>
__global__ void __launch_bounds__(kThreads, 4)
    poly_expansion_kernel(const float* __restrict__ img, float* __restrict__ out, int h,
                          int w, const Taps taps) {
  using G = Geometry<N>;
  __shared__ __align__(16) float vsum[3 * kTileY * G::kPitch];  // t0, t1, t2: [3][kTileY][kPitch]

  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t b = blockIdx.z;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;

  // Vertical pass: thread c takes column c of the pass, frame column
  // x0 - N + c, and its rows y0 - N .. y0 + kTileY - 1 + N, both clamped.
  if (threadIdx.x < G::kCols) {
    const int c = threadIdx.x;
    const float* col = img + b * plane + min(max(x0 - N + c, 0), w - 1);
    // As in box_solve.cu: hiding w and the top row from ptxas keeps the row
    // addresses inside, so the column's loads stay in flight together.
    int wv = w, top = y0 - N;
    asm volatile("" : "+r"(wv), "+r"(top));
    float v[G::kRows];
#pragma unroll
    for (int j = 0; j < G::kRows; ++j)
      v[j] = __ldg(col + static_cast<int64_t>(min(max(top + j, 0), h - 1)) * wv);
    float* dst = vsum + c;
#pragma unroll
    for (int i = 0; i < kTileY; ++i) {
      float t0 = taps.g[0] * v[i + N];
      float t1 = 0.0f;
      float t2 = 0.0f;
#pragma unroll
      for (int d = 1; d <= N; ++d) {
        const float up = v[i + N - d], down = v[i + N + d];
        t0 = t0 + taps.g[d] * (up + down);
        t1 = t1 + taps.xg[d] * (down - up);
        t2 = t2 + taps.xxg[d] * (up + down);
      }
      dst[i * G::kPitch] = t0;
      dst[(kTileY + i) * G::kPitch] = t1;
      dst[(2 * kTileY + i) * G::kPitch] = t2;
    }
  }
  __syncthreads();

  // Horizontal pass: warp t % 8 takes row t, lane l the outputs
  // x0 + 4l .. x0 + 4l + 3, whose windows are columns 4l .. 4l + 3 + 2N of
  // the vertical pass.
  const int lane = threadIdx.x & 31;
  const int x = x0 + kStrip * lane;
  if (x >= w) return;
  const bool vec = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  float* dst = out + b * 5 * plane + x;
  for (int t = threadIdx.x >> 5; t < kTileY; t += kThreads / 32) {
    const int y = y0 + t;
    if (y >= h) break;
    float a[3][4 * G::kVec];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const float4* row =
          reinterpret_cast<const float4*>(vsum + (p * kTileY + t) * G::kPitch) + lane;
#pragma unroll
      for (int q = 0; q < G::kVec; ++q) {
        const float4 f = row[q];
        a[p][4 * q] = f.x;
        a[p][4 * q + 1] = f.y;
        a[p][4 * q + 2] = f.z;
        a[p][4 * q + 3] = f.w;
      }
    }
    float o[5][kStrip];
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      // a[p][k + N] is the centre of output k's window.
      float b1 = taps.g[0] * a[0][k + N];
      float b3 = taps.g[0] * a[1][k + N];
      float b5 = taps.g[0] * a[2][k + N];
      float b2 = 0.0f, b4 = 0.0f, b6 = 0.0f;
#pragma unroll
      for (int d = 1; d <= N; ++d) {
        const float l0 = a[0][k + N - d], r0 = a[0][k + N + d];
        const float l1 = a[1][k + N - d], r1 = a[1][k + N + d];
        const float l2 = a[2][k + N - d], r2 = a[2][k + N + d];
        b1 = b1 + taps.g[d] * (l0 + r0);
        b4 = b4 + taps.xxg[d] * (l0 + r0);
        b2 = b2 + taps.xg[d] * (r0 - l0);
        b6 = b6 + taps.xg[d] * (r1 - l1);
        b3 = b3 + taps.g[d] * (l1 + r1);
        b5 = b5 + taps.g[d] * (l2 + r2);
      }
      o[0][k] = b3 * taps.ig11;
      o[1][k] = b2 * taps.ig11;
      o[2][k] = b5 * taps.ig33 + b1 * taps.ig03;
      o[3][k] = b4 * taps.ig33 + b1 * taps.ig03;
      o[4][k] = b6 * taps.ig55;
    }
    const int64_t pix = static_cast<int64_t>(y) * w;
    if (vec && x + kStrip <= w) {
#pragma unroll
      for (int p = 0; p < 5; ++p)
        *reinterpret_cast<float4*>(dst + p * plane + pix) =
            make_float4(o[p][0], o[p][1], o[p][2], o[p][3]);
    } else {
#pragma unroll
      for (int k = 0; k < kStrip; ++k) {
        if (x + k < w) {
#pragma unroll
          for (int p = 0; p < 5; ++p) dst[p * plane + pix + k] = o[p][k];
        }
      }
    }
  }
}

template <int N>
int launch(const float* img, float* out, int b, int h, int w, const Taps& taps,
           cudaStream_t stream) {
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, b);
  poly_expansion_kernel<N><<<grid, kThreads, 0, stream>>>(img, out, h, w, taps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img: [b, h, w]; out: [b, 5, h, w]; contiguous float32 on the current
// device; 1 <= n <= 8. taps: host memory, 3 (n + 1) + 4 floats: g, xg and
// xxg at n .. 2n of `_poly_exp_consts`, then ig11, ig03, ig33, ig55 as
// float32. Enqueues on `stream` (nothing for b = 0); returns the launch's
// cudaError_t.
extern "C" int ofc_poly_expansion(const float* img, float* out, int b, int h, int w, int n,
                                  const float* taps, void* stream) {
  if (n < 1 || n > kMaxN || b < 0 || h < 1 || w < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  Taps t{};
  for (int d = 0; d <= n; ++d) {
    t.g[d] = taps[d];
    t.xg[d] = taps[n + 1 + d];
    t.xxg[d] = taps[2 * (n + 1) + d];
  }
  t.ig11 = taps[3 * (n + 1)];
  t.ig03 = taps[3 * (n + 1) + 1];
  t.ig33 = taps[3 * (n + 1) + 2];
  t.ig55 = taps[3 * (n + 1) + 3];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch<1>(img, out, b, h, w, t, s);
    case 2: return launch<2>(img, out, b, h, w, t, s);
    case 3: return launch<3>(img, out, b, h, w, t, s);
    case 4: return launch<4>(img, out, b, h, w, t, s);
    case 5: return launch<5>(img, out, b, h, w, t, s);
    case 6: return launch<6>(img, out, b, h, w, t, s);
    case 7: return launch<7>(img, out, b, h, w, t, s);
    default: return launch<8>(img, out, b, h, w, t, s);
  }
}
