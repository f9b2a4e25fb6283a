// pyramid: the blur and downsample of one Farneback pyramid level.
//
// Replaces no Pallas kernel: the JAX package builds each level with plain
// jnp (opticalflowclustering_tpu/flow/farneback.py: `gaussian_blur` of the
// full frame, then `resize_linear`) and leaves it to XLA. On the card the
// port's plain version (ops/filters.py `sep_filter_axis`, ops/resize.py) is
// one full-frame float32 operator per tap pair and axis, 10 to 124 of them
// a level and image, and each axis starts with a pageable upload of its
// border index, which synchronises the stream. Traces of the benchmark
// showed it as the largest stage on the card at 720p. This kernel is that
// stage in one launch a level and image.
//
// Semantics, per image of [B, H, W] float32 to [B, Ho, Wo] with integer
// factors sy = H / Ho, sx = W / Wo, a radius r < min(H, W) and the float32
// weights w[0..r] of `ops.filters.gaussian_kernel` (w[k] at distance k):
//   vertical:   V[y][x] = w[0]*I[y][x]; for k = 1..r:
//               V = V + w[k]*(I[y-k][x] + I[y+k][x])
//   horizontal: H[y][x] = w[0]*V[y][x]; for k = 1..r:
//               H = H + w[k]*(V[y][x-k] + V[y][x+k])
//   rows, then columns, of the downsample: for an even factor s, output j
//   reads a = s*j + s/2 - 1 and b = a + 1 as 0.5*a + 0.5*b; for an odd one
//   the single tap s*j + (s - 1)/2 (at s = 1, the value itself);
// rows and columns beyond the image reflect101 (numpy's `reflect`). That
// is the plain version's float32 operation order, `sep_filter_axis`'s
// symmetric-pair sums included; the build uses --fmad=false, so the kernel
// equals the plain version bit for bit.
//
// What bounds it on the card: memory. It must read the frames once and
// write the level once: 4 (H W + Ho Wo) bytes an image, 0.1876 ms for a
// 720p chunk's 8 launches (16 frames, 4 levels, two images) at 3.35 TB/s.
// Only the blurred rows and columns that the downsample reads are needed
// (2 rows and 2 columns in s), so the arithmetic is small beside the
// bytes; the plain version's blurred frame never reaches device memory.
// The design:
//   - one block per output tile of one image: txo = 128 / sx columns and
//     about 32 / sy rows (spread evenly over the level), so a block reads
//     128 input columns and about 32 rows, and their r-wide halos;
//   - staging: the block copies the input columns and rows its sums read
//     into shared memory with cp.async (16-byte copies where a quad lies
//     inside an aligned row, else 4-byte copies from the reflected column),
//     every copy of the block in flight at once and none through L1; the
//     halo rows and columns of the tiles around come again from L2;
//   - vertical pass: a thread takes one input column of one output row, the
//     lanes of a warp neighbouring columns; for an even sy it forms both
//     rows a and a + 1 from one walk over the taps, each read serving the
//     two sums, at only the rows the downsample reads; the sums go to
//     shared memory phase-major (column c at (c mod sx) * p + c / sx);
//   - horizontal pass: a thread takes one output pixel; in the phase-major
//     rows the lanes of a warp, on neighbouring outputs, read neighbouring
//     words at every tap (no bank conflict at any sx), and the tile's rows
//     are padded apart so the rows one warp covers fall on other banks; it
//     forms the (up to) 2 x 2 sums the downsample reads and combines them
//     in registers;
//   - the radius is a runtime loop bound and the taps are a __grid_constant__
//     launch parameter (no copy to the card); the downsample's two shapes,
//     one or two taps an axis, are the four instantiations.
// Measured on the card (PERF.md, section 6): 36-45% of the bound at each
// 720p level, where a plain copy of the frames reaches 83%. Variants kept
// each thread's loads in registers (in batches of 1 to 8 taps, 48 to 125
// registers) or widened the tile to 256 and 512 columns or 16 and 64 rows:
// none passed 45% at any level.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRadius = 39;  // ksize 79: pyr_scale 0.5 through level 5
constexpr int kThreads = 256;
constexpr int kSpan = 128;      // input columns of a block's output tile
constexpr int kRowsIn = 32;     // input rows of a block's output tile (sy * its rows)

struct Taps {
  float w[kMaxRadius + 1];  // w[k]: the weight at distance k
};

struct Geometry {
  int h, w, ho, wo;
  int sy, sx;                // integer factors
  int oy, ox;                // the downsample's first row / column within a factor
  int r;                     // radius
  int txo, tyo;              // output columns and rows of a block
  int cpitch;                // floats of a staged input row
  int in_floats;             // floats of the staged input rows
  int kh;                    // a block's shared column 0 is input column sx * (i0 - kh)
  int p;                     // entries of one phase in a row of vertical sums
  int pitch;                 // floats of a row of vertical sums
  unsigned long long magic;  // ceil(2^32 / sx): d / sx = (d * magic) >> 32 for small d
  int vec;                   // rows are 16-byte aligned: 16-byte copies
};

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * n - 2 - i : i;
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// The horizontal sums of one row of vertical sums at the output's first
// column (a) and, for NX = 2, the next (b). `row` points at the output's
// entry: the vertical sum at input column sx * (i0 + ii) + u - sx * kh lies
// at row[(u mod sx) * p + u / sx]; u starts at sx * kh + ox and steps by one.
template <int NX>
__device__ __forceinline__ void horizontal(const float* row, const Geometry& g, const Taps& t,
                                           float& a, float& b) {
  const int sx = g.sx, p = g.p;
  int phl = g.ox, offl = g.ox * p + g.kh;
  int phr = g.ox + NX - 1, offr = phr * p + g.kh;
  const float w0 = t.w[0];
  const float ca = row[offl];
  a = w0 * ca;
  float pl = ca, ph = ca;
  if (NX == 2) {
    ph = row[offr];
    b = w0 * ph;
  }
#pragma unroll 4
  for (int k = 1; k <= g.r; ++k) {
    if (phl == 0) {
      phl = sx - 1;
      offl += (sx - 1) * p - 1;
    } else {
      --phl;
      offl -= p;
    }
    if (phr == sx - 1) {
      phr = 0;
      offr -= (sx - 1) * p - 1;
    } else {
      ++phr;
      offr += p;
    }
    const float lo = row[offl], hi = row[offr];
    const float wk = t.w[k];
    if (NX == 2) {
      a = a + wk * (lo + ph);
      b = b + wk * (pl + hi);
      pl = lo;
      ph = hi;
    } else {
      a = a + wk * (lo + hi);
    }
  }
}

template <int NY, int NX>
__global__ void __launch_bounds__(kThreads)
    pyramid_kernel(const float* __restrict__ img, float* __restrict__ out,
                   const __grid_constant__ Geometry g, const __grid_constant__ Taps t) {
  // The input rows the block reads, [rows][cpitch], then its vertical sums,
  // [tyo * NY][pitch], phase-major.
  extern __shared__ __align__(16) float smem[];
  float* const in_s = smem;
  float* const vs = smem + g.in_floats;

  const int64_t b = blockIdx.z;
  const int i0 = blockIdx.x * g.txo;
  const int j0 = blockIdx.y * g.tyo;
  const int nxo = min(g.txo, g.wo - i0);
  const int nyo = min(g.tyo, g.ho - j0);
  const float* src = img + b * g.h * g.w;

  // Stage the input columns [c_lo, c_hi) that the block's horizontal sums
  // read (from c_lo rounded down to 4) at the rows its vertical sums read
  // (from y0), each row and column beyond the image at its reflection: all
  // of the block's copies in flight at once, past L1.
  const int c_lo = g.sx * i0 + g.ox - g.r;
  const int c_hi = g.sx * (i0 + nxo - 1) + g.ox + NX + g.r;
  const int q0 = c_lo & ~3;
  const int nq = (c_hi - q0 + 3) >> 2;
  const int y0 = g.sy * j0 + g.oy - g.r;
  const int rows = g.sy * (nyo - 1) + NY + 2 * g.r;
  {
    const int step_i = kThreads / nq, step_q = kThreads - step_i * nq;
    int i = threadIdx.x / nq, q = threadIdx.x - i * nq;
    for (; i < rows; i += step_i, q += step_q) {
      for (; q >= nq; q -= nq) ++i;
      if (i >= rows) break;
      const float* row = src + static_cast<int64_t>(reflect101(y0 + i, g.h)) * g.w;
      float* dst = in_s + i * g.cpitch + 4 * q;
      const int c0 = q0 + 4 * q;
      if (g.vec && c0 >= 0 && c0 + 4 <= g.w) {
        copy16(dst, row + c0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) copy4(dst + e, row + min(max(reflect101(c0 + e, g.w), 0), g.w - 1));
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // Vertical pass: item (jj, m) is output row jj's rows a = sy * (j0 + jj)
  // + oy and, for NY = 2, b = a + 1, at input column c_lo + m. For NY = 2
  // each tap reads rows a - k and b + k and takes the other two from the tap
  // before (row a + k is b + k - 1, row b - k is a - k + 1).
  const int ncol = c_hi - c_lo;
  const int base = g.sx * (i0 - g.kh);
  {
    const int step_j = kThreads / ncol, step_m = kThreads - step_j * ncol;
    int jj = threadIdx.x / ncol, m = threadIdx.x - jj * ncol;
    for (; jj < nyo; jj += step_j, m += step_m) {
      for (; m >= ncol; m -= ncol) ++jj;
      if (jj >= nyo) break;
      const int cp = g.cpitch;
      const float* col = in_s + (g.sy * jj + g.r) * cp + (c_lo - q0) + m;
      const float w0 = t.w[0];
      const float ca = col[0];
      float va = w0 * ca, vb = 0.0f;
      if (NY == 2) {
        const float cb = col[cp];
        vb = w0 * cb;
        float pl = ca, ph = cb;
#pragma unroll 4
        for (int k = 1; k <= g.r; ++k) {
          const float lo = col[-k * cp], hi = col[(k + 1) * cp];
          const float wk = t.w[k];
          va = va + wk * (lo + ph);
          vb = vb + wk * (pl + hi);
          pl = lo;
          ph = hi;
        }
      } else {
#pragma unroll 4
        for (int k = 1; k <= g.r; ++k) {
          const float lo = col[-k * cp], hi = col[k * cp];
          va = va + t.w[k] * (lo + hi);
        }
      }
      const unsigned d = static_cast<unsigned>(c_lo + m - base);
      const unsigned dv = static_cast<unsigned>((d * g.magic) >> 32);
      float* at = vs + jj * NY * g.pitch + (d - dv * g.sx) * g.p + dv;
      at[0] = va;
      if (NY == 2) at[g.pitch] = vb;
    }
  }
  __syncthreads();

  // Horizontal pass and the downsample: one output pixel a thread, the
  // block's outputs row by row, a thread's kThreads apart.
  float* dst = out + (b * g.ho + j0) * g.wo + i0;
  const int step_j = kThreads / nxo, step_i = kThreads - step_j * nxo;
  int oj = threadIdx.x / nxo, oi = threadIdx.x - oj * nxo;
  for (; oj < nyo; oj += step_j, oi += step_i) {
    for (; oi >= nxo; oi -= nxo) ++oj;
    if (oj >= nyo) break;
    float ha[NY], hb[NY];
#pragma unroll
    for (int q = 0; q < NY; ++q)
      horizontal<NX>(vs + (oj * NY + q) * g.pitch + oi, g, t, ha[q], hb[q]);
    const float ra = NY == 2 ? 0.5f * ha[0] + 0.5f * ha[NY - 1] : ha[0];
    float v = ra;
    if (NX == 2) {
      const float rb = NY == 2 ? 0.5f * hb[0] + 0.5f * hb[NY - 1] : hb[0];
      v = 0.5f * ra + 0.5f * rb;
    }
    dst[oj * g.wo + oi] = v;
  }
}

template <int NY, int NX>
int launch(const float* img, float* out, int b, const Geometry& g, const Taps& t,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (g.in_floats + g.tyo * NY * g.pitch);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pyramid_kernel<NY, NX>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((g.wo + g.txo - 1) / g.txo, (g.ho + g.tyo - 1) / g.tyo, b);
  pyramid_kernel<NY, NX><<<grid, kThreads, smem, stream>>>(img, out, g, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img: [b, h, w]; out: [b, ho, wo]; contiguous float32 on the current
// device; h % ho == 0, w % wo == 0, 0 <= radius <= 39, radius < h and < w.
// taps: host memory, radius + 1 floats, the weight at distance 0 .. radius.
// Enqueues on `stream` (nothing for b = 0); returns the launch's
// cudaError_t.
extern "C" int ofc_pyramid_level(const float* img, float* out, int b, int h, int w, int ho,
                                 int wo, int radius, const float* taps, void* stream) {
  if (b < 0 || b > 65535 || h < 1 || w < 1 || ho < 1 || wo < 1 || ho > h || wo > w ||
      h % ho != 0 || w % wo != 0 || radius < 0 || radius > kMaxRadius || radius >= h ||
      radius >= w)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  Taps t{};
  for (int k = 0; k <= radius; ++k) t.w[k] = taps[k];
  Geometry g{};
  g.h = h;
  g.w = w;
  g.ho = ho;
  g.wo = wo;
  g.sy = h / ho;
  g.sx = w / wo;
  g.oy = g.sy % 2 == 0 ? g.sy / 2 - 1 : (g.sy - 1) / 2;
  g.ox = g.sx % 2 == 0 ? g.sx / 2 - 1 : (g.sx - 1) / 2;
  g.r = radius;
  const int ny = g.sy % 2 == 0 ? 2 : 1, nx = g.sx % 2 == 0 ? 2 : 1;
  g.txo = kSpan / g.sx > 1 ? kSpan / g.sx : 1;
  if (g.txo > wo) g.txo = wo;
  // kRowsIn input rows a block, its output rows spread evenly over the level.
  const int rows = kRowsIn / g.sy > 1 ? kRowsIn / g.sy : 1;
  const int row_blocks = (ho + rows - 1) / rows;
  g.tyo = (ho + row_blocks - 1) / row_blocks;
  // The staged rows of a full tile, and its quads at the worst alignment.
  g.cpitch = 4 * ((g.sx * (g.txo - 1) + nx + 2 * radius + 3 + 3) / 4);
  g.in_floats = (g.sy * (g.tyo - 1) + ny + 2 * radius) * g.cpitch;
  g.kh = radius > g.ox ? (radius - g.ox + g.sx - 1) / g.sx : 0;
  g.p = g.txo + g.kh + (g.ox + nx - 1 + radius) / g.sx;
  // Rows a warp's horizontal pass spans start txo banks apart.
  g.pitch = g.sx * g.p;
  if (g.txo < 32) {
    for (int pad = 0; pad < 32; ++pad) {
      if ((ny * (g.pitch + pad)) % 32 == g.txo) {
        g.pitch += pad;
        break;
      }
    }
  }
  g.magic = ((1ull << 32) + g.sx - 1) / g.sx;
  g.vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ny == 2) return nx == 2 ? launch<2, 2>(img, out, b, g, t, s) : launch<2, 1>(img, out, b, g, t, s);
  return nx == 2 ? launch<1, 2>(img, out, b, g, t, s) : launch<1, 1>(img, out, b, g, t, s);
}
