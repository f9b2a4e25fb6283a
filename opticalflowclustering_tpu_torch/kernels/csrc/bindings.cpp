// PyTorch bindings of the warp_m, box_solve, gauss_solve, poly_expansion,
// pyramid_level, loop_probe and dynslice kernels.
//
// The kernels' sources include no PyTorch header; each exposes a plain C
// launcher. This file takes tensors, checks them, launches on PyTorch's
// current stream of the tensors' device and raises if the launch failed.
// Outputs are allocated by the Python wrappers (kernels/warp.py,
// kernels/poly.py, kernels/pyramid.py, kernels/probes.py).

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/extension.h>

extern "C" int ofc_warp_m(const float* r0, const float* r1, const float* fx,
                          const float* fy, float* m, int b, int h, int w,
                          void* stream);
extern "C" int ofc_box_solve(const float* m, float* fx, float* fy, int b, int h,
                             int w, int radius, float inv_area, void* stream);
extern "C" int ofc_gauss_solve(const float* m, float* fx, float* fy, int b, int h,
                               int w, int radius, const float* taps, void* stream);
extern "C" int ofc_poly_expansion(const float* img, float* out, int b, int h,
                                  int w, int n, const float* taps, void* stream);
extern "C" int ofc_pyramid_level(const float* img, float* out, int b, int h,
                                 int w, int ho, int wo, int radius,
                                 const float* taps, void* stream);
extern "C" int ofc_loop_probe(int body, const void* x, const int* idx,
                              float* out, int rows, int n, void* stream);
extern "C" int ofc_dynslice(const void* x, const int* off, float* out,
                            void* stream);

namespace {

void check(const torch::Tensor& t, const char* name, int64_t dim,
           torch::ScalarType dtype = torch::kFloat32) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dtype, name, " must be ", dtype);
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.dim() == dim, name, " must have ", dim, " dims");
}

void raise_on(int err, const char* what) {
  TORCH_CHECK(err == cudaSuccess, what, " launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

void warp_m(const torch::Tensor& r0, const torch::Tensor& r1,
            const torch::Tensor& fx, const torch::Tensor& fy, torch::Tensor m) {
  check(r0, "r0", 4);
  check(r1, "r1", 4);
  check(fx, "fx", 3);
  check(fy, "fy", 3);
  check(m, "m", 4);
  const int64_t b = r0.size(0), h = r0.size(2), w = r0.size(3);
  TORCH_CHECK(r0.size(1) == 5 && r1.sizes() == r0.sizes() && m.sizes() == r0.sizes(),
              "r0, r1 and m must be [B, 5, H, W] of one shape");
  TORCH_CHECK(fx.size(0) == b && fx.size(1) == h && fx.size(2) == w &&
                  fy.sizes() == fx.sizes(),
              "fx and fy must be [B, H, W]");
  TORCH_CHECK(h >= 2 && w >= 2, "warp_m needs H, W >= 2");
  const c10::cuda::CUDAGuard guard(r0.device());
  void* stream = c10::cuda::getCurrentCUDAStream(r0.get_device()).stream();
  raise_on(ofc_warp_m(r0.data_ptr<float>(), r1.data_ptr<float>(),
                      fx.data_ptr<float>(), fy.data_ptr<float>(),
                      m.data_ptr<float>(), static_cast<int>(b),
                      static_cast<int>(h), static_cast<int>(w), stream),
           "warp_m");
}

void box_solve(const torch::Tensor& m, torch::Tensor fx, torch::Tensor fy,
               int64_t radius, double inv_area) {
  check(m, "m", 4);
  check(fx, "fx", 3);
  check(fy, "fy", 3);
  const int64_t b = m.size(0), h = m.size(2), w = m.size(3);
  TORCH_CHECK(m.size(1) == 5, "m must be [B, 5, H, W]");
  TORCH_CHECK(fx.size(0) == b && fx.size(1) == h && fx.size(2) == w &&
                  fy.sizes() == fx.sizes(),
              "fx and fy must be [B, H, W]");
  TORCH_CHECK(radius >= 0 && radius <= 8, "box_solve needs winsize <= 17");
  const c10::cuda::CUDAGuard guard(m.device());
  void* stream = c10::cuda::getCurrentCUDAStream(m.get_device()).stream();
  raise_on(ofc_box_solve(m.data_ptr<float>(), fx.data_ptr<float>(),
                         fy.data_ptr<float>(), static_cast<int>(b),
                         static_cast<int>(h), static_cast<int>(w),
                         static_cast<int>(radius), static_cast<float>(inv_area),
                         stream),
           "box_solve");
}

// radius, B, H and W are the C launcher's to refuse (cudaErrorInvalidValue).
void gauss_solve(const torch::Tensor& m, torch::Tensor fx, torch::Tensor fy,
                 int64_t radius, const torch::Tensor& taps) {
  check(m, "m", 4);
  check(fx, "fx", 3);
  check(fy, "fy", 3);
  TORCH_CHECK(taps.device().is_cpu() && taps.scalar_type() == torch::kFloat32 &&
                  taps.is_contiguous() && taps.dim() == 1 && taps.size(0) == radius + 1,
              "taps must be a CPU float32 vector of radius + 1");
  const int64_t b = m.size(0), h = m.size(2), w = m.size(3);
  TORCH_CHECK(m.size(1) == 5, "m must be [B, 5, H, W]");
  TORCH_CHECK(fx.size(0) == b && fx.size(1) == h && fx.size(2) == w &&
                  fy.sizes() == fx.sizes(),
              "fx and fy must be [B, H, W]");
  TORCH_CHECK(fx.device() == m.device() && fy.device() == m.device(),
              "m, fx and fy must be on one device");
  const c10::cuda::CUDAGuard guard(m.device());
  void* stream = c10::cuda::getCurrentCUDAStream(m.get_device()).stream();
  raise_on(ofc_gauss_solve(m.data_ptr<float>(), fx.data_ptr<float>(),
                           fy.data_ptr<float>(), static_cast<int>(b),
                           static_cast<int>(h), static_cast<int>(w),
                           static_cast<int>(radius), taps.data_ptr<float>(),
                           stream),
           "gauss_solve");
}

// n, B, H and W are the C launcher's to refuse (cudaErrorInvalidValue);
// kernels/poly.py checks n first, since the taps are made from it.
void poly_expansion(const torch::Tensor& img, torch::Tensor out, int64_t n,
                    const torch::Tensor& taps) {
  check(img, "img", 3);
  check(out, "out", 4);
  TORCH_CHECK(taps.device().is_cpu() && taps.scalar_type() == torch::kFloat32 &&
                  taps.is_contiguous() && taps.dim() == 1 && taps.size(0) == 3 * (n + 1) + 4,
              "taps must be a CPU float32 vector of 3 (n + 1) + 4");
  const int64_t b = img.size(0), h = img.size(1), w = img.size(2);
  TORCH_CHECK(out.size(0) == b && out.size(1) == 5 && out.size(2) == h && out.size(3) == w,
              "out must be [B, 5, H, W] of img's [B, H, W]");
  TORCH_CHECK(out.device() == img.device(), "img and out must be on one device");
  const c10::cuda::CUDAGuard guard(img.device());
  void* stream = c10::cuda::getCurrentCUDAStream(img.get_device()).stream();
  raise_on(ofc_poly_expansion(img.data_ptr<float>(), out.data_ptr<float>(),
                              static_cast<int>(b), static_cast<int>(h),
                              static_cast<int>(w), static_cast<int>(n),
                              taps.data_ptr<float>(), stream),
           "poly_expansion");
}

// The factors and the radius are the C launcher's to refuse
// (cudaErrorInvalidValue); kernels/pyramid.py checks them first.
void pyramid_level(const torch::Tensor& img, torch::Tensor out, int64_t radius,
                   const torch::Tensor& taps) {
  check(img, "img", 3);
  check(out, "out", 3);
  TORCH_CHECK(taps.device().is_cpu() && taps.scalar_type() == torch::kFloat32 &&
                  taps.is_contiguous() && taps.dim() == 1 && taps.size(0) == radius + 1,
              "taps must be a CPU float32 vector of radius + 1");
  TORCH_CHECK(out.size(0) == img.size(0), "img and out must hold one batch");
  TORCH_CHECK(out.device() == img.device(), "img and out must be on one device");
  const c10::cuda::CUDAGuard guard(img.device());
  void* stream = c10::cuda::getCurrentCUDAStream(img.get_device()).stream();
  raise_on(ofc_pyramid_level(img.data_ptr<float>(), out.data_ptr<float>(),
                             static_cast<int>(img.size(0)), static_cast<int>(img.size(1)),
                             static_cast<int>(img.size(2)), static_cast<int>(out.size(1)),
                             static_cast<int>(out.size(2)), static_cast<int>(radius),
                             taps.data_ptr<float>(), stream),
           "pyramid_level");
}

constexpr int64_t kLanes = 128;
constexpr int64_t kTakeBf16 = 3;  // index of take_bf16 in probes.py BODIES

void loop_probe(int64_t body, const torch::Tensor& x, const torch::Tensor& idx,
                torch::Tensor out, int64_t n) {
  TORCH_CHECK(body >= 0 && body <= 5, "loop_probe: unknown body ", body);
  check(x, "x", 2, body == kTakeBf16 ? torch::kBFloat16 : torch::kFloat32);
  check(idx, "idx", 2, torch::kInt32);
  check(out, "out", 2);
  TORCH_CHECK(x.size(1) == kLanes && x.size(0) >= 1 &&
                  idx.sizes() == x.sizes() && out.sizes() == x.sizes(),
              "x, idx and out must be [rows, 128] of one shape");
  TORCH_CHECK(n >= 0 && n < (int64_t{1} << 24),
              "loop_probe needs 0 <= n < 2^24");
  const c10::cuda::CUDAGuard guard(x.device());
  void* stream = c10::cuda::getCurrentCUDAStream(x.get_device()).stream();
  raise_on(ofc_loop_probe(static_cast<int>(body), x.data_ptr(),
                          idx.data_ptr<int>(), out.data_ptr<float>(),
                          static_cast<int>(x.size(0)), static_cast<int>(n),
                          stream),
           "loop_probe");
}

void dynslice(const torch::Tensor& x, const torch::Tensor& off,
              torch::Tensor out) {
  check(x, "x", 2, torch::kBFloat16);
  check(off, "off", 1, torch::kInt32);
  check(out, "out", 2);
  TORCH_CHECK(x.size(0) == 80 && x.size(1) == kLanes, "x must be [80, 128]");
  TORCH_CHECK(off.size(0) == 1, "off must hold one element");
  TORCH_CHECK(out.size(0) == 24 && out.size(1) == kLanes,
              "out must be [24, 128]");
  const c10::cuda::CUDAGuard guard(x.device());
  void* stream = c10::cuda::getCurrentCUDAStream(x.get_device()).stream();
  raise_on(ofc_dynslice(x.data_ptr(), off.data_ptr<int>(),
                        out.data_ptr<float>(), stream),
           "dynslice");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("warp_m", &warp_m, "warp_m kernel: (r0, r1, fx, fy, m_out)");
  mod.def("box_solve", &box_solve,
          "box_solve kernel: (m, fx_out, fy_out, radius, inv_area)");
  mod.def("gauss_solve", &gauss_solve,
          "gauss_solve kernel: (m, fx_out, fy_out, radius, taps)");
  mod.def("poly_expansion", &poly_expansion,
          "poly_expansion kernel: (img, out, n, taps)");
  mod.def("pyramid_level", &pyramid_level,
          "pyramid_level kernel: (img, out, radius, taps)");
  mod.def("loop_probe", &loop_probe, "loop_probe kernel: (body, x, idx, out, n)");
  mod.def("dynslice", &dynslice, "dynslice kernel: (x, off, out)");
}
