// The fdgan:: operators for a process without Python.
//
// An AOTInductor package of the generator (fdgan_tpu_torch/io/export.py)
// calls the hand kernels as the ops fdgan::dense_layer (K1), fdgan::h_stats
// (K2) and fdgan::channel_stats. In Python they are defined by
// fdgan_tpu_torch/ops/library.py; here, with the same schemas letter for
// letter, for libtorch: native/aoti_runner.cpp loads this library (--ops)
// before the package. Each CUDA implementation checks the operands the op
// was given (pixel strides against ld/ldo, sizes, dtypes, 16-byte
// addresses), calls the C entry point of libfdgan_kernels.so on the current
// CUDA stream of x's device, and throws on an error code. K2's per-block
// partials are reduced in float64 with ATen, as the Python op does. The
// weights arrive in the kernels' layouts (the package computes them), so
// this file lays nothing out.
//
// Built by fdgan_tpu_torch/ops/build.py::torch_ops_library() into the
// kernel library's directory, linked against it. A Python process never
// loads it: ops/library.py registers the same schemas there.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <atomic>
#include <string>

extern "C" {
int fdgan_dense_layer_f32(const void* x, const void* a1, const void* b1, const void* w1, const void* a2,
                          const void* b2, const void* w2, void* out, int B, int H, int W, int C, int ldx,
                          int ldo, int top, int bot, void* stream);
int fdgan_dense_layer_bf16(const void* x, const void* a1, const void* b1, const void* w1, const void* a2,
                           const void* b2, const void* w2, void* out, int B, int H, int W, int C, int ldx,
                           int ldo, int top, int bot, void* stream);
int fdgan_h_stats_f32_blocks(int npix);
int fdgan_h_stats_f32(const void* x, const void* a1, const void* b1, const void* w1, void* psum, void* psq,
                      int npix, int C, int ldx, void* stream);
int fdgan_h_stats_bf16_blocks(int npix);
int fdgan_h_stats_bf16(const void* x, const void* a1, const void* b1, const void* w1, void* psum, void* psq,
                       int npix, int C, int ldx, void* stream);
int fdgan_channel_stats_blocks(int npix, int C);
int fdgan_channel_stats_bf16(const void* x, void* part, void* out, int npix, int C, int ld, int rows,
                             void* stream);
const char* fdgan_error_string(int err);

// launches of each op's kernel in this process: 0 dense_layer, 1 h_stats, 2 channel_stats
long long fdgan_ops_launches(int op);
}

namespace {

constexpr int64_t kInter = 128;
constexpr int64_t kGrowth = 32;
std::atomic<long long> g_launches[3];

void check(int err, const char* what) {
  TORCH_CHECK(err == 0, what, ": CUDA error ", err, " (", fdgan_error_string(err), ")");
}

// The elements from one pixel of the NHWC tensor t to the next (ops/common.py::pixel_stride).
int64_t pixel_stride(const at::Tensor& t, const char* name) {
  TORCH_CHECK(t.dim() == 4, name, " must be NHWC (B, H, W, C), got ", t.sizes());
  const int64_t b = t.size(0), h = t.size(1), w = t.size(2), c = t.size(3);
  const auto s = t.strides();
  const int64_t ld = w > 1 ? s[2] : h > 1 ? s[1] : b > 1 ? s[0] : c;
  TORCH_CHECK((c == 1 || s[3] == 1) && (h == 1 || s[1] == w * ld) && (s[0] == h * w * ld || b == 1) && ld >= c,
              name, " must be NHWC-contiguous or a channel slice of an NHWC-contiguous buffer, got strides ",
              s, " for shape ", t.sizes());
  TORCH_CHECK((t.numel() / c - 1) * ld + c < (int64_t(1) << 31), name,
              " is too large for the kernels' 32-bit pixel indices");
  return ld;
}

void check_stride(const at::Tensor& t, int64_t ld, const char* name) {
  const int64_t got = pixel_stride(t, name);
  TORCH_CHECK(got == ld, name, " has pixel stride ", got, ", the op was given ld=", ld);
}

void check_operand(const at::Tensor& t, const at::Tensor& x, at::ScalarType dtype, int64_t numel, const char* name) {
  TORCH_CHECK(t.device() == x.device() && t.scalar_type() == dtype && t.numel() == numel && t.is_contiguous(),
              name, " must be a contiguous ", dtype, " tensor of ", numel, " elements on ", x.device(), ", got ",
              t.sizes(), " ", t.scalar_type(), " on ", t.device());
}

void check_address(const at::Tensor& t, const char* name) {
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, name,
              " must start on a 16-byte boundary (the kernels' vector loads)");
}

void* stream_of(const at::Tensor& x) { return c10::cuda::getCurrentCUDAStream(x.device().index()).stream(); }

int64_t round_up(int64_t n, int64_t m) { return (n + m - 1) / m * m; }

void dense_layer_cuda(const at::Tensor& x, const at::Tensor& a1, const at::Tensor& b1, const at::Tensor& w1,
                      const at::Tensor& a2, const at::Tensor& b2, const at::Tensor& w2, int64_t ld, int64_t top,
                      int64_t bot, const at::Tensor& out, int64_t ldo) {
  const bool f32 = x.scalar_type() == at::kFloat;
  TORCH_CHECK(x.is_cuda() && (f32 || x.scalar_type() == at::kBFloat16), "x must be float32 or bfloat16 on cuda");
  TORCH_CHECK(out.scalar_type() == x.scalar_type() && out.device() == x.device(), "out must be x's dtype on x's device");
  check_stride(x, ld, "x");
  check_stride(out, ldo, "out");
  const int64_t c = x.size(3), c32 = round_up(c, 32);
  TORCH_CHECK(out.size(0) == x.size(0) && out.size(1) == x.size(1) && out.size(2) == x.size(2) &&
                  out.size(3) == kGrowth,
              "out must be (B, H, W, 32)");
  check_operand(a1, x, at::kFloat, f32 ? c32 : c, "a1");
  check_operand(b1, x, at::kFloat, f32 ? c32 : c, "b1");
  check_operand(a2, x, at::kFloat, kInter, "a2");
  check_operand(b2, x, at::kFloat, kInter, "b2");
  check_operand(w1, x, x.scalar_type(), f32 ? 2 * c32 * kInter : c * kInter, "w1");
  check_operand(w2, x, x.scalar_type(), (f32 ? 2 : 1) * 9 * kInter * kGrowth, "w2");
  check_address(x, "x");
  if (!f32) check_address(out, "out");  // the fp32 kernel stores f with scalar writes: any ldo, any address
  c10::cuda::CUDAGuard guard(x.device());
  const auto launch = f32 ? fdgan_dense_layer_f32 : fdgan_dense_layer_bf16;
  check(launch(x.data_ptr(), a1.data_ptr(), b1.data_ptr(), w1.data_ptr(), a2.data_ptr(), b2.data_ptr(),
               w2.data_ptr(), out.data_ptr(), x.size(0), x.size(1), x.size(2), c, ld, ldo, top, bot, stream_of(x)),
        f32 ? "fdgan_dense_layer_f32" : "fdgan_dense_layer_bf16");
  g_launches[0]++;
}

std::tuple<at::Tensor, at::Tensor> h_stats_cuda(const at::Tensor& x, const at::Tensor& a1, const at::Tensor& b1,
                                                const at::Tensor& w1, int64_t ld) {
  const bool f32 = x.scalar_type() == at::kFloat;
  TORCH_CHECK(x.is_cuda() && (f32 || x.scalar_type() == at::kBFloat16), "x must be float32 or bfloat16 on cuda");
  check_stride(x, ld, "x");
  const int64_t c = x.size(3), ck = round_up(c, f32 ? 32 : 64);
  check_operand(a1, x, at::kFloat, f32 ? ck : c, "a1");
  check_operand(b1, x, at::kFloat, f32 ? ck : c, "b1");
  check_operand(w1, x, x.scalar_type(), (f32 ? 2 : 1) * ck * kInter, "w1");
  check_address(x, "x");
  c10::cuda::CUDAGuard guard(x.device());
  const int npix = static_cast<int>(x.numel() / c);
  const int rows = f32 ? fdgan_h_stats_f32_blocks(npix) : fdgan_h_stats_bf16_blocks(npix);
  if (rows < 0) check(-rows, "fdgan_h_stats_blocks");
  // per-block sums of h and of h*h; reduced in float64: at 8x512^2 the count is 2.1 M, and E[h^2]-mu^2 in
  // fp32 would lose the variance to cancellation
  auto part = at::empty({2, rows, kInter}, x.options().dtype(at::kDouble));
  const auto launch = f32 ? fdgan_h_stats_f32 : fdgan_h_stats_bf16;
  check(launch(x.data_ptr(), a1.data_ptr(), b1.data_ptr(), w1.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
               npix, c, ld, stream_of(x)),
        f32 ? "fdgan_h_stats_f32" : "fdgan_h_stats_bf16");
  g_launches[1]++;
  auto mom = part.sum(1).div_(npix);
  mom[1].addcmul_(mom[0], mom[0], -1.0).clamp_min_(0.0);
  auto m = mom.to(at::kFloat);
  return {m[0], m[1]};
}

std::tuple<at::Tensor, at::Tensor> channel_stats_cuda(const at::Tensor& x, int64_t ld) {
  TORCH_CHECK(x.is_cuda() && x.scalar_type() == at::kBFloat16, "the channel_stats kernel is bfloat16 only");
  check_stride(x, ld, "x");
  const int64_t c = x.size(3);
  const int npix = static_cast<int>(x.numel() / c);
  TORCH_CHECK(c % 8 == 0 && ld % 8 == 0, "channel_stats needs C % 8 == 0 and a pixel stride ld % 8 == 0");
  TORCH_CHECK(npix > 0, "channel_stats of an empty tensor");
  check_address(x, "x");
  c10::cuda::CUDAGuard guard(x.device());
  const int rows = fdgan_channel_stats_blocks(npix, c);
  if (rows < 0) check(-rows, "fdgan_channel_stats_blocks");
  auto part = at::empty({2, rows, c}, x.options().dtype(at::kDouble));
  auto out = at::empty({2, c}, x.options().dtype(at::kFloat));  // mean, biased var
  check(fdgan_channel_stats_bf16(x.data_ptr(), part.data_ptr(), out.data_ptr(), npix, c, ld, rows, stream_of(x)),
        "fdgan_channel_stats_bf16");
  g_launches[2]++;
  return {out[0], out[1]};
}

}  // namespace

extern "C" long long fdgan_ops_launches(int op) { return op >= 0 && op < 3 ? g_launches[op].load() : -1; }

TORCH_LIBRARY(fdgan, m) {
  m.def("dense_layer(Tensor x, Tensor a1, Tensor b1, Tensor w1, Tensor a2, Tensor b2, Tensor w2, int ld, int top, int bot, Tensor(a!) out, int ldo) -> ()");
  m.def("h_stats(Tensor x, Tensor a1, Tensor b1, Tensor w1, int ld) -> (Tensor, Tensor)");
  m.def("channel_stats(Tensor x, int ld) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(fdgan, CUDA, m) {
  m.impl("dense_layer", dense_layer_cuda);
  m.impl("h_stats", h_stats_cuda);
  m.impl("channel_stats", channel_stats_cuda);
}
