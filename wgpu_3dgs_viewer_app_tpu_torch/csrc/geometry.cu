// K4 - query geometry, and K8 - the staged front-end's preprocess: flat
// word pod -> the 12 per-splat PreprocessOut fields.
//
// One kernel template, `geometry_kernel<SH, COV, GATED>`, with two entries:
// - `gs_geometry` (K4) replaces the Pallas kernel
//   `wgpu_3dgs_viewer_app_tpu/ops/fused.py::_geometry_kernel`: the SH-less
//   instance (SH = kNoSh: no SH word is read and the colour is the u8 base),
//   with the mask and per-splat edit gates, for selection and hit queries.
// - `gs_preprocess` (K8) replaces no Pallas kernel: it is the counterpart of
//   the reference's jitted `wgpu_3dgs_viewer_app_tpu/ops/preprocess.py::
//   preprocess`, which XLA fuses into one pass on the TPU and which eager
//   torch would run as ~1,100-3,400 launches. SH degree 0-3 in every SH and
//   covariance compression, `no_sh0`, the three display modes and all four
//   gates (mask, per-splat edit, selection edit, highlight).
// One thread per splat: the pod words, SH words and gate records are loaded
// first, then decode, model and view transform, EWA conic and radius, SH to
// RGB, the gates and the opacity-aware extent (splat.cuh, the section K1
// runs too) and the cull. Writes mean_x, mean_y, conic a/b/c, r, g, b, alpha
// (0 where culled), depth and radius as rows of one (11, N) f32 tensor, and
// valid as (N,) bytes. The plain version is ops/preprocess.py::preprocess
// with the same frame scalars (for K4 at sh_degree 0; proj[0][0] from the
// matrix, not the reference's 2 fx / width), so kernel and plain version
// agree to the bit on the card.
//
// What bounds it on an H100: memory. Per splat it reads 28 B of pod (12 B
// position, 4 B colour, 12 B half covariance; 12 B more for a single-float
// covariance), the SH words the degree needs (K8 at degree 3: 48 B at
// norm8 with 8 B of range, 92 B at half, 180 B at single), 35 B more when
// every gate is on (1 B mask, 1 B selection, 4 B flags, 12 B edit rgb, 16 B
// edit params), and writes 45 B; ~150 flops, ~180 more for SH 3 and ~110
// an edit, stay far below the compute rate. K8 at norm8/half and degree 3
// moves 129 B a splat: a bound of 0.231 ms at 6M splats at 3.35 TB/s. The
// design is one thread per splat with every intermediate in registers and
// every plane read and written once, coalesced across the warp
// (splat-axis-last planes); the ungated call runs an instantiation without
// gate code.
#include <cstring>

#include "splat.cuh"

using namespace gs;

namespace {

// K4's SH "compression": no SH word is read; the colour is the u8 base.
constexpr int kNoSh = 4;

template <int SH, int COV, bool GATED>
__global__ void __launch_bounds__(128)
geometry_kernel(const FrameParams fp, const IntParams ip, const float* __restrict__ pos,
                const uint32_t* __restrict__ color0, const void* __restrict__ cov3d,
                const void* __restrict__ sh, const float* __restrict__ sh_mn,
                const float* __restrict__ sh_span, const Gates gates, float* __restrict__ out,
                uint8_t* __restrict__ valid_out) {
  const int64_t n = ip.n;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;

  // --- every load first: pod words, SH words and range, gate records. K4
  // loads its gate records where it applies them (A/B on an H100: 2-4%
  // faster gated than loading them first) ---
  const SplatWords pw = load_splat<COV>(pos, color0, cov3d, n, s);
  ShWords<SH> shw{};
  if constexpr (SH != kNoSh) shw = load_sh<SH>(ip.sh_degree, sh, sh_mn, sh_span, n, s);
  GateWords gw{};
  if constexpr (GATED && SH != kNoSh) gw = load_gates(ip, gates, s);

  const SplatGeometry sg = splat_geometry<COV>(fp, ip.display_mode, pw);
  float col[3];
  if constexpr (SH == kNoSh) {
    col[0] = clampf(sg.r, 0.0f, 1.0f);
    col[1] = clampf(sg.g, 0.0f, 1.0f);
    col[2] = clampf(sg.b, 0.0f, 1.0f);
  } else {
    sh_color<SH>(fp, ip.no_sh0, shw, sg, col);
  }
  float alpha = sg.alpha;
  bool gate_ok = true;
  if constexpr (GATED) {
    if constexpr (SH == kNoSh) gw = load_gates(ip, gates, s);
    gate_ok = apply_gates(fp, ip, ip.sel_flags, gw, col[0], col[1], col[2], alpha);
  }
  const float radius = live_radius(ip.display_mode, sg.radius, alpha);
  const bool valid = splat_valid(fp, sg, radius, alpha, gate_ok);

  out[s] = sg.px;
  out[n + s] = sg.py;
  out[2 * n + s] = sg.ca;
  out[3 * n + s] = sg.cb;
  out[4 * n + s] = sg.cc;
  out[5 * n + s] = col[0];
  out[6 * n + s] = col[1];
  out[7 * n + s] = col[2];
  out[8 * n + s] = valid ? alpha : 0.0f;
  out[9 * n + s] = sg.depth;
  out[10 * n + s] = radius;
  valid_out[s] = valid ? 1 : 0;
}

template <int SH, int COV>
void launch(const FrameParams& fp, const IntParams& ip, const void* pos, const void* color0,
            const void* cov3d, const void* sh, const void* sh_mn, const void* sh_span,
            const Gates& gates, void* out, void* valid, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (ip.n + threads - 1) / threads;
  const float* p = static_cast<const float*>(pos);
  const uint32_t* c0 = static_cast<const uint32_t*>(color0);
  const float* mn = static_cast<const float*>(sh_mn);
  const float* span = static_cast<const float*>(sh_span);
  float* o = static_cast<float*>(out);
  uint8_t* v = static_cast<uint8_t*>(valid);
  if (ip.gates)
    geometry_kernel<SH, COV, true><<<blocks, threads, 0, stream>>>(fp, ip, p, c0, cov3d, sh, mn,
                                                                  span, gates, o, v);
  else
    geometry_kernel<SH, COV, false><<<blocks, threads, 0, stream>>>(fp, ip, p, c0, cov3d, sh, mn,
                                                                   span, gates, o, v);
}

// Both entries take the same arguments; K4 reads no SH and takes the mask
// and edit gates only.
int run(bool with_sh, const float* frame, const int* iparams, const void* pos,
        const void* color0, const void* cov3d, const void* sh, const void* sh_mn,
        const void* sh_span, const void* mask, const void* sel, const void* eflags,
        const void* ergb, const void* eparams, void* out, void* valid, void* stream) {
  FrameParams fp;
  IntParams ip;
  memcpy(&fp, frame, sizeof(fp));
  memcpy(&ip, iparams, sizeof(ip));
  if (ip.n <= 0) return 0;
  if (ip.gates & ~(GATE_MASK | GATE_EDIT | GATE_SEL_EDIT | GATE_HIGHLIGHT))
    return (int)cudaErrorInvalidValue;
  if (!with_sh && (ip.gates & ~(GATE_MASK | GATE_EDIT))) return (int)cudaErrorInvalidValue;
  if (ip.sh_degree < 0 || ip.sh_degree > 3 || ip.display_mode < 0 || ip.display_mode > 2 ||
      ip.sh_comp < SH_SINGLE || ip.sh_comp > SH_REMOVE || ip.cov_comp < COV_SINGLE ||
      ip.cov_comp > COV_HALF)
    return (int)cudaErrorInvalidValue;
  const Gates gates{static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(sel),
                    static_cast<const uint32_t*>(eflags), static_cast<const float*>(ergb),
                    static_cast<const float*>(eparams)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sh_comp = with_sh ? ip.sh_comp : kNoSh;
#define GS_CASE(S, C)                                                                      \
  case S * 2 + C:                                                                          \
    launch<S, C>(fp, ip, pos, color0, cov3d, sh, sh_mn, sh_span, gates, out, valid, st); \
    break;
  switch (sh_comp * 2 + ip.cov_comp) {
    GS_CASE(SH_SINGLE, COV_SINGLE)
    GS_CASE(SH_SINGLE, COV_HALF)
    GS_CASE(SH_HALF, COV_SINGLE)
    GS_CASE(SH_HALF, COV_HALF)
    GS_CASE(SH_NORM8, COV_SINGLE)
    GS_CASE(SH_NORM8, COV_HALF)
    GS_CASE(SH_REMOVE, COV_SINGLE)
    GS_CASE(SH_REMOVE, COV_HALF)
    GS_CASE(kNoSh, COV_SINGLE)
    GS_CASE(kNoSh, COV_HALF)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GS_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gs_geometry(const float* frame, const int* iparams, const void* pos,
                           const void* color0, const void* cov3d, const void* sh,
                           const void* sh_mn, const void* sh_span, const void* mask,
                           const void* sel, const void* eflags, const void* ergb,
                           const void* eparams, void* out, void* valid, void* stream) {
  return run(false, frame, iparams, pos, color0, cov3d, sh, sh_mn, sh_span, mask, sel, eflags,
             ergb, eparams, out, valid, stream);
}

extern "C" int gs_preprocess(const float* frame, const int* iparams, const void* pos,
                             const void* color0, const void* cov3d, const void* sh,
                             const void* sh_mn, const void* sh_span, const void* mask,
                             const void* sel, const void* eflags, const void* ergb,
                             const void* eparams, void* out, void* valid, void* stream) {
  return run(true, frame, iparams, pos, color0, cov3d, sh, sh_mn, sh_span, mask, sel, eflags,
             ergb, eparams, out, valid, stream);
}
