// K4 - query geometry: flat word pod -> the 12 per-splat PreprocessOut
// fields at SH degree 0, for selection and hit queries.
//
// Replaces the Pallas kernel `wgpu_3dgs_viewer_app_tpu/ops/fused.py::
// _geometry_kernel`. One thread per splat: decode, model and view transform,
// EWA conic and radius (splat.cuh, the section K1 runs too), the u8 base
// colour, the mask and per-splat edit gates, the opacity-aware extent and
// the cull. Writes mean_x, mean_y, conic a/b/c, r, g, b, alpha (0 where
// culled), depth and radius as rows of one (11, N) f32 tensor, and valid as
// (N,) bytes. Its plain version is ops/preprocess.py::preprocess at
// sh_degree 0 with the same frame scalars (proj[0][0] from the matrix, not
// the reference's 2 fx / width), so the two agree to the bit on the card.
//
// What bounds it on an H100: memory. Per splat it reads 28 B of pod (12 B
// position, 4 B colour, 12 B half covariance; 36 B more for a single-float
// covariance), 33 B more when gated (1 B mask, 4 B flags, 12 B edit rgb,
// 16 B edit params), and writes 45 B; ~150 flops (~250 with an edit) stay
// far below the compute rate. At 2M splats that is 146-212 MB, a bound of
// 0.044-0.063 ms at 3.35 TB/s. The design is one thread per splat with
// every intermediate in registers and every plane read and written once,
// coalesced across the warp (splat-axis-last planes); the ungated query
// runs an instantiation without gate code.
#include <cstring>

#include "splat.cuh"

using namespace gs;

namespace {

template <int COV, bool GATED>
__global__ void __launch_bounds__(128)
geometry_kernel(const FrameParams fp, const IntParams ip, const float* __restrict__ pos,
                const uint32_t* __restrict__ color0, const void* __restrict__ cov3d,
                const Gates gates, float* __restrict__ out, uint8_t* __restrict__ valid_out) {
  const int64_t n = ip.n;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;

  const SplatGeometry sg =
      splat_geometry<COV>(fp, ip.display_mode, load_splat<COV>(pos, color0, cov3d, n, s));
  // Degree 0: the colour is the u8 base (queries read geometry only).
  float r = clampf(sg.r, 0.0f, 1.0f), g = clampf(sg.g, 0.0f, 1.0f), b = clampf(sg.b, 0.0f, 1.0f);
  float alpha = sg.alpha;
  bool gate_ok = true;
  if (GATED) gate_ok = apply_gates(fp, ip, load_gates(ip, gates, s), r, g, b, alpha);
  const float radius = live_radius(ip.display_mode, sg.radius, alpha);
  const bool valid = splat_valid(fp, sg, radius, alpha, gate_ok);

  out[s] = sg.px;
  out[n + s] = sg.py;
  out[2 * n + s] = sg.ca;
  out[3 * n + s] = sg.cb;
  out[4 * n + s] = sg.cc;
  out[5 * n + s] = r;
  out[6 * n + s] = g;
  out[7 * n + s] = b;
  out[8 * n + s] = valid ? alpha : 0.0f;
  out[9 * n + s] = sg.depth;
  out[10 * n + s] = radius;
  valid_out[s] = valid ? 1 : 0;
}

template <int COV>
void launch(const FrameParams& fp, const IntParams& ip, const void* pos, const void* color0,
            const void* cov3d, const Gates& gates, void* out, void* valid, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (ip.n + threads - 1) / threads;
  const float* p = static_cast<const float*>(pos);
  const uint32_t* c0 = static_cast<const uint32_t*>(color0);
  float* o = static_cast<float*>(out);
  uint8_t* v = static_cast<uint8_t*>(valid);
  if (ip.gates)
    geometry_kernel<COV, true><<<blocks, threads, 0, stream>>>(fp, ip, p, c0, cov3d, gates, o, v);
  else
    geometry_kernel<COV, false><<<blocks, threads, 0, stream>>>(fp, ip, p, c0, cov3d, gates, o, v);
}

}  // namespace

extern "C" int gs_geometry(const float* frame, const int* iparams, const void* pos,
                           const void* color0, const void* cov3d, const void* mask,
                           const void* eflags, const void* ergb, const void* eparams, void* out,
                           void* valid, void* stream) {
  FrameParams fp;
  IntParams ip;
  memcpy(&fp, frame, sizeof(fp));
  memcpy(&ip, iparams, sizeof(ip));
  if (ip.n <= 0) return 0;
  if (ip.gates & ~(GATE_MASK | GATE_EDIT)) return (int)cudaErrorInvalidValue;
  const Gates gates{static_cast<const uint8_t*>(mask), nullptr,
                    static_cast<const uint32_t*>(eflags), static_cast<const float*>(ergb),
                    static_cast<const float*>(eparams)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ip.cov_comp == COV_SINGLE)
    launch<COV_SINGLE>(fp, ip, pos, color0, cov3d, gates, out, valid, st);
  else if (ip.cov_comp == COV_HALF)
    launch<COV_HALF>(fp, ip, pos, color0, cov3d, gates, out, valid, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
