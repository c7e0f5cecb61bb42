// K1 - fused splat front-end: flat word pod -> (N * D) packed entries.
//
// Replaces the Pallas kernel `wgpu_3dgs_viewer_app_tpu/ops/fused.py::_kernel`
// (presort off), gates included. One thread per splat: load the splat's pod
// words, SH words and gate records, then decode, model and view transform,
// EWA conic and radius (splat.cuh, shared with K4), SH (degree 0-3) to RGB,
// the gates (mask bits, per-splat edit, scene-wide selection edit,
// highlight; splat.cuh), opacity-aware extent, cull, then enumerate up to D
// tiles centre-out with the exact ellipse-tile test and pack key/p1/p2/p3
// (enumerate.cuh, shared with K5; the key carries the model rank of a merged
// multi-model frame). Slot d of splat s is entry s * D + d; dead slots are
// (SENTINEL, 0, 0, 0). The block stages its splats' entries in shared
// memory and writes them out as one contiguous range with one bulk (TMA)
// store (enumerate.cuh).
//
// The arithmetic repeats, expression for expression, the plain version
// (ops/preprocess.py + ops/binning.py); the library is built with
// --fmad=false so no multiply-add contracts, and the transcendentals are the
// ones torch's CUDA ops call (logf, sqrtf, rsqrtf, exp2f, log2f), so kernel
// and plain version agree to the bit on almost every entry.
//
// What bounds it on an H100: memory, by the bound `chip_smoke.py` reports.
// Per splat it reads 12 B of position, 4 B of colour, 12-24 B of covariance
// and up to 180 B of SH (48 B at norm8, with 8 B of range), and writes
// 16 * D bytes of entries; the gates add 1 B of mask, 1 B of selection and
// 32 B of edit record. But nothing may fuse or approximate, so at SH degree
// 3 (and more so with two edits) a thread issues about as many instructions
// as the card can issue in the time its bytes take; the design therefore
// spends no instruction or byte it can avoid without moving a bit: every
// load a thread makes (pod planes, each SH word once, the range, the gate
// records) is issued at the top, before any arithmetic, coalesced across
// the warp (the pod is splat-axis-last); the SH sum is unrolled so its
// basis and words stay in registers, with one test of the degree per band;
// the two edits share one copy of their code; every intermediate stays in
// registers (the plain version makes ~60 full-size tensors); the entries
// leave through the block's stage. The gate tensors are read where they
// lie, u8 bits and row-major (N, 3) / (N, 4) edit records, so a gated
// frame repacks nothing; the ungated frame runs a separate instantiation
// with no gate code at all.
#include <cstring>

#include "enumerate.cuh"
#include "splat.cuh"

using namespace gs;

namespace {

// u32 words of SH coefficients a splat holds (degree 3), by compression.
template <int SH>
constexpr int kShWords = SH == SH_SINGLE ? 45 : SH == SH_HALF ? 23 : SH == SH_NORM8 ? 12 : 0;

// Coefficient i = k * 3 + c of the splat, unpacked from its words in registers.
template <int SH>
__device__ __forceinline__ float sh_coeff(const uint32_t* w, float mn, float scale, int i) {
  if (SH == SH_SINGLE) return __uint_as_float(w[i]);
  if (SH == SH_HALF) return gs_f16_bits_to_f32((w[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
  if (SH == SH_NORM8) return (float)((w[i / 4] >> (8 * (i % 4))) & 0xFFu) * scale + mn;
  return 0.0f;
}

template <int SH, int COV, bool GATED>
__global__ void __launch_bounds__(kEnumThreads)
fused_frontend_kernel(const FrameParams fp, const IntParams ip,
                      const float* __restrict__ pos, const uint32_t* __restrict__ color0,
                      const void* __restrict__ cov3d, const void* __restrict__ sh,
                      const float* __restrict__ sh_mn, const float* __restrict__ sh_span,
                      const Gates gates, uint4* __restrict__ out) {
  const int64_t n = ip.n;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x;
  const int nb = (int)(n - first < (int64_t)blockDim.x ? n - first : (int64_t)blockDim.x);
  // A thread past the last splat repeats it; its slots are not stored.
  const int64_t s = first + ((int)threadIdx.x < nb ? (int)threadIdx.x : nb - 1);

  // --- every load first, so all of the splat's bytes are in flight at once:
  // pod words, the SH words the degree needs (each once), their range, and
  // the gate records ---
  const SplatWords pw = load_splat<COV>(pos, color0, cov3d, n, s);
  const int n_coef = ip.sh_degree >= 3 ? 15 : ip.sh_degree == 2 ? 8 : ip.sh_degree == 1 ? 3 : 0;
  const int n_words = SH == SH_SINGLE ? 3 * n_coef
                      : SH == SH_HALF ? (3 * n_coef + 1) / 2
                                      : (3 * n_coef + 3) / 4;
  constexpr int kW = kShWords<SH>;
  uint32_t shw[kW > 0 ? kW : 1];
#pragma unroll
  for (int i = 0; i < kW; ++i)
    shw[i] = i < n_words ? static_cast<const uint32_t*>(sh)[i * n + s] : 0u;
  const bool norm8 = SH == SH_NORM8 && n_coef > 0;
  const float mn = norm8 ? sh_mn[s] : 0.0f;
  const float span = norm8 ? sh_span[s] : 0.0f;
  GateWords gw{};
  if (GATED) gw = load_gates(ip, gates, s);

  const SplatGeometry sg = splat_geometry<COV>(fp, ip.display_mode, pw);
  const float wx = sg.wx, wy = sg.wy, wz = sg.wz, px = sg.px, py = sg.py;
  const float ca = sg.ca, cb = sg.cb, cc = sg.cc;
  const float c0r = sg.r, c0g = sg.g, c0b = sg.b;
  float alpha = sg.alpha;

  // --- SH -> RGB (degree-0 term is the u8 color0), unrolled over the 15
  // terms so the basis and the words stay in registers ---
  const float base_r = ip.no_sh0 ? 0.5f : c0r;
  const float base_g = ip.no_sh0 ? 0.5f : c0g;
  const float base_b = ip.no_sh0 ? 0.5f : c0b;
  float col[3] = {base_r, base_g, base_b};
  if (n_coef > 0) {
    const float dx = wx - fp.cam[0], dy = wy - fp.cam[1], dz = wz - fp.cam[2];
    const float inv_n = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-18f));
    const float x = dx * inv_n, y = dy * inv_n, z = dz * inv_n;
    float b[15] = {};
    b[0] = -0.4886025119029199f * y;
    b[1] = 0.4886025119029199f * z;
    b[2] = -0.4886025119029199f * x;
    const float xx2 = x * x, yy2 = y * y, zz2 = z * z;
    const float xy2 = x * y, yz2 = y * z, xz2 = x * z;
    if (n_coef >= 8) {
      b[3] = 1.0925484305920792f * xy2;
      b[4] = -1.0925484305920792f * yz2;
      b[5] = 0.31539156525252005f * (2.0f * zz2 - xx2 - yy2);
      b[6] = -1.0925484305920792f * xz2;
      b[7] = 0.5462742152960396f * (xx2 - yy2);
    }
    if (n_coef >= 15) {
      b[8] = -0.5900435899266435f * y * (3.0f * xx2 - yy2);
      b[9] = 2.890611442640554f * xy2 * z;
      b[10] = -0.4570457994644658f * y * (4.0f * zz2 - xx2 - yy2);
      b[11] = 0.3731763325901154f * z * (2.0f * zz2 - 3.0f * xx2 - 3.0f * yy2);
      b[12] = -0.4570457994644658f * x * (4.0f * zz2 - xx2 - yy2);
      b[13] = 1.445305721320277f * z * (xx2 - yy2);
      b[14] = -0.5900435899266435f * x * (xx2 - yy2);
    }
    const float scale = span * (1.0f / 255.0f);
    // Each channel's sum in the plain version's order; the three channels
    // interleave, and the degree is tested once per band, not per term.
    float acc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = b[0] * sh_coeff<SH>(shw, mn, scale, c);
#pragma unroll
    for (int k = 1; k < 15; ++k) {
      if (k == 3 && n_coef < 8) break;
      if (k == 8 && n_coef < 15) break;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c] = acc[c] + b[k] * sh_coeff<SH>(shw, mn, scale, k * 3 + c);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) col[c] = acc[c] + col[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) col[c] = clampf(col[c], 0.0f, 1.0f);

  // --- gates and edits, then the opacity-aware extent and cull ---
  bool gate_ok = true;
  if (GATED) gate_ok = apply_gates(fp, ip, gw, col[0], col[1], col[2], alpha);
  const float radius = live_radius(ip.display_mode, sg.radius, alpha);
  const bool valid = splat_valid(fp, sg, radius, alpha, gate_ok);
  if (!valid) alpha = 0.0f;

  // --- enumerate up to max_dup tiles centre-out and pack (enumerate.cuh) ---
  const EnumParams ep{ip.tile, ip.tiles_x, ip.tiles_y, ip.max_dup, ip.tile_shift,
                      ip.rank_shift, ip.model_rank, fp.depth_scale, fp.depth_qmax};
  enumerate_pack(ep, px, py, sg.depth, radius, ca, cb, cc, col[0], col[1], col[2], alpha, valid,
                 first, nb, out);
}

template <int SH, int COV>
void launch(const FrameParams& fp, const IntParams& ip, const void* pos, const void* color0,
            const void* cov3d, const void* sh, const void* sh_mn, const void* sh_span,
            const Gates& gates, void* out, cudaStream_t stream) {
  const int threads = kEnumThreads;
  const int blocks = (ip.n + threads - 1) / threads;
  const size_t smem = stage_bytes(threads, ip.max_dup);
  const float* p = static_cast<const float*>(pos);
  const uint32_t* c0 = static_cast<const uint32_t*>(color0);
  const float* mn = static_cast<const float*>(sh_mn);
  const float* span = static_cast<const float*>(sh_span);
  uint4* o = static_cast<uint4*>(out);
  if (ip.gates)
    fused_frontend_kernel<SH, COV, true><<<blocks, threads, smem, stream>>>(
        fp, ip, p, c0, cov3d, sh, mn, span, gates, o);
  else
    fused_frontend_kernel<SH, COV, false><<<blocks, threads, smem, stream>>>(
        fp, ip, p, c0, cov3d, sh, mn, span, gates, o);
}

}  // namespace

extern "C" int gs_fused_frontend(const float* frame, const int* iparams, const void* pos,
                                 const void* color0, const void* cov3d, const void* sh,
                                 const void* sh_mn, const void* sh_span, const void* mask,
                                 const void* sel, const void* eflags, const void* ergb,
                                 const void* eparams, void* out, void* stream) {
  FrameParams fp;
  IntParams ip;
  memcpy(&fp, frame, sizeof(fp));
  memcpy(&ip, iparams, sizeof(ip));
  if (ip.n <= 0) return 0;
  const Gates gates{static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(sel),
                    static_cast<const uint32_t*>(eflags), static_cast<const float*>(ergb),
                    static_cast<const float*>(eparams)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GS_CASE(S, C) \
  case S * 2 + C: launch<S, C>(fp, ip, pos, color0, cov3d, sh, sh_mn, sh_span, gates, out, st); break;
  switch (ip.sh_comp * 2 + ip.cov_comp) {
    GS_CASE(SH_SINGLE, COV_SINGLE)
    GS_CASE(SH_SINGLE, COV_HALF)
    GS_CASE(SH_HALF, COV_SINGLE)
    GS_CASE(SH_HALF, COV_HALF)
    GS_CASE(SH_NORM8, COV_SINGLE)
    GS_CASE(SH_NORM8, COV_HALF)
    GS_CASE(SH_REMOVE, COV_SINGLE)
    GS_CASE(SH_REMOVE, COV_HALF)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GS_CASE
  return (int)cudaGetLastError();
}
