// K1 - fused splat front-end: flat word pod -> (N * D) packed entries.
//
// Replaces the Pallas kernel `wgpu_3dgs_viewer_app_tpu/ops/fused.py::_kernel`
// (presort off), gates included. One thread per splat: load the splat's pod
// words, SH words and gate records, then decode, model and view transform,
// EWA conic and radius, SH (degree 0-3) to RGB (splat.cuh, shared with K4
// and K8), the gates (mask bits, per-splat edit, scene-wide selection edit,
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
// What bounds it on an H100: memory (its bytes over the card's bandwidth).
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

// The frame's scalars of the launch, copied in on the stream before it from
// the FrameRecord the launcher is given (device memory: a row of the viewer's
// parameter block). A launch captured in a CUDA graph keeps its arguments,
// not the frame's values; the copy is a node of the graph too, so each
// replay takes the frame's values. In the constant bank, as arguments were,
// the scalars cost the arithmetic no instruction of their own. One record
// serves every launch, so K1 is launched on one stream at a time.
__constant__ FrameRecord c_frame;

template <int SH, int COV, bool GATED>
__global__ void __launch_bounds__(kEnumThreads)
fused_frontend_kernel(const IntParams ip, const float* __restrict__ pos,
                      const uint32_t* __restrict__ color0, const void* __restrict__ cov3d,
                      const void* __restrict__ sh, const float* __restrict__ sh_mn,
                      const float* __restrict__ sh_span, const Gates gates,
                      uint4* __restrict__ out) {
  const FrameParams& fp = c_frame.fp;
  const int64_t n = ip.n;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x;
  const int nb = (int)(n - first < (int64_t)blockDim.x ? n - first : (int64_t)blockDim.x);
  // A thread past the last splat repeats it; its slots are not stored.
  const int64_t s = first + ((int)threadIdx.x < nb ? (int)threadIdx.x : nb - 1);

  // --- every load first, so all of the splat's bytes are in flight at once:
  // pod words, the SH words the degree needs (each once), their range, and
  // the gate records ---
  const SplatWords pw = load_splat<COV>(pos, color0, cov3d, n, s);
  const ShWords<SH> shw = load_sh<SH>(ip.sh_degree, sh, sh_mn, sh_span, n, s);
  GateWords gw{};
  if (GATED) gw = load_gates(ip, gates, s);

  const SplatGeometry sg = splat_geometry<COV>(fp, ip.display_mode, pw);
  float alpha = sg.alpha;

  // --- SH -> RGB (splat.cuh) ---
  float col[3];
  sh_color<SH>(fp, ip.no_sh0, shw, sg, col);

  // --- gates and edits, then the opacity-aware extent and cull ---
  bool gate_ok = true;
  if (GATED) gate_ok = apply_gates(fp, ip, c_frame.sel_flags, gw, col[0], col[1], col[2], alpha);
  const float radius = live_radius(ip.display_mode, sg.radius, alpha);
  const bool valid = splat_valid(fp, sg, radius, alpha, gate_ok);
  if (!valid) alpha = 0.0f;

  // --- enumerate up to max_dup tiles centre-out and pack (enumerate.cuh) ---
  const EnumParams ep{ip.tile, ip.tiles_x, ip.tiles_y, ip.max_dup, ip.tile_shift,
                      ip.rank_shift, c_frame.model_rank, fp.depth_scale, fp.depth_qmax};
  enumerate_pack(ep, sg.px, sg.py, sg.depth, radius, sg.ca, sg.cb, sg.cc, col[0], col[1], col[2],
                 alpha, valid, first, nb, out);
}

template <int SH, int COV>
void launch(const IntParams& ip, const void* pos, const void* color0,
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
        ip, p, c0, cov3d, sh, mn, span, gates, o);
  else
    fused_frontend_kernel<SH, COV, false><<<blocks, threads, smem, stream>>>(
        ip, p, c0, cov3d, sh, mn, span, gates, o);
}

}  // namespace

// `record`: a FrameRecord in device memory (the frame floats, the selection
// edit's flags, the model rank), copied into the kernel's constant record on
// `stream` before the launch; `iparams`: the host's IntParams, whose
// sel_flags and model_rank the record's take the place of.
extern "C" int gs_fused_frontend(const void* record, const int* iparams, const void* pos,
                                 const void* color0, const void* cov3d, const void* sh,
                                 const void* sh_mn, const void* sh_span, const void* mask,
                                 const void* sel, const void* eflags, const void* ergb,
                                 const void* eparams, void* out, void* stream) {
  IntParams ip;
  memcpy(&ip, iparams, sizeof(ip));
  if (ip.n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemcpyToSymbolAsync(c_frame, record, sizeof(FrameRecord), 0,
                                                  cudaMemcpyDefault, st);
  if (err != cudaSuccess) return (int)err;
  const Gates gates{static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(sel),
                    static_cast<const uint32_t*>(eflags), static_cast<const float*>(ergb),
                    static_cast<const float*>(eparams)};
#define GS_CASE(S, C) \
  case S * 2 + C: launch<S, C>(ip, pos, color0, cov3d, sh, sh_mn, sh_span, gates, out, st); break;
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

// An asynchronous copy of `bytes` on `stream` (the direction from the
// pointers), for the viewer's parameter block: pinned host memory to the
// device, captured in a CUDA graph as its first node.
extern "C" int gs_copy_async(void* dst, const void* src, long long bytes, void* stream) {
  return (int)cudaMemcpyAsync(dst, src, (size_t)bytes, cudaMemcpyDefault,
                              static_cast<cudaStream_t>(stream));
}

// Record `event` on `stream`; inside a stream capture as an external event,
// which makes it an event record node of the graph, so that each replay
// records it where it stands (after the parameter block's copy).
extern "C" int gs_record_event(void* event, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  const cudaError_t err = cudaStreamIsCapturing(st, &capture);
  if (err != cudaSuccess) return (int)err;
  cudaEvent_t ev = static_cast<cudaEvent_t>(event);
  return (int)(capture == cudaStreamCaptureStatusActive
                   ? cudaEventRecordWithFlags(ev, st, cudaEventRecordExternal)
                   : cudaEventRecord(ev, st));
}
