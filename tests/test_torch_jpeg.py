"""The port's JPEG encoder (`utils/jpeg.py`) against Pillow's (libjpeg's).

Pillow is used here only to encode the reference and to decode. Held: the
decoded pixels of the port's JPEG equal those of Pillow's own JPEG of the
same uint8 image (quality 50, 70, 85, 95; sizes whose edges fill partial
blocks and MCUs), the file equal byte for byte as well, the resize knob
within 2 levels of Pillow's `resize` (f32 weights against Pillow's 22-bit
fixed point, in each of two rounded passes), a well-formed stream, an
encoder that runs with no image library, and no module of the port nor
of the card scripts that imports JAX, the JAX package or PIL."""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu_torch.utils import jpeg, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(23, 37), (64, 64), (120, 200)]  # (H, W)
QUALITIES = [50, 70, 85, 95]
# Pillow's resize weighs in 22-bit fixed point, `resize_u8` in f32: each of
# the two passes (both rounded to uint8) may round a level apart.
RESIZE_TOL = 2


def _image(h, w, seed=0):
    """Smooth gradients with a band of noise: flat blocks, runs of zeros
    longer than 16 (ZRL), large coefficients and 0xFF bytes in the scan."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 7 + yy * 3) % 256, (xx * xx // 5 + yy) % 256,
                    128 + 60 * np.sin(xx / 5.0 + yy / 7.0)], -1).astype(np.uint8)
    lo, hi = h // 3, h // 3 + max(1, h // 4)
    img[lo:hi] = rng.integers(0, 256, (hi - lo, w, 3), dtype=np.uint8)
    return img


def _pil_jpeg(u8, quality):
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _decode(blob):
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES)
def test_jpeg_matches_pillow(size, quality):
    u8 = _image(*size)
    ref = _pil_jpeg(u8, quality)
    got = jpeg.encode_jpeg(u8, quality)
    assert np.array_equal(_decode(got), _decode(ref))
    assert got == ref


def test_jpeg_tensor_and_frame_inputs():
    """A tensor, a numpy array and an f32 frame of the same pixels give one file."""
    u8 = _image(40, 56, seed=1)
    frame = torch.from_numpy(u8.astype(np.float32) / 255.0)
    want = np.clip(frame.numpy() * 255.0, 0, 255).astype(np.uint8)
    assert np.array_equal(jpeg.frame_to_u8(frame).numpy(), want)
    blob = jpeg.encode_jpeg(want, 85)
    assert jpeg.encode_jpeg(torch.from_numpy(want), 85) == blob
    with trace.collect():
        n0 = len(trace.records)
        assert jpeg.encode_frame(frame, 85) == blob
        recs = trace.records[n0:]
    assert [r.name for r in recs] == ["jpeg.device", "jpeg.device", "jpeg.copy", "jpeg.entropy"]
    assert all(r.end >= r.start for r in recs)
    assert all(b.start >= a.end for a, b in zip(recs, recs[1:]))


@pytest.mark.parametrize("scale", [0.5, 0.37, 1.5])
def test_resize_matches_pillow(scale):
    u8 = _image(120, 200, seed=2)
    got = jpeg.resize_u8(torch.from_numpy(u8), scale).numpy()
    im = Image.fromarray(u8)
    size = (max(1, round(im.width * scale)), max(1, round(im.height * scale)))
    assert jpeg.scaled_size(im.width, im.height, scale) == size
    ref = np.asarray(im.resize(size))
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= RESIZE_TOL
    # The scaled frame is the encoding of the resized pixels.
    frame = torch.from_numpy(u8.astype(np.float32) / 255.0)
    assert jpeg.encode_frame(frame, 70, scale) == jpeg.encode_jpeg(got, 70)


def _segments(blob):
    """(marker, payload) of every segment before the scan, then the scan."""
    assert blob[:2] == b"\xff\xd8" and blob[-2:] == b"\xff\xd9"
    i, out = 2, []
    while True:
        assert blob[i] == 0xFF
        m, n = blob[i + 1], int.from_bytes(blob[i + 2:i + 4], "big")
        out.append((m, blob[i + 4:i + 2 + n]))
        i += 2 + n
        if m == 0xDA:
            return out, blob[i:-2]


def test_jpeg_stream_is_well_formed():
    u8 = _image(120, 200, seed=3)
    blob = jpeg.encode_jpeg(u8, 95)
    segs, scan = _segments(blob)
    assert [m for m, _ in segs] == [0xE0, 0xDB, 0xDB, 0xC0, 0xC4, 0xC4, 0xC4, 0xC4, 0xDA]
    assert segs[0][1][:5] == b"JFIF\x00"
    sof = segs[3][1]
    assert sof[0] == 8 and int.from_bytes(sof[1:3], "big") == 120
    assert int.from_bytes(sof[3:5], "big") == 200 and sof[5] == 3
    assert sof[6:] == bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])  # 4:2:0
    for (m, body), q in zip(segs[1:3], jpeg.quant_tables(95)):
        assert body[1:] == q[jpeg.ZIGZAG].astype(np.uint8).tobytes()
    # Byte stuffing: every 0xFF of the scan is followed by 0x00.
    ff = np.flatnonzero(np.frombuffer(scan, np.uint8) == 0xFF)
    assert ff.size > 0 and ff[-1] + 1 < len(scan)
    assert all(scan[i + 1] == 0 for i in ff)


def test_quant_tables_follow_the_ijg_rule():
    assert np.array_equal(jpeg.quant_tables(50)[0][:8], [16, 11, 10, 16, 24, 40, 51, 61])
    assert jpeg.quant_tables(100).max() == 1
    assert jpeg.quant_tables(1).max() == 255  # baseline: clipped to 8 bits
    assert jpeg.ZIGZAG[:6].tolist() == [0, 1, 8, 16, 9, 2]


def test_jpeg_encodes_without_an_image_library():
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from wgpu_3dgs_viewer_app_tpu_torch.utils.jpeg import encode_jpeg\n"
        "from wgpu_3dgs_viewer_app_tpu_torch.app import server\n"
        "b = encode_jpeg(np.full((9, 17, 3), 200, np.uint8), 85)\n"
        "assert b[:2] == b'\\xff\\xd8' and b[-2:] == b'\\xff\\xd9'\n"
        "print(len(b))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) > 100


def test_port_and_card_tools_import_no_jax_nor_pil():
    """No module of the port, nor a script the card runs (`scripts/card.py`
    and the scripts beside it that use it or drive several cards), imports
    JAX, the JAX package or PIL."""
    pkg = os.path.join(REPO, "wgpu_3dgs_viewer_app_tpu_torch")
    files = [os.path.join(REPO, "scripts", f) for f in ("card.py", "ab_port_kernels.py",
                                                        "profile_port_frame.py",
                                                        "sharded_ranks.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, f) for f in sorted(names) if f.endswith(".py")]
    assert len(files) > 50
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|wgpu_3dgs_viewer_app_tpu|PIL)\b", re.M)
    for f in files:
        with open(f) as fh:
            assert not bad.search(fh.read()), f
