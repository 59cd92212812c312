"""Write the WebP fixtures of the port's tests.

    python tests/torch_port_webp/make_fixtures.py

The card's machine has neither cv2 nor PIL nor libwebp, so the files that
hold the port's C++ decoder to its numpy one there are made here once and
checked in; `tests/test_torch_port_webp.py` holds both against JAX's
`_read_image` (cv2) and the tile loader against JAX's OpenCV 4.6 loader on
the CPU, and `chip_smoke.py` holds the C++ decoder to the numpy one on
them. Most files come from libwebp's encoder, driven through its C API by
a small program this script builds with the host C compiler against the
headers and library of the machine's libwebp (`webp/encode.h`): it sets
the WebPConfig fields cv2 and PIL do not expose (segments, partitions,
filter type and sharpness, spatial noise shaping, alpha compression and
filtering, near-lossless, lossless method, sharp YUV, exact). Others come
from cv2 and PIL, and the containers this script writes itself (VP8X with
an ALPH chunk of each filter, raw or as a VP8L stream of
`torch_port_common.vp8l_stream`, the minimal VP8L writer). Each image is
smooth structure plus noise, palettes or quadrants of unlike statistics
(which give VP8L's meta prefix codes), from a seeded numpy generator at odd
sides.

`vedai_q90/` holds four RGB + IR pairs of `SyntheticVedai(n=16, 512,
seed=1)` (stems 00000000-00000003) and one 1024 px pair (`SyntheticVedai(
n=1, 1024, seed=2)`, stem 00001024) at quality 90, the lossy folder of
chip_smoke's phase `webp`; the IR images are stored as RGB with three equal
channels (WebP has no gray).
"""

from __future__ import annotations

import io
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))
sys.path.insert(0, str(HERE.parent))

from torch_port_common import riff, vp8l_stream  # noqa: E402

# libwebp's encoder these files were written with (WebPGetEncoderVersion):
# another version may write other bytes for the same settings
ENCODER_VERSION = 0x010204

ENCODER_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <webp/encode.h>
/* in.raw w h channels out.webp [field=value ...] */
int main(int argc, char** argv) {
  if (argc < 6) return 2;
  int w = atoi(argv[2]), h = atoi(argv[3]), c = atoi(argv[4]);
  size_t n = (size_t)w * h * c;
  unsigned char* px = malloc(n);
  FILE* f = fopen(argv[1], "rb");
  if (!f || fread(px, 1, n, f) != n) return 3;
  fclose(f);
  WebPConfig cfg;
  if (!WebPConfigInit(&cfg)) return 4;
  for (int i = 6; i < argc; ++i) {
    char k[64];
    double v;
    if (sscanf(argv[i], "%63[^=]=%lf", k, &v) != 2) return 5;
#define FIELD(name) else if (!strcmp(k, #name)) cfg.name = v;
    if (0) {}
    FIELD(lossless) FIELD(quality) FIELD(method) FIELD(segments)
    FIELD(sns_strength) FIELD(filter_strength) FIELD(filter_sharpness)
    FIELD(filter_type) FIELD(autofilter) FIELD(alpha_compression)
    FIELD(alpha_filtering) FIELD(alpha_quality) FIELD(partitions)
    FIELD(near_lossless) FIELD(exact) FIELD(use_sharp_yuv) FIELD(pass)
    else return 6;
  }
  if (!WebPValidateConfig(&cfg)) return 7;
  WebPPicture pic;
  if (!WebPPictureInit(&pic)) return 8;
  pic.width = w;
  pic.height = h;
  pic.use_argb = cfg.lossless || cfg.near_lossless < 100 || cfg.use_sharp_yuv;
  if (!(c == 4 ? WebPPictureImportRGBA(&pic, px, w * 4)
               : WebPPictureImportRGB(&pic, px, w * 3))) return 9;
  WebPMemoryWriter wr;
  WebPMemoryWriterInit(&wr);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &wr;
  if (!WebPEncode(&cfg, &pic)) return 10;
  f = fopen(argv[5], "wb");
  if (!f || fwrite(wr.mem, 1, wr.size, f) != wr.size) return 11;
  fclose(f);
  printf("%d\n", WebPGetEncoderVersion());
  return 0;
}
"""


class Encoder:
    """libwebp's encoder through ENCODER_C, built in a scratch directory
    (`cc` / `gcc` / `g++` with -lwebp); raises RuntimeError where it does
    not build."""

    def __init__(self):
        self.tmp = Path(tempfile.mkdtemp(prefix="webpenc"))
        src = self.tmp / "webpenc.c"
        src.write_text(ENCODER_C)
        self.exe = self.tmp / "webpenc"
        for cc in ("cc", "gcc", "g++"):
            cmd = [cc, "-O1", "-x", "c", str(src), "-o", str(self.exe),
                   "-lwebp"]
            try:
                p = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError:
                continue
            if p.returncode == 0:
                break
        else:
            raise RuntimeError("libwebp's encoder does not build here")
        self.version = None

    def __call__(self, arr: np.ndarray, **cfg) -> bytes:
        arr = np.ascontiguousarray(arr, np.uint8)
        h, w, c = arr.shape
        raw, out = self.tmp / "in.raw", self.tmp / "out.webp"
        raw.write_bytes(arr.tobytes())
        p = subprocess.run([str(self.exe), str(raw), str(w), str(h), str(c),
                            str(out)] + [f"{k}={v}" for k, v in cfg.items()],
                           capture_output=True, text=True)
        if p.returncode:
            raise RuntimeError(f"webpenc {cfg}: exit {p.returncode}")
        self.version = int(p.stdout)
        return out.read_bytes()


def scene(h: int, w: int, c: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 90 * np.sin(x / 5.0 + k) * np.cos(y / 7.0 - k)
                     for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 18, (h, w, c)), 0, 255).astype(
        np.uint8)


def palette(h: int, w: int, c: int, n: int, seed: int) -> np.ndarray:
    cols = np.random.default_rng(seed).integers(0, 256, (n, c), np.uint8)
    return cols[(scene(h, w, 1, seed)[..., 0].astype(int) * n) // 256]


def quadrants(h: int, w: int, seed: int) -> np.ndarray:
    """Four regions of unlike statistics: VP8L's meta prefix codes."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    y, x = np.mgrid[:h, :w]
    a, b = h // 2, w // 2
    img[:a, :b] = (x[:a, :b, None] * 3 + np.arange(3) * 40) % 256
    img[:a, b:] = rng.integers(0, 4, (a, w - b, 3)) * 60
    img[a:, :b] = ((y[a:, :b, None] * 2) % 256).astype(np.uint8)
    img[a:, b:] = rng.integers(100, 140, (h - a, w - b, 3))
    return img


def alpha_of(h: int, w: int, seed: int) -> np.ndarray:
    """An alpha plane: a soft disc, a ramp and noise, some 0 and 255."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    r = np.hypot(y - h / 2, x - w / 2) / (0.5 * max(h, w))
    a = np.clip(300 * (1 - r) + 40 * np.sin(x / 3.0), 0, 255)
    return np.clip(a + rng.normal(0, 6, (h, w)), 0, 255).astype(np.uint8)


def filter_alpha(a: np.ndarray, filt: int) -> np.ndarray:
    """libwebp's alpha filters (the inverse of the decoder's unfilters):
    0 none, 1 horizontal, 2 vertical, 3 gradient."""
    a = a.astype(np.int32)
    out = a.copy()
    if filt == 0:
        return a.astype(np.uint8)
    out[0, 1:] = a[0, 1:] - a[0, :-1]
    if filt == 1:
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
        out[1:, 1:] = a[1:, 1:] - a[1:, :-1]
    elif filt == 2:
        out[1:] = a[1:] - a[:-1]
    else:
        left = np.concatenate([a[1:, :1], a[1:, :-1]], 1)   # left, x=0: top
        top, tl = a[:-1], np.concatenate([a[:-1, :1], a[:-1, :-1]], 1)
        out[1:] = a[1:] - np.clip(left + top - tl, 0, 255)
    return (out & 255).astype(np.uint8)


def with_alpha(lossy: bytes, alpha: np.ndarray, filt: int,
               compressed: bool) -> bytes:
    """A VP8X file: the VP8 chunk of a simple lossy file and an ALPH chunk
    of `alpha` under filter `filt`, raw or as a headerless VP8L stream."""
    assert lossy[12:16] == b"VP8 "
    vp8 = lossy[20:20 + int.from_bytes(lossy[16:20], "little")]
    h, w = alpha.shape
    f = filter_alpha(alpha, filt)
    if compressed:
        argb = np.zeros((h, w, 4), np.uint8)
        argb[..., 0] = 255
        argb[..., 2] = f
        data = vp8l_stream(argb, header=False)
    else:
        data = f.tobytes()
    head = bytes([(filt << 2) | int(compressed)])
    vp8x = (bytes([0x10, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
            + (h - 1).to_bytes(3, "little"))
    return riff([(b"VP8X", vp8x), (b"ALPH", head + data), (b"VP8 ", vp8)])


def _pil(arr: np.ndarray, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    mode = {2: "L", 3: "RGB"}.get(arr.ndim) if arr.ndim == 2 else \
        {3: "RGB", 4: "RGBA"}[arr.shape[2]]
    Image.fromarray(arr, mode).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _cv2(rgb: np.ndarray, quality: int) -> bytes:
    import cv2
    ok, buf = cv2.imencode(".webp", rgb[..., ::-1].copy(),
                           [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return buf.tobytes()


def fixtures(enc: Encoder) -> dict:
    """name -> file bytes, every kind the tests hold."""
    from PIL import Image
    s = scene
    out = {
        # VP8L: predictor + cross-colour, subtract green, palettes (pixel
        # bundling of 8, 4 and 2 indices a pixel, and none), colour cache
        # and meta codes, alpha, near-lossless, exact
        "ll_rgb_37x53": enc(s(37, 53, 3, 1), lossless=1),
        "ll_rgba_41x29_m6": enc(s(41, 29, 4, 2), lossless=1, method=6,
                                quality=100),
        "ll_m0_61x17": enc(s(61, 17, 3, 3), lossless=1, method=0),
        "ll_pal2_33x21": enc(palette(33, 21, 3, 2, 4), lossless=1),
        "ll_pal4_35x23": enc(palette(35, 23, 3, 4, 5), lossless=1),
        "ll_pal16_39x25": enc(palette(39, 25, 3, 16, 6), lossless=1),
        "ll_pal256_57x39": enc(palette(57, 39, 3, 256, 7), lossless=1),
        "ll_pal16_rgba_21x19": enc(palette(21, 19, 4, 16, 8), lossless=1),
        "ll_meta_cache_96x131": enc(quadrants(96, 131, 9), lossless=1,
                                    method=6, quality=100),
        "ll_1x1": enc(s(1, 1, 3, 10), lossless=1),
        "ll_1x7_rgba": enc(s(1, 7, 4, 11), lossless=1),
        "ll_9x1": enc(s(9, 1, 3, 12), lossless=1),
        "ll_near_lossless_60": enc(s(45, 47, 3, 13), lossless=1,
                                   near_lossless=60),
        "ll_exact_rgba_27x31": enc(s(27, 31, 4, 14), lossless=1, exact=1),
        "ll_gray_64x33": enc(np.repeat(s(64, 33, 1, 15), 3, -1),
                             lossless=1),
        "ll_minimal_writer_23x19": riff([(b"VP8L", vp8l_stream(
            s(23, 19, 4, 16)[..., [3, 0, 1, 2]]))]),
        "ll_cv2_31x43": _cv2(s(31, 43, 3, 17), 101),
        "ll_pil_rgba_29x37": _pil(s(29, 37, 4, 18), lossless=True),
        # VP8: qualities, segments, filters, partitions, sharp YUV, sides
        "q1_47x61": enc(s(47, 61, 3, 20), quality=1),
        "q10_61x47": enc(s(61, 47, 3, 21), quality=10),
        "q50_33x65": enc(s(33, 65, 3, 22), quality=50),
        "q75_65x33": enc(s(65, 33, 3, 23), quality=75),
        "q90_97x83": enc(s(97, 83, 3, 24), quality=90),
        "q100_49x51": enc(s(49, 51, 3, 25), quality=100),
        "seg1_90x91": enc(s(90, 91, 3, 26), segments=1),
        "seg2_90x91": enc(s(90, 91, 3, 27), segments=2, sns_strength=100),
        "seg3_90x91": enc(s(90, 91, 3, 28), segments=3, sns_strength=100),
        "seg4_90x91": enc(s(90, 91, 3, 29), segments=4, sns_strength=100),
        "simple_sharp0_45x77": enc(s(45, 77, 3, 30), filter_type=0,
                                   filter_strength=60, filter_sharpness=0),
        "simple_sharp7_45x77": enc(s(45, 77, 3, 31), filter_type=0,
                                   filter_strength=60, filter_sharpness=7),
        "strong_sharp3_77x45": enc(s(77, 45, 3, 32), filter_type=1,
                                   filter_strength=80, filter_sharpness=3),
        "nofilter_41x41": enc(s(41, 41, 3, 33), filter_strength=0,
                              autofilter=0),
        "part2_150x70": enc(s(150, 70, 3, 34), partitions=1),
        "part4_150x70": enc(s(150, 70, 3, 35), partitions=2),
        "part8_150x70": enc(s(150, 70, 3, 36), partitions=3),
        "part8_17x40": enc(s(17, 40, 3, 37), partitions=3),
        "sharp_yuv_50x50": enc(s(50, 50, 3, 38), use_sharp_yuv=1),
        "lossy_1x1": enc(s(1, 1, 3, 39)),
        "lossy_2x3": enc(s(2, 3, 3, 40)),
        "lossy_3x1": enc(s(3, 1, 3, 41)),
        "lossy_257x300": enc(s(257, 300, 3, 42), quality=80),
        "lossy_gray_pil_64x33": _pil(s(64, 33, 1, 43)[..., 0]),
        "lossy_cv2_43x31": _cv2(s(43, 31, 3, 44), 80),
        # VP8X + ALPH: the encoder's (raw and VP8L, its filter choices) and
        # this script's (each of the four filters, raw and VP8L)
        "alpha_enc_vp8l_f0_33x29": enc(s(33, 29, 4, 50), alpha_filtering=0),
        "alpha_enc_vp8l_f1_33x29": enc(s(33, 29, 4, 51), alpha_filtering=1),
        "alpha_enc_vp8l_f2_33x29": enc(s(33, 29, 4, 52), alpha_filtering=2),
        "alpha_enc_raw_37x35": enc(s(37, 35, 4, 53), alpha_compression=0),
        "alpha_enc_q50_1x9": enc(s(1, 9, 4, 54), quality=50),
        "alpha_pil_lossy_29x41": _pil(s(29, 41, 4, 55), quality=70),
        # VP8X with ICCP and EXIF chunks (skipped) before the frame
        "vp8x_icc_exif_39x27": _pil(s(39, 27, 3, 56), quality=80,
                                    icc_profile=b"\0" * 128,
                                    exif=b"Exif\0\0" + bytes(30)),
        "vp8x_ll_exif_27x39": _pil(s(27, 39, 3, 57), lossless=True,
                                   exif=b"Exif\0\0" + bytes(31)),
    }
    lossy = enc(s(31, 45, 3, 60), quality=80)
    a = alpha_of(31, 45, 61)
    for filt, name in enumerate(("none", "horizontal", "vertical",
                                 "gradient")):
        out[f"alpha_raw_{name}_45x31"] = with_alpha(lossy, a, filt, False)
        out[f"alpha_vp8l_{name}_45x31"] = with_alpha(lossy, a, filt, True)
    # animated: two frames (the port raises NotImplementedError)
    buf = io.BytesIO()
    frames = [Image.fromarray(s(24, 32, 3, 70 + k)) for k in range(2)]
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=100, lossless=True)
    out["animated_32x24"] = buf.getvalue()
    return out


def vedai_q90(enc: Encoder) -> dict:
    """`vedai_q90/<stem>_co.webp` / `_ir.webp` -> bytes (module doc)."""
    from sodt_tpu_torch.data import SyntheticVedai
    out = {}
    for ds, stems in ((SyntheticVedai(n=16, img_size=512, nc=8, seed=1),
                       [f"{i:08d}" for i in range(4)]),
                      (SyntheticVedai(n=1, img_size=1024, nc=8, seed=2),
                       ["00001024"])):
        for i, stem in enumerate(stems):
            rgb, ir, _ = ds[i]
            out[f"{stem}_co.webp"] = enc(rgb, quality=90)
            out[f"{stem}_ir.webp"] = enc(np.repeat(ir[..., :1], 3, -1),
                                         quality=90)
    return out


def main():
    enc = Encoder()
    made = fixtures(enc)
    for name, data in made.items():
        (HERE / f"{name}.webp").write_bytes(data)
    folder = HERE / "vedai_q90"
    folder.mkdir(exist_ok=True)
    for name, data in vedai_q90(enc).items():
        (folder / name).write_bytes(data)
    if enc.version != ENCODER_VERSION:
        print(f"note: written with libwebp {enc.version:#x}, not "
              f"{ENCODER_VERSION:#x}")
    print(f"{len(made)} fixtures, {sum(map(len, made.values()))} bytes")


if __name__ == "__main__":
    main()
