"""VEDAI paired RGB+IR folders on the host (`sodt_tpu/data/vedai.py`).

A fold list names the RGB images (`*_co.png`, `*_co.jpg`, ...); the IR image
is the `*_ir` file beside each, the label `labels/<stem>.txt` beside `images/`
(`class cx cy w h`, normalized, one object a line). Items are the RGB and
IR images resized so that the longest side is `img_size`, in the dtype
`_read_image` gives (uint8 mostly; a 16-bit IR stays uint16, a float or
signed one float32 or int16, as in JAX), and the (n, 5) labels.

Decoding is the port's own (the card's machine has neither cv2 nor PIL),
chosen by the file's signature as cv2 chooses it, and `_read_image` returns
what JAX's `_read_image` returns:
  PNG   `png.read_png`: 8-bit gray (H, W, 1), RGB (H, W, 3), RGBA and gray
        + alpha (H, W, 4) as cv2 gives them; palette indices, 1-, 2-, 4-
        and 16-bit kinds as PIL gives them (`png.py`'s table);
  JPEG  the host library's decoder (`csrc/jpeg.cpp`, through
        `native_loader.decode_jpeg`): gray (H, W, 1) or RGB (H, W, 3), the
        pixels of cv2;
  BMP   the host library's decoder (`csrc/bmp.cpp`, `native_loader.
        decode_bmp`): 24- and 32-bit as cv2, palette (indices) and 16-bit
        as PIL (`bmp.py`'s table);
  TIFF  the host library's decoder (`csrc/tiff.cpp`, `native_loader.
        decode_tiff`): 8-bit gray and RGB(A), JPEG, YCbCr, CMYK, signed,
        float and 32-bit samples as cv2, palette (indices), 1-, 2-, 4- and
        16-bit as PIL (`tiff.py`'s table);
  WebP  the host library's decoder (`csrc/webp.cpp`, `native_loader.
        decode_webp`): lossy and lossless, (H, W, 3) RGB, or (H, W, 4) A R
        G B with alpha, the pixels of cv2 (`webp.py`'s table); an animated
        WebP raises NotImplementedError naming "animated WebP".
Where the host library does not build, a JPEG, BMP, TIFF or WebP read
raises with the compiler's words; it never falls back to the numpy
decoders. A DNG (a TIFF named .dng) reads as its IFD0 reads as a TIFF, as
cv2 and PIL read it: neither develops a raw IFD0 (CFA, LinearRaw), and
neither does the port (`tiff.py`'s table). The resize is
the port's own too (`resize.resize_longest`, cv2's arithmetic for every
dtype cv2 resizes, IPP's where cv2 takes it). The
integrity scan verifies each file with `verify_png`, `verify_jpeg`,
`verify_bmp`, `verify_tiff` or `verify_webp` where JAX calls PIL's
`Image.verify`, and marks the same files corrupt; `image_size` is PIL's
`Image.size` for the five. The label cache
(`<list>.labels.npz`, keyed by a sha256 over every file's path, size and
mtime) has JAX's key and layout, so each package reads the other's.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

from . import native_loader
from .bmp import bmp_size, verify_bmp
from .jpeg import jpeg_size, verify_jpeg
from .png import SIGNATURE as PNG_SIGNATURE
from .png import png_size, read_png, verify_png
from .resize import resize_longest as _resize_longest
from .tiff import SIGNATURES as TIFF_SIGNATURES
from .tiff import tiff_size, verify_tiff
from .webp import verify_webp, webp_size


def derive_ir_path(p: str) -> str:
    name = Path(p).name.replace("_co", "_ir")
    return str(Path(p).parent / name)


def derive_label_path(p: str) -> str:
    sa, sb = os.sep + "images" + os.sep, os.sep + "labels" + os.sep
    q = sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0]
    if q.endswith("_co"):
        q = q[: -len("_co")]
    return q + ".txt"


def image_format(path: str) -> str:
    """The format of a file by its signature, as cv2 and PIL tell it:
    "PNG", "JPEG", "BMP", "TIFF", "DNG" (a TIFF named .dng), "WebP", or
    "unknown"."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head.startswith(PNG_SIGNATURE):
        return "PNG"
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if head.startswith(b"BM"):
        return "BMP"
    if head[:4] in TIFF_SIGNATURES:            # classic TIFF and BigTIFF
        return "DNG" if Path(path).suffix.lower() == ".dng" else "TIFF"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    return "unknown"


def _unsupported(path: str, fmt: str):
    return NotImplementedError(
        f"{path}: a {fmt} image; the port reads PNG, JPEG, BMP, TIFF and "
        "WebP (the card's machine has no other decoder)")


# a DNG is a TIFF to cv2 and PIL, which read its IFD0 and develop no raw
_SIZES = {"PNG": png_size, "JPEG": jpeg_size, "BMP": bmp_size,
          "TIFF": tiff_size, "DNG": tiff_size, "WebP": webp_size}
_VERIFY = {"PNG": verify_png, "unknown": verify_png, "JPEG": verify_jpeg,
           "BMP": verify_bmp, "TIFF": verify_tiff, "DNG": verify_tiff,
           "WebP": verify_webp}
_DECODE = {"PNG": read_png, "JPEG": native_loader.decode_jpeg,
           "BMP": native_loader.decode_bmp, "TIFF": native_loader.decode_tiff,
           "DNG": native_loader.decode_tiff,
           "WebP": native_loader.decode_webp}


def image_size(path: str) -> tuple[int, int]:
    """(width, height) from the file's header, as PIL's `Image.size`."""
    fmt = image_format(path)
    if fmt not in _SIZES:
        raise _unsupported(path, fmt)
    return _SIZES[fmt](path)


def verify_image(path: str) -> None:
    """Raise where the JAX scan (PIL's `Image.verify` and its 10 px
    assert) marks the file corrupt."""
    fmt = image_format(path)
    if fmt not in _VERIFY:
        raise _unsupported(path, fmt)
    _VERIFY[fmt](path)


def _read_image(path: str) -> np.ndarray:
    """Decode as JAX's `_read_image` does (module doc), by the file's
    signature: PNG, JPEG, BMP, TIFF or WebP."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    fmt = image_format(path)
    if fmt not in _DECODE:
        raise _unsupported(path, fmt)
    return _DECODE[fmt](path)


class VedaiDataset:
    """Index-addressable paired dataset: (rgb, ir, labels (n, 5)), the images
    in `_read_image`'s dtype (module doc)."""

    def __init__(self, list_file: str, img_size: int = 512,
                 prefix: str | None = None):
        self.img_size = img_size
        root = Path(list_file).parent
        with open(list_file) as f:
            files = [ln.strip() for ln in f if ln.strip()]
        if prefix:
            files = [str(Path(prefix) / p) for p in files]
        # relative entries resolve against the list file's directory
        self.img_files = [
            p if os.path.isabs(p) and os.path.exists(p)
            else (p if os.path.exists(p) else str(root / Path(p).name))
            for p in files
        ]
        self.ir_files = [derive_ir_path(p) for p in self.img_files]
        self.label_files = [derive_label_path(p) for p in self.img_files]
        labels, bad = self._load_labels(list_file)
        if bad.any():
            keep = [i for i in range(len(labels)) if not bad[i]]
            self.img_files = [self.img_files[i] for i in keep]
            self.ir_files = [self.ir_files[i] for i in keep]
            self.label_files = [self.label_files[i] for i in keep]
            labels = [labels[i] for i in keep]
        self.labels = labels

    def _load_labels(self, list_file: str):
        """The labels and the corrupt-item flags, from the cache when its
        key matches, else from the integrity scan: both modalities
        verified (>= 10 px sides), labels of 5 columns, non-negative,
        normalized, without duplicate rows. A corrupt item is left out of
        the dataset and counted in the summary line."""
        cache = Path(list_file).with_suffix(".labels.npz")
        h = hashlib.sha256()
        for p in (*self.label_files, *self.img_files, *self.ir_files):
            st = os.stat(p) if os.path.exists(p) else None
            h.update(f"{p}:{st.st_size if st else -1}:"
                     f"{st.st_mtime_ns if st else 0};".encode())
        key = np.frombuffer(h.digest(), np.uint8)
        if cache.exists():
            data = np.load(cache, allow_pickle=True)
            if np.array_equal(data["key"], key) and "bad" in data:
                return list(data["labels"]), np.asarray(data["bad"], bool)
        labels, bad = [], []
        nf = nm = ne = nc = 0  # found, missing, empty, corrupt
        for im, irf, lf in zip(self.img_files, self.ir_files,
                               self.label_files):
            ok = True
            for f in (im, irf):
                if not os.path.exists(f):
                    continue  # decoded lazily; a missing pair fails there
                try:
                    verify_image(f)
                except Exception as e:
                    print(f"WARNING: corrupt image {f}: {e}")
                    ok = False
            arr = np.zeros((0, 5), np.float32)
            if not os.path.exists(lf):
                nm += 1
            else:
                try:
                    arr = np.loadtxt(lf, ndmin=2, dtype=np.float32)
                    if arr.size == 0:
                        arr = np.zeros((0, 5), np.float32)
                        ne += 1
                    else:
                        assert arr.shape[1] == 5, "labels require 5 columns"
                        assert (arr >= 0).all(), "negative labels"
                        assert (arr[:, 1:] <= 1.00001).all(), \
                            "non-normalized or out of bounds coordinates"
                        assert np.unique(arr, axis=0).shape[0] == \
                            arr.shape[0], "duplicate labels"
                        nf += 1
                except Exception as e:
                    print(f"WARNING: corrupt label {lf}: {e}")
                    arr = np.zeros((0, 5), np.float32)
                    ok = False
            if not ok:
                nc += 1
            labels.append(arr)
            bad.append(not ok)
        bad = np.asarray(bad, bool)
        if nm or ne or nc:
            print(f"Scanned {len(labels)} items: {nf} labels found, "
                  f"{nm} missing, {ne} empty, {nc} corrupt")
        try:
            np.savez(cache, key=key,
                     labels=np.asarray(labels, dtype=object), bad=bad)
        except OSError:
            pass
        return labels, bad

    def __len__(self):
        return len(self.img_files)

    def __getitem__(self, i: int):
        rgb = _resize_longest(_read_image(self.img_files[i]), self.img_size)
        ir = _resize_longest(_read_image(self.ir_files[i]), self.img_size)
        if ir.shape[-1] == 1:
            ir = np.repeat(ir, 3, axis=-1)
        elif ir.shape[-1] > 3:
            ir = ir[..., :3]
        if rgb.shape[-1] == 1:
            rgb = np.repeat(rgb, 3, axis=-1)
        return rgb, ir[..., :3], self.labels[i].copy()


def apply_single_cls(ds):
    """--single-cls: every label becomes class 0, in place. Works on any
    dataset with a `.labels` list of (n, 5) [cls, cx, cy, w, h] arrays."""
    ds.labels = [
        (np.concatenate([np.zeros((len(l), 1), np.float32),
                         np.asarray(l, np.float32)[:, 1:]], axis=1)
         if len(l) else l)
        for l in ds.labels]
    return ds
