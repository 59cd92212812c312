"""ctypes binding of the port's host library (`libsodt_tiles.so`): the tile
loader, `csrc/tile_loader.cpp`, with the JAX package's API (`available`,
`NativeTileLoader`: submit / wait / get / close; `sodt_tpu/data/
native_loader.py`), and the one-file decodes of `csrc/jpeg.cpp`
(`decode_jpeg`), `csrc/bmp.cpp` (`decode_bmp`), `csrc/tiff.cpp`
(`decode_tiff`) and `csrc/webp.cpp` (`decode_webp`).

A GIL-free worker decodes and resizes the next step's (rgb, ir) pairs while
the device runs the current one: its own PNG reader and inflate, its own
JPEG, BMP, TIFF and WebP decoders (the decoder chosen by the file's
signature), cv2's resize arithmetic, no OpenCV, no libjpeg, no libtiff, no
libwebp and no zlib. The
library is built from the repo's sources with the host compiler at first
use (`kernels._build.build_host`), on any machine with `c++` or `g++`.
Where it does not build or load, `load_error()` keeps the reason word for
word and the feed takes the Python tile source.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..kernels import _build

_lib = None
_error = None


def _load_lib():
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build.build_host()))
    except (RuntimeError, OSError) as e:
        _error = str(e)
        return None
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t]
    lib.loader_submit.restype = None
    lib.loader_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.loader_wait.restype = ctypes.c_int
    lib.loader_wait.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
    lib.loader_last_error.restype = ctypes.c_int
    lib.loader_last_error.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    ip = ctypes.POINTER(ctypes.c_int)
    lib.jpeg_file_shape.restype = ctypes.c_int
    lib.jpeg_file_shape.argtypes = [ctypes.c_char_p, ip, ip, ip, ip,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_file_decode.restype = ctypes.c_int
    lib.jpeg_file_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int]
    for fmt in ("bmp", "tiff", "webp"):
        shape = getattr(lib, f"{fmt}_file_shape")
        shape.restype = ctypes.c_int
        shape.argtypes = [ctypes.c_char_p, ip, ip, ip, ip, ctypes.c_char_p,
                          ctypes.c_int]
        fill = getattr(lib, f"{fmt}_file_decode")
        fill.restype = ctypes.c_int
        fill.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                         ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds (at first use) and loads."""
    return _load_lib() is not None


def load_error() -> str | None:
    """Why the library did not build or load (None where it did)."""
    _load_lib()
    return _error


def decode_jpeg(path, opencv46: bool = False,
                raw_cmyk: bool = False) -> np.ndarray:
    """A JPEG file -> (H, W, 1) gray or (H, W, 3) RGB uint8, the pixels of
    the JAX package's `_read_image` through cv2 (of the JAX tile loader's
    OpenCV 4.6 where `opencv46`), decoded by the host library; a CMYK or
    YCCK file gives (H, W, 4) C M Y K, libjpeg's samples, where `raw_cmyk`
    (`data/jpeg.py`'s table). Raises RuntimeError with the compiler's words where the
    library does not build, and ValueError naming the file and the cause
    where the file does not decode."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"the host library (JPEG decoder) is "
                           f"unavailable: {_error}")
    name = str(path).encode()
    err = ctypes.create_string_buffer(1024)
    h, w, c, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if not lib.jpeg_file_shape(name, ctypes.byref(h), ctypes.byref(w),
                               ctypes.byref(c), ctypes.byref(n), err,
                               len(err)):
        raise ValueError(err.value.decode(errors="replace"))
    raw = raw_cmyk and n.value == 4
    out = np.empty((h.value, w.value, 4 if raw else c.value), np.uint8)
    if not lib.jpeg_file_decode(
            name, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h.value, w.value, out.shape[2], int(opencv46) | 2 * raw, err,
            len(err)):
        raise ValueError(err.value.decode(errors="replace"))
    return out


# the sample kinds of `bmp_file_decode` / `tiff_file_decode` /
# `webp_file_decode`
_KINDS = {0: np.bool_, 1: np.uint8, 2: np.uint16, 3: np.int8, 4: np.int16,
          5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}
_NOT_IMPLEMENTED = "not implemented: "


def _decode_file(fmt: str, path) -> np.ndarray:
    """A BMP, TIFF or WebP file decoded by the host library (BMP and TIFF
    to `_read_image`'s layout, `data/bmp.py` and `data/tiff.py`; WebP to
    cv2's B G R (A)); raises RuntimeError with the
    compiler's words where the library does not build, NotImplementedError
    for a kind out of the port's scope, ValueError where the file does not
    decode."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"the host library ({fmt.upper()} decoder) is "
                           f"unavailable: {_error}")
    name = str(path).encode()
    err = ctypes.create_string_buffer(1024)
    h, w, c, kind = (ctypes.c_int() for _ in range(4))

    def fail():
        msg = err.value.decode(errors="replace")
        if _NOT_IMPLEMENTED in msg:
            raise NotImplementedError(msg.replace(_NOT_IMPLEMENTED, "", 1))
        raise ValueError(msg)

    if not getattr(lib, f"{fmt}_file_shape")(
            name, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
            ctypes.byref(kind), err, len(err)):
        fail()
    out = np.empty((h.value, w.value, c.value), _KINDS[kind.value])
    if not getattr(lib, f"{fmt}_file_decode")(
            name, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h.value, w.value, c.value, kind.value, err, len(err)):
        fail()
    return out


def decode_bmp(path) -> np.ndarray:
    """A BMP file -> what the JAX package's `_read_image` returns for it
    (`data/bmp.py`'s table), decoded by the host library (`csrc/bmp.cpp`)."""
    return _decode_file("bmp", path)


def decode_tiff(path) -> np.ndarray:
    """A TIFF file -> what the JAX package's `_read_image` returns for it
    (`data/tiff.py`'s table: bool, uint8, uint16, int8, int16, int32,
    uint32, float32 or float64 samples), decoded by the host library
    (`csrc/tiff.cpp`)."""
    return _decode_file("tiff", path)


def decode_webp(path) -> np.ndarray:
    """A WebP file -> what the JAX package's `_read_image` returns for it
    through cv2 (`data/webp.py`'s table: (H, W, 3) RGB, or (H, W, 4) A R G
    B where the file has alpha), decoded by the host library
    (`csrc/webp.cpp`); an animated file raises NotImplementedError."""
    return np.ascontiguousarray(_decode_file("webp", path)[..., ::-1])


class NativeTileLoader:
    """Decode-and-resize service over (rgb, ir) path pairs: uint8 (n, s, s,
    3) tiles, RGB, gray repeated, the longest side resized to s and the
    rest padded with 114; tiles stay cached up to `cache_gb`."""

    def __init__(self, rgb_paths: list[str], ir_paths: list[str],
                 img_size: int, cache_gb: float = 8.0):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        if len(rgb_paths) != len(ir_paths) or img_size < 1:
            raise ValueError(f"{len(rgb_paths)} rgb and {len(ir_paths)} ir "
                             f"paths at img_size {img_size}")
        self._lib = lib
        self.img_size = img_size
        self.n = len(rgb_paths)
        enc = lambda ps: (ctypes.c_char_p * len(ps))(
            *[str(p).encode() for p in ps])
        self._rgb_arr = enc(rgb_paths)   # kept alive for the worker
        self._ir_arr = enc(ir_paths)
        self._handle = lib.loader_create(
            self._rgb_arr, self._ir_arr, self.n, img_size,
            int(cache_gb * (1 << 30)))
        self._next_id = 0
        self._pending: dict[int, int] = {}

    def submit(self, indices: np.ndarray) -> int:
        idx = np.ascontiguousarray(indices, dtype=np.int32)
        if idx.ndim != 1 or (idx.size and (idx.min() < 0
                                           or idx.max() >= self.n)):
            raise IndexError(f"tile indices must be 1-D in [0, {self.n})")
        job = self._next_id
        self._next_id += 1
        self._lib.loader_submit(
            self._handle, job,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(idx))
        self._pending[job] = len(idx)
        return job

    def wait(self, job: int):
        n = self._pending.pop(job)
        s = self.img_size
        rgb = np.empty((n, s, s, 3), np.uint8)
        ir = np.empty((n, s, s, 3), np.uint8)
        ok = self._lib.loader_wait(
            self._handle, job,
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ir.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if not ok:
            buf = ctypes.create_string_buffer(4096)
            self._lib.loader_last_error(self._handle, buf, len(buf))
            detail = buf.value.decode(errors="replace") or "unknown error"
            raise RuntimeError(f"native loader job failed: {detail}")
        return rgb, ir

    def get(self, indices: np.ndarray):
        return self.wait(self.submit(indices))

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
