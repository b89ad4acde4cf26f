"""The port's host image code in C++ (counterpart of fsvlm_tpu.native and of
the PIL calls of the JAX package's data layer), through ctypes.

The card's machine has neither libjpeg's header nor its library, nor any
other image library, so every decoder is the port's own C++ and links
nothing: ``csrc/jpeg_decoder.cpp`` (baseline, progressive and lossless
JPEG, Huffman and arithmetic coded, with libjpeg's block smoothing),
``csrc/png_decoder.cpp`` (all of PNG, its inflate included, which the TIFF
decoder's Deflate strips share), ``csrc/bmp_decoder.cpp``,
``csrc/pnm_decoder.cpp`` (P1-P6), ``csrc/gif_decoder.cpp`` (the first
frame), ``csrc/tiff_decoder.cpp`` (the first IFD of a classic or a
BigTIFF: none, PackBits, LZW, Deflate, JPEG (through the JPEG decoder),
old-style JPEG and CCITT (``csrc/ccitt_decoder.cpp``); signed, float,
12- and 32-bit samples, YCbCr through libtiff's RGBA conversion, LAB
through LittleCMS's) and ``csrc/webp_decoder.cpp`` (the RIFF container,
ALPH and an animation's first frame, over ``csrc/vp8l_decoder.cpp``, lossless, and
``csrc/vp8_decoder.cpp``, lossy with libwebp's fancy upsampling: libwebp
1.6.0 as Pillow 12.1 uses it); ``csrc/imaging.cpp`` holds the per-pixel passes of
``data/imageops.py``'s Pillow-exact image operations (resampling with a
box, the affine transform, the Gaussian blur, HSV, the 3x3 filter, blend,
L and lookup tables).  All are compiled with ``g++`` at first use into one
library in ``fsvlm_tpu_torch/_build/`` (listed in ``.gitignore``), named by
a hash of sources, headers and flags, and loaded once.  A failed build
raises with the compiler's output; nothing falls back to another decoder.

- ``read_image(path)``: the full-resolution RGB image of a JPEG, PNG, BMP,
  Netpbm, GIF, TIFF or WebP file (told apart by their magic bytes, whatever
  the extension) as an (H, W, 3) uint8 array, byte-equal to Pillow 12.1's
  ``Image.open(path).convert("RGB")``, each format as Pillow reads and
  converts it (each decoder's header says how);
- ``decode_file(path, pre_size)``: the (P, P, 3) uint8 device-aug cache
  view of a JPEG, byte-equal to ``fsvlm_tpu.native.decode_file`` (DCT-domain
  downscale, float bilinear resize of the shorter edge, centre crop), or
  None where the JAX package's libjpeg build has no output either: a CMYK,
  YCCK or lossless JPEG, and every other format.  The loader then resizes
  the full decode as Pillow's bilinear.

Both release the GIL for the decode, so a thread pool decodes in parallel;
so does every imaging pass (ctypes drops the GIL for each foreign call).
Every decoder checks Pillow's decompression-bomb limit (more than twice
``MAX_IMAGE_PIXELS`` raises) before it sizes a buffer.  A missing file
raises ``IOError``; corrupt or truncated data, and a layout Pillow 12.1
refuses too, raise ``ValueError``; a file in another format, and a
variant of a read format that Pillow reads but the port does not yet
(``_UNSUPPORTED``: TIFF's LZMA, ZSTD, WebP, Thunderscan and SGILog
compressions), raise ``NotImplementedError`` naming ROADMAP A16.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

ROUTE = "B"  # the repo's own decoder; route A would link the machine's libjpeg
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = [os.path.join(CSRC, f) for f in (
    "jpeg_decoder.cpp", "png_decoder.cpp", "bmp_decoder.cpp", "pnm_decoder.cpp",
    "gif_decoder.cpp", "tiff_decoder.cpp", "ccitt_decoder.cpp", "webp_decoder.cpp",
    "vp8l_decoder.cpp", "vp8_decoder.cpp", "imaging.cpp")]
HEADERS = [os.path.join(CSRC, "host_common.h")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off", "-Wall"]

_lib = None
_build_info = None
_lock = threading.Lock()
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.c_int64
# the imaging passes' C signatures (csrc/imaging.cpp)
_IMAGING = {
    "fsvlm_resample": [_U8P, _I64, _I64, _I64, ctypes.c_int, *[ctypes.c_float] * 4, _I64, _I64,
                       _U8P],
    "fsvlm_affine_nearest": [_U8P, _I64, _I64, _I64, _F64P, _I64, _I64, _U8P],
    "fsvlm_gaussian_blur": [_U8P, _I64, _I64, _I64, ctypes.c_float, _U8P],
    "fsvlm_rgb_to_hsv": [_U8P, _I64, _U8P],
    "fsvlm_hsv_to_rgb": [_U8P, _I64, _U8P],
    "fsvlm_filter3x3": [_U8P, _I64, _I64, _I64, _F32P, ctypes.c_float, _U8P],
    "fsvlm_blend": [_U8P, _U8P, _I64, ctypes.c_float, _U8P],
    "fsvlm_grayscale": [_U8P, _I64, ctypes.c_int, _U8P],
    "fsvlm_lut": [_U8P, _I64, _I64, _U8P, _U8P],
}

# the decoders' return codes (csrc/host_common.h's Status)
NO_RGB, CORRUPT, UNSUPPORTED, NO_MEMORY, TOO_LARGE, REFUSED = 1, 2, 3, 5, 6, 7

# each format by its magic bytes, and the prefix of its C pair
# fsvlm_<prefix>_size / fsvlm_<prefix>_decode_full
_MAGIC = [(b"\xff\xd8", "JPEG"), (b"\x89PNG\r\n\x1a\n", "PNG"), (b"GIF87a", "GIF"),
          (b"GIF89a", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
          (b"II+\x00", "TIFF"), (b"MM\x00+", "TIFF")]  # the last two BigTIFF
_PREFIX = {"JPEG": "jpeg", "PNG": "png", "BMP": "bmp", "Netpbm": "pnm", "GIF": "gif",
           "TIFF": "tiff", "WebP": "webp"}
_UNSUPPORTED = {
    "JPEG": "a JPEG variant the port's decoder does not read (hierarchical, 12-bit or "
            "arithmetic-coded lossless, which Pillow does not read either, or lossless with "
            "subsampled components)",
    "PNG": "a PNG whose compression, filter or interlace method the PNG specification does "
           "not define",
    "TIFF": "a TIFF compressed as the port's decoder does not read yet (LZMA, ZSTD, WebP, "
            "Thunderscan or SGILog; or old-style JPEG past one strip)",
}


def find_cxx():
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the port's host C++ is built from "
                           f"{CSRC} at first use (set CXX or put g++ on PATH)")
    return cxx


def library_path():
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libfsvlm_host-{h.hexdigest()[:16]}.so")


def build():
    """Compile the library unless it is built already: one g++ per source,
    all started together, then the link.  Returns {"path", "seconds",
    "log"}; raises with the compiler's output if it fails."""
    out = library_path()
    if os.path.isfile(out):
        return {"path": out, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    objects = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    t0 = time.perf_counter()
    cxx = find_cxx()
    try:
        procs = [subprocess.Popen([cxx, *CXX_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objects)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [(src, p.returncode) for src, p in zip(SOURCES, procs) if p.returncode != 0]
        if not failed:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *objects], capture_output=True,
                                  text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed = [("the link", proc.returncode)]
        if failed:
            raise RuntimeError(f"g++ failed for {failed} (sources {SOURCES}):\n{log}")
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)
    return {"path": out, "seconds": time.perf_counter() - t0, "log": log}


def load():
    """The library's ctypes handle, built and loaded on the first call."""
    global _lib, _build_info
    with _lock:
        if _lib is None:
            _build_info = build()
            lib = ctypes.CDLL(_build_info["path"])
            lib.fsvlm_jpeg_size.argtypes = [_U8P, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_int)]
            lib.fsvlm_jpeg_decode_full.argtypes = [_U8P, ctypes.c_long, ctypes.c_int,
                                                   ctypes.c_int, _U8P]
            lib.fsvlm_jpeg_file_resize_crop.argtypes = [ctypes.c_char_p, ctypes.c_int, _U8P]
            decoders = [lib.fsvlm_jpeg_file_resize_crop]
            for prefix in _PREFIX.values():
                size, full = (getattr(lib, f"fsvlm_{prefix}_{k}") for k in ("size",
                                                                            "decode_full"))
                size.argtypes = lib.fsvlm_jpeg_size.argtypes
                full.argtypes = lib.fsvlm_jpeg_decode_full.argtypes
                decoders += [size, full]
            for name, args in _IMAGING.items():
                getattr(lib, name).argtypes = args
            for fn in (*decoders, *(getattr(lib, n) for n in _IMAGING)):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_info():
    """The route and the build: {"route", "source", "path", "seconds"}."""
    load()
    return {"route": ROUTE, "source": os.path.relpath(SOURCES[0], os.path.dirname(BUILD_DIR)),
            "path": _build_info["path"], "seconds": _build_info["seconds"]}


def _kind(data):
    """The format of a file's first bytes, or None."""
    kind = next((k for m, k in _MAGIC if data.startswith(m)), None)
    if kind is None and data[:1] == b"P" and data[1:2] in (b"1", b"2", b"3", b"4", b"5", b"6"):
        kind = "Netpbm"
    if kind is None and data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        kind = "WebP"
    return kind


def _read(path, head=None):
    """The file's bytes (its first ``head`` bytes if given) and its format
    by its magic bytes; raises for a format the port does not read."""
    if not os.path.exists(path):
        raise IOError(f'No file exists at "{path}"')
    with open(path, "rb") as f:
        data = f.read(head) if head else f.read()
    kind = _kind(data)
    if kind is None:
        raise NotImplementedError(
            f'"{path}" is in no format the port reads: it decodes JPEG, PNG, BMP, Netpbm, GIF, '
            "TIFF and WebP, all but the TIFF compressions ROADMAP A16 leaves (LZMA, ZSTD, WebP, "
            "Thunderscan, SGILog)")
    return data, kind


def _check(rc, path, kind):
    if rc == CORRUPT:
        raise ValueError(f'corrupt or truncated {kind} data in "{path}"')
    if rc == REFUSED:
        raise ValueError(f'"{path}" is a {kind} layout that Pillow 12.1 refuses too, so the '
                         "JAX package reads it no more than the port")
    if rc == UNSUPPORTED:
        raise NotImplementedError(f'"{path}" is {_UNSUPPORTED[kind]}: ROADMAP A16')
    if rc == TOO_LARGE:
        raise ValueError(f'"{path}" has more pixels than twice Pillow\'s MAX_IMAGE_PIXELS, '
                         "which Pillow refuses as a decompression bomb")
    if rc == NO_MEMORY:
        raise MemoryError(f'decoding "{path}" ran out of memory')
    if rc in (10, 11):
        raise IOError(f'Cannot read "{path}"')
    if rc != 0:
        raise ValueError(f'cannot decode "{path}" (decoder code {rc})')


def read_image(path):
    """The full-resolution RGB image of a JPEG, PNG, BMP, Netpbm, GIF, TIFF or
    WebP file: uint8 (H, W, 3)."""
    data, kind = _read(path)
    lib = load()
    size, full = (getattr(lib, f"fsvlm_{_PREFIX[kind]}_{k}") for k in ("size", "decode_full"))
    buf = np.frombuffer(data, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(size(buf.ctypes.data_as(_U8P), len(data), ctypes.byref(w), ctypes.byref(h)), path,
           kind)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(full(buf.ctypes.data_as(_U8P), len(data), w.value, h.value,
                out.ctypes.data_as(_U8P)), path, kind)
    return out


def decode_file(path, pre_size):
    """The (pre_size, pre_size, 3) uint8 cache view of a JPEG file, or None
    where the JAX package's libjpeg build has no output: a CMYK, YCCK or
    lossless JPEG (no RGB output at a DCT scale, or no lossless decoder, in
    its libjpeg) and a file in any other format."""
    _, kind = _read(path, head=12)
    if kind != "JPEG":
        return None
    lib = load()
    out = np.empty((pre_size, pre_size, 3), np.uint8)
    rc = lib.fsvlm_jpeg_file_resize_crop(os.fsencode(path), pre_size, out.ctypes.data_as(_U8P))
    if rc == NO_RGB:
        return None
    _check(rc, path, kind)
    return out


def imaging(name, *args):
    """Call the imaging pass ``fsvlm_<name>`` of csrc/imaging.cpp: numpy
    arrays go as pointers to their data (contiguous, of the pass's types:
    the caller makes them so), other arguments as they are.  The GIL is
    released for the call.  Raises if the pass refuses its arguments."""
    fn = getattr(load(), f"fsvlm_{name}")
    conv = []
    for a, t in zip(args, fn.argtypes):
        if isinstance(a, np.ndarray):
            if not a.flags.c_contiguous:
                raise ValueError(f"{name}: arrays must be contiguous")
            a = a.ctypes.data_as(t)
        conv.append(a)
    rc = fn(*conv)
    if rc != 0:
        raise ValueError(f"imaging pass {name} refused its arguments (code {rc})")
