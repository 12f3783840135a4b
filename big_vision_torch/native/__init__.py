"""ctypes binding of the JPEG decoder in dataio.cc: port of
big_vision_tpu/native/__init__.py.

  jpeg_size(bytes) -> (h, w)
  decode_crop_resize(bytes, crop=(y0, x0, h, w) | None, out_size=(h, w) | None)
  decode_crop_resize_yuv420(bytes, crop, out) -> (y [out, out],
                                                  uv [2, out/2, out/2])
  decode_crop_resize_batch(list[bytes], crops | None, out_size) -> [N, H, W, 3]
  linked_library() -> path of the libjpeg the decoder links

The calls release the GIL while they decode. dataio.cc is built with
`g++ -O3` at first use into `build/native/` at the root of the checkout,
named by a hash of the sources, the flags and the library. It compiles
against the libjpeg-turbo 2.1.5 headers beside it (ABI 62, README.ijg)
and links the first library found of:
  1. the system's `libjpeg.so.62`, where `ldconfig -p` lists one;
  2. Pillow's bundled `pillow.libs/libjpeg-*.so.62*`, by full path, with
     an rpath to its directory.
Where neither is found, or g++ fails, or the library's decompress struct
differs from the headers' ("JPEG parameter struct mismatch"), the first
call raises an error that says so. Unlike the JAX package, whose
`available()` turns such an error into a PIL fallback, the port has no
fallback for a JPEG.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SOURCES = ("dataio.cc", "jpeglib.h", "jmorecfg.h", "jerror.h", "jconfig.h")
BUILD_DIR = _HERE.parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_INT, _SIZE, _U8P = ctypes.c_int, ctypes.c_size_t, ctypes.POINTER(
    ctypes.c_uint8)
_INTP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {  # dataio.cc's C entry points; each returns an int
    "bvt_jpeg_size": [ctypes.c_char_p, _SIZE, _INTP, _INTP],
    "bvt_decode_crop_resize": [ctypes.c_char_p, _SIZE] + [_INT] * 6 + [_U8P],
    "bvt_decode_crop_resize_yuv420": [ctypes.c_char_p, _SIZE] + [_INT] * 5
                                     + [_U8P, _U8P],
    "bvt_decode_crop_resize_batch": [
        _INT, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(_SIZE), _INTP,
        _INT, _INT, _U8P, _INT],
}

_LIB = None
_LIBJPEG = None
_LOCK = threading.Lock()


def _system_libjpeg():
  """The path of the system's libjpeg.so.62 that `ldconfig -p` lists for
  this machine's word size, or None."""
  ldconfig = shutil.which("ldconfig") or next(
      (p for p in ("/sbin/ldconfig", "/usr/sbin/ldconfig")
       if os.path.exists(p)), None)
  if ldconfig is None:
    return None
  try:
    out = subprocess.run([ldconfig, "-p"], capture_output=True, text=True,
                         check=True).stdout
  except (OSError, subprocess.CalledProcessError):
    return None
  want_64 = ctypes.sizeof(ctypes.c_void_p) == 8
  for line in out.splitlines():
    m = re.match(r"\s*libjpeg\.so\.62 \(([^)]*)\) => (\S+)", line)
    if m and ("64" in m.group(1)) == want_64 and os.path.exists(m.group(2)):
      return m.group(2)
  return None


def _pillow_libjpeg():
  """The path of the libjpeg of ABI 62 that Pillow's wheel bundles, or
  None (found without importing PIL)."""
  spec = importlib.util.find_spec("PIL")
  if spec is None or not spec.submodule_search_locations:
    return None
  site = Path(next(iter(spec.submodule_search_locations))).parent
  found = sorted(glob.glob(str(site / "pillow.libs" / "libjpeg-*.so.62*")))
  return found[0] if found else None


def find_libjpeg():
  """The libjpeg that dataio.cc links: the system's, else Pillow's."""
  for find in (_system_libjpeg, _pillow_libjpeg):
    path = find()
    if path:
      return path
  raise RuntimeError(
      "no libjpeg of ABI 62 to link the JPEG decoder with: `ldconfig -p` "
      "lists no libjpeg.so.62 and Pillow's wheel bundles no "
      "pillow.libs/libjpeg-*.so.62*")


def _target(libjpeg):
  digest = hashlib.sha1(" ".join(CXX_FLAGS + (libjpeg,)).encode())
  for name in _SOURCES:
    digest.update((_HERE / name).read_bytes())
  return BUILD_DIR / f"dataio-{digest.hexdigest()[:12]}.so"


def _build(libjpeg, out):
  cxx = os.environ.get("CXX") or shutil.which("g++")
  if cxx is None:
    raise RuntimeError("g++ not found: the JPEG decoder (dataio.cc) is "
                       "built with it at first use")
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
  cmd = [cxx, *CXX_FLAGS, f"-I{_HERE}", str(_HERE / "dataio.cc"), "-o",
         str(tmp), libjpeg, f"-Wl,-rpath,{os.path.dirname(libjpeg)}"]
  proc = subprocess.run(cmd, capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"building the JPEG decoder failed:\n{' '.join(cmd)}"
                       f"\n{proc.stderr[-4000:]}")
  os.replace(tmp, out)


def _load():
  """The decoder's library, built and checked on first use."""
  global _LIB, _LIBJPEG
  if _LIB is not None:
    return _LIB
  with _LOCK:
    if _LIB is None:
      libjpeg = find_libjpeg()
      out = _target(libjpeg)
      if not out.exists():
        _build(libjpeg, out)
      lib = ctypes.CDLL(str(out))
      for fn, args in _SIGNATURES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
      lib.bvt_last_error.argtypes = []
      lib.bvt_last_error.restype = ctypes.c_char_p
      # An empty input fails in jpeg_mem_src, after jpeg_CreateDecompress
      # has compared the struct sizes.
      lib.bvt_jpeg_size(b"", 0, ctypes.byref(ctypes.c_int()),
                        ctypes.byref(ctypes.c_int()))
      msg = lib.bvt_last_error().decode()
      if "mismatch" in msg:
        raise RuntimeError(f"the JPEG decoder's headers disagree with "
                           f"{libjpeg}: {msg}")
      _LIB, _LIBJPEG = lib, libjpeg
  return _LIB


def linked_library():
  """The path of the libjpeg that the decoder links (built if need be)."""
  _load()
  return _LIBJPEG


def _failed(what):
  return ValueError(f"{what}: {_LIB.bvt_last_error().decode()}")


def jpeg_size(data: bytes):
  """(height, width) from the JPEG header."""
  lib = _load()
  h, w = ctypes.c_int(), ctypes.c_int()
  if lib.bvt_jpeg_size(data, len(data), ctypes.byref(h), ctypes.byref(w)):
    raise _failed("Corrupt JPEG header")
  return h.value, w.value


def _u8(arr):
  return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_crop_resize(data: bytes, crop=None, out_size=None) -> np.ndarray:
  """Decode, then an optional crop (y0, x0, h, w in the image's
  coordinates), then an optional bilinear resize to out_size; uint8 RGB."""
  lib = _load()
  if crop is None and out_size is None:
    out_h, out_w = jpeg_size(data)
    y0 = x0 = ch = cw = 0
  else:
    y0, x0, ch, cw = crop if crop is not None else (0, 0, 0, 0)
    out_h, out_w = out_size if out_size is not None else (ch, cw)
  out = np.empty((out_h, out_w, 3), np.uint8)
  if lib.bvt_decode_crop_resize(data, len(data), y0, x0, ch, cw, out_h,
                                out_w, _u8(out)):
    raise _failed("JPEG decode failed")
  return out


class NotYuv420(ValueError):
  """The JPEG is not YCbCr 4:2:0 or 4:4:4 (decode to RGB instead)."""


def decode_crop_resize_yuv420(data: bytes, crop, out: int):
  """The JPEG's raw YCbCr planes, cropped (y0, x0, h, w) and resized:
  (y [out, out], uv [2, out/2, out/2]) uint8. Raises NotYuv420 where the
  JPEG is not YCbCr 4:2:0 or 4:4:4."""
  lib = _load()
  assert out % 2 == 0, out
  y0, x0, ch, cw = crop if crop is not None else (0, 0, 0, 0)
  y_out = np.empty((out, out), np.uint8)
  uv_out = np.empty((2, out // 2, out // 2), np.uint8)
  rc = lib.bvt_decode_crop_resize_yuv420(data, len(data), y0, x0, ch, cw,
                                         out, _u8(y_out), _u8(uv_out))
  if rc == 2:
    raise NotYuv420("not a YCbCr 4:2:0 or 4:4:4 JPEG")
  if rc:
    raise _failed("JPEG decode failed")
  return y_out, uv_out


def decode_crop_resize_batch(datas, crops, out_size, nthreads=None):
  """Decodes a list of JPEGs on `nthreads` threads of the library; crops is
  an [N, 4] int array or None. Returns [N, H, W, 3] uint8."""
  lib = _load()
  n = len(datas)
  out_h, out_w = out_size
  out = np.empty((n, out_h, out_w, 3), np.uint8)
  data_ptrs = (ctypes.c_char_p * n)(*datas)
  lens = (ctypes.c_size_t * n)(*[len(d) for d in datas])
  crops_ptr = None
  if crops is not None:
    crops = np.ascontiguousarray(crops, np.int32)
    crops_ptr = crops.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
  nthreads = nthreads or min(n, os.cpu_count() or 1)
  failures = lib.bvt_decode_crop_resize_batch(
      n, ctypes.cast(data_ptrs, ctypes.POINTER(ctypes.c_char_p)), lens,
      crops_ptr, out_h, out_w, _u8(out), nthreads)
  if failures:
    raise ValueError(f"{failures}/{n} JPEG decodes failed")
  return out
