"""Builds `big_vision_torch/csrc/*.cu` with nvcc and loads them with ctypes.

Each source is one shared library with a plain C interface (no PyTorch
headers), so a build takes seconds. Libraries go to `build/kernels/` at the
root of the checkout, named by a hash of the source and of the shared
headers in `csrc/` (`*.cuh`), and are built at first
use in a process. `build_all()` starts one nvcc per source at once.

Every C entry point takes its pointers and the CUDA stream as `void*`,
launches on that stream, and returns `cudaGetLastError()`; `check()` turns
a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
  if home and (Path(home) / "bin" / "nvcc").exists():
    return str(Path(home) / "bin" / "nvcc")
  found = shutil.which("nvcc") or (
      "/usr/local/cuda/bin/nvcc"
      if Path("/usr/local/cuda/bin/nvcc").exists() else None)
  if found is None:
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
  return found


def _target(name: str) -> tuple[Path, Path]:
  """(csrc/<name>.cu, its library, named by a hash of the source, the
  headers of csrc/ and the flags)."""
  src = _CSRC / f"{name}.cu"
  digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
  for header in sorted(_CSRC.glob("*.cuh")):
    digest.update(header.read_bytes())
  return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
  """Starts nvcc for csrc/<name>.cu; returns (process or None, lib path)."""
  src, lib = _target(name)
  if lib.exists():
    return None, lib
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = lib.with_suffix(f".{os.getpid()}.tmp")
  cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
  proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
  return (proc, tmp), lib


def _finish(name, started, lib) -> str:
  if started is None:
    return ""
  proc, tmp = started
  out, _ = proc.communicate()
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
  os.replace(tmp, lib)
  return out


def build_all(names) -> dict[str, str]:
  """Builds the named sources in parallel; returns nvcc's output by name."""
  started = {n: _start(n) for n in names}
  logs = {}
  for n, (s, lib) in started.items():
    logs[n] = _finish(n, s, lib)
  return logs


def load(name: str) -> ctypes.CDLL:
  """Returns the library for csrc/<name>.cu, building it if needed."""
  if name not in _loaded:
    started, lib = _start(name)
    _finish(name, started, lib)
    _loaded[name] = ctypes.CDLL(str(lib))
  return _loaded[name]


def check(err: int, what: str) -> None:
  if err != 0:
    raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
  """The current CUDA stream of `device` as an address, by the raw lookup:
  `torch.cuda.current_stream` builds a Stream object on every call, which
  costs the host several times as much."""
  import torch
  return torch._C._cuda_getCurrentRawStream(device.index)
