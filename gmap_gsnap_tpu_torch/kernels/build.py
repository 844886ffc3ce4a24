"""Build and bind the port's hand-written CUDA kernels.

Modelled on ``gmap_gsnap_tpu/native/__init__.py``: the sources under
``gmap_gsnap_tpu_torch/csrc/`` are compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The library
name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded.  The build directory
(``kernels/_build``) is listed in ``.gitignore``.

Every C entry point launches one kernel on the stream it is given and
returns ``cudaGetLastError()``; :func:`launch` raises when that is not
0, and counts the launch in :data:`LAUNCHES`.  A failure to build or to
launch raises: there is no fallback to the plain torch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from collections import Counter

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# launches per kernel in this process (reset with LAUNCHES.clear())
LAUNCHES: Counter = Counter()

# argument kinds of each C entry point: p = device pointer (or None),
# i = int32, l = int64.  The stream is appended to every call.
_SIGNATURES = {
    "gsnap_seed_diagonals": "p" * 10 + "i" * 7 + "ll",
    "gsnap_top_diagonals": "p" * 5 + "i" * 4,
    "gsnap_prefix_mismatches": "p" * 10 + "ll" + "i" * 7,
    "gsnap_solve_indels": "p" * 18 + "i" * 8,
    "gsnap_solve_splices": "p" * 18 + "l" + "i" * 4,
    "gsnap_select_triples": "p" * 6 + "i" * 3 + "l",
    "gsnap_solve_doublesplices": "p" * 24 + "l" + "i" * 4,
    "gsnap_pair_grid": "p" * 28 + "i" * 6,
}

_lib = None
build_seconds: float | None = None
build_log: str = ""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> list[str]:
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def library() -> ctypes.CDLL:
    """The kernel library, compiled on first use."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libgsnap_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.time()
    if not os.path.exists(so):
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               *[s for s in srcs if s.endswith(".cu")]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int32, "l": ctypes.c_int64}
    for name, sig in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [kinds[c] for c in sig] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.gsnap_error_string.argtypes = [ctypes.c_int]
    lib.gsnap_error_string.restype = ctypes.c_char_p
    build_seconds = time.time() - t0
    _lib = lib
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream.

    Tensors pass as their data pointers (they must stay alive until the
    kernel has run; the caller holds them), None as a null pointer."""
    sig = _SIGNATURES[name]
    if len(args) != len(sig):
        raise TypeError(f"{name}: {len(args)} arguments, expected {len(sig)}")
    conv = []
    for kind, a in zip(sig, args):
        if kind == "p":
            if a is None:
                conv.append(None)
            else:
                if a.device != device or not a.is_contiguous():
                    raise ValueError(
                        f"{name}: tensor on {a.device} (contiguous="
                        f"{a.is_contiguous()}), expected contiguous on {device}")
                conv.append(a.data_ptr())
        else:
            conv.append(int(a))
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*conv, stream)
    if rc != 0:
        msg = lib.gsnap_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1
