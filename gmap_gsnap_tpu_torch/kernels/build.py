"""Build and bind the port's hand-written CUDA kernels.

Modelled on ``gmap_gsnap_tpu/native/__init__.py``: the sources under
``gmap_gsnap_tpu_torch/csrc/`` are compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a``, one nvcc process per
``.cu`` file, all started together, and linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library
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
              "-O3", "-lineinfo", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

# launches per kernel in this process (reset with LAUNCHES.clear())
LAUNCHES: Counter = Counter()

# argument kinds of each C entry point: p = device pointer (or None),
# i = int32, l = int64.  The stream is appended to every call.
_SIGNATURES = {
    "gsnap_seed_diagonals": "p" * 10 + "i" * 7 + "ll",
    "gsnap_top_diagonals": "p" * 5 + "i" * 4,
    "gsnap_prefix_mismatches": "p" * 10 + "ll" + "i" * 7,
    "gsnap_solve_indels": "p" * 18 + "i" * 8,
    "gsnap_solve_splices": "p" * 22 + "ll" + "i" * 5,
    "gsnap_select_triples": "p" * 6 + "i" * 3 + "l",
    "gsnap_solve_doublesplices": "p" * 28 + "ll" + "i" * 5,
    "gsnap_pair_grid": "p" * 28 + "i" * 6,
    "gmap_seed_segments": "p" * 11 + "i" * 6 + "ll" + "ii",
    "gmap_chain": "p" * 10 + "i" * 5,
    "gmap_banded_gotoh": "p" * 12 + "i" * 6,
    "gmap_bridge_traceback": "p" * 21 + "i" * 8,
    "gsnap_lane_features": "p" * 16 + "i" * 6,
    "gsnap_rank_hits": "p" * 34 + "i" * 14,
    "gsnap_qpos_ranges": "p" * 5 + "i" * 3,
    "gsnap_select_pairs": "p" * 5 + "i" * 4 + "li",
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
        objdir = tempfile.mkdtemp(dir=BUILD_DIR)
        cus = [s for s in srcs if s.endswith(".cu")]
        objs = [os.path.join(objdir, os.path.basename(s)[:-3] + ".o")
                for s in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(cus, objs)]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [(s, p.returncode, log) for s, p, log in zip(cus, procs, logs)
                  if p.returncode != 0]
        if not failed:
            tmp = os.path.join(objdir, "lib.so")
            link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            build_log += link.stdout + link.stderr
            if link.returncode != 0:
                failed = [("link", link.returncode, link.stdout + link.stderr)]
        if failed:
            shutil.rmtree(objdir, ignore_errors=True)
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{s} ({rc}):\n{log}" for s, rc, log in failed))
        os.replace(tmp, so)
        shutil.rmtree(objdir, ignore_errors=True)
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
