"""Build kernels of ``gmap_gsnap_tpu_torch/csrc`` for the CPU emulation
in this directory (``cuda_runtime.h``) and drive them through the port's
own ``_X_cuda`` wrappers on CPU tensors.

The .cu files are rewritten (``extern __shared__`` arrays become the
emulation's dynamic buffer, ``kernel<<<grid, block, smem, stream>>>(...)``
a call of ``emu_launch``) and compiled with ``g++ -std=c++20`` into one
shared library; :func:`use` points ``kernels.build.launch`` at it.  A
kernel's logic can so be held against its plain version before the
first run on the card; its speed, and whatever the GPU compiler refuses,
show only there.

    python tools/cuda_emu/emu_build.py OUTDIR rank_hits top_diagonals

(``tools/cuda_emu/rehearse_rank_select.py`` drives K2 and K14 so.)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
CSRC = os.path.join(REPO, "gmap_gsnap_tpu_torch", "csrc")


def _split_top(text: str) -> list[str]:
    """Comma-separated parts of text outside parentheses."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
            continue
        depth += (ch == "(") - (ch == ")")
        cur += ch
    return parts + [cur.strip()]


def rewrite(src: str) -> str:
    """A .cu source as C++ for the emulation."""
    import re

    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)emu_dyn.data();", src)
    out, i = [], 0
    while (j := src.find("<<<", i)) >= 0:
        start = max(src.rfind(c, 0, j) for c in ";{}") + 1
        k = src.find(">>>", j)
        cfg = (_split_top(src[j + 3:k]) + ["0"] * 4)[:3]
        p = q = k + 3
        depth = 0
        while True:
            depth += (src[q] == "(") - (src[q] == ")")
            if depth == 0 and src[q] == ")":
                break
            q += 1
        out += [src[i:start], f"\n  emu_launch(dim3({cfg[0]}), dim3({cfg[1]}), "
                f"{cfg[2]}, [&] {{ {src[start:j].strip()}{src[p:q + 1]}; }})"]
        i = q + 1
    return "".join(out) + src[i:]


def build(names: list[str], outdir: str) -> str:
    """Compile csrc/<name>.cu for each name into outdir/libemu.so."""
    os.makedirs(outdir, exist_ok=True)
    cpps = []
    for name in names:
        with open(os.path.join(CSRC, name + ".cu")) as f:
            cpp = os.path.join(outdir, name + ".cpp")
            with open(cpp, "w") as g:
                g.write(rewrite(f.read()))
        cpps.append(cpp)
    err = os.path.join(outdir, "error_string.cpp")
    with open(err, "w") as g:
        if "seed_diagonals" not in names:  # which defines its own
            g.write('extern "C" const char* gsnap_error_string(int) '
                    '{ return "emulated launch failed"; }\n')
    so = os.path.join(outdir, "libemu.so")
    # -ffp-contract=off: no product fused into a sum, as nvcc's __f*_rn;
    # one g++ a source, all started together, then the link
    flags = ["-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-pthread",
             "-I", HERE, "-I", CSRC]
    objs = [c[:-4] + ".o" for c in cpps + [err]]
    procs = [subprocess.Popen(["g++", *flags, "-c", c, "-o", o])
             for c, o in zip(cpps + [err], objs)]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("g++ failed on an emulated kernel")
    subprocess.run(["g++", "-shared", "-pthread", *objs, "-o", so],
                   check=True)
    return so


def use(so: str) -> None:
    """Point kernels.build.launch at the emulated entry points in so
    (CPU tensors; the stream is a null pointer)."""
    sys.path.insert(0, REPO)
    from gmap_gsnap_tpu_torch.kernels import build as kbuild

    lib = ctypes.CDLL(so)
    kinds = {"p": ctypes.c_void_p, "h": ctypes.c_void_p,
             "i": ctypes.c_int32, "l": ctypes.c_int64}
    entries = {}
    for entry, sig in kbuild._SIGNATURES.items():
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes = [kinds[c] for c in sig] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            entries[entry] = fn

    def launch(name, device, *args):
        sig = kbuild._SIGNATURES[name]
        if len(args) != len(sig):
            raise TypeError(f"{name}: {len(args)} arguments, expected "
                            f"{len(sig)}")
        conv, tables = [], []
        for kind, a in zip(sig, args):
            if kind == "h":
                tables.append((ctypes.c_int64 * len(a))(*a))
                conv.append(ctypes.addressof(tables[-1]))
            elif kind == "p":
                conv.append(None if a is None else a.data_ptr())
            else:
                conv.append(int(a))
        rc = entries[name](*conv, None)
        if rc != 0:
            raise RuntimeError(f"{name}: emulated launch refused ({rc})")
        kbuild.LAUNCHES[name] += 1

    kbuild.launch = launch


if __name__ == "__main__":
    print(build(sys.argv[2:], sys.argv[1]))
