"""Native host-side runtime kernels, loaded via ctypes.

A copy of gmap_gsnap_tpu/native/__init__.py for the port's own
``hostops.c``.  Compiled on first use (cc -O3 -shared) into
``native/_build/`` (listed in .gitignore); None when no compiler is
available.  The SAM assembly keeps a Python path for that case; the gamma
offset coder raises beyond toy oligospaces instead (db/indexdb.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(__file__)
_BUILD = os.path.join(_DIR, "_build")
_SO = os.path.join(_BUILD, "libhostops.so")
_SRC = os.path.join(_DIR, "hostops.c")

_lib = None
_tried = False


def get_lib():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{_SO}.{os.getpid()}"
            subprocess.run(
                ["cc", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        lib.gamma_expand_offsets.restype = ctypes.c_int
        lib.gamma_expand_offsets.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint64,
            ctypes.c_uint32,
        ]
        lib.gamma_pack_offsets.restype = ctypes.c_int64
        lib.gamma_pack_offsets.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint64,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.sam_sub_lines.restype = ctypes.c_long
        lib.sam_sub_lines.argtypes = [
            ctypes.c_long,
            ctypes.c_char_p, u32p, u32p,           # labels
            u8p, ctypes.c_char_p, ctypes.c_long,   # seq, qual, lmax
            i32p, u8p,                             # L, hasq
            ctypes.c_char_p, u32p, i32p,           # chrblob, chr_off, chridx
            i64p, i32p, i32p,                      # pos, flag, mapq
            i32p, i64p, i64p,                      # rnext, pnext, tlen
            i32p, i32p,                            # t5, t3
            i32p, i32p, i32p, i32p, i32p,          # nm, nh, hi, xq, x2
            i32p, u32p, ctypes.c_char_p,           # mdpos, mdoff, mdch
            ctypes.c_char_p, ctypes.c_long, i64p,  # buf, cap, out_off
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def sam_sub_lines(labblob, lab_start, lab_len, seq_mat, qual_mat, L, hasq,
                  chrblob, chr_off, chridx, pos, flag, mapq, rnext, pnext,
                  tlen, t5, t3, nm, nh, hi, xq, x2, mdpos, mdoff, mdch):
    """Native batched SAM line assembly for gapless SUB hits.

    Returns (text, offsets int64[n+1]) — line i is
    text[offsets[i]:offsets[i+1]] — or None when the native lib is
    unavailable (callers keep the Python path)."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    n = int(len(L))
    if n == 0:
        return "", np.zeros(1, np.int64)
    lmax = int(seq_mat.shape[1]) if seq_mat.size else 0

    def arr(a, dt):
        return np.ascontiguousarray(a, dtype=dt)

    lab_start = arr(lab_start, np.uint32)
    lab_len = arr(lab_len, np.uint32)
    seq_mat = arr(seq_mat, np.uint8)
    qual_mat = arr(qual_mat, np.uint8)
    L = arr(L, np.int32)
    hasq = arr(hasq, np.uint8)
    chr_off = arr(chr_off, np.uint32)
    chridx = arr(chridx, np.int32)
    pos = arr(pos, np.int64)
    flag = arr(flag, np.int32)
    mapq = arr(mapq, np.int32)
    rnext = arr(rnext, np.int32)
    pnext = arr(pnext, np.int64)
    tlen = arr(tlen, np.int64)
    t5 = arr(t5, np.int32)
    t3 = arr(t3, np.int32)
    nm = arr(nm, np.int32)
    nh = arr(nh, np.int32)
    hi = arr(hi, np.int32)
    xq = arr(xq, np.int32)
    x2 = arr(x2, np.int32)
    mdpos = arr(mdpos, np.int32)
    mdoff = arr(mdoff, np.uint32)
    cap = int(lab_len.sum()) + n * (2 * lmax + 280) + 8 * int(mdoff[-1]) + 64
    buf = ctypes.create_string_buffer(cap)
    out_off = np.empty(n + 1, np.int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def p(a, ct):
        return a.ctypes.data_as(ct)

    r = lib.sam_sub_lines(
        n, labblob, p(lab_start, u32p), p(lab_len, u32p),
        p(seq_mat, u8p), qual_mat.tobytes(), lmax,
        p(L, i32p), p(hasq, u8p),
        chrblob, p(chr_off, u32p), p(chridx, i32p),
        p(pos, i64p), p(flag, i32p), p(mapq, i32p),
        p(rnext, i32p), p(pnext, i64p), p(tlen, i64p),
        p(t5, i32p), p(t3, i32p),
        p(nm, i32p), p(nh, i32p), p(hi, i32p), p(xq, i32p), p(x2, i32p),
        p(mdpos, i32p), p(mdoff, u32p), mdch,
        buf, cap, p(out_off, i64p))
    if r < 0:
        return None
    return buf.raw[:r].decode("latin-1"), out_off
