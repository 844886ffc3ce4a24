"""K17 (``csrc/pack_queries.cu``: the read packing and per-read reverse
complement) built by ``tools/cuda_emu`` (a CPU emulation, where g++ is
present) and driven through the port's own ``_pack_batch_cuda`` on CPU
tensors, against ``_pack_batch_plain`` on ``synth.pack_query_cases``
(lengths 0 to 33 and L, all-N reads, N runs, lengths past L; rows off a
4-byte boundary; the card's longest read; B off a CTA's reads, 1 and 0)
in both ``uniform`` forms; and the wrapper's refusals.  The plain version
is held to the JAX package in ``test_torch_pack_gate.py``."""

import ctypes
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.kernels import build as kbuild
from gmap_gsnap_tpu_torch.utils import synth


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """kernels.build.launch pointed at K17 built by tools/cuda_emu
    (restored after); yields the emulated library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernels")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "cuda_emu"))
    import emu_build

    launch = kbuild.launch
    so = emu_build.build(["pack_queries"],
                         str(tmp_path_factory.mktemp("emu")))
    emu_build.use(so)
    yield ctypes.CDLL(so)
    kbuild.launch = launch


def _flat(res):
    fwd, crc, frc, rev = res
    return (fwd.codes16, fwd.nflags16, crc, frc, rev.codes16, rev.nflags16)


def _equal(got, want):
    for g, w in zip(_flat(got), _flat(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("b,lmax", synth.PACK_QUERY_SHAPES)
def test_pack_queries_emulated_kernel(emulated, b, lmax, uniform):
    """Every output equal, on the batch and on its rows from the second
    on (a view one row into the allocation: its rows start off a 4-byte
    boundary where lmax is odd); one launch counted a call."""
    c, f, ln = (torch.from_numpy(x) for x in synth.pack_query_cases(
        np.random.default_rng(b + lmax), b, lmax, uniform))
    before = kbuild.LAUNCHES["gsnap_pack_queries"]
    for rows in (slice(None), slice(1, None)):
        a = (c[rows], f[rows], ln[rows], uniform)
        _equal(tse._pack_batch_cuda(*a), tse._pack_batch_plain(*a))
    assert kbuild.LAUNCHES["gsnap_pack_queries"] == before + 2


def test_pack_queries_refuses(emulated):
    """Codes that are not uint8, flags that are not bool and shapes that
    disagree raise before a launch; the launch floor's entry point takes
    K17's grid and refuses an empty one."""
    c, f, ln = (torch.from_numpy(x) for x in synth.pack_query_cases(
        np.random.default_rng(5), 9, 20))
    before = kbuild.LAUNCHES["gsnap_pack_queries"]
    for bad in ((c.long(), f, ln), (c, f.to(torch.uint8), ln),
                (c, f[:, 1:], ln), (c, f, ln[1:]), (c[0], f[0], ln[:1])):
        with pytest.raises((TypeError, ValueError)):
            tse._pack_batch_cuda(*bad)
    assert kbuild.LAUNCHES["gsnap_pack_queries"] == before
    floor = emulated.gsnap_pack_queries_floor
    floor.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    assert floor(61, 100, None) == 0
    assert floor(0, 100, None) != 0
