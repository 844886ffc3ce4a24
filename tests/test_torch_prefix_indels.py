"""The plain versions of K3 (prefix_mismatches) and K4 (solve_indels),
which their kernels are held to, against the JAX package's _prefix_mm and
_solve_indels on the edges the kernels' designs turn on, at L 75, 100,
150 and 1024.  K3 (synth.prefix_mismatch_cases): B x NC not a multiple
of the kernel's 64-placement tile, INVALID diagonals and diagonals at and
past the genome end, genome N runs and query Ns, reads of 1, 15, 16 and
17 nt; every conversion, with and without an alt genome, under both N
rules.  K4 (synth.indel_pair_cases): insertions of every shift,
deletions, differences that wrap in uint32 and int32, rows that several
pairs of a read name, a candidate only at s = L, ties in total, rows
without mismatches; min_end 0, 4 and past half the read, with and
without the seed-order gate.  Seeded numpy inputs, exact equality.

Where g++ is present, K3's and K4's CUDA sources are also built through
tools/cuda_emu (a CPU emulation of the CUDA subset they use) and their
own wrappers run on a few of those edges against the plain versions."""

import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_gapped as jgg
from gmap_gsnap_tpu.ops import genome as jgen
from gmap_gsnap_tpu.ops import mismatch as jmm
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
from gmap_gsnap_tpu_torch.kernels import build as kbuild
from gmap_gsnap_tpu_torch.ops import mismatch as tmm
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import fresh_jax_caches, one_torch_thread

LENGTHS = [75, 100, 150, 1024]
CONVERSIONS = (None, "ct", "ga", "ag", "tc")
RULES = ((False, True), (True, False))   # (query-N, genome-N mismatches)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), one_torch_thread():
        yield


def _eq(jax_value, port):
    j = np.asarray(jax_value)
    p = port.numpy()
    assert p.shape == j.shape
    np.testing.assert_array_equal(p.astype(np.int64), j.astype(np.int64))


def _prefix_world(L):
    """(JAX genome, port genome, JAX queries, port queries, diags,
    lengths) of synth.prefix_mismatch_cases at L."""
    case = synth.prefix_mismatch_cases(np.random.default_rng(L), 37, 24, L)
    jg = jgen.GenomeArrays.from_codes(case["gcodes"], case["gflags"],
                                      [len(case["gcodes"])])
    tg = convert.genome_from_arrays(jg.ref16, jg.flag16, jg.length,
                                    jg.chr_offsets, "cpu")
    jq = jmm.pack_queries(case["codes"], case["nflags"], case["lengths"])
    tq = tmm.pack_queries(case["codes"], case["nflags"], case["lengths"],
                          "cpu")
    return jg, tg, jq, tq, case["diags"], case["lengths"]


@pytest.mark.parametrize("L", LENGTHS)
def test_prefix_mismatches_edges_match_jax(monkeypatch, L):
    jg, tg, jq, tq, diags, lengths = _prefix_world(L)
    jalt = (jg.ref16[::-1], jg.flag16)
    talt = (tg.ref16.flip(0).contiguous(), tg.flag16)
    for qunk, gunk in RULES:
        for mod in (jmm, tmm):
            monkeypatch.setattr(mod, "QUERY_UNK_MISMATCH", qunk)
            monkeypatch.setattr(mod, "GENOME_UNK_MISMATCH", gunk)
        for conv in CONVERSIONS:
            for ja, ta in ((None, None), (jalt, talt)):
                jm, jp = jgg._prefix_mm(
                    jg, jq, jnp.asarray(diags.astype(np.uint32)),
                    jnp.asarray(lengths), conv, ja)
                tm, tp = tmm.prefix_mismatches(
                    tg, tq, torch.from_numpy(diags),
                    torch.from_numpy(lengths), conv, ta)
                _eq(jm, tm)
                _eq(jp, tp)


def _indel_args(case, L, min_end, gate, to):
    """solve_indels' arguments from synth.indel_pair_cases, through ``to``
    (numpy array -> the framework's array)."""
    return ((to(case["top_d"]), to(case["mm"]), to(case["pref"]),
             to(case["ii"]), to(case["jj"]), to(case["pvalid"]),
             to(case["lengths"]), to(case["budget"]), L),
            dict(qp5=to(case["qp5"]) if gate else None,
                 qp3=to(case["qp3"]) if gate else None, max_ins=9,
                 max_del=30, min_end=min_end))


@pytest.mark.parametrize("L", LENGTHS)
def test_solve_indels_edges_match_jax(L):
    case = synth.indel_pair_cases(np.random.default_rng(L), 40, 32, 16, L)
    jto = {"top_d": lambda x: jnp.asarray(x.astype(np.uint32)),
           "ii": lambda x: jnp.asarray(x.astype(np.int32)),
           "jj": lambda x: jnp.asarray(x.astype(np.int32))}
    jcase = {k: jto.get(k, jnp.asarray)(v) for k, v in case.items()}
    nvalid = 0
    for min_end in (0, 4, L // 2 + 1):
        for gate in (True, False):
            ja, jkw = _indel_args(jcase, L, min_end, gate, lambda x: x)
            ta, tkw = _indel_args(case, L, min_end, gate, torch.from_numpy)
            want = jgg._solve_indels(*ja, **jkw)
            got = tgg.solve_indels(*ta, **tkw)
            assert set(want) == set(got) == set(tgg._INDEL_KEYS)
            for k in tgg._INDEL_KEYS:
                _eq(want[k], got[k])
            nvalid += int(got["valid"].sum())
            if min_end == 0 and gate:
                # the deletion pair (0, 10): its only candidate at s = L
                # where row 0 is clean and the read is L long
                ln = torch.from_numpy(case["lengths"])[:, None]
                at_l = ((got["split"] == L) & got["valid"]
                        & (ln == L))
                assert int(at_l.sum()) > 0
    assert nvalid > 0


# ------------------------------------------- the kernels, emulated on the CPU

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """kernels.build.launch pointed at K3 and K4 built by tools/cuda_emu
    (restored after), so that _prefix_mismatches_cuda / _solve_indels_cuda
    run the CUDA sources on CPU tensors."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernels")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "cuda_emu"))
    import emu_build

    launch = kbuild.launch
    so = emu_build.build(["prefix_mismatches", "solve_indels"],
                         str(tmp_path_factory.mktemp("emu")))
    emu_build.use(so)
    yield
    kbuild.launch = launch


@pytest.mark.parametrize("L", [100, 1024])
def test_prefix_mismatches_emulated_kernel(emulated, monkeypatch, L):
    _, tg, _, tq, diags, lengths = _prefix_world(L)
    d, ln = torch.from_numpy(diags), torch.from_numpy(lengths)
    alt = (tg.ref16.flip(0).contiguous(), tg.flag16)
    for (qunk, gunk), conv, a in ((RULES[0], None, None),
                                  (RULES[1], "ga", alt),
                                  (RULES[0], "tc", None)):
        monkeypatch.setattr(tmm, "QUERY_UNK_MISMATCH", qunk)
        monkeypatch.setattr(tmm, "GENOME_UNK_MISMATCH", gunk)
        got = tmm._prefix_mismatches_cuda(tg, tq, d, ln, conv, a)
        want = tmm._prefix_mismatches_plain(tg, tq, d, ln, conv, a)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("L", [100, 1024])
def test_solve_indels_emulated_kernel(emulated, L):
    case = synth.indel_pair_cases(np.random.default_rng(L), 24, 32, 16, L)
    for min_end, gate in ((0, True), (4, False)):
        args, kw = _indel_args(case, L, min_end, gate, torch.from_numpy)
        got = tgg._solve_indels_cuda(*args, kw["qp5"], kw["qp3"], 9, 30,
                                     min_end)
        want = tgg._solve_indels_plain(*args, kw["qp5"], kw["qp3"], 9, 30,
                                       min_end)
        for k in tgg._INDEL_KEYS:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                                want[k]), k
