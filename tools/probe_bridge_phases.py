"""Where K12 (csrc/bridge_traceback.cu) spends its time, on the card.

Builds the kernel's source with its BRIDGE_STAMP(i) markers defined:
thread 0 of every CTA writes clock64() at the end of each phase (its
start, the copies issued, landed, the decision table, the junction
search and its reduction, both walks to the barrier after them, its
stores) and %globaltimer at its start and its end.  Runs it on random
junction windows (chip_smoke's _junction_windows) at 14 and 128
junctions, checks it against the plain version, and prints, for CTA 0
and for the CTA that took the most cycles, the phases as cycles since
that CTA's start beside its two walks' lengths; the CTAs' cycles
(least, median, most) and the slowest one's cycles from the search to
its stores a step of its longer walk; on the global timer the spread of
the CTAs' starts and the span from the first start to the last end;
and, from torch.profiler over 20 calls, the device time of the stamped
kernel alone and, for the unstamped kernel, of the kernel alone and of
every device op the wrapper runs (with their number).  The clock stamps
are warp 0's: a walker in another warp may read another sub-partition's
counter, so none is stamped there; the compiler may move a stamp
against the barrier before it, so the walks and the stores are read as
one span.

    python tools/probe_bridge_phases.py
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("start", "copies issued", "copies landed", "decision table",
          "search + reduction", "walks", "stores")
MAX_CTAS = 128
PROBE = f"""
__device__ long long g_clock[{MAX_CTAS}][8];
__device__ unsigned long long g_ns[{MAX_CTAS}][2];
__device__ __forceinline__ void probe_stamp(int i) {{
  if (threadIdx.x != 0 || blockIdx.x >= {MAX_CTAS}) return;
  g_clock[blockIdx.x][i] = clock64();
  if (i == 0 || i == 6) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_ns[blockIdx.x][i == 6] = t;
  }}
}}
#define BRIDGE_STAMP(i) probe_stamp(i)
"""
READ = f"""
extern "C" void probe_read(long long* clk, unsigned long long* ns) {{
  cudaMemcpyFromSymbol(clk, g_clock, sizeof(g_clock));
  cudaMemcpyFromSymbol(ns, g_ns, sizeof(g_ns));
}}
"""


def device_ms(torch, fn, reps: int = 20) -> tuple:
    """(every device op, the K12 kernel alone) in ms a call of fn, and
    the number of device ops a call, from one torch.profiler profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = lambda es: sum(e.self_device_time_total for e in es) / 1e3 / reps
    return (us(ev), us([e for e in ev if "bridge_traceback" in e.key]),
            sum(e.count for e in ev) / reps)


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from gmap_gsnap_tpu_torch.kernels import build as kbuild
    from gmap_gsnap_tpu_torch.ops import dynprog as dp

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_probe", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(REPO, "gmap_gsnap_tpu_torch", "csrc",
                           "bridge_traceback.cu")) as f:
        src = f.read()
    out = tempfile.mkdtemp()
    cu, so = os.path.join(out, "probe.cu"), os.path.join(out, "probe.so")
    with open(cu, "w") as f:
        f.write(PROBE + src + READ)
    subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I",
                    os.path.join(REPO, "gmap_gsnap_tpu_torch", "csrc"),
                    "-shared", "-o", so, cu], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    fn = lib.gmap_bridge_traceback
    fn.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    real = kbuild.library()

    class Probe:  # kbuild.launch through the stamped kernel
        def __getattr__(self, name):
            return fn if name == "gmap_bridge_traceback" else getattr(real,
                                                                      name)

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    for nb in (14, 128):
        w = smoke._junction_windows(torch, dp, rng, nb, dev)
        mats = dp._banded_matrices_plain(
            w["q"], w["g"], w["len1"], w["len2"], w["lb"], w["rb"],
            dp.pair_matrix(dp.MISMATCH_HIGHQ), w["late"], 64, 23,
            dp.PAIRED_OPEN, dp.PAIRED_EXTEND)
        bargs = (mats, w["len1"][:nb], w["len2"][:nb], w["len2"][nb:],
                 w["lb"][:nb], w["lb"][nb:], w["g"][:nb], w["g"][nb:],
                 w["known"], w["known"], w["loff"], w["roff"], 64, 23, 138,
                 dp.PAIRED_OPEN, dp.PAIRED_EXTEND, 30, 1, True, False, False)
        call = lambda: dp._bridge_traceback_cuda(*bargs)
        whole, alone, nops = device_ms(torch, call)
        kbuild._lib = Probe()
        try:
            stamped = device_ms(torch, call)[1]
            got = call()
            torch.cuda.synchronize()
        finally:
            kbuild._lib = real
        want = dp._bridge_traceback_plain(*bargs)
        if smoke._max_abs_err(got, want) != 0:
            raise SystemExit("the stamped kernel disagrees with the plain "
                             "version")
        clk = (ctypes.c_longlong * (MAX_CTAS * 8))()
        ns = (ctypes.c_ulonglong * (MAX_CTAS * 2))()
        lib.probe_read(clk, ns)
        clk = np.array(clk, dtype=np.int64).reshape(MAX_CTAS, 8)[:nb, :7]
        ns = np.array(ns, dtype=np.int64).reshape(MAX_CTAS, 2)[:nb]
        cyc = clk - clk[:, :1]
        steps = np.stack([(want[2 + 3 * s] != dp.OP_NONE).sum(1).cpu()
                          .numpy() for s in (0, 1)], 1)
        slow = int(cyc[:, 6].argmax())
        for label, i in (("CTA 0", 0), (f"slowest CTA {slow}", slow)):
            print(f"nb={nb} {label}: cycles since its start "
                  f"{dict(zip(PHASES[1:], cyc[i, 1:].tolist()))}; walks "
                  f"{int(steps[i, 0])} (left) and {int(steps[i, 1])} "
                  f"(right) steps", flush=True)
        print(f"nb={nb}: CTA cycles least {int(cyc[:, 6].min())}, median "
              f"{int(np.median(cyc[:, 6]))}, most {int(cyc[:, 6].max())}; "
              f"the slowest's walks and stores "
              f"{(cyc[slow, 6] - cyc[slow, 4]) / max(1, steps[slow].max()):.0f}"
              f" cycles a step of its longer walk; longest walk "
              f"{int(steps.max())} steps; global timer: starts spread over "
              f"{int(ns[:, 0].max() - ns[:, 0].min())} ns, first start to "
              f"last end {int(ns[:, 1].max() - ns[:, 0].min())} ns; profiler "
              f"ms a call: stamped kernel {stamped}, kernel {alone}, all "
              f"{nops:g} device ops of the wrapper {whole}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
