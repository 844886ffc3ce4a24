"""Where K1 (csrc/seed_diagonals.cu), K11 (csrc/banded_gotoh.cu) and K9
(csrc/gmap_seed_segments.cu) spend their time, on the card.

Builds each source with its stamp markers defined: SEED_STAMP(i) and
GOTOH_STAMP(i) make lane 0 of each warp write clock64() at the end of
phase i of its read (K1) or problem (K11), and %globaltimer at its first
and last stamp; K11 also with GOTOH_ROW_STORES=0 (the last row stored
alone), to show what its row stores cost.  Then, through the port's own
wrappers:

  K1 ("seed") on 2,048 planted reads x 2 strands (L = 100) over a
  16 Mbp synthetic genome, with a k=15 index (a 4.3 GB offsets table, as the
  main path's) and a k=12 one (67 MB), at W = 384 and 4096 (the -N 0
  runner's grid and the wide lane's), the size threshold the runner
  computes: per phase the median and the largest cycles over the reads
  (a phase's cycles: its stamp less the stamp before it), the slowest
  read's phases, the spread of the reads' starts and the span from the
  first start to the last end on the global timer, and torch.profiler's
  device time of the stamped and of the default-built kernel; "warm"
  calls follow calls on the same reads (the table entries they read are
  in the 50 MB L2, as a timing loop leaves them), "cold" ones follow a
  write of 256 MB (as a main path's next batch, whose k-mers are new,
  finds the table);
  K11 ("gotoh") on random junction windows (chip_smoke._junction_windows:
  M = 64, W = 23) at 14 and 128 junctions (28 and 256 problems): the
  cycles of the staging and of the row loop, whole and a row (median
  and most over the problems), with the row stores and without, the
  span, and the device times;
  K9 ("gmap_seed", GMAP_SEED_STAMP(i), thread 0 of each row's CTA) on
  the PE -N 1 runner's GMAP-lane inputs (tools/time_kernels.py
  lane_inputs): per phase (counts, expansion, sort, segments, segment
  sort, stores) the median and the largest cycles over the rows, the
  slowest row's phases, the span, the shared memory and the CTAs an SM
  holds, at the runner's H and S and at those of one and two retries;
  "latency": one warp's dependent chains (a shuffle, an add and a max, a
  shared load, a shuffle with four global or four shared stores), their
  cycles an iteration.

Each source is built alone, stamped and not ("default build").  The
stamped kernels are checked against the plain versions first (K11
without its row stores is not: it writes rows 0 and M alone).  ``--root`` probes
another checkout (its wrappers and its csrc/, whose sources must carry
the same markers; phases it does not stamp are left out).  Prints one
line per measurement.

    python tools/probe_seed_gotoh.py [--root DIR]
        [--only seed gotoh gmap_seed latency]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MAX_ITEMS = 8192      # reads or problems stamped
SEED = 11
# source, marker, stamps, the kernel's variable naming the item stamped,
# the threads that stamp it
PROBES = {"seed": ("seed_diagonals", "SEED_STAMP", 6, "row", "lane 0"),
          "gotoh": ("banded_gotoh", "GOTOH_STAMP", 3, "b", "lane 0"),
          "gmap_seed": ("gmap_seed_segments", "GMAP_SEED_STAMP", 7, "row",
                        "thread 0")}
ENTRIES = {"seed": "gsnap_seed_diagonals", "gotoh": "gmap_banded_gotoh",
           "gmap_seed": "gmap_seed_segments"}


def build_source(root: str, which: str, out: str, stamp: bool = True,
                 defines=()) -> str:
    """Build csrc/<source>.cu of ``root`` alone (with its stamp marker
    defined where ``stamp``) into a shared library under ``out``; returns
    its path."""
    from gmap_gsnap_tpu_torch.kernels import build as kbuild

    src, macro, n, var, who = PROBES[which]
    skip = "(threadIdx.x & 31) != 0" if who == "lane 0" else "threadIdx.x != 0"
    csrc = os.path.join(root, "gmap_gsnap_tpu_torch", "csrc")
    with open(os.path.join(csrc, src + ".cu")) as f:
        body = f.read()
    head = tail = ""
    if stamp:
        head = f"""
__device__ long long g_clock[{MAX_ITEMS}][{n}];
__device__ unsigned long long g_ns[{MAX_ITEMS}][2];
__device__ __forceinline__ void probe_stamp(long long item, int i) {{
  if ({skip} || item < 0 || item >= {MAX_ITEMS}) return;
  g_clock[item][i] = clock64();
  if (i == 0 || i == {n - 1}) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_ns[item][i != 0] = t;
  }}
}}
#define {macro}(i) probe_stamp({var}, i)
"""
        tail = f"""
extern "C" void probe_read(long long* clk, unsigned long long* ns) {{
  cudaMemcpyFromSymbol(clk, g_clock, sizeof(g_clock));
  cudaMemcpyFromSymbol(ns, g_ns, sizeof(g_ns));
}}
extern "C" void probe_clear() {{
  static long long zc[{MAX_ITEMS}][{n}];
  static unsigned long long zn[{MAX_ITEMS}][2];
  cudaMemcpyToSymbol(g_clock, zc, sizeof(zc));
  cudaMemcpyToSymbol(g_ns, zn, sizeof(zn));
}}
"""
    tag = "_".join([which, "stamped" if stamp else "plain",
                    *[d.replace("=", "") for d in defines]])
    cu = os.path.join(out, tag + ".cu")
    so = os.path.join(out, tag + ".so")
    with open(cu, "w") as f:
        f.write(head + body + tail)
    subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", csrc,
                    *[f"-D{d}" for d in defines], "-shared", "-o", so, cu],
                   check=True, capture_output=True)
    return so


class Probe:
    """A stand-in for kernels.build's library holding the probed entry
    point alone (the K1 and K11 wrappers call no other)."""

    def __init__(self, so: str, entry: str):
        from gmap_gsnap_tpu_torch.kernels import build as kbuild

        self.lib = ctypes.CDLL(so)
        kinds = {"p": ctypes.c_void_p, "h": ctypes.c_void_p,
                 "i": ctypes.c_int32, "l": ctypes.c_int64}
        fn = getattr(self.lib, entry)
        fn.argtypes = [kinds[c] for c in kbuild._SIGNATURES[entry]] + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        setattr(self, entry, fn)
        if hasattr(self.lib, "probe_read"):
            self.lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    @staticmethod
    def gsnap_error_string(rc):
        return f"probe launch failed ({rc})".encode()

    def stamps(self, n: int, items: int):
        clk = np.zeros((MAX_ITEMS, n), np.int64)
        ns = np.zeros((MAX_ITEMS, 2), np.uint64)
        self.lib.probe_read(clk.ctypes.data, ns.ctypes.data)
        return clk[:items], ns[:items].astype(np.int64)


def using(kbuild, probe, fn):
    """fn() with kernels.build's library replaced by ``probe``."""
    saved = kbuild._lib
    kbuild._lib = probe
    try:
        return fn()
    finally:
        kbuild._lib = saved


def device_ms(torch, fn, name: str, reps: int = 20, flush=None) -> float:
    """The kernel's device time a call of fn (torch.profiler, the events
    whose name holds ``name``), each call after ``flush.zero_()`` where
    a flush buffer is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and name in e.key]
    return sum(e.self_device_time_total for e in ev) / 1e3 / reps


def phase_cycles(clk: np.ndarray) -> dict:
    """Cycles of each stamped phase (a stamp less the one before it that
    was written) of every item: {stamp index: int64[items]}."""
    have = [i for i in range(1, clk.shape[1]) if (clk[:, i] != 0).all()]
    out, prev = {}, 0
    for i in have:
        out[i] = clk[:, i] - clk[:, prev]
        prev = i
    return out


def spans(ns: np.ndarray) -> str:
    return (f"starts spread over {int(ns[:, 0].max() - ns[:, 0].min())} ns, "
            f"first start to last end {int(ns[:, 1].max() - ns[:, 0].min())}"
            f" ns")


def probe_seed(torch, smoke, kbuild, out, args) -> None:
    from gmap_gsnap_tpu_torch import convert
    from gmap_gsnap_tpu_torch.align import gsnap_se as se
    from gmap_gsnap_tpu_torch.align import runner as trun
    from gmap_gsnap_tpu_torch.utils import synth

    dev = torch.device("cuda")
    probe = Probe(build_source(args.root, "seed", out), ENTRIES["seed"])
    default = Probe(build_source(args.root, "seed", out, stamp=False),
                    ENTRIES["seed"])
    rng = np.random.default_rng(SEED)
    n = 16_000_000
    g = synth.make_genome(rng, [n // 2, n // 3, n - n // 2 - n // 3])
    recs, _ = synth.plant_reads(rng, g, 2048)
    c, f, ln = (torch.from_numpy(x).to(dev)
                for x in trun.encode_batch(recs, 100))
    crc, frc = se._revcomp_batch_plain(c, f, ln)
    c, f, ln = torch.cat([c, crc]), torch.cat([f, frc]), torch.cat([ln, ln])
    rows = c.shape[0]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for k in (15, 12):
        db = synth.genome_db(g, k, 3)
        ti = convert.index_from_arrays(db.offsets, db.positions, k, 3, dev)
        thr = se.dynamic_size_threshold(int(db.offsets[-1]), k, "standard")
        for st in (384, 4096):
            p = se.GsnapParams(seed_total=st, size_threshold=thr)
            call = lambda: se._seed_diagonals_cuda(ti, c, f, ln, p, True)
            want = se._seed_diagonals_plain(ti, c, f, ln, p, True)
            filled = int((want[0] != se.INVALID_DIAG).sum())
            for cache in ("warm", "cold"):
                fl = flush if cache == "cold" else None
                plain_built = using(kbuild, default, lambda: device_ms(
                    torch, call, "seed_diagonals", flush=fl))
                stamped = using(kbuild, probe, lambda: device_ms(
                    torch, call, "seed_diagonals", flush=fl))
                probe.lib.probe_clear()
                if fl is not None:
                    fl.zero_()
                got = using(kbuild, probe, call)
                torch.cuda.synchronize()
                if smoke._max_abs_err(got, want) != 0:
                    raise SystemExit("the stamped K1 disagrees with the "
                                     "plain version")
                clk, ns = probe.stamps(PROBES["seed"][2], rows)
                ph = phase_cycles(clk)
                total = sum(ph.values())
                slow = int(total.argmax())
                print(f"seed k={k} W={st} {cache}: {rows} rows, size "
                      f"threshold {thr}, {filled} filled slots; cycles a "
                      f"phase (stamp: median / most) "
                      + ", ".join(f"{i}: {int(np.median(v))} / "
                                  f"{int(v.max())}" for i, v in ph.items())
                      + f"; the slowest read ({slow}): "
                      + ", ".join(f"{i}: {int(v[slow])}"
                                  for i, v in ph.items())
                      + f"; reads' cycles median {int(np.median(total))}, "
                      f"most {int(total.max())}; {spans(ns)}; profiler ms "
                      f"a call: stamped {stamped:.4f}, default build "
                      f"{plain_built:.4f}", flush=True)
        del ti, db
        torch.cuda.empty_cache()


def probe_gmap_seed(torch, smoke, kbuild, out, args) -> None:
    """K9 on the PE -N 1 runner's GMAP-lane inputs (tools/time_kernels.py
    lane_inputs over its 16 Mbp genome, k = 12): its largest call at the
    runner's H and S and at those of one and two overflow retries (x4
    each, which align/gmap.py keeps for the rest of the process)."""
    from gmap_gsnap_tpu_torch import convert
    from gmap_gsnap_tpu_torch.align import gmap_engine as eng
    from gmap_gsnap_tpu_torch.utils import synth

    sys.path.insert(0, HERE)
    import time_kernels

    dev = torch.device("cuda")
    probe = Probe(build_source(args.root, "gmap_seed", out),
                  ENTRIES["gmap_seed"])
    default = Probe(build_source(args.root, "gmap_seed", out, stamp=False),
                    ENTRIES["gmap_seed"])
    rng = np.random.default_rng(SEED)
    n = 16_000_000
    g = synth.make_genome(rng, [n // 2, n // 3, n - n // 2 - n // 3])
    db = synth.genome_db(g, 12, 3)
    captured, _ = time_kernels.lane_inputs(torch, db, g, dev, SEED + 1)
    offs, pos, oligos, valid, k, H, S, thr = captured["seg"]
    rows = oligos.shape[0]
    for h, s_ in ((H, S), (4 * H, 4 * S), (16 * H, 16 * S)):
        a = (offs, pos, oligos, valid, k, h, s_, thr)
        call = lambda a=a: eng._seed_segments_cuda(*a)
        want = eng._seed_segments_plain(*a)
        plain_built = using(kbuild, default, lambda: device_ms(
            torch, call, "seed_segments"))
        stamped = using(kbuild, probe, lambda: device_ms(
            torch, call, "seed_segments"))
        probe.lib.probe_clear()
        got = using(kbuild, probe, call)
        torch.cuda.synchronize()
        keys = eng.SEG_KEYS
        if smoke._max_abs_err([got[x] for x in keys],
                              [want[x] for x in keys]) != 0:
            raise SystemExit("the stamped K9 disagrees with the plain "
                             "version")
        clk, ns = probe.stamps(PROBES["gmap_seed"][2], rows)
        ph = phase_cycles(clk)
        total = sum(ph.values())
        slow = int(total.argmax())
        nv = want["nhits"].clamp(max=h).cpu().numpy()
        layout = using(kbuild, probe, lambda: time_kernels.seed_layout(
            eng, kbuild, oligos.shape[1], h, s_))
        print(f"gmap_seed rows={rows} Q={oligos.shape[1]} H={h} S={s_}: "
              f"{layout}; "
              f"min(nhits, H) most {int(nv.max())}, median "
              f"{float(np.median(nv))}, nsegs most "
              f"{int(want['nsegs'].max())}; cycles a phase (stamp: median / "
              f"most) " + ", ".join(f"{i}: {int(np.median(v))} / "
                                    f"{int(v.max())}" for i, v in ph.items())
              + f"; the slowest row ({slow}, {int(nv[slow])} hits): "
              + ", ".join(f"{i}: {int(v[slow])}" for i, v in ph.items())
              + f"; rows' cycles median {int(np.median(total))}, most "
              f"{int(total.max())}; {spans(ns)}; profiler ms a call: "
              f"stamped {stamped:.4f}, default build {plain_built:.4f}",
              flush=True)


def probe_gotoh(torch, smoke, kbuild, out, args) -> None:
    from gmap_gsnap_tpu_torch.ops import dynprog as dp

    dev = torch.device("cuda")
    probes = {label: Probe(build_source(args.root, "gotoh", out,
                                        defines=d), ENTRIES["gotoh"])
              for label, d in (("row stores", ()),
                               ("last row only", ("GOTOH_ROW_STORES=0",)))}
    default = Probe(build_source(args.root, "gotoh", out, stamp=False),
                    ENTRIES["gotoh"])
    rng = np.random.default_rng(SEED)
    for nb in (14, 128):
        w = smoke._junction_windows(torch, dp, rng, nb, dev)
        margs = (w["q"], w["g"], w["len1"], w["len2"], w["lb"], w["rb"],
                 dp.pair_matrix(dp.MISMATCH_HIGHQ), w["late"], 64, 23,
                 dp.PAIRED_OPEN, dp.PAIRED_EXTEND)
        call = lambda: dp._banded_matrices_cuda(*margs)
        want = dp._banded_matrices_plain(*margs)
        plain_built = using(kbuild, default, lambda: device_ms(
            torch, call, "banded_gotoh"))
        for label, probe in probes.items():
            stamped = using(kbuild, probe, lambda: device_ms(
                torch, call, "banded_gotoh"))
            probe.lib.probe_clear()
            got = using(kbuild, probe, call)
            torch.cuda.synchronize()
            if label == "row stores" and smoke._max_abs_err(got, want) != 0:
                raise SystemExit("the stamped K11 disagrees with the plain "
                                 "version")
            clk, ns = probe.stamps(PROBES["gotoh"][2], 2 * nb)
            stage, loop = clk[:, 1] - clk[:, 0], clk[:, 2] - clk[:, 1]
            step = loop / 64
            print(f"gotoh {2 * nb} problems ({label}): staging cycles median "
                  f"{int(np.median(stage))} / most {int(stage.max())}; row "
                  f"loop cycles median {int(np.median(loop))} / most "
                  f"{int(loop.max())}, a row {np.median(step):.1f} / "
                  f"{step.max():.1f}; {spans(ns)}; profiler ms a call: "
                  f"stamped {stamped:.4f}, default build {plain_built:.4f}",
                  flush=True)


LATENCY = r"""
// Cycles an iteration of dependent chains in one warp, by clock64().
#include <cstdio>
#define FULL 0xFFFFFFFFu
__global__ void chains(int n, int* out, long long* cyc, int* gbuf) {
  __shared__ int s[1024];
  const int lane = threadIdx.x & 31, src = (lane + 31) & 31;
  for (int i = lane; i < 1024; i += 32) s[i] = (i * 37 + 11) & 1023;
  __syncwarp();
  int x = lane, acc = 0;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) x = __shfl_sync(FULL, x, src);
  cyc[0] = clock64() - t0; acc += x;
  t0 = clock64();
  for (int i = 0; i < n; ++i) x = max(x + 3, acc - i);
  cyc[1] = clock64() - t0; acc += x;
  x = lane;
  t0 = clock64();
  for (int i = 0; i < n; ++i) x = s[x];
  cyc[2] = clock64() - t0; acc += x;
  t0 = clock64();
  for (int i = 0; i < n; ++i) {
    x = __shfl_sync(FULL, x, src);
    gbuf[(i & 255) * 32 + lane] = i;
    gbuf[8192 + (i & 255) * 32 + lane] = i;
    gbuf[16384 + (i & 255) * 32 + lane] = i;
    gbuf[24576 + (i & 255) * 32 + lane] = i;
  }
  cyc[3] = clock64() - t0; acc += x;
  t0 = clock64();
  for (int i = 0; i < n; ++i) {
    x = __shfl_sync(FULL, x, src);
    s[(i * 4) & 1023] = i + lane;
    s[(i * 4 + 1) & 1023] = i;
    s[(i * 4 + 2) & 1023] = i;
    s[(i * 4 + 3) & 1023] = i;
  }
  cyc[4] = clock64() - t0; acc += x;
  out[lane] = acc;
}
int main() {
  int* out; long long* cyc; int* gbuf;
  cudaMalloc(&out, 128); cudaMalloc(&cyc, 64); cudaMalloc(&gbuf, 4 << 15);
  const int n = 1000;
  long long h[5];
  for (int rep = 0; rep < 2; ++rep) {
    chains<<<1, 32>>>(n, out, cyc, gbuf);
    cudaDeviceSynchronize();
  }
  cudaMemcpy(h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
  const char* what[5] = {"a shuffle", "an add and a max",
                         "a shared load (pointer chase)",
                         "a shuffle and 4 global stores",
                         "a shuffle and 4 shared stores"};
  for (int i = 0; i < 5; ++i)
    printf("latency: %s, %.1f cycles an iteration\n", what[i],
           (double)h[i] / n);
  return cudaGetLastError() != cudaSuccess;
}
"""


def probe_latency(out) -> None:
    """The latencies that bound one warp's dependent chains (K11's row
    loop): a kernel of one warp times 1,000 iterations of each chain."""
    from gmap_gsnap_tpu_torch.kernels import build as kbuild

    cu, exe = os.path.join(out, "latency.cu"), os.path.join(out, "latency")
    with open(cu, "w") as f:
        f.write(LATENCY)
    subprocess.run([kbuild._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", exe, cu], check=True, capture_output=True)
    print(subprocess.run([exe], check=True, capture_output=True,
                         text=True).stdout, end="", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO,
                    help="checkout whose gmap_gsnap_tpu_torch is probed")
    ap.add_argument("--only", nargs="+", choices=(*PROBES, "latency"),
                    default=(*PROBES, "latency"))
    args = ap.parse_args()
    args.root = os.path.abspath(args.root)
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from gmap_gsnap_tpu_torch.kernels import build as kbuild

    assert kbuild.__file__.startswith(args.root), kbuild.__file__
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_probe", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; root {args.root}", flush=True)
    out = tempfile.mkdtemp()
    if "seed" in args.only:
        probe_seed(torch, smoke, kbuild, out, args)
    if "gotoh" in args.only:
        probe_gotoh(torch, smoke, kbuild, out, args)
    if "gmap_seed" in args.only:
        probe_gmap_seed(torch, smoke, kbuild, out, args)
    if "latency" in args.only:
        probe_latency(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
