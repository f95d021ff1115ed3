#!/usr/bin/env python3
"""Block-shape and timeline experiment for tidb_probe_count on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 probe_experiment.py [OTHER_SOURCE.cu ...]

It builds variants of tidb_tpu_torch/ops/csrc/hash_probe.cu that differ
only in their block shape (threads per block, rows per thread) and in
whether a small table is staged in shared memory, checks each bit-equal to
plain_probe_chunk, and times each (CUDA graph replay, as chip_smoke.py
times kernels, two passes in opposite orders) at four shapes:

  * Q18's semi join: 57 build keys padded to 64 (table capacity 128),
    65,536 probes, the table route in the lookup-only, flags-only and
    full modes;
  * a Q3-like direct index: 147,000 of 1.5M dense keys (a 2^18-row
    build), 65,536 probes in key order, half of them selected, in the
    flags-only and full modes;
  * a Q5-like sorted build: 2^24 keys, three quarters live, 65,536
    probes (a third of them hits), full mode.

Beside them: an empty kernel's graph-replayed time (the launch floor),
each OTHER_SOURCE given (a file exporting tidb_hash_probe with B3's C
signature, such as an earlier hash_probe.cu) in the lookup-only mode, and
globaltimer stamps per block of the shipped shape (block start, lookup
done, block end) for one launch of each mode. Results go to stdout and
chiprun_out/probe_experiment.json; without a CUDA card it exits non-zero."""

import ctypes
import json
import os
import subprocess
import sys

VARIANTS = {  # name -> (threads per block, rows per thread, largest staged table)
    "shipped_512x1": (512, 1, 1024),
    "512x1_no_staging": (512, 1, 0),
    "256x1": (256, 1, 1024),
    "256x2": (256, 2, 1024),
    "128x4": (128, 4, 1024),
    "1024x1": (1024, 1, 1024),
}
SHIPPED = ("constexpr int kThreads = 512;", "constexpr int kItems = 1; ",
           "constexpr int kSmemMaxCap = 1024;")
EMPTY_CU = """#include <cuda_runtime.h>
__global__ void empty_kernel(long long* out) { if (out != nullptr && threadIdx.x == 0) out[blockIdx.x] = 0; }
extern "C" int empty_launch(int blocks, int threads, void* out, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""
STAMP_DECL = """__device__ unsigned long long g_stamps[1 << 16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
"""
STAMP_SAVE = ("if (threadIdx.x == 0) { g_stamps[blockIdx.x * 3] = t_in; "
              "g_stamps[blockIdx.x * 3 + 1] = t_look; g_stamps[blockIdx.x * 3 + 2] = gtime(); }")


def patch(src: str, needle: str, replacement: str) -> str:
    if src.count(needle) != 1:
        raise SystemExit(f"probe_experiment: the kernel source no longer has {needle!r}")
    return src.replace(needle, replacement)


def variant_source(src: str, threads: int, items: int, cap: int, stamped: bool) -> str:
    """The shipped source with another block shape, and globaltimer stamps."""
    for needle, value in zip(SHIPPED, (threads, items, cap)):
        src = patch(src, needle, needle.split("=")[0] + f"= {value};" +
                    (" " if needle.endswith(" ") else ""))
    if stamped:
        src = patch(src, "namespace {\n", "namespace {\n" + STAMP_DECL)
        src = patch(src, "  if constexpr (kSmem) {  // stage",
                    "  const unsigned long long t_in = gtime();\n"
                    "  if constexpr (kSmem) {  // stage")
        src = patch(src, "  if (ranges) {\n",
                    "  const unsigned long long t_look = gtime();\n  if (ranges) {\n")
        src = patch(src, "  if (!full) return;", "  if (!full) { " + STAMP_SAVE + " return; }")
        last = "  if (threadIdx.x == 0 && tile == gridDim.x - 1) *p.total = base + agg;\n"
        src = patch(src, last, last + "  " + STAMP_SAVE + "\n")
        src = patch(src, 'extern "C" {\n', 'extern "C" {\nint read_stamps(void* dst, int n) '
                    '{ return (int)cudaMemcpyFromSymbol(dst, g_stamps, n * 8); }\n')
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_experiment: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as cs
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.ops import join_kernels as jk
    from tidb_tpu_torch.ops import nvcc_build as nb

    card = cs.card_line()
    print(card, flush=True)
    out_dir = os.path.join("build", "probe_experiment")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(nb.CSRC, hp.SOURCE)).read()
    sources = {n: variant_source(src, t, i, c, n == "shipped_512x1")
               for n, (t, i, c) in VARIANTS.items()}
    sources["empty"] = EMPTY_CU
    others = {f"other:{os.path.basename(p)}": open(p).read() for p in sys.argv[1:]}
    sources.update(others)
    procs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, name.replace(":", "_") + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nb.nvcc_path(), *nb._NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            print(f"probe_experiment: nvcc failed on {name}:\n{err[-3000:]}", file=sys.stderr)
            return 1
        lib = libs[name] = ctypes.CDLL(os.path.join(out_dir, name.replace(":", "_") + ".so"))
        for fn, argtypes in (
                ("tidb_probe_count", [ctypes.c_void_p, ctypes.c_void_p]),
                ("tidb_hash_probe", [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]),
                ("empty_launch", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p])):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
    hp.load_kernels()

    def use(name):  # the wrappers load the library through this cache
        nb._libs[hp.SOURCE] = libs[name]

    dev = "cuda"
    rng = np.random.default_rng(1)
    b, p = cs.probe_cases(np)["q18_shape"]
    sk18, pr18 = torch.from_numpy(b).to(dev), torch.from_numpy(p).to(dev)
    ones = torch.ones(len(p), dtype=torch.bool, device=dev)
    t18 = hp.placed_table(sk18)
    q18 = (pr18, ones, None, ones, torch.tensor(57, dtype=torch.int64, device=dev), sk18)
    live = np.sort(rng.choice(np.arange(1, 1_500_001), 147_000, replace=False))
    skd = torch.from_numpy(np.concatenate([live, np.full((1 << 18) - len(live), cs.I64_MAX)])).to(dev)
    nbd = torch.tensor(len(live), dtype=torch.int64, device=dev)
    direct_kw = dict(route="direct", firsts=jk.build_direct_index(skd, nbd, 1, 1 << 21),
                     lo_packed=1, rng_packed=1_500_000)
    sel = torch.from_numpy(rng.random(65536) < 0.5).to(dev)
    q3 = (torch.from_numpy(np.sort(rng.integers(1, 1_500_001, 65536))).to(dev), ones, None, sel,
          nbd, skd)
    ns = 3 << 22
    sks = torch.cat([torch.sort(torch.randint(0, 1 << 40, (ns,), device=dev)).values,
                     torch.full(((1 << 24) - ns,), cs.I64_MAX, dtype=torch.int64, device=dev)])
    prs = torch.randint(0, 1 << 40, (65536,), device=dev)
    prs[:20000] = sks[torch.randint(0, ns, (20000,), device=dev)]
    q5 = (prs, ones, None, sel, torch.tensor(ns, dtype=torch.int64, device=dev), sks)
    shapes = {
        "q18_table_ranges": None,
        "q18_table_flags": (q18, dict(route="table", table=t18, flags_only=True)),
        "q18_table_full": (q18, dict(route="table", table=t18)),
        "q3_direct_flags": (q3, dict(direct_kw, flags_only=True)),
        "q3_direct_full": (q3, direct_kw),
        "q5_sorted_full": (q5, dict(route="sorted")),
    }

    def call(shape):
        if shapes[shape] is None:
            return lambda: hp.probe_table(*t18, sk18, pr18)
        args, kw = shapes[shape]
        return lambda: hp.probe_chunk(*args, **kw)

    times = {}
    order = list(VARIANTS) + list(others)
    for rep in range(2):
        for name in (order if rep == 0 else order[::-1]):
            use(name)
            for shape in (shapes if name in VARIANTS else ["q18_table_ranges"]):
                if shapes[shape] is None:
                    lo, hi = hp.probe_table(*t18, sk18, pr18)
                    plo, phi = hp.plain_probe_table(*t18, sk18, pr18)
                    if not (torch.equal(lo, plo) and torch.equal(hi, phi)):
                        raise AssertionError(f"{name} {shape} differs from plain")
                else:
                    cs.check_chunk(torch, hp, *shapes[shape])
                us = cs.device_ms(torch, call(shape), graph=True) * 1e3
                times.setdefault(f"{name} {shape}", []).append(us)
    use("empty")
    sink = torch.zeros(1024, dtype=torch.int64, device=dev)
    for blocks, threads in ((128, 512), (1, 32)):
        def empty(b=blocks, t=threads):
            if libs["empty"].empty_launch(b, t, sink.data_ptr(),
                                          torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("empty kernel launch failed")
        times[f"empty {blocks}x{threads}"] = [cs.device_ms(torch, empty, graph=True) * 1e3]
    for key, us in times.items():
        print(f"{key:40s} us/call {' '.join(f'{x:.3f}' for x in us)}", flush=True)

    stamps = {}
    use("shipped_512x1")
    threads, items, _ = VARIANTS["shipped_512x1"]
    for shape in ("q18_table_flags", "q18_table_full", "q3_direct_flags", "q3_direct_full",
                  "q5_sorted_full"):
        args, kw = shapes[shape]
        for _ in range(4):
            hp.probe_chunk(*args, **kw)
        torch.cuda.synchronize()
        n_blocks = -(-args[0].shape[0] // (threads * items))
        buf = (ctypes.c_ulonglong * (n_blocks * 3))()
        if libs["shipped_512x1"].read_stamps(buf, n_blocks * 3):
            raise RuntimeError("reading the stamps failed")
        s = np.array(buf, dtype=np.float64).reshape(n_blocks, 3)
        s -= s[:, 0].min()
        stamps[shape] = {"start_spread_ns": s[:, 0].max(),
                         "lookup_done_ns": [np.median(s[:, 1]), s[:, 1].max()],
                         "block_end_ns": [np.median(s[:, 2]), s[:, 2].max()]}
        print(f"stamps {shape}: block start spread {s[:, 0].max():.0f} ns; lookup done median "
              f"{np.median(s[:, 1]):.0f} max {s[:, 1].max():.0f} ns; block end median "
              f"{np.median(s[:, 2]):.0f} max {s[:, 2].max():.0f} ns", flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "probe_experiment.json"), "w") as f:
        json.dump({"card": card, "us_per_call": times, "stamps": stamps}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
