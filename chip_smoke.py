#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tidb_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from tidb_tpu_torch/ops/csrc with
nvcc (sm_90a, one nvcc per source, all started together), then runs the
phases below; any failure exits non-zero.

1. Kernels against their plain PyTorch versions on the card.
   The fused segment update (tidb_segagg, which replaces B1 and B2) on
   fourteen cases: Q1's 16 accumulators (23 outputs) at its chunk shape,
   G in {1, 12, 26, 33, 300, 8192} and 2^16 (global atomics), ragged R,
   no sel, sel all false, a NULL column, operands 8 bytes off a 16-byte
   boundary and 40 accumulators (two launches); ids >= G and < 0 and
   int64 extremes throughout, each output bit-equal to
   plain_segment_accumulate. Its one-accumulator entry points (B1, B2) at
   Q1's chunk shape (R = 65,536) with G in {1, 12, 8192}, a G above the
   shared-memory budget, ragged R, ids >= G and int64 extremes: counts and
   int64 sums bit-equal, f32 sums within 1e-5 of each group's absolute
   mass (atomics add in a different order on every run). The hash probe
   (B3) on Q18's shape, random keys with duplicates, a same-home cluster,
   full-int64 keys, a build over capacity, the largest eligible build,
   ragged R, all misses and keys whose mix hits the EMPTY sentinel: (lo,
   hi) bit-equal to the plain window scan, and hi - lo equal to
   searchsorted's count (lo equal on every hit); B3 is now
   tidb_probe_count's lookup-only mode. The join's probe program
   (tidb_probe_count, which replaces B3 and the eager chain around it) on
   twenty-one cases (probe_count_cases): each route (direct, table,
   sorted) plain, with the LEFT pad, flags-only and at a ragged row count,
   a table above the shared-memory limit (cap 2^18) in both modes, a build
   holding the EMPTY-preimage keys, two-key range packing, hash packing
   and a chunk below one tile; NULL keys, sel holes, absent keys and
   INT64 extremes throughout: all seven outputs bit-equal to
   plain_probe_chunk. The built library's atomic opcodes are read with
   cuobjdump -sass.
Grid. All 22 TPC-H queries at SF0.1 (the port's generator, seed 7, chunk
   capacity 8,192) through Session on cuda, each against an indexed sqlite
   oracle built here from the port's tables (sqlite_oracle), ordered, with
   the oracle's SQL variants, numbers within 1e-6 relative. Each run must
   keep the probe kernel's launch contract, take at least the fused
   fragments its plan calls for, and run the device generic aggregation
   exactly on Q2, Q3, Q7, Q8, Q9, Q10, Q11, Q13, Q15, Q16, Q17, Q18 and
   Q20, fused at least on Q15, Q17, Q18 and Q20. Q9 is empty at this
   scale and checks nothing.
2. TPC-H Q1, Q6, Q3, Q5 and Q18 at SF1 (about 6M lineitem rows) through
   tidb_tpu_torch.session.Session on cuda, each compared with a numpy
   evaluation of the same query over the same generated arrays (decimals
   exact), on two paths. Each run has the kernels' launch counters, the
   join's probe-route counter and the pipeline's and segment store's
   counters set to 0 just before it and read just after. Every run must
   launch tidb_segagg exactly once per chunk its segment aggregation
   updates and tidb_probe_count exactly once per probe chunk, on every
   route, and the one-column and lookup-only entries never.
   The default path (columnar segment store, fused pipelines): Q1 and Q6
   run twice and must each run in FusedScanAggExec, one pinned copy per
   staged batch the first time and 0 bytes staged the second (the device
   buffer cache); Q3, Q5 and Q18 must run every inner join whose probe
   side is a plain scan (counted on the plan taken just before the run)
   in FusedScanProbeExec, and every generic aggregation on the device:
   fused over a plain scan (Q18's IN subquery), else on the classic
   tree's device path (Q3's, Q18's outer), counted against the plan. The
   classic path (tidb_tpu_pipeline_fuse = 0,
   tidb_tpu_columnar_enable = 0, the earlier raw tree) must give the same
   rows and run nothing fused. Then a 1,200,000-row table loaded with
   8,192-row segments (8 packed a batch) answers one aggregate and one
   join equal to numpy, through the fused executors, tidb_segagg once per
   staged batch. The probe chunks' arguments are recorded for phase 3.
   Then Q3, Q18 and Q18's IN subquery run once more with torch's sync
   debug mode set to "error" around every per-chunk step of the device
   generic aggregation (a device->host copy or any sync there fails), and
   a top-N report over lineitem runs with one sort key, with three, and
   with a LIMIT above the chunk capacity, each against numpy: the first
   two through FusedScanTopNExec, the last through the classic TopNExec.
3. Times: warm wall time (median of 3) and rows/s of each query in four
   modes (fused with the buffer cache, fused with its budget 0, the same
   staged inline at prefetch depth 0, classic), and of Q3 and Q18 in a
   fifth (generic_host: tidb_device_engine_mode = 'off', the host
   groupby); one more warm run of each under torch.profiler (device busy
   time, idle share, host->device copies split pinned/pageable with their
   bytes, device->host copies, host cudaMemcpyAsync and launch counts, top
   operators by device time); Q18's IN subquery alone on the device and
   host paths (on the device it may copy device->host only in its
   finalize: at most 2 copies), and the peak device memory of Q18, its
   subquery and Q3; each kernel's time at its
   main-path shape beside its bound, its plain version's time and a
   library call as the yardstick (`index_add_` for B1/B2 with one
   accumulator, and for the fused update one `index_add_` of the [R, 23]
   stacked contributions; searchsorted left + right for B3 and
   tidb_probe_count), and the time of what each fused kernel replaces
   (the single-column calls; the eager probe chain). tidb_probe_count is
   timed on the recorded arguments of Q18's table route (flags-only and
   full), Q3's direct route and Q5's sorted route (a phase-1 case of the
   route where the plan takes it nowhere), and on a cap-2^18
   table. The full report goes to chiprun_out/chip_smoke.json.

The card's name and power limit are printed first; the line before the
last is one JSON object {"kernels": [...]}, the last {"ok": true,
"device": {...}}. Without a CUDA card, or without the repository beside
it, it prints no result and exits non-zero."""

import copy
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12    # H100 SXM non-tensor FP32 peak, used for adds
Q1_ROWS = 65536             # Q1's chunk capacity at SF1 (tidb_max_chunk_size)
Q1_GROUPS = 12              # (3 returnflags + NULL) x (2 linestatuses + NULL)
OUT_DIR = "chiprun_out"
I64_MAX = (1 << 63) - 1
M64 = (1 << 64) - 1
FP_SALT = 0x9E3779B97F4A7C15  # the hash probe's fingerprint salt
# operations per probe in B3: two splitmix64 tails (xor, shift, multiply
# twice each, then the final xor-shift and the EMPTY remap: 9 each) and,
# per slot read, a slot index, a compare against EMPTY and the fingerprint
MIX_OPS, SLOT_OPS = 18, 3


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def device_ms(torch, fn, graph: bool, calls: int = 20, reps: int = 10) -> float:
    """Device time per call. With `graph`, replays a CUDA graph of `calls`
    calls, so the host's launch cost drops out; a function that cannot be
    captured (the plain versions synchronise on boolean-mask indexing) is
    timed as a loop of calls between CUDA events, host gaps included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm-up on the capture stream
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (reps * calls)
    start.record()
    for _ in range(reps * calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(torch, np, seg_mod):
    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    info = np.iinfo(np.int64)
    extremes = np.array([info.max, info.min, info.max - 1, info.min + 1, -1, 1, 0],
                        dtype=np.int64)
    over_budget = 16384  # 16384 x 8 B = 128 KiB > the kernel's 96 KiB budget
    cases = [(Q1_ROWS, 1), (Q1_ROWS, Q1_GROUPS), (Q1_ROWS, 8192),
             (Q1_ROWS, over_budget), (Q1_ROWS + 37, Q1_GROUPS), (1000, 300)]
    err = {"segsum_count": 0, "segsum_i64": 0, "segsum_f32": 0.0}
    for R, G in cases:
        seg = rng.integers(0, G, R)
        bad = rng.random(R) < 0.1
        seg[bad] = G + rng.integers(0, 7, int(bad.sum()))  # ids >= G drop
        seg_t = torch.from_numpy(seg.astype(np.int64)).to(dev)
        mask = torch.from_numpy(rng.random(R) < 0.5).to(dev)
        dec = torch.from_numpy(rng.integers(-10**13, 10**13, R, dtype=np.int64)).to(dev)
        ext = torch.from_numpy(extremes[rng.integers(0, len(extremes), R)]).to(dev)
        f = torch.from_numpy(rng.standard_normal(R).astype(np.float32)).to(dev)

        got = seg_mod.segment_count(mask, seg_t, G)
        want = seg_mod.plain_segment_count(mask, seg_t, G)
        if not torch.equal(got, want):
            raise AssertionError(f"segsum_count R={R} G={G} differs from plain")
        for name, vals in (("decimal", dec), ("extremes", ext)):
            got = seg_mod.segment_sum_i64(vals, seg_t, G)
            want = seg_mod.plain_segment_sum_i64(vals, seg_t, G)
            if not torch.equal(got, want):
                raise AssertionError(f"segsum_i64 {name} R={R} G={G} differs from plain")
        got = seg_mod.segment_sum_f32(f, seg_t, G).double()
        want = seg_mod.plain_segment_sum_f32(f, seg_t, G).double()
        mass = seg_mod.plain_segment_sum_f32(f.abs(), seg_t, G).double()
        diff = (got - want).abs()
        if bool((diff > 1e-5 * mass + 1e-6).any()):
            raise AssertionError(f"segsum_f32 R={R} G={G}: max diff {float(diff.max())}")
        err["segsum_f32"] = max(err["segsum_f32"], float(diff.max()))
        torch.cuda.synchronize()
        log(f"kernel check R={R} G={G}: count, i64 (decimal, extremes) bit-equal; "
            f"f32 max |diff| {float(diff.max()):.3e}")
    return err


Q1_DECIMALS = 7  # Q1's decimal SUMs and AVGs: two limbs and a count each


def q1_accs(torch, seg_mod, vals, masks, G, dev):
    """Q1's 16 accumulators (23 [G] outputs) over `vals`/`masks` (one per
    decimal aggregate): occ, count(*), then a two-limb sum and a count per
    decimal SUM/AVG, as executor/aggregate.py's update builds them."""
    def z():
        return torch.zeros(G, dtype=torch.int64, device=dev)

    accs = [seg_mod.SegAcc("count", z()), seg_mod.SegAcc("count", z())]
    for v, m in zip(vals, masks):
        accs.append(seg_mod.SegAcc("limbs", z(), vals=v, mask=m, out_hi=z()))
        accs.append(seg_mod.SegAcc("count", z(), mask=m))
    return accs


def segagg_cases():
    """name -> (R, G, options) of the fused kernel's phase-1 cases."""
    cases = {f"mixed_G{G}": (Q1_ROWS, G, {}) for G in (1, 12, 26, 33, 300, 8192)}
    cases.update({
        "q1_shape": (Q1_ROWS, Q1_GROUPS, {"q1": True}),
        "global_atomics": (Q1_ROWS, 1 << 16, {}),  # 2 x 512 KiB > the 96 KiB budget
        "ragged_r": (Q1_ROWS + 37, Q1_GROUPS, {}),
        "ragged_hist": (1000, 300, {}),
        "no_sel": (Q1_ROWS, 26, {"no_sel": True}),
        "all_false": (Q1_ROWS, Q1_GROUPS, {"all_false": True}),
        "misaligned": (Q1_ROWS + 3, Q1_GROUPS, {"misaligned": True}),
        "forty_accs": (Q1_ROWS, Q1_GROUPS, {"many": 40}),
    })
    return cases


def make_segagg_case(torch, np, seg_mod, R, G, opts, seed, dev):
    """(seg, sel, accs) on the card: ids with a tenth at or above G and a
    twentieth below 0, outputs holding random state, int64 extremes and
    decimals, masks with NULLs; `misaligned` offsets every row operand by
    one element from a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    off = 1 if opts.get("misaligned") else 0

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t[off:] if off else t

    n = R + off
    seg = rng.integers(0, G, n)
    bad = rng.random(n)
    seg[bad < 0.1] = G + rng.integers(0, 7, int((bad < 0.1).sum()))
    seg[bad > 0.95] = -rng.integers(1, 4, int((bad > 0.95).sum()))
    sel = rng.random(n) < 0.7
    if opts.get("all_false"):
        sel[:] = False
    info = np.iinfo(np.int64)
    pool = np.array([info.max, info.min, info.max - 1, info.min + 1, -1, 1, 0], np.int64)

    def vals(i):
        if i % 2:
            return put(pool[rng.integers(0, len(pool), n)])
        return put(rng.integers(-10**13, 10**13, n, dtype=np.int64))

    def mask():
        return put(rng.random(n) < 0.8)

    def state():
        return torch.from_numpy(rng.integers(-10**6, 10**6, G, dtype=np.int64)).to(dev)

    if opts.get("q1"):
        accs = q1_accs(torch, seg_mod, [vals(i) for i in range(Q1_DECIMALS)],
                       [mask() for _ in range(Q1_DECIMALS)], G, dev)
        for a in accs:
            a.out.copy_(state())
            if a.out_hi is not None:
                a.out_hi.copy_(state())
    elif opts.get("many"):
        accs = [seg_mod.SegAcc("sum", state(), vals=vals(i), mask=mask())
                for i in range(opts["many"])]
    else:
        null = mask()
        null.zero_()  # a column that is NULL on every row
        accs = [seg_mod.SegAcc("count", state()),
                seg_mod.SegAcc("count", state(), mask=mask()),
                seg_mod.SegAcc("count", state(), mask=null),
                seg_mod.SegAcc("sum", state(), vals=vals(0), mask=mask()),
                seg_mod.SegAcc("sum", state(), vals=vals(1)),
                seg_mod.SegAcc("limbs", state(), vals=vals(2), mask=mask(), out_hi=state()),
                seg_mod.SegAcc("limbs", state(), vals=vals(3), mask=null, out_hi=state()),
                seg_mod.SegAcc("limbs", state(), vals=vals(5), out_hi=state())]
    return put(seg), None if opts.get("no_sel") else put(sel), accs


def check_segagg_case(torch, seg_mod, seg, G, sel, accs) -> int:
    """tidb_segagg against plain_segment_accumulate on the same state;
    raises unless every output is bit-equal. Returns the launches made."""
    plain = []
    for a in accs:
        b = copy.copy(a)
        b.out = a.out.clone()
        b.out_hi = None if a.out_hi is None else a.out_hi.clone()
        plain.append(b)
    n0 = seg_mod.LAUNCHES["segagg"]
    seg_mod.segment_accumulate(seg, G, sel, accs)
    seg_mod.plain_segment_accumulate(seg, G, sel, plain)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(accs, plain)):
        if not torch.equal(a.out, b.out) or (
                a.out_hi is not None and not torch.equal(a.out_hi, b.out_hi)):
            raise AssertionError(f"segagg accumulator {k} ({a.kind}) differs from plain")
    return seg_mod.LAUNCHES["segagg"] - n0


def phase_segagg(torch, np, seg_mod) -> dict:
    """Phase 1 for the fused kernel: every case of segagg_cases on the card,
    each bit-equal to plain_segment_accumulate."""
    out = {}
    for i, (name, (R, G, opts)) in enumerate(segagg_cases().items()):
        seg, sel, accs = make_segagg_case(torch, np, seg_mod, R, G, opts, 3000 + i, "cuda")
        launches = check_segagg_case(torch, seg_mod, seg, G, sel, accs)
        want = -(-len(accs) // seg_mod.MAX_ACCS)
        if launches != want:
            raise AssertionError(f"segagg {name}: {launches} launches, expected {want}")
        outs = sum(2 if a.kind == "limbs" else 1 for a in accs)
        out[name] = {"R": R, "G": G, "accumulators": len(accs), "outputs": outs,
                     "launches": launches}
        log(f"segagg check {name}: R={R} G={G} {len(accs)} accumulators ({outs} "
            f"outputs), {launches} launch(es): bit-equal to plain")
    return out


def sass_atomics(path: str, nvcc: str) -> dict:
    """Atomic opcodes per kernel in a built library (cuobjdump -sass, from
    nvcc's directory): whether 64-bit shared-memory adds are one
    ATOMS.ADD.64 or a CAS loop."""
    import re  # local: numpy_q5 names its region table `re`

    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    try:
        r = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                           timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": str(e)}
    found, fn = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)(?:\.[A-Z0-9_]+)+)", line):
            found.setdefault(fn, {})
            found[fn][op] = found[fn].get(op, 0) + 1
    return found or {"error": (r.stderr or "no atomics found")[-500:]}


def _unshift(y: int, s: int) -> int:
    """Inverse of x ^ (x >> s) on 64 bits."""
    x, t = y, y >> s
    while t:
        x ^= t
        t >>= s
    return x


def empty_preimage(salt: int) -> int:
    """The int64 key whose splitmix64 tail (with `salt`) has low 32 bits
    0x7FFFFFFF, the probe table's EMPTY sentinel (the tail is invertible)."""
    h = _unshift(0x7FFFFFFF, 31)
    h = (h * pow(0x94D049BB133111EB, -1, 1 << 64)) & M64
    h = _unshift(h, 27)
    h = (h * pow(0xBF58476D1CE4E5B9, -1, 1 << 64)) & M64
    h = _unshift(h, 30) ^ salt
    return h - (1 << 64) if h >= (1 << 63) else h


def probe_cases(np):
    """name -> (sorted int64 build keys, int64 probe keys) for B3."""
    rng = np.random.default_rng(2027)
    R = Q1_ROWS
    info = np.iinfo(np.int64)
    ext = np.array([info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max, info.max])
    q18 = np.sort(rng.choice(np.arange(1, 1_500_001), 57, replace=False))
    q18_probes = rng.integers(1, 1_500_001, R)
    q18_probes[rng.integers(0, R, 399)] = rng.choice(q18, 399)  # ~7 lines per key
    pre = [empty_preimage(0), empty_preimage(FP_SALT)]
    dups = np.repeat(rng.integers(0, 1 << 40, 1 << 17), 2)
    cases = {
        # Q18's semi join: ~60 runs padded to the build's shape bucket
        "q18_shape": (np.concatenate([q18, np.full(64 - len(q18), I64_MAX)]), q18_probes),
        "random_dups": (rng.integers(-500, 500, 4000) * 7919,
                        rng.integers(-800, 800, R) * 7919),
        "same_home_cluster": (np.arange(64) << 40, np.resize(np.arange(-8, 72) << 40, R)),
        "full_int64": (ext, np.resize(np.array([info.min, info.min + 2, -1, 0, 2, info.max,
                                                 info.max - 1, 7]), R)),
        "over_capacity": (rng.integers(0, 1 << 40, 1 << 19), rng.integers(0, 1 << 40, R)),
        # bucket 2^18, capacity 2^19: the largest build the table takes
        "largest_eligible": (dups, np.concatenate([rng.choice(dups, R // 2),
                                                   rng.integers(0, 1 << 40, R // 2)])),
        "ragged_r": (rng.integers(-500, 500, 4000) * 7919,
                     rng.integers(-800, 800, R + 37) * 7919),
        "all_miss": (np.arange(0, 4000, 2) << 20, np.resize(np.arange(1, 4001, 2) << 20, R)),
        "empty_sentinel": (np.array(pre + [5, 0x7FFFFFFF]),
                           np.resize(np.array(pre + [5, 6, 0x7FFFFFFF]), R)),
    }
    return {k: (np.sort(np.asarray(b, dtype=np.int64)), np.asarray(p, dtype=np.int64))
            for k, (b, p) in cases.items()}


def check_probe_case(torch, hp, sk, pr) -> dict:
    """B3 against its plain version and searchsorted on one case; raises
    on any difference. Returns what the case exercised."""
    ss_lo, ss_hi = hp.sorted_probe_ranges(sk, pr)
    ss_cnt = ss_hi - ss_lo
    cap = hp.table_capacity(sk.shape[0])
    if cap is None:
        # over capacity: the join keeps searchsorted and launches nothing
        n0 = hp.LAUNCHES["hash_probe"]
        lo, hi = hp.probe_ranges(sk, pr)
        if hp.LAUNCHES["hash_probe"] != n0 or not (
                torch.equal(lo, ss_lo) and torch.equal(hi, ss_hi)):
            raise AssertionError("an over-capacity build did not keep searchsorted")
        return {"cap": None, "placed": None, "hits": int((ss_cnt > 0).sum())}
    tkeys, tlos, this, placed = hp.build_table(sk, cap)
    lo, hi = hp.probe_table(tkeys, tlos, this, sk, pr)
    p_lo, p_hi = hp.plain_probe_table(tkeys, tlos, this, sk, pr)
    if not (torch.equal(lo, p_lo) and torch.equal(hi, p_hi)):
        bad = int(((lo != p_lo) | (hi != p_hi)).sum())
        raise AssertionError(f"hash_probe differs from its plain version on {bad} keys")
    placed = bool(placed)
    if placed:
        cnt = hi - lo
        hit = ss_cnt > 0
        if not (torch.equal(cnt, ss_cnt) and torch.equal(lo[hit], ss_lo[hit])):
            raise AssertionError("hash_probe ranges differ from searchsorted")
    else:  # the join falls back to searchsorted for such a build
        f_lo, f_hi = hp.probe_ranges(sk, pr)
        if not (torch.equal(f_lo, ss_lo) and torch.equal(f_hi, ss_hi)):
            raise AssertionError("an unplaced build did not fall back to searchsorted")
    return {"cap": cap, "placed": placed, "hits": int((ss_cnt > 0).sum())}


def phase_probe(torch, np, hp) -> dict:
    """Phase 1 for B3: every case of probe_cases on the card."""
    out = {}
    for name, (b, p) in probe_cases(np).items():
        sk = torch.from_numpy(b).cuda()
        pr = torch.from_numpy(p).cuda()
        out[name] = check_probe_case(torch, hp, sk, pr)
        torch.cuda.synchronize()
        log(f"hash_probe check {name}: R={len(p)} build={len(b)} {out[name]}: "
            f"bit-equal to the plain scan, counts equal searchsorted")
    return out


CHUNK_OUTPUTS = ("start", "count", "real_count", "cum", "total", "ok", "matched")


def probe_count_cases():
    """name -> (R, build length, options) of tidb_probe_count's phase-1
    cases: each route with and without the LEFT pad and in the flags-only
    mode, at Q1_ROWS rows and at a row count that is not a multiple of the
    kernel's 512-row tile; a table above the shared-memory limit (2^17
    build rows, capacity 2^18), a build holding the EMPTY-preimage keys,
    two-key range packing (with keys out of range), hash packing and a
    chunk smaller than one tile."""
    R = Q1_ROWS
    cases = {}
    for route in ("direct", "table", "sorted"):
        cases[route] = (R, 4096, {"route": route})
        cases[f"{route}_left"] = (R, 4096, {"route": route, "left_pad": True})
        cases[f"{route}_flags"] = (R, 4096, {"route": route, "flags_only": True})
        cases[f"{route}_ragged"] = (R + 37, 4096, {"route": route, "left_pad": True})
    cases.update({
        "table_cap_2e18": (R, 1 << 17, {"route": "table"}),
        "table_cap_2e18_flags": (R + 37, 1 << 17, {"route": "table", "flags_only": True}),
        "table_empty_preimage": (R, 64, {"route": "table", "preimage": True}),
        "two_key_direct": (R, 4096, {"route": "direct", "keys": 2}),
        "two_key_sorted": (R, 4096, {"route": "sorted", "keys": 2, "left_pad": True}),
        "two_key_table": (R, 4096, {"route": "table", "keys": 2}),
        "hash_table": (R, 4096, {"route": "table", "hash": True}),
        "hash_sorted": (R, 4096, {"route": "sorted", "hash": True, "left_pad": True}),
        "one_partial_tile": (100, 64, {"route": "table", "left_pad": True}),
    })
    return cases


def make_probe_count_case(torch, np, jk, hp, R, B, opts, seed, dev) -> dict:
    """The arguments of join_kernels.probe_count for one case, built on the
    CPU and moved to `dev`: a build of B sorted packed keys (an eighth of
    them dead INT64_MAX padding; two live INT64_MAX keys on the table and
    sorted routes) with its direct index or table, and R probe rows with
    NULL keys (5%), sel holes (15%), absent keys and INT64 extremes."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(np.int64)
    route, n_keys, hashed = opts["route"], opts.get("keys", 1), opts.get("hash", False)
    n = B - B // 8
    if hashed:
        build_cols = [rng.integers(-50, 50, n) * (1 << 40), rng.integers(0, 9, n) / 4.0]
        probe_cols = [rng.integers(-60, 60, R) * (1 << 40), rng.integers(0, 11, R) / 4.0]
    elif n_keys == 2:
        build_cols = [rng.integers(-20, 40, n), rng.integers(1000, 1100, n)]
        probe_cols = [rng.integers(-30, 50, R), rng.integers(990, 1110, R)]
    elif route == "direct":
        build_cols = [rng.integers(-1000, 2000, n)]
        probe_cols = [rng.integers(-1100, 2100, R)]
    else:
        build_cols = [np.resize(rng.integers(-(1 << 20), 1 << 20, (n + 1) // 2).repeat(2), n)
                      * 7919]
        build_cols[0][:2] = info.max  # legitimate INT64_MAX keys before the dead tail
        probe_cols = [rng.integers(-(1 << 20), 1 << 20, R) * 7919]
        hits = rng.random(R) < 0.4
        probe_cols[0][hits] = rng.choice(build_cols[0], int(hits.sum()))
    if opts.get("preimage"):
        pre = [empty_preimage(0), empty_preimage(FP_SALT)]
        build_cols[0][2:4] = pre
        probe_cols[0][rng.integers(0, R, R // 8)] = rng.choice(pre, R // 8)
    if n_keys == 1 and not hashed:
        ext = np.array([info.min, info.min + 1, -1, 0, info.max - 1, info.max])
        probe_cols[0][rng.integers(0, R, R // 50)] = rng.choice(ext, R // 50)
    modes = tuple("bits" if c.dtype.kind == "f" else "int" for c in build_cols)
    bk = [torch.from_numpy(np.ascontiguousarray(c)) for c in build_cols]
    if hashed:
        los = strides = rngs = [0] * n_keys
        packed = jk.hash_combine_device([jk.as_int64_key(k, m) for k, m in zip(bk, modes)])
    else:
        lo_hi = [(int(c.min()), int(c.max())) for c in build_cols]
        los = [lo for lo, _ in lo_hi]
        # as the join's pack info: a single key spanning (almost) all of
        # int64 gets range 0, "unknown" (its probe packer ignores ranges)
        rngs = [hi - lo + 1 if hi - lo + 1 < (1 << 63) else 0 for lo, hi in lo_hi]
        strides = [1] + [int(np.prod(rngs[:i])) for i in range(1, n_keys)]
        ones = torch.ones(n, dtype=torch.bool)
        packed, _, _ = jk.pack_keys(bk, (ones,) * n_keys, los, strides, rngs, ones, modes,
                                    False)
    sk = torch.cat([packed.sort().values, torch.full((B - n,), I64_MAX, dtype=torch.int64)])
    n_build = torch.tensor(n, dtype=torch.int64)
    firsts, lo_packed, rng_packed, table = torch.zeros(2, dtype=torch.int64), 0, 0, None
    if route == "direct":
        lo_packed = los[0] if n_keys == 1 else 0
        rng_packed = rngs[0] if n_keys == 1 else strides[-1] * rngs[-1]
        firsts = jk.build_direct_index(sk, n_build, lo_packed, jk.shape_bucket(rng_packed))
    elif route == "table":
        table = hp.placed_table(sk)
        if table is None:
            raise AssertionError("a phase-1 table left a run unplaced")
    kd = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in probe_cols)
    return {"sorted_keys": sk.to(dev), "n_build": n_build.to(dev), "key_datas": kd,
            "key_valids": tuple(torch.from_numpy(rng.random(R) < 0.95).to(dev) for _ in kd),
            "sel": torch.from_numpy(rng.random(R) < 0.85).to(dev), "los": los,
            "strides": strides, "rngs": rngs, "firsts": firsts.to(dev),
            "lo_packed": lo_packed, "rng_packed": rng_packed, "modes": modes,
            "hash_mode": hashed, "left_pad": opts.get("left_pad", False),
            "direct": route == "direct",
            "table": None if table is None else tuple(t.to(dev) for t in table),
            "flags_only": opts.get("flags_only", False)}


def chunk_args(jk, case: dict):
    """(positional, keyword) arguments of hash_probe.probe_chunk for a
    probe_count case: its keys packed as join_kernels.probe_count packs
    them."""
    packed, kvalid, in_range = jk._pack(
        case["key_datas"], case["key_valids"], case["los"], case["strides"], case["rngs"],
        case["sel"], case["modes"], case["hash_mode"])
    route = "direct" if case["direct"] else ("table" if case["table"] is not None else "sorted")
    kw = {"route": route, "firsts": case["firsts"], "lo_packed": case["lo_packed"],
          "rng_packed": case["rng_packed"], "table": case["table"],
          "left_pad": case["left_pad"], "flags_only": case["flags_only"]}
    return (packed, kvalid, in_range, case["sel"], case["n_build"], case["sorted_keys"]), kw


def check_chunk(torch, hp, args, kw) -> dict:
    """tidb_probe_count against plain_probe_chunk on the same card inputs;
    raises unless all seven outputs are bit-equal (the five scan outputs
    are None on both sides in the flags-only mode). Returns the launches
    made, the matched rows and the total."""
    n0 = hp.LAUNCHES["probe_count"]
    got = hp.probe_chunk(*args, **kw)
    launches = hp.LAUNCHES["probe_count"] - n0
    want = hp.plain_probe_chunk(*args, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(CHUNK_OUTPUTS, got, want):
        if (g is None) != (w is None) or (w is not None and not torch.equal(g, w)):
            bad = "one is None" if g is None or w is None else int((g != w).sum())
            raise AssertionError(f"probe_count {name} differs from plain ({bad})")
    return {"launches": launches, "matched": int(got[6].sum()),
            "total": None if got[4] is None else int(got[4])}


def phase_probe_count(torch, np, jk, hp) -> dict:
    """Phase 1 for tidb_probe_count: every case of probe_count_cases on the
    card, all seven outputs bit-equal to plain_probe_chunk, one launch
    each."""
    out = {}
    for i, (name, (R, B, opts)) in enumerate(probe_count_cases().items()):
        case = make_probe_count_case(torch, np, jk, hp, R, B, opts, 4000 + i, "cuda")
        args, kw = chunk_args(jk, case)
        out[name] = check_chunk(torch, hp, args, kw)
        if out[name]["launches"] != 1:
            raise AssertionError(f"probe_count {name}: {out[name]['launches']} launches")
        log(f"probe_count check {name}: R={R} build={B} {kw['route']} "
            f"left_pad={kw['left_pad']} flags_only={kw['flags_only']} {out[name]}: "
            f"bit-equal to plain")
    return out


# ---------------------------------------------------------------------------
# phase 2: Q1, Q6, Q3, Q5 and Q18 at SF1 through the port's Session
# ---------------------------------------------------------------------------


def _days(np, iso: str) -> int:
    return int((np.datetime64(iso) - np.datetime64("1970-01-01")).astype(np.int64))


def numpy_q1(np, t):
    n = t.n
    d = {c: t.data[c][:n] for c in ("l_quantity", "l_extendedprice", "l_discount",
                                    "l_tax", "l_shipdate", "l_returnflag",
                                    "l_linestatus")}
    m = d["l_shipdate"] <= _days(np, "1998-09-02")  # 1998-12-01 - 90 days
    rf_vals, ls_vals = t.dicts["l_returnflag"].values, t.dicts["l_linestatus"].values
    rows = []
    for rf in range(len(rf_vals)):
        for ls in range(len(ls_vals)):
            g = m & (d["l_returnflag"] == rf) & (d["l_linestatus"] == ls)
            cnt = int(g.sum())
            if not cnt:
                continue
            qty = d["l_quantity"][g]
            ext = d["l_extendedprice"][g]
            disc = d["l_discount"][g]
            tax = d["l_tax"][g]
            disc_price = ext * (100 - disc)                 # scale 4
            charge = disc_price * (100 + tax)               # scale 6
            rows.append((rf_vals[rf], ls_vals[ls], int(qty.sum()), int(ext.sum()),
                         int(disc_price.sum()), int(charge.sum()),
                         float(qty.sum()) / 100 / cnt, float(ext.sum()) / 100 / cnt,
                         float(disc.sum()) / 100 / cnt, cnt))
    return sorted(rows)


def numpy_q6(np, t):
    n = t.n
    ship = t.data["l_shipdate"][:n]
    disc = t.data["l_discount"][:n]
    m = ((ship >= _days(np, "1994-01-01")) & (ship < _days(np, "1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (t.data["l_quantity"][:n] < 2400))
    return int((t.data["l_extendedprice"][:n][m] * disc[m]).sum())  # scale 4


def _scaled(s: str) -> int:
    """An exact decimal string -> its scaled integer ('12.50' -> 1250)."""
    return int(s.replace(".", ""))


def check_q1(np, got, want):
    if len(got) != len(want):
        raise AssertionError(f"Q1: {len(got)} rows, numpy has {len(want)}")
    for g, w in zip(got, want):
        if tuple(g[:2]) != w[:2] or g[9] != w[9]:
            raise AssertionError(f"Q1 keys/count differ: {g} vs {w}")
        if [_scaled(x) for x in g[2:6]] != list(w[2:6]):
            raise AssertionError(f"Q1 decimal sums differ: {g} vs {w}")
        for a, b in zip(g[6:9], w[6:9]):
            if not (np.isfinite(a) and abs(a - b) <= 1e-12 * abs(b)):
                raise AssertionError(f"Q1 averages differ: {g} vs {w}")


def _cols(t, *names):
    return [t.data[c][:t.n] for c in names]


def _iso(np, days: int) -> str:
    return str(np.datetime64("1970-01-01") + np.timedelta64(int(days), "D"))


def _lookup(np, keys, n_max):
    """key -> row position (-1 where absent) over keys in [0, n_max]."""
    pos = np.full(n_max + 1, -1, dtype=np.int64)
    pos[keys] = np.arange(len(keys))
    return pos


def _group_sum(np, keys, vals):
    """(sorted distinct keys, exact int64 sum of vals per key)."""
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(sums, inv, vals.astype(np.int64))
    return uniq, sums


def numpy_q3(np, cat):
    c, o, li = (cat.table("test", n) for n in ("customer", "orders", "lineitem"))
    d0 = _days(np, "1995-03-15")
    ckey, cseg = _cols(c, "c_custkey", "c_mktsegment")
    building = np.zeros(int(ckey.max()) + 1, dtype=bool)
    building[ckey[cseg == c.dicts["c_mktsegment"].values.index("BUILDING")]] = True
    okey, ocust, odate, oprio = _cols(o, "o_orderkey", "o_custkey", "o_orderdate",
                                      "o_shippriority")
    keep_o = (odate < d0) & building[ocust]
    opos = _lookup(np, okey, int(okey.max()))
    lkey, ship, ext, disc = _cols(li, "l_orderkey", "l_shipdate", "l_extendedprice",
                                  "l_discount")
    row = opos[lkey]
    m = (ship > d0) & (row >= 0) & keep_o[np.maximum(row, 0)]
    uniq, rev = _group_sum(np, lkey[m], ext[m] * (100 - disc[m]))  # scale 4
    od = odate[opos[uniq]]
    top = np.lexsort((od, -rev))[:10]
    return [(int(uniq[i]), int(rev[i]), _iso(np, od[i]), int(oprio[opos[uniq[i]]]))
            for i in top]


def numpy_q5(np, cat):
    c, o, li, su, na, re = (cat.table("test", n) for n in (
        "customer", "orders", "lineitem", "supplier", "nation", "region"))
    rkey, rname = _cols(re, "r_regionkey", "r_name")
    asia = rkey[rname == re.dicts["r_name"].values.index("ASIA")]
    nkey, nname, nreg = _cols(na, "n_nationkey", "n_name", "n_regionkey")
    in_asia = np.zeros(int(nkey.max()) + 1, dtype=bool)
    in_asia[nkey[np.isin(nreg, asia)]] = True
    ckey, cnat = _cols(c, "c_custkey", "c_nationkey")
    cnat_of = np.full(int(ckey.max()) + 1, -1)
    cnat_of[ckey] = cnat
    skey, snat = _cols(su, "s_suppkey", "s_nationkey")
    snat_of = np.full(int(skey.max()) + 1, -2)
    snat_of[skey] = snat
    okey, ocust, odate = _cols(o, "o_orderkey", "o_custkey", "o_orderdate")
    in_year = (odate >= _days(np, "1994-01-01")) & (odate < _days(np, "1995-01-01"))
    opos = _lookup(np, okey, int(okey.max()))
    lkey, lsupp, ext, disc = _cols(li, "l_orderkey", "l_suppkey", "l_extendedprice",
                                   "l_discount")
    row = np.maximum(opos[lkey], 0)
    sn = snat_of[lsupp]
    m = ((opos[lkey] >= 0) & in_year[row] & (cnat_of[ocust[row]] == sn)
         & in_asia[np.maximum(sn, 0)])
    nat, rev = _group_sum(np, sn[m], ext[m] * (100 - disc[m]))
    names = na.dicts["n_name"].values
    name_of = {int(k): names[int(n)] for k, n in zip(nkey, nname)}
    return sorted(((name_of[int(k)], int(v)) for k, v in zip(nat, rev)),
                  key=lambda r: -r[1])


def numpy_q18(np, cat, threshold=30000):
    """Q18's rows, and its semi join's sorted build keys (the orders whose
    quantity sum, at scale 2, exceeds the threshold)."""
    c, o, li = (cat.table("test", n) for n in ("customer", "orders", "lineitem"))
    lkey, qty = _cols(li, "l_orderkey", "l_quantity")
    uniq, tot = _group_sum(np, lkey, qty)
    big = uniq[tot > threshold]
    okey, ocust, odate, oprice = _cols(o, "o_orderkey", "o_custkey", "o_orderdate",
                                       "o_totalprice")
    opos = _lookup(np, okey, int(okey.max()))
    ckey, cname = _cols(c, "c_custkey", "c_name")
    cpos = _lookup(np, ckey, int(ckey.max()))
    names = c.dicts["c_name"].values
    rows = []
    for k, q in zip(big, tot[tot > threshold]):
        r = opos[k]
        if r < 0 or cpos[ocust[r]] < 0:
            continue
        rows.append((names[int(cname[cpos[ocust[r]]])], int(ocust[r]), int(k),
                     int(odate[r]), int(oprice[r]), int(q)))
    rows.sort(key=lambda r: (-r[4], r[3]))
    rows = [(a, b, k, _iso(np, d), p, q) for a, b, k, d, p, q in rows[:100]]
    return rows, np.sort(big.astype(np.int64))


def check_join_rows(qname, got, want, decimal_cols):
    """Port rows (decimal strings) against numpy rows (scaled ints)."""
    if len(got) != len(want):
        raise AssertionError(f"{qname}: {len(got)} rows, numpy has {len(want)}")
    for g, w in zip(got, want):
        g = tuple(_scaled(v) if i in decimal_cols else v for i, v in enumerate(g))
        if g != tuple(w):
            raise AssertionError(f"{qname} differs: {g} vs {w}")


def trace_summary(trace_path: str) -> tuple:
    """From a profiled run's chrome trace: the host->device copies by kind
    ({"pinned"/"pageable": {"count", "bytes", "device_us"}}; the profiler
    names each copy 'Memcpy HtoD (Pinned -> Device)' or '(Pageable ->
    Device)'), the device->host copies ("d2h", 'Memcpy DtoH ...'), and each
    host thread's busy time in torch operators and
    CUDA runtime calls (the union of their intervals, in us), which shows
    the prefetch thread beside the statement's own."""
    with open(trace_path) as f:
        trace = json.load(f)
    copies = {"pinned": {"count": 0, "bytes": 0, "device_us": 0.0},
              "pageable": {"count": 0, "bytes": 0, "device_us": 0.0},
              "d2h": {"count": 0, "bytes": 0, "device_us": 0.0}}
    spans = {}
    for e in trace.get("traceEvents", []):
        name, cat = e.get("name", ""), e.get("cat")
        if cat == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name):
            kind = "d2h" if "DtoH" in name else "pinned" if "Pinned" in name else "pageable"
            copies[kind]["count"] += 1
            copies[kind]["bytes"] += int((e.get("args") or {}).get("bytes", 0))
            copies[kind]["device_us"] += float(e.get("dur", 0.0))
        elif cat in ("cpu_op", "cuda_runtime") and "dur" in e:
            ts = float(e["ts"])
            spans.setdefault(str(e.get("tid")), []).append((ts, ts + float(e["dur"])))
    busy = {}
    for tid, iv in spans.items():
        iv.sort()
        total, end = 0.0, None
        for a, b in iv:
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        busy[tid] = total
    return copies, busy


def profile_query(torch, session, sql: str) -> dict:
    """One warm run under torch.profiler: wall time, device busy time (the
    sum over the kernels and copies on the card), the idle share, the
    host->device copies split pinned/pageable (count, bytes), the host's
    cudaMemcpyAsync and launch counts, and the top entries by device and by
    host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.query(sql)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    trace_path = os.path.join(OUT_DIR, "profile_trace.tmp.json")
    prof.export_chrome_trace(trace_path)
    try:
        copies, thread_busy = trace_summary(trace_path)
    finally:
        os.remove(trace_path)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in on_card)
    host = [e for e in events if e.device_type == DeviceType.CPU]

    def row(e):
        return {"name": e.key, "count": e.count, "device_us": dev_us(e),
                "cpu_us": e.self_cpu_time_total}

    launch_apis = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                   "cuLaunchKernelEx")
    copy_apis = ("cudaMemcpyAsync",)
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "idle_share": 1.0 - busy_us / wall_us,
            "host_launches": {e.key: e.count for e in host if e.key in launch_apis},
            "host_copies": {e.key: {"count": e.count, "cpu_us": e.self_cpu_time_total}
                            for e in host if e.key in copy_apis},
            "h2d": {k: copies[k] for k in ("pinned", "pageable")}, "d2h": copies["d2h"],
            "host_thread_busy_us": thread_busy,
            "top_device": [row(e) for e in sorted(on_card, key=dev_us, reverse=True)[:8]],
            "top_host": [row(e) for e in sorted(
                host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]]}


def count_segment_chunks() -> list:
    """Count the chunks the segment aggregation updates, by wrapping the
    executor's make_segment_kernel; returns the one-element counter."""
    from tidb_tpu_torch.executor import aggregate as agg_mod

    counter = [0]
    real = agg_mod.make_segment_kernel

    def counting(*args, **kw):
        init_state, update, G = real(*args, **kw)

        def counted(state, chunk):
            counter[0] += 1
            return update(state, chunk)

        return init_state, counted, G

    agg_mod.make_segment_kernel = counting
    return counter


def run_query(session, mods, sql: str):
    """One run with the kernels' launch counters, the join's probe-route
    counter and the pipeline's and segment store's counters zeroed just
    before and read just after; returns (rows, counts, seconds)."""
    seg_mod, hp, jk, pl, st, agg_mod = mods
    seg_mod.reset_launches()
    hp.reset_launches()
    jk.reset_routes()
    pl.reset_counters()
    agg_mod.reset_counters()
    seg0 = dict(st.SCAN_SEGMENTS_TOTAL)
    t0 = time.perf_counter()
    rows = session.query(sql)
    dt = time.perf_counter() - t0
    pre = dict(pl.PIPELINE_PREFETCH_TOTAL)
    counts = {"launches": {**seg_mod.LAUNCHES, **hp.LAUNCHES},
              "routes": dict(jk.PROBE_ROUTES),
              "segments": {k: st.SCAN_SEGMENTS_TOTAL[k] - seg0[k] for k in seg0},
              "staged_batches": pre["hit"] + pre["wait"] + pre["inline"],
              "prefetch": pre, "h2d": dict(pl.PIPELINE_PREFETCH_BYTES),
              "stage_s": dict(pl.PIPELINE_STAGE_SECONDS),
              "cache": dict(pl.DEVICE_CACHE_TOTAL),
              "fused": dict(pl.PIPELINE_FUSED_TOTAL),
              "generic_runs": dict(agg_mod.DEVICE_GENERIC_TOTAL)}
    return rows, counts, dt


def fusible_joins(plan) -> int:
    """Inner/LEFT hash joins of a physical plan whose probe side peels to a
    plain table scan: the joins the builder's gates send to
    FusedScanProbeExec."""
    from tidb_tpu_torch.executor.builder import peel_stages
    from tidb_tpu_torch.planner.physical import PHashJoin, PScan

    n, stack = 0, [plan]
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        if (isinstance(node, PHashJoin) and node.kind in ("inner", "left")
                and node.other_cond is None and not node.exists_sem):
            _stages, base = peel_stages(node.children[1 - node.build_side])
            n += type(base) is PScan and base.table is not None
    return n


def frags(agg=0, generic=0, probe=0, topn=0, generic_classic=0) -> dict:
    """Fragments a run must take: fused segment ("agg") and generic
    aggregations, probes and top-k roots, and generic aggregations on the
    classic tree's device path ("generic_classic")."""
    return {"agg": agg, "generic": generic, "probe": probe, "topn": topn,
            "generic_classic": generic_classic}


def plan_fragments(plan, capacity: int) -> dict:
    """The fragments a physical plan calls for under the builder's gates and
    the device engine: an aggregation over a plain scan runs fused (segment
    or, for core generic functions, generic); other core generic
    aggregations take the classic tree's device path; fusible joins probe
    fused; an ORDER BY [LIMIT] over a plain scan whose state fits the chunk
    capacity runs as a fused top-k."""
    from tidb_tpu_torch.executor.builder import peel_stages
    from tidb_tpu_torch.planner.logical import core_generic_agg
    from tidb_tpu_torch.planner.physical import PHashAgg, PScan, PSort, PTopN

    out = frags(probe=fusible_joins(plan))
    stack = [plan]
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        if not node.children:
            continue
        _stages, base = peel_stages(node.children[0])
        scan = type(base) is PScan and base.table is not None
        if isinstance(node, PHashAgg):
            if node.strategy == "segment":
                out["agg"] += scan
            elif core_generic_agg(node.group_exprs, node.aggs):
                out["generic" if scan else "generic_classic"] += 1
        elif isinstance(node, (PTopN, PSort)) and node.items and scan:
            k = node.count + node.offset if isinstance(node, PTopN) else base.table.n
            out["topn"] += k <= capacity
    return out


def check_path(qname, c, agg_chunks, want: dict):
    """The launch contract of one query's run on one path: tidb_segagg once
    per aggregated chunk (one-column entries never), tidb_probe_count once
    per probe chunk (lookup-only never), and the fused fragments and device
    generic aggregations the plan calls for (`want`, from plan_fragments)."""
    lc = c["launches"]
    if lc["segagg"] != agg_chunks:
        raise AssertionError(f"{qname}: segagg launched {lc['segagg']} times over "
                             f"{agg_chunks} aggregated chunks, not once per chunk")
    if lc["segsum_count"] or lc["segsum_i64"] or lc["hash_probe"]:
        raise AssertionError(f"{qname} launched an off-path kernel entry: {lc}")
    if lc["probe_count"] != sum(c["routes"].values()):
        raise AssertionError(f"{qname}: probe_count launched {lc['probe_count']} times "
                             f"over {c['routes']} probe chunks, not once per chunk")
    got = {k: c["fused"][k] for k in ("agg", "generic", "probe", "topn")}
    got["generic_classic"] = c["generic_runs"]["classic"]
    if c["generic_runs"]["fused"] != c["fused"]["generic"] or got != want:
        raise AssertionError(f"{qname}: fragments {c['fused']}, device generic runs "
                             f"{c['generic_runs']}; the plan calls for {want}")


def packed_batch_phase(torch, np, Session, mods, agg_chunks) -> dict:
    """A 1,200,000-row table loaded with tidb_tpu_segment_rows = 8192
    before its first scan, so the fused scan packs k = 65,536 / 8,192 = 8
    segments a batch: one aggregate and one join over it, each equal to
    numpy, each through its fused executor, tidb_segagg once per staged
    batch."""
    n, nd = 1_200_000, 100_000
    rng = np.random.default_rng(5)
    k = rng.integers(0, 2 * nd, n).astype(np.int64)  # half the keys miss
    cvals = ["AIR", "MAIL", "RAIL", "SHIP", "TRUCK"]
    c = rng.integers(0, len(cvals), n)
    v = rng.integers(-100_000, 10_000_000, n).astype(np.int64)  # decimal(12,2)
    w = rng.integers(0, 1000, nd).astype(np.int64)
    s = Session()
    s.execute("set tidb_tpu_segment_rows = 8192")
    s.execute("create table big (k bigint, c varchar(8), v decimal(12,2))")
    s.execute("create table dim (k bigint, w bigint)")
    s.catalog.table("test", "big").insert_columns(
        {"k": k, "v": v}, strings={"c": [cvals[i] for i in c]})
    s.catalog.table("test", "dim").insert_columns({"k": np.arange(nd), "w": w})
    out = {}
    agg_sql = "select c, count(*), sum(v) from big where v > 0 group by c order by c"
    agg_chunks[0] = 0
    rows, cnt, dt = run_query(s, mods, agg_sql)
    m = v > 0
    want = [(cvals[i], int((m & (c == i)).sum()), int(v[m & (c == i)].sum()))
            for i in range(len(cvals))]
    got = [(r[0], r[1], _scaled(r[2])) for r in rows]
    if got != want:
        raise AssertionError(f"packed aggregate {got} vs numpy {want}")
    n_segs = -(-n // 8192)
    if cnt["segments"]["scanned"] + cnt["segments"]["pruned"] != n_segs:
        raise AssertionError(f"packed aggregate read segments {cnt['segments']}")
    check_path("packed_agg", cnt, agg_chunks[0], frags(agg=1))
    if agg_chunks[0] != cnt["staged_batches"] or cnt["staged_batches"] != -(-n_segs // 8):
        raise AssertionError(f"packed aggregate: {cnt['staged_batches']} staged batches, "
                             f"{agg_chunks[0]} aggregated, {n_segs} segments")
    out["agg"] = {"counts": cnt, "seconds": dt}
    join_sql = ("select count(*), sum(dim.w), sum(big.v) from big join dim "
                "on big.k = dim.k where big.c <> 'RAIL'")
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner.physical import explain_text

    plan = s._plan_select(parse(join_sql)[0])
    agg_chunks[0] = 0
    rows, cnt, dt = run_query(s, mods, join_sql)
    hit = (k < nd) & (c != cvals.index("RAIL"))
    want = (int(hit.sum()), int(w[k[hit]].sum()), int(v[hit].sum()))
    got = (rows[0][0], int(rows[0][1]), _scaled(rows[0][2]))
    if got != want:
        raise AssertionError(f"packed join {got} vs numpy {want}")
    check_path("packed_join", cnt, agg_chunks[0], frags(probe=fusible_joins(plan)))
    if cnt["fused"]["probe"] != 1:
        raise AssertionError(f"the packed join did not run fused: {cnt['fused']}")
    out["join"] = {"counts": cnt, "seconds": dt, "plan": explain_text(plan)}
    log(f"packed batches (1,200,000 rows, 8,192-row segments, 8 a batch): aggregate "
        f"{cnt['staged_batches']} staged batches; both equal numpy; counts "
        f"{out['agg']['counts']} / {cnt}")
    return out


def probe_slot_reads(torch, hp, tkeys, tlos, sk, probes):
    """(slots read, distinct bytes read) of B3's scan for these probes: up
    to and including the first hit or EMPTY slot, at most MAX_PROBES (the
    work its early stop leaves); the bytes are the distinct 12-byte slots
    and 8-byte sorted keys verified, each counted once."""
    cap = tkeys.shape[0]
    home = hp._mix32(probes) & (cap - 1)
    fp = hp._mix32(probes, FP_SALT)
    done = torch.zeros(probes.shape, dtype=torch.bool, device=probes.device)
    slots, verified, reads = [], [], 0
    for r in range(hp.MAX_PROBES):
        pos = (home + r) & (cap - 1)
        act = ~done
        reads += int(act.sum())
        slots.append(pos[act])
        k = tkeys[pos].long()
        cand = tlos[pos].long().clamp(0, sk.shape[0] - 1)
        fpm = act & (k == fp)
        verified.append(cand[fpm])
        done |= (k == 0x7FFFFFFF) | (fpm & (sk[cand] == probes))
    return reads, (torch.unique(torch.cat(slots)).numel() * 12
                   + torch.unique(torch.cat(verified)).numel() * 8)


def record_probe_chunks(hp) -> dict:
    """Wrap hash_probe.probe_chunk for the main path's run: per (query,
    route, mode, build) the kernel calls made and the first one's
    arguments. The caller sets rec["query"] before each query and puts
    rec["real"] back when the run is over."""
    rec = {"query": None, "calls": {}, "args": {}, "real": hp.probe_chunk}

    def recording(*args, **kw):
        key = (rec["query"], kw["route"], "flags" if kw.get("flags_only") else "full",
               args[5].data_ptr())
        rec["calls"][key] = rec["calls"].get(key, 0) + 1
        rec["args"].setdefault(key, (args, kw))
        return rec["real"](*args, **kw)

    hp.probe_chunk = recording
    return rec


def main_path_args(rec, query: str, route: str, mode: str):
    """The recorded arguments of the build `query` probed most often along
    `route` in `mode` ('full' or 'flags'); of another query's build when
    this plan sent `query` elsewhere; None when no query took the route."""
    keys = [k for k in rec["calls"] if k[:3] == (query, route, mode)]
    if not keys:
        keys = [k for k in rec["calls"] if k[1:3] == (route, mode)]
    if not keys:
        return None
    return rec["args"][max(keys, key=rec["calls"].get)]


def chunk_lookup_work(torch, hp, args, kw):
    """(distinct bytes of the lookup structure read, operations) of one
    probe_chunk call on these inputs: the direct index's entries, the
    table's slots and verified sorted keys, or the sorted keys a search
    visits, each counted once; operations per row for the lookup and the
    count, pad and scan (about 6)."""
    packed, _kvalid, _in_range, _sel, _n_build, sk = args
    R = packed.shape[0]
    if kw["route"] == "direct":
        idxc = (packed - kw["lo_packed"]).clamp(0, kw["firsts"].shape[0] - 2)
        read = torch.unique(torch.cat([idxc, idxc + 1])).numel() * 8
        return read, R * (8 + 6)
    if kw["route"] == "table":
        reads, read = probe_slot_reads(torch, hp, kw["table"][0], kw["table"][1], sk, packed)
        return read, R * (MIX_OPS + 6) + reads * SLOT_OPS
    n = sk.shape[0]
    bl = torch.zeros(R, dtype=torch.int64, device=packed.device)
    bu = torch.zeros_like(bl)
    visited, levels = [], 0
    while n > 1:
        half = n >> 1
        visited += [bl + half, bu + half]
        bl = torch.where(sk[bl + half] < packed, bl + half, bl)
        bu = torch.where(sk[bu + half] <= packed, bu + half, bu)
        n -= half
        levels += 1
    visited += [bl, bu]
    return torch.unique(torch.cat(visited)).numel() * 8, R * (2 * (levels + 1) * 3 + 6)


def probe_chunk_row(torch, hp, name: str, args, kw, launches: int) -> dict:
    """The kernels-line row of tidb_probe_count on one shape: checked
    bit-equal first, then its graph-replayed time beside the eager chain
    it replaces (the earlier eager composition: the all-true in-range mask, B3's
    lookup on the table route, count, pad and cumsum, always in full),
    the plain version (a loop), searchsorted x2 and its bound."""
    packed, kvalid, in_range, sel, n_build, sk = args
    check_chunk(torch, hp, args, kw)
    R = packed.shape[0]
    ms = device_ms(torch, lambda: hp.probe_chunk(*args, **kw), graph=True)
    chain_kw = dict(kw, flags_only=False, lookup=hp.probe_table)
    chain_ms = device_ms(torch, lambda: hp.plain_probe_chunk(
        packed, kvalid, torch.ones_like(sel) if in_range is None else in_range, sel,
        n_build, sk, **chain_kw), graph=True)
    plain_ms = device_ms(torch, lambda: hp.plain_probe_chunk(*args, **kw), graph=False)
    library_ms = device_ms(torch, lambda: (torch.searchsorted(sk, packed),
                                           torch.searchsorted(sk, packed, right=True)),
                           graph=True)
    read, ops = chunk_lookup_work(torch, hp, args, kw)
    # keys, key validity, sel (and in-range) in; ok and matched out, and in
    # full mode start, count, real_count and cum and the total
    row_bytes = 10 + (in_range is not None) + (2 if kw["flags_only"] else 34)
    nbytes = R * row_bytes + read + (0 if kw["flags_only"] else 8)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    row = {"name": name, "route": "cuda", "source": "tidb_tpu_torch/ops/csrc/hash_probe.cu",
           "replaces": "tidb_tpu/ops/hash_probe.py:244",
           "also_replaces": "tidb_tpu/ops/join_kernels.py:311",
           "launches": launches, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms, "replaced_chain_ms": chain_ms}
    log(f"{name} at R={R} build={sk.shape[0]} ({kw['route']}, flags_only="
        f"{kw['flags_only']}, left_pad={kw['left_pad']}): {ms * 1e3:.2f} us/call, bound "
        f"{row['bound_ms'] * 1e3:.3f} us ({nbytes} B, {row_bytes} B/row), the eager chain "
        f"it replaces {chain_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
        f"searchsorted x2 {library_ms * 1e3:.2f} us; {launches} main-path launches")
    return row


def phase_paths(torch, np, s, mods, new_session, queries) -> dict:
    """Phase 2 on a Session `s` holding the TPC-H tables: the fused path
    (default sysvars), the classic raw path, and packed batches over a
    table of `new_session()`; every result against numpy, every launch
    contract checked. Returns what phases 3 and the report read."""
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner.physical import explain_text
    from tidb_tpu_torch.storage.tpch_queries import Q

    seg_mod, hp, jk, pl, st, agg_mod = mods
    li = s.catalog.table("test", "lineitem")
    n_rows = li.live_rows
    agg_chunks = count_segment_chunks()
    plans = {}

    # the default sysvars: the columnar segment store and the fused
    # pipelines. The first runs of Q1 and Q6 build the segment stores and
    # fill the device buffer cache; their second runs stage nothing
    results, per_query, cold = {}, {}, {}
    probes = record_probe_chunks(hp)
    for run in ("q1", "q1_warm", "q6", "q6_warm", "q3", "q5", "q18"):
        qname = run.split("_")[0]
        # the plan this run executes: segment stores built by earlier runs
        # feed the planner's statistics, so it is taken just before
        plans[qname] = s._plan_select(parse(Q[qname][0])[0])
        want = plan_fragments(plans[qname], s._plan_capacity(plans[qname]))
        if qname in ("q1", "q6") and want["agg"] != 1:
            raise AssertionError(f"{qname}'s plan has no fused segment aggregation")
        if qname in ("q3", "q18") and not want["generic"] + want["generic_classic"]:
            raise AssertionError(f"{qname}'s plan has no device generic aggregation")
        if qname == "q18" and not want["generic"]:
            raise AssertionError("q18's IN subquery is not a fused generic aggregation")
        agg_chunks[0] = 0
        probes["query"] = qname
        rows, cnt, dt = run_query(s, mods, Q[qname][0])
        cnt["aggregated_chunks"] = agg_chunks[0]
        per_query[run] = cnt
        if run == qname:
            results[qname], cold[qname] = rows, dt
        elif rows != results[qname]:
            raise AssertionError(f"{run} differs from the first run")
        log(f"{run} (fused): {dt:.3f} s; launches {cnt['launches']}; probe routes "
            f"{cnt['routes']}; segments scanned/pruned {cnt['segments']}; staged "
            f"batches {cnt['staged_batches']}; prefetch {cnt['prefetch']}; host->device "
            f"{cnt['h2d']}; staging host s {cnt['stage_s']}; device buffer cache {cnt['cache']}; fused {cnt['fused']}; "
            f"aggregated chunks {agg_chunks[0]}; device generic runs {cnt['generic_runs']}")
        check_path(run, cnt, agg_chunks[0], want)
        cnt["want"] = want
    hp.probe_chunk = probes["real"]
    for q in ("q1", "q6"):
        cold_c, warm_c = per_query[q], per_query[q + "_warm"]
        if not (cold_c["staged_batches"] == cold_c["aggregated_chunks"]
                == cold_c["h2d"]["copies"] > 0 and cold_c["h2d"]["h2d"] > 0):
            raise AssertionError(f"{q}: staging {cold_c}, not one pinned copy a batch")
        if warm_c["h2d"]["h2d"] or warm_c["staged_batches"] or warm_c["cache"]["hit"] < 1:
            raise AssertionError(f"{q}'s second run staged: {warm_c}")
        if warm_c["aggregated_chunks"] != cold_c["aggregated_chunks"]:
            raise AssertionError(f"{q}'s second run aggregated another batch count")
    if per_query["q18"]["routes"]["table"] <= 0:
        log("note: q18 made no table-route probe at SF1 under this plan")
    probe_modes = {}  # (route, mode) -> kernel launches over the five queries
    for (_q, route, mode, _b), n in probes["calls"].items():
        probe_modes[f"{route}/{mode}"] = probe_modes.get(f"{route}/{mode}", 0) + n
    log(f"probe_count launches by route and mode: {probe_modes}")

    def check_results(res, label):
        check_q1(np, res["q1"], numpy_q1(np, li))
        if len(res["q6"]) != 1 or _scaled(res["q6"][0][0]) != numpy_q6(np, li):
            raise AssertionError(f"{label} Q6 {res['q6']} vs numpy {numpy_q6(np, li)}")
        check_join_rows("q3", res["q3"], numpy_q3(np, s.catalog), {1})
        check_join_rows("q5", res["q5"], numpy_q5(np, s.catalog), {1})
        check_join_rows("q18", res["q18"], q18_want, {4, 5})
        if not res["q3"] or not res["q5"] or not res["q18"]:
            raise AssertionError(f"{label}: a join query returned no rows")

    q18_want, q18_build = numpy_q18(np, s.catalog)
    check_results(results, "fused")
    log(f"fused path: Q1 ({len(results['q1'])} groups), Q6, Q3 ({len(results['q3'])} "
        f"rows), Q5 ({len(results['q5'])}) and Q18 ({len(results['q18'])}) equal the "
        f"numpy evaluation")
    launches = {k: sum(per_query[r]["launches"][k] for r in per_query)
                for k in ("segagg", "segsum_count", "segsum_i64", "hash_probe",
                          "probe_count")}

    # the earlier path: no segment store, no fused pipeline (the raw
    # classic tree), the same queries and the same launch contract
    s.execute("set tidb_tpu_pipeline_fuse = 0")
    s.execute("set tidb_tpu_columnar_enable = 0")
    classic, classic_counts = {}, {}
    for qname in queries:
        agg_chunks[0] = 0
        rows, cnt, dt = run_query(s, mods, Q[qname][0])
        cnt["aggregated_chunks"] = agg_chunks[0]
        classic[qname], classic_counts[qname] = rows, cnt
        log(f"{qname} (classic): {dt:.3f} s; launches {cnt['launches']}; probe routes "
            f"{cnt['routes']}; fused {cnt['fused']}; aggregated chunks {agg_chunks[0]}; "
            f"device generic runs {cnt['generic_runs']}")
        want = per_query[qname]["want"]
        check_path(qname, cnt, agg_chunks[0],
                   frags(generic_classic=want["generic"] + want["generic_classic"]))
        if cnt["segments"]["scanned"] or cnt["staged_batches"]:
            raise AssertionError(f"{qname} (classic) read the segment store: {cnt}")
    check_results(classic, "classic")
    for qname in queries:
        if classic[qname] != results[qname]:
            raise AssertionError(f"{qname}: the classic path's rows differ from the fused path's")
    s.execute("set tidb_tpu_pipeline_fuse = 1")
    s.execute("set tidb_tpu_columnar_enable = 1")
    launches_classic = {k: sum(classic_counts[q]["launches"][k] for q in queries)
                        for k in launches}
    log("classic path: the same rows as the fused path and numpy")

    packed = packed_batch_phase(torch, np, new_session, mods, agg_chunks)
    launches_packed = {k: packed["agg"]["counts"]["launches"][k]
                       + packed["join"]["counts"]["launches"][k] for k in launches}
    plans = {q: explain_text(plans[q]) for q in queries}
    for qname in ("q3", "q5", "q18"):
        log(f"{qname} plan at SF1:\n{plans[qname]}")

    return {"li": li, "n_rows": n_rows, "results": results, "per_query": per_query,
            "cold": cold, "probes": probes, "probe_modes": probe_modes,
            "launches": launches, "launches_classic": launches_classic,
            "launches_packed": launches_packed, "classic_counts": classic_counts,
            "packed": packed, "plans": plans, "q18_build": q18_build}



def phase_modes(torch, s, queries, n_rows) -> tuple:
    """Phase 3's query times: warm medians of 3 and one profiled warm run of
    each query in each mode. Returns (times, profiles)."""
    from tidb_tpu_torch.executor import pipeline as pl
    from tidb_tpu_torch.storage.tpch_queries import Q

    # five modes: fused with the device buffer cache (the default), fused
    # with the cache budget 0 (every run stages through the prefetcher),
    # the classic raw path
    # (and the same staged inline, prefetch depth 0: what the staging
    # thread buys or costs against the host's Python launch loop), and for
    # the generic aggregations of Q3 and Q18 the host engine
    # (tidb_device_engine_mode = 'off': the numpy groupby, classic joins)
    modes = {"fused_cache": [],
             "fused_nocache": ["set global tidb_tpu_device_buffer_cache_bytes = 0"],
             "fused_nocache_inline": ["set global tidb_tpu_device_buffer_cache_bytes = 0",
                                      "set tidb_tpu_pipeline_prefetch_depth = 0"],
             "classic": ["set tidb_tpu_pipeline_fuse = 0",
                         "set tidb_tpu_columnar_enable = 0"],
             "generic_host": ["set tidb_device_engine_mode = 'off'"]}
    undo = ["set global tidb_tpu_device_buffer_cache_bytes = 268435456",
            "set tidb_tpu_pipeline_prefetch_depth = 2",
            "set tidb_tpu_pipeline_fuse = 1", "set tidb_tpu_columnar_enable = 1",
            "set tidb_device_engine_mode = 'auto'"]
    times, profiles = {}, {}
    for mode, sets in modes.items():
        for stmt in sets:
            s.execute(stmt)
        times[mode], profiles[mode] = {}, {}
        for qname in queries:
            if mode == "generic_host" and qname not in ("q3", "q18"):
                continue
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                s.query(Q[qname][0])
                runs.append(time.perf_counter() - t0)
            med = statistics.median(runs)
            times[mode][qname] = med
            pl.reset_counters()
            prof = profile_query(torch, s, Q[qname][0])
            prof["pipeline"] = {"prefetch": dict(pl.PIPELINE_PREFETCH_TOTAL),
                                "stage_s": dict(pl.PIPELINE_STAGE_SECONDS),
                                "cache": dict(pl.DEVICE_CACHE_TOTAL)}
            profiles[mode][qname] = prof
            log(f"{mode} {qname}: warm wall median of 3 {med * 1e3:.3f} ms "
                f"({n_rows / med:,.0f} rows/s over {n_rows} lineitem rows); runs {runs}; "
                f"profiled wall {prof['wall_us'] / 1e3:.3f} ms, device busy "
                f"{prof['device_busy_us'] / 1e3:.3f} ms, idle share "
                f"{prof['idle_share']:.3f}, host->device {prof['h2d']}, device->host "
                f"{prof['d2h']}, host "
                f"{prof['host_copies']} {prof['host_launches']}; pipeline {prof['pipeline']}; "
                f"host thread busy ms "
                f"{ {t: round(v / 1e3, 1) for t, v in prof['host_thread_busy_us'].items()} }")
            for e in prof["top_device"][:5] + prof["top_host"][:5]:
                log(f"  {e['name'][:60]:60s} device {e['device_us'] / 1e3:9.3f} ms "
                    f"x{e['count']}  host {e['cpu_us'] / 1e3:9.3f} ms")
        for stmt in undo:
            s.execute(stmt)
    return times, profiles



# ---------------------------------------------------------------------------
# the 22 TPC-H queries at SF0.1 against an indexed sqlite oracle
# ---------------------------------------------------------------------------

GENERIC_QUERIES = ("q2", "q3", "q7", "q8", "q9", "q10", "q11", "q13", "q15", "q16", "q17",
                   "q18", "q20")
FUSED_GENERIC_QUERIES = ("q15", "q17", "q18", "q20")


def sqlite_oracle(np, catalog, db: str = "test"):
    """The port's tables copied into an in-memory sqlite database, with the
    key indexes a TPC-H grid needs (what tidb_tpu/testutil.py's
    mirror_to_sqlite and index_tpch_oracle do): decimals become REAL,
    dates ISO strings, strings their dictionary values, case-insensitive
    collations NOCASE."""
    import sqlite3

    from tidb_tpu_torch.types import TypeKind

    sql_type = {TypeKind.INT: "INTEGER", TypeKind.BOOL: "INTEGER", TypeKind.FLOAT: "REAL",
                TypeKind.DECIMAL: "REAL", TypeKind.STRING: "TEXT", TypeKind.DATE: "TEXT"}
    conn = sqlite3.connect(":memory:")
    for name in catalog.tables(db):
        t = catalog.table(db, name)
        cols = t.schema.columns
        decls = ", ".join(
            f"{c.name} {sql_type[c.type_.kind]}"
            + (" COLLATE NOCASE" if c.type_.kind == TypeKind.STRING
               and c.coll.endswith("_ci") else "") for c in cols)
        conn.execute(f"CREATE TABLE {name} ({decls})")
        n = t.n
        if n == 0:
            continue
        pycols = []
        for c in cols:
            data, valid, k = t.data[c.name][:n], t.valid[c.name][:n], c.type_.kind
            if k == TypeKind.STRING:
                vals = np.asarray(t.dicts[c.name].values, dtype=object)[np.maximum(data, 0)]
            elif k == TypeKind.DECIMAL:
                vals = (data.astype(np.float64) / 10 ** c.type_.scale).astype(object)
            elif k == TypeKind.DATE:
                vals = (np.datetime64("1970-01-01", "D")
                        + data.astype("timedelta64[D]")).astype(str).astype(object)
            elif k == TypeKind.FLOAT:
                vals = data.astype(np.float64).astype(object)
            else:
                vals = data.astype(np.int64).astype(object)
            vals[~valid] = None
            pycols.append(vals.tolist())
        live = t.live_mask(0, n)
        rows = [r for r, ok in zip(zip(*pycols), live) if ok]
        conn.executemany(f"INSERT INTO {name} VALUES ({', '.join('?' * len(cols))})", rows)
    for ddl in ("create index li_ok on lineitem(l_orderkey)",
                "create index li_pk on lineitem(l_partkey, l_suppkey)",
                "create index li_sk on lineitem(l_suppkey)",
                "create index o_ok on orders(o_orderkey)",
                "create index o_ck on orders(o_custkey)",
                "create index c_ck on customer(c_custkey)",
                "create index s_sk on supplier(s_suppkey)",
                "create index p_pk on part(p_partkey)",
                "create index ps_pk on partsupp(ps_partkey, ps_suppkey)",
                "create index ps_sk on partsupp(ps_suppkey)"):
        conn.execute(ddl)
    conn.execute("analyze")
    conn.commit()
    return conn


def _normal(v):
    """A result value for comparison: numeric strings (decimals) -> float."""
    if isinstance(v, str) and v:
        body = v[1:] if v[0] in "+-" else v
        if body.replace(".", "", 1).isdigit():
            return float(v)
    return v


def rows_equal(got, want, rel_tol: float = 1e-6):
    """(ok, message): the rows in order, numbers within rel_tol (sqlite keeps
    decimals as REAL), everything else equal (testutil.rows_equal's rule)."""
    if len(got) != len(want):
        return False, f"row count {len(got)} != {len(want)}: {got[:3]} vs {want[:3]}"
    for i, (rg, rw) in enumerate(zip(got, want)):
        if len(rg) != len(rw):
            return False, f"row {i}: width {len(rg)} != {len(rw)}"
        for j, (a, b) in enumerate(zip(map(_normal, rg), map(_normal, rw))):
            if a is None or b is None:
                ok = a is b
            elif isinstance(a, (int, float)) and isinstance(b, (int, float)):
                ok = abs(a - b) <= rel_tol * max(1.0, abs(a), abs(b))
            else:
                ok = a == b
            if not ok:
                return False, f"row {i} col {j}: {rg[j]!r} != {rw[j]!r}"
    return True, "ok"


def phase_grid(torch, np, Session, mods) -> dict:
    """All 22 TPC-H queries at SF0.1 (the port's generator, seed 7, chunk
    capacity 8,192) on the card against the sqlite oracle, ordered, with
    the oracle's SQL variants. Each run: the probe kernel's launch contract,
    the fused fragments its plan (taken just before) calls for, and the
    device generic aggregation on exactly the thirteen queries whose plans
    group generically, fused at least for Q15, Q17, Q18 and Q20. Plan-time
    subqueries may add fragments beyond the final plan's (Q11's HAVING
    subquery groups partsupp fused at this scale)."""
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.storage.tpch_queries import Q

    s = Session(chunk_capacity=8192)
    t0 = time.perf_counter()
    counts = s.load_tpch(0.1)
    t_load = time.perf_counter() - t0
    oracle = sqlite_oracle(np, s.catalog)
    log(f"grid: SF0.1 loaded in {t_load:.1f} s ({counts}); sqlite oracle built in "
        f"{time.perf_counter() - t0 - t_load:.1f} s")
    out = {}
    for name, (sql, osql) in Q.items():
        plan = s._plan_select(parse(sql)[0])
        want = plan_fragments(plan, s._plan_capacity(plan))
        rows, cnt, dt = run_query(s, mods, sql)
        expect = oracle.execute(osql or sql).fetchall()
        ok, msg = rows_equal(rows, expect)
        if not ok:
            raise AssertionError(f"grid {name}: {msg}")
        if not rows and name != "q9":
            raise AssertionError(f"grid {name} returned no rows")
        lc, gen = cnt["launches"], cnt["generic_runs"]
        if lc["segsum_count"] or lc["segsum_i64"] or lc["hash_probe"]:
            raise AssertionError(f"grid {name} launched an off-path kernel entry: {lc}")
        if lc["probe_count"] != sum(cnt["routes"].values()):
            raise AssertionError(f"grid {name}: probe_count {lc['probe_count']} over "
                                 f"{cnt['routes']} probe chunks")
        if (gen["classic"] + gen["fused"] > 0) != (name in GENERIC_QUERIES):
            raise AssertionError(f"grid {name}: device generic runs {gen}")
        if name in FUSED_GENERIC_QUERIES and not gen["fused"]:
            raise AssertionError(f"grid {name}: fused generic runs {gen}")
        ran = dict(cnt["fused"], generic_classic=gen["classic"])
        if any(ran[k] < want[k] for k in want):
            raise AssertionError(f"grid {name}: ran {ran}, the plan calls for {want}")
        out[name] = {"rows": len(rows), "seconds": dt, "plan_fragments": want,
                     "fused": cnt["fused"], "generic_runs": gen, "routes": cnt["routes"],
                     "launches": lc, "checks_nothing": not rows}
        log(f"grid {name}: {len(rows)} rows equal sqlite in {dt:.3f} s; fused "
            f"{ {k: v for k, v in cnt['fused'].items() if v} }; device generic {gen}; "
            f"probe routes {cnt['routes']}" + ("; empty: checks nothing" if not rows else ""))
    return out


# ---------------------------------------------------------------------------
# the per-chunk loop of the device generic aggregation makes no host read
# ---------------------------------------------------------------------------


def sync_free_pass(torch, s, mods, sqls: dict) -> dict:
    """Run each statement (inline staging, so no other thread works in the
    window) with torch's sync debug mode set to "error" around every
    per-chunk step of the device generic aggregation: the fused batch
    function (decode, pipeline, partial table), the classic partial table
    and each push onto the GroupTableStack (its merges). A device->host
    copy, .item() or any other synchronising call in them raises. Returns
    the steps checked per statement."""
    from tidb_tpu_torch.executor import agg_device as ad
    from tidb_tpu_torch.executor import pipeline as pl

    calls = {}
    real = (ad.make_partial_kernel, ad.GroupTableStack.push, pl._make_fused_generic_fn)

    def strict(fn, key):
        def run(*a):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            calls[key] = calls.get(key, 0) + 1
            return out
        return run

    ad.make_partial_kernel = lambda *a: strict(real[0](*a), "partial")
    ad.GroupTableStack.push = lambda self, t: strict(real[1], "push")(self, t)
    pl._make_fused_generic_fn = lambda *a: strict(real[2](*a), "fused_batch")
    s.execute("set tidb_tpu_pipeline_prefetch_depth = 0")
    out = {}
    try:
        for name, sql in sqls.items():
            calls.clear()
            rows, cnt, _dt = run_query(s, mods, sql)
            if not calls.get("push"):
                raise AssertionError(f"{name}: no device generic aggregation step ran")
            out[name] = {"steps": dict(calls), "generic_runs": cnt["generic_runs"],
                         "rows": len(rows)}
            log(f"sync-free per-chunk loop, {name}: {dict(calls)} steps under sync debug "
                f"mode 'error', none synchronised")
    finally:
        ad.make_partial_kernel, ad.GroupTableStack.push, pl._make_fused_generic_fn = real
        s.execute("set tidb_tpu_pipeline_prefetch_depth = 2")
    return out


# ---------------------------------------------------------------------------
# the fused scan -> top-k root at SF1
# ---------------------------------------------------------------------------

TOPN_SQL = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
            "where l_shipdate >= date '1995-01-01' order by l_extendedprice desc")


def numpy_topn(np, li, limit: int, multi: bool):
    """The top `limit` lineitems shipped since 1995 by extendedprice desc: with
    `multi`, then by orderkey and linenumber; else ties in drain (row) order."""
    ship, ext, okey, lnum = _cols(li, "l_shipdate", "l_extendedprice", "l_orderkey",
                                  "l_linenumber")
    rows = np.nonzero(ship >= _days(np, "1995-01-01"))[0]
    if multi:
        order = np.lexsort((lnum[rows], okey[rows], -ext[rows]))
    else:
        order = np.argsort(-ext[rows], kind="stable")
    top = rows[order[:limit]]
    return [(int(okey[i]), int(lnum[i]), int(ext[i])) for i in top]


def phase_topn(np, s, mods) -> dict:
    """A top-N report over lineitem at SF1 with one sort key (the threshold
    cut), with three (the full merge) and with a LIMIT above the chunk
    capacity (the classic delegate), each against numpy; the first two must
    run fused."""
    li = s.catalog.table("test", "lineitem")
    cases = {"single_key": (TOPN_SQL + " limit 10", 10, False, "topn"),
             "multi_key": (TOPN_SQL + ", l_orderkey, l_linenumber limit 100", 100, True,
                           "topn"),
             "over_capacity": (TOPN_SQL + " limit 70000", 70000, False, "delegate")}
    out = {}
    for name, (sql, limit, multi, route) in cases.items():
        runs = []
        for _ in range(2):
            rows, cnt, dt = run_query(s, mods, sql)
            runs.append(dt)
        got = [(r[0], r[1], _scaled(r[2])) for r in rows]
        want = numpy_topn(np, li, limit, multi)
        if got != want:
            raise AssertionError(f"top-k {name}: {got[:3]} vs numpy {want[:3]}")
        if cnt["fused"][route] != 1 or cnt["fused"]["topn"] != (route == "topn"):
            raise AssertionError(f"top-k {name} took {cnt['fused']}, not {route}")
        out[name] = {"rows": len(rows), "seconds": runs, "fused": cnt["fused"],
                     "h2d": cnt["h2d"], "staged_batches": cnt["staged_batches"]}
        log(f"top-k {name}: {len(rows)} rows equal numpy; route {route}; cold/warm s {runs}; "
            f"staged batches {cnt['staged_batches']}")
    return out


def peak_memory(torch, s, sql: str) -> dict:
    """The card's allocated bytes before one warm run of `sql` and the
    allocator's peak during it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s.query(sql)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"before_bytes": base, "peak_bytes": peak, "statement_peak_bytes": peak - base}



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from tidb_tpu_torch.columnar import store as st
        from tidb_tpu_torch.executor import aggregate as agg_mod
        from tidb_tpu_torch.executor import pipeline as pl
        from tidb_tpu_torch.ops import hash_probe as hp
        from tidb_tpu_torch.ops import join_kernels as jk
        from tidb_tpu_torch.ops import nvcc_build
        from tidb_tpu_torch.ops import segment_sum as seg_mod
        from tidb_tpu_torch.parser import parse
        from tidb_tpu_torch.planner.physical import explain_text
        from tidb_tpu_torch.session import Session
        from tidb_tpu_torch.storage.tpch_queries import Q
    except ImportError as e:
        print(f"chip_smoke: the tidb_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    os.makedirs(OUT_DIR, exist_ok=True)
    mods = (seg_mod, hp, jk, pl, st, agg_mod)

    t0 = time.perf_counter()
    nvcc_build.build_libraries([os.path.join(nvcc_build.CSRC, m.SOURCE)
                                for m in (seg_mod, hp)])
    seg_mod.load_kernels()
    hp.load_kernels()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    sass = {m.SOURCE: sass_atomics(nvcc_build._so_path(os.path.join(nvcc_build.CSRC, m.SOURCE)),
                                   nvcc_build.nvcc_path()) for m in (seg_mod, hp)}
    for src, found in sass.items():
        for fn, ops in found.items():
            log(f"SASS atomics {src} {str(fn)[:70]}: {ops}")

    # -- phase 1 ------------------------------------------------------------
    errs = phase_kernels(torch, np, seg_mod)
    segagg_checks = phase_segagg(torch, np, seg_mod)
    probe_checks = phase_probe(torch, np, hp)
    probe_count_checks = phase_probe_count(torch, np, jk, hp)

    # -- the grid: 22 queries at SF0.1 against sqlite ------------------------
    t0 = time.perf_counter()
    grid = phase_grid(torch, np, Session, mods)
    pl.DEVICE_CACHE.clear()  # the grid's staged tables, off the card
    log(f"grid: all 22 queries equal sqlite in {time.perf_counter() - t0:.1f} s")

    # -- phase 2 ------------------------------------------------------------
    s = Session()  # device=None: the card
    t0 = time.perf_counter()
    counts = s.load_tpch(1.0)
    log(f"TPC-H SF1 loaded in {time.perf_counter() - t0:.1f} s: {counts}")
    queries = ("q1", "q6", "q3", "q5", "q18")
    p2 = phase_paths(torch, np, s, mods, Session, queries)
    li, n_rows, results, per_query = p2["li"], p2["n_rows"], p2["results"], p2["per_query"]
    cold, probes, probe_modes = p2["cold"], p2["probes"], p2["probe_modes"]
    launches, launches_classic = p2["launches"], p2["launches_classic"]
    launches_packed, classic_counts = p2["launches_packed"], p2["classic_counts"]
    packed, plans, q18_build = p2["packed"], p2["plans"], p2["q18_build"]
    q18_sub = Q["q18"][0].split("in (", 1)[1].split(")\n", 1)[0]
    sync_free = sync_free_pass(torch, s, mods, {"q3": Q["q3"][0], "q18": Q["q18"][0],
                                                "q18_subquery": q18_sub})
    topn = phase_topn(np, s, mods)

    # -- phase 3 ------------------------------------------------------------
    times, profiles = phase_modes(torch, s, queries, n_rows)

    # Q18's IN subquery alone (a generic aggregation of lineitem by order
    # key, fused on the device; and on the host engine): how much of Q18 is
    # not the join. Its profile's device->host copies are the finalize
    # fetch of the stack's tables alone: the slot counts, then every live slot
    for mode in ("fused_cache", "generic_host"):
        if mode == "generic_host":
            s.execute("set tidb_device_engine_mode = 'off'")
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            s.query(q18_sub)
            runs.append(time.perf_counter() - t0)
        times[mode]["q18_subquery"] = statistics.median(runs)
        profiles[mode]["q18_subquery"] = prof = profile_query(torch, s, q18_sub)
        s.execute("set tidb_device_engine_mode = 'auto'")
        log(f"{mode} q18's IN subquery alone, warm wall median of 3: "
            f"{times[mode]['q18_subquery'] * 1e3:.3f} ms; runs {runs}; device->host "
            f"{prof['d2h']}; host->device {prof['h2d']}")
    if profiles["fused_cache"]["q18_subquery"]["d2h"]["count"] > 2:
        raise AssertionError("q18's IN subquery copied device->host beyond its finalize "
                             f"fetch: {profiles['fused_cache']['q18_subquery']['d2h']}")
    memory = {name: peak_memory(torch, s, sql) for name, sql in
              (("q18", Q["q18"][0]), ("q18_subquery", q18_sub), ("q3", Q["q3"][0]))}
    log(f"peak device memory (bytes): {memory}")

    # Q1's chunk as the kernels see it: packed ids (returnflag code +
    # 4 x linestatus code) over the groups Q1 found, in the proportions of
    # their counts, and the share of rows its shipdate filter keeps
    q1_rows = results["q1"]
    rng = np.random.default_rng(7)
    R, G = Q1_ROWS, Q1_GROUPS
    rf_vals = li.dicts["l_returnflag"].values
    ls_vals = li.dicts["l_linestatus"].values
    gids = np.array([rf_vals.index(r[0]) + (len(rf_vals) + 1) * ls_vals.index(r[1])
                     for r in q1_rows])
    gcnt = np.array([r[9] for r in q1_rows], dtype=np.float64)
    ids = rng.choice(gids, R, p=gcnt / gcnt.sum())
    seg = torch.from_numpy(ids.astype(np.int64)).cuda()
    mask = torch.from_numpy(rng.random(R) < gcnt.sum() / n_rows).cuda()
    vals = torch.from_numpy(rng.integers(0, 1 << 32, R).astype(np.int64)).cuda()
    mask_i64 = mask.to(torch.int64)
    lib_out = torch.zeros(G, dtype=torch.int64, device="cuda")
    rows = []
    specs = [
        ("segsum_count", "tidb_tpu/ops/segment_sum.py:111", 1,
         lambda: seg_mod.segment_count(mask, seg, G),
         lambda: seg_mod.plain_segment_count(mask, seg, G),
         lambda: lib_out.index_add_(0, seg, mask_i64)),
        ("segsum_i64", "tidb_tpu/ops/segment_sum.py:176", 8,
         lambda: seg_mod.segment_sum_i64(vals, seg, G),
         lambda: seg_mod.plain_segment_sum_i64(vals, seg, G),
         lambda: lib_out.index_add_(0, seg, vals)),
    ]
    for kname, replaces, vbytes, kern, plain, library in specs:
        ms = device_ms(torch, kern, graph=True)
        plain_ms = device_ms(torch, plain, graph=False)
        library_ms = device_ms(torch, library, graph=True)
        nbytes = R * (vbytes + 8) + G * 8  # values + int64 ids in, [G] out
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = R / SCALAR_OPS_PER_S * 1e3  # one add per row
        rows.append({
            "name": kname, "route": "cuda",
            "source": "tidb_tpu_torch/ops/csrc/segment_sum.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        })
        log(f"{kname} at R={R} G={G}: {ms * 1e3:.2f} us/call, bound "
            f"{max(bytes_ms, ops_ms) * 1e3:.3f} us ({nbytes} B), plain "
            f"{plain_ms * 1e3:.2f} us, index_add_ {library_ms * 1e3:.2f} us")

    # the fused update at Q1's chunk shape: the same ids and live rows, 7
    # decimal columns drawn like `vals` with their (all-true) validity,
    # into Q1's 16 accumulators and 23 outputs
    dvals = [torch.from_numpy(rng.integers(0, 1 << 32, R).astype(np.int64)).cuda()
             for _ in range(Q1_DECIMALS)]
    dmasks = [torch.ones(R, dtype=torch.bool, device="cuda") for _ in range(Q1_DECIMALS)]
    accs = q1_accs(torch, seg_mod, dvals, dmasks, G, "cuda")
    check_segagg_case(torch, seg_mod, seg, G, mask, accs)
    n_out = sum(2 if a.kind == "limbs" else 1 for a in accs)
    # the library yardstick's operand: each output's per-row contribution
    cols = []
    for a in accs:
        live = mask if a.mask is None else mask & a.mask
        if a.kind == "count":
            cols.append(live.to(torch.int64))
        else:
            v = torch.where(live, a.vals, 0)
            cols += [v & 0xFFFFFFFF, v >> 32]
    stacked = torch.stack(cols, 1).contiguous()
    lib23 = torch.zeros(G, n_out, dtype=torch.int64, device="cuda")
    ms = device_ms(torch, lambda: seg_mod.segment_accumulate(seg, G, mask, accs), graph=True)
    plain_ms = device_ms(torch, lambda: seg_mod.plain_segment_accumulate(seg, G, mask, accs),
                         graph=False)
    library_ms = device_ms(torch, lambda: lib23.index_add_(0, seg, stacked), graph=True)
    nbytes = R * (8 + 1 + Q1_DECIMALS * (8 + 1)) + n_out * G * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = R * n_out / SCALAR_OPS_PER_S * 1e3  # one add per row and output
    n_counts = sum(1 for a in accs if a.kind == "count")
    replaced_ms = n_counts * rows[0]["ms"] + (n_out - n_counts) * rows[1]["ms"]
    rows.append({
        "name": "segagg", "route": "cuda",
        "source": "tidb_tpu_torch/ops/csrc/segment_sum.cu",
        "replaces": "tidb_tpu/ops/segment_sum.py:176",
        "also_replaces": "tidb_tpu/ops/segment_sum.py:111",
        "launches": launches["segagg"], "max_abs_err": 0, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    })
    segagg_q1 = {"R": R, "G": G, "accumulators": len(accs), "outputs": n_out,
                 "bytes": nbytes, "replaced_calls": f"{n_counts} x segsum_count + "
                 f"{n_out - n_counts} x segsum_i64", "replaced_calls_ms": replaced_ms}
    log(f"segagg at R={R} G={G}, {len(accs)} accumulators ({n_out} outputs): "
        f"{ms * 1e3:.2f} us/call, bound {max(bytes_ms, ops_ms) * 1e3:.3f} us "
        f"({nbytes} B), plain {plain_ms * 1e3:.2f} us, index_add_ [R, {n_out}] "
        f"{library_ms * 1e3:.2f} us; the {segagg_q1['replaced_calls']} calls it "
        f"replaces take {replaced_ms * 1e3:.2f} us")

    # Q18's semi-join probe as B3 sees it: the build is the orders whose
    # quantity passes the HAVING, padded to the join's shape bucket with
    # INT64_MAX; a chunk is R lineitem order keys in the probe's order
    nb = jk.shape_bucket(len(q18_build))
    sk = torch.from_numpy(np.concatenate(
        [q18_build, np.full(nb - len(q18_build), I64_MAX)])).cuda()
    pr = torch.from_numpy(np.ascontiguousarray(li.data["l_orderkey"][:R])).cuda()
    cap = hp.table_capacity(nb)
    tkeys, tlos, this, placed = hp.build_table(sk, cap)
    if not bool(placed):
        raise AssertionError("Q18's build left a run unplaced")
    check_probe_case(torch, hp, sk, pr)
    reads, _ = probe_slot_reads(torch, hp, tkeys, tlos, sk, pr)
    ms = device_ms(torch, lambda: hp.probe_table(tkeys, tlos, this, sk, pr), graph=True)
    plain_ms = device_ms(torch, lambda: hp.plain_probe_table(tkeys, tlos, this, sk, pr),
                         graph=False)
    library_ms = device_ms(torch, lambda: (torch.searchsorted(sk, pr),
                                           torch.searchsorted(sk, pr, right=True)),
                           graph=True)
    # keys in, (lo, hi) out, the table and the sorted keys read once
    nbytes = R * (8 + 16) + cap * 12 + nb * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (R * MIX_OPS + reads * SLOT_OPS) / SCALAR_OPS_PER_S * 1e3
    rows.append({
        "name": "hash_probe", "route": "cuda",
        "source": "tidb_tpu_torch/ops/csrc/hash_probe.cu",
        "replaces": "tidb_tpu/ops/hash_probe.py:244", "launches": launches["hash_probe"],
        "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    })
    log(f"hash_probe at R={R} cap={cap} runs={len(q18_build)} (slot reads {reads}): "
        f"{ms * 1e3:.2f} us/call, bound {max(bytes_ms, ops_ms) * 1e3:.3f} us "
        f"({nbytes} B), plain {plain_ms * 1e3:.2f} us, searchsorted x2 "
        f"{library_ms * 1e3:.2f} us")

    # tidb_probe_count at the main path's shapes, on the arguments the
    # run above gave it: Q18's semi join (the table route, flags only; also
    # timed in full), Q3's top join (direct) and Q5's two-key join (sorted);
    # and a table above the shared-memory limit (2^17 build rows, cap 2^18)
    def recorded(query, route, mode, seed):
        got = main_path_args(probes, query, route, mode)
        if got is not None:
            return got
        # no query of this plan took the route: a phase-1 case of the shape
        log(f"note: no main-path {route}/{mode} probe; timing a synthetic case")
        case = make_probe_count_case(torch, np, jk, hp, R, 1 << 12,
                                     {"route": route, "flags_only": mode == "flags"},
                                     seed, "cuda")
        return chunk_args(jk, case)

    q18_args, q18_kw = recorded("q18", "table", "flags", 4001)
    shapes = [
        ("probe_count.table_flags", q18_args, q18_kw, probe_modes.get("table/flags", 0)),
        ("probe_count.table_full", q18_args, dict(q18_kw, flags_only=False),
         probe_modes.get("table/full", 0)),
        ("probe_count.direct", *recorded("q3", "direct", "full", 4002),
         probe_modes.get("direct/full", 0)),
        ("probe_count.sorted", *recorded("q5", "sorted", "full", 4003),
         probe_modes.get("sorted/full", 0)),
    ]
    big = make_probe_count_case(torch, np, jk, hp, R, 1 << 17, {"route": "table"}, 4999,
                                "cuda")
    shapes.append(("probe_count.table_cap_2e18", *chunk_args(jk, big), 0))
    for kname, args, kw, n_launch in shapes:
        rows.append(probe_chunk_row(torch, hp, kname, args, kw, n_launch))

    log(f"main-path launches: fused path {launches}, classic path {launches_classic}, "
        f"packed batches {launches_packed}")
    report = {"card": card, "device": name, "lineitem_rows": n_rows,
              "warm_s": times, "cold_s": cold, "per_query": per_query,
              "classic_counts": classic_counts, "packed_batches": packed,
              "launches_by_path": {"fused": launches, "classic": launches_classic,
                                   "packed": launches_packed},
              "plans": plans, "probe_checks": probe_checks, "grid": grid,
              "sync_free": sync_free, "topn": topn, "peak_memory": memory,
              "segagg_checks": segagg_checks, "segagg_q1": segagg_q1,
              "probe_count_checks": probe_count_checks, "probe_modes": probe_modes,
              "sass_atomics": sass,
              "q18_probe": {"R": R, "cap": cap, "runs": len(q18_build),
                            "slot_reads": reads},
              "f32_max_abs_diff": errs["segsum_f32"], "profiles": profiles,
              "kernels": rows}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
