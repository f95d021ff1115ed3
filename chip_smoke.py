#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tidb_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from tidb_tpu_torch/ops/csrc with
nvcc (sm_90a, one nvcc per source, all started together), then runs three
phases; any failure exits non-zero.

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
   searchsorted's count (lo equal on every hit). The built library's
   atomic opcodes are read with cuobjdump -sass.
2. TPC-H Q1, Q6, Q3, Q5 and Q18 at SF1 (about 6M lineitem rows) through
   tidb_tpu_torch.session.Session on cuda, each compared with a numpy
   evaluation of the same query over the same generated arrays (decimals
   exact). Each query runs with the kernels' launch counters and the join's
   probe-route counter set to 0 just before it and read just after; Q1, Q6
   and Q5 must launch tidb_segagg exactly once per chunk their segment
   aggregation updates and the one-accumulator entry points never, Q18 the
   hash probe through the table route.
3. Times: warm wall time (median of 3) and rows/s of each query; one more
   warm run of each under torch.profiler (device busy time, idle share,
   top operators by device time); each kernel's time at its main-path
   shape beside its bound, its plain version's time and a library call as
   the yardstick (`index_add_` for B1/B2 with one accumulator, and for the
   fused update one `index_add_` of the [R, 23] stacked contributions;
   searchsorted left + right for B3), and the time of the single-column
   calls the fused update replaces. The full report goes to
   chiprun_out/chip_smoke.json.

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


def profile_query(torch, session, sql: str) -> dict:
    """One warm run under torch.profiler: wall time, device busy time (the
    sum over the kernels and copies on the card, which run on one stream),
    the idle share, and the top entries by device and by host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.query(sql)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in on_card)
    host = [e for e in events if e.device_type == DeviceType.CPU]

    def row(e):
        return {"name": e.key, "count": e.count, "device_us": dev_us(e),
                "cpu_us": e.self_cpu_time_total}

    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "idle_share": 1.0 - busy_us / wall_us,
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
    """One run with the kernels' launch counters and the join's probe-route
    counter zeroed just before and read just after; returns (rows,
    launches, routes, seconds)."""
    seg_mod, hp, jk = mods
    seg_mod.reset_launches()
    hp.reset_launches()
    jk.reset_routes()
    t0 = time.perf_counter()
    rows = session.query(sql)
    dt = time.perf_counter() - t0
    return rows, {**seg_mod.LAUNCHES, **hp.LAUNCHES}, dict(jk.PROBE_ROUTES), dt


def probe_slot_reads(torch, hp, tkeys, tlos, sk, probes) -> int:
    """Slots B3 reads for these probes: up to and including the first hit
    or EMPTY slot, at most MAX_PROBES (the work its early stop leaves)."""
    cap = tkeys.shape[0]
    home = hp._mix32(probes) & (cap - 1)
    fp = hp._mix32(probes, FP_SALT)
    done = torch.zeros(probes.shape, dtype=torch.bool, device=probes.device)
    reads = torch.zeros((), dtype=torch.int64, device=probes.device)
    for r in range(hp.MAX_PROBES):
        pos = (home + r) & (cap - 1)
        reads += (~done).sum()
        k = tkeys[pos].long()
        cand = tlos[pos].long().clamp(0, sk.shape[0] - 1)
        done |= (k == 0x7FFFFFFF) | ((k == fp) & (sk[cand] == probes))
    return int(reads)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import numpy as np

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
    mods = (seg_mod, hp, jk)

    t0 = time.perf_counter()
    nvcc_build.build_libraries([os.path.join(nvcc_build.CSRC, m.SOURCE)
                                for m in (seg_mod, hp)])
    seg_mod.load_kernels()
    hp.load_kernels()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    sass = sass_atomics(nvcc_build._so_path(os.path.join(nvcc_build.CSRC, seg_mod.SOURCE)),
                        nvcc_build.nvcc_path())
    for fn, ops in sass.items():
        log(f"SASS atomics {str(fn)[:70]}: {ops}")

    # -- phase 1 ------------------------------------------------------------
    errs = phase_kernels(torch, np, seg_mod)
    segagg_checks = phase_segagg(torch, np, seg_mod)
    probe_checks = phase_probe(torch, np, hp)

    # -- phase 2 ------------------------------------------------------------
    s = Session()  # device=None: the card
    t0 = time.perf_counter()
    counts = s.load_tpch(1.0)
    log(f"TPC-H SF1 loaded in {time.perf_counter() - t0:.1f} s: {counts}")
    li = s.catalog.table("test", "lineitem")
    n_rows = li.live_rows

    queries = ("q1", "q6", "q3", "q5", "q18")
    launches = {"segagg": 0, "segsum_count": 0, "segsum_i64": 0, "hash_probe": 0}
    results, per_query, cold = {}, {}, {}
    agg_chunks = count_segment_chunks()
    for qname in queries:
        agg_chunks[0] = 0
        rows, lc, routes, dt = run_query(s, mods, Q[qname][0])
        results[qname], cold[qname] = rows, dt
        per_query[qname] = {"launches": lc, "routes": routes,
                            "aggregated_chunks": agg_chunks[0]}
        log(f"{qname} launches: {lc}; probe routes: {routes}; segment-aggregated "
            f"chunks {agg_chunks[0]}; cold run {dt:.3f} s")
        for k in launches:
            launches[k] += lc[k]
    for qname in ("q1", "q6", "q5"):
        lc, n_chunks = per_query[qname]["launches"], per_query[qname]["aggregated_chunks"]
        if n_chunks <= 0 or lc["segagg"] != n_chunks:
            raise AssertionError(f"{qname} launched segagg {lc['segagg']} times over "
                                 f"{n_chunks} aggregated chunks, not once per chunk")
        if lc["segsum_count"] or lc["segsum_i64"]:
            raise AssertionError(f"{qname} launched a single-column kernel: {lc}")
    if per_query["q18"]["launches"]["hash_probe"] <= 0:
        raise AssertionError("q18 never launched hash_probe")
    if per_query["q18"]["routes"]["table"] <= 0:
        raise AssertionError("q18 never probed through the table route")
    check_q1(np, results["q1"], numpy_q1(np, li))
    q6_rows = results["q6"]
    if len(q6_rows) != 1 or _scaled(q6_rows[0][0]) != numpy_q6(np, li):
        raise AssertionError(f"Q6 {q6_rows} vs numpy {numpy_q6(np, li)}")
    q18_want, q18_build = numpy_q18(np, s.catalog)
    check_join_rows("q3", results["q3"], numpy_q3(np, s.catalog), {1})
    check_join_rows("q5", results["q5"], numpy_q5(np, s.catalog), {1})
    check_join_rows("q18", results["q18"], q18_want, {4, 5})
    if not results["q3"] or not results["q5"] or not results["q18"]:
        raise AssertionError("a join query returned no rows")
    log(f"Q1 ({len(results['q1'])} groups), Q6, Q3 ({len(results['q3'])} rows), "
        f"Q5 ({len(results['q5'])}) and Q18 ({len(results['q18'])}) equal the numpy "
        f"evaluation")
    plans = {}
    for qname in ("q3", "q5", "q18"):
        plans[qname] = explain_text(s._plan_select(parse(Q[qname][0])[0]))
        log(f"{qname} plan at SF1:\n{plans[qname]}")

    # -- phase 3 ------------------------------------------------------------
    times = {}
    for qname in queries:
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            s.query(Q[qname][0])
            runs.append(time.perf_counter() - t0)
        med = statistics.median(runs)
        times[qname] = med
        log(f"{qname} warm wall median of 3: {med * 1e3:.3f} ms "
            f"({n_rows / med:,.0f} rows/s over {n_rows} lineitem rows); runs {runs}")

    # Q18's IN subquery alone (a generic aggregation of lineitem by order
    # key): how much of Q18 is not the join
    sub = Q["q18"][0].split("in (", 1)[1].split(")\n", 1)[0]
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        s.query(sub)
        runs.append(time.perf_counter() - t0)
    times["q18_subquery"] = statistics.median(runs)
    log(f"q18's IN subquery alone, warm wall median of 3: "
        f"{times['q18_subquery'] * 1e3:.3f} ms; runs {runs}")

    profiles = {}
    for qname in queries:
        prof = profile_query(torch, s, Q[qname][0])
        profiles[qname] = prof
        log(f"{qname} profiled: wall {prof['wall_us'] / 1e3:.3f} ms, device busy "
            f"{prof['device_busy_us'] / 1e3:.3f} ms, idle share {prof['idle_share']:.3f}")
        for e in prof["top_device"] + prof["top_host"]:
            log(f"  {e['name'][:60]:60s} device {e['device_us'] / 1e3:9.3f} ms "
                f"x{e['count']}  host {e['cpu_us'] / 1e3:9.3f} ms")

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
    reads = probe_slot_reads(torch, hp, tkeys, tlos, sk, pr)
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

    report = {"card": card, "device": name, "lineitem_rows": n_rows,
              "warm_s": times, "cold_s": cold, "per_query": per_query,
              "plans": plans, "probe_checks": probe_checks,
              "segagg_checks": segagg_checks, "segagg_q1": segagg_q1,
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
