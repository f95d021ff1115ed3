// The join's per-chunk probe program for Hopper (sm_90a), bound through a
// plain C ABI (ctypes; no PyTorch headers).
//
// Replaces the Pallas kernel _probe_pallas of tidb_tpu/ops/hash_probe.py
// (B3), and with it the rest of the program the reference compiles around
// it once per probe chunk (tidb_tpu/ops/join_kernels.py _probe_count: range
// lookup, match count, LEFT pad, prefix sum). tidb_probe_count does all of
// it in one launch, on every route of the range lookup:
//   direct: start, end = firsts[clamp(key - lo)], firsts[clamp(key - lo) + 1],
//           and the key is in range when 0 <= key - lo < rng;
//   table:  the open-addressing table (ops/hash_probe.py build_table: three
//           int32 arrays of capacity cap, a power of two <= 2^19, holding per
//           occupied slot a run's 32-bit fingerprint, start and end). From
//             home = mix32(key) & (cap - 1),  fp = mix32(key ^ FP_SALT)
//           up to MAX_PROBES slots are scanned; a slot is a hit when its
//           fingerprint equals fp and the sorted build key at the run's start
//           equals the key. A miss gives (0, 0);
//   sorted: start, end = searchsorted left and right over the sorted keys;
// the table and sorted routes clamp start and end to n_build (the sentinel
// tail never matches), the direct route does not. Then per row
//   ok = kvalid & sel,  count = ok & in_range ? end - start : 0,
//   matched = count > 0,  real_count = count,
//   count = sel ? max(count, 1) : 0        (LEFT pad, when asked)
// and cum is the inclusive int64 prefix sum of count over all R rows, total
// its last value. Every output is bit-equal to the plain version
// (ops/hash_probe.py plain_probe_chunk).
//
// Modes: full (every output), flags (ok and matched only: the unfiltered
// semi and anti joins read nothing else, so the scan is skipped) and ranges
// (the table lookup alone, (lo, hi) unclamped: hash_probe's probe_table).
//
// What bounds it on an H100: bytes, and below them the fixed cost of one
// launch. A full-mode row reads its 8-byte key and three flags and writes
// four int64 and two flags (44 B); a flags-mode row 12 B. At a chunk of
// 65,536 rows that is 2.9 MB (0.86 us at 3.35 TB/s) or 0.8 MB (0.23 us);
// the table (at most 6 MiB), the direct index and the sorted keys stay in
// L2 across a chunk. In practice the latency of dependent loads (the table
// scan, the binary searches) and of the scan's look-back decide the time.
//
// Design.
//   * One launch per chunk. The reference's XLA program is one kernel; the
//     eager chain it replaces was 13-17 launches, each costing the host far
//     more than the card. The parameters go by value in one struct
//     (__grid_constant__), so the launch can be captured in a CUDA graph.
//   * One row per thread, 512 threads a block: the lookups are chains of
//     dependent loads, and the card hides their latency with warps, not
//     with rows a thread interleaves (measured: 4 rows a thread in blocks
//     of 128 took more than twice as long on the table route; PERF.md).
//     Every input of a row is loaded before any output is stored, so one
//     round trip serves them all (the struct's pointers may alias).
//   * Table route: a table of at most 1,024 slots (Q18's has 128) is staged
//     once per block into shared memory, interleaved as (fp, lo, hi, 0) by
//     4-byte cp.async copies that overlap the row loads and the hashing;
//     larger ones are read through the read-only cache. The scan stops at
//     the first verified hit or the first EMPTY slot. Stopping is sound: the
//     build never frees a slot, so a run placed at home + r leaves home ..
//     home + r - 1 occupied and the scan reaches it before any EMPTY slot;
//     and distinct runs hold distinct keys, so the first verified hit is the
//     only one. The hash is splitmix64's tail in uint64 (the same bits as
//     the torch mix that builds the table, with EMPTY remapped to 0).
//   * Sorted route: branch-free lower and upper bounds, advanced together
//     level by level.
//   * The prefix sum is a single-pass chained scan with decoupled look-back:
//     a block scans its tile by warp shuffles and publishes its aggregate;
//     warp 0 reads up to 128 predecessor tiles at a time (4 per lane, all in
//     flight) until one has published its inclusive prefix, then publishes
//     its own. Tiles are numbered by an atomic ticket, not by blockIdx, so a
//     tile waits only on tiles whose blocks are already running and the
//     look-back cannot deadlock. The ticket word holds the tile counter in
//     its low 24 bits and a launch epoch above them: the last block to take
//     a ticket resets the counter and advances the epoch in one add. A
//     tile's status is one 16-byte word, (epoch << 2 | flag, value), stored
//     and loaded as one access, as CUB's single-pass scan keeps 8-byte
//     values: a reader never sees a flag without its value, so the scan
//     needs no memory fence (a fence waits for the thread's outstanding
//     stores; with three of them on the critical path the scan took most
//     of a full-mode launch), and a word left by an earlier launch carries
//     an older epoch and reads as not ready, so no memset launch is needed.
//     Launches that share the ticket must run in stream order (the wrapper
//     keeps one ticket per card; the port probes on one stream).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 1;                 // rows per thread
constexpr int kTile = kThreads * kItems;  // rows per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxProbes = 32;            // MAX_PROBES
constexpr int kEmpty = 0x7FFFFFFF;        // the table's free slot
constexpr unsigned long long kFpSalt = 0x9E3779B97F4A7C15ull;
constexpr int kSmemMaxCap = 1024;         // tables staged in shared memory (16 KB)
constexpr int kTileBits = 24;             // the ticket's tile counter; the epoch above
constexpr unsigned long long kTileMask = (1ull << kTileBits) - 1ull;
constexpr unsigned kFull = 0xffffffffu;

enum Route : int { kDirect = 0, kTable = 1, kSorted = 2 };
enum Mode : int { kModeFull = 0, kModeFlags = 1, kModeRanges = 2 };
// a tile's status word: (epoch << 2) | flag
constexpr unsigned long long kAggregate = 1ull, kPrefix = 2ull;

// one probe chunk as the caller passes it (ctypes layout: 216 bytes)
struct ProbeParams {
  const long long* packed;        // [R] packed keys
  const unsigned char* kvalid;    // [R] key validity (not read in ranges mode)
  const unsigned char* in_range;  // [R], null: every key in range
  const unsigned char* sel;       // [R] live rows (not read in ranges mode)
  const long long* n_build;       // device scalar (table and sorted routes)
  const long long* sorted_keys;   // [n_sorted] (table and sorted routes)
  const long long* firsts;        // [n_firsts] (direct route)
  const int* tkeys;               // [cap] (table route)
  const int* tlos;
  const int* this_;
  long long R;
  long long n_sorted;
  long long n_firsts;
  long long lo_packed;
  long long rng_packed;
  int cap;
  int route;
  int mode;
  int left_pad;
  long long* start;               // [R]; ranges mode: lo
  long long* end;                 // [R], ranges mode: hi
  long long* count;               // [R]
  long long* real_count;          // [R]
  long long* cum;                 // [R]
  long long* total;               // scalar
  unsigned char* ok;              // [R]
  unsigned char* matched;         // [R]
  unsigned long long* ticket;     // full mode: the tile ticket and epoch
  unsigned long long* status;     // full mode: [tiles] (tag, value) pairs, 16-byte aligned
};

// int64 -> well-spread int32 (splitmix64 tail), EMPTY remapped to 0 so a
// stored fingerprint never looks like a free slot
__device__ __forceinline__ int mix32(unsigned long long h) {
  h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
  h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
  const int out = static_cast<int>(static_cast<unsigned int>(h ^ (h >> 31)));
  return out == kEmpty ? 0 : out;
}

// The table scan of a thread's rows, interleaved: each round reads the next
// slot of every row not yet resolved. `stab` is the staged table (kSmem).
template <bool kSmem>
__device__ __forceinline__ void table_lookup(const ProbeParams& p, const int4* stab,
                                             const long long (&key)[kItems],
                                             const unsigned (&home)[kItems],
                                             const int (&fp)[kItems], bool (&done)[kItems],
                                             long long (&lo)[kItems], long long (&hi)[kItems]) {
  const unsigned mask = static_cast<unsigned>(p.cap - 1);
  for (int r = 0; r < kMaxProbes; ++r) {
    bool more = false;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (!done[k]) {
        const unsigned pos = (home[k] + r) & mask;
        int f, c = 0, h = 0;
        if constexpr (kSmem) {
          const int4 e = stab[pos];
          f = e.x;
          c = e.y;
          h = e.z;
        } else {
          f = __ldg(p.tkeys + pos);
        }
        if (f == kEmpty) {
          done[k] = true;
        } else if (f == fp[k]) {
          if (!kSmem) c = __ldg(p.tlos + pos);
          long long v = c < 0 ? 0 : c;
          if (v > p.n_sorted - 1) v = p.n_sorted - 1;
          if (__ldg(p.sorted_keys + v) == key[k]) {
            lo[k] = c;
            hi[k] = kSmem ? h : __ldg(p.this_ + pos);
            done[k] = true;
          }
        }
        more = more || !done[k];
      }
    }
    if (!more) break;
  }
}

// searchsorted left and right of each row's key, branch-free, every search
// of the thread one level at a time
__device__ __forceinline__ void sorted_lookup(const ProbeParams& p, const long long (&key)[kItems],
                                              long long (&lo)[kItems], long long (&hi)[kItems]) {
  const long long* sk = p.sorted_keys;
  long long bl[kItems], bu[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) bl[k] = bu[k] = 0;
  for (long long n = p.n_sorted; n > 1;) {
    const long long half = n >> 1;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      bl[k] = __ldg(sk + bl[k] + half) < key[k] ? bl[k] + half : bl[k];
      bu[k] = __ldg(sk + bu[k] + half) <= key[k] ? bu[k] + half : bu[k];
    }
    n -= half;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    lo[k] = bl[k] + (__ldg(sk + bl[k]) < key[k] ? 1 : 0);
    hi[k] = bu[k] + (__ldg(sk + bu[k]) <= key[k] ? 1 : 0);
  }
}

// A tile's status word: (epoch << 2 | flag, value) written and read as one
// 16-byte access, so a reader never sees a flag without its value and no
// fence is needed (CUB's single-pass scan keeps 8-byte values the same way).
__device__ __forceinline__ unsigned long long* status_word(const ProbeParams& p, long long tile) {
  return p.status + 2 * tile;
}

__device__ __forceinline__ void publish(const ProbeParams& p, long long tile,
                                        unsigned long long epoch, unsigned long long flag,
                                        long long v) {
  asm volatile("st.volatile.v2.u64 [%0], {%1, %2};" ::"l"(status_word(p, tile)),
               "l"((epoch << 2) | flag), "l"(v)
               : "memory");
}

// The sum of the counts of every tile before `tile`, by warp 0: each lane
// waits for kLook predecessors' status words of this epoch (read together),
// the warp adds the values up to the nearest inclusive prefix, and moves
// 32 * kLook tiles back if none had one.
constexpr int kLook = 4;
__device__ __forceinline__ long long look_back(const ProbeParams& p, long long tile,
                                               unsigned long long epoch, int lane) {
  long long base = 0;
  for (long long j0 = tile - 1;; j0 -= 32 * kLook) {
    unsigned long long flag[kLook];
    long long v[kLook];
    bool ready;
    do {
      ready = true;
#pragma unroll
      for (int u = 0; u < kLook; ++u) {
        const long long j = j0 - lane - 32 * u;  // nearer tiles on lower (u, lane)
        flag[u] = kPrefix;
        v[u] = 0;
        if (j >= 0) {
          unsigned long long t;
          asm volatile("ld.volatile.v2.u64 {%0, %1}, [%2];"
                       : "=l"(t), "=l"(v[u])
                       : "l"(status_word(p, j))
                       : "memory");
          flag[u] = (t >> 2) == epoch ? t & 3ull : 0ull;
          ready = ready && flag[u] != 0ull;
        }
      }
    } while (!ready);
    // the nearest inclusive prefix: the lowest u, then the lowest lane
    int stop_u = kLook, stop_lane = 31;
#pragma unroll
    for (int u = kLook - 1; u >= 0; --u) {
      const unsigned pm = __ballot_sync(kFull, flag[u] == kPrefix);
      if (pm) {
        stop_u = u;
        stop_lane = __ffs(pm) - 1;
      }
    }
    long long c = 0;
#pragma unroll
    for (int u = 0; u < kLook; ++u)
      c += (u < stop_u || (u == stop_u && lane <= stop_lane)) ? v[u] : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(kFull, c, d);
    base += c;
    if (stop_u < kLook) return base;
  }
}

template <int kRoute, bool kSmem>
__global__ void __launch_bounds__(kThreads)
probe_count(const __grid_constant__ ProbeParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int4* stab = reinterpret_cast<int4*>(smem_raw);
  __shared__ unsigned long long s_ticket;
  __shared__ long long s_warp[kWarps];
  __shared__ long long s_base;

  if constexpr (kSmem) {  // stage the table while the rows load and hash
    for (int i = threadIdx.x; i < p.cap; i += kThreads) {
      __pipeline_memcpy_async(&stab[i].x, p.tkeys + i, 4);
      __pipeline_memcpy_async(&stab[i].y, p.tlos + i, 4);
      __pipeline_memcpy_async(&stab[i].z, p.this_ + i, 4);
    }
    __pipeline_commit();
  }

  const bool full = p.mode == kModeFull;
  long long tile = blockIdx.x;
  unsigned long long epoch = 0;
  if (full) {
    if (threadIdx.x == 0) {
      const unsigned long long t = atomicAdd(p.ticket, 1ull);
      // the last ticket of the launch: counter back to 0, epoch + 1
      if ((t & kTileMask) == gridDim.x - 1u) atomicAdd(p.ticket, (1ull << kTileBits) - gridDim.x);
      s_ticket = t;
    }
    __syncthreads();
    tile = static_cast<long long>(s_ticket & kTileMask);
    epoch = s_ticket >> kTileBits;
  }

  // every input of the thread's rows is loaded before any output is
  // stored: the compiler may not move a load above a store it cannot prove
  // disjoint, so one round trip to memory serves all of them
  const long long row0 = tile * kTile + static_cast<long long>(threadIdx.x) * kItems;
  const bool ranges = p.mode == kModeRanges;
  long long key[kItems], lo[kItems], hi[kItems];
  bool live[kItems], done[kItems], sel[kItems], kv[kItems], inr[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long r = row0 + k;
    live[k] = r < p.R;
    key[k] = live[k] ? p.packed[r] : 0;
    sel[k] = live[k] && !ranges && p.sel[r] != 0;
    kv[k] = live[k] && !ranges && p.kvalid[r] != 0;
    inr[k] = !live[k] || ranges || p.in_range == nullptr || p.in_range[r] != 0;
    lo[k] = hi[k] = 0;
    done[k] = !live[k];
  }

  bool rin[kItems];  // the direct route's own range test
#pragma unroll
  for (int k = 0; k < kItems; ++k) rin[k] = true;
  if constexpr (kRoute == kDirect) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long idx = static_cast<long long>(static_cast<unsigned long long>(key[k]) -
                                                   static_cast<unsigned long long>(p.lo_packed));
      rin[k] = idx >= 0 && idx < p.rng_packed;
      long long c = idx < 0 ? 0 : idx;
      if (c > p.n_firsts - 2) c = p.n_firsts - 2;
      if (live[k]) {
        lo[k] = __ldg(p.firsts + c);
        hi[k] = __ldg(p.firsts + c + 1);
      }
    }
  } else if constexpr (kRoute == kTable) {
    unsigned home[kItems];
    int fp[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned long long u = static_cast<unsigned long long>(key[k]);
      home[k] = static_cast<unsigned>(mix32(u)) & static_cast<unsigned>(p.cap - 1);
      fp[k] = mix32(u ^ kFpSalt);
    }
    if constexpr (kSmem) {
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    table_lookup<kSmem>(p, stab, key, home, fp, done, lo, hi);
  } else {
    sorted_lookup(p, key, lo, hi);
  }

  if (ranges) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (live[k]) {
        p.start[row0 + k] = lo[k];
        p.end[row0 + k] = hi[k];
      }
    }
    return;
  }

  if constexpr (kRoute != kDirect) {
    const long long nb = *p.n_build;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      lo[k] = lo[k] < nb ? lo[k] : nb;
      hi[k] = hi[k] < nb ? hi[k] : nb;
    }
  }
  long long cnt[kItems], pad[kItems];
  long long sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    cnt[k] = pad[k] = 0;
    if (live[k]) {
      const long long r = row0 + k;
      const bool ok = sel[k] && kv[k];
      cnt[k] = ok && inr[k] && rin[k] ? hi[k] - lo[k] : 0;
      pad[k] = !p.left_pad ? cnt[k] : (sel[k] ? (cnt[k] > 1 ? cnt[k] : 1) : 0);
      p.ok[r] = ok;
      p.matched[r] = cnt[k] > 0;
    }
    sum += pad[k];
  }
  if (!full) return;

  // the tile's exclusive prefix per thread: warp scans, then the warp sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  long long agg = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    agg += s_warp[w];
  }

  if (warp == 0) {
    long long base = 0;
    if (tile == 0) {
      if (lane == 0) publish(p, 0, epoch, kPrefix, agg);
    } else {
      if (lane == 0) publish(p, tile, epoch, kAggregate, agg);
      base = look_back(p, tile, epoch, lane);
      if (lane == 0) publish(p, tile, epoch, kPrefix, base + agg);
    }
    if (lane == 0) s_base = base;
  }
  __syncthreads();
  const long long base = s_base;
  long long run = base + before + incl - sum;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (live[k]) {
      const long long r = row0 + k;
      run += pad[k];
      p.start[r] = lo[k];
      p.real_count[r] = cnt[k];
      p.count[r] = pad[k];
      p.cum[r] = run;
    }
  }
  if (threadIdx.x == 0 && tile == gridDim.x - 1) *p.total = base + agg;
}

template <int kRoute, bool kSmem>
cudaError_t launch(const ProbeParams& p, long long blocks, cudaStream_t st) {
  const size_t smem = kSmem ? static_cast<size_t>(p.cap) * sizeof(int4) : 0;
  probe_count<kRoute, kSmem><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One probe chunk (see the header): `params` points to a host ProbeParams.
int tidb_probe_count(const void* params, void* stream) {
  const ProbeParams p = *static_cast<const ProbeParams*>(params);
  if (p.R <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (p.R + kTile - 1) / kTile;
  const bool table = p.route == kTable;
  if (blocks >= static_cast<long long>(kTileMask) || p.packed == nullptr ||
      p.mode < kModeFull || p.mode > kModeRanges || p.route < kDirect || p.route > kSorted ||
      (p.mode == kModeRanges && !table) ||
      (p.mode != kModeRanges && (p.kvalid == nullptr || p.sel == nullptr || p.ok == nullptr ||
                                 p.matched == nullptr)) ||
      (p.mode == kModeFull && (p.start == nullptr || p.count == nullptr ||
                               p.real_count == nullptr || p.cum == nullptr ||
                               p.total == nullptr || p.ticket == nullptr ||
                               p.status == nullptr ||
                               (reinterpret_cast<unsigned long long>(p.status) & 15) != 0)) ||
      (p.mode == kModeRanges && (p.start == nullptr || p.end == nullptr)) ||
      (p.route != kDirect && p.mode != kModeRanges && p.n_build == nullptr) ||
      (p.route != kDirect && (p.sorted_keys == nullptr || p.n_sorted <= 0)) ||
      (p.route == kDirect && (p.firsts == nullptr || p.n_firsts < 2)) ||
      (table && (p.cap <= 0 || (p.cap & (p.cap - 1)) != 0 || p.tkeys == nullptr ||
                 p.tlos == nullptr || p.this_ == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.route == kDirect) return static_cast<int>(launch<kDirect, false>(p, blocks, st));
  if (p.route == kSorted) return static_cast<int>(launch<kSorted, false>(p, blocks, st));
  if (p.cap <= kSmemMaxCap) return static_cast<int>(launch<kTable, true>(p, blocks, st));
  return static_cast<int>(launch<kTable, false>(p, blocks, st));
}

// (lo[i], hi[i]) for each of the n probe keys (int64) against a table of
// capacity cap (int32 tkeys/tlos/this) over n_sorted sorted int64 keys:
// tidb_probe_count's table lookup alone (ranges mode).
int tidb_hash_probe(const void* probes, long long n, const void* tkeys,
                    const void* tlos, const void* this_, int cap,
                    const void* sorted_keys, long long n_sorted, void* lo,
                    void* hi, void* stream) {
  ProbeParams p = {};
  p.packed = static_cast<const long long*>(probes);
  p.R = n;
  p.tkeys = static_cast<const int*>(tkeys);
  p.tlos = static_cast<const int*>(tlos);
  p.this_ = static_cast<const int*>(this_);
  p.cap = cap;
  p.sorted_keys = static_cast<const long long*>(sorted_keys);
  p.n_sorted = n_sorted;
  p.route = kTable;
  p.mode = kModeRanges;
  p.start = static_cast<long long*>(lo);
  p.end = static_cast<long long*>(hi);
  return tidb_probe_count(&p, stream);
}

}  // extern "C"
