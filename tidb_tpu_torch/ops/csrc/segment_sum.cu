// Segment aggregation kernels for Hopper (sm_90a), bound through a plain C
// ABI (ctypes; no PyTorch headers, so nvcc builds this file in seconds).
//
// Replaces the two Pallas kernels of tidb_tpu/ops/segment_sum.py:
//   * _pallas_segsum_f32 (B1): f32 per-group sum, and through
//     segment_count the exact count of mask-true rows per group;
//   * _pallas_segsum_i64 (B2): exact int64 per-group sum, wrapping mod 2^64
//     (the TPU kernel sums eight byte limbs in int32 and recombines).
//
// tidb_segagg does a whole chunk's segment-aggregation update in one
// launch: up to 32 accumulators over one set of packed group ids. Each is
//   count: out[g] += #{i : sel[i] && mask[i] && seg[i] == g}
//   sum:   out[g] += vals[i] over the same rows, mod 2^64
//   limbs: the sum split as the caller's split_limbs does (lo = v & (2^32-1),
//          hi = v >> 32 arithmetic); lo into out, hi into out_hi, and then
//          the pair normalized as normalize_limbs does (lo's overflow
//          carried into hi) by the last block to finish
// where a null sel or mask means every row. Ids outside [0, G) contribute
// nothing, as in the Pallas kernels. Every output is the caller's own [G]
// int64 state, updated in place (no zeroed temporary, no `+=` after).
// Integer addition mod 2^64 does not depend on order, so every output is
// bit-equal to the plain version. tidb_segsum_count and tidb_segsum_i64 are
// the same kernel with one accumulator.
//
// What bounds it on an H100: bytes. A chunk's update reads its ids (8 B a
// row), sel (1 B) and each distinct value column (8 B) and mask (1 B) once
// and writes G int64 per output: Q1's chunk is 72 B a row, 4.7 MB, 1.41 us
// at 3.35 TB/s. The work per byte is an add, far below the compute line, so
// the TPU's one-hot contraction on the matrix unit has no counterpart here:
// tensor cores would only add work.
//
// Design. One launch replaces the 23 single-column calls (and their
// zero-fills, `+=`, where/split/and ops) of a Q1 chunk.
//   * G <= 32 (Q1 12, Q5 26, Q6 1): at most one block per SM walks tiles of
//     512 rows. A tile's columns (each distinct pointer once) are staged
//     into shared memory with 16-byte cp.async copies, all in flight at
//     once, so a tile pays one memory latency. A counting sort then puts
//     the tile's live rows in id order, once for all accumulators, so every
//     per-group sum is a run of contiguous positions. The outputs are read
//     through walkers, one per distinct (values, mask) pair, each keeping a
//     count, a sum and both limb sums (Q1's 23 outputs are 9 walkers, so
//     each column is read once); a walker gets up to 512 / walkers threads,
//     each adding its share of positions into registers and flushing a
//     run's sums into the block's [output][G] table when the id changes. A
//     row costs a walker a few instructions whatever G is, where a
//     compare-and-add over G registers costs O(G), and a per-group
//     __reduce_add_sync runs once for each distinct id of a warp; atomics
//     run per run, not per row. The block flushes each non-zero sum with
//     one global atomic, once.
//   * larger G: per accumulator, a private block
//     histogram over a grid-stride loop, flushed once; counts are
//     warp-aggregated (__match_any_sync: the leader of the lanes that share
//     an id adds their number), sums take one shared atomic per row.
//   * beyond the shared-memory budget: the same loop with global atomics.
// On sm_90a a 64-bit atomicAdd on shared memory is a CAS loop
// (ATOMS.CAST.SPIN.64) and on global memory a native REDG.E.ADD.64, which
// is why the main path keeps 64-bit shared atomics to one per run.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTileRows = kThreads;  // rows a block stages per pass, one a thread
constexpr int kMaxAccs = 32;
constexpr int kMaxCols = 2 + 2 * kMaxAccs;  // ids, sel, a value and a mask each
constexpr int kSortMaxG = 32;  // ids fit a byte and one warp scans the counts
constexpr int kBlocksPerSm = 4;  // for the f32 kernel and the large-G path
// dynamic shared memory a histogram may take (opted in with
// cudaFuncAttributeMaxDynamicSharedMemorySize; 227 KB is the limit)
constexpr size_t kSmemBudget = 96 * 1024;
// the sorted path's shared memory after its [slot][G] table: cursors,
// offsets, the tile's permutation and sorted ids
constexpr size_t kSortScratch = 32 * 4 + 64 * 4 + kTileRows * 2 + kTileRows;
// the most it can ask for: the table, that scratch, and a tile of ids, sel
// and 32 distinct values and masks
constexpr size_t kSortedSmemMax = size_t(2 * kMaxAccs) * kSortMaxG * 8 + kSortScratch +
                                  size_t(kTileRows) * (8 + 1 + kMaxAccs * 9);

enum Kind : int { kCount = 0, kSum = 1, kLimbs = 2 };
// the sums a walker of the sorted path keeps for its (values, mask) pair:
// the count of rows, the whole value, its low and its high 32 bits
enum Sum : int { kSumCount = 0, kSumFull = 1, kSumLo = 2, kSumHi = 3, kSums = 4 };

// one accumulator as the caller passes it (ctypes layout: 40 bytes)
struct AccIn {
  void* out;
  void* out_hi;
  const void* vals;
  const void* mask;
  int kind;
  int pad;
};

struct AccDesc {
  unsigned long long* out;
  unsigned long long* out_hi;
  const long long* vals;
  const unsigned char* mask;
  int kind;
};

// One walker of the sorted path: a distinct (values, mask) pair and the
// output slot each of its sums goes to (-1: none).
struct WalkDesc {
  int vals_off;  // byte offset of the staged value column, -1 for none
  int mask_off;  // byte offset of the staged mask column, -1 for none
  int slot[kSums];
};

struct StageCol {
  const unsigned char* src;
  int esize;
  int off;  // byte offset in the stage area (a multiple of 16)
};

struct SegAggParams {
  const long long* seg;
  const unsigned char* sel;  // null: every row live
  unsigned* ticket;          // blocks done; the last one normalizes the limbs
  long long R;
  int G;
  int n;      // accumulators
  int nout;   // output slots of the sorted path (a limbs accumulator has two)
  int nwalk;  // its walkers
  int ncols;  // its staged columns; ids first, then sel
  int sel_off;
  int table_bytes;
  int limbs;  // any limbs accumulator
  AccDesc acc[kMaxAccs];
  StageCol cols[kMaxCols];
  WalkDesc walkers[kMaxAccs];
  unsigned long long* slot_out[2 * kMaxAccs];
};

// ---------------------------------------------------------------------------
// sorted path (G <= 32: Q1, Q5, Q6)
// ---------------------------------------------------------------------------

// Copy `bytes` from global to shared memory: 16-byte cp.async where the
// source is aligned, byte by byte for a ragged or unaligned remainder.
__device__ __forceinline__ void stage_col(unsigned char* dst,
                                          const unsigned char* src, int bytes) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int chunks = (bytes + 15) >> 4;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int o = c << 4;
    if (aligned && o + 16 <= bytes) {
      __pipeline_memcpy_async(dst + o, src + o, 16);
    } else {
      const int end = o + 16 < bytes ? o + 16 : bytes;
      for (int b = o; b < end; ++b) dst[b] = src[b];
    }
  }
}

// Add each lane's run sums into the table (key = walker * G + id; key < 0:
// nothing), one shared atomic per sum and run of lanes with the same key:
// a segmented suffix sum over the warp by shuffles, whose segments are the
// runs of equal keys (a segment id that grows with the lane keeps them
// contiguous).
__device__ __forceinline__ void warp_run_sum(unsigned long long* table, const WalkDesc& wd,
                                             int key, int G, unsigned long long (&acc)[kSums],
                                             int lane) {
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != key);
  const int sid = __popc(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int other = __shfl_down_sync(0xffffffffu, sid, d);
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      const unsigned long long t = __shfl_down_sync(0xffffffffu, acc[k], d);
      if (lane + d < 32 && other == sid) acc[k] += t;
    }
  }
  if (key < 0 || !((heads >> lane) & 1u)) return;
  const int g = key % G;
#pragma unroll
  for (int k = 0; k < kSums; ++k)
    if (wd.slot[k] >= 0 && acc[k] != 0ull) atomicAdd(&table[wd.slot[k] * G + g], acc[k]);
}

// After every block's atomics into the outputs, the last block to finish
// (its ticket wraps the counter back to 0 for the next launch) carries each
// limb pair's low-limb overflow into its high limb, as normalize_limbs does,
// so lo stays in [0, 2^32) however many chunks add into it.
__device__ void normalize_if_last(const SegAggParams& p) {
  __shared__ bool last;
  __threadfence();  // this block's atomics land before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(p.ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every (accumulator, group) pair on its own thread: one round trip to
  // L2, not one per accumulator
  for (long long i = threadIdx.x; i < static_cast<long long>(p.n) * p.G; i += blockDim.x) {
    const AccDesc& d = p.acc[i / p.G];
    if (d.kind != kLimbs) continue;
    const long long g = i % p.G;
    const long long lo = static_cast<long long>(__ldcg(d.out + g));
    const long long hi = static_cast<long long>(__ldcg(d.out_hi + g));
    d.out_hi[g] = static_cast<unsigned long long>(hi + (lo >> 32));
    d.out[g] = static_cast<unsigned long long>(lo) & 0xFFFFFFFFull;
  }
}

// The sorted path. Per tile of 512 rows staged in shared memory: a
// counting sort of the live rows by id (__match_any_sync groups a warp's
// lanes by id, so one shared atomic per group and warp ranks them; one warp
// scans the G counts), then every per-group sum is a run of contiguous
// positions. Each walker gets up to 512 / walkers threads, each walking its
// share of the positions with plain 64-bit adds and flushing a run's sums
// to the block's [slot][G] table when the id changes (the run it ends on
// summed first over the warp's lanes that end on the same one).
// The block flushes each non-zero sum with one global atomic at its end.
__global__ void __launch_bounds__(kThreads, 1)
segagg_sorted(const __grid_constant__ SegAggParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.G, nout = p.nout;
  unsigned long long* table = reinterpret_cast<unsigned long long*>(smem);
  unsigned* cursor = reinterpret_cast<unsigned*>(smem + p.table_bytes);  // [32]
  unsigned* offset = cursor + 32;                                        // [33]
  unsigned short* perm = reinterpret_cast<unsigned short*>(offset + 64);  // [512]
  unsigned char* sg = reinterpret_cast<unsigned char*>(perm + kTileRows);  // [512]
  unsigned char* stage = sg + kTileRows;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < nout * G; i += kThreads) table[i] = 0ull;

  // this thread's walker and its share of each tile's positions
  const int per_walk = kThreads / p.nwalk;
  const int w = threadIdx.x / per_walk, c = threadIdx.x % per_walk;
  const bool walks = w < p.nwalk;
  const WalkDesc wd = walks ? p.walkers[w] : WalkDesc{-1, -1, {-1, -1, -1, -1}};

  const long long step = static_cast<long long>(gridDim.x) * kTileRows;
  for (long long t0 = static_cast<long long>(blockIdx.x) * kTileRows; t0 < p.R;
       t0 += step) {
    const int rows = static_cast<int>(p.R - t0 < kTileRows ? p.R - t0 : kTileRows);
    if (threadIdx.x < 32) cursor[threadIdx.x] = 0u;
    for (int ci = 0; ci < p.ncols; ++ci) {
      const StageCol& col = p.cols[ci];
      stage_col(stage + col.off, col.src + t0 * col.esize, rows * col.esize);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    // 1. rank each live row within its id
    const long long* s_ids = reinterpret_cast<const long long*>(stage);
    const unsigned char* s_sel = p.sel_off >= 0 ? stage + p.sel_off : nullptr;
    int id = -1;
    if (threadIdx.x < rows) {
      const long long x = s_ids[threadIdx.x];
      if (static_cast<unsigned long long>(x) < static_cast<unsigned long long>(G) &&
          (s_sel == nullptr || s_sel[threadIdx.x]))
        id = static_cast<int>(x);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    const int leader = __ffs(peers) - 1;
    unsigned base = 0u;
    if (id >= 0 && lane == leader) base = atomicAdd(&cursor[id], __popc(peers));
    const unsigned rank = __shfl_sync(0xffffffffu, base, leader) +
                          __popc(peers & ((1u << lane) - 1u));
    __syncthreads();

    // 2. offsets: an exclusive scan of the G counts by one warp
    if (threadIdx.x < 32) {
      unsigned v = threadIdx.x < G ? cursor[threadIdx.x] : 0u;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      offset[threadIdx.x + 1] = v;
      if (threadIdx.x == 0) offset[0] = 0u;
    }
    __syncthreads();

    // 3. scatter the live rows into id order
    if (id >= 0) {
      const unsigned pos = offset[id] + rank;
      perm[pos] = static_cast<unsigned short>(threadIdx.x);
      sg[pos] = static_cast<unsigned char>(id);
    }
    __syncthreads();

    // 4. walk the positions, at least 4 to a thread, run by run (a run's
    // end is the next id's offset, so the inner loop has no branch); a run
    // that ends inside a thread's share goes to the table at once, the run
    // the share ends on is first summed over the warp (warp_run_sum)
    const int P = static_cast<int>(offset[G]);
    int share = (P + 3) / 4;
    if (share > per_walk) share = per_walk;
    unsigned long long acc[kSums] = {0ull, 0ull, 0ull, 0ull};
    int key = -1;
    if (walks && c < share) {
      const int p1 = P * (c + 1) / share;  // P <= 512: no 64-bit division
      const long long* s_vals = reinterpret_cast<const long long*>(stage + wd.vals_off);
      const unsigned char* s_mask = stage + wd.mask_off;
      int q = P * c / share;
      while (q < p1) {
        const int g = sg[q];
        const int end = min(p1, static_cast<int>(offset[g + 1]));
        unsigned long long cnt = 0ull, full = 0ull, lo = 0ull, hi = 0ull;
#pragma unroll 4
        for (; q < end; ++q) {
          const int r = perm[q];
          const bool ok = wd.mask_off < 0 || s_mask[r];
          const long long v = ok && wd.vals_off >= 0 ? s_vals[r] : 0ll;
          cnt += ok ? 1ull : 0ull;
          full += static_cast<unsigned long long>(v);
          lo += static_cast<unsigned long long>(v) & 0xFFFFFFFFull;
          hi += static_cast<unsigned long long>(v >> 32);
        }
        if (q < p1) {
          const unsigned long long run[kSums] = {cnt, full, lo, hi};
#pragma unroll
          for (int k = 0; k < kSums; ++k)
            if (wd.slot[k] >= 0 && run[k] != 0ull) atomicAdd(&table[wd.slot[k] * G + g], run[k]);
        } else {
          acc[kSumCount] = cnt;
          acc[kSumFull] = full;
          acc[kSumLo] = lo;
          acc[kSumHi] = hi;
          key = w * G + g;
        }
      }
    }
    warp_run_sum(table, wd, key, G, acc, lane);
    __syncthreads();  // the next tile overwrites the stage area and cursors
  }

  for (int i = threadIdx.x; i < nout * G; i += kThreads) {
    const unsigned long long h = table[i];
    if (h != 0ull) atomicAdd(p.slot_out[i / G] + i % G, h);
  }
  if (p.limbs) normalize_if_last(p);
}

// ---------------------------------------------------------------------------
// histogram path (G > 32): shared-memory histograms, or global atomics
// ---------------------------------------------------------------------------

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
segagg_hist(const __grid_constant__ SegAggParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* hist = reinterpret_cast<unsigned long long*>(smem);
  const int G = p.G;
  const unsigned lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int k = 0; k < p.n; ++k) {
    const AccDesc& d = p.acc[k];
    const int width = d.kind == kLimbs ? 2 : 1;
    unsigned long long* lo = kShared ? hist : d.out;
    unsigned long long* hi = kShared ? hist + G : d.out_hi;
    if (kShared) {
      for (int g = threadIdx.x; g < width * G; g += blockDim.x) hist[g] = 0ull;
      __syncthreads();
    }
    // every lane of a warp runs the same number of passes, so the warp
    // stays converged for __match_any_sync
    for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < p.R;
         base += stride) {
      const long long i = base + threadIdx.x;
      long long s = -1;
      if (i < p.R) {
        const long long x = p.seg[i];
        if (static_cast<unsigned long long>(x) < static_cast<unsigned long long>(G) &&
            (p.sel == nullptr || p.sel[i]) && (d.mask == nullptr || d.mask[i]))
          s = x;
      }
      if (d.kind == kCount) {
        const unsigned peers = __match_any_sync(0xffffffffu, s);
        if (s >= 0 && static_cast<unsigned>(__ffs(peers) - 1) == lane)
          atomicAdd(&lo[s], static_cast<unsigned long long>(__popc(peers)));
      } else if (s >= 0) {
        const long long v = d.vals[i];
        if (d.kind == kSum) {
          atomicAdd(&lo[s], static_cast<unsigned long long>(v));
        } else {
          atomicAdd(&lo[s], static_cast<unsigned long long>(v) & 0xFFFFFFFFull);
          atomicAdd(&hi[s], static_cast<unsigned long long>(v >> 32));
        }
      }
    }
    if (kShared) {
      __syncthreads();
      for (int g = threadIdx.x; g < width * G; g += blockDim.x) {
        const unsigned long long h = hist[g];
        if (h != 0ull) atomicAdd(g < G ? d.out + g : d.out_hi + (g - G), h);
      }
      __syncthreads();
    }
  }
  if (p.limbs) normalize_if_last(p);
}

// ---------------------------------------------------------------------------
// f32 sums (segment_sum_f32, off the aggregation's main path)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
segsum_f32_smem(const float* __restrict__ vals, const long long* __restrict__ seg,
                long long R, int G, float* __restrict__ out) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  float* hist = reinterpret_cast<float*>(smem_raw);
  for (int g = threadIdx.x; g < G; g += blockDim.x) hist[g] = 0.f;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < R; i += stride) {
    const long long s = seg[i];
    if (s >= 0 && s < G) atomicAdd(&hist[s], vals[i]);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float h = hist[g];
    if (h != 0.f) atomicAdd(&out[g], h);
  }
}

__global__ void __launch_bounds__(kThreads)
segsum_f32_global(const float* __restrict__ vals, const long long* __restrict__ seg,
                  long long R, int G, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < R; i += stride) {
    const long long s = seg[i];
    if (s >= 0 && s < G) atomicAdd(&out[s], vals[i]);
  }
}

int num_sms() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// Opt a kernel into `bytes` of dynamic shared memory, once per kernel.
template <typename K>
cudaError_t opt_in(K kernel, bool& done, size_t bytes) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) done = true;
  return e;
}

// Add one column to the stage list unless the same pointer is there.
int stage_offset(SegAggParams& p, const void* src, int esize, int& next_off) {
  for (int c = 0; c < p.ncols; ++c)
    if (p.cols[c].src == src && p.cols[c].esize == esize) return p.cols[c].off;
  StageCol& col = p.cols[p.ncols++];
  col.src = static_cast<const unsigned char*>(src);
  col.esize = esize;
  col.off = next_off;
  next_off += kTileRows * esize;
  return col.off;
}

}  // namespace

extern "C" {

// The fused update: `descs` is a host array of n AccIn (n in [1, 32]);
// seg int64 [R], sel bool [R] or null, every out/out_hi int64 [G] on the
// card, vals int64 [R], masks bool [R] or null; `ticket` one uint32 on the
// card, 0 between launches (needed when an accumulator is limbs).
int tidb_segagg(const void* seg, const void* sel, long long R, int G,
                const void* descs, int n, void* ticket, void* stream) {
  if (n < 1 || n > kMaxAccs || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  SegAggParams p = {};
  p.seg = static_cast<const long long*>(seg);
  p.sel = static_cast<const unsigned char*>(sel);
  p.ticket = static_cast<unsigned*>(ticket);
  p.R = R;
  p.G = G;
  p.n = n;
  p.sel_off = -1;
  const AccIn* in = static_cast<const AccIn*>(descs);
  bool limbs = false;
  for (int k = 0; k < n; ++k) {
    AccDesc& d = p.acc[k];
    d.out = static_cast<unsigned long long*>(in[k].out);
    d.out_hi = static_cast<unsigned long long*>(in[k].out_hi);
    d.vals = static_cast<const long long*>(in[k].vals);
    d.mask = static_cast<const unsigned char*>(in[k].mask);
    d.kind = in[k].kind;
    if (d.kind < kCount || d.kind > kLimbs || d.out == nullptr ||
        (d.kind != kCount && d.vals == nullptr) || (d.kind == kLimbs && d.out_hi == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    limbs = limbs || d.kind == kLimbs;
  }
  if (limbs && ticket == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.limbs = limbs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (G <= kSortMaxG) {
    int off = 0;
    stage_offset(p, seg, 8, off);
    if (sel != nullptr) p.sel_off = stage_offset(p, sel, 1, off);
    // one walker per distinct (values, mask) pair: sums and limbs first,
    // then each count joins a walker of its mask whose count is free
    for (int pass = 0; pass < 2; ++pass) {
      for (int k = 0; k < n; ++k) {
        const AccDesc& d = p.acc[k];
        if ((d.kind == kCount) != (pass == 1)) continue;
        const int vals_off = d.kind == kCount ? -1 : stage_offset(p, d.vals, 8, off);
        const int mask_off = d.mask == nullptr ? -1 : stage_offset(p, d.mask, 1, off);
        const int need = d.kind == kCount ? kSumCount : d.kind == kSum ? kSumFull : kSumLo;
        WalkDesc* wd = nullptr;
        for (int i = 0; i < p.nwalk && wd == nullptr; ++i) {
          WalkDesc& e = p.walkers[i];
          if (e.mask_off == mask_off && (d.kind == kCount || e.vals_off == vals_off) &&
              e.slot[need] < 0 && (d.kind != kLimbs || e.slot[kSumHi] < 0))
            wd = &e;
        }
        if (wd == nullptr) {
          wd = &p.walkers[p.nwalk++];
          *wd = {vals_off, mask_off, {-1, -1, -1, -1}};
        }
        p.slot_out[p.nout] = d.out;
        wd->slot[need] = p.nout++;
        if (d.kind == kLimbs) {
          p.slot_out[p.nout] = d.out_hi;
          wd->slot[kSumHi] = p.nout++;
        }
      }
    }
    p.table_bytes = (p.nout * G * 8 + 15) & ~15;
    static bool opted = false;
    const cudaError_t e = opt_in(segagg_sorted, opted, kSortedSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    long long blocks = (R + kTileRows - 1) / kTileRows;
    if (blocks > num_sms()) blocks = num_sms();
    const size_t smem = size_t(p.table_bytes) + kSortScratch + size_t(off);
    segagg_sorted<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }

  long long blocks = (R + kThreads - 1) / kThreads;
  const long long max_blocks = static_cast<long long>(num_sms()) * kBlocksPerSm;
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t smem = size_t(limbs ? 2 : 1) * G * 8;
  if (smem <= kSmemBudget) {
    static bool opted = false;
    const cudaError_t e = opt_in(segagg_hist<true>, opted, kSmemBudget);
    if (e != cudaSuccess) return static_cast<int>(e);
    // each block flushes up to 2G atomics per accumulator: keep that
    // below its row work
    long long cap = R / G;
    if (cap < 1) cap = 1;
    if (blocks > cap) blocks = cap;
    segagg_hist<true><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(p);
  } else {
    segagg_hist<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// counts[g] += #{i : mask[i] && seg[i] == g}; mask is 1 byte per row
// (torch.bool), seg and counts int64: tidb_segagg with one count.
int tidb_segsum_count(const void* mask, const void* seg, long long R, int G,
                      void* counts, void* stream) {
  const AccIn acc = {counts, nullptr, nullptr, nullptr, kCount, 0};
  return tidb_segagg(seg, mask, R, G, &acc, 1, nullptr, stream);
}

// out[g] += sum of vals[i] over seg[i] == g, mod 2^64; vals, out int64:
// tidb_segagg with one sum.
int tidb_segsum_i64(const void* vals, const void* seg, long long R, int G,
                    void* out, void* stream) {
  const AccIn acc = {out, nullptr, vals, nullptr, kSum, 0};
  return tidb_segagg(seg, nullptr, R, G, &acc, 1, nullptr, stream);
}

// out[g] += sum of vals[i] over seg[i] == g; vals, out float32 (atomics add
// in an order that changes from run to run).
int tidb_segsum_f32(const void* vals, const void* seg, long long R, int G,
                    void* out, void* stream) {
  if (R <= 0 || G <= 0) return 0;
  long long blocks = (R + kThreads * 4 - 1) / (kThreads * 4);
  const long long max_blocks = static_cast<long long>(num_sms()) * kBlocksPerSm;
  if (blocks > max_blocks) blocks = max_blocks;
  const float* v = static_cast<const float*>(vals);
  const long long* ids = static_cast<const long long*>(seg);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(G) * sizeof(float);
  if (smem <= kSmemBudget) {
    static bool opted = false;
    const cudaError_t e = opt_in(segsum_f32_smem, opted, kSmemBudget);
    if (e != cudaSuccess) return static_cast<int>(e);
    long long cap = R / G;
    if (cap < 1) cap = 1;
    if (blocks > cap) blocks = cap;
    segsum_f32_smem<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(v, ids, R, G, o);
  } else {
    segsum_f32_global<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(v, ids, R, G, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
