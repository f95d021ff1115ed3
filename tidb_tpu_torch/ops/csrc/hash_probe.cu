// Open-addressing hash-table probe for Hopper (sm_90a), bound through a
// plain C ABI (ctypes; no PyTorch headers).
//
// Replaces the Pallas kernel _probe_pallas of tidb_tpu/ops/hash_probe.py
// (B3). The table is built once per join build (ops/hash_probe.py
// build_table, plain torch): three int32 arrays of capacity cap (a power of
// two, at most 2^19) holding, per occupied slot, the 32-bit fingerprint of
// a run of equal sorted build keys, the run's start and its end. For each
// probe key the kernel computes
//   home = mix32(key) & (cap - 1),  fp = mix32(key ^ FP_SALT)
// and scans up to MAX_PROBES slots from home. A slot is a hit when its
// fingerprint equals fp and the sorted build key at the run's start equals
// the probe key (two different keys can share a slot and a fingerprint).
// The result is int64 (lo, hi) = the run's [start, end) on a hit and (0, 0)
// on a miss, as searchsorted left/right would give wherever the join reads
// them (hi - lo, and lo + k under hi - lo).
//
// What bounds it on an H100: bytes. A probe reads its 8-byte key and writes
// 16 bytes of (lo, hi): 24 B per probe over 3.35 TB/s. The table (at most
// 6 MiB) and the sorted keys are read through the read-only cache and stay
// in L2 across the probes of a chunk.
//
// Design. The TPU kernel runs all MAX_PROBES rounds as vector selects over
// a tile, with every hash split into int32 halves because Mosaic keeps to
// int32. Here one thread takes one probe key and mixes it in uint64 itself
// (splitmix64 tail, the same bits as the torch mix that builds the table),
// and it stops at the first hit or the first EMPTY slot. Stopping is sound:
// the build never frees a slot, so a run placed at home + r leaves
// home .. home + r - 1 occupied and the scan reaches it before any EMPTY
// slot; and distinct runs hold distinct keys, so the first verified hit is
// the only one. Outputs are written coalesced, one int64 per thread each.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxProbes = 32;                     // MAX_PROBES
constexpr int kEmpty = 0x7FFFFFFF;                 // the table's free slot
constexpr unsigned long long kFpSalt = 0x9E3779B97F4A7C15ull;

// int64 -> well-spread int32 (splitmix64 tail), EMPTY remapped to 0 so a
// stored fingerprint never looks like a free slot
__device__ __forceinline__ int mix32(unsigned long long h) {
  h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
  h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
  const int out = static_cast<int>(static_cast<unsigned int>(h ^ (h >> 31)));
  return out == kEmpty ? 0 : out;
}

__global__ void __launch_bounds__(kThreads)
probe_table(const long long* __restrict__ probes, long long n,
            const int* __restrict__ tkeys, const int* __restrict__ tlos,
            const int* __restrict__ this_, unsigned int mask,
            const long long* __restrict__ sorted_keys, long long n_sorted,
            long long* __restrict__ lo_out, long long* __restrict__ hi_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long key = probes[i];
  const unsigned long long ukey = static_cast<unsigned long long>(key);
  const unsigned int home = static_cast<unsigned int>(mix32(ukey)) & mask;
  const int fp = mix32(ukey ^ kFpSalt);
  long long lo = 0, hi = 0;
  for (int r = 0; r < kMaxProbes; ++r) {
    const unsigned int pos = (home + r) & mask;
    const int k = __ldg(tkeys + pos);
    if (k == kEmpty) break;
    if (k == fp) {
      const int cand = __ldg(tlos + pos);
      long long c = cand < 0 ? 0 : cand;
      if (c > n_sorted - 1) c = n_sorted - 1;
      if (__ldg(sorted_keys + c) == key) {
        lo = cand;
        hi = __ldg(this_ + pos);
        break;
      }
    }
  }
  lo_out[i] = lo;
  hi_out[i] = hi;
}

}  // namespace

extern "C" {

// (lo[i], hi[i]) for each of the n probe keys (int64) against a table of
// capacity cap (int32 tkeys/tlos/this) over n_sorted sorted int64 keys.
int tidb_hash_probe(const void* probes, long long n, const void* tkeys,
                    const void* tlos, const void* this_, int cap,
                    const void* sorted_keys, long long n_sorted, void* lo,
                    void* hi, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (cap <= 0 || (cap & (cap - 1)) != 0 || n_sorted <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  probe_table<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(probes), n, static_cast<const int*>(tkeys),
      static_cast<const int*>(tlos), static_cast<const int*>(this_),
      static_cast<unsigned int>(cap - 1),
      static_cast<const long long*>(sorted_keys), n_sorted,
      static_cast<long long*>(lo), static_cast<long long*>(hi));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
