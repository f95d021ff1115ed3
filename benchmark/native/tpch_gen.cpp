// TPC-H data generator core (the dbgen equivalent of the native
// data-loader tier; ref: the reference ecosystem's external dbgen +
// TiKV-side ingest, which live below the SQL layer as native code).
//
// Generates the two big tables (orders, lineitem) directly in the
// engine's device representation: int64 columns, scale-2 cents for
// money, days-since-epoch dates, and dictionary CODES for the
// low-cardinality string columns (the Python side supplies the sorted
// pools). Strings for the big tables never exist as Python objects —
// the columnar buffers fill at memcpy-like speed and stage straight to
// HBM.
//
// Determinism: splitmix64 seeded per (seed, purpose) stream, so
// tpch_sizes and tpch_gen agree on the variable lineitem count.
//
// Keys follow TPC-H clause 4.2.3: O_ORDERKEY is sparse (the first 8 of
// every 32 keys), O_CUSTKEY is never a multiple of 3, and L_SUPPKEY is
// one of its part's four PS_SUPPKEY values.
//
// C ABI only (loaded via ctypes; no pybind11 in this image).

#include <cstdint>
#include <cstring>

namespace {

struct Rng {
    uint64_t s;
    explicit Rng(uint64_t seed) : s(seed) {}
    uint64_t next() {
        uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
        return z ^ (z >> 31);
    }
    // uniform in [lo, hi] inclusive
    int64_t uniform(int64_t lo, int64_t hi) {
        return lo + static_cast<int64_t>(next() % static_cast<uint64_t>(hi - lo + 1));
    }
    double real() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

// days since epoch for the spec's fixed dates
constexpr int64_t kStart = 8035;    // 1992-01-01
constexpr int64_t kEnd = 10440;     // 1998-08-02
constexpr int64_t kCurrent = 9298;  // 1995-06-17

inline int64_t retail_price(int64_t pk) {
    return 90000 + (pk / 10) % 20001 + 100 * (pk % 1000);
}

// the i-th (0..3) supplier of part pk among nsupp suppliers (PS_SUPPKEY)
inline int64_t part_supp(int64_t pk, int64_t i, int64_t nsupp) {
    return (pk + i * (nsupp / 4 + (pk - 1) / nsupp)) % nsupp + 1;
}

}  // namespace

extern "C" {

// Row counts for scale factor sf: orders count and (rng-dependent)
// lineitem count. Must be called before tpch_gen to size the buffers.
void tpch_sizes(double sf, uint64_t seed, int64_t* no_out, int64_t* nl_out) {
    int64_t no = static_cast<int64_t>(1500000.0 * sf);
    if (no < 1) no = 1;
    Rng rng(seed * 2654435761ULL + 1);
    int64_t nl = 0;
    for (int64_t i = 0; i < no; i++) nl += rng.uniform(1, 7);
    *no_out = no;
    *nl_out = nl;
}

// Fill orders + lineitem columns. All pointers are int64 buffers sized
// by tpch_sizes (orders: no; lineitem: nl). *_code columns are indices
// into the sorted pools the caller owns. npart/nsupp/ncust/nclerk give
// the FK domains.
void tpch_gen(
    double sf, uint64_t seed,
    int64_t npart, int64_t nsupp, int64_t ncust, int64_t nclerk,
    // orders
    int64_t* o_orderkey, int64_t* o_custkey, int64_t* o_totalprice,
    int64_t* o_orderdate, int64_t* o_shippriority, int64_t* o_status_code,
    int64_t* o_priority_code, int64_t* o_clerk_code, int64_t* o_comment_code,
    // lineitem
    int64_t* l_orderkey, int64_t* l_partkey, int64_t* l_suppkey,
    int64_t* l_linenumber, int64_t* l_quantity, int64_t* l_extendedprice,
    int64_t* l_discount, int64_t* l_tax, int64_t* l_returnflag_code,
    int64_t* l_linestatus_code, int64_t* l_shipdate, int64_t* l_commitdate,
    int64_t* l_receiptdate, int64_t* l_instruct_code, int64_t* l_shipmode_code,
    int64_t* l_comment_code) {
    int64_t no = static_cast<int64_t>(1500000.0 * sf);
    if (no < 1) no = 1;

    // identical stream to tpch_sizes for the per-order line counts
    Rng line_rng(seed * 2654435761ULL + 1);
    Rng rng(seed * 0x9E3779B97F4A7C15ULL + 7);

    // customer keys that place orders: those not divisible by 3
    int64_t ncust_ordering = ncust - ncust / 3;
    int64_t li = 0;
    for (int64_t o = 0; o < no; o++) {
        int64_t okey = (o / 8) * 32 + (o % 8) + 1;
        int64_t lines = line_rng.uniform(1, 7);
        int64_t odate = rng.uniform(kStart, kEnd - 151);

        o_orderkey[o] = okey;
        int64_t ci = rng.uniform(0, ncust_ordering - 1);
        o_custkey[o] = 3 * (ci / 2) + (ci % 2) + 1;
        o_orderdate[o] = odate;
        o_shippriority[o] = 0;
        o_priority_code[o] = rng.uniform(0, 4);
        o_clerk_code[o] = rng.uniform(0, nclerk - 1);
        o_comment_code[o] = rng.uniform(0, 63);

        int64_t total_scale6 = 0;  // sum of extended*(1-d)*(1+t), scale 6
        int64_t n_f = 0;
        for (int64_t j = 0; j < lines; j++, li++) {
            int64_t pk = rng.uniform(1, npart);
            int64_t qty = rng.uniform(1, 50);
            int64_t ext = qty * retail_price(pk);
            int64_t disc = rng.uniform(0, 10);
            int64_t tax = rng.uniform(0, 8);
            int64_t ship = odate + rng.uniform(1, 121);
            int64_t commit = odate + rng.uniform(30, 90);
            int64_t receipt = ship + rng.uniform(1, 30);

            l_orderkey[li] = okey;
            l_partkey[li] = pk;
            l_suppkey[li] = part_supp(pk, rng.uniform(0, 3), nsupp);
            l_linenumber[li] = j + 1;
            l_quantity[li] = qty * 100;  // scale-2
            l_extendedprice[li] = ext;
            l_discount[li] = disc;
            l_tax[li] = tax;
            l_shipdate[li] = ship;
            l_commitdate[li] = commit;
            l_receiptdate[li] = receipt;
            // sorted pool {A, N, R}: returned -> A or R, else N
            bool returned = receipt <= kCurrent;
            l_returnflag_code[li] = returned ? (rng.real() < 0.5 ? 0 : 2) : 1;
            // sorted pool {F, O}
            bool open = ship > kCurrent;
            l_linestatus_code[li] = open ? 1 : 0;
            if (!open) n_f++;
            l_instruct_code[li] = rng.uniform(0, 3);
            l_shipmode_code[li] = rng.uniform(0, 6);
            l_comment_code[li] = rng.uniform(0, 63);

            total_scale6 += ext * (100 - disc) * (100 + tax) / 10000;
        }
        o_totalprice[o] = total_scale6;
        // sorted pool {F, O, P}
        o_status_code[o] = (n_f == lines) ? 0 : (n_f == 0 ? 1 : 2);
    }
}

}  // extern "C"
