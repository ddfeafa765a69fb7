// Native host-side kernels for ligero_jax.
//
// The device owns the dense bulk math (NTT, hashing, combinations); the host
// owns irregular, pointer-chasing work the reference does in Rust:
// witness evaluation over the circuit DAG and the sparse r^T·A products
// (reference: src/arithmetic_circuit/mod.rs:247-271 evaluator,
// src/matrices/mod.rs:100-110 sparse row_mul).  Python-int big-number
// arithmetic is ~100x too slow at 2^20 gates, so these run here as
// limb-vector Montgomery arithmetic, generic over the u64 limb count
// (4 = BN254, 6 = BLS12-377 Fq).
//
// Build: g++ -O3 -shared -fPIC (driven by ligero_jax/native.py, loaded via
// ctypes; the framework falls back to pure Python when unavailable).
//
// Representation: little-endian u64 limbs; "mont" = Montgomery form with
// R = 2^(64*NL), matching ark-ff and ligero_jax.fields.

#include <cstdint>
#include <cstring>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

using u64 = uint64_t;
using u128 = __uint128_t;

namespace {

constexpr int MAX_NL = 8;

struct Field {
    int nl;
    u64 p[MAX_NL];
    u64 n0inv;           // -p^{-1} mod 2^64
    u64 r2[MAX_NL];      // R^2 mod p
};

inline bool geq(const u64* a, const u64* b, int nl) {
    for (int i = nl - 1; i >= 0; --i) {
        if (a[i] > b[i]) return true;
        if (a[i] < b[i]) return false;
    }
    return true;  // equal
}

inline void sub_p(u64* a, const u64* p, int nl) {
    u64 borrow = 0;
    for (int i = 0; i < nl; ++i) {
        u128 t = (u128)a[i] - p[i] - borrow;
        a[i] = (u64)t;
        borrow = (t >> 64) ? 1 : 0;
    }
}

// CIOS Montgomery multiplication: out = a*b*R^{-1} mod p.
inline void mont_mul(const Field& f, const u64* a, const u64* b, u64* out) {
    const int nl = f.nl;
    u64 t[MAX_NL + 2] = {0};
    for (int i = 0; i < nl; ++i) {
        u128 carry = 0;
        for (int j = 0; j < nl; ++j) {
            u128 cur = (u128)t[j] + (u128)a[i] * b[j] + carry;
            t[j] = (u64)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[nl] + carry;
        t[nl] = (u64)cur;
        t[nl + 1] = (u64)(cur >> 64);

        u64 m = t[0] * f.n0inv;
        carry = ((u128)t[0] + (u128)m * f.p[0]) >> 64;
        for (int j = 1; j < nl; ++j) {
            u128 c2 = (u128)t[j] + (u128)m * f.p[j] + carry;
            t[j - 1] = (u64)c2;
            carry = c2 >> 64;
        }
        cur = (u128)t[nl] + carry;
        t[nl - 1] = (u64)cur;
        t[nl] = t[nl + 1] + (u64)(cur >> 64);
        t[nl + 1] = 0;
    }
    // t[0..nl] holds the result (t[nl] is the overflow bit)
    if (t[nl] || geq(t, f.p, nl)) sub_p(t, f.p, nl);
    std::memcpy(out, t, nl * sizeof(u64));
}

inline void add_mod(const Field& f, const u64* a, const u64* b, u64* out) {
    const int nl = f.nl;
    u64 carry = 0;
    u64 t[MAX_NL + 1];
    for (int i = 0; i < nl; ++i) {
        u128 cur = (u128)a[i] + b[i] + carry;
        t[i] = (u64)cur;
        carry = (u64)(cur >> 64);
    }
    t[nl] = carry;
    if (carry || geq(t, f.p, nl)) sub_p(t, f.p, nl);
    std::memcpy(out, t, nl * sizeof(u64));
}

// ---------------------------------------------------------------------
// ChaCha20 (djb variant, 64-bit counter, stream 0) — the rand_chacha
// keystream behind ark's F::rand challenge expansion
// (reference src/utils.rs:23-29).  Consumed as sequential u64 draws, so
// the 4-block BlockRng refill is equivalent to a flat block stream.
// ---------------------------------------------------------------------

inline uint32_t rotl32(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

inline void chacha20_block(const uint32_t key[8], u64 counter,
                           uint32_t out[16]) {
    static const uint32_t C[4] = {0x61707865u, 0x3320646eu,
                                  0x79622d32u, 0x6b206574u};
    uint32_t s[16];
    for (int i = 0; i < 4; ++i) s[i] = C[i];
    for (int i = 0; i < 8; ++i) s[4 + i] = key[i];
    s[12] = (uint32_t)counter;
    s[13] = (uint32_t)(counter >> 32);
    s[14] = 0;
    s[15] = 0;
    uint32_t x[16];
    std::memcpy(x, s, sizeof(s));
#define LH_QR(a, b, c, d)                                                \
    x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 16);                        \
    x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 12);                        \
    x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 8);                         \
    x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 7);
    for (int r = 0; r < 10; ++r) {
        LH_QR(0, 4, 8, 12) LH_QR(1, 5, 9, 13)
        LH_QR(2, 6, 10, 14) LH_QR(3, 7, 11, 15)
        LH_QR(0, 5, 10, 15) LH_QR(1, 6, 11, 12)
        LH_QR(2, 7, 8, 13) LH_QR(3, 4, 9, 14)
    }
#undef LH_QR
    for (int i = 0; i < 16; ++i) out[i] = x[i] + s[i];
}

// 8 consecutive counter-mode blocks at once: state laid out as
// x[word][block] so every round statement is an independent 8-lane
// loop the compiler vectorizes (AVX2: one 256-bit op per statement).
inline void chacha20_blocks8(const uint32_t key[8], u64 counter0,
                             uint32_t* out /* 16*8 words */) {
    static const uint32_t C[4] = {0x61707865u, 0x3320646eu,
                                  0x79622d32u, 0x6b206574u};
    uint32_t x[16][8];
    uint32_t c12[8], c13[8];
    for (int j = 0; j < 8; ++j) {
        u64 c = counter0 + (u64)j;
        c12[j] = (uint32_t)c;
        c13[j] = (uint32_t)(c >> 32);
    }
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 8; ++j) x[i][j] = C[i];
    for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) x[4 + i][j] = key[i];
    for (int j = 0; j < 8; ++j) {
        x[12][j] = c12[j];
        x[13][j] = c13[j];
        x[14][j] = 0;
        x[15][j] = 0;
    }
#define LH_QR8(a, b, c, d)                                                 \
    for (int j = 0; j < 8; ++j) x[a][j] += x[b][j];                        \
    for (int j = 0; j < 8; ++j) x[d][j] = rotl32(x[d][j] ^ x[a][j], 16);   \
    for (int j = 0; j < 8; ++j) x[c][j] += x[d][j];                        \
    for (int j = 0; j < 8; ++j) x[b][j] = rotl32(x[b][j] ^ x[c][j], 12);   \
    for (int j = 0; j < 8; ++j) x[a][j] += x[b][j];                        \
    for (int j = 0; j < 8; ++j) x[d][j] = rotl32(x[d][j] ^ x[a][j], 8);    \
    for (int j = 0; j < 8; ++j) x[c][j] += x[d][j];                        \
    for (int j = 0; j < 8; ++j) x[b][j] = rotl32(x[b][j] ^ x[c][j], 7);
    for (int r = 0; r < 10; ++r) {
        LH_QR8(0, 4, 8, 12) LH_QR8(1, 5, 9, 13)
        LH_QR8(2, 6, 10, 14) LH_QR8(3, 7, 11, 15)
        LH_QR8(0, 5, 10, 15) LH_QR8(1, 6, 11, 12)
        LH_QR8(2, 7, 8, 13) LH_QR8(3, 4, 9, 14)
    }
#undef LH_QR8
    // add the initial state, then store block-major
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 8; ++j) x[i][j] += C[i];
    for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) x[4 + i][j] += key[i];
    for (int j = 0; j < 8; ++j) {
        x[12][j] += c12[j];
        x[13][j] += c13[j];
    }
    for (int j = 0; j < 8; ++j)
        for (int i = 0; i < 16; ++i) out[j * 16 + i] = x[i][j];
}

Field make_field(int nl, const u64* p, u64 n0inv, const u64* r2) {
    Field f;
    f.nl = nl;
    f.n0inv = n0inv;
    std::memcpy(f.p, p, nl * sizeof(u64));
    std::memcpy(f.r2, r2, nl * sizeof(u64));
    return f;
}

}  // namespace

extern "C" {

// values[count][nl]: canonical -> Montgomery in place.
void lh_to_mont(int nl, const u64* p, u64 n0inv, const u64* r2,
                u64* values, int64_t count) {
    Field f = make_field(nl, p, n0inv, r2);
    u64 tmp[MAX_NL];
    for (int64_t i = 0; i < count; ++i) {
        mont_mul(f, values + i * nl, f.r2, tmp);
        std::memcpy(values + i * nl, tmp, nl * sizeof(u64));
    }
}

// values[count][nl]: Montgomery -> canonical in place.
void lh_from_mont(int nl, const u64* p, u64 n0inv, const u64* r2,
                  u64* values, int64_t count) {
    Field f = make_field(nl, p, n0inv, r2);
    u64 one[MAX_NL] = {1, 0, 0, 0, 0, 0, 0, 0};
    u64 tmp[MAX_NL];
    for (int64_t i = 0; i < count; ++i) {
        mont_mul(f, values + i * nl, one, tmp);
        std::memcpy(values + i * nl, tmp, nl * sizeof(u64));
    }
}

// Forward evaluation of a topologically-ordered circuit.
//   kinds[i]: 0 = preset (constant/variable; values[i] already in
//             Montgomery form, have[i] = 1), 1 = add, 2 = mul.
// Returns 0 on success, 1 + index of the first unset operand on failure.
int64_t lh_eval_circuit(int nl, const u64* p, u64 n0inv, const u64* r2,
                        const uint8_t* kinds, const int64_t* lefts,
                        const int64_t* rights, u64* values, uint8_t* have,
                        int64_t n_nodes) {
    Field f = make_field(nl, p, n0inv, r2);
    for (int64_t i = 0; i < n_nodes; ++i) {
        if (kinds[i] == 0) {
            if (!have[i]) return i + 1;
            continue;
        }
        int64_t l = lefts[i], r = rights[i];
        if (!have[l]) return l + 1;
        if (!have[r]) return r + 1;
        if (kinds[i] == 1) {
            add_mod(f, values + l * nl, values + r * nl, values + i * nl);
        } else {
            mont_mul(f, values + l * nl, values + r * nl, values + i * nl);
        }
        have[i] = 1;
    }
    return 0;
}

// Poseidon duplex-sponge absorb (ark-crypto-primitives 0.5 semantics for
// the test_sponge config: state width 3 = rate 2 + capacity 1, MDS
// [[1,0,1],[1,1,0],[0,1,1]], x^alpha S-box; reference transcript call
// sites src/ligero/mod.rs:560-973).  All field values Montgomery.
//
//   state:      3*nl limbs, in/out
//   mode:       0 = absorbing, 1 = squeezing (ark DuplexSpongeMode)
//   mode_index: next_absorb_index / next_squeeze_index
//   ark_rc:     (full+partial) x 3 x nl Montgomery round constants
//
// Runs the exact absorb state machine (including mid-absorb permutes for
// inputs longer than the rate) so the Python sponge can hand off whole
// element vectors; ~100x faster than host-int pow chains at the 2^20
// transcript scale (k=1024-element absorbs => 512 serial permutations).
void lh_poseidon_absorb(int nl, const u64* p, u64 n0inv, const u64* r2,
                        const u64* ark_rc, int full_rounds, int partial_rounds,
                        u64 alpha, u64* state, int64_t* mode,
                        int64_t* mode_index, const u64* elems, int64_t count) {
    Field f = make_field(nl, p, n0inv, r2);

    u64 sbox_out[MAX_NL];
    auto mont_pow = [&](const u64* base, u64 e, u64* out) {
        // e >= 1: left-to-right binary square-and-multiply from the MSB
        int msb = 63;
        while (!((e >> msb) & 1)) --msb;
        u64 acc[MAX_NL];
        std::memcpy(acc, base, nl * sizeof(u64));
        for (int b = msb - 1; b >= 0; --b) {
            u64 sq[MAX_NL];
            mont_mul(f, acc, acc, sq);
            if ((e >> b) & 1) mont_mul(f, sq, base, acc);
            else std::memcpy(acc, sq, nl * sizeof(u64));
        }
        std::memcpy(out, acc, nl * sizeof(u64));
    };

    const int half = full_rounds / 2;
    const int total = full_rounds + partial_rounds;
    auto permute = [&]() {
        for (int r = 0; r < total; ++r) {
            const bool is_full = r < half || r >= half + partial_rounds;
            const u64* rc = ark_rc + (int64_t)r * 3 * nl;
            for (int i = 0; i < 3; ++i)
                add_mod(f, state + i * nl, rc + i * nl, state + i * nl);
            if (is_full) {
                for (int i = 0; i < 3; ++i) {
                    mont_pow(state + i * nl, alpha, sbox_out);
                    std::memcpy(state + i * nl, sbox_out, nl * sizeof(u64));
                }
            } else {
                mont_pow(state, alpha, sbox_out);
                std::memcpy(state, sbox_out, nl * sizeof(u64));
            }
            // MDS [[1,0,1],[1,1,0],[0,1,1]]
            u64 ns[3 * MAX_NL];
            add_mod(f, state + 0 * nl, state + 2 * nl, ns + 0 * nl);
            add_mod(f, state + 0 * nl, state + 1 * nl, ns + 1 * nl);
            add_mod(f, state + 1 * nl, state + 2 * nl, ns + 2 * nl);
            std::memcpy(state, ns, 3 * nl * sizeof(u64));
        }
    };

    int64_t rate_start;
    if (*mode == 0) {
        rate_start = *mode_index;
        if (rate_start == 2) { permute(); rate_start = 0; }
    } else {
        permute();
        rate_start = 0;
    }

    int64_t i = 0;
    for (;;) {
        const int64_t rem = count - i;
        if (rate_start + rem <= 2) {
            for (int64_t j = 0; j < rem; ++j) {
                u64* dst = state + (1 + rate_start + j) * nl;
                add_mod(f, dst, elems + (i + j) * nl, dst);
            }
            *mode = 0;
            *mode_index = rate_start + rem;
            return;
        }
        const int64_t num = 2 - rate_start;
        for (int64_t j = 0; j < num; ++j) {
            u64* dst = state + (1 + rate_start + j) * nl;
            add_mod(f, dst, elems + (i + j) * nl, dst);
        }
        permute();
        i += num;
        rate_start = 0;
    }
}

// Sparse v^T·M accumulation: out[cols[e]] += r[rows[e]] * vals[e] for every
// entry e.  r and vals in Montgomery form; out (pre-zeroed, ncols x nl)
// accumulates in Montgomery form.
void lh_sparse_row_mul(int nl, const u64* p, u64 n0inv, const u64* r2,
                       int64_t nnz, const int32_t* rows, const int32_t* cols,
                       const u64* vals, const u64* r, u64* out) {
    Field f = make_field(nl, p, n0inv, r2);
    u64 prod[MAX_NL];
    for (int64_t e = 0; e < nnz; ++e) {
        mont_mul(f, r + (int64_t)rows[e] * nl, vals + e * nl, prod);
        u64* dst = out + (int64_t)cols[e] * nl;
        add_mod(f, dst, prod, dst);
    }
}

// Column-partitioned parallel variant: REQUIRES cols[] nondecreasing
// (stable column sort preserves per-column entry order, so sums are
// bit-identical to the serial kernel above).  Each column's entries are
// contiguous, so snapping every static chunk boundary forward to the
// next column start gives each thread exclusive ownership of its
// columns — no atomics.  Threads compute boundaries with the same
// formula, so ranges tile [0, nnz) exactly.
void lh_sparse_row_mul_sorted(int nl, const u64* p, u64 n0inv,
                              const u64* r2, int64_t nnz,
                              const int32_t* rows, const int32_t* cols,
                              const u64* vals, const u64* r, u64* out) {
#ifdef _OPENMP
    Field f = make_field(nl, p, n0inv, r2);
#pragma omp parallel
    {
        int nth = omp_get_num_threads();
        int tid = omp_get_thread_num();
        int64_t lo = nnz * (int64_t)tid / nth;
        int64_t hi = nnz * (int64_t)(tid + 1) / nth;
        while (lo > 0 && lo < nnz && cols[lo] == cols[lo - 1]) ++lo;
        while (hi > 0 && hi < nnz && cols[hi] == cols[hi - 1]) ++hi;
        u64 prod[MAX_NL];
        for (int64_t e = lo; e < hi; ++e) {
            mont_mul(f, r + (int64_t)rows[e] * nl, vals + e * nl, prod);
            u64* dst = out + (int64_t)cols[e] * nl;
            add_mod(f, dst, prod, dst);
        }
    }
#else
    lh_sparse_row_mul(nl, p, n0inv, r2, nnz, rows, cols, vals, r, out);
#endif
}

// F::rand rejection sampling straight off the ChaCha20 stream: draw nl
// u64s (LSB first), mask the top limb to MODULUS_BIT_SIZE, accept iff
// lexicographically < p.  Accepted raw limbs ARE the Montgomery form
// (ark semantics; see ligero_jax/sampling.py).  out: count x nl u64.
// out[j][.] = sum_i a[i][j] * b[i][j] * R^{-1} mod p  (the verifier's
// <r_evals, column> spot products over every opened column at once;
// reference src/ligero/mod.rs:820-828 per-column inner products).
// a, b: (rows, cols, nl) u64 limbs; out: (cols, nl), zero-initialised
// by the caller.
void lh_mul_sum_rows(int nl, const u64* p, u64 n0inv, const u64* r2,
                     int64_t rows, int64_t cols,
                     const u64* a, const u64* b, u64* out) {
    Field f = make_field(nl, p, n0inv, r2);
    u64 prod[MAX_NL];
    for (int64_t i = 0; i < rows; ++i) {
        const u64* ra = a + i * cols * nl;
        const u64* rb = b + i * cols * nl;
        for (int64_t j = 0; j < cols; ++j) {
            mont_mul(f, ra + j * nl, rb + j * nl, prod);
            add_mod(f, out + j * nl, prod, out + j * nl);
        }
    }
}

// Quadratic spot check: out[j] = sum_i r[i] * (x[i,j]*y[i,j] - z[i,j])
// with x,y,z canonical columns and r Montgomery weights — i.e.
// term = mont_mul(mont_mul(x, R2), y) (exact canonical product), minus z
// mod p, weighted by mont_mul(r, term) and summed mod p (reference
// src/ligero/mod.rs:901-961 per-column quadratic test).
// x,y,z: (rows, cols, nl); r: (rows, nl); out: (cols, nl) zeroed.
void lh_quad_spot(int nl, const u64* p, u64 n0inv, const u64* r2,
                  int64_t rows, int64_t cols, const u64* x, const u64* y,
                  const u64* z, const u64* r, u64* out) {
    Field f = make_field(nl, p, n0inv, r2);
    u64 xm[MAX_NL], term[MAX_NL], w[MAX_NL];
    for (int64_t i = 0; i < rows; ++i) {
        const u64* xi = x + i * cols * nl;
        const u64* yi = y + i * cols * nl;
        const u64* zi = z + i * cols * nl;
        const u64* ri = r + i * nl;
        for (int64_t j = 0; j < cols; ++j) {
            mont_mul(f, xi + j * nl, f.r2, xm);      // to_mont(x)
            mont_mul(f, xm, yi + j * nl, term);      // canonical x*y
            // term -= z (mod p)
            u64 borrow = 0;
            u64 t[MAX_NL];
            for (int l = 0; l < nl; ++l) {
                u128 cur = (u128)term[l] - zi[j * nl + l] - borrow;
                t[l] = (u64)cur;
                borrow = (cur >> 64) ? 1 : 0;
            }
            if (borrow) {  // re-add p
                u64 carry = 0;
                for (int l = 0; l < nl; ++l) {
                    u128 cur = (u128)t[l] + f.p[l] + carry;
                    t[l] = (u64)cur;
                    carry = (u64)(cur >> 64);
                }
            }
            mont_mul(f, ri, t, w);
            add_mod(f, out + j * nl, w, out + j * nl);
        }
    }
}

void lh_chacha_fr_sample(int nl, const u64* p, u64 topmask,
                         const uint32_t* key, int64_t count, u64* out) {
    // Chunked batch variant of the serial word-stream sampler: generate
    // the keystream for a block range in parallel (ChaCha20 is counter-
    // mode — every block is independent), test every attempt in
    // parallel, then compact accepted candidates IN ATTEMPT ORDER.
    // Acceptance order is stream order, so the output is bit-identical
    // to the serial loop; over-generated keystream is discarded, which
    // is sound because every expansion uses a fresh squeezed seed (the
    // stream position never escapes this call).
    const int wpa = 2 * nl;                 // u32 words per attempt
    const int64_t CHUNK = 1 << 19;          // attempts per chunk
    std::vector<uint32_t> ks;
    std::vector<u64> cands;
    std::vector<uint8_t> flags;
    int64_t got = 0;
    u64 word_pos = 0;                       // global stream word offset
    while (got < count) {
        int64_t remaining = count - got;
        // acceptance prob = p / 2^bits (>= 1/2 after the top mask);
        // 1/4 slack + 64 makes a second chunk astronomically rare
        int64_t A = remaining + remaining / 4 + 64;
        if (A > CHUNK) A = CHUNK;
        u64 word_lo = word_pos;
        u64 word_hi = word_pos + (u64)A * (u64)wpa;
        u64 blk_lo = word_lo / 16, blk_hi = (word_hi + 15) / 16;
        int64_t nblk = (int64_t)(blk_hi - blk_lo);
        ks.resize((size_t)nblk * 16);
        int64_t nbatch = (nblk + 7) / 8;
#pragma omp parallel for schedule(static)
        for (int64_t t = 0; t < nbatch; ++t) {
            int64_t b0 = t * 8;
            if (b0 + 8 <= nblk)
                chacha20_blocks8(key, blk_lo + (u64)b0, ks.data() + b0 * 16);
            else
                for (int64_t b = b0; b < nblk; ++b)
                    chacha20_block(key, blk_lo + (u64)b, ks.data() + b * 16);
        }
        cands.resize((size_t)A * nl);
        flags.resize((size_t)A);
        const int64_t base_off = (int64_t)(word_lo - blk_lo * 16);
#pragma omp parallel for schedule(static)
        for (int64_t a = 0; a < A; ++a) {
            const uint32_t* w = ks.data() + base_off + a * wpa;
            u64 cand[MAX_NL];
            for (int i = 0; i < nl; ++i)
                cand[i] = (u64)w[2 * i] | ((u64)w[2 * i + 1] << 32);
            cand[nl - 1] &= topmask;
            bool lt = false;
            for (int i = nl - 1; i >= 0; --i) {
                if (cand[i] < p[i]) { lt = true; break; }
                if (cand[i] > p[i]) break;
            }
            flags[a] = (uint8_t)lt;
            std::memcpy(cands.data() + (size_t)a * nl, cand,
                        nl * sizeof(u64));
        }
        for (int64_t a = 0; a < A && got < count; ++a)
            if (flags[a]) {
                std::memcpy(out + (size_t)got * nl,
                            cands.data() + (size_t)a * nl, nl * sizeof(u64));
                ++got;
            }
        word_pos = word_hi;
    }
}

}  // extern "C"
