// Native host backend of the PyTorch port: sect233k1 point codec and
// scalar multiplication, and the gnark R1CS row parser.
//
// A copy of dvpari_tpu/native/xsk233_native.cpp, cut to what the port
// calls: the verifier's two scalar multiplications and point decodes
// (dv_pt_smul, dv_pt_decode), the bulk decode of 30-byte point records
// (dv_pt_decode_bulk) and the R1CS row parse (dv_r1cs_meta,
// dv_r1cs_parse).  The port encodes records and recodes scalars on the
// card, so the bulk encoder, batched affine and tau-NAF recoders of the
// original are left out.
//
// Field: GF(2)[x]/(x^233 + x^74 + 1), elements as 4x64-bit words.
// Curve: y^2 + xy = x^3 + 1 (sect233k1, a=0, b=1), prime subgroup.
//
// Built with g++ at first use into a plain C ABI shared library and
// loaded via ctypes (dvpari_tpu_torch/native.py).

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__PCLMUL__)
#include <smmintrin.h>
#include <wmmintrin.h>
#endif

typedef uint64_t u64;

namespace {

struct FE {
  u64 w[4];  // bits 0..233, little-endian words
};

inline FE fe_zero() { return FE{{0, 0, 0, 0}}; }

inline bool fe_is_zero(const FE &a) {
  return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0;
}

inline FE fe_add(const FE &a, const FE &b) {
  FE r;
  for (int i = 0; i < 4; i++) r.w[i] = a.w[i] ^ b.w[i];
  return r;
}

// carry-less 64x64 -> 128.  PCLMULQDQ when the build machine has it
// (build() compiles on the host that runs it); 4-bit windowed shifts as
// the portable fallback.
#if defined(__PCLMUL__)
inline void clmul64(u64 a, u64 b, u64 &hi, u64 &lo) {
  __m128i r = _mm_clmulepi64_si128(_mm_set_epi64x(0, (long long)a),
                                   _mm_set_epi64x(0, (long long)b), 0x00);
  lo = (u64)_mm_cvtsi128_si64(r);
  hi = (u64)_mm_extract_epi64(r, 1);
}
#else
inline void clmul64(u64 a, u64 b, u64 &hi, u64 &lo) {
  u64 tab[16][2];
  tab[0][0] = 0; tab[0][1] = 0;
  tab[1][0] = a; tab[1][1] = 0;
  for (int i = 2; i < 16; i += 2) {
    // tab[i] = tab[i/2] << 1 ; tab[i+1] = tab[i] ^ a
    tab[i][0] = tab[i / 2][0] << 1;
    tab[i][1] = (tab[i / 2][1] << 1) | (tab[i / 2][0] >> 63);
    tab[i + 1][0] = tab[i][0] ^ a;
    tab[i + 1][1] = tab[i][1];
  }
  u64 rlo = 0, rhi = 0;
  for (int s = 60; s >= 0; s -= 4) {
    // r <<= 4
    rhi = (rhi << 4) | (rlo >> 60);
    rlo <<= 4;
    unsigned nib = (b >> s) & 0xF;
    rlo ^= tab[nib][0];
    rhi ^= tab[nib][1];
  }
  hi = rhi;
  lo = rlo;
}
#endif

// full 233x233 -> <=465-bit product into 8 words (schoolbook 4x4)
inline void fe_clmul_wide(const FE &a, const FE &b, u64 out[8]) {
  memset(out, 0, 8 * sizeof(u64));
  for (int i = 0; i < 4; i++) {
    for (int j = 0; j < 4; j++) {
      u64 hi, lo;
      clmul64(a.w[i], b.w[j], hi, lo);
      out[i + j] ^= lo;
      out[i + j + 1] ^= hi;
    }
  }
}

// reduce 8 words mod x^233 + x^74 + 1
inline FE fe_reduce_wide(u64 v[8]) {
  // fold words 7..3 (bits >= 233): bit 233 is bit 41 of word 3
  for (int i = 7; i >= 4; i--) {
    u64 t = v[i];
    v[i] = 0;
    // x^(64i) = x^(64i-233) * (x^74 + 1)
    int base = 64 * i - 233;  // 23, 87, 151, 215
    int b0 = base, b1 = base + 74;
    v[b0 / 64] ^= t << (b0 % 64);
    if (b0 % 64) v[b0 / 64 + 1] ^= t >> (64 - b0 % 64);
    v[b1 / 64] ^= t << (b1 % 64);
    if (b1 % 64) v[b1 / 64 + 1] ^= t >> (64 - b1 % 64);
  }
  // remaining high bits of word 3 (bits 41..63 = x^233..x^255)
  u64 t = v[3] >> 41;
  v[3] &= (1ULL << 41) - 1;
  v[0] ^= t;          // * 1
  v[1] ^= t << 10;    // * x^74: bit 74 = word1 bit 10
  FE r{{v[0], v[1], v[2], v[3]}};
  // one more fold can be needed if the x^74 fold crossed 233 again: the
  // first loop writes at most bit 215+74+63 < 353 -> handled by t-fold;
  // t-fold writes at most bit 74+22 = 96 < 233.  Check invariant:
  return r;
}

inline FE fe_mul(const FE &a, const FE &b) {
  u64 wide[8];
  fe_clmul_wide(a, b, wide);
  return fe_reduce_wide(wide);
}

// squaring is linear over GF(2): spread each bit to an even position
// (interleave zeros) and reduce -- ~20x cheaper than a generic clmul,
// which matters because fe_inv and fe_halftrace are squaring towers.
inline u64 spread32(u64 x) {
  x &= 0xFFFFFFFFULL;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFULL;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFULL;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0FULL;
  x = (x | (x << 2)) & 0x3333333333333333ULL;
  x = (x | (x << 1)) & 0x5555555555555555ULL;
  return x;
}

inline FE fe_sqr(const FE &a) {
  u64 wide[8];
  for (int i = 0; i < 4; i++) {
    wide[2 * i] = spread32(a.w[i]);
    wide[2 * i + 1] = spread32(a.w[i] >> 32);
  }
  return fe_reduce_wide(wide);
}

inline FE fe_one() {
  FE r = fe_zero();
  r.w[0] = 1;
  return r;
}

inline FE fe_sqr_k(FE a, int k) {
  for (int i = 0; i < k; i++) a = fe_sqr(a);
  return a;
}

// Itoh-Tsujii inversion: a^(2^233 - 2)
inline FE fe_inv(const FE &a) {
  if (fe_is_zero(a)) return a;
  FE x1 = a;
  FE x2 = fe_mul(fe_sqr_k(x1, 1), x1);
  FE x3 = fe_mul(fe_sqr_k(x2, 1), x1);
  FE x6 = fe_mul(fe_sqr_k(x3, 3), x3);
  FE x7 = fe_mul(fe_sqr_k(x6, 1), x1);
  FE x14 = fe_mul(fe_sqr_k(x7, 7), x7);
  FE x28 = fe_mul(fe_sqr_k(x14, 14), x14);
  FE x29 = fe_mul(fe_sqr_k(x28, 1), x1);
  FE x58 = fe_mul(fe_sqr_k(x29, 29), x29);
  FE x116 = fe_mul(fe_sqr_k(x58, 58), x58);
  FE x232 = fe_mul(fe_sqr_k(x116, 116), x116);
  return fe_sqr(x232);
}

// Tr(a) = parity of bits {0, 159} for this trinomial (derived + verified
// in dvpari_tpu/utils/gf2_host.py)
inline int fe_trace(const FE &a) {
  return (int)((a.w[0] ^ (a.w[2] >> 31)) & 1);
}

inline FE fe_halftrace(const FE &a) {
  FE t = a, acc = a;
  for (int i = 0; i < 116; i++) {
    t = fe_sqr(fe_sqr(t));
    acc = fe_add(acc, t);
  }
  return acc;
}

// ------------- curve (projective X:Y:Z, x=X/Z, y=Y/Z) ---------------------

struct PT {
  FE X, Y, Z;
};

inline PT pt_inf() {
  PT p;
  p.X = fe_zero();
  p.Y = fe_zero();
  p.Y.w[0] = 1;
  p.Z = fe_zero();
  return p;
}

inline bool pt_is_inf(const PT &p) { return fe_is_zero(p.Z); }


PT pt_double(const PT &p) {
  if (pt_is_inf(p)) return p;
  FE S = fe_mul(p.X, p.Z);
  if (fe_is_zero(S)) return pt_inf();  // X=0 (order-2) or Z=0
  FE X2 = fe_sqr(p.X);
  FE T = fe_add(X2, fe_mul(p.Y, p.Z));
  FE TpS = fe_add(T, S);
  FE TT = fe_mul(T, TpS);
  FE X3 = fe_mul(TT, S);
  FE Y3 = fe_add(fe_mul(fe_mul(fe_sqr(X2), p.X), p.Z), fe_mul(TT, TpS));
  FE Z3 = fe_mul(fe_sqr(S), S);
  return PT{X3, Y3, Z3};
}

PT pt_add(const PT &p, const PT &q) {
  if (pt_is_inf(p)) return q;
  if (pt_is_inf(q)) return p;
  FE W = fe_mul(p.Z, q.Z);
  FE U = fe_add(fe_mul(p.Y, q.Z), fe_mul(q.Y, p.Z));
  FE V = fe_add(fe_mul(p.X, q.Z), fe_mul(q.X, p.Z));
  if (fe_is_zero(V)) {
    if (fe_is_zero(U)) return pt_double(p);
    return pt_inf();
  }
  FE V2 = fe_sqr(V);
  FE V3 = fe_mul(V2, V);
  FE N = fe_add(fe_add(fe_mul(fe_sqr(U), W), fe_mul(fe_mul(U, W), V)), V3);
  FE X3 = fe_mul(N, V);
  FE Z3 = fe_mul(V3, W);
  FE V2Z2 = fe_mul(V2, q.Z);
  FE Y3 = fe_add(
      fe_add(fe_mul(U, fe_add(fe_mul(p.X, V2Z2), N)), fe_mul(V, N)),
      fe_mul(p.Y, fe_mul(V3, q.Z)));
  return PT{X3, Y3, Z3};
}

void pt_to_affine(const PT &p, FE &x, FE &y, int &inf) {
  if (pt_is_inf(p)) {
    inf = 1;
    x = fe_zero();
    y = fe_zero();
    return;
  }
  inf = 0;
  FE zi = fe_inv(p.Z);
  x = fe_mul(p.X, zi);
  y = fe_mul(p.Y, zi);
}

}  // namespace

// ----------------------- C ABI exports ------------------------------------
// Field elements cross the boundary as 4 little-endian u64 words, affine
// points as 8 words (x, y) and a separate infinity flag.

extern "C" {

// [k]P for a 240-bit little-endian scalar and an affine input point;
// affine output.  One call covers the verifier's two scalar muls
// (reference: src/srs.rs:374-428 verifies via two xsk233 scalar muls) --
// the pure-python double-and-add oracle costs seconds per mul, this is
// sub-millisecond.
void dv_pt_smul(const uint8_t *k30, const u64 *xy_in, uint8_t inf_in,
                u64 *xy_out, uint8_t *inf_out) {
  PT acc = pt_inf();
  if (!inf_in) {
    PT P;
    memcpy(P.X.w, xy_in, 32);
    memcpy(P.Y.w, xy_in + 4, 32);
    P.Z = fe_one();
    int top = 239;
    while (top >= 0 && !((k30[top >> 3] >> (top & 7)) & 1)) top--;
    for (int i = top; i >= 0; i--) {
      acc = pt_double(acc);
      if ((k30[i >> 3] >> (i & 7)) & 1) acc = pt_add(acc, P);
    }
  }
  FE x, y;
  int inf;
  pt_to_affine(acc, x, y, inf);
  *inf_out = (uint8_t)inf;
  memcpy(xy_out, x.w, 32);
  memcpy(xy_out + 4, y.w, 32);
}

// decode 30 bytes -> affine (x, y) + flags; returns 1 if valid.
int dv_pt_decode(const uint8_t *in30, u64 *xy_out, uint8_t *inf_out) {
  u64 acc[4] = {0, 0, 0, 0};
  uint8_t buf[32];
  memset(buf, 0, 32);
  memcpy(buf, in30, 30);
  memcpy(acc, buf, 32);
  int all_zero = 1;
  for (int i = 0; i < 4; i++)
    if (acc[i]) all_zero = 0;
  if (all_zero) {
    *inf_out = 1;
    memset(xy_out, 0, 64);
    return 1;
  }
  // bits 234..239 must be zero
  if (acc[3] >> 42) return 0;
  int lam_bit = (int)((acc[3] >> 41) & 1);
  FE x;
  memcpy(x.w, acc, 32);
  x.w[3] &= (1ULL << 41) - 1;
  if (fe_is_zero(x)) return 0;
  // z^2 + z = x + x^-2 ; solvable iff trace is 0
  FE c = fe_add(x, fe_inv(fe_sqr(x)));
  if (fe_trace(c) != 0) return 0;
  FE z = fe_halftrace(c);
  if ((int)(z.w[0] & 1) != lam_bit) z.w[0] ^= 1;  // pick the right root
  FE y = fe_mul(z, x);
  // subgroup membership: Tr(x)=0 and Tr(y + (lam+1)x) = 0
  if (fe_trace(x) != 0) return 0;
  FE lam = fe_halftrace(x);
  FE lam1 = lam;
  lam1.w[0] ^= 1;
  FE chk = fe_add(y, fe_mul(lam1, x));
  if (fe_trace(chk) != 0) return 0;
  *inf_out = 0;
  memcpy(xy_out, x.w, 32);
  memcpy(xy_out + 4, y.w, 32);
  return 1;
}

// bulk decode: returns number of invalid records (0 = all good)
int64_t dv_pt_decode_bulk(const uint8_t *in, int64_t n, u64 *xy_out,
                          uint8_t *inf_out) {
  int64_t bad = 0;
#pragma omp parallel for reduction(+ : bad) schedule(dynamic, 256)
  for (int64_t i = 0; i < n; i++) {
    if (!dv_pt_decode(in + 30 * i, xy_out + 8 * i, inf_out + i)) bad++;
  }
  return bad;
}

// ---- gnark R1CS dump row parsing (reference: src/gnark_r1cs.rs:3-20,
// rayon row loop :144-179).  Two-phase: meta() walks headers to size the
// outputs, parse() deinterleaves the (wire, coeff) term pairs into three
// per-matrix arrays.  Layout after the coeff table (all little-endian):
//   u32 nbRows; per row: u32 nL | u32 nR | u32 nO; (nL+nR+nO) x
//   (u32 wire_id, u32 coeff_id)

static inline uint32_t rd_u32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

// rows_off: byte offset of the u32 nbRows field.  Returns 0 on success.
int dv_r1cs_meta(const uint8_t *data, int64_t len, int64_t rows_off,
                 int64_t *n_rows_out, int64_t *terms_out /* [3]: L, R, O */) {
  if (rows_off + 4 > len) return 1;
  int64_t n_rows = rd_u32(data + rows_off);
  int64_t off = rows_off + 4;
  int64_t tl = 0, tr = 0, to = 0;
  for (int64_t i = 0; i < n_rows; i++) {
    if (off + 12 > len) return 1;
    uint32_t nl = rd_u32(data + off), nr = rd_u32(data + off + 4),
             no = rd_u32(data + off + 8);
    off += 12 + 8 * (int64_t)(nl + (int64_t)nr + no);
    if (off > len) return 1;
    tl += nl;
    tr += nr;
    to += no;
  }
  *n_rows_out = n_rows;
  terms_out[0] = tl;
  terms_out[1] = tr;
  terms_out[2] = to;
  return 0;
}

// counts: u32[3 * n_rows] (nl, nr, no per row); lw/lc etc. sized by meta().
int dv_r1cs_parse(const uint8_t *data, int64_t len, int64_t rows_off,
                  uint32_t *counts, uint32_t *lw, uint32_t *lc, uint32_t *rw,
                  uint32_t *rc, uint32_t *ow, uint32_t *oc) {
  (void)len;
  int64_t n_rows = rd_u32(data + rows_off);
  int64_t off = rows_off + 4;
  uint32_t *wd[3] = {lw, rw, ow};
  uint32_t *cd[3] = {lc, rc, oc};
  for (int64_t i = 0; i < n_rows; i++) {
    uint32_t n3[3] = {rd_u32(data + off), rd_u32(data + off + 4),
                      rd_u32(data + off + 8)};
    off += 12;
    for (int k = 0; k < 3; k++) {
      counts[3 * i + k] = n3[k];
      uint32_t *w = wd[k], *c = cd[k];
      for (uint32_t t = 0; t < n3[k]; t++) {
        *w++ = rd_u32(data + off);
        *c++ = rd_u32(data + off + 4);
        off += 8;
      }
      wd[k] = w;
      cd[k] = c;
    }
  }
  return 0;
}

}  // extern "C"
