// Vanishing-polynomial coefficients over GF(p): Kronecker-substitution
// product tree on GMP, OpenMP-parallel across tree nodes and slots.
//
// A copy of dvpari_tpu/native/zpoly_native.cpp for the PyTorch port.
// Native twin of utils/kronecker.py (same packing: 64-byte little-endian
// coefficient slots, reduce mod p after every level).  The reference
// treats z_poly as a multi-hour precompute at SP1 scale (reference:
// src/artifacts.rs:85-123, src/ec_fft.rs:241-282); this version runs the
// per-level multiplies and reductions across all cores, with no python
// loop per slot.
//
// The GMP runtime (libgmp.so.10) may come without gmp.h; the mpz ABI
// below has been stable for decades (the same assumption
// utils/kronecker.py makes via ctypes).  The loader
// (dvpari_tpu_torch/native.py) links the libgmp that kronecker.py loads
// and raises when it cannot: there is no stub.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
typedef struct {
  int _mp_alloc;
  int _mp_size;
  void *_mp_d;
} dv_mpz;
void __gmpz_init2(dv_mpz *, unsigned long long);
void __gmpz_clear(dv_mpz *);
void __gmpz_import(dv_mpz *, size_t, int, size_t, int, size_t, const void *);
void *__gmpz_export(void *, size_t *, int, size_t, int, size_t,
                    const dv_mpz *);
void __gmpz_mul(dv_mpz *, const dv_mpz *, const dv_mpz *);
void __gmpz_tdiv_r(dv_mpz *, const dv_mpz *, const dv_mpz *);
void __gmpz_sub(dv_mpz *, const dv_mpz *, const dv_mpz *);
}

namespace {

// 64-byte slots: a level multiply of reduced (<p ~ 2^232) inputs stays
// below (n/2 + 1) * p^2 ~ 2^(464 + log2 n) < 2^512 for any n < 2^48.
constexpr size_t kSlot = 64;
constexpr size_t kCoeffOut = 32;  // caller-facing coefficient record

struct Node {
  std::vector<uint8_t> buf;  // (m + 1) slots, reduced coefficients
  int64_t m = 0;             // leaf count (degree)
};

// Reduce every coefficient slot of `buf` (nslots slots) mod p in place.
void reduce_slots(uint8_t *buf, size_t nslots, const dv_mpz *p, dv_mpz *t) {
  for (size_t k = 0; k < nslots; k++) {
    uint8_t *slot = buf + k * kSlot;
    __gmpz_import(t, kSlot, -1, 1, 0, 0, slot);
    __gmpz_tdiv_r(t, t, p);
    std::memset(slot, 0, kSlot);
    size_t count = 0;
    __gmpz_export(slot, &count, -1, 1, 0, 0, t);  // writes nothing if t==0
  }
}

}  // namespace

extern "C" {

// domain: n little-endian 32-byte reduced field elements d_i < p.
// p_le32: the modulus, little-endian 32 bytes.
// out:    (n + 1) little-endian 32-byte coefficients of prod (x - d_i),
//         low-to-high, monic.  Returns 0 on success.
int64_t dv_zpoly_coeffs(const uint8_t *domain, int64_t n,
                        const uint8_t *p_le32, uint8_t *out) {
  if (n < 1) return -2;
  dv_mpz p;
  __gmpz_init2(&p, 256 + 64);
  __gmpz_import(&p, kCoeffOut, -1, 1, 0, 0, p_le32);

  // Leaves: (x - d) = [p - d, 1] per slot pair ((p-0) % p == 0).
  std::vector<Node> nodes(static_cast<size_t>(n));
#pragma omp parallel
  {
    dv_mpz d, t;
    __gmpz_init2(&d, 256 + 64);
    __gmpz_init2(&t, 256 + 64);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; i++) {
      Node &nd = nodes[static_cast<size_t>(i)];
      nd.m = 1;
      nd.buf.assign(2 * kSlot, 0);
      __gmpz_import(&d, kCoeffOut, -1, 1, 0, 0, domain + i * kCoeffOut);
      if (d._mp_size != 0) {  // d == 0 -> coefficient 0
        __gmpz_sub(&t, &p, &d);
        size_t count = 0;
        __gmpz_export(nd.buf.data(), &count, -1, 1, 0, 0, &t);
      }
      nd.buf[kSlot] = 1;  // monic x term
    }
    __gmpz_clear(&d);
    __gmpz_clear(&t);
  }

  // Product tree, level-synchronous; an odd trailing node carries up.
  while (nodes.size() > 1) {
    size_t pairs = nodes.size() / 2;
    std::vector<Node> nxt(pairs + (nodes.size() & 1));
#pragma omp parallel
    {
      dv_mpz a, b, c, t;
      __gmpz_init2(&a, 1024);
      __gmpz_init2(&b, 1024);
      __gmpz_init2(&c, 2048);
      __gmpz_init2(&t, 8 * kSlot + 64);
#pragma omp for schedule(dynamic, 1)
      for (size_t i = 0; i < pairs; i++) {
        Node &na = nodes[2 * i];
        Node &nb = nodes[2 * i + 1];
        __gmpz_import(&a, na.buf.size(), -1, 1, 0, 0, na.buf.data());
        __gmpz_import(&b, nb.buf.size(), -1, 1, 0, 0, nb.buf.data());
        __gmpz_mul(&c, &a, &b);
        Node &nc = nxt[i];
        nc.m = na.m + nb.m;
        // (m + 1) coefficient slots + 1 headroom slot for the export
        nc.buf.assign(static_cast<size_t>(nc.m + 2) * kSlot, 0);
        size_t count = 0;
        __gmpz_export(nc.buf.data(), &count, -1, 1, 0, 0, &c);
        reduce_slots(nc.buf.data(), static_cast<size_t>(nc.m + 1), &p, &t);
        nc.buf.resize(static_cast<size_t>(nc.m + 1) * kSlot);
        na.buf.clear();
        na.buf.shrink_to_fit();
        nb.buf.clear();
        nb.buf.shrink_to_fit();
      }
      __gmpz_clear(&a);
      __gmpz_clear(&b);
      __gmpz_clear(&c);
      __gmpz_clear(&t);
    }
    if (nodes.size() & 1) nxt.back() = std::move(nodes.back());
    nodes = std::move(nxt);
  }

  const Node &root = nodes[0];
  for (int64_t k = 0; k <= n; k++) {
    std::memcpy(out + k * kCoeffOut, root.buf.data() + k * kSlot, kCoeffOut);
  }
  __gmpz_clear(&p);
  return 0;
}

}  // extern "C"
