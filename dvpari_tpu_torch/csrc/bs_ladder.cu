// Bit-sliced tau-NAF ladder and complete point add over sect233k1 for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the TPU kernel dvpari_tpu/ops/pallas_msm.py:_ladder_kernel
// (entered through msm_packed and mulgen_packed): per 32-point column,
// 62 windows MSB first of acc = tau^4(acc); t = XOR_e table[e] & oh[w][e];
// Y(t) ^= X(t) & ng[w]; acc = complete_add(acc, t), over GF(2^233) mod
// x^233 + x^74 + 1 on y^2 + xy = x^3 + 1.  point_add_kernel is the same
// complete add on its own; the wrapper routes the window-table build and
// the MSM folds (XLA code in the JAX package) through it.
//
// Layouts (32-bit words; bit j of a word is point 32*col + j):
//   oh    [62][11][cols]        one-hot digit masks
//   ng    [62][cols]            negate masks
//   table [11][3][233][tcols]   tcols == cols (MSM) or 1 (one shared table)
//   out   [3][233][cols]
//
// What bounds it: bitwise integer operations.  A field multiply is a
// 233 x 233 AND/XOR schoolbook.  A window does 17 multiplies and 14
// squarings (12 of them tau^4), plus 7 multiplies and 3 squarings in a
// column where some lane doubles; with the operands in shared memory the
// integer and shared-memory pipes bound it, not device memory (a column
// moves ~60 KB in, 2.8 KB out).
//
// Design: one block of 256 threads per column.  The column's window
// table (30 KB) is staged in shared memory once; the accumulator, the
// picked entry and every add/double temporary live in shared memory
// (15 field elements in 256-word slots, zero past word 233, and four
// 465-word products).  The field operations of the add fall into levels
// of independent ones, and each level costs one barrier pair: mul_pass
// computes up to four products at once, spreading their 4 x 233 row
// pairs (rows t and 233 + t of a product, exactly 233 AND/XOR terms)
// over all 256 threads, then out_pass reduces them, squares, and XORs
// the level's results into their slots.  A squaring is a linear map:
// each result word is the XOR of at most three operand words, read
// directly.  The rows' b-operand reads are one conflict-free load per
// term, except in a warp whose rows cross into the next product; the
// a-operand index is the same in every lane of a warp (except where a
// lane switches from row t to row 233 + t), so a comes in one broadcast
// 16-byte load per 4 terms.  Measured on an H100 the products take ~86 %
// of a window, the barriers and reductions little.  The multiply is one
// out-of-line function with rolled loops, which keeps the code small:
// inlined and fully unrolled at every call site it tripled the kernel's
// instructions and ran 1.7x slower on an H100.  Four blocks fit on an SM.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int M = 233;
constexpr int K = 74;            // x^233 = x^74 + 1
constexpr int N_WINDOWS = 62;
constexpr int TABLE_SIZE = 11;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SLOT = 256;  // words per field element; [233, 256) stay zero
constexpr int LEAD = 4;    // zero words before slot 0 (a multiply may read b[-2..-1])
constexpr int A_END = 236;  // a multiply reads a[0, 236): a is zero from 233
constexpr unsigned FULL = 0xffffffffu;

// Field-element slots in shared memory: P = (X1, Y1, Z1) is the
// accumulator and the add's result, Q = (X2, Y2, Z2) the other operand,
// S* and D* temporaries.
enum Slot {
  X1, Y1, Z1, X2, Y2, Z2,
  S0, S1, S2, S3, S4, S5, S6,
  D0, D1,
  NSLOT
};

constexpr int NPROD = 4;                        // products per mul_pass
constexpr int WIDE_WORDS = 468;                 // 2 * M - 1 rounded up to 16 bytes
constexpr int F0 = LEAD;                        // slot 0
constexpr int WIDE_OFF = F0 + NSLOT * SLOT;     // NPROD 465-word products
constexpr int RED_OFF = WIDE_OFF + NPROD * WIDE_WORDS;  // 4 x NWARPS zero-test words
constexpr int WORK_WORDS = RED_OFF + 4 * NWARPS;

// Phase clocks (built with -DBS_PHASE_CLOCKS only): thread 0 of every
// block adds the clock64() cycles between block barriers to the phase it
// is in, and counts the doublings that ran and those that a lane needed.
// "frob" is tau^4 and the table pick (they share their last barrier),
// "mul" mul_pass, "reduce" out_pass (reductions, squarings, XORs).
enum Phase { PH_FROB, PH_MUL, PH_REDUCE, PH_DOUBLE, PH_SELECT, N_PHASES };
#ifdef BS_PHASE_CLOCKS
constexpr int PROF_WORDS = 2 * (N_PHASES + 2);  // sums, last stamp, phase override
#else
constexpr int PROF_WORDS = 0;
#endif
constexpr int PROF_OFF = WORK_WORDS;  // 8-byte aligned: WORK_WORDS is even

constexpr int TABLE_WORDS = TABLE_SIZE * 3 * M;
constexpr int TAB_OFF = PROF_OFF + PROF_WORDS;    // ladder: the window table
constexpr int WMASK_OFF = TAB_OFF + TABLE_WORDS;  // ladder: 11 digit masks + negate
constexpr size_t ADD_SMEM = sizeof(uint32_t) * (WORK_WORDS + PROF_WORDS);
constexpr size_t LADDER_SMEM = sizeof(uint32_t) * (WMASK_OFF + 16);

// mul_pass operands: product k is slot a_k * slot b_k, 10 bits each.
__host__ __device__ constexpr uint64_t ops(int a0, int b0, int a1 = 0, int b1 = 0,
                                           int a2 = 0, int b2 = 0, int a3 = 0, int b3 = 0) {
  return (uint64_t)(a0 | b0 << 5) | (uint64_t)(a1 | b1 << 5) << 10 |
         (uint64_t)(a2 | b2 << 5) << 20 | (uint64_t)(a3 | b3 << 5) << 30;
}

// out_pass results: slot dst = XOR of the reduced products in `wide`
// (bit k: product k), the square of slot `sq` and slot `xr`.
constexpr int NO = 31;
constexpr uint32_t W0 = 1, W1 = 2, W2 = 4, W3 = 8;
__host__ __device__ constexpr uint32_t res(int dst, uint32_t wide, int sq = NO, int xr = NO) {
  return (uint32_t)dst | wide << 5 | (uint32_t)sq << 9 | (uint32_t)xr << 14;
}

}  // namespace

// The block's dynamic shared memory, laid out by the offsets above.  It
// is reached by name, never through pointer arguments, so every access
// compiles to a shared-memory load or store.
extern __shared__ __align__(16) uint32_t smem[];

namespace {

__device__ __forceinline__ uint32_t* el(int slot) { return smem + F0 + slot * SLOT; }

#ifdef BS_PHASE_CLOCKS
__device__ unsigned long long g_phase_cycles[N_PHASES];
__device__ unsigned long long g_phase_windows;   // column-windows timed
__device__ unsigned long long g_doubles_run;     // point_double() calls
__device__ unsigned long long g_doubles_needed;  // adds with a P = Q lane

__device__ __forceinline__ unsigned long long* prof() {
  return reinterpret_cast<unsigned long long*>(smem + PROF_OFF);
}
// Start the clocks (after the block's first barrier).
__device__ __forceinline__ void prof_start() {
  if (threadIdx.x == 0) {
    for (int k = 0; k < N_PHASES; ++k) prof()[k] = 0ull;
    prof()[N_PHASES] = clock64();
    prof()[N_PHASES + 1] = N_PHASES;  // no override
  }
}
// Charge the cycles since the last mark to phase ph (or to the override).
__device__ __forceinline__ void mark(int ph) {
  if (threadIdx.x == 0) {
    unsigned long long* pr = prof();
    const unsigned long long now = clock64();
    if (pr[N_PHASES + 1] != N_PHASES) ph = (int)pr[N_PHASES + 1];
    pr[ph] += now - pr[N_PHASES];
    pr[N_PHASES] = now;
  }
}
// Charge every mark until the next phase_override(N_PHASES) to ph.
__device__ __forceinline__ void phase_override(int ph) {
  if (threadIdx.x == 0) prof()[N_PHASES + 1] = ph;
}
__device__ __forceinline__ void count_double(bool needed, bool ran) {
  if (threadIdx.x == 0) {
    if (needed) atomicAdd(&g_doubles_needed, 1ull);
    if (ran) atomicAdd(&g_doubles_run, 1ull);
  }
}
#else
__device__ __forceinline__ void prof_start() {}
__device__ __forceinline__ void mark(int) {}
__device__ __forceinline__ void phase_override(int) {}
__device__ __forceinline__ void count_double(bool, bool) {}
#endif

// Zero the work area: slot padding and LEAD must read as zero.
__device__ __forceinline__ void clear_work() {
  for (int k = threadIdx.x; k < WORK_WORDS; k += THREADS) smem[k] = 0u;
}

// Word j of product k mod (x^233 + x^74 + 1).  h[r] = wide[233 + r]
// folds to r and r + 74; its rows 159.. land at 233.. and fold once more.
__device__ __forceinline__ uint32_t reduced(int k, int j) {
  const uint32_t* w = smem + WIDE_OFF + k * WIDE_WORDS;
  const uint32_t* h = w + M;
  uint32_t v = w[j];
  if (j < M - 1) v ^= h[j];
  if (j >= K) v ^= h[j - K];
  if (j < K - 1) v ^= h[M - K + j];
  if (j >= K && j < 2 * K - 1) v ^= h[M - 2 * K + j];
  return v;
}

// Word j of (slot s)^2: the same fold applied to the interleave
// wide[2i] = a[i], wide[2i + 1] = 0, reading a directly.
__device__ __forceinline__ uint32_t squared(int s, int j) {
  const uint32_t* a = el(s);
  if (j & 1) {
    uint32_t v = a[(M + j) >> 1];                 // h[j]
    if (j >= K) v ^= a[(M - K + j) >> 1];         // h[j - 74]
    return v;
  }
  uint32_t v = a[j >> 1];
  if (j < K - 1) v ^= a[(2 * M - K + j) >> 1];  // h[159 + j]
  if (j >= K && j < 2 * K - 1) v ^= a[(2 * M - 2 * K + j) >> 1];  // h[85 + j]
  return v;
}

// Terms i .. i + 3 of row pair t, where some lanes of the warp switch
// from row t (i <= t) to row 233 + t.
__device__ __forceinline__ void span4(const uint32_t* pa, const uint32_t* blo,
                                      const uint32_t* bhi, int i, int t,
                                      uint32_t& lo, uint32_t& hi) {
  const uint4 v = *reinterpret_cast<const uint4*>(pa + i);
  const uint32_t av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ii = i + q;
    if (ii <= t) lo ^= av[q] & blo[-ii];
    else hi ^= av[q] & bhi[-ii];
  }
}

// Products k < n (n <= NPROD) into the wide buffers: product k = slot
// a_k * slot b_k (see ops()).  Row t = XOR_{i<=t} a[i] b[t-i], row
// 233+t = XOR_{i>t} a[i] b[t+233-i].  The n * 233 row pairs u = 233 k + t
// go to the threads in warp-sized runs; a run may cross from product k
// (rows t0..232) into k + 1 (rows 0..t31).  Per run, i falls into
// [0, e1) and [e2, e3), where lanes differ in which row a term feeds,
// [e1, e2), where each lane feeds one row (its b pointer picks which),
// and [e3, 236), row 233 + t everywhere.  Slots may be operands of
// several products; the results land in the wide buffers only.
__device__ __noinline__ void mul_pass(int n, uint64_t prods) {
  const int lane = threadIdx.x & 31;
  const int total = n * M;
  for (int base = threadIdx.x & ~31; base < total; base += THREADS) {
    const int u = min(base + lane, total - 1);  // lanes past the end redo one, unstored
    const int k = u / M, t = u - k * M;
    const uint32_t ab = (uint32_t)(prods >> (10 * k));
    const uint32_t* pa = el(ab & 31);
    const uint32_t* blo = el((ab >> 5) & 31) + t;  // blo[-i] = b[t - i]
    const uint32_t* bhi = blo + M;                 // bhi[-i] = b[t + 233 - i]
    const int t0 = __shfl_sync(FULL, t, 0), t31 = __shfl_sync(FULL, t, 31);
    const bool cross = t31 < t0;
    const int e1 = cross ? (t31 & ~3) + 4 : 0;
    const int e2 = t0 & ~3;
    const int e3 = cross ? A_END : min(e2 + 36, A_END);
    const bool low = t >= e2;  // in [e1, e2): row t (else row 233 + t)
    const uint32_t* bmid = low ? blo : bhi;
    uint32_t lo = 0u, hi = 0u, mid = 0u;
    int i = 0;
#pragma unroll 1
    for (; i < e1; i += 4) span4(pa, blo, bhi, i, t, lo, hi);
#pragma unroll 1
    for (; i < e2; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(pa + i);
      mid ^= (v.x & bmid[-i]) ^ (v.y & bmid[-i - 1]) ^ (v.z & bmid[-i - 2]) ^ (v.w & bmid[-i - 3]);
    }
#pragma unroll 1
    for (; i < e3; i += 4) span4(pa, blo, bhi, i, t, lo, hi);
#pragma unroll 1
    for (; i < A_END; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(pa + i);
      hi ^= (v.x & bhi[-i]) ^ (v.y & bhi[-i - 1]) ^ (v.z & bhi[-i - 2]) ^ (v.w & bhi[-i - 3]);
    }
    if (low) lo ^= mid;
    else hi ^= mid;
    if (base + lane < total) {
      uint32_t* w = smem + WIDE_OFF + k * WIDE_WORDS;
      w[t] = lo;
      if (t < M - 1) w[M + t] = hi;
    }
  }
  __syncthreads();
  mark(PH_MUL);
}

// n (<= 4) results of a level, written after mul_pass (see res()).  No
// result's slot may be read by another result of the same pass (a result
// may XOR its own slot).
__device__ __noinline__ void out_pass(int n, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  for (int idx = threadIdx.x; idx < n * M; idx += THREADS) {
    const int o = idx / M, j = idx - o * M;
    const uint32_t r = o == 0 ? r0 : o == 1 ? r1 : o == 2 ? r2 : r3;
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < NPROD; ++k)
      if ((r >> (5 + k)) & 1u) v ^= reduced(k, j);
    const int sq = (r >> 9) & 31, xr = (r >> 14) & 31;
    if (sq != NO) v ^= squared(sq, j);
    if (xr != NO) v ^= el(xr)[j];
    el(r & 31)[j] = v;
  }
  __syncthreads();
  mark(PH_REDUCE);
}

// Warp partial ORs of four slots, for zero_masks after the next barrier.
__device__ __forceinline__ void zero_partials(int e0, int e1, int e2, int e3) {
  const int t = threadIdx.x;
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (t < M) {
    v[0] = el(e0)[t];
    v[1] = el(e1)[t];
    v[2] = el(e2)[t];
    v[3] = el(e3)[t];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = __reduce_or_sync(FULL, v[q]);
  if ((t & 31) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) smem[RED_OFF + q * NWARPS + (t >> 5)] = v[q];
  }
}

// Zero masks (bit set iff that element is 0) of zero_partials' slots,
// the same in every thread.
__device__ __forceinline__ void zero_masks(uint32_t out[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t r = 0;
    for (int w = 0; w < NWARPS; ++w) r |= smem[RED_OFF + q * NWARPS + w];
    out[q] = ~r;
  }
}

// Tangent doubling of P into (D1, S5, D0), in three levels:
// S = XZ, T = X^2 + YZ, X3 = T(T+S)S, Y3 = X^4 S + T(T+S)^2, Z3 = S^3.
__device__ __forceinline__ void point_double() {
  mul_pass(2, ops(X1, Z1, Y1, Z1));               // S, YZ
  out_pass(4, res(S3, W0), res(S4, W1, X1),       // S, T
           res(S5, 0, X1), res(S6, W0 | W1, X1));  // X^2, T + S
  mul_pass(1, ops(S4, S6));                       // TT = T(T+S)
  out_pass(3, res(S4, W0), res(D0, 0, S3), res(D1, 0, S5), 0);  // TT, S^2, X^4
  mul_pass(4, ops(D0, S3, S4, S3, D1, S3, S4, S6));  // S^3, TT S, X^4 S, TT(T+S)
  out_pass(3, res(D0, W0), res(D1, W1), res(S5, W2 | W3), 0);  // Z3, X3, Y3
}

// P = P + Q, masked-complete (same cases as xsk233_bs.add), in six levels:
// W = Z1 Z2, U = Y1 Z2 + Y2 Z1, V = X1 Z2 + X2 Z1, N = U^2 W + U V W + V^3,
// X3 = N V, Z3 = V^3 W, Y3 = U (X1 V^2 Z2 + N) + V N + Y1 V^3 Z2.
__device__ __forceinline__ void point_add() {
  mul_pass(4, ops(Z1, Z2, Y1, Z2, Y2, Z1, X1, Z2));
  out_pass(3, res(S0, W0), res(S1, W1 | W2), res(S2, W3), 0);  // W, U, X1 Z2
  mul_pass(2, ops(X2, Z1, S1, S0));                            // X2 Z1, UW
  out_pass(3, res(S3, W0, NO, S2), res(S5, W1), res(S4, 0, S1), 0);  // V, UW, U^2
  zero_partials(Z1, Z2, S3, S1);  // inf_p, inf_q, v_zero, u_zero
  mul_pass(2, ops(S4, S0, S5, S3));                            // U^2 W, UWV
  out_pass(2, res(S6, W0 | W1), res(S2, 0, S3), 0, 0);         // U^2 W + UWV, V^2
  mul_pass(2, ops(S2, S3, S2, Z2));                            // V^3, V^2 Z2
  out_pass(3, res(S4, W0), res(S6, W0, NO, S6), res(S5, W1), 0);  // V^3, N, V^2 Z2
  mul_pass(4, ops(S4, S0, S4, Z2, S6, S3, X1, S5));  // Z3, V^3 Z2, X3 = N V, X1 V^2 Z2
  out_pass(4, res(S0, W0), res(S4, W1), res(S2, W2), res(S5, W3, NO, S6));  // .., X1 V^2 Z2 + N
  mul_pass(3, ops(Y1, S4, S1, S5, S3, S6));          // Y1 V^3 Z2, U (X1 V^2 Z2 + N), V N
  out_pass(1, res(S1, W0 | W1 | W2), 0, 0, 0);       // Y3

  uint32_t zm[4];
  zero_masks(zm);
  const uint32_t inf_p = zm[0], inf_q = zm[1], v_zero = zm[2], u_zero = zm[3];
  // The doubling survives the selects below only in lanes where P = Q
  // and neither is infinity, so it runs only when some lane of the
  // column is such a lane.  The masks are the same in every thread, so
  // the branch is block-uniform.  Where it is skipped, its result slots
  // hold stale values, and m_dbl picks them only in lanes that the
  // inf_q / inf_p selects then overwrite.  Honest scalars reach P = Q in
  // a lane only if tau^4 * prefix == digit (mod n), with probability
  // about 2^-228 per window, so the branch tells nothing about secret
  // scalars.
  const bool need_double = (v_zero & u_zero & ~inf_p & ~inf_q) != 0u;
  count_double(need_double, need_double);
  if (need_double) {
    phase_override(PH_DOUBLE);
    point_double();  // (D1, S5, D0)
    phase_override(N_PHASES);
  }

  const uint32_t m_inf = v_zero & ~u_zero;  // P = -Q
  const uint32_t m_dbl = v_zero & u_zero;   // P = Q
  const int gen[3] = {S2, S1, S0};
  const int dbl[3] = {D1, S5, D0};
  for (int idx = threadIdx.x; idx < 3 * M; idx += THREADS) {
    const int c = idx / M, j = idx % M;
    const uint32_t inf = (idx == M) ? 0xffffffffu : 0u;  // (0 : 1 : 0)
    uint32_t r = (inf & m_inf) | (el(gen[c])[j] & ~m_inf);
    r = (el(dbl[c])[j] & m_dbl) | (r & ~m_dbl);
    r = (el(X1 + c)[j] & inf_q) | (r & ~inf_q);  // Q = inf -> P
    r = (el(X2 + c)[j] & inf_p) | (r & ~inf_p);  // P = inf -> Q
    el(X1 + c)[j] = r;
  }
  __syncthreads();
  mark(PH_SELECT);
}

__global__ void __launch_bounds__(THREADS, 4)
ladder_kernel(const uint32_t* __restrict__ oh, const uint32_t* __restrict__ ng,
              const uint32_t* __restrict__ table, int tcols,
              uint32_t* __restrict__ out, int cols) {
  uint32_t* tab = smem + TAB_OFF;
  uint32_t* wmask = smem + WMASK_OFF;
  const size_t col = blockIdx.x;
  const size_t tcol = tcols == 1 ? 0 : col;

  clear_work();
  for (int idx = threadIdx.x; idx < TABLE_WORDS; idx += THREADS)
    tab[idx] = table[(size_t)idx * tcols + tcol];
  __syncthreads();
  if (threadIdx.x == 0) el(Y1)[0] = 0xffffffffu;  // acc = (0 : 1 : 0)
  __syncthreads();
  prof_start();

  for (int w = 0; w < N_WINDOWS; ++w) {
    const int wi = N_WINDOWS - 1 - w;
    if (threadIdx.x < TABLE_SIZE)
      wmask[threadIdx.x] = oh[((size_t)wi * TABLE_SIZE + threadIdx.x) * cols + col];
    else if (threadIdx.x == TABLE_SIZE)
      wmask[TABLE_SIZE] = ng[(size_t)wi * cols + col];
    // tau^4: four squarings of X, Y, Z, alternating between P's slots
    // and S0..S2 (the first barrier also publishes wmask)
    phase_override(PH_FROB);
    out_pass(3, res(S0, 0, X1), res(S1, 0, Y1), res(S2, 0, Z1), 0);
    out_pass(3, res(X1, 0, S0), res(Y1, 0, S1), res(Z1, 0, S2), 0);
    out_pass(3, res(S0, 0, X1), res(S1, 0, Y1), res(S2, 0, Z1), 0);
    const uint32_t negm = wmask[TABLE_SIZE];
    for (int j = threadIdx.x; j < M; j += THREADS) {  // the pick, beside the last squaring
      uint32_t v[3] = {0u, 0u, 0u};
      for (int e = 0; e < TABLE_SIZE; ++e) {
        const uint32_t m = wmask[e];
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] ^= tab[(e * 3 + c) * M + j] & m;
      }
      el(X2)[j] = v[0];
      el(Y2)[j] = v[1] ^ (v[0] & negm);  // cneg
      el(Z2)[j] = v[2];
    }
    out_pass(3, res(X1, 0, S0), res(Y1, 0, S1), res(Z1, 0, S2), 0);
    phase_override(N_PHASES);
    point_add();
  }
#ifdef BS_PHASE_CLOCKS
  if (threadIdx.x == 0) {
    for (int k = 0; k < N_PHASES; ++k) atomicAdd(&g_phase_cycles[k], prof()[k]);
    atomicAdd(&g_phase_windows, (unsigned long long)N_WINDOWS);
  }
#endif

  for (int idx = threadIdx.x; idx < 3 * M; idx += THREADS)
    out[(size_t)idx * cols + col] = el(X1 + idx / M)[idx % M];
}

__global__ void __launch_bounds__(THREADS)
point_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                 uint32_t* __restrict__ out, int cols) {
  const size_t col = blockIdx.x;
  clear_work();
  __syncthreads();
  for (int idx = threadIdx.x; idx < 3 * M; idx += THREADS) {
    el(X1 + idx / M)[idx % M] = p[(size_t)idx * cols + col];
    el(X2 + idx / M)[idx % M] = q[(size_t)idx * cols + col];
  }
  __syncthreads();
  prof_start();
  point_add();
  for (int idx = threadIdx.x; idx < 3 * M; idx += THREADS)
    out[(size_t)idx * cols + col] = el(X1 + idx / M)[idx % M];
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).

int bs_ladder(const void* oh, const void* ng, const void* table, int tcols,
              void* out, int cols, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ladder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)LADDER_SMEM);
  if (e != cudaSuccess) return (int)e;
  ladder_kernel<<<cols, THREADS, LADDER_SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)oh, (const uint32_t*)ng, (const uint32_t*)table, tcols,
      (uint32_t*)out, cols);
  return (int)cudaGetLastError();
}

int bs_point_add(const void* p, const void* q, void* out, int cols, void* stream) {
  point_add_kernel<<<cols, THREADS, ADD_SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, cols);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of ladder_kernel (what = 0) or point_add_kernel
// (what = 1) at their launch's shared memory; negative on an error.
int bs_occupancy(int what) {
  int n = -1;
  cudaError_t e = cudaFuncSetAttribute(
      ladder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)LADDER_SMEM);
  if (e != cudaSuccess) return -(int)e;
  e = what == 0
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ladder_kernel, THREADS, LADDER_SMEM)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, point_add_kernel, THREADS, ADD_SMEM);
  return e == cudaSuccess ? n : -(int)e;
}

// Dynamic shared memory of a ladder_kernel (what = 0) or point_add_kernel
// (what = 1) block, in bytes.
int bs_shared_bytes(int what) { return (int)(what == 0 ? LADDER_SMEM : ADD_SMEM); }

#ifdef BS_PHASE_CLOCKS
const char* bs_phase_names() { return "frob,mul,reduce,double,select"; }

// Zero the phase clocks and the doubling counts.
int bs_phase_reset() {
  const unsigned long long z[N_PHASES] = {};
  cudaMemcpyToSymbol(g_phase_cycles, z, sizeof(z));
  cudaMemcpyToSymbol(g_phase_windows, z, sizeof(z[0]));
  cudaMemcpyToSymbol(g_doubles_run, z, sizeof(z[0]));
  cudaMemcpyToSymbol(g_doubles_needed, z, sizeof(z[0]));
  return (int)cudaGetLastError();
}

// out[0..N_PHASES) = cycles per phase summed over blocks, then the
// column-windows timed, doublings run and doublings needed.
int bs_phase_read(void* out) {
  unsigned long long* o = (unsigned long long*)out;
  cudaMemcpyFromSymbol(o, g_phase_cycles, sizeof(unsigned long long) * N_PHASES);
  cudaMemcpyFromSymbol(o + N_PHASES, g_phase_windows, sizeof(unsigned long long));
  cudaMemcpyFromSymbol(o + N_PHASES + 1, g_doubles_run, sizeof(unsigned long long));
  cudaMemcpyFromSymbol(o + N_PHASES + 2, g_doubles_needed, sizeof(unsigned long long));
  return (int)cudaGetLastError();
}
#endif

const char* bs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
