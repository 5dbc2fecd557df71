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
// 233 x 233 AND/XOR schoolbook, ~29 multiplies per window; with the
// operands in shared memory the integer and shared-memory pipes bound
// it, not device memory (a column moves ~60 KB in, 2.8 KB out).
//
// Design: one block of 256 threads per column.  The column's window
// table (30 KB) is staged in shared memory once; the accumulator, the
// picked entry and every add/double temporary live in shared memory
// (19 field elements in 256-word slots, zero past word 233, and one
// 465-word product).  A multiply gives thread t the product rows t and
// 233 + t, which together hold exactly 233 AND/XOR terms, so the work is
// even.  The rows' b-operand reads are one conflict-free load per term;
// the a-operand index is the same in every lane of a warp (except over
// the warp's own 32-row span, where each lane switches from row t to
// row 233 + t), so a comes in one broadcast 16-byte load per 4 terms.
// The multiply is one out-of-line function with rolled loops, which
// keeps the ladder's code small: inlined and fully unrolled at its ~29
// call sites per window it tripled the kernel's instructions and the
// ladder ran 1.7x slower on an H100.  Four blocks fit on an SM.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int M = 233;
constexpr int WIDE = 2 * M - 1;  // 465
constexpr int K = 74;            // x^233 = x^74 + 1
constexpr int N_WINDOWS = 62;
constexpr int TABLE_SIZE = 11;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SLOT = 256;  // words per field element; [233, 256) stay zero
constexpr int LEAD = 4;    // zero words before slot 0 (a multiply may read b[-3..-1])

// Field-element slots in shared memory: P = (X1, Y1, Z1) is the
// accumulator and the add's result, Q = (X2, Y2, Z2) the other operand,
// S* the generic add's temporaries, D* the doubling's.
enum Slot {
  X1, Y1, Z1, X2, Y2, Z2,
  S0, S1, S2, S3, S4, S5, S6,
  D0, D1, D2, D3, D4, D5,
  NSLOT
};

constexpr int WIDE_WORDS = 468;                 // WIDE rounded up to 16 bytes
constexpr int F0 = LEAD;                        // slot 0
constexpr int WIDE_OFF = F0 + NSLOT * SLOT;     // the 465-word product
constexpr int RED_OFF = WIDE_OFF + WIDE_WORDS;  // 4 x NWARPS reduction words
constexpr int WORK_WORDS = RED_OFF + 4 * NWARPS;
constexpr int TABLE_WORDS = TABLE_SIZE * 3 * M;
constexpr int TAB_OFF = WORK_WORDS;               // ladder: the window table
constexpr int WMASK_OFF = TAB_OFF + TABLE_WORDS;  // ladder: 11 digit masks + negate
constexpr size_t ADD_SMEM = sizeof(uint32_t) * WORK_WORDS;
constexpr size_t LADDER_SMEM = sizeof(uint32_t) * (WMASK_OFF + 16);

}  // namespace

// The block's dynamic shared memory, laid out by the offsets above.  It
// is reached by name, never through pointer arguments, so every access
// compiles to a shared-memory load or store.
extern __shared__ __align__(16) uint32_t smem[];

namespace {

__device__ __forceinline__ uint32_t* el(int slot) { return smem + F0 + slot * SLOT; }

// Zero the work area: slot padding and LEAD must read as zero.
__device__ __forceinline__ void clear_work() {
  for (int k = threadIdx.x; k < WORK_WORDS; k += THREADS) smem[k] = 0u;
}

// slot c = wide mod (x^233 + x^74 + 1).  h[r] = wide[233 + r] folds to r
// and r + 74; its rows 159.. land at 233.. and fold once more.
__device__ __forceinline__ void reduce_wide(int c) {
  const uint32_t* w = smem + WIDE_OFF;
  const uint32_t* h = w + M;
  uint32_t* out = el(c);
  for (int j = threadIdx.x; j < M; j += THREADS) {
    uint32_t v = w[j];
    if (j < M - 1) v ^= h[j];
    if (j >= K) v ^= h[j - K];
    if (j < K - 1) v ^= h[M - K + j];
    if (j >= K && j < 2 * K - 1) v ^= h[M - 2 * K + j];
    out[j] = v;
  }
  __syncthreads();
}

// slot c = slot a * slot b; c may be a or b.  Row t = XOR_{i<=t} a[i]
// b[t-i], row 233+t = XOR_{i>t} a[i] b[t+233-i]; i runs to 236, and a is
// zero from 233 (slot padding).
__device__ __noinline__ void gf_mul(int c, int a, int b) {
  const int t = threadIdx.x;
  if (t < M) {
    const uint32_t* pa = el(a);
    const uint32_t* blo = el(b) + t;      // blo[-i] = b[t - i]
    const uint32_t* bhi = el(b) + t + M;  // bhi[-i] = b[t + 233 - i]
    const int w0 = t & ~31;  // first row of this warp
    uint32_t lo = 0u, hi = 0u;
    int i = 0;
#pragma unroll 1
    for (; i < w0; i += 4) {  // i < w0 <= t: row t only
      const uint4 v = *reinterpret_cast<const uint4*>(pa + i);
      lo ^= (v.x & blo[-i]) ^ (v.y & blo[-i - 1]) ^ (v.z & blo[-i - 2]) ^ (v.w & blo[-i - 3]);
    }
#pragma unroll 1
    for (; i < w0 + 32; i += 4) {  // the warp's span: row t up to i = t
      const uint4 v = *reinterpret_cast<const uint4*>(pa + i);
      const uint32_t av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ii = i + q;
        if (ii <= t) lo ^= av[q] & blo[-ii];
        else hi ^= av[q] & bhi[-ii];
      }
    }
#pragma unroll 1
    for (; i < 236; i += 4) {  // i > t: row 233 + t only
      const uint4 v = *reinterpret_cast<const uint4*>(pa + i);
      hi ^= (v.x & bhi[-i]) ^ (v.y & bhi[-i - 1]) ^ (v.z & bhi[-i - 2]) ^ (v.w & bhi[-i - 3]);
    }
    smem[WIDE_OFF + t] = lo;
    if (t < M - 1) smem[WIDE_OFF + M + t] = hi;
  }
  __syncthreads();
  reduce_wide(c);
}

// slot c = (slot a)^2; c may be a.
__device__ __forceinline__ void gf_sqr(int c, int a) {
  const uint32_t* pa = el(a);
  for (int k = threadIdx.x; k < WIDE; k += THREADS)
    smem[WIDE_OFF + k] = (k & 1) ? 0u : pa[k >> 1];
  __syncthreads();
  reduce_wide(c);
}

// Zero masks of four slots (bit set iff that element is 0), returned in
// every thread.
__device__ __forceinline__ void zero_masks(int e0, int e1, int e2, int e3, uint32_t out[4]) {
  const int t = threadIdx.x;
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (t < M) {
    v[0] = el(e0)[t];
    v[1] = el(e1)[t];
    v[2] = el(e2)[t];
    v[3] = el(e3)[t];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = __reduce_or_sync(0xffffffffu, v[q]);
  if ((t & 31) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) smem[RED_OFF + q * NWARPS + (t >> 5)] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t r = 0;
    for (int w = 0; w < NWARPS; ++w) r |= smem[RED_OFF + q * NWARPS + w];
    out[q] = ~r;
  }
  __syncthreads();
}

// Tangent doubling of P into (D5, D2, D3):
// S = XZ, T = X^2 + YZ, X3 = T(T+S)S, Y3 = X^4 S + T(T+S)^2, Z3 = S^3.
__device__ __forceinline__ void point_double() {
  gf_mul(D0, X1, Z1);  // S
  gf_mul(D1, Y1, Z1);  // YZ
  gf_sqr(D2, X1);      // X^2
  gf_sqr(D3, D0);      // S^2
  for (int j = threadIdx.x; j < M; j += THREADS) {
    const uint32_t t = el(D2)[j] ^ el(D1)[j];  // T
    el(D1)[j] = t;
    el(D4)[j] = t ^ el(D0)[j];  // T + S
  }
  __syncthreads();
  gf_sqr(D2, D2);      // X^4
  gf_mul(D1, D1, D4);  // TT = T(T+S)
  gf_mul(D3, D3, D0);  // Z3 = S^3
  gf_mul(D5, D1, D0);  // X3 = TT S
  gf_mul(D2, D2, D0);  // X^4 S
  gf_mul(D1, D1, D4);  // TT (T+S)
  for (int j = threadIdx.x; j < M; j += THREADS) el(D2)[j] ^= el(D1)[j];  // Y3
  __syncthreads();
}

// P = P + Q, masked-complete (same cases as xsk233_bs.add):
// W = Z1 Z2, U = Y1 Z2 + Y2 Z1, V = X1 Z2 + X2 Z1, N = U^2 W + U V W + V^3,
// X3 = N V, Z3 = V^3 W, Y3 = U (X1 V^2 Z2 + N) + V N + Y1 V^3 Z2.
__device__ __forceinline__ void point_add() {
  gf_mul(S0, Z1, Z2);  // W
  gf_mul(S1, Y1, Z2);
  gf_mul(S2, Y2, Z1);
  gf_mul(S3, X1, Z2);
  gf_mul(S4, X2, Z1);
  for (int j = threadIdx.x; j < M; j += THREADS) {
    el(S1)[j] ^= el(S2)[j];  // U
    el(S3)[j] ^= el(S4)[j];  // V
  }
  __syncthreads();
  uint32_t zm[4];  // inf_p, inf_q, v_zero, u_zero
  zero_masks(Z1, Z2, S3, S1, zm);
  gf_sqr(S4, S3);      // V^2
  gf_sqr(S2, S1);      // U^2
  gf_mul(S5, S4, S3);  // V^3
  gf_mul(S6, S1, S0);  // UW
  gf_mul(S2, S2, S0);  // U^2 W
  gf_mul(S6, S6, S3);  // UWV
  gf_mul(S4, S4, Z2);  // V^2 Z2
  for (int j = threadIdx.x; j < M; j += THREADS) el(S2)[j] ^= el(S6)[j] ^ el(S5)[j];  // N
  __syncthreads();
  gf_mul(S0, S5, S0);  // Z3 = V^3 W
  gf_mul(S5, S5, Z2);  // V^3 Z2
  gf_mul(S6, S2, S3);  // X3 = N V
  gf_mul(S4, X1, S4);  // X1 V^2 Z2
  gf_mul(S5, Y1, S5);  // Y1 V^3 Z2
  for (int j = threadIdx.x; j < M; j += THREADS) el(S4)[j] ^= el(S2)[j];  // X1 V^2 Z2 + N
  __syncthreads();
  gf_mul(S4, S1, S4);  // U (X1 V^2 Z2 + N)
  gf_mul(S3, S3, S2);  // V N
  for (int j = threadIdx.x; j < M; j += THREADS) el(S4)[j] ^= el(S3)[j] ^ el(S5)[j];  // Y3
  __syncthreads();

  point_double();  // (D5, D2, D3)

  const uint32_t inf_p = zm[0], inf_q = zm[1], v_zero = zm[2], u_zero = zm[3];
  const uint32_t m_inf = v_zero & ~u_zero;  // P = -Q
  const uint32_t m_dbl = v_zero & u_zero;   // P = Q
  const int gen[3] = {S6, S4, S0};
  const int dbl[3] = {D5, D2, D3};
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

  for (int w = 0; w < N_WINDOWS; ++w) {
    const int wi = N_WINDOWS - 1 - w;
    if (threadIdx.x < TABLE_SIZE)
      wmask[threadIdx.x] = oh[((size_t)wi * TABLE_SIZE + threadIdx.x) * cols + col];
    else if (threadIdx.x == TABLE_SIZE)
      wmask[TABLE_SIZE] = ng[(size_t)wi * cols + col];
    for (int c = 0; c < 3; ++c)
      for (int r = 0; r < 4; ++r) gf_sqr(X1 + c, X1 + c);  // tau^4
    // (gf_sqr's barriers also publish wmask)
    const uint32_t negm = wmask[TABLE_SIZE];
    for (int j = threadIdx.x; j < M; j += THREADS) {
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
    __syncthreads();
    point_add();
  }

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

const char* bs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
