"""tau-adic NAF recoding constants for sect233k1, plus the pure-python
recoder the tests use as an oracle.

Counterpart of dvpari_tpu/ops/tnaf.py without the native bulk
recoders: the port recodes on the device (ops/tnaf_device.py).

tau(x, y) = (x^2, y^2) satisfies tau^2 + tau + 2 = 0 on this curve
(mu = -1).  A scalar k is partially reduced to rho = k partmod delta,
delta = (tau^m - 1)/(tau - 1), expanded as a tau-NAF (digits in
{0, +-1}, no two adjacent non-zero), and cut into 62 windows of 4
digits; each window is one of 21 values = sign x {inf, P, tP, t2P, t3P,
P+-t2P, P+-t3P, tP+-t3P}.
"""

from __future__ import annotations

import numpy as np

MU = -1
M = 233


def _zt_mul(a, b):
    """(a0 + a1 tau)(b0 + b1 tau) with tau^2 = mu tau - 2."""
    return (
        a[0] * b[0] - 2 * a[1] * b[1],
        a[0] * b[1] + a[1] * b[0] + MU * a[1] * b[1],
    )


def _zt_conj(a):
    return (a[0] + MU * a[1], -a[1])


def _zt_norm(a) -> int:
    return a[0] * a[0] + MU * a[0] * a[1] + 2 * a[1] * a[1]


def _lucas_u(m: int):
    u = [0, 1]
    for _ in range(m):
        u.append(MU * u[-1] - 2 * u[-2])
    return u


def _delta():
    """(tau^m - 1)/(tau - 1) in Z[tau] (exact division)."""
    u = _lucas_u(M + 1)
    num = (-1 - 2 * u[M - 1], u[M])  # tau^m - 1 = -2 U_{m-1} - 1 + U_m tau
    den = (-1, 1)
    q = _zt_mul(num, _zt_conj(den))
    n = _zt_norm(den)
    assert q[0] % n == 0 and q[1] % n == 0
    return (q[0] // n, q[1] // n)


DELTA = _delta()
N_DELTA = _zt_norm(DELTA)

TNAF_LEN = 248  # 62 windows of 4
N_WINDOWS = TNAF_LEN // 4

# window pattern -> (table index, sign); table entries:
# 0:inf 1:P 2:tP 3:t2P 4:t3P 5:P+t2P 6:P-t2P 7:P+t3P 8:P-t3P 9:tP+t3P 10:tP-t3P
TABLE_SIZE = 11


def partmod(k: int):
    """rho = k - round(k conj(delta)/N(delta)) * delta, in Z[tau]."""
    num = _zt_mul((k, 0), _zt_conj(DELTA))

    def rnd(x: int) -> int:  # round to nearest (half away from zero)
        return (2 * x + N_DELTA) // (2 * N_DELTA) if x >= 0 else -(
            (-2 * x + N_DELTA) // (2 * N_DELTA)
        )

    q = (rnd(num[0]), rnd(num[1]))
    qd = _zt_mul(q, DELTA)
    return (k - qd[0], -qd[1])


def tnaf_digits(c: int, d: int, max_len: int) -> np.ndarray:
    """tau-NAF of c + d tau: int8 digits in {-1, 0, 1}, LSB first."""
    out = np.zeros(max_len, dtype=np.int8)
    i = 0
    while c != 0 or d != 0:
        if c & 1:
            u = 2 - ((c - 2 * d) % 4)  # +-1
            c -= u
        else:
            u = 0
        assert i < max_len, "tau-NAF overflow; increase max_len"
        out[i] = u
        i += 1
        c, d = d - c // 2, -c // 2  # divide by tau (mu = -1)
    return out


def _window_code(d0: int, d1: int, d2: int, d3: int):
    nz = [(0, d0), (1, d1), (2, d2), (3, d3)]
    nz = [(i, v) for i, v in nz if v != 0]
    if not nz:
        return 0, 1
    if len(nz) == 1:
        i, v = nz[0]
        return 1 + i, v
    (i, v), (j, w) = nz
    pair = (i, j)
    if pair == (0, 2):
        return (5, v) if v == w else (6, v)
    if pair == (0, 3):
        return (7, v) if v == w else (8, v)
    if pair == (1, 3):
        return (9, v) if v == w else (10, v)
    raise AssertionError(f"invalid NAF window {d0, d1, d2, d3}")


def recode_scalars(ks) -> "tuple[np.ndarray, np.ndarray]":
    """Scalars -> (table indices int32[N_WINDOWS, n], signs int32[N_WINDOWS, n]).

    Window w covers tau^(4w)..tau^(4w+3); the ladder consumes windows
    MSB-first with acc = tau^4(acc) + sign * T[idx].
    """
    ks = list(ks)
    idx = np.zeros((N_WINDOWS, len(ks)), dtype=np.int32)
    sgn = np.ones((N_WINDOWS, len(ks)), dtype=np.int32)
    for j, k in enumerate(ks):
        c, d = partmod(int(k))
        digs = tnaf_digits(c, d, TNAF_LEN)
        for w in range(N_WINDOWS):
            d0, d1, d2, d3 = digs[4 * w : 4 * w + 4]
            t, s = _window_code(int(d0), int(d1), int(d2), int(d3))
            idx[w, j] = t
            sgn[w, j] = s
    return idx, sgn
