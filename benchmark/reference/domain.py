"""The evaluation domain D of an m-constraint circuit and its barycentric
weights, derived from the protocol's published constants alone.

D is the even half of the 2m-point ECFFT domain: the x-coordinates of
the coset C + <H> on the auxiliary curve y^2 = x^3 + A x + B over Fr,
d_i = x(C + i H), where H = [2^(28 - log2 m)] G28 has order m (upstream:
alpenlabs/dv-pari src/ec_fft.rs:93-170 for the parameterization,
:203-229 for the constants).

The weights 1/Z_D'(d_i) come from the 2-isogeny phi whose kernel is the
order-2 point K of <H> (Velu: psi(x) = (x^2 - x0 x + t)/(x - x0),
t = 3 x0^2 + A).  The two points of D over each point of psi(D) are
the roots of u(X) - y v(X), u = X^2 - x0 X + t, v = X - x0, so

    Z_D(X) = v(X)^(m/2) Z_D1(psi(X))   and, at a root d,
    Z_D'(d) = v(d)^(m/2) psi'(d) Z_D1'(psi(d)),
    psi'(d) = ((d - x0)^2 - t) / (d - x0)^2,

down to a one-point domain, where Z' = 1.  This is independent of how
a prover computes the same numbers (a product tree of Z_D and an ECFFT
evaluation of its derivative).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import fr

P = fr.P
CURVE_A = 2125753088427212854352924174339172498722499297750753614229533284661082
CURVE_B = 3303427382072851929105738691313541325219445842218525662544269869787589
G28 = (
    1969398527398874941115360315313056361667745675958024267654083765592400,
    917696706299601920847965073366118878832337776859300472447868491055982,
)
COSET = (
    1557215852494830750811239888869886110709986867282698163663807961412586,
    2302954593454110051167704558708330032236229062988890422530712548754008,
)
ADICITY = 28


def _add(a: int, p, q):
    """Affine addition on y^2 = x^3 + a x + b (None is infinity)."""
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1 + a) * fr.inv(2 * y1) % P
    else:
        lam = (y2 - y1) * fr.inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _times_2k(a: int, p, k: int):
    for _ in range(k):
        p = _add(a, p, p)
    return p


def _coset_xs(a: int, c, h, n: int) -> "list[int]":
    """x(c + i h) for i < n (n a power of two): the list doubles by adding
    [2^j] h to every point already there, one batch inversion a step."""
    pts = [c]
    step = h
    while len(pts) < n:
        sx, sy = step
        dens = fr.batch_inv([x - sx for x, _ in pts])
        new = []
        for (x, y), di in zip(pts, dens):
            lam = (y - sy) * di % P
            x3 = (lam * lam - x - sx) % P
            new.append((x3, (lam * (x - x3) - y) % P))
        pts += new
        step = _add(a, step, step)
    return [x for x, _ in pts]


class Domain:
    """D = x(C + i H), i < m, with 1/Z_D'(d_i) and Z_D at a point."""

    def __init__(self, m: int):
        assert m >= 2 and m & (m - 1) == 0
        log_m = m.bit_length() - 1
        a, b = CURVE_A, CURVE_B
        h = _times_2k(a, G28, ADICITY - log_m)
        self.xs = _coset_xs(a, COSET, h, m)
        # the isogeny chain: per level its (x0, t); images of the first
        # half of each level's points are the next level's points
        self.chain = []
        xs, n = self.xs, m
        levels = []
        while n > 1:
            k = _times_2k(a, h, n.bit_length() - 2)  # (n/2) h, order 2
            assert k is not None and k[1] == 0
            x0 = k[0]
            t = (3 * x0 * x0 + a) % P
            self.chain.append((x0, t))
            levels.append(xs)
            vinv = fr.batch_inv([x - x0 for x in xs[: n // 2]])
            xs = [(x * x - x0 * x + t) * vi % P for x, vi in zip(xs[: n // 2], vinv)]
            if n > 2:  # the next level's generator (here h = k)
                h = self._velu(x0, t, h)
            a, b = (a - 5 * t) % P, (b - 7 * x0 * t) % P
            n //= 2
        self.last = xs[0]
        # Z_D' on every level, from the one-point level up (numpy object
        # arrays of python ints: exact, and the loops run in C)
        zp = np.array([1], dtype=object)
        for (x0, t), lv in zip(reversed(self.chain), reversed(levels)):
            n = len(lv)
            vs = (np.array(lv, dtype=object) - x0) % P
            sq = vs * vs % P
            p = vs
            for _ in range(n.bit_length() - 2):  # v^(n/2)
                p = p * p % P
            vinv2 = np.array(fr.batch_inv(list(sq)), dtype=object)
            zp = p * ((sq - t) % P) % P * vinv2 % P * np.tile(zp, 2) % P
        zp = [int(v) for v in zp]
        self.weights = fr.batch_inv(zp)  # 1/Z_D'(d_i)
        self._at = None  # (z, w_i / (z - d_i), Z_D(z)) of the last z

    @staticmethod
    def _velu(x0: int, t: int, pt):
        x, y = pt
        d = fr.inv(x - x0)
        return (x * x - x0 * x + t) * d % P, y * (1 - t * d * d) % P

    def z_at(self, z: int) -> int:
        """Z_D(z) = v(z)^(n/2) Z_D1(psi(z)), level by level."""
        acc = 1
        n = len(self.xs)
        for x0, t in self.chain:
            v = (z - x0) % P
            acc = acc * pow(v, n // 2, P) % P
            z = (z * z - x0 * z + t) * fr.inv(v) % P
            n //= 2
        return acc * (z - self.last) % P

    def interpolate_at(self, z: int, columns: "list[list[int]]") -> "list[int]":
        """p(z) for each column of values p(d_i) over D (degree < m):
        Z_D(z) sum_i w_i p(d_i) / (z - d_i); z must lie outside D."""
        if self._at is None or self._at[0] != z:
            inv = fr.batch_inv([z - x for x in self.xs])
            wd = [w * v % P for w, v in zip(self.weights, inv)]
            self._at = (z, wd, self.z_at(z))
        _, wd, zz = self._at
        return [zz * (sum(a * b for a, b in zip(col, wd)) % P) % P for col in columns]
