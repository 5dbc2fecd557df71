"""Auxiliary short-Weierstrass curve over Fr and the 2-isogeny chain.

ECFFT needs an FFT-like domain inside Fr, but Fr-1 has low 2-adicity, so
the domain is a coset of a 2^28-point subgroup of an auxiliary elliptic
curve over Fr (the ECFFT construction).  Curve, subgroup generator and
coset offset are fixed protocol constants shared with the reference
(reference: src/ec_fft.rs:203-229); the isogeny chain itself is an
implementation detail - any 2-isogeny whose kernel is the order-2 point
of the current subgroup yields the same FFTree domains (and all FFTree
operations are representation-independent polynomial maps).

A copy of dvpari_tpu/fftree/aux_curve.py.  `build_chain` enumerates
every layer on the host; `build_chain_meta` gives only the constants
that the device build (fftree/device_build.py) starts from.

Host-side: python-int arithmetic; this runs once per domain size and is
cached (the reference treats tree construction the same way,
src/artifacts.rs:28-42).
"""

from __future__ import annotations

from dataclasses import dataclass

from dvpari_tpu_torch.ops.fr import P as FR_P

# Short-Weierstrass y^2 = x^3 + A x + B over Fr (reference: src/ec_fft.rs:209-214)
CURVE_A = 2125753088427212854352924174339172498722499297750753614229533284661082
CURVE_B = 3303427382072851929105738691313541325219445842218525662544269869787589

# Generator of the 2^28-torsion subgroup used for domains
# (reference: src/ec_fft.rs:215-221)
SUBGROUP_GEN = (
    1969398527398874941115360315313056361667745675958024267654083765592400,
    917696706299601920847965073366118878832337776859300472447868491055982,
)
SUBGROUP_ADICITY = 28  # max domain size 2^28 (reference: src/ec_fft.rs:205)

# Coset offset keeping domains disjoint from the subgroup
# (reference: src/ec_fft.rs:223-228)
COSET_OFFSET = (
    1557215852494830750811239888869886110709986867282698163663807961412586,
    2302954593454110051167704558708330032236229062988890422530712548754008,
)


def _inv(x: int) -> int:
    # extended Euclid: the same inverse as x^(p-2), several times faster
    return pow(x, -1, FR_P)


@dataclass(frozen=True)
class Curve:
    a: int
    b: int

    def contains(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.a * x + self.b)) % FR_P == 0


def add(c: Curve, p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % FR_P == 0:
            return None
        lam = (3 * x1 * x1 + c.a) * _inv(2 * y1) % FR_P
    else:
        lam = (y2 - y1) * _inv(x2 - x1) % FR_P
    x3 = (lam * lam - x1 - x2) % FR_P
    y3 = (lam * (x1 - x3) - y1) % FR_P
    return (x3, y3)


def double(c: Curve, p):
    return add(c, p, p)


def smul(c: Curve, k: int, p):
    acc = None
    while k:
        if k & 1:
            acc = add(c, acc, p)
        p = double(c, p)
        k >>= 1
    return acc


def double_k(c: Curve, p, k: int):
    for _ in range(k):
        p = double(c, p)
    return p


@dataclass(frozen=True)
class TwoIsogeny:
    """Velu 2-isogeny with kernel {O, (x0, 0)}.

    x-map: psi(x) = (x^2 - x0 x + t) / (x - x0),  t = 3 x0^2 + A.
    Codomain: A' = A - 5t, B' = B - 7 x0 t.
    """

    x0: int
    t: int
    domain: Curve
    codomain: Curve

    def map_x(self, x: int) -> int:
        return (x * x - self.x0 * x + self.t) * _inv(x - self.x0) % FR_P

    def map_point(self, pt):
        if pt is None:
            return None
        x, y = pt
        if x == self.x0:  # the kernel point maps to O
            return None
        d = x - self.x0
        xx = self.map_x(x)
        yy = y * (1 - self.t * pow(_inv(d), 2, FR_P)) % FR_P
        return (xx, yy)


def two_isogeny_from_kernel(c: Curve, x0: int) -> TwoIsogeny:
    t = (3 * x0 * x0 + c.a) % FR_P
    w = x0 * t % FR_P
    cod = Curve((c.a - 5 * t) % FR_P, (c.b - 7 * w) % FR_P)
    return TwoIsogeny(x0=x0, t=t, domain=c, codomain=cod)


@dataclass
class ChainLayer:
    """One layer of the FFTree: its domain points and outgoing isogeny."""

    curve: Curve
    coset: tuple  # C_l
    gen: tuple  # G_l, order n_l
    n: int
    isogeny: "TwoIsogeny | None"  # None for the last layer
    xs: list  # x-coords of C_l + i G_l for i < n_l


def build_chain(domain_len: int, shift_by_one: bool, base_log_n: int):
    """Construct the full layer chain for a domain of `domain_len` points.

    Mirrors the reference's domain parameterization
    (reference: src/ec_fft.rs:93-170): generator G' of order domain_len,
    base generator G of order 2^base_log_n, coset = C (+ G if
    shift_by_one), leaves x(coset + i G').
    """
    assert domain_len & (domain_len - 1) == 0
    log_n = domain_len.bit_length() - 1
    assert log_n <= SUBGROUP_ADICITY
    curve = Curve(CURVE_A, CURVE_B)

    gen = double_k(curve, SUBGROUP_GEN, SUBGROUP_ADICITY - log_n)
    base_gen = double_k(curve, SUBGROUP_GEN, SUBGROUP_ADICITY - base_log_n)
    coset = COSET_OFFSET
    if shift_by_one:
        coset = add(curve, coset, base_gen)

    # Layer-0 points by incremental addition; deeper layers by mapping x's
    # through the isogeny (image of point i is point i mod n/2).
    xs = []
    pt = coset
    for _ in range(domain_len):
        assert pt is not None, "coset point hit infinity - bad coset"
        xs.append(pt[0])
        pt = add(curve, pt, gen)

    layers = []
    c, cs, g, n = curve, coset, gen, domain_len
    while True:
        if n == 1:
            layers.append(ChainLayer(c, cs, g, n, None, xs))
            break
        # kernel = the order-2 point in <G_l>: (n/2) * G_l, with y == 0
        ker = double_k(c, g, log2(n) - 1)
        assert ker is not None and ker[1] == 0, "kernel point must be 2-torsion"
        iso = two_isogeny_from_kernel(c, ker[0])
        layers.append(ChainLayer(c, cs, g, n, iso, xs))
        new_xs = [iso.map_x(x) for x in xs[: n // 2]]
        # pairing invariant: points i and i + n/2 share an image
        if n >= 2:
            assert iso.map_x(xs[n // 2]) == new_xs[0], "isogeny pairing broken"
        cs, g = iso.map_point(cs), iso.map_point(g)
        c, n, xs = iso.codomain, n // 2, new_xs
    return layers


def log2(n: int) -> int:
    return n.bit_length() - 1


@dataclass
class ChainMeta:
    """Per-layer constants without point enumeration (cheap host work),
    for the device build (fftree/device_build.py): layer-0 points come
    from mixed adds of doubled generators, higher layers from isogeny
    x-maps."""

    coset: tuple
    gen_doubles: list  # [2^j * G for j < log2(n)] as points
    layers: list  # per layer: (curve, isogeny or None)


def build_chain_meta(domain_len: int, shift_by_one: bool, base_log_n: int) -> ChainMeta:
    assert domain_len & (domain_len - 1) == 0
    log_n = domain_len.bit_length() - 1
    assert log_n <= SUBGROUP_ADICITY
    curve = Curve(CURVE_A, CURVE_B)
    gen = double_k(curve, SUBGROUP_GEN, SUBGROUP_ADICITY - log_n)
    base_gen = double_k(curve, SUBGROUP_GEN, SUBGROUP_ADICITY - base_log_n)
    coset = COSET_OFFSET
    if shift_by_one:
        coset = add(curve, coset, base_gen)

    gen_doubles = []
    g = gen
    for _ in range(log_n):
        gen_doubles.append(g)
        g = double(curve, g)

    layers = []
    c, gl, n = curve, gen, domain_len
    while True:
        if n == 1:
            layers.append((c, None))
            break
        ker = double_k(c, gl, log2(n) - 1)
        assert ker is not None and ker[1] == 0
        iso = two_isogeny_from_kernel(c, ker[0])
        layers.append((c, iso))
        gl = iso.map_point(gl)
        c, n = iso.codomain, n // 2
    return ChainMeta(coset=coset, gen_doubles=gen_doubles, layers=layers)
