"""FFTree: the ECFFT polynomial engine over Fr, as torch level passes.

Counterpart of dvpari_tpu/fftree/tree.py: the build (the host isogeny
chain, or the device build of fftree/device_build.py from
DVPARI_DEVICE_TREE_MIN leaves), the leaf views, the extend tables, the
vanishing-polynomial coefficients, `extend` (evals on one moiety ->
evals on the other), `enter` (coefficients -> evals on all leaves) and
`exit` (evals on all leaves -> coefficients).

Every level is one whole-array pass: at depth k all 2^k subproblems live
in one tensor `(20, *B, V, s)` (limb axis, batch axes, subproblem axis,
domain axis), so a level is a handful of large elementwise Fr ops.  A
subtree of depth d is a view: stride-2^d slices of the same layers.  The
JAX package's chunk lists, program families and warm jobs
(fftree/chunked.py) exist to bound the TPU's compile universe; torch
compiles nothing, so they have no counterpart here.  Neither setup nor
prove calls `exit`.

Results are polynomial maps, so they equal the JAX package's after
strong_normalize; the loose limbs may differ.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dvpari_tpu_torch.device import resolve
from dvpari_tpu_torch.fftree import aux_curve, device_build as dbuild
from dvpari_tpu_torch.ops import fr
from dvpari_tpu_torch.utils import kronecker
from dvpari_tpu_torch.utils.timing import phase

# Largest domain whose vanishing-poly product tree runs as python-int
# schoolbook; above it the GMP Kronecker-substitution tree of the native
# library (utils/kronecker.py:vanishing_coeffs_limbs) takes over.
HOST_ZC_MAX = 4096

# Smallest domain that FFTree.build builds on the device by default
# (DVPARI_DEVICE_TREE_MIN overrides it): on an H100 the device build beat
# the host chain from 2^16 leaves on (2.11 s against 2.54 s; 3.03 s
# against 6.11 s at 2^17), and lost below (PERF.md, K8;
# scripts/tree_build.py --sizes).
DEVICE_TREE_MIN = 1 << 16


def device_tree_min() -> int:
    return int(os.environ.get("DVPARI_DEVICE_TREE_MIN", DEVICE_TREE_MIN))


_SCHOOLBOOK_CUTOFF = 16  # polynomial products below this length are schoolbook


def _log2(n: int) -> int:
    assert n & (n - 1) == 0
    return n.bit_length() - 1


def _host_vanishing_coeffs(points: "list[int]") -> "list[int]":
    """prod (x - s_i) coefficients via a python-int product tree."""
    polys = [[(-s) % fr.P, 1] for s in points]
    while len(polys) > 1:
        nxt = []
        for a, b in zip(polys[0::2], polys[1::2]):
            out = [0] * (len(a) + len(b) - 1)
            for i, ai in enumerate(a):
                if ai:
                    for j, bj in enumerate(b):
                        out[i + j] = (out[i + j] + ai * bj) % fr.P
            nxt.append(out)
        polys = nxt
    return polys[0]


def _bcast(consts: torch.Tensor, state_ndim: int) -> torch.Tensor:
    """(20, h) level constants -> (20, 1...1, h) against (20, *B, V, s)."""
    return consts.reshape((fr.NLIMB,) + (1,) * (state_ndim - 2) + (consts.shape[-1],))


def _pow_mersenne(v: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """v^(2^j - 1) elementwise, j int64[n] (0 gives 1): the product of
    v^(2^i) for i < j, one square and one masked multiply per bit."""
    acc = fr.ones(v.shape[1:], v.device)
    top = int(j.max()) if j.numel() else 0
    for i in range(top):
        acc = fr.select(j > i, fr.mul(acc, v), acc)
        if i + 1 < top:
            v = fr.square(v)
    return acc


class FFTree:
    """ECFFT tree over a 2^L-point coset domain of the auxiliary curve.

    `layers` are host int32[20, n_l] limb arrays (l = 0..L), `x0s` the
    isogeny kernel x-coordinates (python ints); tables and transforms
    run on `device`.
    """

    def __init__(self, layers, x0s, shift_by_one: bool, base_log_n: int, device="cuda"):
        self.layers = [np.ascontiguousarray(l, dtype=np.int32) for l in layers]
        self.x0s = [int(x) for x in x0s]
        self.n = self.layers[0].shape[-1]
        self.shift_by_one = bool(shift_by_one)
        self.base_log_n = int(base_log_n)
        self.device = resolve(device)
        self._cache: dict = {}
        # Set by storage/artifacts.py: derived tables (extend constants,
        # x^n powers, z coefficients) persist next to the tree artifact,
        # in the JAX package's file names and keys.
        self.table_dir: "str | None" = None

    @classmethod
    def build(cls, domain_len: int, shift_by_one: bool, base_log_n: int, device="cuda",
              device_build: "bool | None" = None):
        """The tree's layers on the host (the isogeny chain in python
        ints, aux_curve.build_chain) or on `device` (device_build.py);
        device_build=None picks the device from DVPARI_DEVICE_TREE_MIN
        leaves (default DEVICE_TREE_MIN).  The phase "tree.device_build"
        or "tree.host_build" records which ran."""
        dev = resolve(device)
        if device_build is None:
            device_build = domain_len >= device_tree_min()
        with phase("tree.device_build" if device_build else "tree.host_build", dev, n=domain_len):
            if device_build:
                meta = aux_curve.build_chain_meta(domain_len, shift_by_one, base_log_n)
                layers = dbuild.build_layers(meta, domain_len, dev)
                x0s = [iso.x0 for _, iso in meta.layers if iso is not None]
            else:
                chain = aux_curve.build_chain(domain_len, shift_by_one, base_log_n)
                layers = [fr.from_int(layer.xs) for layer in chain]
                x0s = [layer.isogeny.x0 for layer in chain if layer.isogeny is not None]
        return cls(layers, x0s, shift_by_one, base_log_n, dev)

    # -- table persistence ----------------------------------------------------

    def _table_load(self, name: str):
        if self.table_dir:
            p = os.path.join(self.table_dir, name + ".npz")
            if os.path.exists(p):
                return np.load(p)
        return None

    def _table_save(self, name: str, **arrs) -> None:
        if self.table_dir:
            os.makedirs(self.table_dir, exist_ok=True)
            np.savez(os.path.join(self.table_dir, name + ".npz"), **arrs)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(self.device)

    # -- views ----------------------------------------------------------------

    def leaves(self, d: int = 0) -> torch.Tensor:
        """Leaf x-coords of the depth-d subtree view (stride 2^d)."""
        key = ("leaves", d)
        if key not in self._cache:
            self._cache[key] = self._dev(self.layers[0][:, :: 1 << d])
        return self._cache[key]

    def both_domains(self):
        """(D, D'): the even and the odd leaves."""
        key = ("both",)
        if key not in self._cache:
            L0 = self.layers[0]
            self._cache[key] = (self._dev(L0[:, 0::2]), self._dev(L0[:, 1::2]))
        return self._cache[key]

    # -- cached constants -----------------------------------------------------

    def _extend_consts(self, d: int, moiety: str):
        """Per-level decompose/recombine tables of the extend at view d:
        lists of 4-tuples of (20, half_k) tensors.  All levels are derived
        in one batch of elementwise ops over their concatenation."""
        key = ("ext", d, moiety)
        if key in self._cache:
            return self._cache[key]
        name = f"ext_{d}_{moiety}"
        z = self._table_load(name)
        if z is not None:
            K = int(z["K"])
            dec = [tuple(self._dev(z[f"d{k}_{i}"]) for i in range(4)) for k in range(K)]
            rec = [tuple(self._dev(z[f"r{k}_{i}"]) for i in range(4)) for k in range(K)]
            self._cache[key] = (dec, rec)
            return self._cache[key]
        m = self.n >> (d + 1)
        K = _log2(m)
        src_off = 0 if moiety == "S1" else (1 << d)
        tgt_off = (1 << d) if moiety == "S1" else 0
        stride = 1 << (d + 1)
        parts = {"s0": [], "s1": [], "t0": [], "t1": [], "x0": []}
        halves, jbits = [], []
        for k in range(K):
            mk = m >> k
            half = mk >> 1
            s = self.layers[k][:, src_off::stride]
            t = self.layers[k][:, tgt_off::stride]
            parts["s0"].append(s[:, :half])
            parts["s1"].append(s[:, half:mk])
            parts["t0"].append(t[:, :half])
            parts["t1"].append(t[:, half:mk])
            parts["x0"].append(np.repeat(fr.from_int(self.x0s[k])[:, None], half, axis=1))
            halves.append(half)
            jbits.append(np.full(half, _log2(half), dtype=np.int64))
        dec, rec = [], []
        if K:
            s0, s1, t0, t1, x0 = (
                self._dev(np.concatenate(parts[k], axis=1))
                for k in ("s0", "s1", "t0", "t1", "x0")
            )
            j = torch.from_numpy(np.concatenate(jbits)).to(self.device)
            v0e = _pow_mersenne(fr.sub(s0, x0), j)
            v1e = _pow_mersenne(fr.sub(s1, x0), j)
            det_inv = fr.batch_inverse(fr.mul(fr.mul(v0e, v1e), fr.sub(s1, s0)), axis=0)
            w0e = _pow_mersenne(fr.sub(t0, x0), j)
            w1e = _pow_mersenne(fr.sub(t1, x0), j)
            dec_all = (
                fr.mul(fr.mul(s1, v1e), det_inv),
                fr.neg(fr.mul(fr.mul(s0, v0e), det_inv)),
                fr.neg(fr.mul(v1e, det_inv)),
                fr.mul(v0e, det_inv),
            )
            rec_all = (w0e, fr.mul(t0, w0e), w1e, fr.mul(t1, w1e))
            splits = list(np.cumsum(halves)[:-1])
            dec_lv = [torch.tensor_split(v, splits, dim=1) for v in dec_all]
            rec_lv = [torch.tensor_split(v, splits, dim=1) for v in rec_all]
            dec = [tuple(dec_lv[i][k].contiguous() for i in range(4)) for k in range(K)]
            rec = [tuple(rec_lv[i][k].contiguous() for i in range(4)) for k in range(K)]
        if self.table_dir:
            host = {"K": np.int64(K)}
            for k in range(K):
                for i in range(4):
                    host[f"d{k}_{i}"] = dec[k][i].cpu().numpy()
                    host[f"r{k}_{i}"] = rec[k][i].cpu().numpy()
            self._table_save(name, **host)
        self._cache[key] = (dec, rec)
        return self._cache[key]

    def _xnn(self, d: int):
        """x^(view_size/2) on the even and the odd leaves of view(d)."""
        key = ("xnn", d)
        if key in self._cache:
            return self._cache[key]
        z = self._table_load(f"xnn_{d}")
        if z is not None:
            self._cache[key] = (self._dev(z["even"]), self._dev(z["odd"]))
            return self._cache[key]
        vals = self.leaves(d)
        for _ in range(_log2(self.n >> (d + 1))):
            vals = fr.square(vals)
        ev, od = vals[:, 0::2].contiguous(), vals[:, 1::2].contiguous()
        self._table_save(f"xnn_{d}", even=ev.cpu().numpy(), odd=od.cpu().numpy())
        self._cache[key] = (ev, od)
        return self._cache[key]

    def z_coeffs(self, d: int) -> torch.Tensor:
        """Vanishing-poly coefficients of the view(d) leaves,
        (20, n_d + 1) canonical limbs: the python-int product tree up to
        HOST_ZC_MAX leaves, the native GMP Kronecker tree above."""
        key = ("zc", d)
        if key in self._cache:
            return self._cache[key]
        z = self._table_load(f"zc_{d}")
        if z is not None:
            got = z["zc"]
        else:
            dom = self.layers[0][:, :: 1 << d]
            if dom.shape[-1] <= HOST_ZC_MAX:
                got = fr.from_int(_host_vanishing_coeffs(fr.to_int(dom)))
            else:
                got = kronecker.vanishing_coeffs_limbs(dom)
            self._table_save(f"zc_{d}", zc=got)
        self._cache[key] = self._dev(got)
        return self._cache[key]

    # -- transforms -----------------------------------------------------------

    def extend(self, evals: torch.Tensor, moiety: str = "S1", d: int = 0) -> torch.Tensor:
        """Evals of P (deg < m) on one moiety of view(d) -> evals on the
        other; evals (20, *B, m), m = n >> (d + 1)."""
        m = evals.shape[-1]
        assert m == self.n >> (d + 1), (m, self.n, d)
        if m == 1:
            return evals
        dec, rec = self._extend_consts(d, moiety)
        return _extend_tabled(evals.to(self.device), dec, rec)

    def enter(self, coeffs: torch.Tensor, d: int = 0) -> torch.Tensor:
        """Coefficients (20, *B, n), n = self.n >> d -> evals on all
        view(d) leaves, one whole-array pass per level."""
        n = coeffs.shape[-1]
        assert n == self.n >> d, (n, self.n, d)
        state = coeffs.to(self.device)[..., :, None]  # (20, *B, V=n, s=1)
        for k in reversed(range(_log2(n))):
            dec, rec = self._extend_consts(d + k, "S1")
            xe, xo = self._xnn(d + k)
            state = _enter_level(state, dec, rec, xe, xo)
        return state[..., 0, :]

    def exit(self, evals: torch.Tensor, d: int = 0) -> torch.Tensor:
        """Evals (20, *B, n) on all view(d) leaves, n = self.n >> d ->
        the coefficients of the polynomial of degree < n through them:
        K forward levels split P = A + Z0 B down to single values, K
        backward levels recombine the coefficients."""
        n = evals.shape[-1]
        assert n == self.n >> d, (n, self.n, d)
        K = _log2(n)
        state = evals.to(self.device)[..., None, :]  # (20, *B, V=1, s=n)
        for k in range(K):
            ext1 = self._extend_consts(d + k, "S1")
            ext0 = self._extend_consts(d + k, "S0")
            state = _exit_fwd_level(state, ext1, ext0, self._z0_inv_odd(d + k))
        for k in reversed(range(K)):
            state = _exit_bwd_level(state, self._z0_tail(d + k + 1))
        return state[..., 0, :]

    def _z0_inv_odd(self, d: int) -> torch.Tensor:
        """1 / Z_{view(d+1)} on the odd leaves of view(d): (20, n_d / 2)."""
        key = ("z0inv", d)
        if key in self._cache:
            return self._cache[key]
        z = self._table_load(f"z0inv_{d}")
        if z is not None:
            self._cache[key] = self._dev(z["inv"])
            return self._cache[key]
        n = self.n >> d
        zc = self.z_coeffs(d + 1)  # (20, n/2 + 1)
        padded = fr.zeros((n,), self.device)
        padded[:, : zc.shape[-1]] = zc
        out = fr.batch_inverse(self.enter(padded, d)[:, 1::2], axis=0)
        self._table_save(f"z0inv_{d}", inv=out.cpu().numpy())
        self._cache[key] = out
        return out

    def _z0_tail(self, d: int) -> torch.Tensor:
        """Z_{view(d)} without its monic top term: (20, n_d) coefficients."""
        return self.z_coeffs(d)[..., :-1]


def _extend_tabled(evals: torch.Tensor, dec, rec) -> torch.Tensor:
    """Levelwise ECFFT extend over the last axis; the per-level tables
    are shared by the 2^k subvectors of level k."""
    state = evals[..., None, :]  # (20, *B, V=1, s=m)
    for k in range(len(dec)):
        half = state.shape[-1] // 2
        d00, d01, d10, d11 = (_bcast(c, state.ndim) for c in dec[k])
        E0, E1 = state[..., :half], state[..., half:]
        U0 = fr.add(fr.mul(d00, E0), fr.mul(d01, E1))
        U1 = fr.add(fr.mul(d10, E0), fr.mul(d11, E1))
        st = torch.stack([U0, U1], dim=-2)  # (..., V, 2, half)
        state = st.reshape(*st.shape[:-3], -1, half)
    for k in reversed(range(len(rec))):
        half = state.shape[-1]
        r0, r0x, r1, r1x = (_bcast(c, state.ndim) for c in rec[k])
        st = state.reshape(*state.shape[:-2], -1, 2, half)
        U0, U1 = st[..., 0, :], st[..., 1, :]
        P0 = fr.add(fr.mul(r0, U0), fr.mul(r0x, U1))
        P1 = fr.add(fr.mul(r1, U0), fr.mul(r1x, U1))
        state = torch.cat([P0, P1], dim=-1)
    return state[..., 0, :]


def _enter_level(state, dec, rec, xe, xo):
    """One enter level: split the even/odd coefficient subvectors, extend
    both (one batched extend), recombine with x^sz on each moiety."""
    u = state[..., 0::2, :]
    v = state[..., 1::2, :]
    ext = _extend_tabled(torch.stack([u, v], dim=1), dec, rec)
    u_ext, v_ext = ext[:, 0], ext[:, 1]
    even = fr.add(u, fr.mul(_bcast(xe, state.ndim), v))
    odd = fr.add(u_ext, fr.mul(_bcast(xo, state.ndim), v_ext))
    st = torch.stack([even, odd], dim=-1)  # (..., V/2, sz, 2)
    return st.reshape(*st.shape[:-3], st.shape[-3], 2 * st.shape[-2])


def _exit_fwd_level(state, ext1, ext0, z0inv):
    """One forward exit level: on each subproblem's evals, P = A + Z0 B
    with A, B of half the degree; A's evals on the even leaves are P's,
    B's on the odd leaves are (P - A) / Z0 there, and an extend carries
    each to the other moiety.  (..., V, s) -> (..., 2V, s/2)."""
    y0 = state[..., 0::2]
    y1 = state[..., 1::2]
    a_odd = _extend_tabled(y0, *ext1)
    b_odd = fr.mul(fr.sub(y1, a_odd), _bcast(z0inv, state.ndim))
    b_even = _extend_tabled(b_odd, *ext0)
    st = torch.stack([y0, b_even], dim=-2)  # (..., V, 2, s/2)
    return st.reshape(*st.shape[:-3], -1, st.shape[-1])


def _exit_bwd_level(state, ztail):
    """One backward exit level: coefficients P = [A || B] + Z0_tail * B.
    (..., 2V, sz) -> (..., V, 2 sz)."""
    sz = state.shape[-1]
    st = state.reshape(*state.shape[:-2], -1, 2, sz)
    A, B = st[..., 0, :], st[..., 1, :]
    prod = _polymul(_bcast(ztail, B.ndim), B)  # (..., V, 2 sz - 1)
    out = torch.cat([A, B], dim=-1)
    out[..., : 2 * sz - 1] = fr.add(out[..., : 2 * sz - 1], prod)
    return out


def _polymul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of coefficient vectors of one power-of-two length n:
    (20, *A, n) x (20, *B, n) -> (20, *broadcast, 2n - 1)."""
    n = a.shape[-1]
    assert b.shape[-1] == n and n & (n - 1) == 0
    shape = torch.broadcast_shapes(a.shape[1:-1], b.shape[1:-1])
    a = a.expand(fr.NLIMB, *shape, n).reshape(fr.NLIMB, -1, n)
    b = b.expand(fr.NLIMB, *shape, n).reshape(fr.NLIMB, -1, n)
    return _karatsuba(a, b).reshape(fr.NLIMB, *shape, 2 * n - 1)


def _karatsuba(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(20, V, n) x (20, V, n) -> (20, V, 2n - 1), level-synchronous: the
    three half products of every pair are one batch of 3V pairs."""
    V, n = a.shape[1], a.shape[-1]
    out = fr.zeros((V, 2 * n - 1), a.device)
    if n <= _SCHOOLBOOK_CUTOFF:
        for i in range(n):
            out[..., i : i + n] = fr.add(out[..., i : i + n], fr.mul(a[..., i : i + 1], b))
        return out
    h = n // 2
    a0, a1, b0, b1 = a[..., :h], a[..., h:], b[..., :h], b[..., h:]
    p = _karatsuba(torch.cat([a0, a1, fr.add(a0, a1)], dim=1),
                   torch.cat([b0, b1, fr.add(b0, b1)], dim=1))
    p0, p2, pm = p[:, :V], p[:, V : 2 * V], p[:, 2 * V :]
    for off, part in ((0, p0), (h, fr.sub(fr.sub(pm, p0), p2)), (2 * h, p2)):
        out[..., off : off + 2 * h - 1] = fr.add(out[..., off : off + 2 * h - 1], part)
    return out
