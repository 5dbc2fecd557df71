"""The scalar field Fr of sect233k1 (its prime group order), on python
ints: the one modulus of every scalar in the protocol."""

P = 3450873173395281893717377931138512760570940988862252126328087024741343


def inv(x: int) -> int:
    return pow(x % P, -1, P)


def batch_inv(xs: "list[int]") -> "list[int]":
    """1/x for every x (none zero), one inversion and 3(n-1) products."""
    n = len(xs)
    pre = [0] * n
    acc = 1
    for i, x in enumerate(xs):
        pre[i] = acc
        acc = acc * x % P
    acc = inv(acc)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = pre[i] * acc % P
        acc = acc * xs[i] % P
    return out
