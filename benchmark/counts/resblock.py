"""One UNet resblock half: conv k (SAME) → GroupNorm → [AdaGN] → Mish [→ +res]."""

from benchmark.counts.peaks import ITEMSIZE, bound_s


def flops(B, T, cin, cout, k=5) -> float:
    return 2.0 * B * T * cin * cout * k


def elements(B, T, cin, cout, adagn, res, k=5) -> int:
    """x, the weight, the bias and the norm's two vectors in, [scale, shift], [res],
    the output; the alignment channels of x are not part of the function."""
    n = B * T * cin + k * cin * cout + 3 * cout + B * T * cout
    return n + (2 * B * cout if adagn else 0) + (B * T * cout if res else 0)


def bound_ms(B, T, cin, cout, adagn, res, dtype="bf16", k=5, backward=False,
             x_grad=True) -> float:
    """The forward's bound, or with `backward` the forward and backward together:
    the backward's products counted as the weight gradient and, where x takes a
    gradient, the data gradient (each as many as the forward's); its bytes as the
    forward's inputs read again with the output's gradient, and the gradients of
    the inputs written (x's only where it takes one)."""
    n = elements(B, T, cin, cout, adagn, res, k)
    ops = flops(B, T, cin, cout, k)
    if backward:
        out, x = B * T * cout, B * T * cin
        ins = n - out
        n = n + ins + out + (ins if x_grad else ins - x)
        ops = ops * (3 if x_grad else 2)
    return bound_s(ops, n * ITEMSIZE[dtype], dtype)[0] * 1e3
