"""The float32 dense route of MDM's encoder projections on the CPU (ops/dense.py).

The kernel itself (csrc/dense.cu) runs only on a card (tests/test_torch_cuda.py).
Here: its plain version, the three-product TF32 split, holds float32's error
where one TF32 product does not; the rounding it is built on; the route
function at every branch; the module's cached split weight; and QDense on the
CPU, which stays `F.linear` bit for bit.
"""

import pytest
import torch
import torch.nn.functional as F

from condmdi_tpu_torch.models.mdm import QDense
from condmdi_tpu_torch.ops import dense as dense_ops
from condmdi_tpu_torch.ops.dense import (MIN_ROWS, SplitDenseWeight, dense, dense_route,
                                         round_tf32, split_tf32, split_weight, tf32x3_linear,
                                         tile_n)

ERR_RATIO = 4.0  # the split's largest error, at most this many times a float32 product's
MDM_PROJECTIONS = [(512, 1536), (512, 512), (512, 1024), (1024, 512)]  # qkv, attn_out, ff1, ff2


def operands(M, K, N, seed=0):
    """x ~ N(0, 1) (a LayerNorm's output), W LeCun-normal, b ~ N(0, 0.02^2)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((M, K), generator=gen)
    w = torch.randn((N, K), generator=gen) * K ** -0.5
    return x, w, torch.randn((N,), generator=gen) * 0.02


def max_err(y, want):
    return (y.double() - want).abs().max().item()


@pytest.mark.parametrize("K,N", MDM_PROJECTIONS)
def test_three_products_keep_float32s_error(K, N):
    """At MDM's four projections (M cut to 256 rows), the plain version's largest error
    against a float64 product is within ERR_RATIO of a float32 product's; one TF32
    product (both operands rounded once) is far outside it."""
    x, w, b = operands(256, K, N, seed=K + N)
    want = x.double() @ w.double().T + b.double()
    f32 = max_err(F.linear(x, w, b), want)
    split = max_err(tf32x3_linear(x, split_weight(w), b), want)
    one = max_err(F.linear(round_tf32(x), round_tf32(w), b), want)
    assert split <= ERR_RATIO * f32, (split, f32)
    assert one > ERR_RATIO * f32, (one, f32)


def test_round_tf32_is_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10  # TF32's last mantissa bit at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, 1 + ulp,
                      0.0, -0.0, float("inf"), 1e30])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 1 + ulp, 0.0, -0.0, float("inf"),
                         2.0 ** 99 * (1 + 592 / 1024)])  # 1e30 = 2^99 x (1 + 591.6 / 1024)
    got = round_tf32(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert torch.all((got.view(torch.int32) & 0x1FFF) == 0)  # 10 mantissa bits kept


def test_hi_and_lo_carry_22_bits():
    x = torch.randn(10_000, generator=torch.Generator().manual_seed(1)) * 100
    hi, lo = split_tf32(x)
    assert torch.equal(round_tf32(hi), hi) and torch.equal(round_tf32(lo), lo)
    assert torch.all((hi.double() + lo.double() - x.double()).abs() <= 2.0 ** -22 * x.abs())
    planes = split_weight(x.reshape(100, 100))
    assert planes.shape == (2, 100, 100) and planes.dtype == torch.float32
    assert torch.equal(planes[0], hi.reshape(100, 100))


@pytest.mark.parametrize("case,route", [
    (dict(), "tf32x3"),
    (dict(M=10 ** 6), "tf32x3"),
    (dict(dtype=torch.bfloat16), "cublas"),
    (dict(dtype=torch.float16), "cublas"),
    (dict(needs_grad=True), "cublas"),
    (dict(K=520), "cublas"),
    (dict(N=263), "cublas"),
    (dict(M=MIN_ROWS - 1), "cublas"),
    (dict(M=MIN_ROWS), "tf32x3"),
])
def test_dense_route_at_every_branch(case, route):
    args = dict(M=64 * 197, K=512, N=1536, dtype=torch.float32, needs_grad=False) | case
    assert dense_route(**args) == route


def test_tile_width_follows_the_tile_count():
    assert tile_n(64 * 197, 512, 132) == 128   # 99 x 4 = 396 tiles
    assert tile_n(4 * 197, 512, 132) == 64     # 7 x 4 = 28 tiles
    assert tile_n(128 * 33, 512, 132) == 128   # exactly 132
    assert tile_n(128 * 33 - 127, 512, 132) == 128
    assert tile_n(128 * 32, 512, 132) == 64


@pytest.mark.parametrize("bias", [True, False])
def test_dense_on_the_cpu_is_the_plain_version(bias):
    x, w, b = operands(40, 64, 48)
    b = b if bias else None
    planes = split_weight(w)
    got = dense(x.reshape(2, 20, 64), planes, b)
    assert got.shape == (2, 20, 48)
    assert torch.equal(got.reshape(40, 48), tf32x3_linear(x, planes, b))


def test_split_weight_is_cached_and_remade_when_the_weight_changes():
    w = torch.nn.Parameter(torch.randn(32, 16))
    cache = SplitDenseWeight()
    first = cache.get(w)
    assert cache.get(w) is first and torch.equal(first, split_weight(w))
    with torch.no_grad():
        w.mul_(2.0)  # in place: the version counter moves
    again = cache.get(w)
    assert again is not first and torch.equal(again, split_weight(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qdense_on_the_cpu_is_f_linear_bit_for_bit(dtype):
    layer = QDense(512, 1536)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen) * 512 ** -0.5)
        layer.bias.copy_(torch.randn(layer.bias.shape, generator=gen) * 0.02)
    layer = layer.to(dtype)
    x = torch.randn((2, 197, 512), generator=gen).to(dtype)
    routes = dict(dense_ops.dense.routes)
    got = layer(x)
    assert torch.equal(got, F.linear(x, layer.weight, layer.bias))
    assert dense_ops.dense.routes == routes  # only float32 CUDA inputs are routed
