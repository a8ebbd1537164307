"""Self-attention of q, k, v [B, T, D] over H heads (the fused kernel's call)."""

from benchmark.counts.peaks import ITEMSIZE, bound_s


def flops(B, T, D, H) -> float:
    return 4.0 * B * T * T * D  # q·kᵀ and p·v, 2·T·T·hd each per head


def bound_ms(B, T, D, H, dtype="bf16") -> float:
    return bound_s(flops(B, T, D, H), 4 * B * T * D * ITEMSIZE[dtype], dtype)[0] * 1e3
