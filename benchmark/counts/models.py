"""Model FLOPs a forward from the configuration's sizes, at batch B (the
CFG-doubled batch where CFG runs): the configuration's reference module
(`benchmark/reference/<reference>.py`) counts its own model in `forward_flops`.
Also the resblock halves of a UNet forward, for the kernel's roofline."""

import importlib


def dense(B, cin, cout, rows=1) -> float:
    """FLOPs of a Dense layer over B × rows vectors."""
    return 2.0 * B * rows * cin * cout


def unet_halves(cfg, B):
    """(T, cin, cout, adagn, res) of the resblock halves of one forward, in order."""
    F, D, pad = cfg["njoints"], cfg["latent_dim"], cfg["pad"]
    dims = [F] + [int(D * m) for m in cfg["dim_mults"]]
    levels = list(zip(dims[:-1], dims[1:]))
    out = []

    def block(T, cin, cout):
        out.extend([(T, cin, cout, True, False), (T, cout, cout, False, True)])

    T = pad
    for i, (cin, cout) in enumerate(levels):
        block(T, 2 * F if i == 0 else cin, cout)
        block(T, cout, cout)
        if i < len(levels) - 1:
            T //= 2
    mid = levels[-1][1]
    block(T, mid, mid)
    block(T, mid, mid)
    for cin, cout in reversed(levels[1:]):
        block(T, 2 * cout, cin)
        block(T, cin, cin)
        T *= 2
    out.append((T, levels[0][1], levels[0][1], False, False))
    return out


def forward(cfg, B, frames) -> float:
    """The forward FLOPs of the configuration's model."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}").forward_flops(
        cfg, B, frames)
