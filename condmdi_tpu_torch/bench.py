"""The bench models and the golden trajectory check, without JAX.

Counterpart of the root bench.py's `build_bench_model`, `build_run`,
`verify_trajectory`, `golden_name` and `check_against_golden` for the
`BENCH_MODEL` keys `unet`, `unet_int8`, `unet_int8_static`,
`unet_int8_static_pc`, `unet_int8_mixed`, `mdm` and `mdm_int8`, with
`BENCH_PAD`, `BENCH_BATCH` and `BENCH_FLOAT_LAST_K` read as bench.py reads
them. The timed `main()` waits for the benchmark.

bench.py draws its weights from Flax's initialisers (`model.init(
jax.random.key(0), …)`), and its committed golden trajectories
(tests/golden/bench_traj_*.json) follow from those weights. So this module
carries Flax's parameter initialisation for the port's modules, written in
torch: the threefry-2x32 generator with JAX's partitionable bit layout, each
parameter's key folded from Flax's module path and per-module counter
(sha1 of the path, as flax.core.scope `_fold_in_static`), and lecun-normal
as `jax.random.truncated_normal` draws it. The threefry bits are exact; the
float steps (erf, erfinv) may differ from XLA's in the last bit.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.models.embeddings import EmbedAction
from condmdi_tpu_torch.models.layers import ConvTransposeParams, Dense, GroupNormParams
from condmdi_tpu_torch.models.unet import QConv
from condmdi_tpu_torch.weights import load_flax_params

T, F = 196, 263
GOLDEN_PATH = str(Path(__file__).resolve().parent.parent / "tests" / "golden"
                  / "bench_traj_{which}.json")
UNET_MODES = {
    "unet": "float",
    "unet_int8": "int8",
    "unet_int8_static": "int8_static",
    "unet_int8_static_pc": "int8_static_pc",
    "unet_int8_mixed": "int8_static",  # + a float twin for the last BENCH_FLOAT_LAST_K steps
}
BENCH_MODELS = tuple(UNET_MODES) + ("mdm", "mdm_int8")

# --------------------------------------------------------------------------- #
# Flax's parameter initialisation, in torch
# --------------------------------------------------------------------------- #
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: tuple[int, int], x0, x1):
    """Threefry-2x32 (20 rounds) of counters x0, x1: Python ints or int64
    tensors holding uint32 values."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """jax.random.fold_in for the threefry implementation."""
    return _threefry2x32(key, 0, data & _M32)


def _param_key(root: tuple[int, int], path: tuple[str, ...], counter: int) -> tuple[int, int]:
    """The key Flax's scope hands the `counter`-th parameter of the module at
    `path`: one fold_in of the first 4 bytes of sha1(path + counter)."""
    m = hashlib.sha1()
    for part in path:
        m.update(part.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, byteorder="big"))
    return _fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))


def _random_bits(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """32 random bits per element, JAX's partitionable layout: threefry of the
    element's 64-bit index split in (hi, lo), the two words xor-ed."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32(key, idx >> 32, idx & _M32)
    return b0 ^ b1


def _lecun_normal(key, shape, device) -> torch.Tensor:
    """jax.nn.initializers.lecun_normal: truncated_normal(-2, 2) * sqrt(1/fan_in) / 0.8796…,
    fan_in = the product of all but the last axis."""
    bits = _random_bits(key, math.prod(shape), device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    sqrt2 = torch.tensor(np.sqrt(2), dtype=torch.float32, device=device)
    lo, hi = torch.erf(-2.0 / sqrt2), torch.erf(2.0 / sqrt2)
    u = torch.maximum(lo, floats * (hi - lo) + lo)
    out = sqrt2 * torch.special.erfinv(u)
    bound = torch.tensor(2.0, dtype=torch.float32)
    out = out.clamp(torch.nextafter(-bound, bound).item(), torch.nextafter(bound, -bound).item())
    fan_in = math.prod(shape[:-1])
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
    return (out * float(stddev)).reshape(shape)


def flax_params(model: torch.nn.Module, seed: int = 0, device=None) -> dict[tuple, torch.Tensor]:
    """The parameters `flax_module.init(jax.random.key(seed), …)` gives the
    Flax counterpart of `model`, as {Flax path: tensor in Flax's layout}, made
    on `device` (the model's by default)."""
    if device is None:
        device = next(model.parameters()).device
    root = (seed >> 32 & _M32, seed & _M32)
    tree = {}

    def lecun(path, counter, shape, zero=False):
        if zero:
            return torch.zeros(shape, device=device)
        return _lecun_normal(_param_key(root, path, counter), shape, device)

    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, QConv) and mod.precision_mode == "int8_prequant":
            cout, cin, k = mod.weight_q.shape
            tree[path + ("kernel_q",)] = torch.zeros((k, cin, cout), dtype=torch.int8,
                                                     device=device)
            tree[path + ("scale",)] = torch.ones(cout, device=device)
        elif isinstance(mod, QConv):
            cout, cin, k = mod.weight.shape
            tree[path + ("kernel",)] = lecun(path, 1, (k, cin, cout), mod.zero_init)
        elif isinstance(mod, ConvTransposeParams):
            cin, cout, k = mod.weight.shape
            tree[path + ("kernel",)] = lecun(path, 1, (k, cin, cout))
        elif isinstance(mod, Dense):
            dout, din = mod.weight.shape
            tree[path + ("kernel",)] = lecun(path, 1, (din, dout), mod.zero_init)
        elif isinstance(mod, GroupNormParams):  # GroupNorm and LayerNorm
            tree[path + ("scale",)] = torch.ones(mod.weight.shape, device=device)
        elif isinstance(mod, EmbedAction):
            raise NotImplementedError("Flax's init of EmbedAction is not reproduced")
        else:
            continue
        tree[path + ("bias",)] = torch.zeros(mod.bias.shape, device=device)
    return tree


def load_tree(model: torch.nn.Module, tree: dict[tuple, torch.Tensor]) -> torch.nn.Module:
    """Load a {Flax path: tensor} tree through weights.load_flax_params; the
    QConvs' amax buffers, which a params tree does not hold, keep their values."""
    nested: dict = {}
    for path, value in tree.items():
        node = nested
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value.cpu().numpy()
    missing, unexpected = model.load_state_dict(load_flax_params({"params": nested}),
                                                strict=False)
    missing = [k for k in missing if not k.endswith(".amax")]
    if missing or unexpected:
        raise KeyError(f"tree does not match the model: missing {missing[:3]}, "
                       f"unexpected {unexpected[:3]}")
    return model


def perturb(tree: dict[tuple, torch.Tensor], seed: int = 11, scale: float = 0.02) -> None:
    """bench.verify_trajectory's perturbation: every leaf, in
    jax.tree_util.tree_flatten's order (paths sorted), plus
    f32(scale * default_rng(seed).standard_normal(shape)); in place."""
    prng = np.random.default_rng(seed)
    for path in sorted(tree):
        leaf = tree[path]
        noise = (scale * prng.standard_normal(tuple(leaf.shape))).astype(np.float32)
        leaf.add_(torch.from_numpy(noise).to(leaf.device))


# --------------------------------------------------------------------------- #
# bench.py's models and programs
# --------------------------------------------------------------------------- #
def _float_last_k() -> int:
    return int(os.environ.get("BENCH_FLOAT_LAST_K", "250"))


def build_bench_model(which: str, B: int, device="cuda", *, calibrate: bool = True,
                      perturbed: bool = False):
    """(model, y, obs_x0, obs_mask, label): bench.py's model with its Flax
    initialisation (plus verify_trajectory's perturbation if `perturbed`), in
    float32, on `device`, and bench.py's inputs from default_rng(0). The
    int8_static models are calibrated as bench.py calibrates them (five
    dynamic-int8 passes at t = 999 … 0) unless `calibrate` is False."""
    from condmdi_tpu_torch.ops.quant import calibration

    if which not in BENCH_MODELS:
        raise ValueError(f"unknown bench model {which!r}; one of {BENCH_MODELS}")
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    y = {"text_embed": torch.from_numpy(rng.standard_normal((B, 512)).astype(np.float32)).to(dev)}
    obs_x0 = obs_mask = None
    if which.startswith("mdm"):
        from condmdi_tpu_torch.models.mdm import MDM

        model = MDM(njoints=F, latent_dim=512, ff_size=1024, num_layers=8, num_heads=4,
                    precision_mode="int8" if which == "mdm_int8" else "float", device=dev,
                    seed=None)
        label = "MDM transformer encoder (fused attention)" + (
            " int8" if which == "mdm_int8" else "")
        mode = "float"
    else:
        from condmdi_tpu_torch.models.unet import MDM_UNET

        mode = UNET_MODES[which]
        model = MDM_UNET(njoints=F, latent_dim=512, dim_mults=(2, 2, 2, 2),
                         keyframe_conditioned=True,
                         pad_frames_to=int(os.environ.get("BENCH_PAD", "200")),
                         precision_mode=mode, device=dev, seed=None)
        obs_x0 = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32) * 0.1).to(dev)
        obs_mask = torch.zeros((B, T, F), dtype=torch.bool, device=dev)
        obs_mask[:, ::10, :] = True
        label = "CondMDI UNet-XL keyframe-conditioned" + {
            "int8": " int8 serving path",
            "int8_static": " int8 static-scale serving path",
            "int8_static_pc": " int8 per-channel-static serving path",
            "float": " bf16",
        }[mode]
        if which == "unet_int8_mixed":
            label = ("CondMDI UNet-XL keyframe-conditioned int8 mixed-step serving path "
                     f"(last {_float_last_k()} steps float)")
    tree = flax_params(model, 0, dev)
    if perturbed:
        perturb(tree)
    load_tree(model, tree)
    del tree
    model.requires_grad_(False).eval()
    if mode.startswith("int8_static") and calibrate:
        kw = dict(obs_x0=obs_x0, obs_mask=obs_mask)
        with torch.no_grad(), calibration(model):
            for tv in (999, 750, 500, 250, 0):
                x_t = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32)).to(dev)
                model(x_t, torch.full((B,), tv, device=dev), y, **kw)
    return model, y, obs_x0, obs_mask, label


@contextlib.contextmanager
def _full_f32():
    """float32 products in full float32 on the card (no TF32), as the JAX
    check forces 'highest' precision."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def verify_trajectory(which: str, B: int = 2, n_steps: int = 20, device="cuda") -> np.ndarray:
    """Deterministic float32 respaced-DDIM final sample of the bench model, the
    (B, 28, 21) slice that tests/golden/bench_traj_*.json holds: bench.py's
    weights perturbed as bench.py perturbs them, the static scales
    recalibrated on three dynamic-int8 passes, noise from default_rng(7)."""
    from condmdi_tpu_torch.diffusion import (
        DiffusionConfig, DiffusionSchedule, SamplerConfig, ddim_sample_loop,
        get_named_beta_schedule,
    )
    from condmdi_tpu_torch.ops.quant import _amax_buffers, calibration

    dev = resolve_device(device)
    model, y, obs_x0, obs_mask, _ = build_bench_model(which, B, dev, calibrate=False,
                                                      perturbed=True)
    kw = dict(obs_x0=obs_x0, obs_mask=obs_mask) if obs_x0 is not None else {}
    amax = _amax_buffers(model)
    with _full_f32(), torch.no_grad():
        if amax:
            # perturbed weights shift activation magnitudes: recalibrate from zero
            for b in amax:
                b.zero_()
            with calibration(model):
                for i in range(3):
                    x_cal = np.random.default_rng(50 + i).standard_normal((B, T, F))
                    x_cal = torch.from_numpy(x_cal.astype(np.float32)).to(dev) * (1.0 - 0.4 * i)
                    model(x_cal, torch.full((B,), i * 400, device=dev), y, **kw)
        sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 1000),
                                         use_timesteps=range(0, 1000, 1000 // n_steps)).to(dev)
        noise = np.random.default_rng(7).standard_normal((B, T, F)).astype(np.float32)
        out = ddim_sample_loop(lambda x, t: model(x, t, y, **kw), sched, DiffusionConfig(),
                               (B, T, F), noise=torch.from_numpy(noise).to(dev),
                               sampler=SamplerConfig(method="ddim"))
    return out.cpu().numpy()[:, ::7, ::13].astype(np.float64)


def golden_name(which: str) -> str:
    """Golden family of a bench model: int8 variants verify against the float
    golden; a BENCH_PAD other than 224 has its own UNet golden."""
    fam = which.split("_int8")[0] if "int8" in which else which
    pad = os.environ.get("BENCH_PAD", "200")
    if pad != "224" and not fam.startswith("mdm"):
        fam += f"_pad{pad}"
    return fam


def check_against_golden(which: str, slice_: np.ndarray, atol: float):
    """(ok, err) against the committed CPU golden; (None, None) if there is
    none. Float models: max |Δ| <= atol. int8 models against their float
    family's golden: mean |Δ| / mean |golden| <= 0.10."""
    path = GOLDEN_PATH.format(which=golden_name(which))
    if not os.path.exists(path):
        return None, None
    with open(path) as f:
        golden = np.asarray(json.load(f)["slice"])
    if golden.shape != slice_.shape:
        return False, float("inf")
    if "int8" in which:
        err = float(np.abs(golden - slice_).mean() / (np.abs(golden).mean() + 1e-8))
        return bool(err <= 0.10), err
    err = float(np.max(np.abs(golden - slice_)))
    return bool(err <= atol), err


def build_run(which: str, B: Optional[int] = None, device="cuda"):
    """(run, label): bench.py's 1000-step cosine DDPM program over the bench
    model in bfloat16 (weights only; the calibrated amaxes stay float32),
    `run(generator)` → float32 samples [B, 196, 263]. `unet_int8_mixed` runs
    the int8_static model for model timesteps >= BENCH_FLOAT_LAST_K and its
    float twin below."""
    from condmdi_tpu_torch.diffusion import (
        DiffusionConfig, DiffusionSchedule, ddpm_sample_loop, get_named_beta_schedule,
    )
    from condmdi_tpu_torch.models.unet import MixedStepDenoiser, cast_weights

    B = int(os.environ.get("BENCH_BATCH", "128")) if B is None else B
    dev = resolve_device(device)
    model, y, obs_x0, obs_mask, label = build_bench_model(which, B, dev)
    cast_weights(model, torch.bfloat16)
    apply = MixedStepDenoiser(model, _float_last_k()) if which == "unet_int8_mixed" else model
    kw = {} if obs_x0 is None else dict(obs_x0=obs_x0.to(torch.bfloat16), obs_mask=obs_mask)
    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 1000)).to(dev)

    def denoise(x_t, t):
        return apply(x_t.to(torch.bfloat16), t, y, **kw).float()

    def run(generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            return ddpm_sample_loop(denoise, sched, DiffusionConfig(), (B, T, F),
                                    generator=generator)

    return run, label
