"""The diffusion train step in plain PyTorch: the x0 loss (keyframe-conditioned
where the draws hold a keyframe mask), its gradient, optax's global-norm clip
and AdamW (decoupled weight decay), from the same batch and the same draws as
the program's step, over the configuration's reference model
(`benchmark/reference/<reference>.py`'s `Model`).

Per step: x_t = q_sample(x0, t, noise); the observation mask is the drawn
keyframe mask, dropped for a sample where `drop`, inside the valid frames;
the text is zeroed where the condition-dropout draw says so; the loss is the
mean over the batch of each sample's mean squared x0 error over its valid
frames and the features. Everything is float32 but what `use_fp16` rounds to
bfloat16, as the configuration states it: the model's input (x_t and the
keyframes) and the text, and what the model's `bf16_input` rounds after them.
"""

from __future__ import annotations

import importlib
import math

import torch

from benchmark.reference.diffusion import Schedule
from benchmark.reference.precision import Precision


def loss_fn(model, sched: Schedule, batch: dict, draws: dict):
    x0, time_mask = batch["motion"], batch["time_mask"]
    t, noise = draws["t"], draws["noise"]
    obs_mask = None
    if draws.get("mask") is not None:
        obs_mask = draws["mask"] & time_mask[..., None]
        if draws.get("drop") is not None:
            obs_mask = obs_mask & ~draws["drop"]
    x_t = sched.q_sample(x0, t, noise)
    out = model(x_t, t, batch["text_embed"], ~draws["keep"][:, 0], x0, obs_mask)
    m = time_mask.float()
    per = ((out - x0) ** 2).mean(dim=-1)
    per = (per * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-8)
    return per.mean()


def train_steps(P0: dict, cfg: dict, tcfg: dict, batches: list, draws: list,
                prec: Precision = Precision("f32"), loss_fn=loss_fn):
    """Steps from P0 (float32 leaves) over `batches`/`draws`; returns (losses, the
    first step's clipped gradient norm per leaf, the change of each leaf after
    all the steps, the leaves' names in order)."""
    names = list(P0)
    params = {k: v.detach().float().clone().requires_grad_(True) for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    sched = Schedule(cfg["diffusion_steps"], next(iter(P0.values())).device)
    lr, wd, b1, b2, eps = tcfg["lr"], tcfg["weight_decay"], 0.9, tcfg["adam_beta2"], 1e-8
    losses, first_norms = [], None
    reference = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    model = reference.Model(params, cfg, prec, bf16_input=bool(tcfg.get("use_fp16")))
    with prec.products():
        for k, (batch, dr) in enumerate(zip(batches, draws), start=1):
            loss = loss_fn(model, sched, batch, dr)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            losses.append(float(loss.detach()))
            gnorm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads)).float()
            scale = torch.where(gnorm < tcfg["grad_clip"], torch.ones_like(gnorm),
                                tcfg["grad_clip"] / gnorm)
            grads = [g * scale for g in grads]
            if k == 1:
                first_norms = [float(g.norm()) for g in grads]
            with torch.no_grad():
                bc1, bc2 = 1 - b1 ** k, 1 - b2 ** k
                for n, g in zip(names, grads):
                    p = params[n]
                    p.mul_(1 - lr * wd)
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v2[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = v2[n].sqrt() / math.sqrt(bc2) + eps
                    p.addcdiv_(m[n], denom, value=-lr / bc1)
    change = [float((params[n].detach() - P0[n].float()).norm()) for n in names]
    return losses, first_norms, change, names
