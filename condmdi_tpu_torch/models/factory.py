"""Model + diffusion factory from an args dataclass.

Counterpart of condmdi_tpu/models/factory.py (reference
utils/model_util.py:26, :40, :122). Arch dispatch: 'dit*' → MDM_DiT, 'unet*' →
MDM_UNET, else MDM. Dataset table: humanml → 263×1 text-conditioned; kit →
251×1; humanact12/uestc → action-conditioned 25×6; traj_only → 4×1.

`create_model` builds the module on `device` with its parameters allocated
and not filled, as the JAX factory returns a module without parameters: the
caller loads a checkpoint, or Flax's initialisation from a seed
(`models.flax_init.load_flax_init`). The modules take `cond_mask_prob` (and
the transformers their default dropout of 0.1, as the Flax modules), and
the DiffusionConfig the loss options, as in the JAX factory.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from condmdi_tpu_torch.diffusion.gaussian import (
    DiffusionConfig,
    LossType,
    ModelMeanType,
    ModelVarType,
)
from condmdi_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    get_named_beta_schedule,
    space_timesteps,
)


def get_model_dims(args) -> dict[str, Any]:
    dataset = getattr(args, "dataset", "humanml")
    if dataset == "humanml":
        njoints, nfeats, cond_mode = 263, 1, "text"
    elif dataset == "kit":
        njoints, nfeats, cond_mode = 251, 1, "text"
    elif dataset == "amass":
        njoints, nfeats, cond_mode = 764, 1, "no_cond"
    elif dataset in ("humanact12", "uestc"):
        njoints, nfeats, cond_mode = 25, 6, "action"
    else:
        raise ValueError(f"unknown dataset {dataset}")
    if getattr(args, "traj_only", False):
        njoints, nfeats = 4, 1
    if getattr(args, "unconstrained", False):
        cond_mode = "no_cond"
    return dict(njoints=njoints, nfeats=nfeats, cond_mode=cond_mode)


def create_model(args, device: str | torch.device = "cuda") -> torch.nn.Module:
    """The denoiser module for `args`, on `device` (CUDA unless the caller
    passes "cpu"), its parameters not yet filled."""
    from condmdi_tpu_torch.models.dit import MDM_DiT
    from condmdi_tpu_torch.models.mdm import MDM
    from condmdi_tpu_torch.models.unet import MDM_UNET

    dims = get_model_dims(args)
    arch = args.arch
    if arch.startswith("dit"):
        return MDM_DiT(
            njoints=dims["njoints"], nfeats=dims["nfeats"], latent_dim=args.latent_dim,
            ff_size=args.ff_size, num_layers=args.layers,
            num_heads=getattr(args, "num_heads", 4), cond_mode=dims["cond_mode"], arch=arch,
            cond_mask_prob=args.cond_mask_prob, device=device, seed=None,
        )
    if arch.startswith("unet"):
        return MDM_UNET(
            njoints=dims["njoints"], nfeats=dims["nfeats"], latent_dim=args.latent_dim,
            dim_mults=tuple(args.dim_mults), adagn=args.unet_adagn, zero=args.unet_zero,
            cond_mode=dims["cond_mode"] if not getattr(args, "traj_only", False) else "text",
            keyframe_conditioned=getattr(args, "keyframe_conditioned", False),
            pad_frames_to=int(getattr(args, "unet_pad_to", 224) or 224),
            precision_mode=getattr(args, "precision_mode", "float"),
            cond_mask_prob=args.cond_mask_prob, xz_only=getattr(args, "xz_only", False),
            attention=getattr(args, "unet_attention", False), device=device, seed=None,
        )
    return MDM(
        njoints=dims["njoints"], nfeats=dims["nfeats"], latent_dim=args.latent_dim,
        ff_size=args.ff_size, num_layers=args.layers, num_heads=getattr(args, "num_heads", 4),
        cond_mode=dims["cond_mode"], arch=arch,
        emb_trans_dec=getattr(args, "emb_trans_dec", False),
        precision_mode=getattr(args, "precision_mode", "float"),
        cond_mask_prob=args.cond_mask_prob, out_mult=int(getattr(args, "out_mult", 1) or 1),
        device=device, seed=None,
    )


def create_gaussian_diffusion(args) -> Tuple[DiffusionSchedule, DiffusionConfig]:
    """Schedule + config (reference model_util.py:122: cosine, START_X when
    predict_xstart, FIXED_SMALL when sigma_small, 'ddim100' respacing when
    use_ddim and no respacing is given). The schedule's tables are made on
    the host; SamplePipeline moves them to its device."""
    steps = getattr(args, "diffusion_steps", 1000)
    betas = get_named_beta_schedule(args.noise_schedule, steps)
    respacing = getattr(args, "timestep_respacing", "") or (
        "ddim100" if getattr(args, "use_ddim", False) else ""
    )
    use_timesteps = space_timesteps(steps, respacing) if respacing else None
    sched = DiffusionSchedule.create(betas, use_timesteps=use_timesteps)
    cfg = DiffusionConfig(
        model_mean_type=(
            ModelMeanType.START_X if args.predict_xstart else ModelMeanType.EPSILON
        ),
        model_var_type=(
            ModelVarType.FIXED_SMALL if args.sigma_small else ModelVarType.FIXED_LARGE
        ),
        loss_type=LossType.MSE,
        lambda_rcxyz=getattr(args, "lambda_rcxyz", 0.0),
        lambda_vel=getattr(args, "lambda_vel", 0.0),
        lambda_fc=getattr(args, "lambda_fc", 0.0),
        clip_range=getattr(args, "clip_range", None),
        abs_3d=getattr(args, "abs_3d", False),
        traj_only=getattr(args, "traj_only", False),
        apply_zero_mask=getattr(args, "apply_zero_mask", False),
        traj_extra_weight=getattr(args, "traj_extra_weight", 1.0),
        time_weighted_loss=getattr(args, "time_weighted_loss", False),
        train_x0_as_eps=getattr(args, "train_x0_as_eps", False),
    )
    return sched, cfg



def create_model_and_diffusion(args, device: str | torch.device = "cuda"):
    """(model, sched, cfg): `create_model` on `device` (its parameters not yet
    filled) and `create_gaussian_diffusion`, as the JAX factory returns them."""
    return create_model(args, device), *create_gaussian_diffusion(args)
