"""Checkpoint helpers that need no JAX: EMA-preferred parameter selection and
the reference's PyTorch checkpoints converted to a Flax parameter tree.

Counterpart of condmdi_tpu/utils/checkpoint.py for `select_eval_params`,
`convert_mdm_state_dict`, `convert_unet_state_dict` and
`load_torch_checkpoint` (plain numpy, copied here so that the port imports
nothing of the JAX package). The tree they give goes through
`weights.load_flax_params` into the port's modules. Orbax checkpoints need the
JAX package: export one to a flat npz (scripts/gate_params_io.py) to sample it
with the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch


def select_eval_params(restored: dict, use_ema: bool = True) -> dict:
    """EMA-preferred param selection (reference model_util.py:168-182).

    One source of truth for "which params does an eval of this checkpoint
    use" — shared by the sampling loader and by report-fingerprint checks.
    """
    loaded = (restored.get("ema_params") if use_ema else None) or restored.get(
        "params"
    )
    # training saves the FULL flax variables dict ({'params': ...},
    # training/train.py) — don't wrap it twice
    return loaded if isinstance(loaded, dict) and "params" in loaded else {
        "params": loaded
    }


# --------------------------------------------------------------------------- #
# Torch layout helpers
# --------------------------------------------------------------------------- #
def _t(w: np.ndarray) -> np.ndarray:  # torch Linear [out,in] -> flax [in,out]
    return np.ascontiguousarray(w.T)


def _conv(w: np.ndarray) -> np.ndarray:  # Conv1d [out,in,k] -> flax [k,in,out]
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _convT(w: np.ndarray) -> np.ndarray:
    # ConvTranspose1d [in,out,k] -> flax ConvTranspose (transpose_kernel=False)
    # kernel [k,in,out], FLIPPED along k (torch computes the conv gradient).
    return np.ascontiguousarray(np.transpose(w, (2, 0, 1))[::-1])


def _dense(sd, prefix):
    return {"kernel": _t(sd[f"{prefix}.weight"]), "bias": sd[f"{prefix}.bias"]}


def _norm(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _np(state_dict: dict) -> dict:
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


# --------------------------------------------------------------------------- #
# MDM (trans_enc) converter
# --------------------------------------------------------------------------- #
def convert_mdm_state_dict(sd: dict, num_layers: int = 8) -> dict:
    """Reference MDM (arch=trans_enc) .pt state dict → Flax params tree."""
    sd = _np(sd)
    p: dict[str, Any] = {}
    p["input_process"] = _dense(sd, "input_process.poseEmbedding")
    p["output_process"] = _dense(sd, "output_process.poseFinal")
    p["embed_timestep"] = {
        "fc1": _dense(sd, "embed_timestep.time_embed.0"),
        "fc2": _dense(sd, "embed_timestep.time_embed.2"),
    }
    if "embed_text.weight" in sd:
        p["embed_text"] = _dense(sd, "embed_text")
    if "embed_action.action_embedding" in sd:
        p["embed_action"] = {
            "action_embedding": sd["embed_action.action_embedding"]
        }
    for i in range(num_layers):
        pre = f"seqTransEncoder.layers.{i}"
        p[f"layer{i}"] = {
            "qkv": {
                "kernel": _t(sd[f"{pre}.self_attn.in_proj_weight"]),
                "bias": sd[f"{pre}.self_attn.in_proj_bias"],
            },
            "attn_out": _dense(sd, f"{pre}.self_attn.out_proj"),
            "ff1": _dense(sd, f"{pre}.linear1"),
            "ff2": _dense(sd, f"{pre}.linear2"),
            "norm1": _norm(sd, f"{pre}.norm1"),
            "norm2": _norm(sd, f"{pre}.norm2"),
        }
    return {"params": p}


# --------------------------------------------------------------------------- #
# MDM_UNET converter
# --------------------------------------------------------------------------- #
def _res_block(sd, pre, adagn=True):
    out = {
        "time_mlp": _dense(sd, f"{pre}.time_mlp.1"),
        "block2": {
            "conv": {
                "kernel": _conv(sd[f"{pre}.blocks.1.block.0.weight"]),
                "bias": sd[f"{pre}.blocks.1.block.0.bias"],
            },
            "norm": _norm(sd, f"{pre}.blocks.1.block.2"),
        },
    }
    if adagn:
        out["block1"] = {
            "conv": {
                "kernel": _conv(sd[f"{pre}.blocks.0.block1.0.weight"]),
                "bias": sd[f"{pre}.blocks.0.block1.0.bias"],
            },
            "norm": _norm(sd, f"{pre}.blocks.0.block1.2"),
        }
    else:
        out["block1"] = {
            "conv": {
                "kernel": _conv(sd[f"{pre}.blocks.0.block.0.weight"]),
                "bias": sd[f"{pre}.blocks.0.block.0.bias"],
            },
            "norm": _norm(sd, f"{pre}.blocks.0.block.2"),
        }
    if f"{pre}.residual_conv.weight" in sd:
        out["residual_conv"] = {
            "kernel": _conv(sd[f"{pre}.residual_conv.weight"]),
            "bias": sd[f"{pre}.residual_conv.bias"],
        }
    return out


def convert_unet_state_dict(sd: dict, n_levels: int = 4, adagn: bool = True) -> dict:
    """Reference MDM_UNET .pt state dict → Flax params tree."""
    sd = _np(sd)
    p: dict[str, Any] = {}
    p["embed_timestep"] = {
        "fc1": _dense(sd, "embed_timestep.time_embed.0"),
        "fc2": _dense(sd, "embed_timestep.time_embed.2"),
    }
    if "embed_text.weight" in sd:
        p["embed_text"] = _dense(sd, "embed_text")

    u: dict[str, Any] = {
        "time_fc1": _dense(sd, "unet.time_mlp.0"),
        "time_fc2": _dense(sd, "unet.time_mlp.2"),
    }
    for i in range(n_levels):
        u[f"down{i}_res1"] = _res_block(sd, f"unet.downs.{i}.0", adagn)
        u[f"down{i}_res2"] = _res_block(sd, f"unet.downs.{i}.1", adagn)
        if f"unet.downs.{i}.3.conv.weight" in sd:
            u[f"down{i}_downsample"] = {
                "kernel": _conv(sd[f"unet.downs.{i}.3.conv.weight"]),
                "bias": sd[f"unet.downs.{i}.3.conv.bias"],
            }
    u["mid_block1"] = _res_block(sd, "unet.mid_block1", adagn)
    u["mid_block2"] = _res_block(sd, "unet.mid_block2", adagn)
    n_ups = n_levels - 1
    for i in range(n_ups):
        u[f"up{i}_res1"] = _res_block(sd, f"unet.ups.{i}.0", adagn)
        u[f"up{i}_res2"] = _res_block(sd, f"unet.ups.{i}.1", adagn)
        if f"unet.ups.{i}.3.conv.weight" in sd:
            u[f"up{i}_upsample"] = {
                "kernel": _convT(sd[f"unet.ups.{i}.3.conv.weight"]),
                "bias": sd[f"unet.ups.{i}.3.conv.bias"],
            }
    u["final_block"] = {
        "conv": {
            "kernel": _conv(sd["unet.final_conv.0.block.0.weight"]),
            "bias": sd["unet.final_conv.0.block.0.bias"],
        },
        "norm": _norm(sd, "unet.final_conv.0.block.2"),
    }
    u["final_conv"] = {
        "kernel": _conv(sd["unet.final_conv.1.weight"]),
        "bias": sd["unet.final_conv.1.bias"],
    }
    p["unet"] = u
    return {"params": p}


def load_torch_checkpoint(path: str | Path, arch: str, **kw) -> dict:
    """Load a reference model####.pt and convert it (prefers model_avg,
    model_util.py:168-182)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_avg" in blob:
        sd = blob["model_avg"]
    elif isinstance(blob, dict) and "model" in blob:
        sd = blob["model"]
    else:
        sd = blob
    # strip frozen CLIP weights if present (training_loop.py:404-410)
    sd = {k: v for k, v in sd.items() if not k.startswith("clip_model.")}
    if arch.startswith("unet"):
        return convert_unet_state_dict(sd, **kw)
    return convert_mdm_state_dict(sd, **kw)
