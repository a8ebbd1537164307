"""Checkpoints of the port's training, EMA-preferred parameter selection, and
the reference's PyTorch checkpoints converted to a Flax parameter tree.

Training writes two files per save into its save_dir:
  * `ckpt_{step:09d}.pth` (torch.save): the step, the model's parameters,
    the EMA, the optimizer's state (moments and count), the loss-aware
    sampler, the random generators' states and the data stream's position,
    everything a run needs to resume exactly; the suffix is not `.pt`, which
    the samplers read as a reference checkpoint;
  * `ema_{step:09d}.npz`: the EMA parameters as a flat "//"-keyed Flax tree
    (weights.to_flax_params) tagged with `__params_fingerprint__` and
    `__step__`, the format of the committed
    save/synthetic_unet_m/gate_ema_000100000.npz, which the port's CLIs and
    evals.run take as --model_path (args.json sits beside it).

Counterpart of condmdi_tpu/utils/checkpoint.py for `select_eval_params`,
`params_fingerprint`, `convert_mdm_state_dict`, `convert_unet_state_dict` and
`load_torch_checkpoint` (plain numpy, copied here so that the port imports
nothing of the JAX package). The tree they give goes through
`weights.load_flax_params` into the port's modules. Orbax checkpoints need the
JAX package: export one to a flat npz (scripts/gate_params_io.py) to sample it
with the port.
"""

from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


# --------------------------------------------------------------------------- #
# The port's training checkpoints
# --------------------------------------------------------------------------- #
def _atomic_write(path: Path, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=path.suffix + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def save_checkpoint(save_dir: str | Path, step: int, state: dict,
                    ema_params: Optional[dict] = None) -> Path:
    """Write `ckpt_{step:09d}.pth` (the whole `state`) and, when `ema_params`
    (a {"params": Flax tree}) is given, `ema_{step:09d}.npz` beside it.
    Returns the resume file's path."""
    from condmdi_tpu_torch.weights import flatten_flax_params

    save_dir = Path(save_dir).absolute()
    save_dir.mkdir(parents=True, exist_ok=True)
    path = save_dir / f"ckpt_{step:09d}.pth"
    _atomic_write(path, lambda f: torch.save(state, f))
    if ema_params is not None:
        flat = flatten_flax_params(ema_params)
        # uncompressed: float weights barely compress, and zlib over UNet-XL's 0.8 GB
        # took most of a save
        _atomic_write(save_dir / f"ema_{step:09d}.npz", lambda f: np.savez(
            f, __params_fingerprint__=np.array(params_fingerprint(ema_params)),
            __step__=np.array(step, np.int64), **flat))
    return path


def load_checkpoint(path: str | Path, map_location="cpu") -> dict:
    """The state a `save_checkpoint` wrote (it holds numpy generator states, so
    it is loaded with weights_only=False: load only checkpoints you wrote)."""
    return torch.load(Path(path), map_location=map_location, weights_only=False)


def latest_checkpoint(save_dir: str | Path) -> Optional[Path]:
    """The resume file of the highest step in save_dir, or None."""
    save_dir = Path(save_dir)
    if not save_dir.is_dir():
        return None
    ckpts = sorted(save_dir.glob("ckpt_*.pth"))
    return ckpts[-1] if ckpts else None


def parse_step_from_checkpoint(path: str | Path) -> int:
    m = re.search(r"(?:ckpt_|ema_|model)(\d+)", Path(path).name)
    return int(m.group(1)) if m else 0


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


def _flat_leaves(tree, prefix=()):
    """{path tuple: leaf} of a nested mapping, or of a mapping already keyed by
    path tuples."""
    out = {}
    for k, v in tree.items():
        path = prefix + (tuple(k) if isinstance(k, tuple) else (k,))
        if isinstance(v, dict):
            out.update(_flat_leaves(v, path))
        else:
            out[path] = v
    return out


def params_fingerprint(params: Any) -> str:
    """Stable content hash of a Flax parameter tree, the JAX package's hex for
    the same parameters.

    `params` is a nested dict (or a dict keyed by path tuples) of numpy arrays
    or tensors in Flax's layout, e.g. the `{"params": ...}` tree of a flat npz
    (`weights.read_params`). sha256 over the leaves in the order of their
    `jax.tree_util.keystr` paths ("['params']['unet']…"), each adding its path,
    str(shape) and raw bytes, floats cast to float32 first; the first 16 hex
    digits. Eval reports record it so that a report names the weights that
    made it.
    """
    import hashlib

    def keystr(path):
        return "".join(f"[{k!r}]" for k in path)

    h = hashlib.sha256()
    for path, leaf in sorted(_flat_leaves(params).items(), key=lambda kv: keystr(kv[0])):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().float() if leaf.is_floating_point() else leaf.detach()
            leaf = leaf.cpu().numpy()
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        h.update(keystr(path).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


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
