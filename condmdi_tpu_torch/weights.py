"""Flax parameter tree → this package's state_dict.

The inverse of condmdi_tpu/utils/checkpoint.py's torch→Flax helpers. The
port keeps the Flax module names, so a Flax path maps to a state_dict key by
joining with '.' and renaming the leaf; the values go through one of a few
layout transforms:

  Dense kernel          [in, out]        → weight [out, in] (no bias where
                                           Flax's `use_bias=False`)
  Conv kernel           [k, Cin, Cout]   → weight [Cout, Cin, k] (grouped:
                                           [k, Cin/groups, Cout] → [Cout, Cin/groups, k])
  ConvTranspose kernel  [k, in, out]     → weight [in, out, k], flipped along k
                                           (Flax correlates, torch's
                                           ConvTranspose1d takes the conv's
                                           gradient)
  GroupNorm / LayerNorm scale/bias       → weight/bias
  EmbedAction action_embedding           → kept as it is ([num_actions, D])
  ChannelLayerNorm g / b                 → kept as they are
  CLIP token_embedding, positional_embedding, text_projection → kept as they are
  int8_prequant QConv kernel_q [k, Cin, Cout] int8, scale [Cout]
                                         → weight_q [Cout, Cin, k] int8,
                                           weight_scale (not a norm's weight)
  act_scale collection amax              → the QConv's amax buffer

One function serves the UNet, MDM (with its GRU cells) and DiT families. `to_flax_params` is its
inverse for float models: a state_dict back to the Flax tree, which the
training loop writes as a flat npz and the JAX model can load.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

_SEP = "//"  # the flat npz's path joiner (scripts/gate_params_io.py)
# leaves whose name and layout the port keeps (CLIP's three raw tensors among them)
_KEPT = ("bias", "action_embedding", "g", "b", "token_embedding", "positional_embedding",
         "text_projection")


def _flatten(tree: Mapping[str, Any], prefix=()) -> dict[tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def read_params(source) -> dict[tuple[str, ...], np.ndarray]:
    """Flat {path tuple: array} from a nested tree or a flat '//'-keyed npz
    (without the npz's `__…__` entries)."""
    if isinstance(source, (str, os.PathLike)):
        with np.load(source, allow_pickle=False) as z:
            return {tuple(k.split(_SEP)): z[k] for k in z.files if not k.startswith("__")}
    return _flatten(source)


def _convert(path: tuple[str, ...], arr: np.ndarray, prequant: bool) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel_q":  # an int8_prequant QConv's codes, kept int8
        return "weight_q", arr.transpose(2, 1, 0)
    if leaf == "kernel":
        if arr.ndim == 2:  # Dense
            return "weight", arr.T
        if mods[-1].endswith("_upsample"):  # ConvTranspose
            return "weight", arr[::-1].transpose(1, 2, 0)
        return "weight", arr.transpose(2, 1, 0)  # Conv
    if leaf == "scale":  # beside kernel_q: the weight scale; else GroupNorm, LayerNorm
        return ("weight_scale" if prequant else "weight"), arr
    if leaf in _KEPT:
        return leaf, arr
    raise KeyError(f"no port layout for Flax parameter {'/'.join(path)}")


def load_flax_params(source) -> dict[str, torch.Tensor]:
    """state_dict for the port's MDM_UNET, MDM or MDM_DiT from Flax variables.

    `source` is a nested Flax param dict of numpy arrays (with or without
    the top-level "params" key, and with an "act_scale" collection beside
    it, whose `amax` leaves become the QConvs' amax buffers), or the path of
    a flat npz whose keys are "params//…" paths (as
    scripts/gate_params_io.py exports them; its
    `__params_fingerprint__`/`__step__` entries are skipped). Floating
    arrays become float32; the int8 codes of an int8_prequant tree
    (`kernel_q`) stay int8, and the `scale` beside them becomes
    `weight_scale`.
    """
    flat = {}
    for path, arr in read_params(source).items():
        if path[0] == "act_scale":
            flat[path[1:-1] + ("amax",)] = arr
        else:
            flat[path[1:] if path[0] == "params" else path] = arr
    prequant = {path[:-1] for path in flat if path[-1] == "kernel_q"}
    sd = {}
    for path, arr in flat.items():
        if path[-1] == "amax":
            sd[".".join(path)] = torch.from_numpy(np.array(arr, dtype=np.float32))
            continue
        leaf, value = _convert(path, arr, path[:-1] in prequant)
        key = ".".join(path[:-1] + (leaf,))
        dtype = np.int8 if leaf == "weight_q" else np.float32
        sd[key] = torch.from_numpy(np.array(value, dtype=dtype))
    return sd


def _to_flax(key: str, value: np.ndarray) -> tuple[tuple[str, ...], np.ndarray]:
    *mods, leaf = key.split(".")
    if leaf == "weight":
        if value.ndim == 2:  # Dense
            return tuple(mods) + ("kernel",), value.T
        if value.ndim == 3 and mods[-1].endswith("_upsample"):  # ConvTranspose
            return tuple(mods) + ("kernel",), value.transpose(2, 0, 1)[::-1]
        if value.ndim == 3:  # Conv
            return tuple(mods) + ("kernel",), value.transpose(2, 1, 0)
        return tuple(mods) + ("scale",), value  # GroupNorm / LayerNorm
    if leaf in _KEPT:
        return tuple(mods) + (leaf,), value
    raise KeyError(f"no Flax layout for the port's parameter {key} (float models only)")


def to_flax_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """{"params": nested Flax tree of float32 numpy arrays} from a float model's
    parameters (`model.state_dict()`, or any {name: tensor} of its parameters):
    the inverse of `load_flax_params`."""
    tree: dict = {}
    for key, tensor in state_dict.items():
        value = tensor.detach().float().cpu().numpy()
        path, arr = _to_flax(key, value)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr, dtype=np.float32)
    return {"params": tree}


def flatten_flax_params(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """The flat npz's {'params//a//b//kernel': array} form of a nested tree."""
    return {_SEP.join(path): arr for path, arr in _flatten(tree).items()}


def smpl_model_from_arrays(arrays: Mapping[str, Any], device="cuda"):
    """A body model from the JAX package's SMPLModel fields as numpy arrays
    ({field name: array}; the same layout, so only the type changes), on `device`."""
    from condmdi_tpu_torch.models.smpl import SMPLModel

    return SMPLModel.from_arrays(dict(arrays), device)
