"""Flax parameter tree → this package's state_dict.

The inverse of condmdi_tpu/utils/checkpoint.py's torch→Flax helpers. The
port keeps the Flax module names, so a Flax path maps to a state_dict key by
joining with '.' and renaming the leaf; the values go through one of a few
layout transforms:

  Dense kernel          [in, out]        → weight [out, in]
  Conv kernel           [k, Cin, Cout]   → weight [Cout, Cin, k]
  ConvTranspose kernel  [k, in, out]     → weight [in, out, k], flipped along k
                                           (Flax correlates, torch's
                                           ConvTranspose1d takes the conv's
                                           gradient)
  GroupNorm scale/bias                   → weight/bias
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

_SEP = "//"  # the flat npz's path joiner (scripts/gate_params_io.py)


def _flatten(tree: Mapping[str, Any], prefix=()) -> dict[tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _read(source) -> dict[tuple[str, ...], np.ndarray]:
    """Flat {path tuple: array} from a nested tree or a flat '//'-keyed npz."""
    if isinstance(source, (str, os.PathLike)):
        with np.load(source, allow_pickle=False) as z:
            return {tuple(k.split(_SEP)): z[k] for k in z.files if not k.startswith("__")}
    return _flatten(source)


def _convert(path: tuple[str, ...], arr: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        if arr.ndim == 2:  # Dense
            return "weight", arr.T
        if mods[-1].endswith("_upsample"):  # ConvTranspose
            return "weight", arr[::-1].transpose(1, 2, 0)
        return "weight", arr.transpose(2, 1, 0)  # Conv
    if leaf == "scale":  # GroupNorm
        return "weight", arr
    if leaf == "bias":
        return "bias", arr
    raise KeyError(f"no port layout for Flax parameter {'/'.join(path)}")


def load_flax_params(source) -> dict[str, torch.Tensor]:
    """state_dict for the port's MDM_UNET from Flax params.

    `source` is a nested Flax param dict of numpy arrays (with or without
    the top-level "params" key) or the path of a flat npz whose keys are
    "params//…" paths (as scripts/gate_params_io.py exports them; its
    `__params_fingerprint__`/`__step__` entries are skipped).
    """
    flat = _read(source)
    sd = {}
    for path, arr in flat.items():
        if path[0] == "params":
            path = path[1:]
        leaf, value = _convert(path, arr)
        key = ".".join(path[:-1] + (leaf,))
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return sd
