"""The T2M opt-file parser (reference data_loaders/humanml/utils/get_opt.py:29).

Counterpart of condmdi_tpu/data/get_opt.py, copied so that the port imports
nothing of the JAX package. Parses `dataset/humanml_opt.txt` / `kit_opt.txt`
(the "------------ Options" key: value text of the original text-to-motion
code) into a namespace, with the same derived fields: joint and feature
counts, the data directories (new_joint_vecs, or new_joint_vecs_abs_3d with
use_abs3d outside 'gt' mode, get_opt.py:61) and the $DATA_ROOT override (:62).
"""

from __future__ import annotations

import os
from pathlib import Path
from types import SimpleNamespace

_INT_KEYS = {
    "dim_word", "dim_pos_ohot", "dim_motion_hidden", "max_text_len",
    "dim_text_hidden", "dim_coemb_hidden", "dim_pose", "dim_movement_enc_hidden",
    "dim_movement_latent", "unit_length", "max_motion_length", "batch_size",
    "joints_num",
}
_FLOAT_KEYS = {"lr"}
_BOOL_KEYS = {"is_train", "is_continue"}


def get_opt(opt_path: str | Path, use_abs3d: bool = False, mode: str = "train"):
    opt = SimpleNamespace()
    with open(opt_path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("-") or ":" not in line:
                continue
            key, value = (s.strip() for s in line.split(":", 1))
            if key in _INT_KEYS:
                value = int(value)
            elif key in _FLOAT_KEYS:
                value = float(value)
            elif key in _BOOL_KEYS:
                value = value == "True"
            setattr(opt, key, value)

    opt.dataset_name = getattr(opt, "dataset_name", "t2m")
    data_root = os.environ.get("DATA_ROOT", getattr(opt, "data_root", "./dataset"))
    if opt.dataset_name == "t2m":
        opt.data_root = str(Path(data_root))
        opt.joints_num, opt.dim_pose, opt.max_motion_length = 22, 263, 196
    elif opt.dataset_name == "kit":
        opt.data_root = str(Path(data_root))
        opt.joints_num, opt.dim_pose, opt.max_motion_length = 21, 251, 196
    vec_dir = "new_joint_vecs_abs_3d" if (use_abs3d and mode != "gt") else "new_joint_vecs"
    opt.motion_dir = str(Path(opt.data_root) / vec_dir)
    opt.text_dir = str(Path(opt.data_root) / "texts")
    opt.joint_dir = str(Path(opt.data_root) / "new_joints")
    return opt
