"""Dataset asset discovery (normalization stats, skeleton example) and the asset table.

Counterpart of condmdi_tpu/utils/assets.py (plain numpy, copied so that the
port imports nothing of the JAX package), and the port's one home of
`NormStats`. The reference ships per-dataset mean/std files
(dataset/t2m_mean.npy, dataset/HumanML3D_abs/{Mean,Std}_abs_3d.npy, the
000021.npy skeleton example; README + prepare/*.sh download the rest).
Assets are searched in $CONDMDI_ASSETS, then ./dataset (the JAX package also
searches a mounted copy of the reference repository).

`check_assets` reports which asset groups are present; `fetch_assets` and
the command line (`python -m condmdi_tpu_torch.utils.assets --check` /
`--fetch [GROUP ...]` / `--dry_run`) download them with the reference's
commands, which need network access and gdown/wget.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

_CANDIDATES = (
    os.environ.get("CONDMDI_ASSETS", ""),
    "dataset",
)


def find_assets_dir() -> Optional[Path]:
    for c in _CANDIDATES:
        if c and Path(c).is_dir():
            return Path(c)
    return None


@dataclass(frozen=True)
class NormStats:
    mean: np.ndarray  # [263]
    std: np.ndarray  # [263]

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return x * self.std + self.mean


def load_norm_stats(kind: str = "abs3d", assets: Optional[Path] = None) -> NormStats:
    """kind: 'abs3d' (HumanML3D_abs Mean/Std_abs_3d), 't2m' (evaluator norms), 'kit'.

    Falls back to zeros/ones stats (identity transform), with a warning, when
    the files are absent, so the pipeline stays runnable without assets.
    """
    assets = assets or find_assets_dir()
    dim = 251 if kind == "kit" else 263
    if assets is not None:
        try:
            if kind == "abs3d":
                mean = np.load(assets / "HumanML3D_abs" / "Mean_abs_3d.npy")
                std = np.load(assets / "HumanML3D_abs" / "Std_abs_3d.npy")
            elif kind == "t2m":
                mean = np.load(assets / "t2m_mean.npy")
                std = np.load(assets / "t2m_std.npy")
            elif kind == "kit":
                mean = np.load(assets / "kit_mean.npy")
                std = np.load(assets / "kit_std.npy")
            else:
                raise ValueError(kind)
            return NormStats(mean.astype(np.float32), std.astype(np.float32))
        except FileNotFoundError:
            pass
    import warnings

    warnings.warn(
        f"normalization stats for kind={kind!r} not found (searched "
        f"{[c for c in _CANDIDATES if c]}) — falling back to IDENTITY stats "
        "(mean=0, std=1). Generated motions will be wrongly scaled unless the "
        "model was also trained with identity stats. `check_assets()` reports "
        "the asset status.",
        stacklevel=2,
    )
    return NormStats(np.zeros(dim, np.float32), np.ones(dim, np.float32))


def load_skeleton_example(assets: Optional[Path] = None) -> Optional[np.ndarray]:
    """000021.npy — the reference pose used to derive FK bone offsets."""
    assets = assets or find_assets_dir()
    if assets is None:
        return None
    p = assets / "000021.npy"
    if not p.exists():
        return None
    data = np.load(p)
    return data.reshape(len(data), -1, 3)


# --------------------------------------------------------------------------- #
# The asset groups (reference prepare/*.sh, declarative)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Asset:
    """One downloadable asset group (reference prepare/download_*.sh)."""

    name: str
    description: str
    check_paths: tuple  # paths (relative to repo root) proving presence
    commands: tuple  # shell commands that fetch + unpack it
    manual: str = ""  # non-empty: cannot be scripted; human instructions


ASSETS = (
    Asset(
        name="glove",
        description="GloVe word vectors (used by the T2M evaluators)",
        check_paths=("glove/our_vab_data.npy", "glove/our_vab_idx.pkl", "glove/our_vab_words.pkl"),
        commands=(
            "gdown --fuzzy https://drive.google.com/file/d/1cmXKUT31pqd7_XpJAiWEo1K81TMYHA5n/view?usp=sharing",
            "unzip -o glove.zip && rm glove.zip",
        ),
    ),
    Asset(
        name="smpl",
        description="SMPL body-model files (rendering + rot2xyz)",
        check_paths=("body_models/smpl/SMPL_NEUTRAL.pkl",),
        commands=(
            "mkdir -p body_models && cd body_models && "
            "gdown 'https://drive.google.com/uc?id=1INYlGA76ak_cKGzvpOV2Pe6RkYTlXTW2' && "
            "unzip -o smpl.zip && rm smpl.zip",
        ),
    ),
    Asset(
        name="t2m_evaluators",
        description="T2M evaluator checkpoints (FID / R-precision nets)",
        check_paths=("t2m/text_mot_match/model/finest.tar",),
        commands=(
            "gdown --fuzzy https://drive.google.com/file/d/1DSaKqWX2HlwBtVH5l7DdW96jeYUIXsOP/view && "
            "unzip -o t2m.zip && rm t2m.zip",
            "gdown --fuzzy https://drive.google.com/file/d/1tX79xk0fflp07EZ660Xz1RAFE33iEyJR/view && "
            "unzip -o kit.zip && rm kit.zip",
        ),
    ),
    Asset(
        name="a2m_recognition",
        description="Action-recognition models for HumanAct12/UESTC evals",
        check_paths=("assets/actionrecognition/humanact12_gru.tar",),
        commands=(
            "mkdir -p assets/actionrecognition && cd assets/actionrecognition && "
            "wget https://raw.githubusercontent.com/EricGuo5513/action-to-motion/master/model_file/action_recognition_model_humanact12.tar -O humanact12_gru.tar",
            "cd assets/actionrecognition && "
            "gdown 'https://drive.google.com/uc?id=1bSSD69s1dHY7Uk0RGbGc6p7uhUxSDSBK'",
        ),
    ),
    Asset(
        name="a2m_datasets",
        description="HumanAct12 + UESTC (VIBE) pose datasets",
        check_paths=("dataset/HumanAct12Poses/humanact12poses.pkl",),
        commands=(
            "mkdir -p dataset && cd dataset && "
            "gdown 'https://drive.google.com/uc?id=1130gHSvNyJmii7f6pv5aY5IyQIWc3t7R' && "
            "tar xfzv HumanAct12Poses.tar.gz && rm HumanAct12Poses.tar.gz",
            "cd dataset && "
            "gdown 'https://drive.google.com/uc?id=1LE-EmYNzECU8o7A2DmqDKtqDMucnSJsy' && "
            "tar xjvf uestc.tar.bz2 && rm uestc.tar.bz2",
        ),
    ),
    Asset(
        name="models",
        description="Released CondMDI model checkpoints (README.md:116-122)",
        check_paths=("save/condmdi_randomframes/model000750000.pt",),
        commands=(
            "mkdir -p save && cd save && "
            "gdown --fuzzy https://drive.google.com/file/d/15mYPp2U0VamWfu1SnwCukUUHczY9RPIP/view?usp=sharing && "
            "unzip -o condmdi_randomframes.zip && rm condmdi_randomframes.zip",
            "cd save && "
            "gdown --fuzzy https://drive.google.com/file/d/1aP-z1JxSCTcUHhMqqdL2wbwQJUZWHT2j/view?usp=sharing && "
            "unzip -o condmdi_randomjoints.zip && rm condmdi_randomjoints.zip",
            "cd save && "
            "gdown --fuzzy https://drive.google.com/file/d/1B0PYpmCXXwV0a5mhkgea_J2pOwhYy-k5/view?usp=sharing && "
            "unzip -o condmdi_uncond.zip && rm condmdi_uncond.zip",
        ),
    ),
    Asset(
        name="clip",
        description="CLIP ViT-B/32 checkpoint (text conditioning)",
        check_paths=("save/clip/ViT-B-32.pt",),
        commands=(
            "mkdir -p save/clip && "
            "wget https://openaipublic.azureedge.net/clip/models/"
            "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt "
            "-O save/clip/ViT-B-32.pt",
        ),
    ),
    Asset(
        name="humanml3d",
        description="HumanML3D dataset (263-dim features, abs-root variant)",
        check_paths=("dataset/HumanML3D/Mean.npy", "dataset/HumanML3D_abs/Mean_abs_3d.npy"),
        commands=(),
        manual=(
            "HumanML3D is built from AMASS (license-gated): follow "
            "https://github.com/EricGuo5513/HumanML3D, then copy "
            "HumanML3D/ into ./dataset/ and run the reference's abs-root "
            "conversion to produce dataset/HumanML3D_abs."
        ),
    ),
)


def check_assets(root: str | Path = ".") -> dict:
    """Status of every asset group: {name: {'present': bool, 'missing': [...]}}"""
    root = Path(root)
    out = {}
    for a in ASSETS:
        missing = [p for p in a.check_paths if not (root / p).exists()]
        out[a.name] = {"present": not missing, "missing": missing}
    return out


def fetch_assets(names=None, root: str | Path = ".", dry_run: bool = False) -> bool:
    """Run the download commands of the named asset groups (default: every one
    that is missing). True if everything asked for is present afterwards.

    Needs network access and gdown/wget; without them each group fails loudly
    and the others are still tried.
    """
    import subprocess

    root = Path(root)
    status = check_assets(root)
    todo = [a for a in ASSETS if (names is None or a.name in names)]
    ok = True
    for a in todo:
        if status[a.name]["present"]:
            print(f"[assets] {a.name}: already present")
            continue
        if a.manual:
            print(f"[assets] {a.name}: MANUAL — {a.manual}")
            ok = False
            continue
        for cmd in a.commands:
            print(f"[assets] {a.name}: $ {cmd}")
            if dry_run:
                continue
            r = subprocess.run(cmd, shell=True, cwd=root)
            if r.returncode != 0:
                print(f"[assets] {a.name}: FAILED (rc={r.returncode}) — "
                      "check network access / gdown availability")
                ok = False
                break
    final = check_assets(root)
    for a in todo:
        state = "present" if final[a.name]["present"] else "MISSING"
        print(f"[assets] {a.name}: {state}")
        ok = ok and (final[a.name]["present"] or bool(dry_run))
    return ok


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Asset bootstrap (port of reference prepare/*.sh)")
    ap.add_argument("--check", action="store_true", help="print asset status")
    ap.add_argument("--fetch", nargs="*", metavar="GROUP",
                    help="download asset groups (no names = all missing)")
    ap.add_argument("--dry_run", action="store_true",
                    help="print the commands without running them")
    ap.add_argument("--root", default=".", help="repo root to place assets in")
    ns = ap.parse_args(argv)

    if ns.fetch is not None:
        names = ns.fetch or None
        known = {a.name for a in ASSETS}
        bad = set(names or ()) - known
        if bad:
            ap.error(f"unknown asset group(s) {sorted(bad)}; known: {sorted(known)}")
        return 0 if fetch_assets(names, ns.root, dry_run=ns.dry_run) else 1

    status = check_assets(ns.root)
    width = max(len(a.name) for a in ASSETS)
    for a in ASSETS:
        st = status[a.name]
        mark = "ok     " if st["present"] else "MISSING"
        print(f"{a.name:<{width}}  {mark}  {a.description}")
        for m in st["missing"]:
            print(f"{'':<{width}}           missing: {m}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
