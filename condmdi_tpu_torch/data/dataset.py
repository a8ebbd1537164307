"""The synthetic text-to-motion dataset, its collation, and the HumanML3D guard.

Counterpart of condmdi_tpu/data/dataset.py for `DatasetConfig`,
`synthetic_captions`, `SyntheticMotionDataset` and `collate` (with
`NormStats` from condmdi_tpu/utils/assets.py). The same seeds give the same
items: each item draws from `default_rng((seed, i))`, its captions from
`default_rng((seed, i, 7))`, and `__getitem__` draws its crop and its caption
from the global `np.random` in the same order as JAX. Forward kinematics and
the feature codec run on the device the dataset is given.

The file-backed HumanML3D dataset is not ported (ROADMAP Queue A 8).
`Text2MotionDataset` keeps the JAX package's existence test, so a caller that
falls back to the synthetic set on FileNotFoundError behaves as JAX's does
where the files are absent, and raises NotImplementedError where they are
present instead of quietly serving synthetic data. The disk cache that JAX
keeps for training-size synthetic sets (>= 512 items) waits for the training
slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from condmdi_tpu_torch.device import resolve_device

_STATS_DIR = Path(__file__).resolve().parent


@dataclass
class NormStats:
    mean: np.ndarray  # [263]
    std: np.ndarray  # [263]


@dataclass
class DatasetConfig:
    """The fields of the JAX package's DatasetConfig that the synthetic set and
    the HumanML3D guard read."""

    name: str = "humanml"
    data_dir: str = ""
    split: str = "train"
    max_motion_length: int = 196
    unit_length: int = 4
    abs_3d: bool = False
    traject_only: bool = False


class Text2MotionDataset:
    """The file-backed HumanML3D dataset: not ported yet (ROADMAP Queue A 8).

    Raises FileNotFoundError where the split file is absent, exactly where the
    JAX class does, and NotImplementedError where it is present.
    """

    def __init__(self, cfg: DatasetConfig):
        root = Path(cfg.data_dir or ("./dataset/KIT-ML" if cfg.name == "kit"
                                     else "./dataset/HumanML3D"))
        split_file = root / f"{cfg.split}.txt"
        if not split_file.exists():
            raise FileNotFoundError(
                f"HumanML3D split file {split_file} not found — download the "
                "dataset (reference prepare/*.sh) or use SyntheticMotionDataset"
            )
        raise NotImplementedError(
            f"HumanML3D files found at {root}, but the file-backed Text2MotionDataset is not "
            "ported yet (ROADMAP Queue A 8); move them away to sample on the synthetic set"
        )


# --------------------------------------------------------------------------- #
# Procedural captions for the synthetic population
# --------------------------------------------------------------------------- #
# tertile thresholds of the generative draws (from the U(-0.02,0.02)^2 drift
# and the mean-of-22 U(0.25,0.45) scale distributions)
_SPEED_T = (0.01304, 0.01843)
_SCALE_T = (0.34467, 0.35532)
_SPEED_WORDS = (
    ("slowly", "strolls", "strolling"),
    ("steadily", "walks", "walking"),
    ("quickly", "jogs", "jogging"),
)
_SIZE_WORDS = ("short", "average", "tall")
# 8 compass sectors of atan2(x, z), 0 = +z = "forward"
_DIR_PHRASES = (
    "forward", "forward and right", "right", "backward and right",
    "backward", "backward and left", "left", "forward and left",
)
_POS_TAGS = {
    "a": "DET", "the": "DET", "person": "NOUN", "figure": "NOUN",
    "is": "AUX", "and": "OTHER", "to": "ADP", "while": "OTHER",
    "moving": "VERB", "heading": "VERB",
}


def synthetic_captions(props: dict, rng: np.random.Generator) -> list:
    """Paraphrased captions whose words follow an item's drift direction,
    drift speed and body scale; tokens in the T2M 'word/POS' format."""
    drift, scale = props["drift"], props["scale"]
    speed = float(np.linalg.norm(drift))
    si = int(speed > _SPEED_T[0]) + int(speed > _SPEED_T[1])
    zi = int(scale > _SCALE_T[0]) + int(scale > _SCALE_T[1])
    ang = float(np.degrees(np.arctan2(drift[0], drift[1]))) % 360.0
    di = int(((ang + 22.5) % 360.0) // 45.0)

    adv, verb, gerund = _SPEED_WORDS[si]
    size = _SIZE_WORDS[zi]
    direc = _DIR_PHRASES[di]

    templates = (
        f"a {size} person {verb} {adv} {direc}",
        f"the {size} figure is {gerund} {direc} {adv}",
        f"a {size} person is moving {direc} while {gerund}",
        f"the {size} person {verb} {direc}",
    )
    picks = rng.permutation(len(templates))[:3]  # 3 paraphrases, shuffled per item

    def tokenize(caption: str) -> list:
        toks = []
        for w in caption.split(" "):
            if w in (adv, "forward", "backward", "left", "right"):
                pos = "ADV"
            elif w == size:
                pos = "ADJ"
            elif w in (verb, gerund):
                pos = "VERB"
            else:
                pos = _POS_TAGS.get(w, "OTHER")
            toks.append(f"{w}/{pos}")
        return toks

    return [dict(caption=templates[p], tokens=tokenize(templates[p])) for p in picks]


class SyntheticMotionDataset:
    """Procedural plausible-motion dataset (FK on smooth random walks).

    Stands in for HumanML3D where its files are absent. Features go through
    the real codec (`extract_features`) on `device` (CUDA unless the caller
    passes "cpu"), so recover_from_ric round-trips behave as on real data.
    The items are kept on the host.
    """

    _POP_STATS: dict = {}
    _CHUNK = 256  # items per FK + codec call

    def __init__(self, cfg: DatasetConfig, size: int = 64, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        T = min(cfg.max_motion_length + 1, 200)
        feats, props = self._make_items(cfg, seed, size, T, resolve_device(device))
        self.items = []
        for i in range(size):
            texts = synthetic_captions(props[i], np.random.default_rng((seed, i, 7)))
            self.items.append(dict(motion=feats[i], texts=texts))
        self.stats = self._population_stats(cfg)

    @staticmethod
    def _make_items(cfg: DatasetConfig, seed: int, size: int, T: int, device):
        """(size, T-1, 263) float32 motions and each item's generative
        properties (xz drift, mean body scale), in JAX's draw order."""
        from condmdi_tpu_torch.data.humanml_repr import extract_features
        from condmdi_tpu_torch.geometry.skeleton import T2M_RAW_OFFSETS, t2m_skeleton

        qs, roots, offs, props = [], [], [], []
        for i in range(size):
            rng = np.random.default_rng((seed, i))
            scale = rng.uniform(0.25, 0.45, size=(22, 1))
            offs.append((T2M_RAW_OFFSETS * scale).astype(np.float32))
            base = rng.normal(size=(1, 22, 4))
            steps = rng.normal(size=(T, 22, 4)) * 0.03
            q = base + np.cumsum(steps, axis=0)
            qs.append((q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32))
            root = np.cumsum(rng.normal(size=(T, 3)) * 0.01, axis=0).astype(np.float32)
            # meters-scale locomotion: a constant per-item xz drift
            drift = rng.uniform(-0.02, 0.02, size=2).astype(np.float32)
            root[:, [0, 2]] += drift * np.arange(T, dtype=np.float32)[:, None]
            root[:, 1] += 0.9
            roots.append(root)
            props.append(dict(drift=drift, scale=float(scale.mean())))

        out = []
        step = SyntheticMotionDataset._CHUNK
        with torch.no_grad():
            for c in range(0, size, step):
                q = torch.from_numpy(np.stack(qs[c: c + step])).to(device)
                root = torch.from_numpy(np.stack(roots[c: c + step])).to(device)
                off = torch.from_numpy(np.stack(offs[c: c + step])).to(device)
                joints = t2m_skeleton.forward_kinematics(q, root, off[:, None])
                feats = extract_features(joints, 0.002, abs_3d=cfg.abs_3d)
                out.append(feats.float().cpu().numpy())
        return np.concatenate(out, axis=0), props

    @classmethod
    def _population_stats(cls, cfg: DatasetConfig) -> NormStats:
        """The population normalisation stats every instance shares (as every
        HumanML3D split shares the dataset's Mean.npy/Std.npy), from the files
        the JAX package ships, copied beside this module."""
        key = "abs" if cfg.abs_3d else "rel"
        if key not in cls._POP_STATS:
            with np.load(_STATS_DIR / f"synthetic_stats_{key}.npz") as z:
                cls._POP_STATS[key] = NormStats(z["mean"], z["std"])
        return cls._POP_STATS[key]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        cfg = self.cfg
        it = self.items[i]
        motion = it["motion"]
        m_length = min(len(motion), cfg.max_motion_length)
        m_length = (m_length // cfg.unit_length) * cfg.unit_length
        start = np.random.randint(0, len(motion) - m_length + 1)
        motion = motion[start: start + m_length]
        if cfg.traject_only:
            motion = motion[:, :4]
        motion = self.normalize(motion)
        text = it["texts"][np.random.randint(len(it["texts"]))]
        return dict(motion=motion, length=m_length,
                    caption=text["caption"], tokens=text["tokens"])

    def _stats_like(self, x):
        mean, std = self.stats.mean[: x.shape[-1]], self.stats.std[: x.shape[-1]]
        if isinstance(x, torch.Tensor):
            return (torch.as_tensor(mean, dtype=x.dtype, device=x.device),
                    torch.as_tensor(std, dtype=x.dtype, device=x.device))
        return mean, std

    def normalize(self, x):
        """numpy array or tensor."""
        mean, std = self._stats_like(x)
        return (x - mean) / std

    def denormalize(self, x):
        """numpy array or tensor."""
        mean, std = self._stats_like(x)
        return x * std + mean


def collate(samples: Sequence[dict], max_motion_length: int, text_encoder=None) -> dict:
    """Pad to max length and build the masks, layout [B, T, F]; numpy on the host."""
    B = len(samples)
    F = samples[0]["motion"].shape[-1]
    motion = np.zeros((B, max_motion_length, F), np.float32)
    lengths = np.zeros((B,), np.int32)
    for i, s in enumerate(samples):
        n = min(len(s["motion"]), max_motion_length)
        motion[i, :n] = s["motion"][:n]
        lengths[i] = n
    captions = [s["caption"] for s in samples]
    time_mask = np.arange(max_motion_length)[None, :] < lengths[:, None]
    batch = dict(motion=motion, time_mask=time_mask, lengths=lengths, text=captions,
                 tokens=[s.get("tokens", []) for s in samples])
    if text_encoder is not None:
        batch["text_embed"] = text_encoder.encode(captions)
    return batch
