"""Text-to-motion datasets: HumanML3D / KIT from their files, the synthetic set,
collation and the loader.

Counterpart of condmdi_tpu/data/dataset.py for `DatasetConfig`,
`Text2MotionDataset`, `TextOnlyDataset`, `apply_augmentation`,
`synthetic_captions`, `SyntheticMotionDataset`, `collate`, `DataLoader`,
`PrefetchIterator` and `get_dataset_loader` (`NormStats` lives in
utils/assets.py and is imported here for the callers that take it from this
module).

`Text2MotionDataset` reads the reference's tree (reference
Text2MotionDatasetV2, dataset.py:231): per-clip .npy features and
texts/*.txt lines "caption#tokens#f_tag#to_tag", tagged sub-clips at 20 fps,
the length filter [min_len, 200), then per item a random caption, a crop to
unit-length multiples with the single/single/double coin (:434-447), the
trajectory-only slice (:450), rot/full augmentation (:453-474),
drop_redundant (:476), z-normalisation with std_scale_shift (:481-483) and
the random projection outside 'eval'/'gt' (:487). The caption and crop come
from the global `random` and `np.random` in the JAX package's order, so a
seeded run draws the same items. The sub-clip length filter keeps the JAX
package's reading: it measures every tagged line by the tags of the last line
parsed (ROADMAP Queue C 7). Where the split file is absent it raises
FileNotFoundError, and `get_dataset_loader` and the CLIs fall back to the
synthetic set.

The synthetic set: the same seeds give the same items: each item draws from
`default_rng((seed, i))`, its captions from `default_rng((seed, i, 7))`, and
`__getitem__` draws its crop and its caption from the global `np.random` in
the same order as JAX. Forward kinematics and the feature codec run on the
device the dataset is given. Both datasets keep their items on the host;
`normalize`/`denormalize` take numpy arrays or tensors.

Synthetic sets of 512 items or more are cached on disk, as the JAX package
does, under $CONDMDI_SYNTH_CACHE (default ~/.cache/condmdi_synth) in a
`torch` subdirectory of their own, keyed by (abs_3d, length, seed, size) and
the device type the features were computed on.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.utils.assets import NormStats, load_norm_stats

_STATS_DIR = Path(__file__).resolve().parent


HML_DIM = 263


@dataclass
class DatasetConfig:
    name: str = "humanml"
    data_dir: str = ""
    split: str = "train"
    hml_mode: str = "train"  # train | eval | gt | text_only
    max_motion_length: int = 196
    min_motion_length: int = 40
    unit_length: int = 4
    abs_3d: bool = False
    traject_only: bool = False
    use_random_projection: bool = False
    random_projection_scale: float = 10.0
    augment_type: str = "none"  # none | rot | full
    std_scale_shift: tuple[float, float] = (1.0, 0.0)
    drop_redundant: bool = False
    fixed_len: int = 0
    # the synthetic set's size; 0 = $CONDMDI_SYNTHETIC_SIZE, else batch_size*4
    # (get_dataset_loader)
    synthetic_size: int = 0


def _like(a: np.ndarray, x):
    """`a` as a tensor of x's dtype and device where x is a tensor, else `a`."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)
    return a


class Text2MotionDataset:
    """File-backed HumanML3D / KIT-ML (the reference's tree; see the module's
    docstring). `stats` overrides the normalisation stats, which otherwise come
    from the assets directory (utils/assets.load_norm_stats)."""

    # __getitem__ draws a caption, a crop and an augmentation: a cache of collated
    # batches freezes them (training re-collates it every device_cache_refresh steps)
    has_random_item_transforms = True

    def __init__(self, cfg: DatasetConfig, stats: Optional[NormStats] = None):
        self.cfg = cfg
        if cfg.name == "kit":
            # KIT: 251-dim, 21 joints, min length 24 (reference dataset.py:255)
            cfg.min_motion_length = min(cfg.min_motion_length, 24)
            root = Path(cfg.data_dir or "./dataset/KIT-ML")
        else:
            root = Path(cfg.data_dir or "./dataset/HumanML3D")
        self.motion_dir = root / ("new_joint_vecs" + ("_abs_3d" if cfg.abs_3d else ""))
        if not self.motion_dir.is_dir():
            self.motion_dir = root / "new_joint_vecs"
        self.text_dir = root / "texts"
        split_file = root / f"{cfg.split}.txt"
        if not split_file.exists():
            raise FileNotFoundError(
                f"HumanML3D split file {split_file} not found — download the "
                "dataset (reference prepare/*.sh) or use SyntheticMotionDataset"
            )
        kind = "kit" if cfg.name == "kit" else ("abs3d" if cfg.abs_3d else "t2m")
        self.stats = stats or load_norm_stats(kind)
        self.rand_proj = None
        if cfg.use_random_projection:
            from condmdi_tpu_torch.data.projection import RandomProjection

            self.rand_proj = RandomProjection.load_or_create(scale=cfg.random_projection_scale)

        ids = [line.strip() for line in open(split_file) if line.strip()]
        self.entries = []
        for name in ids:
            mpath = self.motion_dir / f"{name}.npy"
            if not mpath.exists():
                continue
            motion = np.load(mpath, mmap_mode="r")
            if len(motion) < cfg.min_motion_length or len(motion) >= 200:
                continue
            texts = []
            tpath = self.text_dir / f"{name}.txt"
            if tpath.exists():
                for line in open(tpath):
                    parts = line.strip().split("#")
                    if len(parts) < 4:
                        continue
                    caption, tokens, f_tag, to_tag = parts[0], parts[1], parts[2], parts[3]
                    f_tag = 0.0 if f_tag in ("", "nan") else float(f_tag)
                    to_tag = 0.0 if to_tag in ("", "nan") else float(to_tag)
                    texts.append(dict(caption=caption, tokens=tokens.split(" "),
                                      f_tag=f_tag, to_tag=to_tag))
            if not texts:
                continue
            # tagged sub-clips (reference :300-330); as in the JAX package, each is
            # measured by f_tag/to_tag as the loop above left them, the last line's
            # (ROADMAP Queue C 7)
            base_texts = [t for t in texts if t["f_tag"] == 0.0 and t["to_tag"] == 0.0]
            for t in texts:
                if t["f_tag"] != 0.0 or t["to_tag"] != 0.0:
                    n_frames = int(to_tag * 20) - int(f_tag * 20)
                    if cfg.min_motion_length <= n_frames < 200:
                        self.entries.append(dict(
                            name=name, span=(int(t["f_tag"] * 20), int(t["to_tag"] * 20)),
                            texts=[t]))
            if base_texts:
                self.entries.append(dict(name=name, span=None, texts=base_texts))

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> dict:
        cfg = self.cfg
        e = self.entries[i]
        motion = np.load(self.motion_dir / f"{e['name']}.npy").astype(np.float32)
        if e["span"] is not None:
            motion = motion[e["span"][0]: e["span"][1]]
        text = random.choice(e["texts"])

        m_length = len(motion)
        coin2 = (np.random.choice(["single", "single", "double"]) if cfg.unit_length < 10
                 else "single")
        if coin2 == "double":
            m_length = (m_length // cfg.unit_length - 1) * cfg.unit_length
        else:
            m_length = (m_length // cfg.unit_length) * cfg.unit_length
        start = random.randint(0, len(motion) - m_length)
        motion = motion[start: start + m_length]

        if cfg.traject_only:
            motion = motion[:, :4]
        motion = apply_augmentation(motion, cfg.augment_type)
        if cfg.drop_redundant:
            motion = motion[:, :67]
        motion = self.normalize(motion)
        return dict(motion=motion, length=m_length, caption=text["caption"],
                    tokens=text["tokens"])

    def _projected(self) -> bool:
        return self.rand_proj is not None and self.cfg.hml_mode not in ("eval", "gt")

    def normalize(self, x):
        """(x - mean) / (std * scale + shift), then the random projection outside
        'eval'/'gt' (reference __getitem__:481-489); numpy array or tensor."""
        scale, shift = self.cfg.std_scale_shift
        F = x.shape[-1]
        x = (x - _like(self.stats.mean[:F], x)) / _like(self.stats.std[:F] * scale + shift, x)
        if self._projected():
            x = x @ _like(self.rand_proj.proj, x)
        return x

    def denormalize(self, x):
        """The inverse of `normalize`; numpy array or tensor."""
        if self._projected():
            x = x @ _like(self.rand_proj.inv_proj, x)
        scale, shift = self.cfg.std_scale_shift
        F = x.shape[-1]
        return x * _like(self.stats.std[:F] * scale + shift, x) + _like(self.stats.mean[:F], x)


def apply_augmentation(motion: np.ndarray, augment_type: str) -> np.ndarray:
    """Random yaw ('rot') and also a random xz translation ('full') of abs-root
    features, drawn from the global np.random as in the JAX package."""
    if augment_type not in ("rot", "full"):
        return motion
    motion = motion.copy()
    rand_rot = (np.random.rand() * 2.0 - 1.0) * np.pi / 4.0
    motion[:, 0] = motion[:, 0] + rand_rot
    c, s = np.cos(-rand_rot), np.sin(-rand_rot)
    x, z = motion[:, 1].copy(), motion[:, 2].copy()
    # rotate xz by -rand_rot about y (qrot with the inverse yaw quaternion)
    motion[:, 1] = c * x + s * z
    motion[:, 2] = -s * x + c * z
    if augment_type == "full":
        rand_trans = (np.random.rand(2) * 2.0 - 1.0) * 3.0
        motion[:, 1] += rand_trans[0]
        motion[:, 2] += rand_trans[1]
    return motion


class TextOnlyDataset:
    """Caption-only dataset for generation without ground-truth motions (reference
    :866): zero motions of a fixed length."""

    has_random_item_transforms = False

    def __init__(self, cfg: DatasetConfig, captions: Sequence[str], fixed_length: int = 120):
        self.cfg = cfg
        self.captions = list(captions)
        self.fixed_length = fixed_length

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, i):
        return dict(motion=np.zeros((self.fixed_length, HML_DIM), np.float32),
                    length=self.fixed_length, caption=self.captions[i], tokens=[])


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
    # __getitem__ draws a crop start and a caption: a cache of collated batches
    # freezes them (training re-collates it every device_cache_refresh steps)
    has_random_item_transforms = True

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
        properties (xz drift, mean body scale), in JAX's draw order; sets of
        512 items or more from the disk cache when it holds them."""
        from condmdi_tpu_torch.data.humanml_repr import extract_features
        from condmdi_tpu_torch.geometry.skeleton import T2M_RAW_OFFSETS, t2m_skeleton

        cache_path = None
        if size >= 512:
            cdir = Path(os.environ.get("CONDMDI_SYNTH_CACHE", "~/.cache/condmdi_synth"))
            cache_path = (cdir.expanduser() / "torch"
                          / f"synth_{int(cfg.abs_3d)}_{T}_{seed}_{size}_{device.type}.npz")
            if cache_path.exists():
                try:
                    with np.load(cache_path) as z:
                        feats, drift, scale = z["feats"], z["drift"], z["scale"]
                    return feats, [dict(drift=drift[i], scale=float(scale[i]))
                                   for i in range(size)]
                except Exception:  # a corrupt or partial file: make the set again
                    pass

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
        feats = np.concatenate(out, axis=0)
        if cache_path is not None:
            try:  # best effort: a read-only home keeps the set in memory only
                import tempfile

                cache_path.parent.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(dir=str(cache_path.parent), suffix=".npz.tmp")
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, feats=feats, drift=np.stack([p["drift"] for p in props]),
                             scale=np.asarray([p["scale"] for p in props]))
                os.replace(tmp, cache_path)  # atomic against concurrent writers
            except OSError:
                pass
        return feats, props

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
    if any(s.get("action") is not None for s in samples):  # action labels, 0 where absent
        batch["action"] = np.asarray([s.get("action", 0) for s in samples], np.int32)
    if text_encoder is not None:
        batch["text_embed"] = text_encoder.encode(captions)
    return batch


class DataLoader:
    """Shuffling epoch iterator with per-process sharding, single-threaded.

    Epoch e shuffles with `default_rng(seed + e)`, the shard is every
    `process_count`-th index from `process_index`, and each batch is collated
    from the dataset's items, as the JAX package's loader does: the same
    seed gives the same batches. `batches(epoch, start)` yields (batch,
    (epoch, index of the next batch)) from any position, which is how
    training resumes its data stream.
    """

    def __init__(self, dataset, batch_size: int, max_motion_length: int, shuffle: bool = True,
                 seed: int = 0, text_encoder=None, process_index: int = 0,
                 process_count: int = 1, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_motion_length = max_motion_length
        self.shuffle = shuffle
        self.seed = seed
        self.text_encoder = text_encoder
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx[self.process_index:: self.process_count]

    def _epoch(self, epoch: int, start: int = 0) -> Iterator[tuple[dict, tuple[int, int]]]:
        idx = self._order(epoch)
        stop = len(idx) - (self.batch_size - 1 if self.drop_last else 0)
        for b, i in enumerate(range(0, max(stop, 0), self.batch_size)):
            if b < start:
                continue
            chunk = idx[i: i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            samples = [self.dataset[int(j)] for j in chunk]
            yield collate(samples, self.max_motion_length, self.text_encoder), (epoch, b + 1)

    def batches(self, epoch: int = 0, start: int = 0) -> Iterator[tuple[dict, tuple[int, int]]]:
        """Endless (batch, position) from batch `start` of `epoch` on."""
        if len(self) == 0:
            raise ValueError(f"{len(self.dataset)} items make no batch of {self.batch_size}")
        while True:
            yield from self._epoch(epoch, start)
            epoch, start = epoch + 1, 0

    def __iter__(self) -> Iterator[dict]:
        epoch = self.epoch
        self.epoch += 1
        for batch, _ in self._epoch(epoch):
            yield batch


class PrefetchIterator:
    """Background-thread prefetch: keeps `depth` items ready so that collation
    on the host does not stall the card. `close()` stops the thread and
    returns once it has ended."""

    def __init__(self, iterable, depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err = None
        self._stop = threading.Event()

        def feed():
            try:
                for item in iterable:
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.05)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # surface the feeder's error to the consumer
                self._err = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(self._sentinel, timeout=0.05)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=feed, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


def get_dataset_loader(cfg: DatasetConfig, batch_size: int, text_encoder=None,
                       device: str | torch.device = "cuda", **kw) -> DataLoader:
    """The HumanML3D (or KIT) loader where its files are, else the synthetic set, whose
    size is cfg.synthetic_size, else $CONDMDI_SYNTHETIC_SIZE, else
    max(batch_size * 4, 64), as in the JAX package. The synthetic features are
    computed on `device`."""
    try:
        ds = Text2MotionDataset(cfg)
    except FileNotFoundError:
        size = (cfg.synthetic_size or int(os.environ.get("CONDMDI_SYNTHETIC_SIZE", 0))
                or max(batch_size * 4, 64))
        ds = SyntheticMotionDataset(cfg, size=size, device=device)
    return DataLoader(ds, batch_size, cfg.max_motion_length, text_encoder=text_encoder, **kw)
