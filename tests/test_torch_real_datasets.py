"""The file-backed datasets, the random projection and the opt-file parser on
the port against the JAX package, on the CPU, on trees the tests write:

  * HumanML3D (263 features) and KIT (251, minimum length 24): the same entries
    (names, sub-clip spans at 20 fps, captions and tokens), and the same items
    under the same `random` / `np.random` seeds, equal (both sides are the same
    numpy arithmetic), with the options: augmentation (rot, full),
    std_scale_shift, traject_only, drop_redundant, the random projection
    (applied outside 'eval'/'gt'); denormalize on numpy and on tensors;
  * the sub-clip length filter reads the last caption line's tags in both
    (ROADMAP Queue C 7): two tagged lines of different spans keep the same entries;
  * TextOnlyDataset equal; get_dataset_loader reading the files where they are;
  * RandomProjection.load_or_create: made, saved and loaded as JAX does, equal;
  * get_opt on an opt file the test writes, with and without $DATA_ROOT and
    use_abs3d: equal namespaces.
"""

import random

import numpy as np
import pytest
import torch

from condmdi_tpu.data import dataset as jds
from condmdi_tpu.data import get_opt as jgo
from condmdi_tpu.data import projection as jproj
from condmdi_tpu.utils.assets import NormStats as JNormStats
from condmdi_tpu_torch.data import dataset as tds
from condmdi_tpu_torch.data import get_opt as tgo
from condmdi_tpu_torch.data import projection as tproj
from condmdi_tpu_torch.utils.assets import NormStats as TNormStats


def write_tree(root, clips, dim, abs_3d=False, split="train"):
    """clips: {name: (frames or None, caption lines)}; features random, with the
    frame index in feature 0; the split file also names a clip without a file."""
    rng = np.random.default_rng(len(clips) + dim)
    vecs = root / ("new_joint_vecs_abs_3d" if abs_3d else "new_joint_vecs")
    vecs.mkdir(parents=True)
    (root / "texts").mkdir(exist_ok=True)
    for name, (T, lines) in clips.items():
        if T is not None:
            arr = rng.standard_normal((T, dim)).astype(np.float32)
            arr[:, 0] = np.arange(T)
            np.save(vecs / f"{name}.npy", arr)
        (root / "texts" / f"{name}.txt").write_text("\n".join(lines) + "\n")
    (root / f"{split}.txt").write_text("\n".join(list(clips) + ["ghost_id"]) + "\n")
    return root


HML_CLIPS = {
    "000001": (100, ["a person walks forward#a/DET person/NOUN walks/VERB##",
                     "someone strolls#someone/PRON strolls/VERB#0.0#0.0"]),
    "000002": (120, ["whole clip caption#whole/ADJ clip/NOUN#0.0#0.0",
                     "sub clip caption#sub/ADJ clip/NOUN#1.0#3.5"]),
    "000003": (30, ["short#short/ADJ##"]),  # under the 40-frame minimum
    "000004": (90, ["base#base/NOUN##", "tiny segment#tiny/ADJ#1.0#2.0"]),
    "000005": (199, ["long#long/ADJ#nan#nan", "broken line"]),
    "000006": (None, ["no motion file#no/DET##"]),
    "000007": (64, ["the first tag#first/ADJ#0.5#1.5", "the second tag#second/ADJ#0.0#2.5"]),
}


def stats(dim, seed):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(dim).astype(np.float32)
    std = (rng.random(dim) + 0.5).astype(np.float32)
    return JNormStats(mean, std), TNormStats(mean, std)


def pair(root, name="humanml", stats_seed=0, **kw):
    dim = 251 if name == "kit" else 263
    js, ts_ = stats(dim, stats_seed)
    jcfg = jds.DatasetConfig(name=name, data_dir=str(root), split="train", **kw)
    tcfg = tds.DatasetConfig(name=name, data_dir=str(root), split="train", **kw)
    return jds.Text2MotionDataset(jcfg, stats=js), tds.Text2MotionDataset(tcfg, stats=ts_)


def assert_same_entries(a, b):
    assert len(a) == len(b)
    for x, y in zip(a.entries, b.entries):
        assert x == y


def assert_same_items(jset, tset, n_draws=12, seed=5):
    random.seed(seed)
    np.random.seed(seed)
    want = [jset[i % len(jset)] for i in range(n_draws)]
    random.seed(seed)
    np.random.seed(seed)
    got = [tset[i % len(tset)] for i in range(n_draws)]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["length"], g["caption"], g["tokens"]) == (w["length"], w["caption"], w["tokens"])
        np.testing.assert_array_equal(g["motion"], w["motion"])
    return got


@pytest.fixture()
def hml_tree(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no assets directory: the projection is made afresh
    monkeypatch.delenv("CONDMDI_ASSETS", raising=False)
    return write_tree(tmp_path / "HumanML3D", HML_CLIPS, 263)


def test_humanml_entries_equal_jax(hml_tree):
    jset, tset = pair(hml_tree)
    assert_same_entries(jset, tset)
    names = {e["name"] for e in tset.entries}
    assert names == {"000001", "000002", "000004", "000005", "000007"}
    assert ("000002", (20, 70)) in {(e["name"], e["span"]) for e in tset.entries}


OPTIONS = [
    dict(),
    dict(augment_type="rot"),
    dict(augment_type="full", std_scale_shift=(2.0, 0.5)),
    dict(traject_only=True),
    dict(drop_redundant=True, unit_length=10),
    dict(use_random_projection=True, random_projection_scale=5.0),
    dict(use_random_projection=True, hml_mode="eval"),
]


@pytest.mark.parametrize("kw", OPTIONS, ids=[",".join(o) or "plain" for o in OPTIONS])
def test_humanml_items_equal_jax(hml_tree, kw):
    jset, tset = pair(hml_tree, **kw)
    got = assert_same_items(jset, tset)
    x = got[0]["motion"]
    back = tset.denormalize(x)
    np.testing.assert_array_equal(back, jset.denormalize(x))
    back_t = tset.denormalize(torch.from_numpy(x))
    np.testing.assert_allclose(back_t.numpy(), back, rtol=1e-6, atol=1e-5)
    # the float32 projection and its inverse round-trip to ~1e-5 of the values' scale
    np.testing.assert_allclose(tset.normalize(torch.from_numpy(back)).numpy(), x, rtol=0,
                               atol=1e-4 * (1 + np.abs(x).max()))


def test_kit_tree_equals_jax(tmp_path):
    root = write_tree(tmp_path / "KIT-ML", {
        "kit01": (30, ["a kit clip#a/DET kit/NOUN clip/NOUN##"]),
        "kit02": (20, ["too short#short/ADJ##"]),
        "kit03": (80, ["kit base#base/NOUN##", "kit part#part/NOUN#0.5#2.0"]),
    }, 251)
    jset, tset = pair(root, name="kit")
    assert_same_entries(jset, tset)
    assert tset.cfg.min_motion_length == 24 and len(tset) == 3
    got = assert_same_items(jset, tset, n_draws=6)
    assert got[0]["motion"].shape[-1] == 251


def test_abs_3d_directory_is_preferred(tmp_path):
    root = write_tree(tmp_path / "HumanML3D", {"000001": (60, ["x#x/X##"])}, 263, abs_3d=True)
    jset, tset = pair(root, abs_3d=True)
    assert tset.motion_dir == jset.motion_dir and tset.motion_dir.name.endswith("_abs_3d")
    assert_same_items(jset, tset, n_draws=3)


def test_subclip_length_filter_reads_the_last_line_as_jax_does(tmp_path):
    """ROADMAP Queue C 7: a 20-frame tagged span (under the 40-frame minimum) is
    kept when the file's last tagged line spans 60 frames, and a 60-frame span is
    dropped when the last line spans 20; the port keeps the JAX entries."""
    root = write_tree(tmp_path / "HumanML3D", {
        "kept": (150, ["short span#short/ADJ#0.0#1.0", "long span#long/ADJ#1.0#4.0"]),
        "dropped": (150, ["long span#long/ADJ#1.0#4.0", "short span#short/ADJ#0.0#1.0"]),
    }, 263)
    jset, tset = pair(root)
    assert_same_entries(jset, tset)
    spans = {(e["name"], e["span"]) for e in tset.entries}
    assert spans == {("kept", (0, 20)), ("kept", (20, 80))}


def test_text_only_dataset_equals_jax():
    caps = ["a person jumps", "someone waves"]
    a = tds.TextOnlyDataset(tds.DatasetConfig(), caps, fixed_length=40)
    b = jds.TextOnlyDataset(jds.DatasetConfig(), caps, fixed_length=40)
    assert len(a) == len(b) == 2 and not a.has_random_item_transforms
    for i in range(2):
        x, y = a[i], b[i]
        assert (x["caption"], x["length"], x["tokens"]) == (y["caption"], y["length"], y["tokens"])
        np.testing.assert_array_equal(x["motion"], y["motion"])


def test_loader_reads_the_files_where_they_are(hml_tree):
    cfg = tds.DatasetConfig(data_dir=str(hml_tree), split="train", max_motion_length=196)
    loader = tds.get_dataset_loader(cfg, 2, device="cpu")
    assert isinstance(loader.dataset, tds.Text2MotionDataset)
    np.random.seed(0)
    random.seed(0)
    batch = next(iter(loader))
    assert batch["motion"].shape == (2, 196, 263)


@pytest.mark.parametrize("scale", [10.0, 3.0])
def test_random_projection_equals_jax(tmp_path, monkeypatch, scale):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CONDMDI_ASSETS", raising=False)
    a = tproj.RandomProjection.load_or_create(save_at=str(tmp_path / "t"), scale=scale, dim=40,
                                              seed=2)
    b = jproj.RandomProjection.load_or_create(save_at=str(tmp_path / "j"), scale=scale, dim=40,
                                              seed=2)
    np.testing.assert_array_equal(a.proj, b.proj)
    np.testing.assert_array_equal(a.inv_proj, b.inv_proj)
    for name in ("rand_proj.npy", "inv_rand_proj.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name))
    again = tproj.RandomProjection.load_or_create(save_at=str(tmp_path / "t"), scale=99.0, dim=40)
    np.testing.assert_array_equal(again.proj, a.proj)  # loaded, not made again
    fresh = tproj.RandomProjection.load_or_create(scale=scale, dim=40, seed=2)  # no directory
    np.testing.assert_array_equal(fresh.proj, a.proj)
    x = np.random.default_rng(0).standard_normal((3, 40)).astype(np.float32)
    np.testing.assert_array_equal(a(x), b(x))
    np.testing.assert_array_equal(a.inverse(x), b.inverse(x))


OPT_TEXT = """------------ Options -------------
batch_size: 32
dataset_name: {name}
dim_pose: 7
lr: 0.0002
is_train: True
max_text_len: 20
name: Comp_v6_KLD01
unit_length: 4
no colon here
-------------- End ----------------
"""


@pytest.mark.parametrize("name", ["t2m", "kit"])
@pytest.mark.parametrize("use_abs3d,mode", [(False, "train"), (True, "train"), (True, "gt")])
@pytest.mark.parametrize("data_root", [None, "/data/hml"])
def test_get_opt_equals_jax(tmp_path, monkeypatch, name, use_abs3d, mode, data_root):
    path = tmp_path / "opt.txt"
    path.write_text(OPT_TEXT.format(name=name))
    if data_root is None:
        monkeypatch.delenv("DATA_ROOT", raising=False)
    else:
        monkeypatch.setenv("DATA_ROOT", data_root)
    got = tgo.get_opt(path, use_abs3d=use_abs3d, mode=mode)
    want = jgo.get_opt(path, use_abs3d=use_abs3d, mode=mode)
    assert vars(got) == vars(want)
