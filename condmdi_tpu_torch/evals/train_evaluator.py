"""The T2M evaluator's parameters: initialisation and the npz format.

Counterpart of condmdi_tpu/evals/train_evaluator.py for `init_params`,
`save_params_npz` and `load_params_npz` (numpy; the port keeps its own copy),
so the port reads the committed save/evaluator_synth/evaluator.npz. The
contrastive trainer itself (`train`, `main`) waits for the training slice
(ROADMAP Queue A 5).

The tree is the JAX package's: {"movement", "motion", "text"} of dicts of
float32 arrays, Dense kernels [in, out], conv kernels [k, in, out] (Flax's
WIO), GRU weights in torch's [3H, in] layout with gates r, z, n.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


# --------------------------------------------------------------------------- #
# Initialization (reference modules.py init_weight: xavier-normal linear/conv;
# GRU weights keep torch's U(-1/sqrt(H), 1/sqrt(H)) default)
# --------------------------------------------------------------------------- #
def init_params(rng: np.random.Generator, dim_pose: int = 263) -> dict:
    H, E, W, P = 1024, 512, 300, 15

    def xavier(shape, fan_in, fan_out):
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
        return rng.normal(0.0, std, shape).astype(np.float32)

    def dense(i, o):
        return {"kernel": xavier((i, o), i, o), "bias": np.zeros(o, np.float32)}

    def gru(i, h):
        k = 1.0 / np.sqrt(h)
        return {
            "wi": rng.uniform(-k, k, (3 * h, i)).astype(np.float32),
            "wh": rng.uniform(-k, k, (3 * h, h)).astype(np.float32),
            "bi": rng.uniform(-k, k, 3 * h).astype(np.float32),
            "bh": rng.uniform(-k, k, 3 * h).astype(np.float32),
        }

    return {
        "movement": {
            "conv1": {"kernel": xavier((4, dim_pose - 4, E), 4 * (dim_pose - 4), E),
                      "bias": np.zeros(E, np.float32)},
            "conv2": {"kernel": xavier((4, E, E), 4 * E, E),
                      "bias": np.zeros(E, np.float32)},
            "out": dense(E, E),
        },
        "motion": {
            "input_emb": dense(E, H),
            "gru_f": gru(H, H), "gru_b": gru(H, H),
            "h0": rng.normal(0, 1, (2, H)).astype(np.float32),
            "out1": dense(2 * H, H),
            "ln": {"scale": np.ones(H, np.float32), "bias": np.zeros(H, np.float32)},
            "out2": dense(H, E),
        },
        "text": {
            "pos_emb": dense(P, W),
            "input_emb": dense(W, E),
            "gru_f": gru(E, E), "gru_b": gru(E, E),
            "h0": rng.normal(0, 1, (2, E)).astype(np.float32),
            "out1": dense(2 * E, E),
            "ln": {"scale": np.ones(E, np.float32), "bias": np.zeros(E, np.float32)},
            "out2": dense(E, E),
        },
    }


# --------------------------------------------------------------------------- #
# npz (de)serialization — committed checkpoints store f16 (half the bytes;
# the evaluator is tolerant: embeddings move O(1e-3) relative)
# --------------------------------------------------------------------------- #
def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float16)
    return out


def save_params_npz(params: dict, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **_flatten(params))


def load_params_npz(path: str | Path) -> dict:
    z = np.load(path)
    params: dict = {}
    for key in z.files:
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key].astype(np.float32)
    return params
