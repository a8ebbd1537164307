"""The T2M evaluator's contrastive trainer, its parameters and their npz format.

Counterpart of condmdi_tpu/evals/train_evaluator.py: `init_params`,
`save_params_npz`, `load_params_npz` (numpy; the port keeps its own copy, so
it reads the committed save/evaluator_synth/evaluator.npz), `make_batch`,
`r_precision_of_batch`, `train` and `main`. The trainer is JAX's: the margin
contrastive loss over the movement, motion and text encoders trained jointly
(positives mean |t - m|^2 over matched pairs, negatives the exact expectation
of max(margin - |t - m'|, 0)^2 over every other pair of the batch), the
global-norm clip at 0.5, and Adam (here torch's AdamW without weight decay,
which is Adam) at --lr, on the synthetic set with the hash word vectorizer,
batches drawn from default_rng(seed + 31). On the card unless
`device="cpu"`, in full float32.

Usage:
  python -m condmdi_tpu_torch.evals.train_evaluator --steps 3000 \
      --out torch_eval_out/evaluator_synth [--train_size 4096] [--batch_size 32]

(the default --out is git-ignored: save/evaluator_synth holds the committed
evaluator the JAX package trained)

The tree is the JAX package's: {"movement", "motion", "text"} of dicts of
float32 arrays, Dense kernels [in, out], conv kernels [k, in, out] (Flax's
WIO), GRU weights in torch's [3H, in] layout with gates r, z, n.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

MARGIN = 10.0  # the reference's negative_margin for text_mot_match
UNIT_LENGTH = 4


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


# --------------------------------------------------------------------------- #
# Batching
# --------------------------------------------------------------------------- #
def make_batch(ds, idx, vectorizer, max_len: int):
    """Indices → (word, pos, cap_lens, motions, m_lens) numpy arrays."""
    from condmdi_tpu_torch.data.dataset import collate
    from condmdi_tpu_torch.data.word_vectorizer import tokens_to_embeddings

    batch = collate([ds[int(i)] for i in idx], max_len)
    word, pos, cap_lens = tokens_to_embeddings(batch["tokens"], vectorizer)
    return word, pos, cap_lens, batch["motion"], batch["lengths"]


def r_precision_of_batch(evaluator, word, pos, cap_lens, motions, m_lens):
    from condmdi_tpu_torch.evals import metrics as M

    text_emb, motion_emb = evaluator.get_co_embeddings(word, pos, cap_lens, motions, m_lens)
    top_k = M.calculate_R_precision(text_emb, motion_emb, 3, sum_all=True)
    match = M.calculate_matching_score(text_emb, motion_emb, sum_all=True)
    return np.asarray(top_k, np.float64) / len(text_emb), match / len(text_emb)


# --------------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------------- #
def contrastive_loss(p: dict, word, pos, cap_lens, motions, m_lens):
    """(loss, positive term, negative term) of one batch of tensors."""
    from condmdi_tpu_torch.evals.evaluator import motion_encode, movement_encode, text_encode

    movements = movement_encode(p["movement"], motions[..., :-4])
    mot = motion_encode(p["motion"], movements,
                        torch.div(m_lens, UNIT_LENGTH, rounding_mode="floor"))
    txt = text_encode(p["text"], word, pos, cap_lens)
    d2 = ((txt[:, None, :] - mot[None, :, :]) ** 2).sum(dim=-1)  # text_i to motion_j
    d = torch.sqrt(d2 + 1e-12)
    n = d.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=d.device)
    loss_pos = torch.diagonal(d2).mean()
    hinge = torch.clamp(MARGIN - d, min=0.0) ** 2
    loss_neg = torch.where(eye, 0.0, hinge).sum() / (n * (n - 1))
    return loss_pos + loss_neg, loss_pos, loss_neg


def _leaves(tree: dict, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_numpy(tree: dict) -> dict:
    return {k: _to_numpy(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


def train(args, device: str | torch.device = "cuda") -> dict:
    from condmdi_tpu_torch.data.dataset import DatasetConfig, SyntheticMotionDataset
    from condmdi_tpu_torch.data.word_vectorizer import HashWordVectorizer
    from condmdi_tpu_torch.device import float32_exact, resolve_device
    from condmdi_tpu_torch.evals.evaluator import EvaluatorWrapper

    dev = resolve_device(device)
    T = args.num_frames
    cfg = DatasetConfig(max_motion_length=T, abs_3d=False)
    train_ds = SyntheticMotionDataset(cfg, size=args.train_size, seed=args.seed, device=dev)
    val_ds = SyntheticMotionDataset(cfg, size=args.val_size, seed=args.seed + 990_001,
                                    device=dev)
    vec = HashWordVectorizer()

    params = _params_to(init_params(np.random.default_rng(args.seed)), dev)
    leaves = [leaf for _, leaf in _leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=args.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)

    def step(word, pos, cap_lens, motions, m_lens):
        from condmdi_tpu_torch.training.loop import clip_by_global_norm_, global_norm

        loss, lp, ln_ = contrastive_loss(params, word, pos, cap_lens, motions, m_lens)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad for p in leaves]
            clip_by_global_norm_(grads, 0.5, global_norm(grads))
            opt.step()
        return loss.detach(), lp.detach(), ln_.detach()

    def tensors(word, pos, cap_lens, motions, m_lens):
        return (torch.as_tensor(word, device=dev), torch.as_tensor(pos, device=dev),
                torch.as_tensor(cap_lens, device=dev).long(),
                torch.as_tensor(motions, device=dev), torch.as_tensor(m_lens, device=dev).long())

    rng = np.random.default_rng(args.seed + 31)
    n = len(train_ds)
    B = args.batch_size
    t0 = time.time()
    log = []
    with float32_exact():
        for it in range(args.steps):
            idx = rng.choice(n, size=B, replace=False)
            loss, lp, ln_ = step(*tensors(*make_batch(train_ds, idx, vec, T)))
            if it % args.log_every == 0 or it == args.steps - 1:
                ev = EvaluatorWrapper(_to_numpy(params), device=dev)
                vb = make_batch(val_ds, rng.choice(len(val_ds), B, replace=False), vec, T)
                rp, match = r_precision_of_batch(ev, *vb)
                rec = dict(step=it, loss=float(loss), loss_pos=float(lp), loss_neg=float(ln_),
                           val_r_precision=[round(float(x), 4) for x in rp],
                           val_matching=round(float(match), 4),
                           elapsed_s=round(time.time() - t0, 1))
                log.append(rec)
                print(rec)

    # final validation at the protocol's scale (batches of 32), on the weights as
    # saved (float16 in the npz)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    save_params_npz(_to_numpy(params), out / "evaluator.npz")
    ev = EvaluatorWrapper(load_params_npz(out / "evaluator.npz"), device=dev)
    rps, matches = [], []
    vrng = np.random.default_rng(args.seed + 77)
    for _ in range(args.val_batches):
        vb = make_batch(val_ds, vrng.choice(len(val_ds), 32, replace=False), vec, T)
        rp, match = r_precision_of_batch(ev, *vb)
        rps.append(rp)
        matches.append(match)
    rp_mean = np.stack(rps).mean(axis=0)
    meta = dict(
        steps=args.steps, batch_size=B, lr=args.lr, margin=MARGIN,
        train_size=args.train_size, val_size=args.val_size, seed=args.seed,
        num_frames=T, word_vectorizer="hash",
        val_r_precision_top123=[round(float(x), 4) for x in rp_mean],
        val_matching_score=round(float(np.mean(matches)), 4),
        chance_r_precision=[round(k / 32, 4) for k in (1, 2, 3)],
        val_batches=args.val_batches,
        log=log,
    )
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    print("final:", {k: meta[k] for k in ("val_r_precision_top123", "val_matching_score")})
    return meta


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=device, requires_grad=True)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--train_size", type=int, default=4096)
    p.add_argument("--val_size", type=int, default=512)
    p.add_argument("--val_batches", type=int, default=16)
    p.add_argument("--num_frames", type=int, default=196)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--out", type=str, default="torch_eval_out/evaluator_synth")
    return p


def main(argv=None, *, device: str | torch.device = "cuda"):
    return train(build_parser().parse_args(argv), device=device)


if __name__ == "__main__":
    main()
