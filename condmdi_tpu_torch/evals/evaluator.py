"""T2M co-embedding evaluator networks on tensors, with torch-exact GRU math.

Counterpart of condmdi_tpu/evals/evaluator.py. Parity targets: reference
data_loaders/humanml/networks/modules.py — MovementConvEncoder:79 (2× strided
conv k4s2p1 + LeakyReLU(0.2) + Linear), TextEncoderBiGRUCo:311 /
MotionEncoderBiGRUCo:353 (bi-GRU with learnable initial hidden,
packed-sequence semantics = last VALID step per direction, output MLP with
LayerNorm), and evaluator_wrapper.py:121 (EvaluatorMDMWrapper.get_co_embeddings
— including the sort-by-length-desc quirk, :160-171).

Plain functions over the JAX package's parameter tree (numpy arrays there,
tensors here), so the committed evaluator.npz and the released
`text_mot_match/model/finest.tar` load as they do in JAX. The GRU gate math is
torch's:
  r = σ(W_ir x + b_ir + W_hr h + b_hr)
  z = σ(W_iz x + b_iz + W_hz h + b_hz)
  n = tanh(W_in x + b_in + r (W_hn h + b_hn))
  h' = (1 - z) n + z h
Variable lengths are masked carries in a loop over time (a cuDNN GRU on the
padded batch would run past each length); the backward direction reads each
sample's valid prefix reversed. The wrapper re-applies the reference's
permutation, so its outputs are the JAX wrapper's. No kernel of the port runs
here: on the card these are cuBLAS/cuDNN calls, in full float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from condmdi_tpu_torch.device import float32_exact, resolve_device

UNIT_LENGTH = 4


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


# --------------------------------------------------------------------------- #
# GRU (torch-exact), masked for variable lengths
# --------------------------------------------------------------------------- #
def gru_scan(x: torch.Tensor, lengths: torch.Tensor, p: dict, h0: torch.Tensor,
             reverse: bool = False) -> torch.Tensor:
    """x [B,T,D], lengths [B], params {wi [3H,D], wh [3H,H], bi [3H], bh [3H]},
    h0 [B,H] → final hidden at the last valid step [B,H]."""
    B, T, D = x.shape
    if reverse:
        # per-sample reversal of the valid prefix: index len-1-t
        tidx = torch.arange(T, device=x.device)[None, :]
        ridx = (lengths[:, None] - 1 - tidx).clamp(0, T - 1)
        x = torch.gather(x, 1, ridx[..., None].expand(B, T, D))

    gi = x @ p["wi"].T + p["bi"]  # [B, T, 3H], every step at once
    h = h0
    for t in range(T):
        gh = h @ p["wh"].T + p["bh"]
        i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h_new = (1 - z) * n + z * h
        h = torch.where((t < lengths)[:, None], h_new, h)
    return h


# --------------------------------------------------------------------------- #
# Network applications
# --------------------------------------------------------------------------- #
def movement_encode(params: dict, motion: torch.Tensor) -> torch.Tensor:
    """[B, T, 259] (features minus 4 contacts) → [B, T//4, 512]."""

    def conv(x, w, b):  # w [k, in, out] (Flax's WIO); stride 2, pad 1
        y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, stride=2, padding=1)
        return y.transpose(1, 2)

    h = leaky_relu(conv(motion, params["conv1"]["kernel"], params["conv1"]["bias"]))
    h = leaky_relu(conv(h, params["conv2"]["kernel"], params["conv2"]["bias"]))
    return h @ params["out"]["kernel"] + params["out"]["bias"]


def _bigru_co(params: dict, inputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    B = inputs.shape[0]
    emb = inputs @ params["input_emb"]["kernel"] + params["input_emb"]["bias"]
    H = params["h0"].shape[-1]
    hf = gru_scan(emb, lengths, params["gru_f"], params["h0"][0].expand(B, H))
    hb = gru_scan(emb, lengths, params["gru_b"], params["h0"][1].expand(B, H), reverse=True)
    h = torch.cat([hf, hb], dim=-1)
    h = h @ params["out1"]["kernel"] + params["out1"]["bias"]
    mean = h.mean(dim=-1, keepdim=True)
    var = h.var(dim=-1, keepdim=True, unbiased=False)
    h = (h - mean) / torch.sqrt(var + 1e-5)
    h = leaky_relu(h * params["ln"]["scale"] + params["ln"]["bias"])
    return h @ params["out2"]["kernel"] + params["out2"]["bias"]


def motion_encode(params: dict, movements: torch.Tensor, m_lens: torch.Tensor) -> torch.Tensor:
    return _bigru_co(params, movements, m_lens)


def text_encode(params: dict, word_embs: torch.Tensor, pos_onehot: torch.Tensor,
                cap_lens: torch.Tensor) -> torch.Tensor:
    pos = pos_onehot @ params["pos_emb"]["kernel"] + params["pos_emb"]["bias"]
    return _bigru_co(params, word_embs + pos, cap_lens)


# --------------------------------------------------------------------------- #
# Wrapper (reference EvaluatorMDMWrapper:121)
# --------------------------------------------------------------------------- #
def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in tree.items()}


class EvaluatorWrapper:
    """Holds the evaluator's parameters on `device` (CUDA unless the caller
    passes "cpu"); numpy in, numpy out, computed in full float32."""

    def __init__(self, params: dict, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    @torch.no_grad()
    @float32_exact()
    def _motion_embeddings(self, motions: np.ndarray, m_lens: np.ndarray) -> torch.Tensor:
        motions = self._tensor(motions)
        m_lens = self._tensor(m_lens, torch.int64)
        movements = movement_encode(self.params["movement"], motions[..., :-4])
        return motion_encode(self.params["motion"], movements,
                             torch.div(m_lens, UNIT_LENGTH, rounding_mode="floor"))

    # -- public API (sort-by-length quirk preserved) ---------------------- #
    @torch.no_grad()
    @float32_exact()
    def get_co_embeddings(self, word_embs, pos_ohot, cap_lens, motions, m_lens):
        align_idx = np.argsort(np.asarray(m_lens))[::-1].copy()
        motion_emb = self._motion_embeddings(np.asarray(motions)[align_idx],
                                             np.asarray(m_lens)[align_idx])
        text_emb = text_encode(self.params["text"], self._tensor(word_embs),
                               self._tensor(pos_ohot), self._tensor(cap_lens, torch.int64))
        return text_emb.cpu().numpy()[align_idx], motion_emb.cpu().numpy()

    def get_motion_embeddings(self, motions, m_lens):
        align_idx = np.argsort(np.asarray(m_lens))[::-1].copy()
        return self._motion_embeddings(np.asarray(motions)[align_idx],
                                       np.asarray(m_lens)[align_idx]).cpu().numpy()

    # -- constructors ------------------------------------------------------ #
    @classmethod
    def random_init(cls, seed: int = 0, dim_pose: int = 263,
                    device: str | torch.device = "cuda") -> "EvaluatorWrapper":
        """Random weights (pipeline tests / relative comparisons only); the JAX
        package's draws."""
        rng = np.random.default_rng(seed)
        H, E, W, P = 1024, 512, 300, 15

        def dense(i, o):
            return {
                "kernel": rng.normal(0, 0.02, (i, o)).astype(np.float32),
                "bias": np.zeros(o, np.float32),
            }

        def gru(i, h):
            return {
                "wi": rng.normal(0, 0.02, (3 * h, i)).astype(np.float32),
                "wh": rng.normal(0, 0.02, (3 * h, h)).astype(np.float32),
                "bi": np.zeros(3 * h, np.float32),
                "bh": np.zeros(3 * h, np.float32),
            }

        params = {
            "movement": {
                "conv1": {
                    "kernel": rng.normal(0, 0.02, (4, dim_pose - 4, E)).astype(np.float32),
                    "bias": np.zeros(E, np.float32),
                },
                "conv2": {
                    "kernel": rng.normal(0, 0.02, (4, E, E)).astype(np.float32),
                    "bias": np.zeros(E, np.float32),
                },
                "out": dense(E, E),
            },
            "motion": {
                "input_emb": dense(E, H),
                "gru_f": gru(H, H),
                "gru_b": gru(H, H),
                "h0": rng.normal(0, 1, (2, H)).astype(np.float32),
                "out1": dense(2 * H, H),
                "ln": {"scale": np.ones(H, np.float32), "bias": np.zeros(H, np.float32)},
                "out2": dense(H, E),
            },
            "text": {
                "pos_emb": dense(P, W),
                "input_emb": dense(W, E),
                "gru_f": gru(E, E),
                "gru_b": gru(E, E),
                "h0": rng.normal(0, 1, (2, E)).astype(np.float32),
                "out1": dense(2 * E, E),
                "ln": {"scale": np.ones(E, np.float32), "bias": np.zeros(E, np.float32)},
                "out2": dense(E, E),
            },
        }
        return cls(params, device)

    @classmethod
    def from_torch_checkpoint(cls, path: str,
                              device: str | torch.device = "cuda") -> "EvaluatorWrapper":
        """Convert the reference `text_mot_match/model/finest.tar`."""
        blob = torch.load(path, map_location="cpu", weights_only=False)

        def npy(t):
            return t.detach().cpu().numpy()

        def dense(sd, pre):
            return {"kernel": npy(sd[f"{pre}.weight"]).T, "bias": npy(sd[f"{pre}.bias"])}

        def gru_dir(sd, pre, suffix=""):
            return {
                "wi": npy(sd[f"{pre}.weight_ih_l0{suffix}"]),
                "wh": npy(sd[f"{pre}.weight_hh_l0{suffix}"]),
                "bi": npy(sd[f"{pre}.bias_ih_l0{suffix}"]),
                "bh": npy(sd[f"{pre}.bias_hh_l0{suffix}"]),
            }

        def bigru(sd):
            return {
                "input_emb": dense(sd, "input_emb"),
                "gru_f": gru_dir(sd, "gru"),
                "gru_b": gru_dir(sd, "gru", "_reverse"),
                "h0": npy(sd["hidden"])[:, 0, :],
                "out1": dense(sd, "output_net.0"),
                "ln": {"scale": npy(sd["output_net.1.weight"]),
                       "bias": npy(sd["output_net.1.bias"])},
                "out2": dense(sd, "output_net.3"),
            }

        mov = blob["movement_encoder"]
        params = {
            "movement": {
                "conv1": {
                    "kernel": np.transpose(npy(mov["main.0.weight"]), (2, 1, 0)),
                    "bias": npy(mov["main.0.bias"]),
                },
                "conv2": {
                    "kernel": np.transpose(npy(mov["main.3.weight"]), (2, 1, 0)),
                    "bias": npy(mov["main.3.bias"]),
                },
                "out": {"kernel": npy(mov["out_net.weight"]).T, "bias": npy(mov["out_net.bias"])},
            },
            "motion": bigru(blob["motion_encoder"]),
            "text": {"pos_emb": dense(blob["text_encoder"], "pos_emb"),
                     **bigru(blob["text_encoder"])},
        }
        return cls(params, device)
