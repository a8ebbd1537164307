"""Action-to-motion evaluation (reference eval/eval_humanact12_uestc.py,
eval/a2m/gru_eval.py and the action2motion GRU classifier).

Counterpart of condmdi_tpu/evals/a2m.py. Metrics: recognition accuracy, FID
over the classifier's features and diversity, from a GRU action-recognition
model (`A2MClassifier`; the reference's `humanact12_gru.tar` converts through
`from_torch_checkpoint`, `random_init` keeps the protocol runnable without it)
or ST-GCN (`STGCNClassifier`, the UESTC path). The networks run on `device`
(the card unless the caller passes "cpu"), in float32, as plain PyTorch: the
GRU through evals.evaluator's `gru_scan` (torch's gate math, a loop over time
with masked carries), ST-GCN through evals.stgcn. `random_init` makes the JAX
package's numpy draws in its order, so the same seed gives the same weights.
The metrics are evals.metrics, numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.evals import metrics as M
from condmdi_tpu_torch.evals.evaluator import gru_scan
from condmdi_tpu_torch.evals.stgcn import params_to_tensors


class A2MClassifier:
    """GRU recognition model: motion [B, T, F] → (logits, features), numpy."""

    def __init__(self, params: dict, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.params = params_to_tensors(params, self.device)

    def forward(self, motion: torch.Tensor, lengths: torch.Tensor):
        p = self.params
        h = motion @ p["input_emb"]["kernel"] + p["input_emb"]["bias"]
        h0 = p["h0"][0].expand(h.shape[0], -1)
        feat = gru_scan(h, lengths, p["gru"], h0)
        return feat @ p["out"]["kernel"] + p["out"]["bias"], feat

    @torch.no_grad()
    def __call__(self, motion, lengths):
        motion = torch.as_tensor(np.asarray(motion, np.float32), device=self.device)
        lengths = torch.as_tensor(np.asarray(lengths), device=self.device).long()
        logits, feat = self.forward(motion, lengths)
        return logits.cpu().numpy(), feat.cpu().numpy()

    @classmethod
    def random_init(cls, input_dim: int = 150, hidden: int = 128, num_actions: int = 12,
                    seed: int = 0, device: str | torch.device = "cuda") -> "A2MClassifier":
        rng = np.random.default_rng(seed)

        def dense(i, o):
            return {"kernel": rng.normal(0, 0.05, (i, o)).astype(np.float32),
                    "bias": np.zeros(o, np.float32)}

        params = {
            "input_emb": dense(input_dim, hidden),
            "gru": {
                "wi": rng.normal(0, 0.05, (3 * hidden, hidden)).astype(np.float32),
                "wh": rng.normal(0, 0.05, (3 * hidden, hidden)).astype(np.float32),
                "bi": np.zeros(3 * hidden, np.float32),
                "bh": np.zeros(3 * hidden, np.float32),
            },
            "h0": rng.normal(0, 1, (1, hidden)).astype(np.float32),
            "out": dense(hidden, num_actions),
        }
        return cls(params, device)

    @classmethod
    def from_torch_checkpoint(cls, path: str,
                              device: str | torch.device = "cuda") -> "A2MClassifier":
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        npy = lambda t: t.detach().cpu().numpy()  # noqa: E731
        params = {
            "input_emb": {"kernel": npy(sd["embedding.weight"]).T,
                          "bias": npy(sd["embedding.bias"])},
            "gru": {
                "wi": npy(sd["gru.weight_ih_l0"]),
                "wh": npy(sd["gru.weight_hh_l0"]),
                "bi": npy(sd["gru.bias_ih_l0"]),
                "bh": npy(sd["gru.bias_hh_l0"]),
            },
            "h0": np.zeros((1, sd["gru.weight_hh_l0"].shape[1]), np.float32),
            "out": {"kernel": npy(sd["out.weight"]).T, "bias": npy(sd["out.bias"])},
        }
        return cls(params, device)


class STGCNClassifier:
    """ST-GCN recognition wrapper (the UESTC path; reference stgcn_eval.py).

    motion arrives as [B, T, V, C] joints (rot6d: C = 6); the network reads
    [B, C, T, V].
    """

    def __init__(self, params: dict, layout: str = "smpl_noglobal", strategy: str = "spatial",
                 device: str | torch.device = "cuda"):
        from condmdi_tpu_torch.evals.stgcn import build_graph

        self.device = resolve_device(device)
        self.params = params_to_tensors(params, self.device)
        self.A = torch.as_tensor(build_graph(layout, strategy), dtype=torch.float32,
                                 device=self.device)

    @torch.no_grad()
    def __call__(self, motion, lengths=None):
        """motion [B, T, V, C] → (logits, features), numpy."""
        from condmdi_tpu_torch.evals.stgcn import stgcn_forward

        x = torch.as_tensor(np.asarray(motion, np.float32), device=self.device)
        logits, feat = stgcn_forward(self.params, x.permute(0, 3, 1, 2), self.A)
        return logits.cpu().numpy(), feat.cpu().numpy()

    @classmethod
    def from_torch_checkpoint(cls, path: str, device: str | torch.device = "cuda",
                              **kw) -> "STGCNClassifier":
        from condmdi_tpu_torch.evals.stgcn import convert_stgcn_state_dict

        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        return cls(convert_stgcn_state_dict(sd), device=device, **kw)

    @classmethod
    def random_init(cls, in_channels: int = 6, num_class: int = 12, layout: str = "smpl",
                    strategy: str = "spatial", seed: int = 0,
                    device: str | torch.device = "cuda") -> "STGCNClassifier":
        """The asset-free fallback (relative comparisons only)."""
        from condmdi_tpu_torch.evals.stgcn import build_graph, random_params

        A = build_graph(layout, strategy)
        return cls(random_params(in_channels, num_class, A.shape[-1], A.shape[0], seed),
                   layout=layout, strategy=strategy, device=device)


def evaluate_a2m(
    classifier,
    gt_motions: np.ndarray,
    gt_lengths: np.ndarray,
    gt_actions: np.ndarray,
    gen_motions: np.ndarray,
    gen_lengths: np.ndarray,
    gen_actions: np.ndarray,
    diversity_times: int = 20,
    rng=None,
) -> dict:
    """Accuracy / FID / diversity (the reference gru_eval.py protocol)."""
    rng = rng or np.random.default_rng(0)
    logits_gen, feat_gen = classifier(gen_motions, gen_lengths)
    _, feat_gt = classifier(gt_motions, gt_lengths)

    accuracy = float((logits_gen.argmax(axis=1) == gen_actions).mean())
    mu_gt, cov_gt = M.calculate_activation_statistics(feat_gt)
    mu_gen, cov_gen = M.calculate_activation_statistics(feat_gen)
    fid = M.calculate_frechet_distance(mu_gt, cov_gt, mu_gen, cov_gen)
    dt = min(diversity_times, len(feat_gen) - 1)
    diversity = M.calculate_diversity(feat_gen, dt, rng=rng)
    return dict(accuracy=accuracy, fid=fid, diversity=float(diversity))
