"""ST-GCN action-recognition network on tensors (UESTC / unconstrained eval).

Counterpart of condmdi_tpu/evals/stgcn.py (reference
eval/a2m/recognition/models/stgcn.py: STGCN, the st_gcn block,
ConvTemporalGraphical; stgcnutils/graph.py: the adjacency with uniform,
distance and spatial partitioning). `build_graph`, `convert_stgcn_state_dict`
and `random_params` are numpy copies of the JAX package's (the same seed gives
the same weights); the forward runs on a parameter tree of tensors
(`params_to_tensors`) with `F.conv2d` and eval-mode batch norms (the
checkpoint's running statistics). No kernel of the port runs here: on the card
these are cuDNN and cuBLAS calls.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21]
)


# --------------------------------------------------------------------------- #
# Graph construction (reference stgcnutils/graph.py)
# --------------------------------------------------------------------------- #
def _hop_distance(num_node: int, edges, max_hop: int = 1) -> np.ndarray:
    A = np.zeros((num_node, num_node))
    for i, j in edges:
        A[i, j] = 1
        A[j, i] = 1
    hop_dis = np.full((num_node, num_node), np.inf)
    transfer = [np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]
    arrive = np.stack(transfer) > 0
    for d in range(max_hop, -1, -1):
        hop_dis[arrive[d]] = d
    return hop_dis


def _normalize_digraph(A: np.ndarray) -> np.ndarray:
    Dl = A.sum(0)
    Dn = np.zeros_like(A)
    for i in range(A.shape[0]):
        if Dl[i] > 0:
            Dn[i, i] = Dl[i] ** -1
    return A @ Dn


def build_graph(layout: str = "smpl", strategy: str = "spatial", max_hop: int = 1):
    """Adjacency stack [K, V, V] for the given skeleton layout."""
    if layout == "smpl":
        num_node = 24
        edges = [(i, i) for i in range(num_node)] + [
            (j, int(SMPL_PARENTS[j])) for j in range(1, num_node)
        ]
        center = 0
    elif layout == "smpl_noglobal":
        num_node = 23
        links = [
            (j - 1, int(SMPL_PARENTS[j]) - 1)
            for j in range(1, 24)
            if SMPL_PARENTS[j] != 0
        ]
        edges = [(i, i) for i in range(num_node)] + links
        center = 0
    elif layout == "openpose":
        num_node = 18
        neighbor = [(4, 3), (3, 2), (7, 6), (6, 5), (13, 12), (12, 11),
                    (10, 9), (9, 8), (11, 5), (8, 2), (5, 1), (2, 1), (0, 1),
                    (15, 0), (14, 0), (17, 15), (16, 14)]
        edges = [(i, i) for i in range(num_node)] + neighbor
        center = 1
    else:
        raise NotImplementedError(layout)

    hop_dis = _hop_distance(num_node, edges, max_hop)
    valid_hop = range(0, max_hop + 1)
    adjacency = np.zeros((num_node, num_node))
    for hop in valid_hop:
        adjacency[hop_dis == hop] = 1
    norm_adj = _normalize_digraph(adjacency)

    if strategy == "uniform":
        return norm_adj[None]
    if strategy == "distance":
        A = np.zeros((len(list(valid_hop)), num_node, num_node))
        for i, hop in enumerate(valid_hop):
            A[i][hop_dis == hop] = norm_adj[hop_dis == hop]
        return A
    if strategy == "spatial":
        A = []
        for hop in valid_hop:
            a_root = np.zeros((num_node, num_node))
            a_close = np.zeros((num_node, num_node))
            a_further = np.zeros((num_node, num_node))
            for i in range(num_node):
                for j in range(num_node):
                    if hop_dis[j, i] == hop:
                        if hop_dis[j, center] == hop_dis[i, center]:
                            a_root[j, i] = norm_adj[j, i]
                        elif hop_dis[j, center] > hop_dis[i, center]:
                            a_close[j, i] = norm_adj[j, i]
                        else:
                            a_further[j, i] = norm_adj[j, i]
            if hop == 0:
                A.append(a_root)
            else:
                A.append(a_root + a_close)
                A.append(a_further)
        return np.stack(A)
    raise NotImplementedError(strategy)


# --------------------------------------------------------------------------- #
# Forward (eval-mode BatchNorms)
# --------------------------------------------------------------------------- #
def params_to_tensors(params, device: str | torch.device = "cuda"):
    """The numpy parameter tree as float32 tensors on `device`, same structure."""
    if isinstance(params, dict):
        return {k: params_to_tensors(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_tensors(v, device) for v in params]
    return torch.as_tensor(np.asarray(params, np.float32), device=device)


def _bn(x: torch.Tensor, p: dict, axis: int) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[axis] = -1
    return ((x - p["mean"].reshape(shape)) / torch.sqrt(p["var"].reshape(shape) + 1e-5)
            * p["scale"].reshape(shape) + p["bias"].reshape(shape))


def _conv2d(x: torch.Tensor, p: dict, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    return F.conv2d(x, p["kernel"], p.get("bias"), stride=stride, padding=padding)


def _st_gcn_block(x: torch.Tensor, A: torch.Tensor, p: dict, stride: int,
                  residual: bool) -> torch.Tensor:
    """x [N, C, T, V]; A [K, V, V] (already importance-weighted)."""
    K = A.shape[0]
    # spatial graph conv: 1x1 conv to K*C_out, contracted with A
    h = _conv2d(x, p["gcn"])
    N, KC, T, V = h.shape
    h = torch.einsum("nkctv,kvw->nctw", h.reshape(N, K, KC // K, T, V), A)
    # temporal conv: BN → ReLU → Conv(9, 1) → BN (dropout: eval, none)
    h = F.relu(_bn(h, p["tcn_bn1"], axis=1))
    h = _bn(_conv2d(h, p["tcn"], stride=(stride, 1), padding=(4, 0)), p["tcn_bn2"], axis=1)
    if residual:
        if "res" in p:
            r = _bn(_conv2d(x, p["res"], stride=(stride, 1)), p["res_bn"], axis=1)
        else:
            r = x
        h = h + r
    return F.relu(h)


STGCN_CHANNELS = [(None, 64, 1, False)] + [(64, 64, 1, True)] * 3 + [
    (64, 128, 2, True), (128, 128, 1, True), (128, 128, 1, True),
    (128, 256, 2, True), (256, 256, 1, True), (256, 256, 1, True),
]


def stgcn_forward(params: dict, x: torch.Tensor, A: torch.Tensor):
    """x: [N, C, T, V] → (logits [N, num_class], features [N, 256])."""
    N, C, T, V = x.shape
    # data_bn over the V*C channels of [N, V*C, T]
    h = x.permute(0, 3, 1, 2).reshape(N, V * C, T)
    h = _bn(h, params["data_bn"], axis=1)
    h = h.reshape(N, V, C, T).permute(0, 2, 3, 1)  # [N, C, T, V]
    for i, (_, _, stride, residual) in enumerate(STGCN_CHANNELS):
        Ai = A * params["edge_importance"][i] if "edge_importance" in params else A
        h = _st_gcn_block(h, Ai, params[f"block{i}"], stride, residual)
    feat = h.mean(dim=(2, 3))  # global average pool → [N, 256]
    logits = feat @ params["fcn"]["kernel"] + params["fcn"]["bias"]
    return logits, feat


# --------------------------------------------------------------------------- #
# Torch checkpoint conversion
# --------------------------------------------------------------------------- #
def convert_stgcn_state_dict(sd: dict) -> dict:
    npy = lambda t: np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)

    def bn(pre):
        return {
            "scale": npy(sd[f"{pre}.weight"]), "bias": npy(sd[f"{pre}.bias"]),
            "mean": npy(sd[f"{pre}.running_mean"]), "var": npy(sd[f"{pre}.running_var"]),
        }

    params: dict = {"data_bn": bn("data_bn")}
    if "edge_importance.0" in sd:
        params["edge_importance"] = [
            npy(sd[f"edge_importance.{i}"]) for i in range(len(STGCN_CHANNELS))
        ]
    for i in range(len(STGCN_CHANNELS)):
        pre = f"st_gcn_networks.{i}"
        blk = {
            "gcn": {"kernel": npy(sd[f"{pre}.gcn.conv.weight"]),
                    "bias": npy(sd[f"{pre}.gcn.conv.bias"])},
            "tcn_bn1": bn(f"{pre}.tcn.0"),
            "tcn": {"kernel": npy(sd[f"{pre}.tcn.2.weight"]),
                    "bias": npy(sd[f"{pre}.tcn.2.bias"])},
            "tcn_bn2": bn(f"{pre}.tcn.3"),
        }
        if f"{pre}.residual.0.weight" in sd:
            blk["res"] = {"kernel": npy(sd[f"{pre}.residual.0.weight"]),
                          "bias": npy(sd[f"{pre}.residual.0.bias"])}
            blk["res_bn"] = bn(f"{pre}.residual.1")
        params[f"block{i}"] = blk
    params["fcn"] = {
        "kernel": npy(sd["fcn.weight"])[:, :, 0, 0].T,
        "bias": npy(sd["fcn.bias"]),
    }
    return params


def random_params(
    in_channels: int, num_class: int, num_nodes: int, K: int, seed: int = 0
) -> dict:
    """Random-init ST-GCN param tree matching convert_stgcn_state_dict's
    layout — the asset-free fallback feature extractor for the a2m /
    unconstrained protocol CLIs (relative comparisons only; absolute
    FID/accuracy need the reference recognition checkpoints)."""
    rng = np.random.default_rng(seed)

    def bn(c):
        return {
            "scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
            "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32),
        }

    def conv(cout, cin, kh, kw):
        fan = cin * kh * kw
        return {
            "kernel": rng.normal(0, np.sqrt(2.0 / fan), (cout, cin, kh, kw)).astype(np.float32),
            "bias": np.zeros(cout, np.float32),
        }

    params: dict = {"data_bn": bn(num_nodes * in_channels)}
    params["edge_importance"] = [
        np.ones((K, num_nodes, num_nodes), np.float32)
        for _ in range(len(STGCN_CHANNELS))
    ]
    c_in = in_channels
    for i, (_, c_out, stride, residual) in enumerate(STGCN_CHANNELS):
        blk = {
            "gcn": conv(K * c_out, c_in, 1, 1),
            "tcn_bn1": bn(c_out),
            "tcn": conv(c_out, c_out, 9, 1),
            "tcn_bn2": bn(c_out),
        }
        if residual and (c_in != c_out or stride != 1):
            blk["res"] = conv(c_out, c_in, 1, 1)
            blk["res_bn"] = bn(c_out)
        params[f"block{i}"] = blk
        c_in = c_out
    params["fcn"] = {
        "kernel": rng.normal(0, 0.05, (256, num_class)).astype(np.float32),
        "bias": np.zeros(num_class, np.float32),
    }
    return params
