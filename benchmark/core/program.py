"""The system under test, built through the port's own entry points: the card's
arguments (`utils.config.CARDS`), `models.factory.create_model` and
`create_gaussian_diffusion`, the weights loaded into the model's state_dict."""

from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def card_args(config: dict):
    from condmdi_tpu_torch.utils.config import CARDS

    return dataclasses.replace(CARDS[config["card"]](), **config.get("card_overrides", {}))


def reference_module(config: dict):
    import importlib

    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def make_weights(config: dict, seed: int, device, dtype: str):
    from benchmark.core import weights

    return weights.make(reference_module(config).param_specs(config), seed, device, DTYPES[dtype])


def build(config: dict, seed: int, device, dtype: str, train: bool = False):
    """(model, sched, dcfg, args): the card's model on `device` with the seed's
    weights in `dtype`, and its diffusion."""
    from condmdi_tpu_torch.models.factory import create_gaussian_diffusion, create_model
    from condmdi_tpu_torch.models.unet import cast_weights

    args = card_args(config)
    model = create_model(args, device)
    if DTYPES[dtype] != torch.float32:
        cast_weights(model, DTYPES[dtype])
    w = make_weights(config, seed, device, dtype)
    model.load_state_dict(w, strict=True)
    del w
    model.train(train).requires_grad_(train)
    sched, dcfg = create_gaussian_diffusion(args)
    return model, sched, dcfg, args
