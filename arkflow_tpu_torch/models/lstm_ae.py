"""LSTM autoencoder anomaly scorer (sensor telemetry -> anomaly score).

Counterpart of ``arkflow_tpu/models/lstm_ae.py``. An encoder LSTM
compresses a [B, T, F] window to a latent, a decoder LSTM reconstructs it
from the latent fed at every step, and the anomaly score is each window's
reconstruction MSE. Everything runs in float32. The recurrence is a Python
loop over the time steps (the JAX ``lax.scan``); each step's four gates come
from one ``[F + H, 4H]`` product. ``loss_fn`` and ``make_train_step`` raise
"not yet ported" (training comes with ``gpu_train``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from arkflow_tpu_torch.errors import ConfigError, not_ported
from arkflow_tpu_torch.models import common as cm
from arkflow_tpu_torch.models.registry import ModelFamily, register_model


@dataclass(frozen=True)
class LstmAeConfig:
    features: int = 8
    hidden: int = 64
    latent: int = 16
    window: int = 32  # time steps per example


def make_config(**overrides) -> LstmAeConfig:
    unknown = sorted(set(overrides) - {f.name for f in dataclasses.fields(LstmAeConfig)})
    if unknown:
        raise ConfigError(f"lstm_ae: unknown model_config keys {unknown}")
    return LstmAeConfig(**overrides)


def _lstm_init(gen: torch.Generator, in_dim: int, hidden: int) -> dict:
    return cm.dense_init(gen, in_dim + hidden, 4 * hidden)


def _lstm_scan(p: dict, xs: torch.Tensor, hidden: int):
    """xs: [T, B, F] -> (final (h, c), outputs [T, B, H]). The gates of a
    step come from one float32 product, split i, f, g, o; the forget gate
    takes a bias of 1."""
    b = xs.shape[1]
    h = torch.zeros(b, hidden, dtype=torch.float32, device=xs.device)
    c = torch.zeros_like(h)
    ys = []
    for x in xs:
        z = cm.dense(p, torch.cat([x, h], dim=-1), dtype=torch.float32)
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return (h, c), torch.stack(ys)


def init(gen: torch.Generator, cfg: LstmAeConfig) -> dict:
    """Params on the CPU in float32, drawn from ``gen``: the JAX ``init``'s
    shapes and distributions (the numbers differ: another generator)."""
    return {
        "encoder": _lstm_init(gen, cfg.features, cfg.hidden),
        "to_latent": cm.dense_init(gen, cfg.hidden, cfg.latent),
        "from_latent": cm.dense_init(gen, cfg.latent, cfg.hidden),
        "decoder": _lstm_init(gen, cfg.hidden, cfg.hidden),
        "head": cm.dense_init(gen, cfg.hidden, cfg.features),
    }


def apply(params: dict, cfg: LstmAeConfig, *, values: torch.Tensor) -> dict:
    """values: [B, T, F] sensor windows -> {"score": [B] reconstruction MSE,
    "reconstruction": [B, T, F]}, float32."""
    values = values.float()
    (h, _), _ = _lstm_scan(params["encoder"], values.transpose(0, 1), cfg.hidden)
    latent = torch.tanh(cm.dense(params["to_latent"], h, dtype=torch.float32))
    seed = cm.dense(params["from_latent"], latent, dtype=torch.float32)
    # the decoder takes the latent seed at every step
    dec_in = seed[None].expand(cfg.window, *seed.shape)
    _, ys = _lstm_scan(params["decoder"], dec_in, cfg.hidden)
    recon = cm.dense(params["head"], ys, dtype=torch.float32).transpose(0, 1)  # [B, T, F]
    err = (recon - values).square().mean(dim=(1, 2))
    return {"score": err, "reconstruction": recon}


def loss_fn(params: dict, cfg: LstmAeConfig, values):
    raise not_ported("lstm_ae loss_fn (training)")


def make_train_step(cfg: LstmAeConfig, optimizer):
    raise not_ported("lstm_ae make_train_step (training)")


def input_spec(cfg: LstmAeConfig) -> dict:
    return {"values": ("float32", (cfg.window, cfg.features))}


register_model(
    ModelFamily(
        name="lstm_ae",
        make_config=make_config,
        init=init,
        apply=apply,
        input_spec=input_spec,
        extras={"loss_fn": loss_fn, "make_train_step": make_train_step},
    )
)
