"""Mapping network z, c -> w with w_avg tracking and truncation (port of
pasta_tpu/nn/mapping.py). The fashion config: z_dim=0, c_dim=512 (the
style-encoder code), num_layers=1, lr_multiplier=0.01."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .layers import FullyConnectedLayer, _const, add_buffer, normalize_2nd_moment


class MappingNetwork(nn.Module):
    def __init__(self, z_dim, c_dim, w_dim, num_ws: Optional[int],
                 num_layers=8, embed_features=None, layer_features=None,
                 activation="lrelu", lr_multiplier=0.01,
                 w_avg_beta: Optional[float] = 0.995):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.num_ws, self.num_layers = num_ws, num_layers
        self.w_avg_beta = w_avg_beta
        if embed_features is None:
            embed_features = w_dim
        if c_dim == 0:
            embed_features = 0
        layer_features = layer_features or w_dim
        features = ([z_dim + embed_features]
                    + [layer_features] * (num_layers - 1) + [w_dim])
        if c_dim > 0:
            self.embed = FullyConnectedLayer(c_dim, embed_features)
        for idx in range(num_layers):
            self.add_module(f"fc{idx}", FullyConnectedLayer(
                features[idx], features[idx + 1], activation=activation,
                lr_multiplier=lr_multiplier))
        if num_ws is not None and w_avg_beta is not None:
            add_buffer(self, "w_avg", (w_dim,), _const(0.0))

    def forward(self, z, c, truncation_psi=1.0, truncation_cutoff=None,
                update_w_avg=False):
        x = None
        if self.z_dim > 0:
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1) if x is not None else y

        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)

        if update_w_avg and self.num_ws is not None \
                and self.w_avg_beta is not None:
            self.w_avg.copy_(x.detach().mean(dim=0) * (1 - self.w_avg_beta)
                             + self.w_avg * self.w_avg_beta)

        if self.num_ws is not None:
            x = x[:, None, :].repeat(1, self.num_ws, 1)

        if truncation_psi != 1:
            assert self.w_avg_beta is not None
            if self.num_ws is None or truncation_cutoff is None:
                x = self.w_avg + truncation_psi * (x - self.w_avg)
            else:
                head = self.w_avg + truncation_psi * (
                    x[:, :truncation_cutoff] - self.w_avg)
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x
