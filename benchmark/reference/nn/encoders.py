"""Pose and style encoders (port of pasta_tpu/nn/encoders.py). Sequential
children are ModuleLists named `model` / `feat_enc`, so their state-dict
keys are the reference's `model.0...`."""

from __future__ import annotations

import torch.nn as nn

from .layers import Conv2dLayer, Dense, FullyConnectedLayer


class ConstEncoderNetwork(nn.Module):
    """Pose encoder: e.g. 5ch @ 512^2 -> 512ch @ 8^2 via 6 stride-2 convs."""

    def __init__(self, input_nc, output_nc, ngf=64, n_downsampling=6):
        super().__init__()
        if n_downsampling == 6:
            mult_ins = [1, 2, 4, 4, 4, 8]
            mult_outs = [2, 4, 4, 4, 8, 8]
        else:
            mult_ins = [min(2 ** i, 8) for i in range(n_downsampling)]
            mult_outs = [min(2 ** (i + 1), 8) for i in range(n_downsampling)]
            mult_outs[-1] = 8
            if n_downsampling >= 2:
                mult_ins[-1] = mult_outs[-2]
        layers = [Conv2dLayer(input_nc, ngf, kernel_size=1)]
        for i in range(n_downsampling):
            layers.append(Conv2dLayer(ngf * mult_ins[i], ngf * mult_outs[i],
                                      kernel_size=3, down=2))
        self.model = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.model:
            x = layer(x)
        return x


class StyleEncoderNetwork(nn.Module):
    """Garment-patch style path -> 512-d code, plus the retain-input
    pyramid whose 4 feature maps are skip-injected into the generator."""

    def __init__(self, input_nc, output_nc, ngf=64):
        super().__init__()
        self.feat_enc = nn.ModuleList(
            [Conv2dLayer(6, ngf, kernel_size=3)]
            + [Conv2dLayer(ngf, ngf, kernel_size=3, down=2)
               for _ in range(3)])
        layers = [Conv2dLayer(input_nc, ngf, kernel_size=1)]
        for mult_in, mult_out in zip([1, 2, 4], [2, 4, 8]):
            layers += [Dense(ngf * mult_in, ngf * mult_in),
                       Conv2dLayer(ngf * mult_in, ngf * mult_out,
                                   kernel_size=3, down=2)]
        for _ in range(3):
            layers += [Dense(ngf * 8, ngf * 8),
                       Conv2dLayer(ngf * 8, ngf * 8, kernel_size=3)]
        self.model = nn.ModuleList(layers)
        self.fc = FullyConnectedLayer(output_nc, output_nc)

    def forward(self, x, const_input):
        const_feats = []
        feat = const_input
        for layer in self.feat_enc:
            feat = layer(feat)
            const_feats.append(feat)
        for layer in self.model:
            x = layer(x)
        x = x.mean(dim=(1, 2))  # AdaptiveAvgPool2d(1) + flatten
        return self.fc(x), const_feats
