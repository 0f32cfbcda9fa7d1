"""Patch co-occurrence discriminator (swapping-autoencoder style), port of
pasta_tpu/models/patch_discriminator.py.

Capability parity for the reference StyleGAN2PatchDiscriminator(_V2)
(networks.py:1182-1515; unused by the shipped fullbody loss but part of the
repo's surface). The reference builds it from a vendored rosinality layer
family (its second, duplicated StyleGAN2 implementation); as in the JAX
package, the same co-occurrence architecture is expressed here with the
port's Conv2dLayer / FullyConnectedLayer / ResBlock (nn/layers.py).

Architecture (networks.py:1374-1418): K random crops of the target and
(for the non-V2 variant) reference images, each encoded by a shared conv
encoder; the reference features averaged; (target, reference) feature
pairs scored by a pairlinear MLP. V2 drops the reference branch. The
crops come from `crops()`, random resized crops drawn from an explicit
torch.Generator (nn/legacy.py::apply_random_crop, the reference's
util.apply_random_crop).

The encoder's 4x4 features flatten in NHWC order, as in the JAX package
(whose weights cross by name through io/from_jax.py::jax_to_state_dict);
parameters are drawn at construction from a CPU torch.Generator seeded
with `seed`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.layers import (Conv2dLayer, FullyConnectedLayer, ResBlock,
                         init_weights)
from ..nn.legacy import apply_random_crop


class PatchEncoder(nn.Module):
    """Shared crop encoder: fromrgb + downsampling resblocks to 4x4."""

    def __init__(self, crop_size=64, channel_base=2048, channel_max=256):
        super().__init__()

        def ch(r):
            return min(channel_base // r, channel_max)

        self.fromrgb = Conv2dLayer(3, ch(crop_size), kernel_size=1,
                                   activation="lrelu")
        self.block_resolutions = []
        res = crop_size
        while res > 4:
            setattr(self, f"b{res}", ResBlock(ch(res), ch(res // 2),
                                              kernel_size=3,
                                              activation="lrelu", down=2))
            self.block_resolutions.append(res)
            res //= 2
        self.conv4 = Conv2dLayer(ch(4), ch(4), kernel_size=3,
                                 activation="lrelu")
        self.fc = FullyConnectedLayer(ch(4) * 16, ch(4), activation="lrelu")

    def forward(self, x):
        x = self.fromrgb(x)
        for res in self.block_resolutions:
            x = getattr(self, f"b{res}")(x)
        x = self.conv4(x)
        return self.fc(x.reshape(x.shape[0], -1))


class PatchCoOccurrenceDiscriminator(nn.Module):
    """Score whether target crops share texture statistics with reference
    crops. use_reference=False gives the V2 variant (networks.py:
    1496-1515)."""

    def __init__(self, crop_size=64, num_crops=8, use_reference=True,
                 channel_max=256, seed=0):
        super().__init__()
        self.crop_size, self.num_crops = crop_size, num_crops
        self.use_reference = use_reference
        self.encoder = PatchEncoder(crop_size=crop_size,
                                    channel_max=channel_max)
        feat_dim = min(2048 // 4, channel_max)
        in_dim = feat_dim * 2 if use_reference else feat_dim
        self.pairlinear = nn.ModuleList([
            FullyConnectedLayer(in_dim, feat_dim, activation="lrelu"),
            FullyConnectedLayer(feat_dim, feat_dim, activation="lrelu"),
            FullyConnectedLayer(feat_dim, 1)])
        init_weights(self, torch.Generator().manual_seed(seed))

    def crops(self, images, generator, num_crops=None,
              scale_range=(0.25, 0.5)):
        """[N, H, W, 3] images -> [N, K, crop, crop, 3] random resized
        crops (K = num_crops or the module's), drawn from `generator`."""
        return apply_random_crop(images, generator, self.crop_size,
                                 scale_range=scale_range,
                                 num_crops=num_crops or self.num_crops)

    def forward(self, target_crops, reference_crops=None):
        """target_crops: [N, K, crop, crop, 3]; reference_crops:
        [N, Kr, crop, crop, 3] (required unless V2). Returns [N, K]."""
        n, k = target_crops.shape[:2]
        t_feat = self.encoder(target_crops.reshape(
            (-1,) + tuple(target_crops.shape[2:]))).reshape(n, k, -1)
        if self.use_reference:
            assert reference_crops is not None
            kr = reference_crops.shape[1]
            r_feat = self.encoder(reference_crops.reshape(
                (-1,) + tuple(reference_crops.shape[2:])))
            r_feat = r_feat.reshape(n, kr, -1).mean(dim=1, keepdim=True)
            pair = torch.cat([t_feat, r_feat.expand(t_feat.shape)], dim=-1)
        else:
            pair = t_feat
        h = pair.reshape(n * k, -1)
        for layer in self.pairlinear:
            h = layer(h)
        return h.reshape(n, k)
