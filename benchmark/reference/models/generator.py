"""PASTA-GAN++ generator: style branch + SPADE texture branch (NHWC), port of
pasta_tpu/models/generator.py.

Shipped fashion config: z_dim=0, c_dim=512, w_dim=512, img_resolution=512,
img_channels=3, channel_base=32768, channel_max=512, conv_clamp=256,
mapping num_layers=1. `num_bf16_res` runs the top resolutions (and the
conditioning encoders) in bf16 with fp32 params, as in the JAX package.
Remat has no counterpart in serving and is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..nn.encoders import ConstEncoderNetwork, StyleEncoderNetwork
from ..nn.layers import Conv2dLayer, ResBlock, init_weights
from ..nn.mapping import MappingNetwork
from ..nn.synthesis import SpadeResBlock, SynthesisBlockStyle, SynthesisBlockTexture
from ..shapes import assert_shape


def _channels_dict(resolutions, channel_base, channel_max):
    return {res: min(channel_base // res, channel_max) for res in resolutions}


def _nearest_half(x):
    """F.interpolate(scale_factor=0.5) (nearest): even-index subsampling."""
    return x[:, ::2, ::2, :]


class SynthesisNetwork(nn.Module):
    def __init__(self, w_dim, img_resolution, img_channels,
                 channel_base=32768, channel_max=512,
                 conv_clamp: Optional[float] = None, use_noise=True,
                 num_bf16_res=0):
        super().__init__()
        self.img_resolution = img_resolution
        self.num_bf16_res = num_bf16_res
        self.resolutions = [2 ** i for i in
                            range(3, int(math.log2(img_resolution)) + 1)]
        # b8 contributes 1 conv, every later block 2; +1 for the last torgb.
        self.num_ws = 1 + 2 * (len(self.resolutions) - 1) + 1
        res_log2 = int(math.log2(img_resolution))
        self.bf16_res = (max(2 ** (res_log2 + 1 - num_bf16_res), 16)
                         if num_bf16_res > 0 else img_resolution * 2)
        ch = _channels_dict(self.resolutions, channel_base, channel_max)
        self.channels = ch
        common = dict(w_dim=w_dim, img_channels=img_channels,
                      conv_clamp=conv_clamp, use_noise=use_noise)
        for res in self.resolutions:
            self.add_module(f"b{res}", SynthesisBlockStyle(
                ch[res // 2] if res > 8 else 0, ch[res], resolution=res,
                is_last=(res == img_resolution),
                use_bf16=(res >= self.bf16_res), **common))
        ngf = 64
        self.spade_encoder = nn.ModuleList([
            Conv2dLayer(3, ngf, kernel_size=7, activation="relu"),
            ResBlock(ngf, ngf, kernel_size=4, activation="relu"),
            ResBlock(ngf, ngf * 2, kernel_size=4, activation="relu", down=2),
        ])
        res_256, res_512 = self.resolutions[-2], self.resolutions[-1]
        for name in ("spade_b256_1", "spade_b256_2"):
            self.add_module(name, SpadeResBlock(
                ch[res_256], ch[res_256], spade_channels=128,
                conv_clamp=conv_clamp))
        self.texture_b512 = SynthesisBlockTexture(
            ch[res_512 // 2], ch[res_512], resolution=res_512, is_last=True,
            use_bf16=(res_512 >= self.bf16_res), **common)

    def _blk_dtype(self, res):
        return torch.bfloat16 if res >= self.bf16_res else torch.float32

    @staticmethod
    def _spade_prepare(mask_512, denorm_mask, denorm_input):
        """Masked encoder input + the valid / residual 256px region masks."""
        dt = mask_512.dtype
        mask_512 = (mask_512 > 0.9).to(dt)
        mask_256 = (_nearest_half(mask_512) > 0.9).to(dt)
        denorm_mask_256 = (_nearest_half(denorm_mask) > 0.9).to(dt)
        valid_mask = ((mask_256 + denorm_mask_256) == 2.0).to(dt)
        res_mask = mask_256 - valid_mask
        denorm_input = denorm_input * mask_512 - (1 - mask_512)
        return denorm_input, valid_mask, res_mask

    @staticmethod
    def _spade_fill(feat, valid_mask, res_mask):
        """Fill predicted-but-uncovered region with the masked average
        feature; stats accumulate in fp32."""
        valid_feat_sum = (feat * valid_mask.to(feat.dtype)).sum(
            dim=(1, 2), keepdim=True, dtype=torch.float32)
        valid_mask_sum = valid_mask.sum(dim=(1, 2), keepdim=True,
                                        dtype=torch.float32)
        valid_index = (valid_mask_sum > 10).float()
        num_px = feat.shape[1] * feat.shape[2]
        valid_mask_sum = valid_mask_sum * valid_index + num_px * (1 - valid_index)
        avg_feat = (valid_feat_sum / valid_mask_sum).to(feat.dtype)
        return (feat * (1 - res_mask).to(feat.dtype)
                + avg_feat * res_mask.to(feat.dtype))

    def forward(self, ws, pose_feat, cat_feat, denorm_upper_input,
                denorm_lower_input, denorm_upper_mask, denorm_lower_mask,
                gt_parsing=None, noise_mode="random", generator=None,
                style_only=False):
        """Returns (coarse img, finetune img, pred_parsing); with
        style_only=True only the style branch runs and the result is
        (coarse img, pred_parsing): what the parsing discriminator's phase
        and the path-length regularizer use."""
        resolutions = self.resolutions
        ws = ws.float()
        cat_cast = {res: cat_feat[str(res)].to(self._blk_dtype(res))
                    for res in resolutions
                    if res > 32 and str(res) in cat_feat}

        # Style branch: torgb of block k shares its w with block k+1's conv0.
        x = img = pred_parsing = None
        x_256 = img_256 = None
        w_idx = 0
        for res in resolutions:
            n_conv = 1 if res == 8 else 2
            cur_ws = ws[:, w_idx:w_idx + n_conv + 1]
            if x is not None:
                x = x.to(self._blk_dtype(res))
            x, img, pp = getattr(self, f"b{res}")(
                x, img, cur_ws, pose_feat, cat_cast.get(res), noise_mode,
                generator)
            if pp is not None:
                pred_parsing = pp
            if res == resolutions[-2]:
                x_256, img_256 = x, img
            w_idx += n_conv
        if style_only:
            return img, pred_parsing

        # Parsing-index map drives the SPADE texture branch.
        if gt_parsing is not None:
            parsing_index = gt_parsing
        else:
            probs = torch.softmax(pred_parsing.detach(), dim=-1)
            parsing_index = probs.argmax(dim=-1, keepdim=True).float()
        upper_mask = ((parsing_index == 1).float()
                      + (parsing_index == 4).float())
        lower_mask = ((parsing_index == 2).float()
                      + (parsing_index == 3).float())

        # One encoder pass over [upper; lower] stacked on batch.
        enc_dtype = torch.bfloat16 if self.num_bf16_res > 0 else torch.float32
        up_in, up_valid, up_res = self._spade_prepare(
            upper_mask, denorm_upper_mask, denorm_upper_input)
        lo_in, lo_valid, lo_res = self._spade_prepare(
            lower_mask, denorm_lower_mask, denorm_lower_input)
        feat2 = torch.cat([up_in, lo_in], dim=0).to(enc_dtype)
        for layer in self.spade_encoder:
            feat2 = layer(feat2)
        n = up_in.shape[0]
        spade_upper = self._spade_fill(feat2[:n], up_valid, up_res)
        spade_lower = self._spade_fill(feat2[n:], lo_valid, lo_res)
        upper_mask_256 = (_nearest_half(upper_mask) > 0.9).float()
        lower_mask_256 = (_nearest_half(lower_mask) > 0.9).float()
        spade_feat = spade_upper * upper_mask_256 + spade_lower * lower_mask_256

        res_256 = resolutions[-2]
        spade_dtype = self._blk_dtype(res_256)
        x_spade = self.spade_b256_1(x_256.to(spade_dtype),
                                    spade_feat.to(spade_dtype))
        x_spade = self.spade_b256_2(x_spade, spade_feat.to(spade_dtype))

        res_512 = resolutions[-1]
        last_ws = ws[:, self.num_ws - 3:self.num_ws]
        _, finetune_img, _ = self.texture_b512(
            x_spade.to(self._blk_dtype(res_512)), img_256, last_ws, pose_feat,
            cat_cast.get(res_512), parsing_index, noise_mode, generator)
        return img, finetune_img, pred_parsing


class Generator(nn.Module):
    """Top-level generator: pose/style encoders + mapping + synthesis.

    Parameters are drawn at construction from a CPU torch.Generator seeded
    with `seed`; load real weights with `load_state_dict`."""

    def __init__(self, z_dim=0, c_dim=512, w_dim=512, img_resolution=512,
                 img_channels=3, channel_base=32768, channel_max=512,
                 conv_clamp: Optional[float] = 256, use_noise=True,
                 mapping_layers=1, num_bf16_res=0, seed=0):
        super().__init__()
        self.img_resolution = img_resolution
        self.num_bf16_res = num_bf16_res
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution,
            img_channels=img_channels, channel_base=channel_base,
            channel_max=channel_max, conv_clamp=conv_clamp,
            use_noise=use_noise, num_bf16_res=num_bf16_res)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                                      num_ws=self.num_ws,
                                      num_layers=mapping_layers)
        ch8 = min(channel_base // 8, channel_max)
        n_down = int(math.log2(img_resolution)) - 3
        self.const_encoding = ConstEncoderNetwork(
            input_nc=3 + 2, output_nc=ch8, ngf=max(ch8 // 8, 4),
            n_downsampling=n_down)
        self.style_encoding = StyleEncoderNetwork(
            input_nc=10 * 3 + 5 * 3, output_nc=512, ngf=64)
        if seed is not None:         # None: the caller loads every leaf
            init_weights(self, torch.Generator().manual_seed(seed))

    @property
    def enc_dtype(self):
        """Compute dtype of the conditioning encoders: bf16 whenever the
        synthesis mixed-precision lever is on."""
        return torch.bfloat16 if self.num_bf16_res > 0 else torch.float32

    def style_code(self, c, retain):
        """The style code (the discriminators' conditioning) alone."""
        stylecode, _ = self.style_encoding(c.to(self.enc_dtype),
                                           retain.to(self.enc_dtype))
        return stylecode.float()

    def style_and_ws(self, z, c, retain, truncation_psi=1.0,
                     truncation_cutoff=None, update_w_avg=False):
        """The encoder and mapping half of `forward`: (style code, the
        retain pyramid, ws)."""
        stylecode, feats = self.style_encoding(c.to(self.enc_dtype),
                                               retain.to(self.enc_dtype))
        stylecode = stylecode.float()
        ws = self.mapping(z, stylecode, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff,
                          update_w_avg=update_w_avg)
        return stylecode, feats, ws

    def style_branch(self, ws, feats, pose, noise_mode="random",
                     generator=None):
        """(coarse img, pred_parsing) of the style branch from given ws and
        retain pyramid `feats`, without the SPADE texture branch, which
        neither depends on; the path-length regularizer differentiates the
        coarse image with respect to ws."""
        pose_feat = self.const_encoding(pose.to(self.enc_dtype))
        cat_feats = {str(f.shape[1]): f for f in feats}
        return self.synthesis(ws, pose_feat, cat_feats, None, None, None,
                              None, noise_mode=noise_mode,
                              generator=generator, style_only=True)

    def parsing(self, z, c, retain, pose, noise_mode="random",
                generator=None):
        """(pred_parsing, style code): the style branch of `forward`."""
        stylecode, feats, ws = self.style_and_ws(z, c, retain)
        _, pred_parsing = self.style_branch(ws, feats, pose, noise_mode,
                                            generator)
        return pred_parsing, stylecode

    def forward(self, z, c, retain, pose, denorm_upper_input,
                denorm_lower_input, denorm_upper_mask, denorm_lower_mask,
                gt_parsing=None, truncation_psi=1.0, truncation_cutoff=None,
                update_w_avg=False, noise_mode="random", return_code=False,
                generator=None):
        """Returns (coarse img, finetune img, pred_parsing), all NHWC fp32;
        with return_code=True also the style code."""
        n, res = c.shape[0], self.img_resolution
        # input contracts (reference misc.assert_shape usage in the
        # networks' forwards): an NHWC mix-up fails here, by name
        assert_shape(c, (n, res // 4, res // 4, 45), name="c")
        assert_shape(retain, (n, res, res, 6), name="retain")
        assert_shape(pose, (n, res, res, 5), name="pose")
        for nm, t in (("denorm_upper_input", denorm_upper_input),
                      ("denorm_lower_input", denorm_lower_input)):
            assert_shape(t, (n, res, res, 3), name=nm)
        for nm, t in (("denorm_upper_mask", denorm_upper_mask),
                      ("denorm_lower_mask", denorm_lower_mask)):
            assert_shape(t, (n, res, res, 1), name=nm)
        if gt_parsing is not None:
            assert_shape(gt_parsing, (n, res, res, 1), name="gt_parsing")
        pose_feat = self.const_encoding(pose.to(self.enc_dtype))
        stylecode, feats, ws = self.style_and_ws(
            z, c, retain, truncation_psi=truncation_psi,
            truncation_cutoff=truncation_cutoff, update_w_avg=update_w_avg)
        cat_feats = {str(f.shape[1]): f for f in feats}
        img, finetune, pred_parsing = self.synthesis(
            ws, pose_feat, cat_feats, denorm_upper_input, denorm_lower_input,
            denorm_upper_mask, denorm_lower_mask, gt_parsing,
            noise_mode=noise_mode, generator=generator)
        if return_code:
            return img, finetune, pred_parsing, stylecode
        return img, finetune, pred_parsing
