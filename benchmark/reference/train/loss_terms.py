"""The G / D / parsing-D loss math: a frozen copy of the port's
`train/loss_terms.py` in one process, without the contextual loss
(reference training/loss_fullbody.py:117-330: Gmain, Dmain, Dr1 and the
parsing-discriminator twins).

The cores take generator OUTPUTS `(img, finetune, parsing_logits, gen_c)`
and the modules' current parameters; the train step decides which
parameters are differentiated. Where the minibatch-std groups allow it
(`_can_batch_d`), the sub-batches of one D call are interleaved (`_ilv`)
so that one augment and one D call serve them all, exactly as separate
calls would.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..losses.gan import d_logistic_loss, g_nonsat_loss, r1_penalty
from ..losses.parsing import weighted_parsing_ce
from ..losses.vgg import FEATURE_WEIGHTS, vgg_features
from .augment import AugmentConfig, augment_pipe


def gt_parsing_onehot(gt_parsing):
    """7-channel one-hot of the gt parsing map (loss_fullbody.py:300-308)."""
    return F.one_hot(gt_parsing[..., 0].long(), 7).float()


def _ilv(*xs):
    """Interleave sub-batches along batch: [a0, b0, a1, b1, ...].

    MinibatchStdLayer groups are batch-strided, so interleaving S equal
    sub-batches keeps every group inside one sub-batch whenever the group
    size divides the sub-batch length: one D call on the stack equals S
    separate calls."""
    return torch.stack(xs, dim=1).reshape((-1,) + tuple(xs[0].shape[1:]))


def _dilv(x, s):
    """Inverse of `_ilv`: split an interleaved batch into its s parts."""
    y = x.reshape((-1, s) + tuple(x.shape[1:]))
    return [y[:, i] for i in range(s)]


def build_loss_cores(cfg, d, dp, vgg=None):
    """Returns dict(g, d, dp, d_r1, dp_r1, d_in) closures over the modules.

    g(outputs, ada_p, batch, generator) -> (loss, metrics)
    d(img, finetune, gen_c, ada_p, batch, generator) -> (loss, metrics);
        the fakes must carry no gradient.
    dp(parsing_soft, gen_c, batch) -> (loss, metrics)
    d_r1(gen_c, ada_p, batch, generator), dp_r1(gen_c, batch)
        -> (loss, metrics): the lazy R1 penalties, lazy-reg scaled.
    `generator` is the torch.Generator of the ADA draws.
    """
    vgg_dtype = torch.bfloat16 if cfg.vgg_bf16 else None

    def _vgg_pair(img, finetune, real):
        """One VGG forward over [img; finetune], both halves against the
        real image's pyramid (computed once, no gradient)."""
        with torch.no_grad():
            real_feats = vgg_features(vgg, real, dtype=vgg_dtype)
        fx = vgg_features(vgg, torch.cat([img, finetune], 0),
                          dtype=vgg_dtype)
        li = lf = 0.0
        for w, a, b in zip(FEATURE_WEIGHTS, fx, real_feats):
            nb = b.shape[0]
            dd = (a - torch.cat([b, b], 0)).abs().float()
            li = li + w * dd[:nb].mean()
            lf = lf + w * dd[nb:].mean()
        return li, lf

    use_vgg = cfg.vgg_weight > 0 and vgg is not None

    def _can_batch_d(n):
        """Whether one interleaved D call equals separate calls on `n`
        samples a stream."""
        gs = cfg.mbstd_group_size
        return gs is not None and n >= gs and n % gs == 0

    def _d_in(img, pose, ada_p, generator):
        """ADA-augment the 3-channel image, then append the pose rgb."""
        if cfg.use_ada:
            img = augment_pipe(img, ada_p, generator, AugmentConfig.bgc())
        return torch.cat([img, pose[..., 0:3]], dim=-1)

    def g_terms(outputs, ada_p, batch, generator):
        img, finetune, pred_parsing, gen_c = outputs
        n = img.shape[0]
        pose = batch["pose"]
        if _can_batch_d(n):
            logits2 = d(_d_in(_ilv(img, finetune), _ilv(pose, pose), ada_p,
                              generator), _ilv(gen_c, gen_c))
            gen_logits, ft_logits = _dilv(logits2, 2)
        else:
            gen_logits = d(_d_in(img, pose, ada_p, generator), gen_c)
            ft_logits = d(_d_in(finetune, pose, ada_p, generator), gen_c)

        parsing_soft = torch.softmax(pred_parsing, dim=-1)
        parsing_logits = dp(torch.cat([parsing_soft, pose[..., 0:3]], -1),
                            gen_c)

        loss_gmain = g_nonsat_loss(gen_logits)
        loss_gmain_ft = g_nonsat_loss(ft_logits)
        loss_g_parsing = g_nonsat_loss(parsing_logits)

        loss_l1 = loss_l1_ft = 0.0
        if cfg.l1_weight > 0:
            loss_l1 = (img - batch["real_img"]).abs().mean() * cfg.l1_weight
            loss_l1_ft = ((finetune - batch["real_img"]).abs().mean()
                          * cfg.l1_weight)
        loss_mask = 0.0
        if cfg.mask_weight > 0:
            loss_mask = weighted_parsing_ce(
                pred_parsing, batch["gt_parsing"][..., 0].long()
            ) * cfg.mask_weight
        loss_vgg = loss_vgg_ft = 0.0
        if use_vgg:
            loss_vgg, loss_vgg_ft = _vgg_pair(img, finetune,
                                              batch["real_img"])
            loss_vgg = loss_vgg * cfg.vgg_weight
            loss_vgg_ft = loss_vgg_ft * cfg.vgg_weight

        loss = ((loss_gmain + loss_gmain_ft) / 2 + (loss_l1 + loss_l1_ft) / 2
                + (loss_vgg + loss_vgg_ft) / 2 + loss_mask + loss_g_parsing)
        metrics = dict(
            g_loss=loss_gmain, g_loss_finetune=loss_gmain_ft,
            g_parsing=loss_g_parsing, g_l1=loss_l1 + loss_l1_ft,
            g_vgg=loss_vgg + loss_vgg_ft, g_mask=loss_mask,
            fake_scores=gen_logits.mean())
        return loss, metrics

    def d_terms(img, finetune, gen_c, ada_p, batch, generator):
        n = img.shape[0]
        pose, real = batch["pose"], batch["real_img"]
        if _can_batch_d(n):
            # fake img + finetune + real in ONE interleaved augment + D call
            logits3 = d(_d_in(_ilv(img, finetune, real),
                              _ilv(pose, pose, pose), ada_p, generator),
                        _ilv(gen_c, gen_c, gen_c))
            gen_logits, ft_logits, real_logits = _dilv(logits3, 3)
        else:
            gen_logits = d(_d_in(img, pose, ada_p, generator), gen_c)
            ft_logits = d(_d_in(finetune, pose, ada_p, generator), gen_c)
            real_logits = d(_d_in(real, pose, ada_p, generator), gen_c)
        loss_fake = (d_logistic_loss(fake_logits=gen_logits)
                     + d_logistic_loss(fake_logits=ft_logits)) / 2
        loss_real = d_logistic_loss(real_logits=real_logits)
        loss = loss_fake + loss_real
        metrics = dict(d_loss=loss, real_scores=real_logits.mean(),
                       real_signs=torch.sign(real_logits).mean())
        return loss, metrics

    def dp_terms(parsing_soft, gen_c, batch):
        pose_rgb = batch["pose"][..., 0:3]
        gt_onehot = gt_parsing_onehot(batch["gt_parsing"]).to(
            parsing_soft.dtype)
        if _can_batch_d(parsing_soft.shape[0]):
            in2 = torch.cat([_ilv(parsing_soft, gt_onehot),
                             _ilv(pose_rgb, pose_rgb)], dim=-1)
            fake_logits, real_logits = _dilv(dp(in2, _ilv(gen_c, gen_c)), 2)
        else:
            fake_logits = dp(torch.cat([parsing_soft, pose_rgb], -1), gen_c)
            real_logits = dp(torch.cat([gt_onehot, pose_rgb], -1), gen_c)
        loss = (d_logistic_loss(fake_logits=fake_logits)
                + d_logistic_loss(real_logits=real_logits))
        return loss, dict(dp_loss=loss)

    def d_r1_terms(gen_c, ada_p, batch, generator):
        """Lazy R1 of the image D (the reference's Dreg phase), on the
        first batch // r1_batch_shrink real images."""
        n_r1 = batch["real_img"].shape[0] // cfg.r1_batch_shrink
        pose = batch["pose"][:n_r1]
        r1 = r1_penalty(
            lambda x: d(_d_in(x, pose, ada_p, generator), gen_c[:n_r1]),
            batch["real_img"][:n_r1])
        loss = r1 * (cfg.r1_gamma / 2) * cfg.d_reg_interval
        return loss, dict(r1_penalty=r1)

    def dp_r1_terms(gen_c, batch):
        """Lazy R1 of the parsing D on the one-hot gt parsing."""
        gt_onehot = gt_parsing_onehot(batch["gt_parsing"])
        n_r1 = gt_onehot.shape[0] // cfg.r1_batch_shrink
        pose_rgb = batch["pose"][:n_r1, ..., 0:3]
        r1 = r1_penalty(
            lambda x: dp(torch.cat([x, pose_rgb], -1), gen_c[:n_r1]),
            gt_onehot[:n_r1])
        loss = r1 * (cfg.r1_gamma / 2) * cfg.d_reg_interval
        return loss, dict(dp_r1_penalty=r1)

    return dict(g=g_terms, d=d_terms, dp=dp_terms, d_in=_d_in,
                d_r1=d_r1_terms, dp_r1=dp_r1_terms)
