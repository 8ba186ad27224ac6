"""Loss functions (counterpart of lvt_tpu/models/loss.py; reference
vidgen/modeling/loss/loss.py and the GAN loss keys of the config). All are
computed in fp32 whatever the inputs' dtype. The VQ-VAE's pixel loss goes
through ``pixel_loss_core``; the reference ships no discriminator, so no
shipped config reaches ``gan_loss``."""

import torch


def pixel_loss_core(mode: str, lam: float, x_tilde, x):
    """lambda * (l1 | l2)."""
    diff = x_tilde.float() - x.float()
    if mode == "l2":
        l = (diff ** 2).mean()
    elif mode == "l1":
        l = diff.abs().mean()
    else:
        raise NotImplementedError(mode)
    return lam * l


def pixel_loss(cfg, x_tilde, x):
    """lambda * (l1 | l2) as LOSS.PIXEL says (reference loss.py:5-20)."""
    return pixel_loss_core(cfg.LOSS.PIXEL.MODE, cfg.LOSS.PIXEL.LAMBDA, x_tilde, x)


def gan_loss(cfg, logits, target_is_real: bool):
    """wgan / lsgan / vanilla GAN criteria on discriminator logits."""
    mode = cfg.LOSS.GAN.MODE
    logits = logits.float()
    if mode == "wgan":
        return -logits.mean() if target_is_real else logits.mean()
    target = torch.full_like(logits, cfg.LOSS.GAN.REAL_LABEL if target_is_real
                             else cfg.LOSS.GAN.FAKE_LABEL)
    if mode == "lsgan":
        return ((logits - target) ** 2).mean()
    if mode == "vanilla":
        return (torch.clamp(logits, min=0) - logits * target
                + torch.log1p(torch.exp(-logits.abs()))).mean()
    raise NotImplementedError(mode)
