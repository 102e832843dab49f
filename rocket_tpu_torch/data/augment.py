"""In-step image augmentation — ``Module(batch_transform=...)`` ops on the
device (counterpart of ``rocket_tpu/data/augment.py``).

The host ships raw samples; each train step augments its batch on the
device with its own key. All ops take NHWC image batches and a
counter-hash key (``nn/keys.py``); randomness is per sample, and each op is
one vectorised pass over all B samples (a crop is one gather). A randint
is the floor of a uniform. The bits cannot match ``jax.random``'s: the
tests check the ops' properties (crop windows, exact mirrors, the flip
share, the same key giving the same output).

:func:`mixup` splits into :func:`mixup_draw` (the per-sample lambda and
the partner permutation, from the step's key) and :func:`mixup_mix` (a
pure function of the batch and those draws), so the tests feed the
reference's own draws into the port's mixing.
"""

from __future__ import annotations

import math

import torch

from rocket_tpu_torch.nn import keys

__all__ = ["random_flip", "random_crop", "cutout", "image_augment", "mixup", "mixup_draw",
           "mixup_mix", "beta", "soft_cross_entropy"]


def _randint(key: int, n: int, high: int, device) -> torch.Tensor:
    """``n`` ints uniform in [0, high): the floor of ``high`` times a
    uniform in (0, 1)."""
    return (keys.uniform(key, (n,), device) * high).long().clamp_(max=high - 1)


def random_flip(key: int, images: torch.Tensor) -> torch.Tensor:
    """Horizontal flip, p=0.5 independently per sample. (B, H, W, C)."""
    flip = keys.uniform(key, (images.shape[0],), images.device) < 0.5
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def _source_index(offset: torch.Tensor, size: int, padding: int, reflect: bool):
    """(B, size) source rows (or columns) of a crop at ``offset`` into the
    image padded by ``padding``, and where they fall inside the image.
    ``reflect`` mirrors out-of-range rows without repeating the edge, as
    ``jnp.pad(mode="reflect")`` does."""
    src = offset[:, None] + torch.arange(size, device=offset.device)[None, :] - padding
    inside = (src >= 0) & (src < size)
    if reflect:
        src = torch.where(src < 0, -src, src)
        src = torch.where(src >= size, 2 * (size - 1) - src, src)
        inside = torch.ones_like(inside)
    return src.clamp(0, size - 1), inside


def random_crop(key: int, images: torch.Tensor, padding: int = 4,
                pad_mode: str = "constant") -> torch.Tensor:
    """Pad by ``padding`` then crop back at a random per-sample offset in
    [0, 2 * padding] — the standard CIFAR shift augmentation. ``pad_mode``:
    ``"constant"`` (zeros, torchvision's ``RandomCrop(padding=4)``) or
    ``"reflect"``. One gather over the whole batch; the padded image is
    never materialised."""
    if pad_mode not in ("constant", "reflect"):
        raise ValueError(f"random_crop: pad_mode must be 'constant' or 'reflect', got {pad_mode!r}")
    b, h, w, _ = images.shape
    ky, kx = keys.split(key)
    oy = _randint(ky, b, 2 * padding + 1, images.device)
    ox = _randint(kx, b, 2 * padding + 1, images.device)
    reflect = pad_mode == "reflect"
    rows, row_in = _source_index(oy, h, padding, reflect)
    cols, col_in = _source_index(ox, w, padding, reflect)
    batch = torch.arange(b, device=images.device)[:, None, None]
    out = images[batch, rows[:, :, None], cols[:, None, :]]             # (B, H, W, C)
    if not reflect:
        keep = (row_in[:, :, None] & col_in[:, None, :])[..., None]
        out = torch.where(keep, out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def cutout(key: int, images: torch.Tensor, size: int = 8) -> torch.Tensor:
    """Zero a ``size`` x ``size`` square at a random per-sample centre, the
    window ``[c - size // 2, c + size // 2)`` — exactly ``size`` wide for
    either parity."""
    b, h, w, _ = images.shape
    ky, kx = keys.split(key)
    cy = _randint(ky, b, h, images.device)[:, None]
    cx = _randint(kx, b, w, images.device)[:, None]
    dy = torch.arange(h, device=images.device)[None, :] - (cy - size // 2)   # (B, H)
    dx = torch.arange(w, device=images.device)[None, :] - (cx - size // 2)   # (B, W)
    rows = (dy >= 0) & (dy < size)
    cols = (dx >= 0) & (dx < size)
    hole = rows[:, :, None] & cols[:, None, :]                             # (B, H, W)
    return torch.where(hole[..., None], torch.zeros((), dtype=images.dtype,
                                                    device=images.device), images)


def image_augment(*, crop_padding: int = 4, crop_pad_mode: str = "constant", flip: bool = True,
                  cutout_size: int = 0, key_name: str = "image"):
    """A ``Module(batch_transform=...)`` fn composing the ops. Each op
    draws from its own fold of the step's key, so adding an op never
    reshuffles the others' randomness."""

    def transform(batch, key):
        images = batch[key_name]
        if crop_padding:
            images = random_crop(keys.fold_in(key, 1), images, crop_padding,
                                 pad_mode=crop_pad_mode)
        if flip:
            images = random_flip(keys.fold_in(key, 2), images)
        if cutout_size:
            images = cutout(keys.fold_in(key, 3), images, cutout_size)
        out = dict(batch)
        out[key_name] = images
        return out

    return transform


#: Marsaglia-Tsang proposals drawn per gamma sample. Each is accepted with
#: probability above 0.95 at shape >= 1, so all 16 fail with probability
#: below 1e-20; a fixed count keeps the draw free of host syncs and
#: bitwise repeatable from its key.
_GAMMA_CANDIDATES = 16


def _log_gamma(key: int, shape: float, n: int, device) -> torch.Tensor:
    """log of ``n`` Gamma(shape, 1) samples, f32, on the device. Shape >= 1
    by Marsaglia-Tsang over a fixed number of proposals (the first accepted
    one is taken); shape < 1 as Gamma(shape + 1) * U^(1 / shape), in logs
    so that a small shape cannot underflow."""
    k_norm, k_acc, k_boost = keys.split(key, 3)
    a = shape + 1.0 if shape < 1.0 else shape
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    u = keys.uniform(k_norm, (2, _GAMMA_CANDIDATES, n), device)
    x = torch.sqrt(-2.0 * torch.log(u[0])) * torch.cos(2.0 * math.pi * u[1])   # N(0, 1)
    v = (1.0 + c * x) ** 3
    log_v = torch.log(v.clamp_min(1e-30))
    accept = (v > 0) & (torch.log(keys.uniform(k_acc, (_GAMMA_CANDIDATES, n), device))
                        < 0.5 * x * x + d - d * v + d * log_v)
    first = accept.float().argmax(0)                      # the first accepted proposal
    out = math.log(d) + log_v.gather(0, first[None]).squeeze(0)
    if shape < 1.0:
        out = out + torch.log(keys.uniform(k_boost, (n,), device)) / shape
    return out


def beta(key: int, alpha: float, n: int, device) -> torch.Tensor:
    """``n`` samples of Beta(alpha, alpha), f32 in [0, 1], on the device:
    X / (X + Y) for independent X, Y ~ Gamma(alpha), as ``jax.random.beta``
    forms them (the bits differ)."""
    kx, ky = keys.split(key)
    return torch.sigmoid(_log_gamma(kx, alpha, n, device) - _log_gamma(ky, alpha, n, device))


def mixup_draw(key: int, batch: int, alpha: float, device) -> tuple:
    """The draws of one mixup step: per-sample ``lam`` (B,) ~ Beta(alpha,
    alpha) and the partner permutation ``perm`` (B,), both on the device."""
    k_lam, k_perm = keys.split(key)
    lam = beta(k_lam, alpha, batch, device)
    perm = keys.uniform(k_perm, (batch,), device).argsort(stable=True)
    return lam, perm


def mixup_mix(images: torch.Tensor, labels: torch.Tensor, lam: torch.Tensor,
              perm: torch.Tensor, num_classes: int) -> tuple:
    """Mix each sample with its partner ``perm[i]`` at weight ``lam[i]`` ->
    ``(images in their dtype, soft labels (B, num_classes) f32)``. A label
    outside ``[0, num_classes)`` one-hots to a NaN row (the reference's
    rule: the loss turns NaN instead of silently under-weighting it)."""
    b = images.shape[0]
    lam = lam.float()
    lam_img = lam.reshape((b,) + (1,) * (images.ndim - 1))
    x = images.float()
    mixed = lam_img * x + (1.0 - lam_img) * x[perm]
    in_range = (labels >= 0) & (labels < num_classes)
    one_hot = torch.nn.functional.one_hot(labels.long().clamp(0, num_classes - 1),
                                          num_classes).float()
    one_hot = torch.where(in_range[:, None], one_hot,
                          torch.full((), float("nan"), device=one_hot.device))
    soft = lam[:, None] * one_hot + (1.0 - lam[:, None]) * one_hot[perm]
    return mixed.to(images.dtype), soft


def mixup(alpha: float = 0.2, num_classes: int = 10, image_key: str = "image",
          label_key: str = "label"):
    """Mixup as a ``batch_transform``: each sample convex-combined with a
    shuffled partner (per-sample lambda ~ Beta(alpha, alpha)) and its
    integer label replaced by the matching soft distribution. Train with
    :func:`soft_cross_entropy`."""

    def transform(batch, key):
        images, labels = batch[image_key], batch[label_key]
        lam, perm = mixup_draw(key, images.shape[0], alpha, images.device)
        out = dict(batch)
        out[image_key], out[label_key] = mixup_mix(images, labels, lam, perm, num_classes)
        return out

    return transform


def soft_cross_entropy(logits_key: str = "logits", label_key: str = "label"):
    """Objective for soft (mixup) labels, ``-sum(labels * log_softmax)``
    averaged over the batch, in f32. Integer labels are accepted too (the
    same objective with mixup off)."""

    def objective(batch):
        logits, labels = batch[logits_key].float(), batch[label_key]
        if labels.ndim == logits.ndim:
            return -(labels.float() * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
        return torch.nn.functional.cross_entropy(logits, labels.long())

    return objective
