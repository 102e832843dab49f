"""In-step image augmentation — ``Module(batch_transform=...)`` ops on the
device (counterpart of ``rocket_tpu/data/augment.py``).

The host ships raw samples; each train step augments its batch on the
device with its own key. All ops take NHWC image batches and a
counter-hash key (``nn/keys.py``); randomness is per sample, and each op is
one vectorised pass over all B samples (a crop is one gather). A randint
is the floor of a uniform. The bits cannot match ``jax.random``'s: the
tests check the ops' properties (crop windows, exact mirrors, the flip
share, the same key giving the same output).
"""

from __future__ import annotations

import torch

from rocket_tpu_torch.nn import keys

__all__ = ["random_flip", "random_crop", "cutout", "image_augment"]


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
