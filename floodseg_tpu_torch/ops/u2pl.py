"""U2PL building blocks (counterpart of floodseg_tpu/ops/u2pl.py): masked
percentiles, the entropy-filtered unsupervised loss, the unsupervised
mixing augmentations, nearest resizing of masks, and masked sampling.

Every shape is static and nothing is read back to the host: percentiles
come from a sort of the whole map with the invalid entries at +inf and a
linear interpolation at the float rank; a random subset of a mask is the
top-k of uniform scores with -inf off the mask; a draw with replacement
from a mask is the k-th entry on it, k = floor(u * count), found with a
cumulative sum, so an empty mask gives an index in range and no error (the
callers gate the term that uses it); boxes are comparisons against index
ramps.

``U2PLDraws`` holds every random draw of the U2PL step: the augmentation
coin, each sample's box or class-mix scores, and each class's subset
scores, anchor indices and negative indices. Each draw is a method that
takes what the draw depends on (the sample, the class, the mask, the
count), and by default it draws from generators on the step's device. A
caller can pass another object with the same methods (the tests pass one
that replays the JAX package's keys). The one-hot labels are
train/gan.py's ``one_hot_masks`` (255 gives an all-zero row).
"""

from typing import Optional, Tuple

import torch

from floodseg_tpu_torch.ops.losses import _log_softmax


def _dt(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def masked_percentile(values: torch.Tensor, mask: torch.Tensor,
                      percent: torch.Tensor) -> torch.Tensor:
    """``np.percentile(values[mask], percent)`` with linear interpolation.

    ``values`` and ``mask`` have one shape; ``percent`` is a 0-dim tensor in
    [0, 100]. ``clip(percent) / 100`` is computed in ``percent``'s dtype
    (float32 in the step, as the JAX step's schedules are) and promoted to
    the values' dtype only when it meets ``n_valid - 1``. Invalid entries
    sort to +inf; at least one entry must be valid."""
    dt = _dt(values)
    v = torch.sort(torch.where(mask, values, torch.inf).reshape(-1).to(dt)).values
    n_valid = mask.sum().to(dt)
    frac100 = torch.clamp(percent, 0.0, 100.0) / 100.0
    rank = frac100.to(dt) * torch.clamp_min(n_valid - 1.0, 0.0)
    lo, hi = torch.floor(rank), torch.ceil(rank)
    frac = rank - lo
    # take, not v[t]: indexing with a 0-dim tensor reads it back to the host
    return torch.take(v, lo.long()) * (1.0 - frac) + torch.take(v, hi.long()) * frac


def softmax_entropy(logits: torch.Tensor) -> torch.Tensor:
    """-sum p log(p + 1e-10) over the last axis, at >= float32."""
    p = torch.softmax(logits.to(_dt(logits)), dim=-1)
    return -torch.sum(p * torch.log(p + 1e-10), dim=-1)


def compute_unsupervised_loss(pred: torch.Tensor, target: torch.Tensor,
                              percent: torch.Tensor, pred_teacher: torch.Tensor,
                              ignore_index: int = 255) -> torch.Tensor:
    """The entropy-filtered CE of U2PL: the pixels whose teacher entropy is
    at or above the ``percent``-th percentile of the valid pixels' are
    dropped, and the mean CE of the rest is scaled by B*H*W / (kept +
    1e-10); 0 when no pixel is kept. ``pred`` (B, H, W, C) student logits,
    ``target`` (B, H, W) pseudo-labels, ``pred_teacher`` the teacher's
    logits (no gradient)."""
    b, h, w, _ = pred.shape
    entropy = softmax_entropy(pred_teacher.detach())
    valid = target != ignore_index
    thresh = masked_percentile(entropy, valid, percent)
    kept = valid & ~((entropy >= thresh) & valid)
    dt = _dt(pred)
    n_kept = kept.sum().to(dt)
    weight = (b * h * w) / (n_kept + 1e-10)
    safe = torch.where(kept, target, 0).to(torch.int64)
    nll = -torch.gather(_log_softmax(pred), -1, safe[..., None])[..., 0]
    ce = torch.sum(nll * kept.to(dt)) / torch.clamp_min(n_kept, 1.0)
    return torch.where(n_kept > 0, weight * ce, torch.zeros_like(ce))


def nearest_resize_mask(x: torch.Tensor, size) -> torch.Tensor:
    """``F.interpolate(mode="nearest")`` of (B, H, W, C) masks: row i * H //
    out_h, column j * W // out_w."""
    _, h, w, _ = x.shape
    oh, ow = int(size[0]), int(size[1])
    if (h, w) == (oh, ow):
        return x
    iy = torch.arange(oh, device=x.device) * h // oh
    ix = torch.arange(ow, device=x.device) * w // ow
    return x[:, iy][:, :, ix]


def masked_choice(u: torch.Tensor, mask_flat: torch.Tensor) -> torch.Tensor:
    """len(u) indices drawn uniformly with replacement from {i : mask[i]}:
    the floor(u * count)-th true entry, for uniforms ``u`` in [0, 1). With
    an empty mask the indices are in range but meaningless (callers gate
    on count > 0)."""
    cum = torch.cumsum(mask_flat.to(torch.int64), 0)
    count = cum[-1]
    k = torch.clamp(torch.floor(u.to(torch.float64) * torch.clamp_min(count, 1)).long(),
                    max=torch.clamp_min(count - 1, 0))
    idx = torch.searchsorted(cum, k + 1)
    return torch.clamp(idx, max=mask_flat.numel() - 1)


def masked_subset(scores: torch.Tensor, mask_flat: torch.Tensor,
                  n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to n distinct indices of {i : mask[i]}: (indices (n,), valid
    (n,)), the top n of uniform ``scores`` (the mask's shape) with -inf off
    the mask, in descending order, so the valid indices come first (as
    ``enqueue`` needs): a random subset when the mask has more than n
    entries, all of them and invalid padding otherwise."""
    top, idx = torch.topk(torch.where(mask_flat, scores, -torch.inf), n, sorted=True)
    return idx, top > -torch.inf


# ---------------------------------------------------------- the draws

def box_height(bw: torch.Tensor, h: int, w: int, ratio: float = 2.0) -> torch.Tensor:
    """A cutout box's height for width ``bw``: round(h * w / ratio / bw),
    half to even, in float64."""
    return torch.round((h * w / ratio) / bw.to(torch.float64)).long()


class U2PLDraws:
    """The U2PL step's random draws from generators on ``device``, one for
    each of the JAX step's keys that is not a dropout key (``r_aug``,
    ``r_coin``, ``r_contra``), seeded with the given seeds (None draws
    fresh ones from the default seed source of a new generator). Every
    value is drawn on the device: no draw reads a tensor back."""

    def __init__(self, device: torch.device, aug_seed: Optional[int] = None,
                 coin_seed: Optional[int] = None, contra_seed: Optional[int] = None):
        def gen(seed):
            g = torch.Generator(device=device)
            if seed is None:
                g.seed()
            else:
                g.manual_seed(seed)
            return g

        self.device = device
        self.aug, self.coin_gen, self.contra = gen(aug_seed), gen(coin_seed), gen(contra_seed)

    def _u(self, gen: torch.Generator, n, dtype=torch.float64) -> torch.Tensor:
        shape = (n,) if isinstance(n, int) else tuple(n)
        return torch.rand(shape, generator=gen, device=self.device, dtype=dtype)

    def coin(self) -> torch.Tensor:
        """The augmentation coin: a 0-dim uniform in [0, 1)."""
        return self._u(self.coin_gen, ())

    def box(self, i: int, h: int, w: int,
            ratio: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sample ``i``'s cutout box (bw, x0, y0): bw uniform in [w / ratio
        + 1, w), then x0 in [0, w - bw] and y0 in [0, h - bh]."""
        u = self._u(self.aug, 3)
        lo = int(w / ratio) + 1
        bw = lo + torch.floor(u[0] * (w - lo)).long()
        bh = box_height(bw, h, w, ratio)
        x0 = torch.floor(u[1] * torch.clamp_min(w - bw + 1, 1)).long()
        y0 = torch.floor(u[2] * torch.clamp_min(h - bh + 1, 1)).long()
        return bw, x0, y0

    def class_scores(self, i: int, num_classes: int) -> torch.Tensor:
        """Sample ``i``'s class-mix scores, one uniform a class."""
        return self._u(self.aug, num_classes)

    def subset_scores(self, c: int, size: int) -> torch.Tensor:
        """Class ``c``'s scores for ``masked_subset`` over ``size`` pixels."""
        return self._u(self.contra, size, torch.float32)

    def choice(self, c: int, mask_flat: torch.Tensor, n: int) -> torch.Tensor:
        """Class ``c``'s n anchors: ``masked_choice`` on ``mask_flat``."""
        return masked_choice(self._u(self.contra, n), mask_flat)

    def negatives(self, c: int, count: torch.Tensor, n: int) -> torch.Tensor:
        """Class ``c``'s n negative indices, uniform in [0, max(count, 1))."""
        top = torch.clamp_min(count, 1)
        return torch.clamp(torch.floor(self._u(self.contra, n) * top).long(), max=top - 1)


# ------------------------------------------- unsupervised mixing augmentations

def _box_mask(bw: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, h: int, w: int,
              ratio: float = 2.0) -> torch.Tensor:
    """The cutout mask of a box: 0 inside, 1 outside, float32 (h, w)."""
    bh = box_height(bw, h, w, ratio)
    yy = torch.arange(h, device=bw.device)[:, None]
    xx = torch.arange(w, device=bw.device)[None, :]
    inside = (yy >= y0) & (yy < y0 + bh) & (xx >= x0) & (xx < x0 + bw)
    return 1.0 - inside.to(torch.float32)


def _class_mask(scores: torch.Tensor, pseudo: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The ClassMix mask: 1 where the pixel's class is among a random half
    (n_present // 2, by ``scores``) of the classes present in the sample."""
    cls = torch.clamp(pseudo.reshape(-1).long(), 0, num_classes - 1)
    present = torch.zeros(num_classes, dtype=torch.bool, device=pseudo.device)
    present[cls] = True
    order = torch.argsort(-torch.where(present, scores, -torch.inf), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(num_classes, device=pseudo.device)
    selected = present & (rank < present.sum() // 2)
    return selected[torch.clamp(pseudo.long(), 0, num_classes - 1)].to(torch.float32)


def generate_unsup_data(draws, images: torch.Tensor, target: torch.Tensor,
                        logits: torch.Tensor, mode: str = "cutmix", num_classes: int = 5):
    """Per-sample cutout, cutmix or classmix of an unlabeled batch: images
    (B, H, W, 3), target (B, H, W) int, logits (B, H, W) float. Cutout
    zeroes the box (target 255 there); cutmix and classmix paste the next
    sample of the batch where the mask is 0. Returns the three mixed."""
    b, h, w, _ = images.shape
    imgs, tgts, lgs = [], [], []
    for i in range(b):
        if mode in ("cutout", "cutmix"):
            m = _box_mask(*draws.box(i, h, w, 2.0), h, w, 2.0)
        elif mode == "classmix":
            m = _class_mask(draws.class_scores(i, num_classes), target[i], num_classes)
        else:
            raise ValueError(mode)
        m = m.to(images.device)
        if mode == "cutout":
            imgs.append(images[i] * m[..., None].to(images.dtype))
            tgts.append(torch.where(m == 0, torch.full_like(target[i], 255), target[i]))
            lgs.append(logits[i] * m.to(logits.dtype))
            continue
        j = (i + 1) % b
        mi = m[..., None].to(images.dtype)
        imgs.append(images[i] * mi + images[j] * (1 - mi))
        tgts.append((target[i] * m + target[j] * (1 - m)).to(target.dtype))
        ml = m.to(logits.dtype)
        lgs.append(logits[i] * ml + logits[j] * (1 - ml))
    return torch.stack(imgs), torch.stack(tgts), torch.stack(lgs)
