"""Seeded synthetic video on the device: the benchmark's copy of the
port's ``data/synthetic.py::synthetic_clip`` and ``predict_windows``,
moved onto the card and extended by local motion.

A video is ``windows * n + 1`` frames of drifting class-coloured blobs over
a texture, the scene panned by the smooth global motion of
``synthetic_clip`` (per-frame translation ``motion``) at a fixed speed:
the seed draws its phases, not its amplitudes, so that every seed's grids
move about as many blocks and the warps do the same work. The grids are
the H.264 block-motion grids of that motion plus a seeded local motion
(smooth per-block drift): each 16 px macroblock of the grid samples the
centre of the block its content came from, as
``grids_from_motion_vectors`` builds them from decoder vectors, so a block
moves only where its motion passes half a block (``synthetic_clip``'s
speeds, under 8 px a frame, leave every grid the identity). The inverse
grids come from the inverse motion, and a block whose partner lies outside
the frame keeps the identity there. Only the key frames (every n-th) are
rendered, at the video's size, then resized to the key-frame size as the
predict transform resizes them.
"""

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

BLOCK = 16
PALETTE = ((0, 0, 0), (30, 95, 170), (65, 117, 5), (212, 98, 1), (255, 244, 1))
# (class, centre x, centre y, radius) as shares of the frame
BLOBS = ((1, 0.30, 0.60, 0.22), (2, 0.70, 0.30, 0.15), (3, 0.55, 0.75, 0.12),
         (4, 0.15, 0.20, 0.10))


def motion(t: torch.Tensor, pan_px: float, phase: torch.Tensor) -> torch.Tensor:
    """Global translation (pixels a frame) at frames ``t``: (T, 2), at most
    ``pan_px`` across and 0.6 ``pan_px`` down."""
    dx = pan_px * torch.sin(0.1 * t + phase[0])
    dy = 0.6 * pan_px * torch.cos(0.07 * t + phase[1])
    return torch.stack([dx, dy], dim=-1)


def identity_grid(height: int, width: int, device=None) -> torch.Tensor:
    """Each block samples its own centre: (H/16, W/16, 2) float32."""
    bh, bw = height // BLOCK, width // BLOCK
    xs = (torch.arange(bw, dtype=torch.float64) * BLOCK + BLOCK // 2) / width * 2 - 1
    ys = (torch.arange(bh, dtype=torch.float64) * BLOCK + BLOCK // 2) / height * 2 - 1
    grid = torch.stack([xs[None, :].expand(bh, bw), ys[:, None].expand(bh, bw)], dim=-1)
    return grid.to(torch.float32).to(device)


def _render(size, offsets: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """(K, H, W, 3) uint8 frames at accumulated ``offsets`` (K, 2)."""
    h, w = size
    dev = offsets.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ox, oy = offsets[:, 0, None, None], offsets[:, 1, None, None]
    tex = (torch.sin((xx + ox) * 0.11) + torch.cos((yy + oy) * 0.13)) * 0.5
    img = torch.stack([80 + 40 * tex, 90 + 30 * tex, 70 + 20 * tex], dim=-1)
    for cls, cx, cy, r in BLOBS:
        r = r * min(h, w)
        bx = torch.remainder(cx * w + ox, w)
        by = torch.remainder(cy * h + oy, h)
        mask = ((xx - bx) ** 2 + (yy - by) ** 2) < r * r
        colour = torch.tensor(PALETTE[cls], dtype=torch.float32, device=dev) * 0.7
        img = torch.where(mask[..., None], colour + img * 0.3, img)
    return torch.clamp(img + noise, 0, 255).to(torch.uint8)


def _grids(shift: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(T, bh, bw, 2) grids: each block samples the centre of the block
    that holds its centre displaced by ``shift`` (T, bh, bw, 2) pixels;
    a block whose source lies outside the frame samples outside [-1, 1]
    (the warp's border clamps it)."""
    bh, bw = height // BLOCK, width // BLOCK
    dev = shift.device
    cx = torch.arange(bw, device=dev, dtype=torch.float64) * BLOCK + BLOCK // 2
    cy = torch.arange(bh, device=dev, dtype=torch.float64) * BLOCK + BLOCK // 2
    sx = torch.floor((cx[None, None, :] + shift[..., 0]) / BLOCK)
    sy = torch.floor((cy[None, :, None] + shift[..., 1]) / BLOCK)
    gx = (sx * BLOCK + BLOCK // 2) / width * 2 - 1
    gy = (sy * BLOCK + BLOCK // 2) / height * 2 - 1
    return torch.stack([gx, gy], dim=-1)


def make_video(seed: int, windows: int, n: int, video_hw: Tuple[int, int],
               key_hw: Tuple[int, int], pan_px: float, local_px: float,
               device) -> Dict[str, torch.Tensor]:
    """One video's key frames and each window's grids, on ``device``:

    - ``keys``: (windows + 1, 1, kh, kw, 3) uint8, key frame i*n at index i;
    - ``left``: (windows, n-1, 1, gh, gw, 2) float32, window i's forward
      grids (frames i*n+1 .. i*n+n-1);
    - ``right``: the same frames' inverse grids, reversed.
    """
    h, w = video_hw
    if h % BLOCK or w % BLOCK:
        raise ValueError(f"video size {video_hw} must be a multiple of {BLOCK}")
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = windows * n + 1
    ph = torch.rand(6, generator=gen, device=device, dtype=torch.float64) * 2 * math.pi
    t = torch.arange(frames, device=device, dtype=torch.float64)
    glob = motion(t, pan_px, ph[4:])                        # (T, 2)
    offsets = torch.cumsum(glob, dim=0)
    bh, bw = h // BLOCK, w // BLOCK
    # local drift: two smooth waves a direction, their phases from the seed
    by = torch.arange(bh, device=device, dtype=torch.float64)[None, :, None]
    bx = torch.arange(bw, device=device, dtype=torch.float64)[None, None, :]
    tt = t[:, None, None]
    lx = torch.sin(2 * math.pi * bx / bw + ph[0] + 0.05 * tt) * torch.cos(
        2 * math.pi * by / bh + ph[1])
    ly = torch.cos(2 * math.pi * bx / bw + ph[2]) * torch.sin(
        2 * math.pi * by / bh + ph[3] + 0.03 * tt)
    local = torch.stack([lx, ly], dim=-1) * local_px
    move = glob[:, None, None, :] + local                   # (T, bh, bw, 2)
    grids = _grids(-move, h, w).to(torch.float32)
    inv = _grids(move, h, w)
    ident = identity_grid(h, w, device).to(torch.float64)
    outside = ((inv[..., 0].abs() > 1) | (inv[..., 1].abs() > 1))[..., None]
    inv = torch.where(outside, ident, inv).to(torch.float32)

    key_ids = torch.arange(0, frames, n, device=device)
    keys = []
    for chunk in key_ids.split(8):
        noise = torch.randn((len(chunk), h, w, 3), generator=gen, device=device) * 3
        img = _render(video_hw, offsets[chunk].to(torch.float32), noise)
        small = F.interpolate(img.permute(0, 3, 1, 2).to(torch.float32), size=tuple(key_hw),
                              mode="bilinear", align_corners=False)
        keys.append(small.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1))
    keys = torch.cat(keys)[:, None].contiguous()
    per_window = grids[:windows * n].view(windows, n, bh, bw, 2)[:, 1:]
    inv_window = inv[:windows * n].view(windows, n, bh, bw, 2)[:, 1:].flip(1)
    return {"keys": keys,
            "left": per_window[:, :, None].contiguous(),
            "right": inv_window[:, :, None].contiguous()}
