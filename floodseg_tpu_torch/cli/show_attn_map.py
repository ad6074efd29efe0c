"""Segmenter ViT attention maps as images (counterpart of
scripts/show_attn_map.py).

    python -m floodseg_tpu_torch.cli.show_attn_map CKPT IMAGE OUT_DIR \\
        [--layer-id 0] [--x-patch 0 --y-patch 0] [--dec] [--cls] [--n-cls 5]

Per-head attention maps of one encoder (or ``--dec`` decoder) layer, for
the class token(s) (``--cls``) or one patch's query, upsampled by the patch
size and written as one L PNG per head (and per class embedding with
``--dec --cls``). CKPT is a checkpoint of ``segm.train`` or a state_dict
file ('-' for random weights). Runs on the card unless ``--device cpu``.
"""

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="floodseg_tpu_torch.cli.show_attn_map")
    p.add_argument("ckpt", help="checkpoint or state_dict file (or '-' for random init)")
    p.add_argument("image")
    p.add_argument("out_dir")
    p.add_argument("--layer-id", type=int, default=0)
    p.add_argument("--x-patch", type=int, default=0)
    p.add_argument("--y-patch", type=int, default=0)
    p.add_argument("--dec", action="store_true", help="decoder attention (default: encoder)")
    p.add_argument("--cls", action="store_true",
                   help="class-token query (default: one patch query)")
    p.add_argument("--n-cls", type=int, default=5)
    p.add_argument("--image-size", type=int, default=768)
    p.add_argument("--patch-size", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from floodseg_tpu_torch.core.checkpoint import read_model_state
    from floodseg_tpu_torch.core.device import resolve_device
    from floodseg_tpu_torch.data.image import read_rgb, write_png
    from floodseg_tpu_torch.data.transforms import MEAN, STD
    from floodseg_tpu_torch.models.layers import init_flax_defaults_
    from floodseg_tpu_torch.models.vit import SegmenterViT
    from floodseg_tpu_torch.ops.cv2_compat import pil_resize_bicubic
    from floodseg_tpu_torch.segm.attn import attention_maps, head_maps

    dev = resolve_device(args.device)
    model = SegmenterViT(classes=args.n_cls, image_size=args.image_size,
                         patch_size=args.patch_size)
    if args.ckpt != "-":
        model.load_state_dict(read_model_state(args.ckpt), strict=True)
    else:  # the JAX script's model.init at PRNGKey(0)
        init_flax_defaults_(model, torch.Generator().manual_seed(0))
    model = model.to(dev)

    size = args.image_size - args.image_size % args.patch_size
    img = pil_resize_bicubic(read_rgb(args.image), (size, size))
    x = (np.asarray(img, np.float32) - np.asarray(MEAN)) / np.asarray(STD)
    x = torch.from_numpy(x.astype(np.float32))[None].to(dev)

    maps = attention_maps(model, x)
    which = "decoder" if args.dec else "encoder"
    layers = maps[which]
    if args.layer_id >= len(layers):
        raise SystemExit(f"{which} has {len(layers)} layers, layer-id {args.layer_id} invalid")
    g = size // args.patch_size
    hm = head_maps(layers[args.layer_id], (g, g), args.patch_size,
                   query="cls" if args.cls else "patch", xy_patch=(args.x_patch, args.y_patch),
                   n_cls=args.n_cls, is_decoder=args.dec)

    os.makedirs(args.out_dir, exist_ok=True)
    base = "dec" if args.dec else "enc"
    for h in range(hm.shape[0]):
        for j in range(hm.shape[1]):
            m = hm[h, j]
            m = (255 * (m - m.min()) / max(m.max() - m.min(), 1e-8))
            name = f"{base}_layer{args.layer_id}_attn-head{h}"
            if hm.shape[1] > 1:
                name += f"_cls{j}"
            write_png(os.path.join(args.out_dir, name + ".png"), m.astype(np.uint8))
    print(f"wrote {hm.shape[0] * hm.shape[1]} maps to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
