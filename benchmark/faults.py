"""Faults planted in the program under test, to show that ``correct``
catches them. Each is a context manager that patches the port for the
duration of a run and restores it; the benchmark's own runs plant none.

Flow predict (``flow_predict`` generator):

- ``stale_state``: the cached program hands back the encoding it was given
  (the next window reuses a stale key);
- ``half_batch``: the later half of a window's frames is left out, its
  maps never written (zeros);
- ``altered``: a 16x16 patch of one frame's map set to another class;
- ``warp_identity``: the warp chains (K2) given identity grids, so the
  warped maps stay where the key frames had them.

At the cell's own size only (``ON_CHIP``; the tests' small shapes move
too few blocks for it to show):

- ``chain_step_dropped``: one step of each warp chain (K2) skipped, its
  grid replaced by the identity.

A lower precision that ``correct`` is not bound to catch, for control.py
to read: ``int8_decode``, the program's int8 decoder (K3 and the int8
convolution) with the encoder in bf16.

Training (``train_step`` generator):

- ``stale_state``: the optimizer step is skipped (the state comes back
  unchanged);
- ``half_batch``: the step sees the first half of the batch and takes its
  mean over that half;
- ``altered``: the gradient of the first convolution is doubled before the
  update.
"""

import contextlib
from typing import Iterator


@contextlib.contextmanager
def _patched(obj, name: str, value) -> Iterator[None]:
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _identity_like(grids):
    """Grids (T, 1, gh, gw, 2) in which each point samples its own centre
    (align_corners=False)."""
    import torch

    gh, gw = grids.shape[2:4]
    xs = (2 * torch.arange(gw, device=grids.device, dtype=torch.float32) + 1) / gw - 1
    ys = (2 * torch.arange(gh, device=grids.device, dtype=torch.float32) + 1) / gh - 1
    ident = torch.stack([xs[None, :].expand(gh, gw), ys[:, None].expand(gh, gw)], dim=-1)
    return ident.expand_as(grids).contiguous()


def _chain(kind: str):
    from floodseg_tpu_torch.video import flow_model

    orig = flow_model.warp_chain_cuda

    def chain(y0, grids):
        if kind == "warp_identity":
            return orig(y0, _identity_like(grids))
        grids = grids.clone()
        k = grids.shape[0] // 2
        grids[k] = _identity_like(grids[k:k + 1])[0]
        return orig(y0, grids)

    return _patched(flow_model, "warp_chain_cuda", chain)


def _flow(kind: str):
    from floodseg_tpu_torch.train import flow

    if kind in ("warp_identity", "chain_step_dropped"):
        return _chain(kind)
    orig = flow.make_cached_flow_predict_fn
    if kind == "int8_decode":
        return _patched(flow, "make_cached_flow_predict_fn",
                        lambda *a, **kw: orig(*a, **{**kw, "int8_decode": True}))

    def make(*args, **kwargs):
        full, cached = orig(*args, **kwargs)

        def alter(out):
            out = out.clone()
            n = out.shape[0]
            if kind == "half_batch":
                out[n // 2:] = 0
            else:
                out[n // 2, :16, :16] = (out[n // 2, :16, :16] + 1) % 5
            return out

        def altered(fn):
            def call(*a):
                out, enc = fn(*a)
                return alter(out), enc
            return call

        if kind == "stale_state":
            return full, lambda v, enc, *a: (cached(v, enc, *a)[0], enc)
        return altered(full), altered(cached)

    return _patched(flow, "make_cached_flow_predict_fn", make)


def _train(kind: str):
    from floodseg_tpu_torch.train import state as state_mod
    from floodseg_tpu_torch.train import supervised

    if kind == "stale_state":
        return _patched(state_mod.TrainState, "apply_gradients", lambda self: None)
    if kind == "half_batch":
        orig = supervised.make_train_step

        def make(*args, **kwargs):
            step = orig(*args, **kwargs)

            def half(state, batch, rng):
                b = batch["label"].shape[0] // 2
                return step(state, {k: v[:b] for k, v in batch.items()}, rng)
            return half
        return _patched(supervised, "make_train_step", make)
    orig_apply = state_mod.TrainState.apply_gradients

    def apply(self):
        first = next(iter(self.model.parameters()))
        if first.grad is not None:
            first.grad.mul_(2.0)
        orig_apply(self)
    return _patched(state_mod.TrainState, "apply_gradients", apply)


FAULTS = {"flow_predict": ("stale_state", "half_batch", "altered", "warp_identity"),
          "train_step": ("stale_state", "half_batch", "altered")}
ON_CHIP = {"flow_predict": ("chain_step_dropped",), "train_step": ()}


def plant(generator: str, kind: str):
    """The context manager that plants fault (or lower precision) ``kind``
    for ``generator``."""
    return _flow(kind) if generator == "flow_predict" else _train(kind)
