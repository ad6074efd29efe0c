"""Checkpoints with top-k retention (counterpart of
floodseg_tpu/core/checkpoint.py).

The JAX package's on-disk semantics with ``torch.save`` in place of orbax:
a save every epoch; the top ``save_top_k`` by ``monitor``
(``val_miou_epoch`` unless the caller names another, as the standalone
Segmenter trainer names ``val_miou``) as
``epoch={e}-{monitor}={m:.4f}.pt`` (an epoch without the metric takes no
top-k slot); the crash fallback ``last-{epoch}.pt``, of which the
previous one is removed only at the next save, and a ``last`` symlink to
the newest; ``index.json`` with the top-k entries, read back with entries
whose file is missing (a crash between the write and the index) dropped.
The file names are the JAX package's directory names plus ``.pt``; the
index holds the names without it.

Saves are synchronous and atomic: each file is written under a temporary
name and moved into place with ``os.replace``, so a crash leaves either
the old file or the new one; the ``last`` link points at the new last
checkpoint when ``save`` returns. An epoch that enters the top k writes
its bytes once: its ``last-{epoch}.pt`` is a hard link of the top-k file
(no file is ever rewritten in place, only replaced or removed), or a
second write where the file system has no hard links. ``restore`` of a ``.../last`` path resolves
to the newest ``last-{epoch}.pt`` in that directory.

A checkpoint holds a method's whole state (``state_payload``): a
``TrainState``'s step, model state_dict and optimizer state; for s4GAN the
(generator, discriminator) pair of them; for U2PL the student's, the
teacher's state_dict, ``teacher_synced``, whether the teacher's parameters
alias the student's, and the memory bank. ``load_payload`` restores one
into a state of the same method and shapes, in place.

Over the ranks of a ``world`` (parallel/mesh.py) only rank 0 writes; every
rank waits for the save at a barrier and then reads the index, so that
resume and ``best_path`` agree on every rank.
"""

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from floodseg_tpu_torch.parallel.mesh import barrier

SUFFIX = ".pt"


def _scan_last_entries(directory: str) -> List[Tuple[int, str]]:
    """(epoch, path) of the ``last-{epoch}.pt`` files in ``directory``,
    oldest first."""
    out = []
    if not os.path.isdir(directory):
        return out
    for f in os.listdir(directory):
        if f.startswith("last-") and f.endswith(SUFFIX):
            try:
                out.append((int(f[len("last-"):-len(SUFFIX)]), os.path.join(directory, f)))
            except ValueError:
                continue
    return sorted(out)


def _resolve_last(path: str) -> Optional[str]:
    """A ``.../last`` request -> the newest ``last-{epoch}.pt`` in that
    directory (never another manager's): covers a missing ``last`` link
    after a crash and a stale one left by an earlier fit."""
    entries = _scan_last_entries(os.path.dirname(os.path.abspath(path)))
    if entries:
        return entries[-1][1]
    return path if os.path.exists(path) else None


def _link_or_save(src: str, payload, path: str) -> None:
    """``path`` as a hard link of ``src``, which holds ``payload``; the
    payload written again where the link fails."""
    try:
        os.link(src, path)
    except OSError:
        torch.save(payload, path)


def _atomic(path: str, write) -> None:
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
    write(tmp)
    os.replace(tmp, path)


# ---------------------------------------------------------------- payloads

def _train_payload(ts) -> Dict[str, Any]:
    return {"step": ts.step, "model": ts.model.state_dict(),
            "optimizer": ts.optimizer.state_dict()}


def _load_train(ts, p: Dict[str, Any]) -> None:
    ts.model.load_state_dict(p["model"], strict=True)
    ts.optimizer.load_state_dict(p["optimizer"])
    ts.step = int(p["step"])


def _aliased(state) -> bool:
    """Whether the U2PL teacher's parameters are the student's tensors."""
    teacher = dict(state.teacher.named_parameters())
    return all(teacher.get(n) is p for n, p in state.student.model.named_parameters())


def state_payload(state) -> Dict[str, Any]:
    """What a checkpoint of ``state`` holds: a TrainState, s4GAN's
    (generator, discriminator) pair, or a U2PLState."""
    from floodseg_tpu_torch.train.contrastive import U2PLState

    if isinstance(state, tuple):
        return {"kind": "gan", "generator": _train_payload(state[0]),
                "discriminator": _train_payload(state[1])}
    if isinstance(state, U2PLState):
        bank = state.bank
        return {"kind": "u2pl", "student": _train_payload(state.student),
                "teacher": state.teacher.state_dict(),
                "teacher_synced": bool(state.teacher_synced),
                "teacher_aliased": _aliased(state),
                "bank": {"buffer": bank.buffer, "counts": bank.counts, "ptrs": bank.ptrs,
                         "caps": list(bank.caps)}}
    return {"kind": "train", **_train_payload(state)}


@torch.no_grad()
def load_payload(state, payload: Dict[str, Any]):
    """Restore ``payload`` into ``state`` (same method and shapes) in place
    and return it. A U2PL teacher saved aliased is aliased again."""
    from floodseg_tpu_torch.train.contrastive import U2PLState, sync_teacher

    kind = payload["kind"]
    want = ("gan" if isinstance(state, tuple) else "u2pl" if isinstance(state, U2PLState)
            else "train")
    if kind != want:
        raise ValueError(f"a {kind!r} checkpoint cannot restore a {want!r} state")
    if kind == "gan":
        _load_train(state[0], payload["generator"])
        _load_train(state[1], payload["discriminator"])
    elif kind == "u2pl":
        _load_train(state.student, payload["student"])
        state.teacher.load_state_dict(payload["teacher"], strict=True)
        bank, saved = state.bank, payload["bank"]
        if tuple(saved["caps"]) != tuple(bank.caps):
            raise ValueError(f"bank capacities {tuple(saved['caps'])} != {tuple(bank.caps)}")
        for k in ("buffer", "counts", "ptrs"):
            getattr(bank, k).copy_(saved[k])
        state.teacher_synced = bool(payload["teacher_synced"])
        if payload["teacher_aliased"]:
            sync_teacher(state, alias=True)
    else:
        _load_train(state, payload)
    return state


def read_model_state(path: str) -> Dict[str, torch.Tensor]:
    """The model's state_dict from a file: a TrainState's checkpoint (what
    ``segm.train`` and the supervised fits save), or a ``torch.save`` of a
    state_dict itself. A ``.../last`` path resolves as in
    ``CheckpointManager.restore``."""
    if os.path.basename(path) == "last":
        path = _resolve_last(path) or path
    payload = torch.load(path, map_location="cpu", weights_only=False)
    return payload["model"] if payload.get("kind") == "train" else payload


# ---------------------------------------------------------------- manager

class CheckpointManager:
    MONITOR = "val_miou_epoch"  # ranked highest first

    def __init__(self, directory: str, save_top_k: int = 5, world=None,
                 monitor: str = MONITOR):
        self.directory = os.path.abspath(directory)
        self.world = world
        self.monitor = monitor
        if world is None or world.is_main:
            os.makedirs(self.directory, exist_ok=True)
        self.save_top_k = save_top_k
        self._index_path = os.path.join(self.directory, "index.json")
        self._read_index()

    def _read_index(self) -> None:
        self._index: List[Dict] = []
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)
            # crash orphans: entries whose file never landed would hold
            # top-k slots and could become best_path
            self._index = [e for e in self._index if os.path.isfile(self._path(e["name"]))]

    # ---- paths ----

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name + SUFFIX)

    def _last_entries(self) -> List[Tuple[int, str]]:
        return _scan_last_entries(self.directory)

    @property
    def last_path(self) -> Optional[str]:
        entries = self._last_entries()
        return entries[-1][1] if entries else None

    @property
    def last_epoch(self) -> Optional[int]:
        """Epoch of the newest last checkpoint on disk, else the newest
        top-k entry's."""
        entries = self._last_entries()
        if entries:
            return entries[-1][0]
        if self._index:
            return max(e["epoch"] for e in self._index)
        return None

    @property
    def best_path(self) -> Optional[str]:
        live = [e for e in self._index if os.path.isfile(self._path(e["name"]))]
        if not live:
            return None
        best = max(live, key=lambda e: e["metric"])
        return self._path(best["name"])

    # ---- save / restore ----

    def save(self, state: Any, epoch: int, metrics: Dict[str, float]):
        """Save ``state`` as ``last-{epoch}.pt`` and, when the monitored metric
        was computed and ranks in the top k, under its top-k name. The
        previous save's last checkpoint is kept until now and then removed,
        all but the newest, and the ``last`` link points at the new one.
        Rank 0 writes; the other ranks read the index after it."""
        if self.world is None or self.world.is_main:
            self._save(state, epoch, metrics)
        if self.world is not None and self.world.parallel:
            barrier(self.world)
            if not self.world.is_main:
                self._read_index()

    def _save(self, state: Any, epoch: int, metrics: Dict[str, float]):
        for _, p in self._last_entries()[:-1]:
            os.remove(p)
        metric = metrics.get(self.monitor)
        if metric is None or self.save_top_k == 0:
            keeps = False
        elif self.save_top_k < 0 or len(self._index) < self.save_top_k:
            keeps = True
        else:
            keeps = metric > min(e["metric"] for e in self._index)
        payload = state_payload(state)
        last = self._path(f"last-{epoch}")
        if keeps:
            metric = float(metric)
            name = f"epoch={epoch}-{self.monitor}={metric:.4f}"
            _atomic(self._path(name), lambda p: torch.save(payload, p))
            self._index.append({"name": name, "epoch": epoch, "metric": metric})
            _atomic(last, lambda p: _link_or_save(self._path(name), payload, p))
        else:
            _atomic(last, lambda p: torch.save(payload, p))
        self._prune()

        def write_index(p):
            with open(p, "w") as f:
                json.dump(self._index, f, indent=1)

        _atomic(self._index_path, write_index)
        self._refresh_last_link()

    def _refresh_last_link(self):
        """Point the ``last`` symlink at the newest last checkpoint."""
        entries = self._last_entries()
        if not entries:
            return
        link = os.path.join(self.directory, "last")
        tmp = os.path.join(self.directory, ".last.tmp")
        try:
            if os.path.islink(link) or not os.path.exists(link):
                if os.path.lexists(tmp):
                    os.remove(tmp)
                os.symlink(os.path.basename(entries[-1][1]), tmp)
                os.replace(tmp, link)
        except OSError:
            pass  # a file system without symlinks: restore() resolves instead

    def _prune(self):
        if self.save_top_k < 0:
            return
        keep_names = {e["name"] for e in sorted(self._index, key=lambda e: -e["metric"])
                      [: self.save_top_k]}
        for e in list(self._index):
            if e["name"] not in keep_names:
                p = self._path(e["name"])
                if os.path.exists(p):
                    os.remove(p)
                self._index.remove(e)

    def restore(self, target: Any, path: Optional[str] = None) -> Any:
        """Restore into ``target`` (a state of the method, in place) from
        ``path``, or from this manager's newest last checkpoint. A
        ``.../last`` path resolves to the newest ``last-{epoch}.pt`` in its
        own directory."""
        if path is not None and os.path.basename(path) == "last":
            resolved = _resolve_last(path)
            if resolved is None:
                raise FileNotFoundError(f"no last checkpoint at {path}")
            path = resolved
        path = path or self.last_path
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return load_payload(target, torch.load(path, map_location="cpu", weights_only=False))
