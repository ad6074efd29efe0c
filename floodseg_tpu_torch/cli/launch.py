"""Launchers of a run (counterpart of scripts/train.sh, test.sh, predict.sh
and ingress_new_video.sh):

    python -m floodseg_tpu_torch.cli.launch train <method> [args...]
    python -m floodseg_tpu_torch.cli.launch test <method> <run_dir> [args...]
    python -m floodseg_tpu_torch.cli.launch predict <method> <run_dir> [args...]
    python -m floodseg_tpu_torch.cli.launch ingress <video>

``train``, ``test`` and ``predict`` layer configs/train_base.yaml,
configs/train_<method>.yaml and configs/dataset_flow.yaml (paths relative to
the working directory, as the scripts take them), add ``--method`` and, for
``test`` and ``predict``, ``--ckpt_path <run_dir>/checkpoints/last``, then the
extra args in order, and call ``cli/main.py::main`` with that argv in this
process. The run is on the card unless the extra args hold ``--device cpu``.

``ingress`` re-encodes ``<video>.webm`` to ``<video>.mp4`` without B-frames
at 25 fps and 1920x1072 with ffmpeg, then extracts its frames and block
motion-vector grids (data/tools/extract_motion_vectors.py). Both tools are
looked for first: without ffmpeg on the PATH or the mvextractor package it
stops, naming the one missing.
"""

import importlib.util
import shutil
import subprocess
import sys
from typing import List, Optional, Sequence

SUBCOMMANDS = {"train": "fit", "test": "test", "predict": "predict"}


def cli_argv(command: str, method: str, run_dir: Optional[str] = None,
             extra: Sequence[str] = ()) -> List[str]:
    """The argv scripts/{train,test,predict}.sh pass to the CLI after its
    module name."""
    argv = [SUBCOMMANDS[command]]
    for name in ("train_base", f"train_{method}", "dataset_flow"):
        argv += ["--config", f"configs/{name}.yaml"]
    argv += ["--method", method]
    if command != "train":
        argv += ["--ckpt_path", f"{run_dir}/checkpoints/last"]
    return argv + list(extra)


def ffmpeg_argv(video: str) -> List[str]:
    """scripts/ingress_new_video.sh's re-encode of ``<video>.webm``."""
    return ["ffmpeg", "-i", f"{video}.webm", "-c:v", "libx264", "-x264opts", "bframes=0",
            "-partitions", "none", "-filter:v", "fps=25,scale=1920x1072", f"{video}.mp4"]


def ingress(video: str) -> int:
    """Re-encode ``<video>.webm`` and extract ``<video>.mp4``'s frames and
    grids under ``frames/``; raises ``SystemExit`` naming ffmpeg or
    mvextractor when either is missing, and when ffmpeg fails."""
    if shutil.which("ffmpeg") is None:
        raise SystemExit("ingress needs ffmpeg on the PATH to re-encode the video "
                         "(no B-frames, 25 fps, 1920x1072); it is not installed here")
    if importlib.util.find_spec("mvextractor") is None:
        raise SystemExit("ingress needs mvextractor for motion-vector extraction "
                         "(pip install motion-vector-extractor); it is not installed here")
    done = subprocess.run(ffmpeg_argv(video))
    if done.returncode:
        raise SystemExit(f"ffmpeg exited {done.returncode} re-encoding {video}.webm")
    from floodseg_tpu_torch.data.tools import extract_motion_vectors

    extract_motion_vectors.main([f"{video}.mp4"])
    return 0


USAGE = __doc__.split("\n\n")[1]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    command = argv[0] if argv else None
    if command == "ingress" and len(argv) == 2:
        return ingress(argv[1])
    need = 2 if command == "train" else 3
    if command not in SUBCOMMANDS or len(argv) < need:
        raise SystemExit(f"usage:\n{USAGE}")
    from floodseg_tpu_torch.cli import main as cli

    method, run_dir = argv[1], (argv[2] if need == 3 else None)
    return cli.main(cli_argv(command, method, run_dir, argv[need:]))


if __name__ == "__main__":
    raise SystemExit(main())
