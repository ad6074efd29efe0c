"""The benchmark of floodseg_tpu_torch, the PyTorch and CUDA port.

One command runs one cell once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``README.md`` says how the files are laid out and how a configuration, a
traffic mix or a per-layer metric is added as new files.
"""
