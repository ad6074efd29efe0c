"""The plain reference: PSPNet, DeepLabV3, the keyframe warp and the
supervised training step in plain PyTorch (float32, NCHW, no kernel, no
cache, no batching tricks).

It imports nothing of the program under test and takes nothing the program
made: the benchmark hands it the weights and inputs it made itself. The
parameter names are the torch names of the published models, so one
weights mapping serves both sides.
"""
