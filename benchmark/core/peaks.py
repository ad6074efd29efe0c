"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the full 700 W power limit). A share of a peak is stated
against these, with the card's power limit beside it."""

PEAK_BYTES_PER_S = 3.35e12
# dense operations a second by the dtype a configuration computes in;
# float32 is the rate outside the tensor cores, since the port turns TF32
# off for float32 (core/device.py::full_precision_f32)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "int8": 1979e12}
