"""Peak rates of the card the port targets, NVIDIA H100 SXM (NVIDIA's data
sheet, dense): the roofs of chip_smoke.py's ``bound_ms`` and of
tools/mfu_torch.py's utilization. A card run below its 700 W limit reaches
less; the tools print the limit beside their numbers."""

PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}  # operations/s
