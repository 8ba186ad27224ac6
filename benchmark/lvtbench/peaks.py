"""Peak rates of the NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit), a frozen copy of the port's ``utils/device_specs.py``, and the
least time a piece of work could take on it (``chip_smoke.py``
``bound_ms``). A card set below 700 W reaches less; the benchmark prints the
card's limit beside every share of these peaks."""

PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}  # operations/s


def bound_ms(dtype: str, nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the bytes the work must move (each input
    read once, each output written once) over the memory rate, or its
    operations over the peak rate of their type, whichever is larger."""
    tb, tf = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_FLOPS[dtype]
    return (tb, "bytes") if tb >= tf else (tf, "operations")
