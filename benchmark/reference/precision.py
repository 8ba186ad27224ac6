"""The precision a reference computes its products in.

``FP32`` is the reference itself: float32 operands and sums, TF32 off. The
controls of the correctness check put the reference in the program's place
at the precision just below the one a configuration states:

* ``TF32`` for a float32 model: every operand of a product (matmul,
  convolution, embedding row) rounded to TF32's 10 mantissa bits, to
  nearest, then multiplied and summed in float32. The rounding is made
  explicitly, so that the CPU and the card compute the same numbers.
* ``FP8`` for a bfloat16 model: every operand rounded to float8 e4m3 with a
  scale of its own (its largest magnitude onto 448, e4m3's largest value),
  then multiplied and summed in float32.
"""

import torch

E4M3_MAX = 448.0


def set_true_fp32():
    """Turn TF32 off for matmuls and cuDNN convolutions in this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    # round to nearest (ties away) on the 13 bits TF32 drops, then clear them
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """Operand rounding of one precision; ``q`` rounds an operand of a
    product, ``mm`` / ``einsum`` multiply rounded operands in float32."""

    def __init__(self, name: str):
        if name not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x rounded, in float32; the gradient passes the rounding unchanged."""
        x = x.float()
        if self.name == "fp32":
            return x
        r = _round_tf32(x.detach()) if self.name == "tf32" else _round_fp8(x.detach())
        return x + (r - x).detach() if x.requires_grad else r

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))


FP32 = Precision("fp32")
TF32 = Precision("tf32")
FP8 = Precision("fp8")

# the control of each stated dtype: the nearest precision below it
CONTROL = {"float32": TF32, "bfloat16": FP8}
