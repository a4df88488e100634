"""Precisions for the reference and its control: float32 matrix products
with TF32 off (the reference), and the controls one step below a cell's
stated precision: TF32 for a float32 learner, fp8 (e4m3) operands for a
bf16 one. Besides, a witness of sound arithmetic in another order: every
dense layer's product summed from two halves of its inputs."""
from __future__ import annotations

import contextlib

import torch


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor, dt) -> torch.Tensor:
    """`t` in `dt` with its values rounded to float8 e4m3; gradients pass
    through unchanged."""
    t = t.to(dt)
    return t + (t.to(torch.float8_e4m3fn).to(dt) - t).detach()


@contextlib.contextmanager
def lowered(kind: str | None):
    """Within: the control's precision. "tf32" lets float32 products use
    TF32; "fp8" rounds both operands of every dense layer to float8 e4m3
    before the product; "split" sums every dense layer's product from the
    two halves of its inputs; None changes nothing."""
    if kind is None:
        yield
        return
    if kind == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            strict_fp32()
        return
    linear = torch.nn.functional.linear
    if kind == "split":
        def split_linear(x, w, b=None):
            k = w.shape[1] // 2
            if k == 0:
                return linear(x, w, b)
            lo, hi = linear(x[..., :k], w[:, :k]), linear(x[..., k:], w[:, k:], b)
            return (lo.float() + hi.float()).to(lo.dtype)

        torch.nn.functional.linear = split_linear
        try:
            yield
        finally:
            torch.nn.functional.linear = linear
        return
    if kind != "fp8":
        raise ValueError(f"unknown control precision {kind!r}")

    def fp8_linear(x, w, b=None):
        dt = torch.get_autocast_dtype("cuda") if torch.is_autocast_enabled() else x.dtype
        return linear(_fp8(x, dt), _fp8(w, dt), b)

    torch.nn.functional.linear = fp8_linear
    try:
        yield
    finally:
        torch.nn.functional.linear = linear
