"""Dense op (port of ``znicz_tpu/ops/linear.py``): a plain ``torch.matmul``,
as the reference leaves its ``jnp.dot`` to XLA.  bf16 operands keep a bf16
output (float32 sums inside: ``backends.resolve_device`` turns cuBLAS's
reduced-precision bf16 reduction off), as the reference's bf16 products
do, so that the cotangents keep the operands' dtype."""

from __future__ import annotations


def linear(x, w, b=None, *, weights_transposed: bool = False):
    """``y = x @ W^T + b`` over flattened trailing dims.  Weights are
    stored ``(out, in)``, or ``(in, out)`` with ``weights_transposed``.
    An NHWC input flattens in H, W, C order."""
    x2 = x.reshape(x.shape[0], -1)
    y = x2 @ (w if weights_transposed else w.t())
    if b is not None:
        y = y + b
    return y
