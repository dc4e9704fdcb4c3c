"""Max pooling over NHWC (port of ``MaxPooling`` in
``znicz_tpu/pooling.py``).

The reference's geometry: ``sliding`` defaults to the kernel size,
partial windows at the right/bottom edges are kept, and the plane is
padded with -inf up to ``(oh-1)*sy + ky`` rows and ``(ow-1)*sx + kx``
columns, exactly as its ``reduce_window`` pads.
"""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F

from znicz_torch.forward import ForwardModule


def pool_output_hw(h: int, w: int, ky: int, kx: int,
                   sliding: Tuple[int, int]) -> Tuple[int, int]:
    sy, sx = sliding
    return (max(1, -(-max(h - ky, 0) // sy) + 1),
            max(1, -(-max(w - kx, 0) // sx) + 1))


class MaxPooling(ForwardModule):
    def __init__(self, name=None, kx=2, ky=2, sliding=None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.kx = int(kx)
        self.ky = int(ky)
        self.sliding = (tuple(int(s) for s in sliding) if sliding
                        else (self.ky, self.kx))

    def output_shape_for(self, in_shape):
        b, h, w, c = in_shape
        oh, ow = pool_output_hw(h, w, self.ky, self.kx, self.sliding)
        return (b, oh, ow, c)

    def _padded_hw(self, h: int, w: int) -> Tuple[int, int]:
        oh, ow = pool_output_hw(h, w, self.ky, self.kx, self.sliding)
        sy, sx = self.sliding
        return (oh - 1) * sy + self.ky, (ow - 1) * sx + self.kx

    def exact_tiling(self) -> bool:
        """True when every window is full: the padded extent equals the
        built input plane.  The fused block kernel's precondition."""
        _, h, w, _ = self.in_shape
        return self._padded_hw(h, w) == (h, w)

    def forward(self, x):
        _, h, w, _ = x.shape
        ph, pw = self._padded_hw(h, w)
        xn = x.permute(0, 3, 1, 2)
        if (ph, pw) != (h, w):
            xn = F.pad(xn, (0, pw - w, 0, ph - h), value=float("-inf"))
        y = F.max_pool2d(xn, (self.ky, self.kx), stride=self.sliding)
        return y.permute(0, 2, 3, 1).contiguous()
