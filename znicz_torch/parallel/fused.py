"""The fused forward pass (port of ``FusedTrainer.forward_pass`` and
``_decode`` in ``znicz_tpu/parallel/fused.py``; eval only).

The forward composes the modules' own forwards, except where the
planners route a span through a fused stage: with
``root.common.engine.fused_elementwise`` each conv1/conv2-style block
(ConvStrictRELU -> LRN -> exactly tiling MaxPooling) runs as the raw
convolution plus ONE launch of the block kernel (K1); with
``fused_tail`` each remaining ConvStrictRELU runs as the raw convolution
plus the bias+ReLU kernel (K2), and each All2AllStrictRELU(+dropout) as
the raw product plus the FC epilogue.  A softmax head emits LOGITS.
The plans are read from the knobs on every call.

The train step, scans and the device mesh come with the training slice.
"""

from __future__ import annotations

import torch

from znicz_torch.all2all import All2AllSoftmax
from znicz_torch.dropout import DropoutForward
from znicz_torch.fused_block import (fused_bias_relu, fused_block,
                                     fused_fc_epilogue, plan_fused_blocks,
                                     plan_fused_tail)
from znicz_torch.ops.linear import linear


class FusedTrainer:
    """The eval forward of a built ``StandardWorkflow`` (its ``forwards``
    and, for uint8 requests, its ``scale``/``shift`` decode)."""

    def __init__(self, workflow):
        self.workflow = workflow
        self.forwards = list(workflow.forwards)
        self._decode_params = (float(getattr(workflow, "scale", 1.0)),
                               float(getattr(workflow, "shift", 0.0)))

    def _decode(self, data):
        """uint8 data decodes to ``u8 * scale + shift`` on the device; any
        other dtype passes through."""
        if data.dtype == torch.uint8:
            scale, shift = self._decode_params
            data = data.to(torch.float32) * scale + shift
        return data

    def forward_pass(self, x, train: bool = False):
        """The last module's output (LOGITS for a softmax head) for an
        NHWC batch ``x``."""
        if train:
            raise NotImplementedError(
                "the train forward (dropout masks) comes with the "
                "training slice")
        plan = plan_fused_blocks(self.forwards)
        tail_plan = plan_fused_tail(self.forwards, plan)
        h = x
        last = self.forwards[-1]
        i = 0
        while i < len(self.forwards):
            f = self.forwards[i]
            blk = plan.get(i)
            if blk is not None:
                h = fused_block(f.apply_linear(h), f.bias, blk.n, blk.alpha,
                                blk.beta, blk.k, blk.pool)
                i += blk.span
                continue
            tl = tail_plan.get(i)
            if tl is not None:
                if tl.kind == "conv_bias_relu":
                    h = fused_bias_relu(f.apply_linear(h), f.bias)
                else:                               # fc_epilogue
                    y = linear(h, f.weights,
                               weights_transposed=f.weights_transposed)
                    h = fused_fc_epilogue(y, f.bias).reshape(
                        (x.shape[0],) + f.output_sample_shape)
                i += tl.span
                continue
            if isinstance(f, DropoutForward):
                pass                                # eval: identity
            elif f is last and isinstance(f, All2AllSoftmax):
                h = linear(h, f.weights, f.bias,
                           weights_transposed=f.weights_transposed)
                h = h.reshape((x.shape[0],) + f.output_sample_shape)
            else:
                h = f(h)
            i += 1
        return h
