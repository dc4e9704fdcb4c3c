"""The fused trainer (port of ``FusedTrainer`` in
``znicz_tpu/parallel/fused.py``: the forward pass, the loss head, the
train and eval steps, and a sequential epoch loop).

The forward composes the modules' own forwards, except where the
planners route a span through a fused stage: with
``root.common.engine.fused_elementwise`` each conv1/conv2-style block
(ConvStrictRELU -> LRN -> exactly tiling MaxPooling) runs as the raw
convolution plus the block kernels (K1 forward, K1b backward); with
``fused_tail`` each remaining ConvStrictRELU runs as the raw convolution
plus the bias+ReLU kernels (K2, K2b), each All2AllStrictRELU(+dropout)
as the raw product plus the FC epilogue, and the loss as the fused
softmax-CE head.  ``pallas_lrn`` sends the LRN modules through K3/K3b.
A softmax head emits LOGITS.  The plans are read from the knobs on every
call.

A train step is one autograd pass over the loss, then ``sgd_update`` per
parameter with the bias/weight hyperparameter split, as the reference's
``_update_core``.  :meth:`FusedTrainer.run` is a sequential loop — one
dispatch per minibatch, no scans — with the reference's epoch-tail rule:
on the last TRAIN minibatch of an epoch, an eval step replays the train
forward with that step's dropout masks, the Decision rules on its
metrics, and the update is applied only if ``gd_skip`` stays open.

**Dropout masks.**  ``mask_fn(step, index, shape, ratio)`` supplies the
mask of forwards index ``index`` at train step ``step``; by default it
draws :meth:`DropoutForward.make_mask` from the ``fused_trainer`` stream's
generator for (step, index) on the workflow's device, so the same
(step, index) always gives the same mask — the FC epilogue's backward
regenerates it instead of keeping it.  Tests pass the reference's masks
through this seam.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from znicz_torch.all2all import All2AllSoftmax
from znicz_torch.core import prng
from znicz_torch.core.config import root
from znicz_torch.dropout import DropoutForward
from znicz_torch.evaluator import EvaluatorSoftmax, confusion
from znicz_torch.fused_block import (fused_bias_relu, fused_block,
                                     fused_fc_epilogue, fused_softmax_xent,
                                     plan_fused_blocks, plan_fused_tail)
from znicz_torch.loader.base import TRAIN
from znicz_torch.ops.linear import linear

MaskFn = Callable[[int, int, tuple, float], torch.Tensor]


class FusedTrainer:
    """Train and run a built ``StandardWorkflow`` (its ``forwards``,
    ``gds``, ``loader``, ``evaluator`` and ``decision``) on its device.  A
    workflow built without a loader can only run :meth:`forward_pass`
    (serving)."""

    def __init__(self, workflow, mask_fn: Optional[MaskFn] = None):
        self.workflow = workflow
        self.forwards = list(workflow.forwards)
        self.device = workflow.device
        self.loader = getattr(workflow, "loader", None)
        self.decision = getattr(workflow, "decision", None)
        self.gd_of = dict(getattr(workflow, "gds", {}))
        ev = getattr(workflow, "evaluator", None)
        if ev is not None and not isinstance(ev, EvaluatorSoftmax):
            raise ValueError("only the softmax loss is ported")
        self.compute_confusion = (bool(ev.compute_confusion)
                                  if ev is not None and ev.confusion_explicit
                                  else True)
        self._decode_params = (float(getattr(workflow, "scale", 1.0)),
                               float(getattr(workflow, "shift", 0.0)))
        self.mask_fn: MaskFn = mask_fn or self.default_mask
        self.steps_done = 0
        #: losses of every TRAIN minibatch fed to the Decision, in order
        self.train_losses = []
        #: ``img_per_sec`` counts every step; ``warm_*`` leave out the
        #: first call of each kind (train, tail, eval), which pays the
        #: kernel builds and cuDNN's algorithm search
        self.stats = {"train_steps": 0, "eval_steps": 0, "images": 0,
                      "wall_s": 0.0, "img_per_sec": 0.0, "warm_images": 0, "warm_wall_s": 0.0,
                      "warm_img_per_sec": 0.0}
        self._seen_kinds = set()

    # -- state -----------------------------------------------------------------

    def _weighted(self):
        return [f for f in self.forwards if f.has_weights]

    @staticmethod
    def _params_of(f) -> Dict[str, torch.Tensor]:
        out = {"weights": f.weights}
        if f.include_bias:
            out["bias"] = f.bias
        return out

    def extract_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{module name: {"weights": tensor, "bias": tensor}}``, the live
        parameters (the reference's tree layout)."""
        return {f.name: self._params_of(f) for f in self._weighted()}

    def extract_velocities(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The momentum state in the same layout (zeros until trained)."""
        self._init_velocities()
        return {f.name: dict(self.gd_of[f.name].velocities)
                for f in self._weighted() if f.name in self.gd_of}

    def hypers(self):
        """``{module name: (lr, lr_bias, wd, wd_bias, l1_vs_l2, moment,
        moment_bias, clip)}`` as float32."""
        return {f.name: self.gd_of[f.name].hypers()
                for f in self._weighted() if f.name in self.gd_of}

    def _init_velocities(self) -> None:
        """Zero momentum for every parameter that has none yet, and
        gradients on for every parameter."""
        for f in self._weighted():
            gd = self.gd_of.get(f.name)
            if gd is None:
                raise ValueError(f"{f.name} has no gradient-descent "
                                 f"hyperparameters")
            for k, p in self._params_of(f).items():
                p.requires_grad_(True)
                if k not in gd.velocities:
                    gd.velocities[k] = torch.zeros_like(p.detach())

    # -- the forward -----------------------------------------------------------

    def default_mask(self, step: int, index: int, shape, ratio: float):
        gen = prng.get("fused_trainer").torch_generator(step, index,
                                                        self.device)
        return DropoutForward.make_mask(gen, shape, ratio)

    def _decode(self, data):
        """uint8 data decodes to ``u8 * scale + shift`` on the device; any
        other dtype passes through."""
        if data.dtype == torch.uint8:
            scale, shift = self._decode_params
            data = data.to(torch.float32) * scale + shift
        return data

    def forward_pass(self, x, train: bool = False, step: int = 0):
        """The last module's output (LOGITS for a softmax head) for an
        NHWC batch ``x``; ``train`` applies the dropout masks of train
        step ``step``."""
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
                    mask_of = None
                    if train and tl.dropout_index >= 0 and tl.ratio > 0.0:
                        def mask_of(shape=tuple(y.shape), tl=tl):
                            return self.mask_fn(step, tl.dropout_index,
                                                shape, tl.ratio)
                    h = fused_fc_epilogue(y, f.bias, mask_of).reshape(
                        (x.shape[0],) + f.output_sample_shape)
                i += tl.span
                continue
            if isinstance(f, DropoutForward):
                if train:
                    h = h * self.mask_fn(step, i, tuple(h.shape),
                                         f.dropout_ratio)
            elif f is last and isinstance(f, All2AllSoftmax):
                h = linear(h, f.weights, f.bias,
                           weights_transposed=f.weights_transposed)
                h = h.reshape((x.shape[0],) + f.output_sample_shape)
            else:
                h = f(h)
            i += 1
        return h

    # -- loss, steps -----------------------------------------------------------

    def loss_and_metrics(self, data, target, batch_size: int, step: int,
                         train: bool):
        """``(loss, (loss, n_err, confusion))`` of a minibatch whose first
        ``batch_size`` rows are valid; the loss is the mean softmax-CE of
        those rows, through the fused head under ``fused_tail``."""
        logits = self.forward_pass(data, train, step).float()
        n = logits.shape[0]
        valid = torch.arange(n, device=logits.device) < batch_size
        denom = max(int(batch_size), 1)
        if bool(root.common.engine.get("fused_tail", False)):
            loss = fused_softmax_xent(logits, target, valid, denom)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, 1, target[:, None])[:, 0]
            loss = torch.sum(torch.where(valid, logz - ll, 0.0)) / denom
        pred = torch.argmax(logits, dim=-1)
        n_err = torch.sum((pred != target) & valid)
        conf = confusion(pred, target, valid,
                         logits.shape[-1] if self.compute_confusion else 0)
        return loss, (loss.detach(), n_err, conf)

    def _minibatch(self, idx):
        data, target = self.loader.gather(idx)
        return self._decode(data), target

    def train_step(self, idx, batch_size: int, step: int):
        """Forward, autograd, and the update of every parameter; returns
        the step's metrics."""
        self._init_velocities()
        data, target = self._minibatch(idx)
        tree = self.extract_params()
        leaves = [(name, k, p) for name, ps in tree.items()
                  for k, p in ps.items()]
        loss, metrics = self.loss_and_metrics(data, target, batch_size,
                                              step, train=True)
        grads = torch.autograd.grad(loss, [p for _, _, p in leaves])
        with torch.no_grad():
            for (name, k, p), g in zip(leaves, grads):
                p.copy_(self.gd_of[name].update(k, p, g))
        self.stats["train_steps"] += 1
        return metrics

    def eval_step(self, idx, batch_size: int, step: int = 0,
                  train: bool = False):
        """Metrics only.  ``train`` replays the train forward with the
        dropout masks of ``step`` (the epoch tail)."""
        data, target = self._minibatch(idx)
        with torch.no_grad():
            _, metrics = self.loss_and_metrics(data, target, batch_size,
                                               step, train)
        self.stats["eval_steps"] += 1
        return metrics

    # -- the epoch loop --------------------------------------------------------

    def _feed_decision(self, mb, metrics) -> None:
        loss, n_err, conf = metrics
        d = self.decision
        d.minibatch_class = mb["class"]
        d.last_minibatch = mb["last_minibatch"]
        d.class_ended = mb["class_ended"]
        d.epoch_number = mb["epoch_number"]
        d.class_lengths = list(self.loader.class_lengths)
        d.minibatch_size = mb["size"]
        d.minibatch_loss = float(loss)
        d.minibatch_n_err = int(n_err)
        d.confusion_matrix = conf
        if mb["class"] == TRAIN:
            self.train_losses.append(d.minibatch_loss)
        d.run()

    def _advance(self):
        ldr = self.loader
        ldr.run()
        return {"idx": ldr.minibatch_indices, "class": ldr.minibatch_class,
                "size": ldr.minibatch_size,
                "last_minibatch": ldr.last_minibatch,
                "class_ended": ldr.class_ended,
                "epoch_number": ldr.epoch_number}

    def _account(self, kind: str, images: int, t0: float) -> None:
        dt = time.perf_counter() - t0
        st = self.stats
        st["wall_s"] += dt
        st["images"] += images
        st["img_per_sec"] = st["images"] / st["wall_s"]
        if kind in self._seen_kinds:
            st["warm_wall_s"] += dt
            st["warm_images"] += images
            if st["warm_wall_s"] > 0:
                st["warm_img_per_sec"] = st["warm_images"] / st["warm_wall_s"]
        self._seen_kinds.add(kind)

    def run(self) -> None:
        """Train until the Decision completes.  Every step reads its
        metrics back to the host, which synchronises with the device, so
        the stats' wall times are device-inclusive."""
        if self.loader is None:
            raise ValueError("the workflow has no loader to train from")
        self._init_velocities()
        decision = self.decision
        while not decision.complete:
            mb = self._advance()
            t0 = time.perf_counter()
            if mb["class"] == TRAIN and not mb["last_minibatch"]:
                metrics = self.train_step(mb["idx"], mb["size"],
                                          self.steps_done)
                self.steps_done += 1
                self._feed_decision(mb, metrics)
                self._account("train", mb["size"], t0)
            elif mb["class"] == TRAIN:
                # epoch tail: metrics first, the Decision rules, and the
                # update applies only if gd_skip stayed open
                metrics = self.eval_step(mb["idx"], mb["size"],
                                         self.steps_done, train=True)
                self._feed_decision(mb, metrics)
                if not decision.gd_skip:
                    self.train_step(mb["idx"], mb["size"], self.steps_done)
                self.steps_done += 1
                self._account("tail", mb["size"], t0)
            else:
                metrics = self.eval_step(mb["idx"], mb["size"])
                self._feed_decision(mb, metrics)
                self._account("eval", 0, t0)
