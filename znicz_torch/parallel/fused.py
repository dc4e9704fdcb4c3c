"""The fused trainer (port of ``FusedTrainer`` in
``znicz_tpu/parallel/fused.py``: the forward pass, the loss head, the
train and eval steps, and a sequential epoch loop).

The forward composes the modules' own forwards, except where the
planners route a span through a fused stage: with
``root.common.engine.fused_elementwise`` each conv1/conv2-style block
(ConvStrictRELU, or a plain Conv and a StrictRELU activation layer ->
LRN -> exactly tiling MaxPooling) runs as the raw convolution plus the
block kernels (K1 forward, K1b backward); with ``fused_tail`` each
remaining ConvStrictRELU (or Conv + StrictRELU layer) runs as the raw
convolution
plus the bias+ReLU kernels (K2, K2b), each All2AllStrictRELU(+dropout)
as the raw product plus the FC epilogue, and the loss as the fused
softmax-CE head.  ``pallas_lrn`` sends the LRN modules through K3/K3b.
A softmax head emits LOGITS.  The plans are read from the knobs on every
call.  Under any evaluator but ``EvaluatorSoftmax`` the loss is the
reference's MSE head: half the sum of squares of the last module's
output less the loader's targets (``FullBatchLoaderMSE.gather_targets``)
over the valid rows, over their count, in float32 and never through the
fused softmax head; the Decision gets n_err and a confusion only if it
has them (``DecisionMSE`` has not).

A train step is one autograd pass over the loss, then ``sgd_update`` per
parameter with the bias/weight hyperparameter split, as the reference's
``_update_core``.  :meth:`FusedTrainer.run` is a sequential loop — one
dispatch per minibatch, no scans — with the reference's epoch-tail rule:
on the last TRAIN minibatch of an epoch, an eval step replays the train
forward with that step's dropout masks, the Decision rules on its
metrics, and the update is applied only if ``gd_skip`` stays open.  A
workflow's ``lr_adjust`` unit advances after each applied update, and at
each epoch's end (after the tail's update) its ``snapshotter`` runs, as
the reference's epoch hook runs it.

**Mixed precision** (the reference's ``compute_dtype``, ``master_dtype``
and ``state_dtype`` knobs).  Under ``compute_dtype`` bf16 each step reads
every float32 parameter as its bf16 cast (the reference's ``cparams``;
gradients reach the stored parameters through the cast), casts the input
and then the activation entering every module to bf16, and casts the
logits to float32 before the loss.  Convolutions and products of bf16
operands give bf16; a bf16 activation times a float32 dropout mask is
float32 until the next module's cast.  Under ``master_dtype`` "bfloat16"
the parameters are stored bf16 from the first train step on and updated
in float32; under ``state_dtype`` "bfloat16" the velocities are
(``nn_units.sgd_update``).  ``forward_pass`` itself casts nothing:
serving stays float32.  No ``torch.autocast``: its per-op lists keep some
ops in float32 where the reference does not.

**Dropout masks.**  ``mask_fn(step, index, shape, ratio)`` supplies the
mask of forwards index ``index`` at train step ``step``; by default it
draws :meth:`DropoutForward.make_mask` from the ``fused_trainer`` stream's
generator for (step, index) on the workflow's device, so the same
(step, index) always gives the same mask — the FC epilogue's backward
regenerates it instead of keeping it.  Tests pass the reference's masks
through this seam.

**Stochastic pooling.**  In a train step (and the epoch tail's replay) a
stochastic pooling module outputs the element at offsets sampled from
its window probabilities, ``offset_fn(step, index, probs)``, whose
gradient is scattered back to those positions
(``pooling._StochasticSelect``); by default the offsets are drawn with
:meth:`StochasticPoolingBase.sample_offsets` from the same generator as
a mask of that (step, index).  In evaluation, and in serving, the module
outputs its expectation.  Tests pass the reference's offsets through
this seam.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch
from torch import nn

from znicz_torch.all2all import All2AllSoftmax
from znicz_torch.core import prng
from znicz_torch.core.config import check_engine_knobs, root
from znicz_torch.dropout import DropoutForward
from znicz_torch.evaluator import EvaluatorSoftmax, confusion
from znicz_torch.fused_block import (fused_bias_relu, fused_block,
                                     fused_fc_epilogue, fused_softmax_xent,
                                     plan_fused_blocks, plan_fused_tail)
from znicz_torch.loader.base import TRAIN
from znicz_torch.nn_units import params_of, state_dtype
from znicz_torch.ops.linear import linear
from znicz_torch.pooling import StochasticPoolingBase

MaskFn = Callable[[int, int, tuple, float], torch.Tensor]
OffsetFn = Callable[[int, int, torch.Tensor], torch.Tensor]


def compute_dtype() -> torch.dtype:
    """``root.common.engine.compute_dtype`` ("float32", "bf16" or
    "bfloat16"), or the legacy ``precision`` when it is unset, as a torch
    dtype.  Any other value raises."""
    eng = root.common.engine
    cd = eng.get("compute_dtype", None)
    if cd is None:
        cd = eng.get("precision", "float32")
    cd = {"bf16": "bfloat16"}.get(str(cd), str(cd))
    if cd not in ("float32", "bfloat16"):
        raise ValueError(f"root.common.engine.compute_dtype={cd!r}: must be "
                         "'float32' or 'bf16'/'bfloat16'")
    return torch.float32 if cd == "float32" else torch.bfloat16


def master_dtype() -> Optional[torch.dtype]:
    """``torch.bfloat16`` under ``root.common.engine.master_dtype``
    "bfloat16" (parameters stored bf16), None under "float32".  Any other
    value raises."""
    md = str(root.common.engine.get("master_dtype", "float32"))
    if md not in ("float32", "bfloat16"):
        raise ValueError(f"root.common.engine.master_dtype={md!r}: must be "
                         "'float32' or 'bfloat16'")
    return None if md == "float32" else torch.bfloat16


class FusedUnsupportedError(ValueError):
    """The workflow's graph cannot run on the fused trainer (tied
    weights).  ``engine.train`` catches exactly this to train on the unit
    engine instead; any other error propagates."""


class FusedTrainer:
    """Train and run a built ``StandardWorkflow`` (its ``forwards``,
    ``gds``, ``loader``, ``evaluator`` and ``decision``) on its device.  A
    workflow built without a loader can only run :meth:`forward_pass`
    (serving)."""

    def __init__(self, workflow, mask_fn: Optional[MaskFn] = None,
                 offset_fn: Optional[OffsetFn] = None):
        self.workflow = workflow
        self.forwards = list(workflow.forwards)
        self.device = workflow.device
        self.loader = getattr(workflow, "loader", None)
        self.decision = getattr(workflow, "decision", None)
        self.gd_of = dict(getattr(workflow, "gds", {}))
        # one tensor in two modules would need a joint update the fused
        # step does not make: refused, as the reference refuses it
        seen = {}
        for f in self.forwards:
            for k, p in params_of(f).items():
                if id(p) in seen:
                    raise FusedUnsupportedError(
                        f"fused trainer does not support tied weights "
                        f"({f.name}.{k} shares {seen[id(p)]})")
                seen[id(p)] = f"{f.name}.{k}"
        ev = getattr(workflow, "evaluator", None)
        #: the loss head: softmax-CE for a softmax evaluator, else the
        #: half sum of squares against the loader's targets
        self.loss_kind = ("mse" if ev is not None
                          and not isinstance(ev, EvaluatorSoftmax)
                          else "softmax")
        self.compute_confusion = (bool(ev.compute_confusion)
                                  if getattr(ev, "confusion_explicit", False)
                                  else True)
        self._decode_params = (float(getattr(workflow, "scale", 1.0)),
                               float(getattr(workflow, "shift", 0.0)))
        self.mask_fn: MaskFn = mask_fn or self.default_mask
        self.offset_fn: OffsetFn = offset_fn or self.default_offsets
        self.lr_adjust = getattr(workflow, "lr_adjust", None)
        self.steps_done = 0
        #: ``img_per_sec`` counts every step; ``warm_*`` leave out the
        #: first call of each kind (train, tail, eval), which pays the
        #: kernel builds and cuDNN's algorithm search
        self.stats = {"train_steps": 0, "eval_steps": 0, "images": 0,
                      "wall_s": 0.0, "img_per_sec": 0.0, "warm_images": 0, "warm_wall_s": 0.0,
                      "warm_img_per_sec": 0.0}
        self._seen_kinds = set()
        self.compute_dtype = compute_dtype()
        self.master_dtype = master_dtype()
        state_dtype()                       # a bad spelling raises here
        check_engine_knobs()

    @property
    def train_losses(self):
        """Losses of every TRAIN minibatch fed to the Decision, in order."""
        return self.decision.train_losses

    # -- state -----------------------------------------------------------------

    def _weighted(self):
        return [f for f in self.forwards if f.has_weights]

    @staticmethod
    def _params_of(f) -> Dict[str, torch.Tensor]:
        return params_of(f)

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
        """Zero momentum (in :func:`state_dtype`) for every parameter that
        has none yet, gradients on for every parameter, and the
        parameters stored in ``master_dtype`` when it is set."""
        for f in self._weighted():
            gd = self.gd_of.get(f.name)
            if gd is None:
                raise ValueError(f"{f.name} has no gradient-descent "
                                 f"hyperparameters")
            for k, p in self._params_of(f).items():
                if self.master_dtype is not None \
                        and p.dtype != self.master_dtype:
                    p = nn.Parameter(p.detach().to(self.master_dtype))
                    setattr(f, k, p)
                p.requires_grad_(True)
                if k not in gd.velocities:
                    gd.velocities[k] = torch.zeros_like(p.detach(),
                                                        dtype=state_dtype())

    def _cast(self, t):
        """A float32 tensor cast to the compute dtype; others as they
        are."""
        return t.to(self.compute_dtype) if t.dtype == torch.float32 else t

    @contextlib.contextmanager
    def _compute_params(self):
        """Within it, each parameter stored in another dtype than the
        compute dtype reads as its cast to it (the reference's
        ``cparams``; under float32 compute, bf16-stored parameters widen as
        jax promotes them), autograd reaching the stored one through the
        cast."""
        swapped = []
        try:
            for f in self._weighted():
                for k, p in self._params_of(f).items():
                    if p.dtype != self.compute_dtype:
                        f._parameters[k] = p.to(self.compute_dtype)
                        swapped.append((f, k, p))
            yield
        finally:
            for f, k, p in swapped:
                f._parameters[k] = p

    # -- the forward -----------------------------------------------------------

    def default_mask(self, step: int, index: int, shape, ratio: float):
        gen = prng.get("fused_trainer").torch_generator(step, index,
                                                        self.device)
        return DropoutForward.make_mask(gen, shape, ratio)

    def default_offsets(self, step: int, index: int, probs):
        gen = prng.get("fused_trainer").torch_generator(step, index,
                                                        self.device)
        return StochasticPoolingBase.sample_offsets(probs, gen)

    def _decode(self, data):
        """uint8 data decodes to ``u8 * scale + shift`` on the device; any
        other dtype passes through."""
        if data.dtype == torch.uint8:
            scale, shift = self._decode_params
            data = data.to(torch.float32) * scale + shift
        return data

    def forward_pass(self, x, train: bool = False, step: int = 0,
                     cast: Optional[Callable] = None):
        """The last module's output (LOGITS for a softmax head) for an
        NHWC batch ``x``; ``train`` applies the dropout masks of train
        step ``step``; ``cast`` re-casts the activation entering every
        module (mixed precision)."""
        plan = plan_fused_blocks(self.forwards)
        tail_plan = plan_fused_tail(self.forwards, plan)
        h = x
        last = self.forwards[-1]
        i = 0
        while i < len(self.forwards):
            f = self.forwards[i]
            if cast is not None:
                h = cast(h)
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
            elif isinstance(f, StochasticPoolingBase) and train:
                with torch.no_grad():
                    probs = f.probabilities(f.windows(h, f.PAD_VALUE))
                off = self.offset_fn(step, i, probs)
                h = f.select_sampled(h, off.to(h.device))
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
        ``batch_size`` rows are valid.  A softmax head's loss is the mean
        softmax-CE of those rows, through the fused head under
        ``fused_tail``; an MSE head's is ``0.5 * sum((y - t)^2) / rows``
        over them, with n_err 0 and a (1, 1) confusion.  The forward runs
        in the compute dtype, the loss in float32."""
        cast = None if self.compute_dtype == torch.float32 else self._cast
        with self._compute_params():
            if cast is not None:
                data = cast(data)
            out = self.forward_pass(data, train, step, cast).float()
        n = out.shape[0]
        valid = torch.arange(n, device=out.device) < batch_size
        denom = max(int(batch_size), 1)
        if self.loss_kind == "mse":
            diff = (out.reshape(n, -1) - target.reshape(n, -1)) \
                * valid[:, None]
            loss = 0.5 * torch.sum(torch.square(diff)) / denom
            return loss, (loss.detach(),
                          torch.zeros((), dtype=torch.int64,
                                      device=out.device),
                          torch.zeros((1, 1), dtype=torch.int32,
                                      device=out.device))
        logits = out
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
        """(decoded data rows, target rows) of the index row ``idx``: the
        labels for a softmax head, the loader's targets for an MSE one."""
        data, target = self.loader.gather(idx)
        if self.loss_kind == "mse":
            target = self.loader.gather_targets(idx, data)
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
                # float32 arithmetic; a bf16-stored parameter is widened,
                # updated and rounded back by the copy
                w = p if self.master_dtype is None else p.float()
                p.copy_(self.gd_of[name].update(k, w, g.float()))
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
        if hasattr(d, "minibatch_n_err"):   # not DecisionMSE's
            d.minibatch_n_err = int(n_err)
            d.confusion_matrix = conf
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

    def _advance_lr(self) -> None:
        if self.lr_adjust is not None:
            self.lr_adjust.run()

    def _epoch_end(self) -> None:
        """The workflow's snapshotter, unless it is gated off."""
        snap = getattr(self.workflow, "snapshotter", None)
        if snap is not None and not bool(snap.gate_skip):
            snap.epoch_number = self.decision.epoch_number
            snap.improved = self.decision.improved
            snap.run()

    def run(self) -> None:
        """Train until the Decision completes.  Every step reads its
        metrics back to the host, which synchronises with the device, so
        the stats' wall times are device-inclusive."""
        if self.loader is None:
            raise ValueError("the workflow has no loader to train from")
        self._init_velocities()
        indices_only, self.loader.indices_only = self.loader.indices_only, True
        try:
            self._run()
        finally:
            self.loader.indices_only = indices_only

    def _run(self) -> None:
        decision = self.decision
        while not decision.complete:
            mb = self._advance()
            t0 = time.perf_counter()
            if mb["class"] == TRAIN and not mb["last_minibatch"]:
                metrics = self.train_step(mb["idx"], mb["size"],
                                          self.steps_done)
                self._advance_lr()
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
                    self._advance_lr()
                self.steps_done += 1
                self._account("tail", mb["size"], t0)
            else:
                metrics = self.eval_step(mb["idx"], mb["size"])
                self._feed_decision(mb, metrics)
                self._account("eval", 0, t0)
            if bool(decision.epoch_ended):
                self._epoch_end()
