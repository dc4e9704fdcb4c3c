"""charlm (port of ``znicz_tpu/samples/charlm.py``): a small character
language model built from the sequence modules — CharEmbedding -> causal
MultiHeadAttention with residual -> position-wise SeqAll2AllStrictRELU
FFN -> SeqAll2AllSoftmax head — trained on next-character softmax-CE per
token, with the ``root.charlm`` defaults of the reference entry for
entry:

    start -> repeater -> loader -> embed -> mha -> ffn -> head
          -> evaluator (per token) -> decision -> snapshotter
          -> gd_head -> gd_ffn -> gd_mha -> gd_embed -> repeater

The units carry the reference's names, so the weights draw from the same
named streams and parameter trees, snapshots and the master/slave star's
deltas carry over by name.  Both engines train it: the unit graph
(``EvaluatorSeqSoftmax``) and, with ``root.common.engine.fused``, the
fused trainer, whose ``fused_tail`` runs the FFN through the seq
epilogue and the loss through the fused softmax-CE head.  Served
(``--serve``), requests of any length up to the trained ``seq_len``
ride the 2-D (rows x seq) bucket ladder: the workflow declares its
window as ``serving_seq_len``.

Data: a seeded synthetic corpus, bit for bit the reference's stream:
lines of a cyclic alphabet walk whose stride is set by each line's
first character, so predicting the next character needs context several
positions back.  Id 0 (``PAD_ID``) is never emitted: it is the serving
plane's pad; characters are 1..vocab-1, stored as uint8 and decoded on
the device (scale 1, shift 0).
"""

from __future__ import annotations

import numpy as np

from znicz_torch.attention import (CharEmbedding, GDCharEmbedding,
                                   GDMultiHeadAttention, GDSeqAll2All,
                                   GDSeqSoftmax, MultiHeadAttention,
                                   SeqAll2AllSoftmax, SeqAll2AllStrictRELU)
from znicz_torch.backends import DeviceLike, resolve_device
from znicz_torch.core.config import root
from znicz_torch.core.workflow import Repeater, Workflow
from znicz_torch.decision import DecisionGD
from znicz_torch.evaluator import EvaluatorSeqSoftmax
from znicz_torch.loader.fullbatch import FullBatchLoader
from znicz_torch.nn_units import ForwardBase
from znicz_torch.samples import restore_snapshot, train
from znicz_torch.snapshotter import Snapshotter

#: the serving plane's padding id, never emitted by the corpus
PAD_ID = 0

root.charlm.defaults({
    "loader": {"minibatch_size": 32, "n_train": 384, "n_valid": 96,
               "n_test": 0, "seq_len": 64},
    "model": {"vocab": 32, "embed": 32, "heads": 2, "ffn": 64},
    "learning_rate": 0.5,
    "gradient_moment": 0.9,
    "weights_decay": 0.0,
    "decision": {"max_epochs": 8, "fail_iterations": 0},
    "snapshotter": {"prefix": "charlm", "interval": 0},
})


def make_corpus(n_chars: int, vocab: int, seed: int = 1013) -> np.ndarray:
    """``n_chars + 1`` uint8 ids in 1..vocab-1: lines of 16 characters of
    a cyclic alphabet walk, each line's stride (1..3) and start drawn
    from a numpy generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    span = vocab - 1                      # usable alphabet (0 = PAD)
    out = np.empty(n_chars + 1, np.uint8)
    i = 0
    while i < len(out):
        stride = int(rng.integers(1, 4))
        start = int(rng.integers(0, span))
        line = (start + stride * np.arange(16)) % span + 1
        take = min(len(line), len(out) - i)
        out[i:i + take] = line[:take]
        i += take
    return out


class CharLMLoader(FullBatchLoader):
    """Sliding windows over the corpus: sample ``i`` is ids ``[i, i +
    T)`` (uint8), its labels the next characters ``[i + 1, i + T]``, one
    label a token; classes in the order TEST, VALID, TRAIN."""

    def load_data(self):
        cfg = root.charlm.loader
        n_train = int(cfg.get("n_train", 384))
        n_valid = int(cfg.get("n_valid", 96))
        n_test = int(cfg.get("n_test", 0))
        seq_len = int(cfg.get("seq_len", 64))
        vocab = int(root.charlm.model.get("vocab", 32))
        total = n_train + n_valid + n_test
        stream = make_corpus(total + seq_len, vocab)
        idx = np.arange(total)[:, None] + np.arange(seq_len)[None]
        self.original_data = stream[idx].astype(np.uint8)
        self.original_labels = stream[idx + 1].astype(np.uint8)
        self.class_lengths = [n_test, n_valid, n_train]
        super().load_data()


class CharLMWorkflow(Workflow):
    """The model of ``root.charlm`` with its loader on ``device``."""

    def __init__(self, device: DeviceLike = None):
        super().__init__(name="CharLMWorkflow")
        self.device = dev = resolve_device(device)
        cfg = root.charlm
        seq_len = int(cfg.loader.get("seq_len", 64))
        vocab = int(cfg.model.get("vocab", 32))
        embed = int(cfg.model.get("embed", 32))
        heads = int(cfg.model.get("heads", 2))
        ffn = int(cfg.model.get("ffn", 64))
        gd_kw = {"learning_rate": float(cfg.get("learning_rate")),
                 "gradient_moment": float(cfg.get("gradient_moment")),
                 "weights_decay": float(cfg.get("weights_decay"))}
        #: the serving window: the 2-D ladder's default max_len (an
        #: attribute, so a fixed-shape service built later in the same
        #: process does not inherit a seq axis)
        self.serving_seq_len = seq_len
        #: requests are uint8 ids, decoded as u8 * 1 + 0
        self.dtype = np.dtype(np.uint8)
        self.scale, self.shift = 1.0, 0.0

        self.repeater = Repeater(self, name="repeater")
        self.repeater.link_from(self.start_point)
        self.loader = CharLMLoader(
            self, name="loader",
            minibatch_size=int(cfg.loader.get("minibatch_size")))
        self.loader.link_from(self.repeater)
        self.loader.initialize(device=dev)
        self.sample_shape = self.loader.sample_shape

        specs = [
            CharEmbedding(name="embed", vocab=vocab, embed=embed,
                          max_len=seq_len),
            MultiHeadAttention(name="mha", heads=heads, causal=True,
                               residual=True),
            SeqAll2AllStrictRELU(name="ffn", output_sample_shape=(ffn,)),
            SeqAll2AllSoftmax(name="head", output_sample_shape=(vocab,)),
        ]
        self.forwards = []
        self.forward_units = []
        shape = (1,) + self.sample_shape
        prev, prev_attr = self.loader, "minibatch_data"
        for mod in specs:
            shape = mod.build(shape, dev)
            unit = ForwardBase(self, module=mod)
            unit.link_from(prev)
            unit.link_attrs(prev, ("input", prev_attr))
            self.forwards.append(mod)
            self.forward_units.append(unit)
            prev, prev_attr = unit, "output"
        self.output_sample_shape = tuple(shape[1:])

        self.evaluator = EvaluatorSeqSoftmax(self, name="evaluator",
                                             n_classes=vocab)
        self.evaluator.link_from(prev)
        self.evaluator.link_attrs(prev, "output")
        self.evaluator.link_attrs(self.loader,
                                  ("labels", "minibatch_labels"),
                                  ("batch_size", "minibatch_size"))

        self.decision = DecisionGD(
            self, name="decision",
            max_epochs=int(cfg.decision.get("max_epochs")),
            fail_iterations=int(cfg.decision.get("fail_iterations")))
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "last_minibatch", "class_ended",
            "epoch_number", "class_lengths", "minibatch_size")
        self.decision.link_attrs(
            self.evaluator, ("minibatch_loss", "loss"),
            ("minibatch_n_err", "n_err"), "confusion_matrix",
            "max_err_output_sum")

        self.snapshotter = Snapshotter(
            self, name="snapshotter",
            prefix=cfg.snapshotter.get("prefix"),
            interval=int(cfg.snapshotter.get("interval", 0)))
        self.snapshotter.link_from(self.decision)
        self.snapshotter.link_attrs(self.decision, "epoch_number")
        self.snapshotter.improved = self.decision.improved
        self.snapshotter.gate_skip = ~self.decision.epoch_ended

        # the backward chain, last layer first
        gd_specs = [("gd_head", GDSeqSoftmax, 3, True),
                    ("gd_ffn", GDSeqAll2All, 2, True),
                    ("gd_mha", GDMultiHeadAttention, 1, True),
                    ("gd_embed", GDCharEmbedding, 0, False)]
        self.gd_units = []
        err_src, err_attr, tail = self.evaluator, "err_output", \
            self.snapshotter
        for name, cls, i, need_err in gd_specs:
            gd = cls(self, name=name, forward=self.forward_units[i],
                     need_err_input=need_err, **gd_kw)
            gd.link_from(tail)
            gd.link_attrs(err_src, ("err_output", err_attr))
            gd.gate_skip = self.decision.gd_skip
            self.gd_units.append(gd)
            err_src, err_attr, tail = gd, "err_input", gd
        self.gds = {gd.forward.name: gd for gd in self.gd_units}

        self.repeater.link_from(tail)
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete


def run(device: DeviceLike = None, snapshot: str = "") -> CharLMWorkflow:
    """Build :class:`CharLMWorkflow` on ``device``, resume it from
    ``snapshot`` if one is named, and train it with ``engine.train``
    (the unit graph unless ``root.common.engine.fused``) until the
    Decision completes."""
    wf = CharLMWorkflow(device)
    if snapshot:
        restore_snapshot(wf, snapshot)
    return train(wf, "charlm")
