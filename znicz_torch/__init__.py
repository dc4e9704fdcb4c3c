"""znicz_torch: the PyTorch/CUDA port of znicz_tpu.

The package stands beside ``znicz_tpu`` (the JAX reference) and imports
nothing from it and nothing of JAX.  It keeps the reference's module
names, unit names (``fwd_{kind}_{i}``), NHWC activations and weight
layouts, so each module here has an obvious counterpart there.

It serves and trains: ``samples.alexnet.AlexNetWorkflow`` builds the
model, ``serving.model.ModelRunner`` freezes it on the device and
``serving.frontend.InferenceServer`` batches requests into it;
``python -m znicz_torch {alexnet,mnist,cifar}`` trains a sample through
``engine.train``: on the unit-at-a-time graph (``core.workflow``, the
reference's default, which MNIST and CIFAR10 take) or with
``parallel.fused.FusedTrainer`` (``--fused``, AlexNet's default).  The
conv-block, bias+ReLU and LRN
stages run through kernels written for Hopper (``csrc/``), each with a
plain PyTorch twin used on CPU tensors.

Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``; without a GPU and without that argument they raise.
"""
