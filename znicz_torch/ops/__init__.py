"""Tensor ops of the port: activations, the dense op and LRN."""
