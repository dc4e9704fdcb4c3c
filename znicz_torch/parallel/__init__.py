"""The fused forward pass (the eval half of the reference's trainer)."""
