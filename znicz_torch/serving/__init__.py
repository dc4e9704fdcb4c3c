"""Inference serving of the port: ``InferenceServer`` (frontend) ->
``DynamicBatcher`` (batcher) -> ``ModelRunner`` (model)."""
