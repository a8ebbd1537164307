"""Plain PyTorch references of the benchmarked models, sampler and train step.

Nothing here imports the port, JAX or the JAX package: every layer is written
again from the published description, in float32 unless a `Precision` asks
for rounded operands (the controls). The references read weights as a dict
of tensors keyed by the parameter names of the port's state_dict, which is
the layout the benchmark makes them in.
"""
