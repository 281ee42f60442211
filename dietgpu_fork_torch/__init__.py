"""dietgpu_fork_torch: the PyTorch + CUDA (Hopper) port of the JAX package
beside it.

Importing the package imports nothing else of it; the modules are imported
where they are used (``dietgpu_fork_torch.models.float_codec`` is the entry
point of the float codec).
"""
