"""PyTorch + CUDA port of the JAX package for one NVIDIA H100.

Mirrors the JAX package's layout and module names: each module here sits at
the path of its JAX counterpart. It imports torch and never jax or flax; the
only bridge to the JAX package is ``utils/params.load_jax_params``, which
takes the flax parameter trees as nested dicts of numpy arrays.
"""
