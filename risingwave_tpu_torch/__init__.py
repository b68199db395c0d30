"""risingwave_tpu_torch — the PyTorch + CUDA port of ``risingwave_tpu``.

A second package beside the JAX reference, layer for layer: ``common``
(types, chunks, hashing), ``connector`` (the Nexmark generator),
``expr``, ``state`` (the device hash table), ``stream`` (executors,
fragment, runtime), ``meta`` and ``sql`` (parser, binder, planner,
engine).  The hot loops are hand-written CUDA kernels for Hopper
(``csrc/``, built and loaded by ``kernels``); each has its plain
PyTorch version beside its wrapper, used for CPU tensors.

The port imports neither JAX nor anything of ``risingwave_tpu``; it
keeps its own copies of the reference's JAX-free modules.
"""

__version__ = "0.1.0"
