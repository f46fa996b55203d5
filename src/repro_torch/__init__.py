"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

It imports ``torch`` and numpy, never ``jax`` or ``repro``. This slice holds
the device engine's search+stats path (``mapreduce``) and its two masked
pair kernels, hand-written in CUDA C++ (``kernels/zones_pairs``)."""

__version__ = "0.1.0"
