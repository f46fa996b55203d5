"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

It imports ``torch`` and numpy, never ``jax`` or ``repro``. It holds both
MapReduce engines of the search+stats path, wordcount and the codecs
(``mapreduce``), the LM serving path of the dense TinyLlama (``configs``,
``models``, ``serving``, ``launch``), and the hand-written CUDA kernels
they run (``kernels``: pair counts and histograms, the block quantizer,
flash attention)."""

__version__ = "0.1.0"
