"""Hand-written Hopper kernels for the hot spots the paper's workloads expose:

- ``zones_pairs/``  pair search, masked batched (device engine) and
  unmasked batched (host engine): the astronomy apps' reducers;
- ``quantize/``     block-wise int8 quantize / dequantize: the int8 codec;
- ``flash_attention/`` causal GQA flash-attention forward: the LM's
  full-sequence self attention (prefill, forward).

Each has ``kernel.py`` (ctypes binding of ``csrc/*.cu``, built by
``_build.py``), ``ops.py`` (dispatch on the tensor's device) and ``ref.py``
(plain PyTorch versions). ``LAUNCHES`` counts, per kernel, the launches its
wrapper made (``count_launch``, under a lock: the streaming executor's
lanes launch from several threads at once); ``reset_launch_counts`` sets
every count to 0.
"""
import threading

LAUNCHES = {"pair_count_masked": 0, "pair_hist_masked": 0,
            "pair_count": 0, "pair_hist": 0,
            "quantize": 0, "dequantize": 0, "flash_attention": 0}


_LAUNCHES_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]``. A bare ``+= 1`` is a read-modify-write
    that two threads can interleave, losing a count."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
