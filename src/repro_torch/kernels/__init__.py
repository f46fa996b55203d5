"""Hand-written Hopper kernels for the hot spots the paper's workloads expose:

- ``zones_pairs/``  pair search, masked batched (device engine) and
  unmasked batched (host engine): the astronomy apps' reducers;
- ``quantize/``     block-wise int8 quantize / dequantize: the int8 codec;
- ``flash_attention/`` causal GQA flash-attention forward: the LM's
  full-sequence self attention (prefill, forward).

Each has ``kernel.py`` (ctypes binding of ``csrc/*.cu``, built by
``_build.py``), ``ops.py`` (dispatch on the tensor's device) and ``ref.py``
(plain PyTorch versions). The flash forward and the two quantizers are
``torch.library`` custom ops (``repro_torch::flash_attention_fwd``,
``repro_torch::block_quantize``, ``repro_torch::block_dequantize``): the
CUDA implementation launches the kernel, the fake one gives the outputs'
shapes and dtypes, so a ``TorchDispatchMode`` (``core/op_census.py``)
sees each launch as one operator. ``on_card`` is the dispatch's test:
a CUDA tensor, or under ``card_routing()`` (the dry run) a ``meta`` one,
which then takes the path the card takes and reaches the fake
implementation. ``LAUNCHES`` counts, per kernel, the launches its
wrapper made (``count_launch``, under a lock: the streaming executor's
lanes launch from several threads at once); ``VARIANT_LAUNCHES`` splits a
wrapper's count by the kernel it chose (the flash forward's f32
``flash_fwd_kernel`` and bf16 ``flash_tc_kernel``); ``reset_launch_counts``
sets every count to 0.
"""
import contextlib
import threading

LAUNCHES = {"pair_count_masked": 0, "pair_hist_masked": 0,
            "pair_count": 0, "pair_hist": 0,
            "quantize": 0, "dequantize": 0, "flash_attention": 0}
VARIANT_LAUNCHES = {"flash_attention_f32": 0, "flash_attention_bf16": 0}


_LAUNCHES_LOCK = threading.Lock()


def count_launch(name: str, variant: str | None = None) -> None:
    """Add one to ``LAUNCHES[name]`` (and to ``VARIANT_LAUNCHES[variant]``).
    A bare ``+= 1`` is a read-modify-write that two threads can interleave,
    losing a count."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1
        if variant is not None:
            VARIANT_LAUNCHES[variant] += 1


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for counts in (LAUNCHES, VARIANT_LAUNCHES):
            for k in counts:
                counts[k] = 0


_CARD_ROUTING = [False]


@contextlib.contextmanager
def card_routing():
    """Within the block a tensor on the ``meta`` device is dispatched as a
    CUDA one (``on_card``): to the kernels' custom ops, whose fake
    implementations give the outputs' shapes, and so down the path the
    card runs. Process-wide (the autograd engine's threads see it too)."""
    prev = _CARD_ROUTING[0]
    _CARD_ROUTING[0] = True
    try:
        yield
    finally:
        _CARD_ROUTING[0] = prev


def on_card(t) -> bool:
    """Whether the dispatch sends ``t`` down the card's path: a CUDA
    tensor, or a ``meta`` one under ``card_routing()``."""
    return t.is_cuda or (t.is_meta and _CARD_ROUTING[0])
