"""The LM stack on PyTorch: ``params`` (schemas and ``ParamModule``),
``common`` (norms, rope, activations), ``attention`` (GQA, flash on the
card), ``ffn``, ``transformer`` (layers and the stack), ``model`` (``LM``,
``forward``, ``prefill``, ``decode_step``) and ``convert`` (the JAX
package's parameter and cache trees, as numpy, into the port's)."""
