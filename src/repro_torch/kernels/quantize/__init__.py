from repro_torch.kernels.quantize.ops import dequantize, quantize
