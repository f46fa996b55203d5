# Hand-written Hopper kernels for the hot spots the paper's workloads expose:
#   zones_pairs/  masked batched pair search (the astronomy apps' reducer)
# Each has kernel.py (build + ctypes binding of csrc/*.cu), ops.py (dispatch
# on the tensor's device) and ref.py (plain PyTorch versions).
