# Hand-written CUDA kernels for Hopper (csrc/, built by _build.py and bound
# with ctypes in fused_score.py) + plain PyTorch twins in ref.py.
