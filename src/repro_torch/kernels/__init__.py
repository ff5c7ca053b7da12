# Hand-written CUDA kernels for Hopper (csrc/, built by _build.py and bound
# with ctypes in fused_score.py, local_train.py, fused_agg.py, robust_agg.py,
# quant8.py, topk_ef.py and swa_attention.py) + plain PyTorch twins in ref.py.
