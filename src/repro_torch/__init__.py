"""repro_torch: the PyTorch + CUDA (Hopper) port of ``repro``.

Mirrors ``repro``'s layout module for module.  Serving is ported first:
``repro_torch.serving`` scores telemetry with the paper autoencoder
through two hand-written CUDA kernels (``kernels/csrc/fused_score.cu``).
Entry points run on the CUDA card unless the caller passes
``device="cpu"``, which selects the plain PyTorch versions.
"""
__version__ = "0.1.0"
