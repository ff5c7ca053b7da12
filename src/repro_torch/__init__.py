"""repro_torch: the PyTorch + CUDA (Hopper) port of ``repro``.

Mirrors ``repro``'s layout module for module.  Ported so far: the
scoring service (``repro_torch.serving``, two CUDA score kernels in
``kernels/csrc/fused_score.cu``) and one hierarchical federated training
trial (``repro_torch.launch.experiment.trial_metrics`` -> ``core/hfl``,
with the local-train and compress-aggregate kernels in
``kernels/csrc/local_train.cu`` and ``fused_agg.cu``), its fault, robust,
chunked, per-client-compressor and drift options, and LM decode serving
(``repro_torch.launch.serve`` over ``models/{rglru,transformer}``, with
the sliding-window decode-attention kernel in
``kernels/csrc/swa_decode.cu``), and since then the flat baselines, the
batched ``Engine``, the async family, the client mesh, language-model
training (``repro_torch.launch.train``), the pod family
(``core/mesh_fl``) and the federated-LLM example
(``repro_torch.examples.federated_llm``).  Entry points run
on the CUDA card unless the caller passes ``device="cpu"``, which selects
the plain PyTorch versions.
"""
__version__ = "0.1.0"
