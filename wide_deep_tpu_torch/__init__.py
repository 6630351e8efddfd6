"""wide_deep_tpu_torch: the Wide & Deep system in PyTorch for one NVIDIA
H100, beside the JAX package ``wide_deep_tpu`` it is held against.

Entry points: ``training.loop.Trainer`` (single-device training),
``models.joint.build_model``, and the hand-written CUDA kernels behind
``ops.scatter`` (K1 range / K2 window scatter-add), ``ops.rowdma`` (K3
row write-back, P2 bulk row scatter) and ``ops.gather`` (P1 resident
gather), built from ``csrc/`` at first use; the probe tools in ``tools/``
(``python -m wide_deep_tpu_torch.tools.<name>``).  ``chip_smoke.py`` at
the repo root drives them on the card.
"""
