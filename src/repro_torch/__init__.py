"""repro_torch: the PyTorch / CUDA (Hopper) port of the JAX package ``repro``.

Imports ``torch``, never ``jax``, and nothing of ``repro``.  Every entry
point takes an explicit ``device`` that defaults to ``"cuda"``; the CPU is
used only when a caller passes ``device="cpu"``.
"""
