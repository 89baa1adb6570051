"""repro_torch — the LCMP reproduction ported to PyTorch and CUDA.

It mirrors the layout of the JAX package ``repro`` module for module
(``repro_torch/netsim/engine.py`` is the counterpart of
``repro/netsim/engine.py``) and imports neither JAX nor ``repro``.
Entry points run on the GPU unless the caller passes ``device="cpu"``
(see ``repro_torch.device``). The per-step Pallas kernels of the JAX
package are hand-written CUDA kernels here (``repro_torch.kernels``).
"""
