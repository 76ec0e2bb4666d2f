"""SEAFL in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package ``repro`` that keeps its module layout
(``repro/core/server.py`` <-> ``repro_torch/core/server.py``) and its flat
``(P,)`` f32 parameter layout, so a flat vector, a buffer row or a wire chunk
means the same model in both packages.  The fused aggregation and the LM
serving path's flash attention, RG-LRU scan and SSD forward run in
hand-written CUDA kernels (``kernels/*/csrc``); everything else is plain
PyTorch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises (see :mod:`repro_torch.device`).
"""
