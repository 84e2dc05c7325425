"""FedOptima on PyTorch and CUDA: the port of the JAX package ``repro``.

Module paths mirror ``repro`` so that each module's counterpart is easy to
find.  This package imports torch and numpy, never JAX or ``repro``.
Entry points take an explicit ``device`` and default to ``"cuda"``.
"""
