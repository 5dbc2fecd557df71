"""PyTorch/CUDA port of the DV-Pari engine (first slice: the bit-sliced
tau-NAF MSM and the fixed-base SRS fan-out).

Mirrors the layout of `dvpari_tpu/` so each module's counterpart is easy
to find.  Imports torch and numpy only -- never jax, never dvpari_tpu.
Entry points take `device="cuda"` and raise when CUDA is missing; pass
`device="cpu"` to run the plain PyTorch versions.
"""
