"""PyTorch/CUDA port of the ``repro`` model zoo, serving path and verifier
(``repro_torch.verify``: the tp-forward scenario so far).

Plain functions on tensors over dict parameters, in the parameter layout of
the JAX package (``(d_in, d_out)`` weights applied as ``x @ w``, blocks
stacked by block period).  Every Pallas TPU kernel on a ported path is a
hand-written Hopper kernel under ``repro_torch.kernels``.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""
