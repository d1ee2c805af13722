"""Runnable examples of the port, ``python -m repro_torch.examples.<name>``:
``quickstart`` (verify a TP pair, then catch an injected bug),
``serve_batched`` (the serving engine), ``train_e2e`` (train with the verify
gate, checkpoints and resume) and ``verify_model_zoo`` (every arch at TP 16
through one warm ``Session``)."""
