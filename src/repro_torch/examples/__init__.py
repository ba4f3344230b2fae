"""Examples of the port, run as modules (``python -m
repro_torch.examples.<name>``): ``quickstart``, ``imaging_demo``,
``train_lm_100m``, ``train_lenet_qat`` and ``serve_quantized_lm``."""
