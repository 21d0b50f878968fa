"""Device kernels and their plain PyTorch versions (counterpart of
``nbodykit_tpu/ops``)."""
