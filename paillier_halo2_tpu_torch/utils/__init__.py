"""Utils layer of the PyTorch port (counterpart of
`paillier_halo2_tpu/utils/__init__.py:1`)."""
