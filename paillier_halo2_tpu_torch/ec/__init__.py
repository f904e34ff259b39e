"""Ec layer of the PyTorch port (counterpart of
`paillier_halo2_tpu/ec/__init__.py:1`)."""
