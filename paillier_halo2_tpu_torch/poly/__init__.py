"""Poly layer of the PyTorch port (counterpart of
`paillier_halo2_tpu/poly/__init__.py:1`)."""
