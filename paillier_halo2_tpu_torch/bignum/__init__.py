"""Bignum layer of the PyTorch port (counterpart of
`paillier_halo2_tpu/bignum/__init__.py:1`)."""
