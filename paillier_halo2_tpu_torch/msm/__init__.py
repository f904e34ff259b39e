"""Msm layer of the PyTorch port (counterpart of
`paillier_halo2_tpu/msm/__init__.py:1`)."""
