"""Plonk layer of the PyTorch port (counterpart of
`paillier_halo2_tpu/plonk/__init__.py:1`)."""
