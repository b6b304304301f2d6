"""Part of the PyTorch port of pathway_tpu; see the package docstring."""
