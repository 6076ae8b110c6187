"""Part of granne_tpu_torch; see the package docstring."""
