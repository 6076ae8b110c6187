"""Serving beyond one device's memory (port of ``granne_tpu/parallel``):
so far ``tiering.TieredIvf``, IVF blocks in host memory streamed to the card."""
