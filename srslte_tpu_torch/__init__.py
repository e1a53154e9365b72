"""srslte_tpu_torch: the LTE baseband framework in PyTorch with CUDA kernels.

The package mirrors the directory layout and public names of the JAX package
``srslte_tpu`` (``phy/fec/tdec.py``, ``phy/phch/pdsch.py``, ...), so that the
counterpart of a module is found by its path.  It imports ``torch`` and
``numpy`` only.  Tensors live on the CUDA device unless the caller passes
``device="cpu"``; see ``_device.py``.
"""
