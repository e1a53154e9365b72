"""The plain reference of the benchmark and its stimulus encoder.

`lte/` is a frozen copy of the port's plain transmit and receive code with
the two kernels' plain versions; `stimulus.py` encodes the benchmark's own
inputs with it.  Nothing under this folder imports the port (the package
`srslte_tpu_torch`), JAX or the JAX package `srslte_tpu`.
"""
