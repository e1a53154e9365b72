# Frozen copy of srslte_tpu_torch/phy/__init__.py at commit e4337f4, unchanged but for this line.
