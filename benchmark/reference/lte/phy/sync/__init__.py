# Frozen copy of srslte_tpu_torch/phy/sync/__init__.py at commit e4337f4, unchanged but for this line.
