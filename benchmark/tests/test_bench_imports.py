"""Nothing a run loads is JAX or the JAX package; the reference imports
nothing of the port.  Names compare by their whole top-level part."""

import subprocess
import sys

import pytest

from benchmark.harness import imports
from benchmark.tests.helpers import ROOT


@pytest.mark.parametrize("modules, found", [
    (["srslte_tpu_torch", "srslte_tpu_torch.phy.phch.pdsch", "numpy", "torch"], []),
    (["srslte_tpu", "srslte_tpu_torch"], ["srslte_tpu"]),
    (["srslte_tpu.phy.fec"], ["srslte_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "srslte_tpu_x"], []),
])
def test_forbidden_by_whole_top_level_name(modules, found):
    assert imports.forbidden_loaded(modules) == found


def test_reference_sources_import_neither_jax_nor_the_port():
    assert imports.reference_violations(ROOT / "benchmark" / "reference") == {}


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_the_reference_loads_no_module_of_the_port():
    loaded = _modules_after("import benchmark.reference.stimulus\n"
                            "import benchmark.reference.lte.phy.ue.ue_dl\n"
                            "import benchmark.reference.lte.phy.enb.enb_dl\n"
                            "import benchmark.reference.lte.phy.phch.pdsch")
    assert not loaded & (imports.FORBIDDEN | {"srslte_tpu_torch"})


def test_a_run_loads_no_jax():
    loaded = _modules_after("from benchmark.harness import cells, deploy, runner\n"
                            "cells.find('dl1x1.b128.snr25'); cells.find('tm4.b128.snr28')\n"
                            "deploy.build(cells.find('tm4.b128.snr28').config, deploy.PROGRAM, 'cpu')")
    assert "srslte_tpu_torch" in loaded
    assert not loaded & imports.FORBIDDEN


def _plant_at_start(monkeypatch, cell):
    monkeypatch.setitem(sys.modules, "srslte_tpu", type(sys)("srslte_tpu"))


def _plant_in_the_check(monkeypatch, cell):
    """The comparison with the reference loads JAX, after the window."""
    compare = cell.path.compare

    def loads_jax(*args):
        monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
        return compare(*args)

    monkeypatch.setattr(cell.path, "compare", loads_jax)


@pytest.mark.parametrize("plant, name", [(_plant_at_start, "srslte_tpu"),
                                         (_plant_in_the_check, "jax")])
def test_a_forbidden_module_stops_the_run(monkeypatch, plant, name):
    from benchmark.harness import runner
    from benchmark.tests.helpers import rehearsal_cell

    cell = rehearsal_cell("dl_1port")
    plant(monkeypatch, cell)
    with pytest.raises(runner.ForbiddenModules, match=name):
        runner.run(cell, 1, 0.1, device="cpu")
