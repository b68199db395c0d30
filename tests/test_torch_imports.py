"""The port stands alone: ``risingwave_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the ``risingwave_tpu`` package.

Note that ``"risingwave_tpu_torch".startswith("risingwave_tpu")``: the
checks match the module name ``risingwave_tpu`` and the prefix
``risingwave_tpu.``, never a bare prefix.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "risingwave_tpu_torch"

_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(jax|jaxlib|risingwave_tpu)(?:\.|\s|$)",
    re.MULTILINE)


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import risingwave_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'risingwave_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'risingwave_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'risingwave_tpu.'))]\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n"
        "assert len(mods) > 20\n"
        "new = {'risingwave_tpu_torch.state.tag_table', "
        "'risingwave_tpu_torch.stream.hash_join', "
        "'risingwave_tpu_torch.stream.dag', "
        "'risingwave_tpu_torch.common.tree', "
        "'risingwave_tpu_torch.common.faults', "
        "'risingwave_tpu_torch.common.trace', "
        "'risingwave_tpu_torch.storage.digest', "
        "'risingwave_tpu_torch.storage.integrity', "
        "'risingwave_tpu_torch.storage.checkpoint_store', "
        "'risingwave_tpu_torch.storage.hummock.object_store', "
        "'risingwave_tpu_torch.stream.shadow', "
        "'risingwave_tpu_torch.stream.checkpoint', "
        "'risingwave_tpu_torch.meta.store', "
        "'risingwave_tpu_torch.stream.top_n', "
        "'risingwave_tpu_torch.stream.over_window', "
        "'risingwave_tpu_torch.connector.datagen', "
        "'risingwave_tpu_torch.stream.spill', "
        "'risingwave_tpu_torch.connector.dml', "
        "'risingwave_tpu_torch.stream.temporal_join', "
        "'risingwave_tpu_torch.slt', "
        "'risingwave_tpu_torch.stream.sink', "
        "'risingwave_tpu_torch.connector.sinks', "
        "'risingwave_tpu_torch.cluster.scale.vnode', "
        "'risingwave_tpu_torch.cluster.scale.gate', "
        "'risingwave_tpu_torch.cluster.scale.handover', "
        "'risingwave_tpu_torch.cluster.scale.driver', "
        "'risingwave_tpu_torch.stream.troublemaker'}\n"
        "assert new <= set(mods), new - set(mods)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_imports_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _IMPORT.finditer(f.read_text())]
    assert offenders == []


def test_import_pattern_is_not_fooled_by_the_port_name():
    assert _IMPORT.search("from risingwave_tpu_torch.sql import Engine") \
        is None
    assert _IMPORT.search("from risingwave_tpu.sql import Engine")
    assert _IMPORT.search("import jax.numpy as jnp")
