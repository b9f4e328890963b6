"""The port's package surfaces against the reference's: every name a
reference ``__init__`` exports resolves on the port's package of the same
name to the port's own object, and every ``from phones_las_tpu… import …``
of the reference's own test files resolves on the port, through one table
of renames. Both are read from the reference's sources with ``ast``."""

import ast
import glob
import importlib
import os
import subprocess
import sys

import pytest

from tests.torch_threads import one_thread, subprocess_env

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "phones_las_tpu", "phones_las_torch"

# Modules the port names differently; None: no counterpart (XLA's compile cache).
MODULE_RENAMES = {
    "phones_las_tpu.frontend.pallas_frontend": "phones_las_torch.frontend.fused_frontend",
    "phones_las_tpu.decode.pallas_greedy": "phones_las_torch.decode.fused_greedy",
    "phones_las_tpu.utils.jax_cache": None,
}
# (reference module, name) → the port's name in the renamed module
NAME_RENAMES = {
    ("phones_las_tpu.frontend.pallas_frontend", "extract_features_pallas"): "extract_features_fused",
    ("phones_las_tpu.train.state", "make_optimizer"): "Optimizer",
}
# Recorded deviations (ROADMAP.md C, "No shard_batch / shard_batch_global
# (PR 10)"): both place a host batch as a global array sharded over 'data';
# a torch process holds no global array, and parallel/mesh.py::local_rows
# gives a rank its rows.
DEVIATIONS = {"shard_batch", "shard_batch_global"}


def _port_module(ref_module: str):
    if ref_module in MODULE_RENAMES:
        return MODULE_RENAMES[ref_module]
    return PORT + ref_module[len(REF):]


def _imports_from(path: str):
    """Every ``from phones_las_tpu… import name`` in ``path`` (module level
    or inside a function) → [(line, module, name)], and every bare
    ``import phones_las_tpu…`` as (line, module, None)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.split(".")[0] == REF:
            out += [(node.lineno, node.module, a.name) for a in node.names]
        elif isinstance(node, ast.Import):
            out += [(node.lineno, a.name, None) for a in node.names if a.name.split(".")[0] == REF]
    return sorted(out)


REF_INITS = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, REF, "**", "__init__.py"), recursive=True)
)
EXPORTING_INITS = [p for p in REF_INITS if _imports_from(os.path.join(REPO, p))]
REF_TEST_FILES = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "tests", "test_*.py"))
    if not os.path.basename(p).startswith("test_torch_")
    and _imports_from(p)
)


def test_the_tables_name_what_the_reference_and_the_port_hold():
    """Each rename's source exists in the reference and its target in the
    port; the deviations exist in the reference and not in the port."""
    for (mod, name), new in NAME_RENAMES.items():
        src = os.path.join(REPO, *mod.split(".")) + ".py"
        with open(src, encoding="utf-8") as f:
            defined = {n.name for n in ast.parse(f.read()).body if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        assert name in defined, (mod, name)
        assert hasattr(importlib.import_module(_port_module(mod)), new), (mod, new)
    for mod, new in MODULE_RENAMES.items():
        assert os.path.exists(os.path.join(REPO, *mod.split(".")) + ".py"), mod
        if new is not None:
            importlib.import_module(new)
    parallel = importlib.import_module(f"{PORT}.parallel")
    multihost = importlib.import_module(f"{PORT}.parallel.multihost")
    for name in DEVIATIONS:
        assert not hasattr(parallel, name) and not hasattr(multihost, name), name
    assert len(EXPORTING_INITS) == 9 and len(REF_TEST_FILES) >= 25


@pytest.mark.parametrize("init", EXPORTING_INITS)
def test_reference_exports_resolve_to_the_ports_own_objects(init):
    """Each name the reference ``__init__`` exports (its ``from … import``
    lines, and those its ``__getattr__`` resolves) is an attribute of the
    port's package of the same name, the very object of the port module
    of the same name, and defined in the port."""
    pkg = importlib.import_module(PORT + os.path.dirname(init)[len(REF):].replace(os.sep, "."))
    names = _imports_from(os.path.join(REPO, init))
    checked = 0
    for _, ref_module, name in names:
        if name in DEVIATIONS:
            assert not hasattr(pkg, name), name
            continue
        got = getattr(pkg, name)
        want = getattr(importlib.import_module(_port_module(ref_module)), name)
        assert got is want, (init, name)
        owner = getattr(got, "__module__", None)
        assert owner is None or owner.split(".")[0] == PORT, (name, owner)
        assert name in dir(pkg), name
        checked += 1
    assert checked == len(names) - len([n for _, _, n in names if n in DEVIATIONS]) > 0


@pytest.mark.parametrize("test_file", REF_TEST_FILES)
def test_reference_test_imports_resolve_on_the_port(test_file):
    """Every import of the reference's own test file, mapped onto the port
    through the rename table, resolves; only the deviations are left out."""
    missing = []
    for line, ref_module, name in _imports_from(os.path.join(REPO, "tests", test_file)):
        if name in DEVIATIONS:
            continue
        port_module = _port_module(ref_module)
        if port_module is None:
            continue
        try:
            mod = importlib.import_module(port_module)
            if name is not None and not hasattr(mod, NAME_RENAMES.get((ref_module, name), name)):
                importlib.import_module(f"{port_module}.{name}")  # a submodule
        except ImportError as e:
            missing.append((line, ref_module, name, str(e)))
    assert not missing, missing


def test_packages_import_without_model_code():
    """Importing the port and every subpackage loads no module behind a
    lazy name: no model, API, beam or training code; resolving a name loads
    its module."""
    code = (
        "import sys, importlib\n"
        "for p in ('', '.data', '.decode', '.frontend', '.models', '.ops', '.parallel', '.train', '.utils'):\n"
        "    importlib.import_module('phones_las_torch' + p)\n"
        "heavy = ('phones_las_torch.models.', 'phones_las_torch.api', 'phones_las_torch.decode.beam',\n"
        "         'phones_las_torch.train.loop', 'phones_las_torch.parallel.mesh', 'phones_las_torch.utils.config')\n"
        "loaded = sorted(m for m in sys.modules if m.startswith(heavy))\n"
        "assert not loaded, loaded\n"
        "import phones_las_torch\n"
        "assert {'Transcriber', 'Trainer', 'PRESETS'} <= set(dir(phones_las_torch))\n"
        "from phones_las_torch.models import LASConfig, init_las, compute_loss\n"
        "assert 'phones_las_torch.models.las' in sys.modules\n"
        "assert phones_las_torch.Trainer is importlib.import_module('phones_las_torch.train.loop').Trainer\n"
    )
    env = subprocess_env(PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_unknown_names_raise_attribute_error():
    for p in ("", ".data", ".models", ".train", ".utils"):
        with pytest.raises(AttributeError, match="no_such_name"):
            getattr(importlib.import_module(PORT + p), "no_such_name")
