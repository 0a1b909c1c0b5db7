"""The port's package-level API against the reference's: every name that
``repro/core/__init__.py``, ``repro/optim/__init__.py`` and
``repro/kernels/__init__.py`` re-export either imports from the port's
package of the same name, or is listed below with the ROADMAP item that
brings it.  Importing the packages builds no kernel."""
import ast
import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# reference name -> the ROADMAP A item whose port brings it
NOT_YET = {
    "core": {},
    "optim": {},
    "kernels": {},
}


def _reference_names(pkg: str) -> list[str]:
    """The names ``repro/<pkg>/__init__.py`` imports, read from its source
    (the port's tests may import JAX, but reading needs no import)."""
    path = os.path.join(REPO, "src", "repro", pkg, "__init__.py")
    tree = ast.parse(open(path).read(), path)
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("pkg", sorted(NOT_YET))
def test_every_reference_name_is_exported_or_listed(pkg):
    port = importlib.import_module(f"repro_torch.{pkg}")
    names = _reference_names(pkg)
    assert names, pkg
    missing = [n for n in names if not hasattr(port, n) and n not in NOT_YET[pkg]]
    assert not missing, f"repro_torch.{pkg} lacks {missing} and no ROADMAP item is named for them"


@pytest.mark.parametrize("pkg", sorted(NOT_YET))
def test_the_list_names_only_what_is_still_missing(pkg):
    """A name that the port's package exports comes off the list, and the
    list names only the reference's names."""
    port = importlib.import_module(f"repro_torch.{pkg}")
    names = set(_reference_names(pkg))
    assert set(NOT_YET[pkg]) <= names
    assert not [n for n in NOT_YET[pkg] if hasattr(port, n)]


@pytest.mark.parametrize("pkg", sorted(NOT_YET))
def test_exported_names_are_the_modules_own(pkg):
    """Each re-exported name is the very object its module defines (one
    launch counter per kernel wrapper, one class per type)."""
    port = importlib.import_module(f"repro_torch.{pkg}")
    tree = ast.parse(open(os.path.join(REPO, "src", "repro_torch", pkg, "__init__.py")).read())
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            mod = importlib.import_module(node.module)
            for a in node.names:
                assert getattr(port, a.asname or a.name) is getattr(mod, a.name)


def test_kernels_package_exports_all_five_reference_names():
    import repro_torch.kernels as k
    from repro_torch.kernels.conv2d_tiled import backward, ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    assert _reference_names("kernels") == ["flash_attention", "conv2d_dgrad_tile",
                                           "conv2d_wgrad_tile", "conv2d", "rmsnorm"]
    assert k.conv2d_dgrad_tile is backward.conv2d_dgrad_tile
    assert k.conv2d_wgrad_tile is backward.conv2d_wgrad_tile
    assert k.conv2d is ops.conv2d
    assert k.flash_attention is fa_ops.flash_attention
    assert k.rmsnorm is rms_ops.rmsnorm


def test_importing_the_packages_builds_nothing():
    """The kernels build at their first launch, never at import: with every
    subprocess start refused, the three packages still import, and no
    kernel library is loaded."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'a process was started at import: {a}')\n"
        "subprocess.Popen = refuse\n"
        "subprocess.run = refuse\n"
        "import repro_torch.kernels, repro_torch.core, repro_torch.optim\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._LOADED == {}\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _reference_arch_ids() -> list[str]:
    """The keys of ``repro/models/registry.py:ARCH_MODULES``, read from its
    source."""
    path = os.path.join(REPO, "src", "repro", "models", "registry.py")
    tree = ast.parse(open(path).read(), path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and [t.id for t in node.targets] == ["ARCH_MODULES"]:
            return [k.value for k in node.value.keys]
    raise AssertionError("ARCH_MODULES not found")


def test_every_reference_arch_resolves_and_no_roadmap_item_is_left():
    """Every ``--arch`` of the reference's registry resolves in the port (its
    config, full and reduced, and a bundle on the CPU), so ``ROADMAP_ITEMS``
    names nothing."""
    from repro_torch.models import registry as treg

    ids = _reference_arch_ids()
    assert len(ids) == 10 and treg.ARCH_IDS == ids
    assert treg.ROADMAP_ITEMS == {}
    for name in ids:
        for reduced in (False, True):
            cfg = treg.load_config(name, reduced=reduced)
            assert cfg.name == name
        arch = treg.get_arch(name, reduced=True, device="cpu")
        assert arch.cfg.encoder_decoder == (name == "whisper-medium")


def _module_names(path: str) -> list[str]:
    """The top-level functions, classes and assigned names a module's
    source defines, the private ones included."""
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return names


@pytest.mark.parametrize("mod", ["api", "sharding"])
def test_parallel_modules_define_every_reference_name(mod):
    """``repro/parallel/api.py`` and ``sharding.py`` (ROADMAP A.18.8):
    every name the reference's module defines, its tables and the
    ``_ACTIVE`` context the MoE dispatch reads included, is the port's."""
    port = importlib.import_module(f"repro_torch.parallel.{mod}")
    names = _module_names(os.path.join(REPO, "src", "repro", "parallel", f"{mod}.py"))
    assert {"logical_spec", "constrain"} <= set(names) or {"param_logical_tree",
                                                           "cache_shardings"} <= set(names)
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"repro_torch.parallel.{mod} lacks {missing}"
