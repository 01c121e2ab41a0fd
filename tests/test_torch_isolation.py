"""The port stands alone: ``import repro_torch`` (and every submodule) works
with JAX blocked and loads nothing of the JAX package, no source under
``src/repro_torch`` imports either, and the modules the port copies from
the JAX package (JAX-free there) run the same code as their originals. The
config registry is a copy: the same code and the same archs, apart from
the refusal of an unknown arch, which names ROADMAP.md;
the input pipeline is one too, apart from ``next_batch``, which hands out
torch tensors where the original makes JAX arrays."""

import dataclasses

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
IMPORT_LINE = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)",
                         re.MULTILINE)

# port copy -> original; their code may differ only in repro -> repro_torch
# on import lines, and in importing a host twin (HOST_TWINS) where the
# original imports the name it stands for
COPIES = {"transfer/engine.py": "transfer/engine.py",
          "transfer/recovery.py": "transfer/recovery.py",
          "core/exploration.py": "core/exploration.py",
          "scenarios/families.py": "scenarios/families.py",
          "core/globus.py": "core/globus.py",
          "core/marlin.py": "core/marlin.py",
          "models/config.py": "models/config.py",
          "configs/smollm_135m.py": "configs/smollm_135m.py",
          "configs/mamba2_1_3b.py": "configs/mamba2_1_3b.py",
          "configs/zamba2_1_2b.py": "configs/zamba2_1_2b.py",
          "configs/mixtral_8x22b.py": "configs/mixtral_8x22b.py",
          "configs/deepseek_7b.py": "configs/deepseek_7b.py",
          "configs/granite_34b.py": "configs/granite_34b.py",
          "configs/chatglm3_6b.py": "configs/chatglm3_6b.py",
          "configs/deepseek_v2_236b.py": "configs/deepseek_v2_236b.py",
          "configs/qwen2_vl_72b.py": "configs/qwen2_vl_72b.py",
          "configs/seamless_m4t_large_v2.py":
              "configs/seamless_m4t_large_v2.py",
          "configs/registry.py": "configs/registry.py",
          "core/simref.py": "core/simref.py",
          "scenarios/driver.py": "scenarios/driver.py",
          "core/online.py": "core/online.py",
          "data/pipeline.py": "data/pipeline.py",
          "sharding/context.py": "sharding/context.py"}
# narrowed copies: the top-level names (or "Class.method") whose definitions
# may differ from the original's (the registry's refusal is checked by
# test_registry_narrows_the_reference_registry; the pipeline's next_batch
# hands out torch tensors on a device where the original makes JAX arrays)
NARROWED = {"configs/registry.py": ("_module",),
            "data/pipeline.py": ("InputPipeline.next_batch",)}
# the port's CPU-only twin -> the reference name it stands for: the port's
# entry point runs on the card by default, the NumPy copy reads it on the host
HOST_TWINS = {"_always_on_host": "always_on"}


def test_import_with_jax_blocked_loads_no_reference_module():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'repro' or k.startswith('repro.')\n"
        "             or k == 'jax' and sys.modules[k] is not None\n"
        "             or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "assert {'repro_torch.sharding', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.runtime.elastic'} <= set(sys.modules), names\n"
        "print('ok', len(names))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_source_imports_jax_or_the_reference_package():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        for m in IMPORT_LINE.finditer(path.read_text()):
            line = path.read_text()[m.start():].splitlines()[0]
            offenders.append(f"{path.relative_to(SRC)}: {line.strip()}")
    assert not offenders, offenders


def _code(path, drop=()):
    """The module's code as an AST dump, import names and module-path
    strings normalised from repro_torch to repro and host twins to their
    names, docstrings and the definitions of ``drop`` (top-level names and
    "Class.method") dropped (comments never reach the AST): what the copy
    runs, not how it is worded."""
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.FunctionDef) and n.name in drop
        or isinstance(n, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id in drop for t in n.targets))]
    for cls in tree.body:
        if isinstance(cls, ast.ClassDef):
            cls.body = [n for n in cls.body if not (
                isinstance(n, ast.FunctionDef)
                and f"{cls.name}.{n.name}" in drop)]
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith("repro_torch.")):
            node.value = "repro." + node.value[len("repro_torch."):]
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = re.sub(r"^repro_torch\b", "repro", node.module)
            for alias in node.names:
                alias.name = HOST_TWINS.get(alias.name, alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                alias.name = re.sub(r"^repro_torch\b", "repro", alias.name)
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0].value.value = ""
    return ast.dump(tree)


def test_copied_modules_equal_their_originals():
    for port, orig in COPIES.items():
        drop = NARROWED.get(port, ())
        assert (_code(PORT / port, drop)
                == _code(SRC / "repro" / orig, drop)), (
            f"repro_torch/{port} drifted from repro/{orig}")


def test_registry_narrows_the_reference_registry():
    """The port's registry lists the reference's archs, gives each the
    reference's published and SMOKE configs field for field, and refuses
    every other arch with a KeyError naming ROADMAP.md."""
    from repro.configs import registry as ref
    from repro_torch.configs import registry as port
    assert port.ARCHS == ref.ARCHS
    for arch in port.ARCHS:
        for get in ("get_config", "get_smoke_config"):
            assert (dataclasses.asdict(getattr(port, get)(arch))
                    == dataclasses.asdict(getattr(ref, get)(arch)))
    for arch in sorted(set(ref.ARCHS) - set(port.ARCHS)) + ["no-such"]:
        with pytest.raises(KeyError, match="ROADMAP.md"):
            port.get_config(arch)


def test_cursor_checkpoints_are_readable_across_packages(tmp_path):
    """The port's checkpointer keeps the reference's on-disk format: a
    cursor saved by either package loads in the other."""
    from repro.transfer.recovery import (FlowCursor as JCursor,
                                         save_cursor as jsave,
                                         load_cursor as jload)
    from repro_torch.transfer.recovery import (FlowCursor, save_cursor,
                                               load_cursor)
    c = FlowCursor(1000)
    c.add(0, 100)
    c.add(300, 50)
    save_cursor(str(tmp_path / "port"), c, 1)
    back = jload(str(tmp_path / "port"))
    assert back.total == 1000 and back.intervals() == c.intervals()
    j = JCursor(500)
    j.add(10, 20)
    jsave(str(tmp_path / "ref"), j, 3)
    mine = load_cursor(str(tmp_path / "ref"))
    assert mine.total == 500 and mine.intervals() == j.intervals()
    assert load_cursor(str(tmp_path / "empty")) is None


def test_checkpoint_round_trips_and_keeps_the_newest(tmp_path):
    from repro_torch.checkpoint import (save_checkpoint, load_checkpoint,
                                        latest_step)
    state = {"a": np.arange(10, dtype=np.float32),
             "b": {"c": np.int64(7), "d": np.ones((3, 2), np.int32)}}
    for step in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), state, step, keep=2)
    assert latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    back, step = load_checkpoint(str(tmp_path), state)
    assert step == 4
    np.testing.assert_array_equal(back["a"], state["a"])
    np.testing.assert_array_equal(back["b"]["d"], state["b"]["d"])
    assert int(back["b"]["c"]) == 7


def test_checkpoint_refuses_the_unported_engine_save(tmp_path):
    """The save through the transfer engine raised NotImplementedError
    until the training slice ported it; it is now the default, as in the
    reference, and writes the direct save's bytes and sha256."""
    from repro_torch.checkpoint import save_checkpoint, latest_step
    state = {"a": np.arange(1000, dtype=np.float32),
             "b": {"c": np.int32(5)}}
    paths = [save_checkpoint(str(tmp_path / name), state, 1, chunk_bytes=512,
                             **kw)
             for name, kw in (("engine", {}),
                              ("direct", dict(use_engine=False)))]
    blobs = [open(os.path.join(p, f), "rb").read() for p in paths
             for f in ("ckpt.bin", "manifest.json")]
    assert blobs[0] == blobs[2] and blobs[1] == blobs[3]
    assert latest_step(str(tmp_path / "engine")) == 1
