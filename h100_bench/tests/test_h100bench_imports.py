"""Nothing the benchmark runs imports JAX or the JAX package; the reference imports
nothing of the program.

Module names are compared by their top-level name (the part before the
first dot) whole: ``celldetection_tpu_torch`` begins with
``celldetection_tpu`` and is the program, not the JAX package.
"""
import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'celldetection_tpu'}


def _modules():
    """Every module of the benchmark but its tests, by import name, and the readers' files."""
    mods, files = [], []
    for dirpath, _, names in os.walk(HERE):
        rel = os.path.relpath(dirpath, ROOT)
        if '__pycache__' in rel or rel.startswith(os.path.join('h100_bench', 'tests')):
            continue
        for n in sorted(names):
            if not n.endswith('.py'):
                continue
            if os.path.basename(dirpath) == 'layer_metrics':
                files.append(os.path.join(dirpath, n))
            elif n != '__init__.py':
                mods.append('.'.join(rel.split(os.sep) + [n[:-3]]))
    return mods, files


def test_nothing_loads_jax_or_the_jax_package():
    mods, files = _modules()
    code = f'''
import importlib, importlib.util, json, sys
sys.path.insert(0, {ROOT!r})
for m in {mods!r}:
    importlib.import_module(m)
for i, f in enumerate({files!r}):
    spec = importlib.util.spec_from_file_location(f"m{{i}}", f)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import celldetection_tpu_torch.models, celldetection_tpu_torch.parallel.tiles
import celldetection_tpu_torch.ops.boxes
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
'''
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert 'celldetection_tpu_torch' in loaded and 'h100_bench' in loaded
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, 'reference')
    for n in os.listdir(ref):
        if not n.endswith('.py'):
            continue
        with open(os.path.join(ref, n)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ''] if node.level == 0 else []
            for name in names:
                top = name.split('.')[0]
                assert top in ('torch', 'numpy', 'contextlib', 'typing', 'math'), (n, name)
