"""The port's layering: ``kernels/`` sits below ``ops/``.

The hand-written kernels and their plain versions import nothing of the port
above ``util``, so the package draws as boxes whose arrows point one way;
``ops/boxes.py`` reaches the kernels through one import at its top. The
sources are parsed, not imported.
"""
import ast
import glob
import os

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   'celldetection_tpu_torch')
ABOVE_KERNELS = {'ops', 'models', 'parallel', 'runtime', 'data'}


def imported(node):
    """The port's top-level packages that an import node names, for a module
    one level below the root: ``ops`` for ``from ..ops.boxes import x`` or
    ``import celldetection_tpu_torch.ops``, the names of ``from .. import
    ops``; nothing for another package or a sibling module."""
    if isinstance(node, ast.Import):
        return {a.name.split('.')[1] for a in node.names
                if a.name.startswith('celldetection_tpu_torch.')}
    parts = (node.module or '').split('.')
    if node.level == 0:
        if parts[0] != 'celldetection_tpu_torch':
            return set()
        parts = parts[1:]
    elif node.level == 1:
        return set()             # a module of the same package
    return {parts[0]} if parts and parts[0] else {a.name for a in node.names}


def test_kernels_sit_below_ops():
    """No module of ``kernels/`` imports ``ops``, ``models``, ``parallel``,
    ``runtime`` or ``data``, and ``ops/boxes.py`` imports ``kernels`` once,
    at its top, never inside a function."""
    for path in sorted(glob.glob(os.path.join(PKG, 'kernels', '*.py'))):
        with open(path) as f:
            tree = ast.parse(f.read())
        above = set().union(*(imported(node) for node in ast.walk(tree)
                              if isinstance(node, (ast.Import, ast.ImportFrom))))
        assert not above & ABOVE_KERNELS, f'{os.path.basename(path)} imports {above}'
    with open(os.path.join(PKG, 'ops', 'boxes.py')) as f:
        tree = ast.parse(f.read())
    local = [node.lineno for fn in ast.walk(tree)
             if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
             for node in ast.walk(fn)
             if isinstance(node, (ast.Import, ast.ImportFrom)) and 'kernels' in imported(node)]
    assert not local, f'ops/boxes.py imports kernels inside functions at lines {local}'
    top = [node for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))
           and 'kernels' in imported(node)]
    assert len(top) == 1
