"""The port's test files define each test once: a second module-level (or
class-level) ``def test_x`` of the same name replaces the first, and
pytest then never collects the first."""

import ast
import glob
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _twice(tree):
    """``[(scope, name)]`` of the ``test_*`` functions defined more than
    once at module level or in one class body."""
    out = []
    scopes = [("module", tree.body)] + [
        (node.name, node.body) for node in tree.body
        if isinstance(node, ast.ClassDef)]
    for scope, body in scopes:
        seen = set()
        for node in body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name.startswith("test")):
                if node.name in seen:
                    out.append((scope, node.name))
                seen.add(node.name)
    return out


def test_no_test_name_is_defined_twice_in_a_file():
    files = sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    assert len(files) > 10
    twice = {}
    for path in files:
        with open(path) as f:
            found = _twice(ast.parse(f.read(), path))
        if found:
            twice[os.path.basename(path)] = found
    assert not twice, twice


def test_the_check_finds_a_shadowed_test():
    tree = ast.parse("def test_a(): pass\n"
                     "def test_b(): pass\n"
                     "class TestC:\n"
                     "    def test_d(self): pass\n"
                     "    def test_d(self): pass\n"
                     "def test_a(): pass\n")
    assert _twice(tree) == [("module", "test_a"), ("TestC", "test_d")]
