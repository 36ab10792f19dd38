"""The mechanism that runs the reference's own test cases against the
port: a case's source is taken from its file in ``tests/``, its ``repro.``
imports renamed to ``repro_torch.``, and the calls that build a launch
path pointed at the CPU — ``device="cpu"`` added where a fabric, a node,
a backend or an ``LLMapReduce`` is built, and ``cache_dir=`` dropped
from ``CompileCache`` (the port's cache has no disk tier). Every
assertion stays as the reference wrote it.

The tests below hold the transform itself.
"""
import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"

#: the calls that build something that runs on a device
ON_DEVICE = frozenset({"DistributedBackend", "NodeAgent", "ProcessNodeAgent",
                       "spawn_local_nodes", "make_backend", "LLMapReduce"})


class _Rename(ast.NodeTransformer):
    """``repro`` / ``repro.x`` imports -> ``repro_torch`` / ``repro_torch.x``;
    launch-path constructors get ``device="cpu"``; ``CompileCache`` loses
    ``cache_dir=``."""

    @staticmethod
    def _name(mod):
        if mod == "repro" or (mod or "").startswith("repro."):
            return "repro_torch" + mod[len("repro"):]
        return mod

    def visit_Import(self, node):
        for a in node.names:
            a.name = self._name(a.name)
        return node

    def visit_ImportFrom(self, node):
        if node.level == 0:
            node.module = self._name(node.module)
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name in ON_DEVICE and not any(k.arg == "device"
                                         for k in node.keywords):
            node.keywords.append(ast.keyword(arg="device",
                                             value=ast.Constant("cpu")))
        elif name == "CompileCache":
            node.keywords = [k for k in node.keywords
                             if k.arg != "cache_dir"]
        return node


def _port_cases(ref: str, names: tuple, prefix: str, module: str = None,
                overrides: dict = None) -> dict:
    """The test functions ``names`` of ``tests/<ref>`` (and its helpers and
    fixtures) compiled against the port, keyed ``test_<prefix>__<name>``
    (fixtures under their own names). Top-level imports of a module the
    port lacks are dropped; the cases chosen do not use them.

    With ``module`` (the importing test module's ``__name__``), the cases
    are compiled as that module's functions and its helpers are returned
    too, under their own names: a shard function pickled onto the wire
    then resolves to ``module.<name>`` wherever the node unpickles it.
    ``overrides`` replaces helpers by name (a helper the reference writes
    in ``jax.numpy`` gets its torch counterpart)."""
    tree = _Rename().visit(ast.parse((TESTS / ref).read_text()))
    ns = {"__name__": module or f"ported_{ref[:-3]}",
          "__file__": str(TESTS / ref)}
    kept = []
    for node in tree.body:
        if (isinstance(node, ast.FunctionDef)
                and node.name.startswith("test_")
                and node.name not in names):
            continue
        code = compile(ast.fix_missing_locations(
            ast.Module(body=[node], type_ignores=[])),
            str(TESTS / ref), "exec")
        try:
            exec(code, ns)
        except ImportError:
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                raise
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            kept.append(node.name)
    ns.update(overrides or {})
    missing = set(names) - set(ns)
    assert not missing, missing
    out = {}
    for k in kept:
        v = ns[k]
        if k in names:
            out[f"test_{prefix}__{k[len('test_'):]}"] = v
        elif hasattr(v, "_fixture_function_marker"):     # a fixture
            out[k] = v
        elif module is not None and not k.startswith("test_"):
            out[k] = v                                   # a helper
    return out


def _transformed(src: str) -> str:
    return ast.unparse(_Rename().visit(ast.parse(src)))


def test_imports_are_renamed_to_the_port():
    got = _transformed("import repro.obs\nfrom repro.dist import x\n"
                       "from repro import y\nimport reprox\n")
    assert got.splitlines() == ["import repro_torch.obs",
                                "from repro_torch.dist import x",
                                "from repro_torch import y",
                                "import reprox"]


def test_launch_constructors_are_pointed_at_the_cpu():
    got = _transformed(
        "a = DistributedBackend(n_nodes=2, **kw)\n"
        "b = mod.NodeAgent('n0', reg)\n"
        "c = LLMapReduce(wave_size=4, backend=be)\n"
        "d = make_backend('dist', device='cuda')\n"
        "e = CompileCache(cache_dir=str(p))\n"
        "f = other(cache_dir=1)\n")
    assert got.splitlines() == [
        "a = DistributedBackend(n_nodes=2, **kw, device='cpu')",
        "b = mod.NodeAgent('n0', reg, device='cpu')",
        "c = LLMapReduce(wave_size=4, backend=be, device='cpu')",
        "d = make_backend('dist', device='cuda')",
        "e = CompileCache()",
        "f = other(cache_dir=1)"]
