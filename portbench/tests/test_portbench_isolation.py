"""The benchmark imports no JAX and no JAX package, and its yardstick
imports nothing of the program it measures."""

import ast
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "kanzi_tpu"}
PROGRAM = "kanzi_tpu_torch"
# the yardstick: traffic, reference, the arithmetic of the metrics, the checks
REFERENCE = sorted(os.path.relpath(os.path.join(d, f), HERE)
                   for d, _, files in os.walk(os.path.join(HERE, "reference"))
                   for f in files if f.endswith(".py"))
YARDSTICK = ["corpus.py", "traffic.py", "peaks.py", "measure.py", "trace.py",
             "check.py"] + REFERENCE
# the one dynamic import: the reference's registry of its own codec files
REGISTRY = os.path.join("reference", "__init__.py")


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every module a file imports, relative imports
    resolved to portbench."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("portbench" if node.level else (node.module or "").split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names.add("<dynamic>")
    return names


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN, path


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(name):
    names = imported(os.path.join(HERE, name))
    if name == REGISTRY:
        names -= {"<dynamic>", "importlib"}
    assert PROGRAM not in names and "tests" not in names and "<dynamic>" not in names
    assert names <= {"__future__", "gzip", "hashlib", "os", "json", "math", "struct",
                     "dataclasses", "collections", "sys", "numpy", "portbench"}, names


def test_the_registry_loads_only_the_references_own_files():
    tree = ast.parse(open(os.path.join(HERE, REGISTRY)).read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", "") == "import_module"]
    assert len(calls) == 1
    arg = calls[0].args[0]
    assert isinstance(arg, ast.JoinedStr)
    assert ast.unparse(arg).startswith("f'{__name__}.{kind}.")
    from portbench import reference
    assert {m.__name__.rsplit(".", 2)[0] for kind in ("entropy", "transform")
            for m in reference.codecs(kind).values()} == {"portbench.reference"}


def test_whole_names_are_compared():
    from portbench import run
    saved = dict(sys.modules)
    try:
        sys.modules.setdefault("kanzi_tpu_torch_fake_probe", object())
        assert "kanzi_tpu" not in run.forbidden_modules()
        sys.modules["kanzi_tpu.fake_probe"] = object()
        assert run.forbidden_modules() == ["kanzi_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def written_ids():
    """{"entropy": ids, "transform": ids} that the streams of the
    configurations (configs/*.json) write: a small stream of each,
    written by the program's host path, read by the reference's parser."""
    import kanzi_tpu_torch as kt

    from portbench import corpus, reference
    data = corpus.synth_corpus(200_000, 2 ** 32 + 21, 1)
    ids = {"entropy": set(), "transform": set()}
    for name in sorted(os.listdir(os.path.join(HERE, "configs"))):
        config = json.load(open(os.path.join(HERE, "configs", name)))
        blob = kt.compress(data, transform=config["transform"], entropy=config["entropy"],
                           block_size=65536, checksum=config["checksum"], device=None)
        header, frames = reference.parse(blob)
        ids["entropy"] |= {header.entropy} | {reference.block_head(blob, header, f).entropy
                                              for f in frames}
        ids["transform"] |= {(header.transform >> (42 - 6 * i)) & 0x3F for i in range(8)}
    ids["transform"].discard(reference.TRANSFORM_NONE)   # a step the reference skips
    return {k: sorted(v) for k, v in ids.items()}


def test_the_yardstick_loads_without_the_program():
    ids = written_ids()
    assert ids["entropy"] and ids["transform"]
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            f"        if name.split('.')[0] in {sorted(FORBIDDEN | {PROGRAM})!r}:\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            + "".join(f"import portbench.{n[:-3].replace(os.sep, '.')}\n"
                      for n in YARDSTICK if not n.endswith("__init__.py"))
            + "from portbench import reference\n"
            "assert reference.xxhash32(b'', 0) == 0x02CC5D05\n"
            f"for kind, ids in {ids!r}.items():\n"
            "    missing = set(ids) - set(reference.codecs(kind))\n"
            "    assert not missing, (kind, missing)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr
