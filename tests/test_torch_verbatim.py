"""The port's verbatim copies stay equal to their JAX-package originals.

``src/repro_torch/__init__.py`` lists the modules the port copies verbatim
from ``src/repro`` (they hold no arrays and touch no device). Each pair is
read as text and compared with its import lines removed, so an edit to
either side that the other lacks fails here. The copies the port has since
made its own (``OWN``: its span plane on the profiler's clock, with spans on
the RTS and WFProcessor threads) keep every function and class of their
original but those named as taken out. Nothing of either package is
imported.
"""

import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

VERBATIM = sorted(
    [f"core/{p.name}" for p in (SRC / "repro" / "core").glob("*.py")]
    + [f"api/{p.name}" for p in (SRC / "repro" / "api").glob("*.py")]
    + [f"telemetry/{p.name}"
       for p in (SRC / "repro" / "telemetry").glob("*.py")]
    + [f"rts/{m}.py" for m in ("__init__", "base", "local", "federation",
                               "platforms", "simulated")]
    + [f"fusion/{m}.py" for m in ("__init__", "groups", "plans")]
    + ["chaos/__init__.py"]
    + [f"serve/{m}.py" for m in ("admission", "fair_share", "journal",
                                 "protocol", "client", "daemon")]
    + [f"data/{p.name}" for p in (SRC / "repro" / "data").glob("*.py")])

# copies the port changed on its own -> what of the original they dropped
OWN = {
    "core/profiler.py": {"Profiler.event", "Profiler.events"},
    "core/wfprocessor.py": set(),
    "rts/local.py": set(),
    "telemetry/__init__.py": set(),
    "telemetry/export.py": set(),
    "telemetry/metrics.py": set(),
    "telemetry/tracer.py": {"SpanTracer._push_depth", "SpanTracer._pop_depth"},
}


def _definitions(path: Path) -> set:
    """Qualified names of the module's functions, classes and methods."""
    out = set()

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                out.add(prefix + child.name)
                if isinstance(child, ast.ClassDef):
                    walk(child, f"{prefix}{child.name}.")
    walk(ast.parse(path.read_text()), "")
    return out


def _without_imports(path: Path) -> list:
    return [line for line in path.read_text().splitlines()
            if not line.lstrip().startswith(("import ", "from "))]


def test_every_listed_family_is_present():
    # core/ has 15 modules, api/ 6, telemetry/ 4 and data/ 2 (the
    # docstring's counts)
    fams = [p.split("/")[0] for p in VERBATIM]
    assert (fams.count("core"), fams.count("api"), fams.count("telemetry"),
            fams.count("data")) == (15, 6, 4, 2)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_matches_its_original(rel):
    original, copy = SRC / "repro" / rel, SRC / "repro_torch" / rel
    assert copy.is_file(), f"{copy} missing"
    if rel in OWN:
        missing = _definitions(original) - _definitions(copy)
        assert missing == OWN[rel], (
            f"src/repro_torch/{rel} lacks {missing - OWN[rel]} of "
            f"src/repro/{rel}, or keeps {OWN[rel] - missing}")
        return
    assert _without_imports(copy) == _without_imports(original), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}")
