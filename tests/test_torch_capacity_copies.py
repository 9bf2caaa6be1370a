"""The overload-control modules the port copies from the JAX package
stay copies, and the modules of the port's overload control keep its
rules.

`tests/test_torch_serving_copies.py`'s pattern, extended to the modules
copied with the serving runtime's overload control
(`capacity/admission.py`, `capacity/brownout.py`,
`observability/workload.py`, `observability/utilization.py`): each
module's code, its docstrings aside, is the JAX package's statement for
statement, so the behavior that `tests/test_torch_admission.py` and
`tests/test_torch_utilization_workload.py` hold equal cannot drift
apart unseen. `capacity/recalibrate.py` is ported, not copied (its
switches are code), and is held by behavior only.

The rules: none of these modules, nor `capacity/recalibrate.py`,
`capacity/model.py`, `serving/sparse.py` and the rotation's
`pir/cuckoo_database.py`, reads an environment variable; the model and
the sparse database's rotation have no `try`.
"""

import ast
from pathlib import Path

import pytest

import distributed_point_functions_tpu as jax_pkg
import distributed_point_functions_tpu_torch as port

PORT = Path(port.__file__).resolve().parent
JAX = Path(jax_pkg.__file__).resolve().parent
COPIED = ["capacity/admission.py", "capacity/brownout.py", "observability/workload.py",
          "observability/utilization.py"]


def _code(path: Path) -> str:
    """The module's AST dump without docstrings."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_equals_jax(module):
    assert _code(PORT / module) == _code(JAX / module)


@pytest.mark.parametrize(
    "module", COPIED + ["capacity/recalibrate.py", "capacity/model.py",
                        "capacity/__init__.py", "serving/sparse.py",
                        "pir/cuckoo_database.py", "pir/sparse_server.py"])
def test_reads_no_environment(module):
    text = (PORT / module).read_text()
    assert "os.environ" not in text and "getenv" not in text


@pytest.mark.parametrize("module", ["capacity/model.py", "capacity/recalibrate.py",
                                    "pir/cuckoo_database.py", "pir/sparse_server.py",
                                    "hashing/cuckoo_hash_table.py"])
def test_has_no_try(module):
    tree = ast.parse((PORT / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
