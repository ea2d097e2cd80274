"""Shared loader of the port's example scripts for the example tests."""
import importlib.util
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(script: str):
    """An example script as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        Path(script).stem, EXAMPLES / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
