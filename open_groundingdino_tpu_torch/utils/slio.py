"""Small load/dump helpers by file extension: the port's own copy of the JAX
package's utils/slio.py (reference util/slio.py)."""
from __future__ import annotations

import json
import pickle
from typing import Any


def slload(path: str) -> Any:
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            return yaml.safe_load(f)
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            return pickle.load(f)
    raise ValueError(f"unsupported extension: {path}")


def sldump(obj: Any, path: str) -> None:
    if path.endswith(".json"):
        with open(path, "w") as f:
            json.dump(obj, f)
    elif path.endswith((".yaml", ".yml")):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(obj, f)
    elif path.endswith((".pkl", ".pickle")):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    else:
        raise ValueError(f"unsupported extension: {path}")
